"""Runtime telemetry counters: shape buckets and host<->device transfers
(port of the host counters of m3_tpu/parallel/telemetry.py; its JIT
builder and plan-cache hooks time XLA compiles and have no counterpart
here, where the kernels are built once per process).

Everything exports through `utils.instrument` under the `telemetry.*`
scope and tags the active span via `utils.tracing.count_cost`.

  record_bucket(path, key)
                      pow2 shape-bucket tracking for the batched decode
                      paths: first sight of a (path, geometry) bucket is
                      a `bucket_miss`, repeats are hits. Bounded.

  count_h2d           host->device transfer bytes at the budget's upload
                      choke point (hbm.budgeted_put)."""

from __future__ import annotations

import threading

from ..utils import tracing
from ..utils.instrument import ROOT

_SCOPE = ROOT.sub_scope("telemetry")
_XFER = _SCOPE.sub_scope("transfer")
_BUCKETS = _SCOPE.sub_scope("shape_bucket")


def count_h2d(nbytes: int):
    """Host->device transfer bytes at an upload choke point."""
    if nbytes > 0:
        _XFER.counter("h2d_bytes").inc(int(nbytes))
        _XFER.counter("h2d_transfers").inc()
        tracing.count_cost("h2d_bytes", int(nbytes))


_BUCKET_LOCK = threading.Lock()
_SEEN_BUCKETS: set = set()
_BUCKET_CAP = 4096  # safety bound; real bucket sets are tens of entries


def record_bucket(path: str, key: tuple):
    """pow2 shape-bucket accounting for a batched decode/encode path: a
    first-seen (path, geometry) is a bucket MISS, repeats are hits."""
    k = (path, key)
    with _BUCKET_LOCK:
        if k in _SEEN_BUCKETS:
            hit = True
        else:
            hit = False
            if len(_SEEN_BUCKETS) >= _BUCKET_CAP:
                _SEEN_BUCKETS.clear()  # degenerate workload: restart
            _SEEN_BUCKETS.add(k)
    scope = _SCOPE.sub_scope("shape_bucket", path=path)
    if hit:
        scope.counter("hits").inc()
        _BUCKETS.counter("hits").inc()
    else:
        scope.counter("misses").inc()
        _BUCKETS.counter("misses").inc()
        tracing.count_cost("shape_bucket_miss")

