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
                      choke point (hbm.budgeted_put).

  compute_*           the compute-fault plane (parallel/guard): guarded
                      dispatches per route (answered by the primary, or
                      raised), classified faults by kind, breaker
                      transitions, quarantined keys and OOM reclaims.
                      Tags are closed sets: `route` is a guard route name
                      (codec.encode, codec.decode, codec.hash,
                      block.decode, temporal.*), `kind` a ComputeError
                      kind (compile, oom, kernel, timeout), `state` a
                      breaker state."""

from __future__ import annotations

import functools
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


def count_d2h(nbytes: int):
    """Device->host transfer bytes at a result materialization point."""
    if nbytes > 0:
        _XFER.counter("d2h_bytes").inc(int(nbytes))
        _XFER.counter("d2h_transfers").inc()
        tracing.count_cost("d2h_bytes", int(nbytes))


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



# ---------------------------------------------------------- compute plane

_COMPUTE = _SCOPE.sub_scope("compute")


@functools.lru_cache(maxsize=None)
def _compute_route_counters(route: str):
    # One guarded dispatch per kernel call: resolve the tagged counters
    # once per route, so a dispatch costs two Counter.inc()s.
    scope = _SCOPE.sub_scope("compute", route=route)
    return (scope.counter("primary"), scope.counter("raised"),
            _COMPUTE.counter("primary"), _COMPUTE.counter("raised"))


def compute_route(route: str, primary: bool):
    """Count one guarded dispatch on `route`: answered by the primary, or
    raised as a typed ComputeError (the port has no fallback, so a
    dispatch the guard refuses or that faults ends in a raise)."""
    prim, raised, tot_prim, tot_raised = _compute_route_counters(route)
    if primary:
        prim.inc()
        tot_prim.inc()
    else:
        raised.inc()
        tot_raised.inc()
        tracing.count_cost(f"compute_raised_{route}")


def compute_fault(route: str, kind: str):
    """One classified device/kernel fault on `route`, tagged with its
    ComputeError kind (compile / oom / kernel / timeout)."""
    _SCOPE.sub_scope("compute", route=route, kind=kind).counter(
        "faults").inc()
    _COMPUTE.counter("faults").inc()
    tracing.count_cost(f"compute_fault_{kind}")


def compute_trip(route: str, state: str):
    """One breaker state transition on `route` (state in {"open",
    "half_open", "closed"}); `open` is the degradation signal the
    health probe and debug_snapshot surface."""
    _SCOPE.sub_scope("compute", route=route).counter(
        "trip_" + state).inc()
    if state == "open":
        _COMPUTE.counter("trips").inc()
        tracing.count_cost("compute_breaker_trip")


def compute_quarantine(route: str):
    """One key quarantined on `route` after a fault (TTL'd: dispatches
    with that key raise at once until it expires)."""
    _SCOPE.sub_scope("compute", route=route).counter("quarantined").inc()
    _COMPUTE.counter("quarantined").inc()
    tracing.count_cost("compute_quarantine")


def compute_oom_reclaim(route: str, freed: int):
    """One DeviceOOM-triggered HBMBudget reclaim before the single
    retry; `freed` accumulates the bytes reclaimed."""
    _SCOPE.sub_scope("compute", route=route).counter("oom_reclaims").inc()
    _COMPUTE.counter("oom_reclaims").inc()
    if freed > 0:
        _COMPUTE.counter("oom_reclaimed_bytes").inc(int(freed))
    tracing.count_cost("compute_oom_reclaim")
