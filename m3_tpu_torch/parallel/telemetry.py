"""Runtime telemetry counters: shape buckets, host<->device transfers,
the plan cache and its builds, plan fallbacks and the compute-fault plane
(port of m3_tpu/parallel/telemetry.py).

Everything exports through `utils.instrument` under the `telemetry.*`
scope and tags the active span via `utils.tracing.count_cost`.

  BuildTimed          wraps a freshly built executable so its FIRST call
                      — where the build happens: on the card a warm-up
                      run and a CUDA-graph capture, on the CPU one eager
                      run — is timed into `telemetry.build.build_s` (the
                      counterpart of the reference's jit_builder /
                      _CompileTimed, which time an XLA compile).

  plan_cache_*        compiled-plan executables served from the plan
                      cache (hits) or built (misses, with build wall).

  plan_fallback       one query that missed the compiled route, tagged
                      with its typed reason and scope.

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
                      block.decode, temporal.*, plan), `kind` a ComputeError
                      kind (compile, oom, kernel, timeout), `state` a
                      breaker state.

  mesh_dispatch       one dispatch of a program over the device mesh
                      (parallel/mesh), per kernel tag (flush_encode,
                      agg_flush, agg_rate, plan), with the cells it
                      covered."""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Optional

from ..utils import tracing
from ..utils.instrument import ROOT

_SCOPE = ROOT.sub_scope("telemetry")
_XFER = _SCOPE.sub_scope("transfer")
_BUCKETS = _SCOPE.sub_scope("shape_bucket")
_BUILD = _SCOPE.sub_scope("build")
_MESH = _SCOPE.sub_scope("mesh")

# Build wall time in seconds; boundaries skewed high — a warm-up plus a
# graph capture is milliseconds to seconds, not a sub-ms request.
_BUILD_BOUNDS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class BuildTimed:
    """Wrap a freshly built executable so its FIRST call (where the build
    happens) is timed; later calls pass through one attribute check.
    Thread-safe in the benign direction: a race times the build twice,
    never misses it."""

    __slots__ = ("fn", "name", "done")

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.done = False

    def __call__(self, *args, **kwargs):
        if self.done:
            return self.fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        self.done = True
        _BUILD.counter("builds").inc()
        _BUILD.histogram("build_s", _BUILD_BOUNDS).record(dt)
        _SCOPE.sub_scope("build", builder=self.name).counter("builds").inc()
        tracing.count_cost("build")
        return out


# ------------------------------------------------------------ plan cache

_PLAN_CACHE = _SCOPE.sub_scope("plan_cache")


def plan_cache_hit():
    """One compiled-plan executable served from the plan cache."""
    _PLAN_CACHE.counter("hits").inc()


def plan_cache_miss():
    """One plan-cache miss: an executable is about to be built (its wall
    time lands via plan_compile_recorded)."""
    _PLAN_CACHE.counter("misses").inc()


def plan_compile_recorded(seconds: float):
    """Wall time of one executable's build and first run (a plan-cache
    miss), tagged onto the active span so the slow-query log can
    attribute cold builds."""
    _PLAN_CACHE.counter("compiles").inc()
    _PLAN_CACHE.histogram("compile_s", _BUILD_BOUNDS).record(seconds)
    tracing.count_cost("plan_compile")


# ---------------------------------------------------------- plan fallbacks

_PLAN_FALLBACK = _SCOPE.sub_scope("plan_fallback")


def plan_fallback(reason: str, scope: str = "structural"):
    """One query that missed the compiled whole-plan route, tagged with
    its typed `query.plan.FallbackReason` VALUE (a closed set — raw query
    strings or other unbounded values must never ride as tag values) and
    its SCOPE: "structural" (the query shape is outside the compiled
    surface) vs "runtime" (a data-dependent or operational routing
    decision — below-floor, the route turned off, a backend gap; see
    query.plan.fallback_scope). The split keeps corpus.coverage's
    structural re-lowering consistent with recorded routes: a below-floor
    miss on a small-series corpus is not a lowering gap."""
    _SCOPE.sub_scope("plan_fallback", reason=reason,
                     scope=scope).counter("count").inc()
    _PLAN_FALLBACK.counter("total").inc()
    tracing.count_cost("plan_fallback")


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


# ------------------------------------------------------------- dispatches


def mesh_dispatch(kernel: str, cells: Optional[int] = None):
    """Count one mesh-program dispatch for `kernel` (flush_encode,
    agg_flush, agg_rate, plan); `cells` accumulates the dispatched
    volume."""
    scope = _SCOPE.sub_scope("mesh", kernel=kernel)
    scope.counter("dispatches").inc()
    _MESH.counter("dispatches").inc()
    if cells:
        scope.counter("cells").inc(int(cells))
    tracing.count_cost("mesh_dispatch")


def snapshot() -> dict:
    """The telemetry.* slice of the instrument registry."""
    return {k: v for k, v in ROOT.snapshot().items()
            if k.startswith("telemetry.")}
