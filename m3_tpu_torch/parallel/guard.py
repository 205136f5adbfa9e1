"""Guarded device dispatch: the compute-fault plane (port of
m3_tpu/parallel/guard.py).

Every kernel route of the port dispatches through `dispatch()`: the pack
kernel (`codec.encode`, ops/tsz.encode_batch), the decode kernel
(`codec.decode`, ops/tsz._decode_core), the hash kernel (`codec.hash`,
utils/hashing.hash_batch), the block plane decode (`block.decode`,
storage/block._dispatch_decode) and the temporal device functions
(`temporal.rate`, `temporal.last_two_idx`, `temporal.over_time`,
`temporal.over_time_finish`, through `guarded_builder`).

  classify     torch's exception zoo collapses to a closed ComputeError
               taxonomy: CompileError / DeviceOOM / KernelFault /
               DispatchTimeout. Anything unclassifiable (a shape bug, a
               programming error) RE-RAISES untouched: a shape bug is not
               a device fault. A ComputeError raised by a guarded route
               nested inside a primary (block.decode runs codec.decode)
               passes through the outer route as it is: it was counted
               and charged to a breaker once, where it happened.
  breaker      per-route failure-rate Breaker (utils/retry.py): repeated
               classified faults trip the route OPEN and every dispatch
               raises at once until the cooldown's half-open probe
               succeeds.
  OOM retry    DeviceOOM triggers ONE forced `HBMBudget.reclaim_pass()`
               (cross-tenant LRU eviction even when the host ledger is
               under budget), then a single retry. It is the only retry.
  quarantine   a keyed dispatch that faults is put into a TTL'd
               quarantine set and its cache entry dropped through the
               caller's evictor; the key raises at once until the TTL.

The port never falls back. Where the reference degrades to a twin (the
XLA program for a Pallas route, the host codec for the block decode), the
port raises the typed ComputeError: the plain PyTorch versions run only on
CPU tensors, so on the card a fault, an open breaker, a quarantined key,
a second OOM and a validated corruption each end in a raise. On the CPU
the primary is the plain version, and the guard still types and counts.

A real asynchronous CUDA fault (an illegal address, a device-side assert)
poisons the CUDA context: every later call on that device fails too. After
one, the guard raises and the process should not retry on that device;
the breaker keeps later dispatches from piling onto it.

`elapsed` (held against the route's timeout) measures what the primary
blocks on: CUDA launches are asynchronous, so for a route that ends in a
device-to-host copy (block.decode) it is the whole dispatch, and for the
others only the enqueue.

Degradation is surfaced, never silent: `telemetry.compute_*` counts
dispatches, faults, trips, quarantines and OOM reclaims per route; the
process HealthTracker gains a `compute_degraded` probe (tripped breakers
read DEGRADED, never SHEDDING on their own); `debug_snapshot()` gives the
breaker states, quarantined keys and per-route counts.

The dispatch seam is installable: `testing/faultcomp.py` swaps in a seeded
fault injector whose schedule is a pure function of (seed, route,
call-index). Output validators (`validate=`) run ONLY while an injector
seam is installed; the guard adds no per-value work to clean dispatches.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional

import numpy as np

from . import telemetry
from ..utils import retry as uretry

__all__ = [
    "ComputeError", "CompileError", "DeviceOOM", "KernelFault",
    "DispatchTimeout", "classify", "dispatch", "available", "configure",
    "reset", "debug_snapshot", "install_seam", "uninstall_seam",
    "seam_active", "guarded_builder", "quarantined_keys", "is_quarantined",
    "poisoned", "GARBAGE_F", "GARBAGE_I",
]


# ------------------------------------------------------------- taxonomy


class ComputeError(Exception):
    """Base of the closed device/kernel fault taxonomy. `kind` values are
    telemetry tag values (a closed set)."""

    kind = "compute"

    def __init__(self, route: str, detail: str,
                 cause: Optional[BaseException] = None):
        super().__init__(f"{route}: {detail}")
        self.route = route
        self.detail = detail
        self.cause = cause


class CompileError(ComputeError):
    """The kernels' extension failed to build (nvcc, ninja, the loader)."""
    kind = "compile"


class DeviceOOM(ComputeError):
    """An allocation on the card failed."""
    kind = "oom"


class KernelFault(ComputeError):
    """A launched kernel or device call raised (or, under an injector
    seam, produced provably corrupt output)."""
    kind = "kernel"


class DispatchTimeout(ComputeError):
    """A dispatch exceeded the route's wall-clock budget."""
    kind = "timeout"


# Matched by type NAME (not import), as the reference does, so the
# classification works on every torch build: torch.AcceleratorError is
# new in recent releases, and subprocess.CalledProcessError is what a
# failing ninja build raises out of torch.utils.cpp_extension.load.
_OOM_TYPES = frozenset({"OutOfMemoryError"})
_FAULT_TYPES = frozenset({"AcceleratorError"})
_COMPILE_TYPES = frozenset({"CalledProcessError"})

_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory")
_FAULT_MARKERS = ("CUDA error", "an illegal memory access",
                  "device-side assert")
_COMPILE_MARKERS = ("Error building extension",)
_TIMEOUT_MARKERS = ("DEADLINE_EXCEEDED", "deadline exceeded", "timed out")


def _type_names(exc: BaseException) -> set:
    return {t.__name__ for t in type(exc).__mro__}


def classify(exc: BaseException, route: str) -> Optional[ComputeError]:
    """Collapse an exception into the ComputeError taxonomy, or None if
    it is not a device/kernel fault (the caller must re-raise). An
    already-typed ComputeError passes through."""
    if isinstance(exc, ComputeError):
        return exc
    msg = str(exc)
    names = _type_names(exc)
    if names & _OOM_TYPES or any(m in msg for m in _OOM_MARKERS):
        return DeviceOOM(route, msg, exc)
    if names & _COMPILE_TYPES or any(m in msg for m in _COMPILE_MARKERS):
        return CompileError(route, msg, exc)
    if any(m in msg for m in _TIMEOUT_MARKERS):
        return DispatchTimeout(route, msg, exc)
    if names & _FAULT_TYPES or (isinstance(exc, RuntimeError) and any(
            m in msg for m in _FAULT_MARKERS)):
        return KernelFault(route, msg, exc)
    return None


# ------------------------------------------------------------------ seam


class DispatchSeam:
    """The installable dispatch seam: production is a transparent
    passthrough; faultcomp installs a subclass whose `call` injects
    seeded faults."""

    def call(self, route: str, fn: Callable[[], Any]) -> Any:
        return fn()


_DEFAULT_SEAM = DispatchSeam()
_seam: DispatchSeam = _DEFAULT_SEAM


def install_seam(seam: DispatchSeam):
    global _seam
    _seam = seam


def uninstall_seam():
    global _seam
    _seam = _DEFAULT_SEAM


def seam_active() -> bool:
    return _seam is not _DEFAULT_SEAM


# -------------------------------------------------------- route registry


# Per-route defaults; `configure()` overrides them route by route.
COOLDOWN_S = 5.0  # breaker open -> half-open probe
TIMEOUT_S = 30.0  # a slower dispatch keeps its answer but counts a fault
QUARANTINE_TTL_S = 300.0  # a faulted key raises at once this long


class GuardedRoute:
    """Per-route breaker + quarantine."""

    def __init__(self, name: str,
                 opts: Optional[uretry.BreakerOptions] = None,
                 clock: Callable[[], float] = time.monotonic,
                 timeout_s: float = TIMEOUT_S,
                 quarantine_ttl_s: float = QUARANTINE_TTL_S):
        self.name = name
        self.clock = clock
        self.breaker = uretry.Breaker(
            opts or uretry.BreakerOptions(
                window=16, failure_ratio=0.5, min_samples=4,
                cooldown_s=COOLDOWN_S),
            clock=clock, name=f"compute.{name}")
        self.timeout_s = timeout_s
        self.quarantine_ttl_s = quarantine_ttl_s
        self._qlock = threading.Lock()
        self._quarantine: Dict[Hashable, float] = {}

    # ---------------------------------------------------------- quarantine

    def quarantine_add(self, key: Hashable):
        with self._qlock:
            self._quarantine[key] = self.clock() + self.quarantine_ttl_s

    def quarantined(self, key: Hashable) -> bool:
        with self._qlock:
            exp = self._quarantine.get(key)
            if exp is None:
                return False
            if self.clock() >= exp:
                del self._quarantine[key]
                return False
            return True

    def quarantine_keys(self) -> list:
        now = self.clock()
        with self._qlock:
            expired = [k for k, exp in self._quarantine.items()
                       if now >= exp]
            for k in expired:
                del self._quarantine[k]
            return list(self._quarantine)

    # ------------------------------------------------------------- breaker

    def _settle(self, record: Callable[[], None]):
        before = self.breaker.state
        record()
        after = self.breaker.state
        if after != before:
            telemetry.compute_trip(self.name, after)

    def record_failure(self):
        self._settle(self.breaker.record_failure)

    def record_success(self):
        self._settle(self.breaker.record_success)


_LOCK = threading.Lock()
_ROUTES: Dict[str, GuardedRoute] = {}
_PROBE_WIRED = False


def _wire_health_probe_locked():
    # Lazy, once: tripped breakers read DEGRADED (0.8 sits between the
    # tracker's degraded_at=0.7 and shedding_at=0.95); compute
    # degradation never sheds load on its own.
    global _PROBE_WIRED
    if _PROBE_WIRED:
        return
    from ..utils import health

    health.TRACKER.register("compute_degraded", _degradation)
    _PROBE_WIRED = True


def _degradation() -> float:
    with _LOCK:
        routes = list(_ROUTES.values())
    for r in routes:
        if r.breaker.state != uretry.Breaker.CLOSED:
            return 0.8
    return 0.0


def _route(name: str) -> GuardedRoute:
    with _LOCK:
        r = _ROUTES.get(name)
        if r is None:
            r = GuardedRoute(name)
            _ROUTES[name] = r
            _wire_health_probe_locked()
        return r


def configure(name: str, *,
              opts: Optional[uretry.BreakerOptions] = None,
              clock: Callable[[], float] = time.monotonic,
              timeout_s: float = TIMEOUT_S,
              quarantine_ttl_s: float = QUARANTINE_TTL_S) -> GuardedRoute:
    """(Re)build a route with explicit breaker options, clock, timeout
    and quarantine TTL: the surface for deterministic trip, half-open and
    quarantine-TTL drills."""
    with _LOCK:
        r = GuardedRoute(name, opts=opts, clock=clock, timeout_s=timeout_s,
                         quarantine_ttl_s=quarantine_ttl_s)
        _ROUTES[name] = r
        _wire_health_probe_locked()
        return r


def available(name: str) -> bool:
    """Cheap check: False while the route's breaker is OPEN. Does NOT
    consume a half-open probe slot."""
    with _LOCK:
        r = _ROUTES.get(name)
    return r is None or r.breaker.state != uretry.Breaker.OPEN


def quarantined_keys(name: str) -> list:
    with _LOCK:
        r = _ROUTES.get(name)
    return r.quarantine_keys() if r is not None else []


def is_quarantined(name: str, key: Hashable) -> bool:
    with _LOCK:
        r = _ROUTES.get(name)
    return r is not None and r.quarantined(key)


def reset():
    """Drop every route (breakers, quarantine). Test hygiene; the seam is
    managed separately (faultcomp.uninstall)."""
    with _LOCK:
        _ROUTES.clear()


# ------------------------------------------------------ corruption probe

# The poison values faultcomp writes into corrupted output planes. The
# guard owns the contract (faultcomp imports these): a fully-poisoned
# plane (every element NaN, or every element the garbage sentinel) is
# detectable without an oracle.
GARBAGE_F = 6.02214076e23
GARBAGE_I = -559038737  # 0xDEADBEEF as int32


def _iter_leaves(out):
    if isinstance(out, (tuple, list)):
        for v in out:
            yield from _iter_leaves(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _iter_leaves(v)
    elif hasattr(out, "dtype") and hasattr(out, "shape"):
        yield out


def garbage_int(dtype: np.dtype):
    """GARBAGE_I cast to an integer dtype, wrapping as a C cast does."""
    return np.asarray(GARBAGE_I, np.int64).astype(dtype)


def _poison_kind(leaf) -> Optional[str]:
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.numel() == 0 or leaf.dtype == torch.bool:
            return None
        if leaf.is_floating_point():
            if bool(torch.isnan(leaf).all()):
                return "all-NaN"
            return ("garbage-filled"
                    if bool((leaf == GARBAGE_F).all()) else None)
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return ("garbage-filled"
                if bool((leaf == int(garbage_int(np_dtype))).all()) else None)
    a = np.asarray(leaf)
    if a.size == 0:
        return None
    if a.dtype.kind == "f":
        if np.isnan(a).all():
            return "all-NaN"
        if (a == np.asarray(GARBAGE_F).astype(a.dtype)).all():
            return "garbage-filled"
    elif a.dtype.kind in "iu" and (a == garbage_int(a.dtype)).all():
        return "garbage-filled"
    return None


def poisoned(out) -> Optional[str]:
    """Default output validator: a detail string when any tensor or array
    leaf is a fully-poisoned plane (all-NaN, or every element equal to the
    garbage sentinel cast to its dtype). Consulted only while an injector
    seam is installed (see `dispatch`)."""
    for leaf in _iter_leaves(out):
        bad = _poison_kind(leaf)
        if bad is not None:
            return f"{bad} plane shape={tuple(leaf.shape)}"
    return None


# ------------------------------------------------------------- dispatch


def _oom_reclaim(route: str) -> int:
    from ..utils import hbm

    budget = hbm.shared_budget()
    freed = budget.reclaim()
    if freed == 0:
        # Host ledger under budget but the card said out of memory: force
        # one cross-tenant LRU pass anyway.
        freed = budget.reclaim_pass()
    telemetry.compute_oom_reclaim(route, freed)
    return freed


def _attempt(route: str, primary, validate):
    """One pass through the seam: (out, err). err is a ComputeError (a
    classified fault, or a validated corruption). An unclassifiable
    exception propagates, and so does a ComputeError raised by a guarded
    route nested inside the primary: it was typed, counted and charged to
    a breaker where it happened."""
    try:
        out = _seam.call(route, primary)
    except ComputeError:
        raise
    except Exception as exc:  # noqa: BLE001 — classified or re-raised
        err = classify(exc, route)
        if err is None:
            raise
        return None, err
    if validate is not None and seam_active():
        bad = validate(out)
        if bad is not None:
            return None, KernelFault(route, f"corrupted output: {bad}")
    return out, None


def dispatch(route: str,
             primary: Callable[[], Any],
             *,
             key: Optional[Hashable] = None,
             evict: Optional[Callable[[], None]] = None,
             validate: Optional[Callable[[Any], Optional[str]]] = poisoned):
    """Run `primary` through the guarded seam for `route`, returning its
    answer or raising a typed ComputeError.

    `key` names a cached executable or input bucket (quarantined after a
    fault; `evict` drops its cache entry, best-effort). `validate(out)`
    returns a detail string when the output is provably corrupt (default:
    the poisoned-plane probe), consulted ONLY while an injector seam is
    installed. Unclassifiable exceptions re-raise untouched."""
    r = _route(route)
    if key is not None and r.quarantined(key):
        telemetry.compute_route(route, primary=False)
        raise KernelFault(route, f"quarantined key {key!r}")
    if not r.breaker.allow():
        telemetry.compute_route(route, primary=False)
        raise ComputeError(route, "breaker open")

    # The allow() grant must settle exactly once (record_success /
    # record_failure / cancel) on every path: an unsettled grant leaks the
    # half-open probe slot and wedges the breaker half-open. The finally
    # is the backstop for exceptions between the grant and a settle.
    settled = False
    try:
        t0 = r.clock()
        try:
            out, err = _attempt(route, primary, validate)
        except Exception:
            r.breaker.cancel()  # not this route's fault: release the slot
            settled = True
            raise
        if err is None:
            if r.clock() - t0 > r.timeout_s:
                # The answer is VALID (the primary finished) but the route
                # is hanging: count the fault and keep the answer;
                # repeated delays trip the breaker.
                r.record_failure()
                settled = True
                telemetry.compute_fault(route, DispatchTimeout.kind)
            else:
                r.record_success()
                settled = True
            telemetry.compute_route(route, primary=True)
            return out

        telemetry.compute_fault(route, err.kind)
        if isinstance(err, DeviceOOM):
            _oom_reclaim(route)
            try:
                out, err2 = _attempt(route, primary, validate)
            except Exception:
                r.breaker.cancel()
                settled = True
                raise
            if err2 is None:
                r.record_success()
                settled = True
                telemetry.compute_route(route, primary=True)
                return out
            err = err2
            telemetry.compute_fault(route, err.kind)

        r.record_failure()
        settled = True
        if key is not None:
            r.quarantine_add(key)
            telemetry.compute_quarantine(route)
            if evict is not None:
                try:
                    evict()
                except Exception:  # noqa: BLE001 — eviction best-effort;
                    pass  # the quarantine set already blocks the key
        telemetry.compute_route(route, primary=False)
        raise err from err.cause
    finally:
        if not settled:
            r.breaker.cancel()


class _GuardedFn:
    """Wraps a builder-returned callable: each invocation dispatches
    through the guard."""

    __slots__ = ("route", "fn")

    def __init__(self, route: str, fn: Callable):
        self.route = route
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return dispatch(self.route, lambda: self.fn(*args, **kwargs))


def guarded_builder(route: str):
    """Stack above a cached builder of device functions:

        @guard.guarded_builder("temporal.rate")
        @functools.lru_cache(maxsize=256)
        def _rate_fn(W, ...): return functools.partial(rate_math, W=W, ...)

    The callables the builder returns are wrapped so every invocation
    dispatches through the guard. cache_info/cache_clear are forwarded."""

    def deco(builder: Callable):
        def wrapper(*args, **kwargs):
            return _GuardedFn(route, builder(*args, **kwargs))

        wrapper.cache_info = getattr(builder, "cache_info", None)
        wrapper.cache_clear = getattr(builder, "cache_clear", None)
        wrapper.__wrapped__ = builder
        wrapper.__name__ = getattr(builder, "__name__", "guarded")
        wrapper.__doc__ = getattr(builder, "__doc__", None)
        return wrapper

    return deco


# ---------------------------------------------------------- observability


def _route_counts(name: str, snap: dict) -> dict:
    """The route's telemetry.compute counters, keyed by counter name
    (faults by kind as `faults.<kind>`)."""
    out = {}
    prefix = "telemetry.compute."
    for k, v in snap.items():
        if not k.startswith(prefix) or "{" not in k:
            continue
        metric, tags = k[len(prefix):-1].split("{", 1)
        tag = dict(t.split("=", 1) for t in tags.split(","))
        if tag.get("route") != name:
            continue
        out[f"{metric}.{tag['kind']}" if "kind" in tag else metric] = v
    return out


def debug_snapshot() -> dict:
    """Per route: breaker state, quarantined keys and the route's
    telemetry counts (primary, raised, faults.<kind>, trip_<state>,
    quarantined, oom_reclaims)."""
    from ..utils.instrument import ROOT

    with _LOCK:
        routes = list(_ROUTES.values())
    snap = ROOT.snapshot()
    return {r.name: {
        "state": r.breaker.state,
        "quarantined": sorted(repr(k) for k in r.quarantine_keys()),
        "counts": _route_counts(r.name, snap),
    } for r in routes}
