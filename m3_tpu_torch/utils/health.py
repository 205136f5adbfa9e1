"""Overload health: bounded-work admission gates with priority shedding
and the process degradation state machine (reference: the coordinator's
m3msg ingest worker pools + dbnode queue watermarks; shedding discipline
per "The Tail at Scale" and DAGOR-style priority admission — drop the
cheapest traffic first, never the traffic that keeps the cluster alive).

  AdmissionGate   a bounded in-flight work budget with watermarks.
                  Below the high watermark everything is admitted; from
                  the high watermark to capacity BULK traffic (backfill)
                  is shed; at capacity NORMAL traffic is shed too.
                  CRITICAL traffic (health/admin probes, replication —
                  the traffic whose loss turns an overload into an
                  outage) is ALWAYS admitted and merely counted, so the
                  depth can exceed capacity by the critical overshoot.
                  Shedding raises the typed `Backpressure` so producers
                  back off instead of retrying hot.

  HealthTracker   ok -> degraded -> shedding state machine over
                  registered saturation sources (gate depths, enforcer
                  saturation from utils.limits, the HBM budget's
                  `hbm_pressure`, and parallel/guard's `compute_degraded`:
                  0.8 while any kernel route's breaker is not closed, so
                  compute faults read DEGRADED and never shed on their
                  own) with hysteresis, exported through instrument
                  gauges and the coordinator/aggregator HTTP health
                  endpoints.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .instrument import ROOT
from .limits import Backpressure

__all__ = ["Priority", "AdmissionGate", "HealthTracker", "DiskHealth",
           "TRACKER", "OK", "DEGRADED", "SHEDDING"]


class Priority(enum.IntEnum):
    """Shed order is highest value first: BULK backfill goes before
    NORMAL serving traffic; CRITICAL is never shed."""

    CRITICAL = 0   # health/admin probes, replication/bootstrap streams
    NORMAL = 1     # serving reads/writes
    BULK = 2       # backfill / batch imports


OK, DEGRADED, SHEDDING = "ok", "degraded", "shedding"
_STATE_ORDER = {OK: 0, DEGRADED: 1, SHEDDING: 2}


class AdmissionGate:
    """Bounded in-flight work counter with watermark shedding. `admit`
    raises Backpressure for shed work; every successful admit MUST be
    paired with `release` (use `held()` for scoped work)."""

    def __init__(self, capacity: int, high_watermark: float = 0.75,
                 name: str = "", tracker: Optional["HealthTracker"] = None,
                 tenant_weights: Optional[Dict[bytes, float]] = None):
        if capacity <= 0:
            raise ValueError(f"gate capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.high = max(1.0, high_watermark * capacity)
        self.name = name
        self._lock = threading.Lock()
        self._depth = 0
        self._max_depth = 0
        self._metrics = ROOT.sub_scope(f"admission.{name}" if name
                                       else "admission")
        self.admitted = 0
        self.shed: Dict[str, int] = {p.name.lower(): 0 for p in Priority}
        # Per-tenant weighted fair-share (DAGOR-style), engaged only past
        # the high watermark: each tenant's in-flight depth is capped at
        # weight/(Σ active weights + one reserve share) of capacity, so
        # one noisy tenant saturates its OWN share of the gate and a
        # quiet tenant arriving mid-burst is still admitted. CRITICAL
        # is never tenant-shed. Tenants are tracked only while they hold
        # depth, so the map is bounded by concurrent tenants.
        self._tenant_weights = dict(tenant_weights or {})
        self._tenant_depth: Dict[bytes, int] = {}
        self.shed_tenant = 0
        # Named gates auto-register as health sources (same-named gates
        # overwrite, so re-created services stay bounded in the tracker);
        # anonymous gates are ephemeral (tests, scoped tools) and must
        # not accumulate dead probes in the process-global tracker.
        if name:
            (tracker if tracker is not None else TRACKER).register(
                name, self.saturation)

    def _weight(self, tenant: bytes) -> float:
        return self._tenant_weights.get(tenant, 1.0)

    def _tenant_share_locked(self, tenant: bytes) -> float:
        """Fair share of capacity for `tenant`: capacity * w_t /
        (Σ weights of tenants holding depth + w_t + one reserve share).
        The reserve keeps a lone noisy tenant capped below the whole
        gate, so a newcomer always finds room (lock held)."""
        w = self._weight(tenant)
        active = sum(self._weight(t) for t, d in self._tenant_depth.items()
                     if d > 0 and t != tenant)
        return self.capacity * w / (active + w + 1.0)

    def try_admit(self, n: int = 1, priority: Priority = Priority.NORMAL,
                  tenant: Optional[bytes] = None) -> bool:
        with self._lock:
            depth = self._depth + n
            # Semaphore convention: a single request larger than the whole
            # budget is admitted when the gate is IDLE (it runs alone) —
            # otherwise an oversized batch frame would be deterministically
            # shed forever, a permanent drop no backoff can clear.
            if priority != Priority.CRITICAL and self._depth > 0:
                if depth > self.capacity or \
                        (priority == Priority.BULK and depth > self.high):
                    self.shed[priority.name.lower()] += n
                    self._metrics.counter(
                        f"shed.{priority.name.lower()}").inc(n)
                    return False
                # Past the high watermark the gate is contended: cap each
                # tenant at its weighted fair share of capacity, so one
                # noisy tenant saturates its own share, never the gate.
                if tenant is not None and depth > self.high:
                    td = self._tenant_depth.get(tenant, 0)
                    if td + n > self._tenant_share_locked(tenant):
                        self.shed[priority.name.lower()] += n
                        self.shed_tenant += n
                        self._metrics.counter("shed.tenant").inc(n)
                        return False
            self._depth = depth
            self._max_depth = max(self._max_depth, depth)
            self.admitted += n
            if tenant is not None:
                self._tenant_depth[tenant] = \
                    self._tenant_depth.get(tenant, 0) + n
            return True

    def admit(self, n: int = 1, priority: Priority = Priority.NORMAL,
              tenant: Optional[bytes] = None):
        if not self.try_admit(n, priority, tenant=tenant):
            raise Backpressure(
                f"{self.name or 'admission'}: {priority.name.lower()} work "
                f"shed at depth {self._depth}/{self.capacity} "
                f"(high watermark {self.high:g}"
                + (f", tenant {tenant!r}" if tenant is not None
                   else "") + ")")

    def release(self, n: int = 1, tenant: Optional[bytes] = None):
        with self._lock:
            self._depth = max(0, self._depth - n)
            if tenant is not None:
                td = self._tenant_depth.get(tenant, 0) - n
                if td > 0:
                    self._tenant_depth[tenant] = td
                else:
                    self._tenant_depth.pop(tenant, None)
            self._metrics.gauge("depth").update(self._depth)

    def tenant_depth(self, tenant: bytes) -> int:
        with self._lock:
            return self._tenant_depth.get(tenant, 0)

    def held(self, n: int = 1, priority: Priority = Priority.NORMAL,
             tenant: Optional[bytes] = None):
        """Context manager: admit on enter (raising Backpressure when
        shed), release on every exit path."""
        return _Held(self, n, priority, tenant)

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def max_depth(self) -> int:
        """High-water mark of in-flight depth (memory-bound assertions)."""
        with self._lock:
            return self._max_depth

    def saturation(self) -> float:
        with self._lock:
            return min(1.0, self._depth / self.capacity)

    def stats(self) -> dict:
        with self._lock:
            return {"depth": self._depth, "max_depth": self._max_depth,
                    "capacity": self.capacity, "high": self.high,
                    "admitted": self.admitted, "shed": dict(self.shed),
                    "shed_tenant": self.shed_tenant,
                    "tenants": dict(self._tenant_depth)}


class _Held:
    __slots__ = ("_gate", "_n", "_priority", "_tenant")

    def __init__(self, gate: AdmissionGate, n: int, priority: Priority,
                 tenant: Optional[bytes] = None):
        self._gate = gate
        self._n = n
        self._priority = priority
        self._tenant = tenant

    def __enter__(self):
        self._gate.admit(self._n, self._priority, tenant=self._tenant)
        return self._gate

    def __exit__(self, *exc):
        self._gate.release(self._n, tenant=self._tenant)
        return False


class DiskHealth:
    """Consecutive-failure breaker over durable-write health (the disk
    leg of the degradation story; the reference's fs bootstrapping +
    commitlog failure policies fold into its health reporting the same
    way). WAL append/fsync and fileset-flush failures call `failure()`;
    any durable-write success clears the streak.

    After `trip_after` CONSECUTIVE failures the node takes a READ-ONLY
    posture: `read_only()` is True — the write path sheds NORMAL/BULK
    writes with typed Backpressure while CRITICAL traffic and reads keep
    flowing — and `saturation()` reads 1.0 so a registered HealthTracker
    degrades the exported state. Recovery is automatic: the first
    successful durable write (flush retries keep probing via Retrier
    backoff) resets the streak and lifts the posture."""

    def __init__(self, trip_after: int = 3, name: str = "",
                 tracker: Optional["HealthTracker"] = None):
        if trip_after <= 0:
            raise ValueError(f"trip_after must be positive, got {trip_after}")
        self.trip_after = trip_after
        self._lock = threading.Lock()
        self._consecutive = 0
        self.failures = 0
        self.trips = 0
        if name:
            (tracker if tracker is not None else TRACKER).register(
                name, self.saturation)

    def failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            self.failures += 1
            tripped = self._consecutive == self.trip_after
        if tripped:
            self.trips += 1
            ROOT.sub_scope("health").counter("disk_read_only_trips").inc()

    def success(self) -> None:
        if self._consecutive == 0:
            return  # hot-path fast out: nothing to clear, skip the lock
        with self._lock:
            self._consecutive = 0

    def read_only(self) -> bool:
        with self._lock:
            return self._consecutive >= self.trip_after

    def saturation(self) -> float:
        with self._lock:
            return min(1.0, self._consecutive / self.trip_after)


class HealthTracker:
    """Degradation state machine over saturation sources in [0, 1].

    State is the max source saturation mapped through thresholds, with
    hysteresis: entering a worse state is immediate (overload must be
    visible NOW), leaving one requires dropping `recover_margin` below
    the threshold (so a gate oscillating at the boundary doesn't flap
    the exported state every sample)."""

    def __init__(self, degraded_at: float = 0.7, shedding_at: float = 0.95,
                 recover_margin: float = 0.1,
                 clock: Callable[[], float] = time.monotonic):
        self.degraded_at = degraded_at
        self.shedding_at = shedding_at
        self.recover_margin = recover_margin
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], float]] = {}
        self._state = OK
        self.transitions: List[Tuple[str, str, float]] = []

    def register(self, name: str, fn: Callable[[], float]):
        with self._lock:
            self._sources[name] = fn

    def unregister(self, name: str):
        with self._lock:
            self._sources.pop(name, None)

    def _sample(self) -> Dict[str, float]:
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for name, fn in sources.items():
            try:
                out[name] = max(0.0, min(1.0, float(fn())))
            except Exception:  # noqa: BLE001 — a dead probe reads saturated
                # A source that cannot answer is treated as fully
                # saturated: health must fail toward caution, not toward
                # green.
                out[name] = 1.0
        return out

    def _target_state(self, sat: float, current: str) -> str:
        # entering worse states: plain thresholds; leaving: margin below
        if sat >= self.shedding_at:
            return SHEDDING
        if current == SHEDDING and sat >= self.shedding_at - self.recover_margin:
            return SHEDDING
        if sat >= self.degraded_at:
            return DEGRADED
        if current in (DEGRADED, SHEDDING) and \
                sat >= self.degraded_at - self.recover_margin:
            return DEGRADED
        return OK

    def evaluate(self, sample: Optional[Dict[str, float]] = None) -> str:
        if sample is None:
            sample = self._sample()
        sat = max(sample.values()) if sample else 0.0
        with self._lock:
            new = self._target_state(sat, self._state)
            if new != self._state:
                self.transitions.append((self._state, new, self._clock()))
                self._state = new
            state = self._state
        scope = ROOT.sub_scope("health")
        scope.gauge("state").update(_STATE_ORDER[state])
        scope.gauge("saturation").update(sat)
        return state

    def state(self) -> str:
        return self.evaluate()

    def snapshot(self) -> dict:
        """One probe pass feeds BOTH the returned sources and the state
        transition: every /health hit samples once, and the reported
        state can never disagree with the saturations beside it."""
        sample = self._sample()
        return {"state": self.evaluate(sample), "sources": sample,
                "saturation": max(sample.values()) if sample else 0.0}


# Process-default tracker: gates auto-register here; the coordinator and
# aggregator HTTP health endpoints read it.
TRACKER = HealthTracker()
