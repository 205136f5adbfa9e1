"""Seeded open-loop load generator (port of m3_tpu/testing/loadgen.py,
the overload counterpart of faultnet): the SCHEDULE is a pure function of
the seed, so one seed IS one load shape, reproducible across runs,
machines and packages (the reference draws the same arrivals). Host code:
it has no device; the drills that drive it (testing/scenario.py) name
theirs.

Open loop matters: a closed-loop generator (next request after the last
completes) self-throttles exactly when the system degrades, hiding the
overload it was supposed to create ("The Tail at Scale" coordinated
omission). Here arrival times are fixed up front by the schedule; a slow
or shedding server changes RESULTS, never the offered load.

  LoadSchedule   phases of (duration x rate-multiplier) over a base
                 rate, plus a weighted kind mix. `arrivals()` expands it
                 to a deterministic [(t_offset_s, kind), ...] — per-slot
                 jittered, seeded, wall-clock-free.
  LoadGen        replays a schedule against a callable: dispatches each
                 arrival at its offset on its own thread (open loop),
                 records (kind, phase, latency, outcome).
  LoadReport     per-phase / per-kind throughput, latency quantiles and
                 outcome counts for assertions.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Phase", "LoadSchedule", "LoadGen", "LoadReport", "Record"]


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    duration_s: float
    rate_multiplier: float = 1.0


@dataclasses.dataclass(frozen=True)
class LoadSchedule:
    """Deterministic arrival plan. kinds: (kind, weight) pairs — weights
    are relative; kind selection comes from the same seeded stream as
    the jitter, so the full (time, kind) sequence is seed-stable."""

    seed: int = 0
    base_rate: float = 100.0            # requests/sec at multiplier 1.0
    phases: Tuple[Phase, ...] = (Phase("steady", 1.0, 1.0),)
    kinds: Tuple[Tuple[str, float], ...] = (("request", 1.0),)

    def arrivals(self) -> List[Tuple[float, str, str]]:
        """[(t_offset_s, kind, phase_name)] sorted by time — a pure
        function of the schedule fields (seeded RNG; no wall clock)."""
        rng = random.Random(f"loadgen/{self.seed}")
        kinds = [k for k, _ in self.kinds]
        weights = [w for _, w in self.kinds]
        out: List[Tuple[float, str, str]] = []
        start = 0.0
        for ph in self.phases:
            n = max(0, round(self.base_rate * ph.rate_multiplier
                             * ph.duration_s))
            if n:
                slot = ph.duration_s / n
                for i in range(n):
                    # jitter WITHIN each slot: arrivals stay ordered and
                    # near-uniform, so per-phase counts are exact while
                    # inter-arrival gaps still vary per seed
                    t = start + (i + rng.random()) * slot
                    kind = rng.choices(kinds, weights)[0]
                    out.append((t, kind, ph.name))
            start += ph.duration_s
        return out

    @property
    def total_duration_s(self) -> float:
        return sum(ph.duration_s for ph in self.phases)


@dataclasses.dataclass
class Record:
    t_due_s: float
    kind: str
    phase: str
    latency_s: float
    outcome: str      # "ok" or the exception type name


class LoadReport:
    def __init__(self, records: List[Record],
                 phase_durations: Dict[str, float]):
        self.records = records
        self._phase_durations = phase_durations

    def select(self, phase: Optional[str] = None, kind: Optional[str] = None,
               outcome: Optional[str] = None) -> List[Record]:
        return [r for r in self.records
                if (phase is None or r.phase == phase)
                and (kind is None or r.kind == kind)
                and (outcome is None or r.outcome == outcome)]

    def outcomes(self, phase: Optional[str] = None,
                 kind: Optional[str] = None) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.select(phase, kind):
            out[r.outcome] = out.get(r.outcome, 0) + 1
        return out

    def quantile_latency(self, q: float, phase: Optional[str] = None,
                         kind: Optional[str] = None,
                         outcome: Optional[str] = "ok") -> float:
        lats = sorted(r.latency_s for r in self.select(phase, kind, outcome))
        if not lats:
            return 0.0
        idx = min(len(lats) - 1, int(q * len(lats)))
        return lats[idx]

    def p99(self, **kw) -> float:
        return self.quantile_latency(0.99, **kw)

    def throughput(self, phase: str, kind: Optional[str] = None) -> float:
        """Successful completions per second of phase wall time."""
        dur = self._phase_durations.get(phase, 0.0)
        if dur <= 0:
            return 0.0
        return len(self.select(phase, kind, "ok")) / dur


class LoadGen:
    """Replays a LoadSchedule open-loop against fn(kind) -> None.

    Each arrival runs on its own (daemon) thread started at its offset:
    a stalled server cannot slow the offered rate. `time_scale` stretches
    the schedule (2.0 = half the offered rate at the same shape) for
    slow CI machines."""

    def __init__(self, schedule: LoadSchedule, time_scale: float = 1.0):
        self.schedule = schedule
        self.time_scale = time_scale

    def run(self, fn: Callable[[str], None],
            join_timeout_s: float = 30.0) -> LoadReport:
        arrivals = self.schedule.arrivals()
        records: List[Record] = []
        lock = threading.Lock()
        threads: List[threading.Thread] = []
        t0 = time.monotonic()

        def fire(due: float, kind: str, phase: str):
            t_start = time.monotonic()
            try:
                fn(kind)
                outcome = "ok"
            except Exception as e:  # noqa: BLE001 — outcomes are data here
                outcome = type(e).__name__
            lat = time.monotonic() - t_start
            with lock:
                records.append(Record(due, kind, phase, lat, outcome))

        for due, kind, phase in arrivals:
            delay = t0 + due * self.time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=fire, args=(due, kind, phase),
                                  daemon=True)
            th.start()
            threads.append(th)
        deadline = time.monotonic() + join_timeout_s
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        durations = {ph.name: ph.duration_s * self.time_scale
                     for ph in self.schedule.phases}
        with lock:
            done = list(records)
        done.sort(key=lambda r: r.t_due_s)
        return LoadReport(done, durations)
