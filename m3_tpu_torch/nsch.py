"""Load generator (host copy of m3_tpu/nsch.py; reference: src/m3nsch —
coordinator + agents over gRPC, synthetic workload specs with
value-generator "datums", agents writing via the dbnode client at a
target QPS; CLI m3nsch_client).

Agents here are threads (in-process) or remote service endpoints; the same
Workload/datum model drives both and the benchmark harness."""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, List, Optional

import numpy as np


# ---------------------------------------------------------------- datums

class Datum:
    """Synthetic value generator (m3nsch/datums): deterministic value for
    (series, tick) so reads can verify writes."""

    def value(self, series_idx: int, tick: int) -> float:  # pragma: no cover
        raise NotImplementedError


class SawtoothDatum(Datum):
    def __init__(self, period: int = 100, amplitude: float = 100.0):
        self.period = period
        self.amplitude = amplitude

    def value(self, series_idx: int, tick: int) -> float:
        return (tick % self.period) / self.period * self.amplitude + series_idx


class SineDatum(Datum):
    def __init__(self, period: int = 60, amplitude: float = 50.0):
        self.period = period
        self.amplitude = amplitude

    def value(self, series_idx: int, tick: int) -> float:
        return self.amplitude * math.sin(2 * math.pi * tick / self.period) + series_idx


class CounterDatum(Datum):
    def __init__(self, rate: float = 10.0):
        self.rate = rate

    def value(self, series_idx: int, tick: int) -> float:
        return tick * self.rate + series_idx


# ---------------------------------------------------------------- workload

@dataclasses.dataclass
class Workload:
    """m3nsch workload spec (m3nsch/types.go Workload)."""

    namespace: bytes = b"default"
    metric_prefix: bytes = b"m3nsch.metric"
    cardinality: int = 1000
    ingress_qps: int = 1000
    datum: Datum = dataclasses.field(default_factory=SawtoothDatum)
    tagged: bool = False

    def series_id(self, i: int) -> bytes:
        return b"%s.%d" % (self.metric_prefix, i)

    def tags(self, i: int):
        return {b"__name__": self.metric_prefix, b"idx": b"%d" % i}


class Agent:
    """One write agent (m3nsch/agent): drives `write_fn` at the workload's
    QPS in batches, round-robining the series space."""

    def __init__(self, workload: Workload, write_fn: Callable,
                 clock: Optional[Callable[[], int]] = None,
                 batch_size: int = 100):
        """write_fn(namespace, series_id, tags_or_none, t_ns, value)."""
        self.workload = workload
        self._write = write_fn
        self._clock = clock or time.time_ns
        self._batch = batch_size
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.written = 0
        self.errors = 0
        self._tick = 0

    def run_for(self, n_writes: int) -> int:
        """Synchronous bounded run (for tests/benches)."""
        for _ in range(n_writes):
            self._write_one()
        return self.written

    def _write_one(self):
        w = self.workload
        i = self.written % w.cardinality
        if i == 0 and self.written:
            self._tick += 1
        try:
            self._write(w.namespace, w.series_id(i),
                        w.tags(i) if w.tagged else None,
                        self._clock(), w.datum.value(i, self._tick))
            self.written += 1
        except Exception:  # noqa: BLE001
            self.errors += 1

    def start(self) -> "Agent":
        def loop():
            qps = max(1, self.workload.ingress_qps)
            interval = self._batch / qps
            while not self._stop.is_set():
                t0 = time.monotonic()
                for _ in range(self._batch):
                    self._write_one()
                sleep = interval - (time.monotonic() - t0)
                if sleep > 0:
                    self._stop.wait(sleep)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def status(self) -> dict:
        return {"written": self.written, "errors": self.errors,
                "cardinality": self.workload.cardinality,
                "qps": self.workload.ingress_qps}


class NschCoordinator:
    """Drives a fleet of agents (m3nsch coordinator + m3nsch_client verbs:
    status/init/start/stop/modify)."""

    def __init__(self):
        self._agents: List[Agent] = []

    def init(self, workload: Workload, write_fns: List[Callable],
             clock=None) -> List[Agent]:
        self._agents = [Agent(workload, fn, clock=clock) for fn in write_fns]
        return self._agents

    def start(self):
        for a in self._agents:
            a.start()

    def stop(self):
        for a in self._agents:
            a.stop()

    def modify(self, **changes):
        """Adjust the live workload (m3nsch modify verb)."""
        for a in self._agents:
            a.workload = dataclasses.replace(a.workload, **changes)

    def status(self) -> dict:
        return {
            "agents": [a.status() for a in self._agents],
            "total_written": sum(a.written for a in self._agents),
            "total_errors": sum(a.errors for a in self._agents),
        }
