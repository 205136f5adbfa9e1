"""Metrics instrumentation (reference: uber-go/tally scopes used in 136
files + instrument.Options carried in every component's options;
m3 reports its own metrics through itself).

A Scope is a tagged namespace of counters/gauges/histograms; snapshot()
feeds the /debug/vars HTTP endpoint and, dogfooding like the reference,
can be scraped straight into the coordinator's ingest path."""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def update(self, v: float):
        self._value = v

    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-boundary histogram (tally histogram with duration buckets)."""

    def __init__(self, boundaries: Tuple[float, ...] = (
            0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10)):
        self.boundaries = boundaries
        self._counts = [0] * (len(boundaries) + 1)
        self._lock = threading.Lock()
        self._sum = 0.0
        self._n = 0

    def record(self, v: float):
        i = 0
        while i < len(self.boundaries) and v > self.boundaries[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def snapshot(self) -> dict:
        # One consistent (counts, sum, n) triple under this histogram's
        # own lock — snapshot() is called OUTSIDE the root registry lock
        # (Scope.snapshot), so a racing record() must not tear the read.
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        return {"buckets": dict(zip([str(b) for b in self.boundaries] + ["+Inf"],
                                    counts)),
                "sum": total, "count": n}


class Timer:
    """Context-manager stopwatch recording seconds into a histogram."""

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.record(time.perf_counter() - self._t0)


class Scope:
    def __init__(self, prefix: str = "", tags: Optional[Dict[str, str]] = None,
                 _root: Optional["Scope"] = None):
        self.prefix = prefix
        self.tags = dict(tags or {})
        self._root = _root or self
        if _root is None:
            self._metrics: Dict[str, object] = {}
            self._lock = threading.Lock()

    def sub_scope(self, name: str, **tags) -> "Scope":
        prefix = f"{self.prefix}.{name}" if self.prefix else name
        return Scope(prefix, {**self.tags, **tags}, _root=self._root)

    def _key(self, name: str) -> str:
        full = f"{self.prefix}.{name}" if self.prefix else name
        if self.tags:
            tag_s = ",".join(f"{k}={v}" for k, v in sorted(self.tags.items()))
            full = f"{full}{{{tag_s}}}"
        return full

    def _get(self, name: str, factory):
        root = self._root
        key = self._key(name)
        with root._lock:
            m = root._metrics.get(key)
            if m is None:
                m = root._metrics[key] = factory()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, boundaries=None) -> Histogram:
        return self._get(name, lambda: Histogram(boundaries)
                         if boundaries else Histogram())

    def timer(self, name: str) -> Timer:
        return Timer(self.histogram(name))

    def snapshot(self) -> Dict[str, object]:
        # Copy metric REFS under the registry lock, snapshot OUTSIDE it:
        # Histogram.snapshot() takes its own lock, and holding the root
        # lock across every histogram made /debug/vars an O(metrics)
        # critical section that serialized against every _get() on the
        # hot path (plus a nested root->histogram lock acquisition).
        root = self._root
        with root._lock:
            metrics = sorted(root._metrics.items())
        out = {}
        for key, m in metrics:
            if isinstance(m, (Counter, Gauge)):
                out[key] = m.value()
            else:
                out[key] = m.snapshot()
        return out


ROOT = Scope()
