"""Flush output handlers (reference: src/aggregator/aggregator/handler/ —
blackhole, capture).

A handler receives fully-aggregated datapoints (id, timestamp, value,
storage policy), one at a time or as one flush round's columnar groups.

Host copy of the handler base, BlackholeHandler and CaptureHandler of
m3_tpu/aggregator/handler.py; the m3msg producer handler and its wire
helpers wait for the client slice."""

from __future__ import annotations

from typing import List, NamedTuple

from ..metrics.policy import StoragePolicy


class AggregatedMetric(NamedTuple):
    id: bytes
    time_nanos: int
    value: float
    storage_policy: StoragePolicy


def _tolist(col):
    return col.tolist() if hasattr(col, "tolist") else list(col)


class Handler:
    def handle(self, metric: AggregatedMetric):  # pragma: no cover - iface
        raise NotImplementedError

    # Adapter so handlers can be passed directly as MetricList flush_fn.
    def __call__(self, metric_id: bytes, time_nanos: int, value: float,
                 storage_policy: StoragePolicy):
        self.handle(AggregatedMetric(metric_id, time_nanos, value, storage_policy))

    def handle_columnar(self, groups):
        """One flush round's emissions as columnar groups of
        (ids, times int64 array, values f64 array, storage_policy) —
        the columnar flush (aggregator/list.py emit_batch) hands the
        WHOLE round in one call so handlers can batch per destination
        (a producer handler overrides it: one publish per topic shard per
        round). Default: unbatched per-datapoint handle()."""
        for ids, times, values, policy in groups:
            for mid, t, v in zip(ids, _tolist(times), _tolist(values)):
                self.handle(AggregatedMetric(mid, t, v, policy))


class BlackholeHandler(Handler):
    """Drops everything (handler/blackhole.go)."""

    def handle(self, metric: AggregatedMetric):
        pass


class CaptureHandler(Handler):
    """Accumulates flushed metrics in memory — the test sink."""

    def __init__(self):
        self.metrics: List[AggregatedMetric] = []

    def handle(self, metric: AggregatedMetric):
        self.metrics.append(metric)

    def by_id(self, metric_id: bytes) -> List[AggregatedMetric]:
        return [m for m in self.metrics if m.id == metric_id]
