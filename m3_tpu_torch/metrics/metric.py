"""Core metric value types (reference: src/metrics/metric/types.go and
metric/unaggregated/types.go MetricUnion).

Host copy of m3_tpu/metrics/metric.py."""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple


class MetricType(enum.IntEnum):
    """Unaggregated metric types (metric/types.go)."""

    UNKNOWN = 0
    COUNTER = 1
    TIMER = 2
    GAUGE = 3


@dataclasses.dataclass(frozen=True)
class MetricUnion:
    """One unaggregated sample as ingested by the aggregator
    (metric/unaggregated/types.go MetricUnion): a counter int value, a gauge
    float value, or a batch of timer values."""

    type: MetricType
    id: bytes
    counter_val: int = 0
    batch_timer_val: Tuple[float, ...] = ()
    gauge_val: float = 0.0
    annotation: bytes = b""

    @staticmethod
    def counter(id: bytes, value: int) -> "MetricUnion":
        return MetricUnion(MetricType.COUNTER, id, counter_val=value)

    @staticmethod
    def batch_timer(id: bytes, values: Sequence[float]) -> "MetricUnion":
        return MetricUnion(MetricType.TIMER, id, batch_timer_val=tuple(values))

    @staticmethod
    def gauge(id: bytes, value: float) -> "MetricUnion":
        return MetricUnion(MetricType.GAUGE, id, gauge_val=value)


@dataclasses.dataclass(frozen=True)
class Metric:
    """An aggregated metric sample (metric/aggregated/types.go Metric)."""

    id: bytes
    time_nanos: int
    value: float


@dataclasses.dataclass(frozen=True)
class TimedMetric:
    """A timed metric with an explicit client timestamp."""

    type: MetricType
    id: bytes
    time_nanos: int
    value: float
