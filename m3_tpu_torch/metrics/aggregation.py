"""Aggregation type system (reference: src/metrics/aggregation/type.go).

Types name the statistics an aggregation window exposes; they map 1:1 onto
the mergeable moments / quantile kernels of ops/aggregation.py, so a
Types list is also the device-side output selector for elem consumption.

Host copy of m3_tpu/metrics/aggregation.py."""

from __future__ import annotations

import enum
from typing import Optional, Sequence

from .metric import MetricType


class AggType(enum.IntEnum):
    """Supported aggregation types (type.go:34-57). IDs are stable wire IDs."""

    UNKNOWN = 0
    LAST = 1
    MIN = 2
    MAX = 3
    MEAN = 4
    MEDIAN = 5
    COUNT = 6
    SUM = 7
    SUMSQ = 8
    STDEV = 9
    P10 = 10
    P20 = 11
    P30 = 12
    P40 = 13
    P50 = 14
    P60 = 15
    P70 = 16
    P80 = 17
    P90 = 18
    P95 = 19
    P99 = 20
    P999 = 21
    P9999 = 22

    def quantile(self) -> Optional[float]:
        """Quantile value when this is a percentile type (type.go:161)."""
        return _QUANTILES.get(self)

    def is_valid_for(self, mt: MetricType) -> bool:
        """Validity per metric type (type.go:133-158)."""
        if mt == MetricType.COUNTER:
            return self in _COUNTER_VALID
        if mt == MetricType.TIMER:
            return self != AggType.UNKNOWN and self != AggType.LAST
        if mt == MetricType.GAUGE:
            return self in _GAUGE_VALID
        return False

    @property
    def type_string(self) -> str:
        """Output-name suffix (types_options.go defaultTypeStringsMap:
        Min -> 'lower', Max -> 'upper', quantiles -> 'p50'...)."""
        if self in _TYPE_STRINGS:
            return _TYPE_STRINGS[self]
        q = self.quantile()
        if q is not None:
            return "p" + format(q * 100, "g").replace(".", "")
        return self.name.lower()


_QUANTILES = {
    AggType.P10: 0.1, AggType.P20: 0.2, AggType.P30: 0.3, AggType.P40: 0.4,
    AggType.P50: 0.5, AggType.MEDIAN: 0.5, AggType.P60: 0.6, AggType.P70: 0.7,
    AggType.P80: 0.8, AggType.P90: 0.9, AggType.P95: 0.95, AggType.P99: 0.99,
    AggType.P999: 0.999, AggType.P9999: 0.9999,
}

_COUNTER_VALID = {AggType.MIN, AggType.MAX, AggType.MEAN, AggType.COUNT,
                  AggType.SUM, AggType.SUMSQ, AggType.STDEV}
_GAUGE_VALID = _COUNTER_VALID | {AggType.LAST}

_TYPE_STRINGS = {
    AggType.LAST: "last", AggType.SUM: "sum", AggType.SUMSQ: "sum_sq",
    AggType.MEAN: "mean", AggType.MIN: "lower", AggType.MAX: "upper",
    AggType.COUNT: "count", AggType.STDEV: "stdev", AggType.MEDIAN: "median",
}

# Defaults per metric type (types_options.go:125-145).
DEFAULT_COUNTER_AGGREGATION_TYPES = (AggType.SUM,)
DEFAULT_TIMER_AGGREGATION_TYPES = (
    AggType.SUM, AggType.SUMSQ, AggType.MEAN, AggType.MIN, AggType.MAX,
    AggType.COUNT, AggType.STDEV, AggType.MEDIAN, AggType.P50, AggType.P95,
    AggType.P99,
)
DEFAULT_GAUGE_AGGREGATION_TYPES = (AggType.LAST,)


def default_types_for(mt: MetricType) -> tuple:
    return {
        MetricType.COUNTER: DEFAULT_COUNTER_AGGREGATION_TYPES,
        MetricType.TIMER: DEFAULT_TIMER_AGGREGATION_TYPES,
        MetricType.GAUGE: DEFAULT_GAUGE_AGGREGATION_TYPES,
    }[mt]


def is_expensive(types: Sequence[AggType]) -> bool:
    """Whether sumSq tracking is required (common.go:37 isExpensive)."""
    return AggType.SUMSQ in types or AggType.STDEV in types


class AggID:
    """Compressed aggregation-types bitmask (aggregation/id.go AggregationID).

    A Types list packs into one int bitmask for cheap wire transfer and
    equality; DEFAULT (0) means "use the metric type's defaults".
    """

    DEFAULT = 0

    @staticmethod
    def compress(types: Sequence[AggType]) -> int:
        mask = 0
        for t in types:
            if t == AggType.UNKNOWN:
                raise ValueError("cannot compress UNKNOWN aggregation type")
            mask |= 1 << int(t)
        return mask

    @staticmethod
    def decompress(mask: int) -> tuple:
        return tuple(t for t in AggType if t != AggType.UNKNOWN and mask & (1 << int(t)))


def parse_types(s: str) -> tuple:
    """Parse 'Sum,Max,P99' (type.go ParseTypes)."""
    out = []
    for part in s.split(","):
        part = part.strip()
        try:
            out.append(AggType[part.upper()])
        except KeyError:
            raise ValueError(f"invalid aggregation type {part!r}") from None
    return tuple(out)
