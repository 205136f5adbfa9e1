"""Storage policies (reference: src/metrics/policy/{storage_policy,
resolution,retention,staged_policy,drop_policy}.go).

Host copy of m3_tpu/metrics/policy.py."""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from ..utils import xtime


@dataclasses.dataclass(frozen=True, order=True)
class Resolution:
    """Sampling resolution: window size + stored precision (resolution.go:43)."""

    window_ns: int
    precision: xtime.Unit = xtime.Unit.NONE

    def __post_init__(self):
        if self.precision == xtime.Unit.NONE:
            object.__setattr__(self, "precision", xtime.Unit.from_duration_ns(self.window_ns))

    def __str__(self) -> str:
        w = xtime.format_duration(self.window_ns)
        if xtime.Unit.from_duration_ns(self.window_ns) == self.precision:
            return w
        return f"{w}@1{_UNIT_SUFFIX[self.precision]}"


_UNIT_SUFFIX = {
    xtime.Unit.SECOND: "s", xtime.Unit.MILLISECOND: "ms",
    xtime.Unit.MICROSECOND: "us", xtime.Unit.NANOSECOND: "ns",
    xtime.Unit.MINUTE: "m", xtime.Unit.HOUR: "h", xtime.Unit.DAY: "d",
}
_SUFFIX_UNIT = {v: k for k, v in _UNIT_SUFFIX.items()}


@dataclasses.dataclass(frozen=True, order=True)
class StoragePolicy:
    """resolution:retention pair, e.g. '10s:2d' or '1m@1s:40d'
    (storage_policy.go:25, String :54)."""

    resolution: Resolution
    retention_ns: int

    @staticmethod
    def of(window: str, retention: str, precision: Optional[str] = None) -> "StoragePolicy":
        res = Resolution(
            xtime.parse_duration(window),
            _SUFFIX_UNIT[precision] if precision else xtime.Unit.NONE,
        )
        return StoragePolicy(res, xtime.parse_duration(retention))

    @staticmethod
    def parse(s: str) -> "StoragePolicy":
        """Parse 'window[@1precision]:retention' (storage_policy.go
        ParseStoragePolicy). Memoized: policies are drawn from a handful
        of configured strings but arrive once per datapoint on the
        aggregator's timed-metric wire, where re-parsing was 37% of the
        per-entry dispatch cost; instances are frozen so sharing is safe."""
        return _parse_storage_policy(s)

    def __str__(self) -> str:
        return f"{self.resolution}:{xtime.format_duration(self.retention_ns)}"


@functools.lru_cache(maxsize=1024)
def _parse_storage_policy(s: str) -> StoragePolicy:
    res_s, _, ret_s = s.partition(":")
    if not ret_s:
        raise ValueError(f"invalid storage policy {s!r}")
    win_s, _, prec_s = res_s.partition("@")
    precision = xtime.Unit.NONE
    if prec_s:
        if not prec_s.startswith("1") or prec_s[1:] not in _SUFFIX_UNIT:
            raise ValueError(f"invalid precision in storage policy {s!r}")
        precision = _SUFFIX_UNIT[prec_s[1:]]
    return StoragePolicy(Resolution(xtime.parse_duration(win_s), precision),
                         xtime.parse_duration(ret_s))


@dataclasses.dataclass(frozen=True)
class Policy:
    """StoragePolicy + aggregation-types override bitmask (policy.go Policy)."""

    storage_policy: StoragePolicy
    aggregation_id: int = 0  # AggID.DEFAULT means metric-type defaults


@dataclasses.dataclass(frozen=True)
class StagedPolicies:
    """Policies active from a cutover time (staged_policy.go)."""

    cutover_nanos: int
    tombstoned: bool
    policies: Tuple[Policy, ...] = ()


class DropPolicy:
    """Whether a mapping rule drops the metric entirely (drop_policy.go)."""

    NONE = 0
    DROP_MUST = 1
    DROP_IF_ONLY_MATCH = 2


DEFAULT_STAGED_POLICIES = StagedPolicies(0, False, ())
