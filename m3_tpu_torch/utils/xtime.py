"""Time units and duration helpers (reference: m3x/time xtime.Unit).

Timestamps throughout the framework are int64 nanoseconds; a Unit scales
them to the wire/storage precision (the reference stores per-namespace
precision in namespace options and encodes the unit in the M3TSZ stream's
time-unit markers, src/dbnode/encoding/m3tsz/encoder.go:167-202).
"""

from __future__ import annotations

import enum
import re


class Unit(enum.IntEnum):
    NONE = 0
    SECOND = 1
    MILLISECOND = 2
    MICROSECOND = 3
    NANOSECOND = 4
    MINUTE = 5
    HOUR = 6
    DAY = 7

    @property
    def nanos(self) -> int:
        return _UNIT_NANOS[self]

    @classmethod
    def from_duration_ns(cls, ns: int) -> "Unit":
        """Largest unit that evenly divides ns (m3x xtime.UnitFromDuration)."""
        for u in (Unit.DAY, Unit.HOUR, Unit.MINUTE, Unit.SECOND, Unit.MILLISECOND, Unit.MICROSECOND):
            if ns and ns % _UNIT_NANOS[u] == 0:
                return u
        return Unit.NANOSECOND


_UNIT_NANOS = {
    Unit.NONE: 0,
    Unit.NANOSECOND: 1,
    Unit.MICROSECOND: 1_000,
    Unit.MILLISECOND: 1_000_000,
    Unit.SECOND: 1_000_000_000,
    Unit.MINUTE: 60 * 1_000_000_000,
    Unit.HOUR: 3600 * 1_000_000_000,
    Unit.DAY: 24 * 3600 * 1_000_000_000,
}

_SUFFIX_NANOS = {
    "ns": 1,
    "us": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
    "d": 24 * 3600 * 1_000_000_000,
    "w": 7 * 24 * 3600 * 1_000_000_000,
    "y": 365 * 24 * 3600 * 1_000_000_000,
}

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|ms|s|m|h|d|w|y)")

SECOND = _SUFFIX_NANOS["s"]
MINUTE = _SUFFIX_NANOS["m"]
HOUR = _SUFFIX_NANOS["h"]
DAY = _SUFFIX_NANOS["d"]


def parse_duration(s: str) -> int:
    """'10s' / '1m' / '2h30m' / '40d' -> nanoseconds."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    pos, total = 0, 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration {s!r}")
        total += int(float(m.group(1)) * _SUFFIX_NANOS[m.group(2)])
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration {s!r}")
    return total


def format_duration(ns: int) -> str:
    """Nanoseconds -> compact duration string ('90s' -> '1m30s')."""
    if ns == 0:
        return "0s"
    out = []
    for suffix in ("d", "h", "m", "s", "ms", "us", "ns"):
        n = _SUFFIX_NANOS[suffix]
        if ns >= n:
            q, ns = divmod(ns, n)
            out.append(f"{q}{suffix}")
    return "".join(out)


def truncate(t_ns: int, window_ns: int) -> int:
    """Floor t to a window boundary (blockstart alignment, storage/series)."""
    return t_ns - t_ns % window_ns
