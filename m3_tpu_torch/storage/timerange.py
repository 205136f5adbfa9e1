"""Shard time-range bookkeeping for bootstrap (host copy of
m3_tpu/storage/timerange.py; reference:
src/dbnode/storage/bootstrap/result — shard time ranges that
bootstrappers claim, with the unfulfilled remainder passed down the
chain)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

Range = Tuple[int, int]  # [start, end) ns


def normalize(ranges: Iterable[Range]) -> List[Range]:
    """Sort + coalesce overlapping/adjacent ranges."""
    rs = sorted((s, e) for s, e in ranges if e > s)
    out: List[Range] = []
    for s, e in rs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def subtract(a: Iterable[Range], b: Iterable[Range]) -> List[Range]:
    """a - b over [start, end) interval lists."""
    a = normalize(a)
    b = normalize(b)
    out: List[Range] = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def intersect(a: Iterable[Range], b: Iterable[Range]) -> List[Range]:
    a = normalize(a)
    b = normalize(b)
    out: List[Range] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlaps(ranges: Iterable[Range], s: int, e: int) -> bool:
    return bool(intersect(ranges, [(s, e)]))


class ShardTimeRanges:
    """shard id -> disjoint [start, end) ranges."""

    def __init__(self, m: Dict[int, List[Range]] = None):
        self.m: Dict[int, List[Range]] = {
            k: normalize(v) for k, v in (m or {}).items() if v
        }

    @staticmethod
    def uniform(shards: Iterable[int], start: int, end: int) -> "ShardTimeRanges":
        return ShardTimeRanges({s: [(start, end)] for s in shards})

    def copy(self) -> "ShardTimeRanges":
        return ShardTimeRanges({k: list(v) for k, v in self.m.items()})

    def subtract(self, other: "ShardTimeRanges") -> "ShardTimeRanges":
        out = {}
        for shard, ranges in self.m.items():
            rem = subtract(ranges, other.m.get(shard, []))
            if rem:
                out[shard] = rem
        return ShardTimeRanges(out)

    def add(self, shard: int, s: int, e: int):
        self.m[shard] = normalize(self.m.get(shard, []) + [(s, e)])

    def is_empty(self) -> bool:
        return not any(self.m.values())

    def shards(self) -> List[int]:
        return sorted(self.m)

    def ranges(self, shard: int) -> List[Range]:
        return self.m.get(shard, [])

    def total_ns(self) -> int:
        return sum(e - s for rs in self.m.values() for s, e in rs)

    def __repr__(self):
        return f"ShardTimeRanges({self.m!r})"

    def __eq__(self, other):
        return isinstance(other, ShardTimeRanges) and self.m == other.m
