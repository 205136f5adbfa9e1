"""Mutable head buffer: columnar staging + batch device encode.

TPU-first redesign of the reference's per-series mutable encoders
(src/dbnode/storage/series/buffer.go: dbBuffer with 3 rotating block-aligned
buckets, each holding one-or-more M3TSZ encoders that absorb out-of-order
writes and merge on drain). Encoding per-datapoint on device would be a
host<->device ping-pong per write; instead each shard stages writes in plain
columnar arrays (series index, timestamp, value) bucketed by block start —
O(1) appends, no per-write compression — and the whole bucket is encoded in
ONE batched kernel launch when the block seals (tick) or snapshots.

Out-of-order and duplicate writes land naturally in the columns; the sort at
seal time replaces the reference's multi-encoder merge (buffer.go:244-307),
with last-arrival-wins on duplicate timestamps matching the reference's
"latest write wins within a bucket" drain behavior. The acceptance window
(buffer_past/buffer_future) bounds live buckets to ~3, mirroring
buffer.go:51's bucketsLen=3 invariant structurally rather than by fixed
array."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils import xtime


class _Cols:
    """Growable (series_idx, time, value) columns with doubling storage."""

    __slots__ = ("sidx", "ts", "vals", "n")

    def __init__(self, cap: int = 1024):
        self.sidx = np.empty(cap, np.int32)
        self.ts = np.empty(cap, np.int64)
        self.vals = np.empty(cap, np.float64)
        self.n = 0

    def _grow(self, need: int):
        cap = len(self.sidx)
        if self.n + need <= cap:
            return
        new = max(cap * 2, self.n + need)
        for name in ("sidx", "ts", "vals"):
            arr = getattr(self, name)
            out = np.empty(new, arr.dtype)
            out[: self.n] = arr[: self.n]
            setattr(self, name, out)

    def append(self, si: int, t: int, v: float):
        self._grow(1)
        self.sidx[self.n] = si
        self.ts[self.n] = t
        self.vals[self.n] = v
        self.n += 1

    def extend(self, si: np.ndarray, t: np.ndarray, v: np.ndarray):
        k = len(si)
        self._grow(k)
        self.sidx[self.n : self.n + k] = si
        self.ts[self.n : self.n + k] = t
        self.vals[self.n : self.n + k] = v
        self.n += k

    def view(self):
        return self.sidx[: self.n], self.ts[: self.n], self.vals[: self.n]


@dataclasses.dataclass
class BlockBucket:
    """One block-start's staging columns (analog of a buffer bucket)."""

    block_start: int
    cols: _Cols = dataclasses.field(default_factory=_Cols)
    # Rows already drained to a snapshot (exclusive); snapshot persistence
    # reuses the same columns without copying.
    snapshotted_rows: int = 0

    @property
    def num_writes(self) -> int:
        return self.cols.n


def dedup_sorted(sidx, ts, vals):
    """Stable-sorted columns -> per-point last-arrival-wins dedup."""
    order = np.lexsort((np.arange(len(ts)), ts, sidx))  # stable by arrival
    sidx, ts, vals = sidx[order], ts[order], vals[order]
    if len(ts) > 1:
        nxt_same = (sidx[:-1] == sidx[1:]) & (ts[:-1] == ts[1:])
        keep = np.concatenate([~nxt_same, [True]])
        sidx, ts, vals = sidx[keep], ts[keep], vals[keep]
    return sidx, ts, vals


def to_dense(sidx, ts, vals):
    """Grouped columns -> dense [S, W] tiles + per-series counts.

    Returns (series_indices [S], timestamps [S, W], values [S, W],
    npoints [S]) with W = max points per series; padding replicates each
    series' last point so the codec's delta math stays in range."""
    series, counts = np.unique(sidx, return_counts=True)
    s, w = len(series), int(counts.max(initial=1))
    tdense = np.zeros((s, w), np.int64)
    vdense = np.zeros((s, w), np.float64)
    row = np.repeat(np.arange(s), counts)
    col = np.arange(len(sidx)) - np.repeat(np.cumsum(counts) - counts, counts)
    tdense[row, col] = ts
    vdense[row, col] = vals
    # Pad tail with the last real point per series.
    lastc = counts - 1
    pad_t = tdense[np.arange(s), lastc]
    pad_v = vdense[np.arange(s), lastc]
    colg = np.arange(w)[None, :]
    padmask = colg >= counts[:, None]
    tdense = np.where(padmask, pad_t[:, None], tdense)
    vdense = np.where(padmask, pad_v[:, None], vdense)
    return series, tdense, vdense, counts.astype(np.int32)


class ShardBuffer:
    """All mutable buckets for one shard, keyed by block start."""

    def __init__(self, block_size_ns: int, buffer_past_ns: int, buffer_future_ns: int):
        self.block_size_ns = block_size_ns
        self.buffer_past_ns = buffer_past_ns
        self.buffer_future_ns = buffer_future_ns
        self.buckets: Dict[int, BlockBucket] = {}

    def _bucket(self, block_start: int) -> BlockBucket:
        b = self.buckets.get(block_start)
        if b is None:
            b = self.buckets[block_start] = BlockBucket(block_start)
        return b

    def accepts(self, now_ns: int, t_ns: int) -> bool:
        """Write-time acceptance window (series.go Write bounds checks)."""
        return now_ns - self.buffer_past_ns <= t_ns <= now_ns + self.buffer_future_ns

    def write(self, series_idx: int, t_ns: int, value: float):
        self._bucket(xtime.truncate(t_ns, self.block_size_ns)).cols.append(series_idx, t_ns, value)

    def write_batch(self, sidx: np.ndarray, ts: np.ndarray, vals: np.ndarray):
        starts = ts - ts % self.block_size_ns
        for bs in np.unique(starts):
            m = starts == bs
            self._bucket(int(bs)).cols.extend(sidx[m], ts[m], vals[m])

    def read(self, series_idx: int, start_ns: int, end_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        """Merged in-order datapoints for one series in [start, end)."""
        all_ts: List[np.ndarray] = []
        all_vals: List[np.ndarray] = []
        for bs in sorted(self.buckets):
            if bs + self.block_size_ns <= start_ns or bs >= end_ns:
                continue
            sidx, ts, vals = self.buckets[bs].cols.view()
            m = sidx == series_idx
            if not m.any():
                continue
            s, t, v = dedup_sorted(sidx[m], ts[m], vals[m])
            keep = (t >= start_ns) & (t < end_ns)
            all_ts.append(t[keep])
            all_vals.append(v[keep])
        if not all_ts:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        return np.concatenate(all_ts), np.concatenate(all_vals)

    def sealable(self, now_ns: int) -> List[int]:
        """Block starts no longer writable (block fully past buffer_past)."""
        return sorted(
            bs
            for bs in self.buckets
            if bs + self.block_size_ns + self.buffer_past_ns <= now_ns
        )

    def discard(self, block_start: int) -> None:
        """Drop the bucket (after its snapshot sealed)."""
        self.buckets.pop(block_start, None)

    def snapshot(self, block_start: int):
        """Dense tiles of the bucket's current contents, leaving it mutable
        (storage/flush.go snapshot semantics)."""
        b = self.buckets.get(block_start)
        if b is None or b.cols.n == 0:
            return None
        return to_dense(*dedup_sorted(*b.cols.view()))
