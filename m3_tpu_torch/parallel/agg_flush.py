"""The aggregator flush's quantile ordering on the device (port of
m3_tpu/parallel/agg_flush.py, single device).

One flush round pads the closed windows of every quantile-bearing elem
(across resolutions, lists and aggregation shards) into one [rows, width]
f32 tile; the device orders each row (ops/aggregation.quantile_rank_select,
a stable argsort) and returns only in-row indices, and the host lands the
exact f64 quantile values with one columnar gather by those indices
(aggregator/list.py emit_batch). Moments stay host-exact f64
(np.reduceat in aggregator/list.py): the bit-exactness contract with the
reference's float64 accumulators cannot be met by f32 device sums.

The ordering dispatches through the compute-fault guard under the route
`agg_flush`: one H2D of the tile and counts, the selection, one D2H of
the indices. On the card a fault raises a typed ComputeError; there is no
fallback. The reference's mesh route (make_mesh_rank_selector and its
M3_TPU_MESH_AGG_MIN_CELLS floor) is not ported: one device."""

from __future__ import annotations

import numpy as np
import torch

from . import guard
from ..device import resolve
from ..ops import aggregation as agg
from ..utils import numwatch

# Pad the value axis to lane multiples. MUST match aggregator/list.py's
# _LANE: a NaN-bearing row's in-row +inf padding count is visible in the
# stable order, so every route must quantize width identically to select
# the same element.
LANE = 128


def quantile_rank_rows(tile: np.ndarray, counts: np.ndarray, qs: tuple,
                       device=None) -> np.ndarray:
    """The flush's quantile ordering on `device` (the card unless the
    caller asks for the CPU): [B, width] f32 tile + [B] int32 counts ->
    [B, len(qs)] int32 in-row indices, through the guard's `agg_flush`
    route."""
    dev = resolve(device)

    def select():
        values = torch.from_numpy(tile).to(dev)
        cnt = torch.from_numpy(np.ascontiguousarray(counts, np.int32)).to(dev)
        return agg.quantile_rank_select(values, cnt, qs).cpu().numpy()

    return guard.dispatch("agg_flush", select)


def build_quantile_tile(buckets, counts: np.ndarray):
    """Pad a ragged bucket list into the [B, width] f32 tile the rank
    selector consumes, width quantized to LANE multiples of the longest
    bucket (the rule of the oracle's _quantile_rows_for), with one
    vectorized scatter from the concatenation the exact-value gather
    reuses. Returns (tile f32, cat f64, starts int64): cat and starts
    locate each row's exact f64 values."""
    max_n = max(1, int(counts.max()))
    width = ((max_n + LANE - 1) // LANE) * LANE
    sizes = np.maximum(counts, 1)
    starts = np.zeros(len(buckets), dtype=np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    safe = [b if b.size else np.zeros(1) for b in buckets]
    cat = np.concatenate(safe)
    tile = np.zeros((len(buckets), width), dtype=np.float32)
    total = int(sizes.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
    rows = np.repeat(np.arange(len(buckets), dtype=np.int64), sizes)
    tile.ravel()[rows * width + within] = cat.astype(np.float32)
    # Empty rows scattered a placeholder 0 into column 0; their count is 0,
    # so the selector never reads it and the gather zeroes them.
    return tile, cat, starts


def exact_quantile_values(buckets, counts: np.ndarray, qs: tuple,
                          device=None):
    """Timer quantiles end to end: build the tile, order it on `device`,
    then one columnar host gather of the exact f64 values by index.
    Returns [B, len(qs)] f64, count-0 rows all zero (the stream.go:145-146
    empty convention)."""
    tile, cat, starts = build_quantile_tile(buckets, counts)
    idx = quantile_rank_rows(tile, counts.astype(np.int32), qs, device)
    safe_idx = np.minimum(idx.astype(np.int64),
                          np.maximum(counts - 1, 0)[:, None])
    vals = cat[starts[:, None] + safe_idx]
    vals[counts == 0] = 0.0
    if numwatch.installed():
        # Live rows carry the gathered exact values; count-0 rows must be
        # exactly zero (a non-zero there means a padding row's index
        # leaked into the gather).
        numwatch.observe_rows("agg_flush", vals, counts > 0)
    return vals
