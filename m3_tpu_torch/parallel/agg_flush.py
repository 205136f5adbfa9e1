"""The aggregator flush's quantile ordering on the device, on one device
or split over the shard x time mesh (port of m3_tpu/parallel/agg_flush.py).

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
the indices. With several devices attached (parallel/ingest.flush_mesh)
and a tile of at least M3_TPU_MESH_AGG_MIN_CELLS cells (default 2048),
the rows, padded with count-0 windows to a multiple of the mesh, split
over every entry (make_mesh_rank_selector): rows are independent, so the
indices are bit-identical to one device's. A fault raises a typed
ComputeError on either route; unlike the reference, nothing falls back
to the single-device selection."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import guard
from . import mesh as pmesh
from . import telemetry
from .ingest import flush_mesh
from ..device import resolve
from ..ops import aggregation as agg
from ..utils import numwatch

# Pad the value axis to lane multiples. MUST match aggregator/list.py's
# _LANE: a NaN-bearing row's in-row +inf padding count is visible in the
# stable order, so every route must quantize width identically to select
# the same element.
LANE = 128


@functools.lru_cache(maxsize=64)
def make_mesh_rank_selector(mesh: pmesh.Mesh, width: int, qs: tuple):
    """Quantile rank selection over the shard x time mesh: the tile's
    rows (one staged window each) split over BOTH axes, every entry
    ordering its slice with the single-device selection
    (ops/aggregation.quantile_rank_select), the indices reassembled in
    row order."""

    def local_select(values, counts):
        return agg.quantile_rank_select(values, counts, qs)

    rows, rowc = (mesh.axis_names,), (mesh.axis_names, None)
    return pmesh.shard_map(local_select, mesh, in_specs=(rowc, rows),
                           out_specs=rowc)


def quantile_rank_rows(tile: np.ndarray, counts: np.ndarray, qs: tuple,
                       device=None) -> np.ndarray:
    """The flush's quantile ordering: [B, width] f32 tile + [B] int32
    counts -> [B, len(qs)] int32 in-row indices, through the guard's
    `agg_flush` route. Over the mesh when one is attached and the tile
    reaches the dispatch floor (a tiny flush costs more in dispatch than
    the split saves) and is of `device`'s type (mesh.for_device); else
    on `device` (the card unless the caller asks for the CPU). The
    indices are the same on both routes."""
    n, width = tile.shape
    mesh = pmesh.for_device(flush_mesh(), device)
    min_cells = int(os.environ.get("M3_TPU_MESH_AGG_MIN_CELLS", "2048"))
    if mesh is not None and n * width >= min_cells:
        pad = (-n) % mesh.size
        if pad:
            tile = np.concatenate([tile, np.zeros((pad, width), tile.dtype)])
            counts = np.concatenate([counts, np.zeros(pad, counts.dtype)])

        def mesh_select():
            telemetry.mesh_dispatch("agg_flush", cells=int(tile.size))
            sel = make_mesh_rank_selector(mesh, width, qs)
            idx = sel(torch.from_numpy(tile), torch.from_numpy(
                np.ascontiguousarray(counts, np.int32)))
            return idx.cpu().numpy()[:n]

        return guard.dispatch("agg_flush", mesh_select)
    dev = resolve(device)

    def select():
        # transient: the flush tile and counts live for this one quantile
        # selection
        values = torch.from_numpy(tile).to(dev)  # m3lint: disable=unbudgeted-device-put
        cnt = torch.from_numpy(np.ascontiguousarray(counts, np.int32)).to(dev)  # m3lint: disable=unbudgeted-device-put
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
