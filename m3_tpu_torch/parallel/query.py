"""Sharded scatter-gather query execution over the device mesh (port of
m3_tpu/parallel/query.py).

The reference's distributed query path is coordinator fanout: each dbnode
computes partial results for its shards and the coordinator merges
(src/query/storage/fanout and the session's cross-replica merge). Over
the mesh the same shape is a collective: the gridded series split over
the "shard" axis, every entry runs the fused rate math on its slice and
reduces across its own series, and one psum/pmin/pmax over the entries
(parallel/mesh, in slice order) gives the global aggregate; the host sees
only the final [steps] vector."""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import mesh as pmesh
from . import telemetry
from ..ops import temporal

# (is_counter, is_rate) per supported range function: the rate family all
# reduces to temporal.rate_math.
RANGE_FUNCS = {"rate": (True, True), "increase": (True, False),
               "delta": (False, False)}
AGG_OPS = ("sum", "avg", "count", "min", "max")
SHARD = ("shard", None)


@functools.lru_cache(maxsize=64)
def make_sharded_agg_rate(mesh: pmesh.Mesh, *, op: str, func: str, W: int,
                          step_ns: int, range_ns: int, stride: int = 1):
    """One dashboard-shaped aggregation over the mesh: inputs [S, T]
    split on the "shard" axis (shard_grid's placement); returns a
    function giving the dense [T_out] global aggregate-by-step and the
    contributing-series count, on the mesh's first device.

    op(rate(m[5m])) for op in sum/avg/count/min/max is the canonical
    dashboard shape; NaN cells (windows without two samples) are left out
    per series, as the executor's NaN-aware host reduce does. Sums
    accumulate in f32 on the device, so they carry about
    sqrt(S) * 2^-24 relative error where the host path is exact f64.

    Cached on (mesh, shape parameters), as the reference caches its
    compiled program."""
    if op not in AGG_OPS:
        raise ValueError(f"unsupported sharded aggregation {op!r}")
    is_counter, is_rate = RANGE_FUNCS[func]
    math = functools.partial(
        temporal.rate_math, W=W, step_s=step_ns / 1e9,
        range_s=range_ns / 1e9, is_counter=is_counter, is_rate=is_rate,
        stride=stride)

    def local(adj, finite, grid32):
        out = math(adj, finite, grid32)            # [S_local, T_out]
        fin = torch.isfinite(out)
        if op in ("sum", "avg"):
            part = torch.where(fin, out, 0.0).sum(0)
        elif op == "min":
            part = torch.where(fin, out, float("inf")).amin(0)
        elif op == "max":
            part = torch.where(fin, out, float("-inf")).amax(0)
        else:
            part = None
        return part, fin.sum(0)

    def run(args):
        outs = pmesh.entry_map(lambda a: local(*a), args)
        n = pmesh.psum(pmesh.pick(outs, 1), mesh, "shard")
        if op == "count":
            total = pmesh.entry_map(lambda c: c.to(torch.float32), n)
        else:
            combine = {"min": pmesh.pmin, "max": pmesh.pmax}.get(op,
                                                               pmesh.psum)
            total = combine(pmesh.pick(outs, 0), mesh, "shard")
            if op == "avg":
                total = pmesh.entry_map(lambda t, c: t / c.clamp(min=1),
                                        total, n)
        return pmesh.gather(total, mesh, ()), pmesh.gather(n, mesh, ())

    return run


def make_sharded_sum_rate(mesh: pmesh.Mesh, *, W: int, step_ns: int,
                          range_ns: int):
    """The op="sum", func="rate" program."""
    return make_sharded_agg_rate(mesh, op="sum", func="rate", W=W,
                                 step_ns=step_ns, range_ns=range_ns)


def shard_grid(grid: np.ndarray, mesh: pmesh.Mesh, is_counter: bool = True):
    """Host prep and placement: f64 [S, T] grid -> (adj, finite, grid32)
    split over the mesh's "shard" axis, an object array with one tuple
    per entry. S pads with all-NaN rows (which contribute nothing) up to
    a multiple of the shard axis, so any S works."""
    n_shard = mesh.shape["shard"]
    pad = (-grid.shape[0]) % n_shard
    if pad:
        grid = np.concatenate(
            [grid, np.full((pad, grid.shape[1]), np.nan)], axis=0)
    adj, finite, grid32 = temporal.rate_inputs(grid, is_counter)
    if grid32 is None:
        grid32 = np.zeros_like(adj)
    planes = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (adj, finite, grid32)]
    return pmesh.map_slices(lambda *a: a, mesh, planes, [SHARD] * 3)


def agg_rate(grid: np.ndarray, mesh: pmesh.Mesh, *, op: str, func: str,
             W: int, step_ns: int, range_ns: int,
             stride: int = 1) -> np.ndarray:
    """op(func(...)) over the mesh, NaN where no series had a full
    window: the serving entry the query executor dispatches dashboard
    aggregations through (query/executor.py _eval_sharded_agg)."""
    is_counter, _ = RANGE_FUNCS[func]
    args = shard_grid(grid, mesh, is_counter)
    fn = make_sharded_agg_rate(mesh, op=op, func=func, W=W, step_ns=step_ns,
                               range_ns=range_ns, stride=stride)
    telemetry.mesh_dispatch("agg_rate", cells=int(np.asarray(grid).size))
    total, n = fn(args)
    total = total.cpu().numpy().astype(np.float64)
    n = n.cpu().numpy()
    return np.where(n > 0, total, np.nan)


def sum_rate(grid: np.ndarray, mesh: pmesh.Mesh, *, W: int, step_ns: int,
             range_ns: int) -> np.ndarray:
    """sum(rate(...)) over the mesh, NaN where no series had a full
    window."""
    return agg_rate(grid, mesh, op="sum", func="rate", W=W, step_ns=step_ns,
                    range_ns=range_ns)


def sum_rate_host_reference(grid: np.ndarray, *, W: int, step_ns: int,
                            range_ns: int, device=None) -> np.ndarray:
    """The single-device semantics sum_rate is held against: per-series
    rate on `device` (the card unless the caller asks for the CPU), a
    NaN-excluding f64 host sum, NaN where no series had a full window."""
    per_series = temporal.rate(grid, W, step_ns, range_ns, device=device)
    finite = np.isfinite(per_series)
    return np.where(finite.any(axis=0),
                    np.nansum(np.where(finite, per_series, 0.0), axis=0),
                    np.nan)
