"""Cross-series (instant-vector) aggregation (reference: src/query/
functions/aggregation/{function,take,count_values}.go — sum/min/max/avg/
count/stddev/stdvar/quantile and topk/bottomk grouped by labels).
Counterpart of m3_tpu/ops/series_agg.py.

Grouping structure (which output row each series feeds) is label algebra
and stays on the host. `grouped_reduce` is the f32 device segment reduce
over the [n_series, n_steps] matrix (index_add_ / scatter_reduce_);
`grouped_reduce_f64` is the exact host form the engine uses below its
fan-in threshold. NaN cells are excluded the way the reference skips
missing points."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

F32 = torch.float32


def _segment_sum(x, gid, n_groups: int):
    out = torch.zeros((n_groups, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, gid, x)


def _segment_extreme(x, gid, n_groups: int, largest: bool):
    """Segment min (or max) with XLA's signed-zero order: -0.0 below +0.0.
    scatter_reduce_ keeps whichever zero it meets first, so a zero result
    takes its sign from whether the group holds a -0.0 (min) or a +0.0
    (max) at that step."""
    fill = float("-inf") if largest else float("inf")
    out = torch.full((n_groups, x.shape[1]), fill, dtype=x.dtype,
                     device=x.device)
    idx = gid[:, None].expand_as(x)
    out.scatter_reduce_(0, idx, x, "amax" if largest else "amin",
                        include_self=True)
    zeros = (x == 0) & (torch.signbit(x) != largest)
    has = _segment_sum(zeros.to(F32), gid, n_groups) > 0
    zero = torch.where(has, 0.0, -0.0) if largest else torch.where(has, -0.0, 0.0)
    return torch.where(out == 0, zero, out)


def _segment_math(values, gid, n_groups: int, kind: str):
    mask = torch.isfinite(values)
    z = torch.where(mask, values, 0.0)
    cnt = _segment_sum(mask.to(F32), gid, n_groups)
    if kind == "count":
        out = cnt
    elif kind == "sum":
        out = _segment_sum(z, gid, n_groups)
    elif kind == "avg":
        out = _segment_sum(z, gid, n_groups) / cnt.clamp(min=1)
    elif kind == "min":
        out = _segment_extreme(torch.where(mask, values, float("inf")), gid,
                               n_groups, largest=False)
    elif kind == "max":
        out = _segment_extreme(torch.where(mask, values, float("-inf")), gid,
                               n_groups, largest=True)
    elif kind in ("stddev", "stdvar"):
        mu = _segment_sum(z, gid, n_groups) / cnt.clamp(min=1)
        dev = torch.where(mask, values - mu[gid], 0.0)
        var = _segment_sum(dev * dev, gid, n_groups) / cnt.clamp(min=1)
        out = torch.sqrt(var) if kind == "stddev" else var  # population
    else:
        raise ValueError(kind)
    return torch.where(cnt > 0, out, float("nan"))


def grouped_reduce(values: np.ndarray, group_ids: np.ndarray, n_groups: int,
                   kind: str, device=None) -> np.ndarray:
    """[S, T] + group id per series -> [G, T] f64, computed in f32 on
    `device` (one upload of the f32 plane, one download of the result)."""
    dev = resolve(device)
    if values.size == 0:
        return np.full((n_groups, values.shape[1]), np.nan)
    # transient: the f32 plane and its group ids live only for this reduce,
    # whose f64 result goes back to the host
    v = torch.from_numpy(np.ascontiguousarray(values, np.float32)).to(dev)  # m3lint: disable=unbudgeted-device-put
    gid = torch.from_numpy(np.asarray(group_ids, np.int64)).to(dev)  # m3lint: disable=unbudgeted-device-put
    out = _segment_math(v, gid, n_groups, kind)
    return out.cpu().numpy().astype(np.float64)


def grouped_reduce_f64(values: np.ndarray, group_ids: np.ndarray,
                       n_groups: int, kind: str) -> np.ndarray:
    """Exact-f64 host fallback used when magnitudes demand it (counter sums):
    same semantics as grouped_reduce via np.add.at on the f64 matrix."""
    S, T = values.shape
    mask = np.isfinite(values)
    z = np.where(mask, values, 0.0)
    cnt = np.zeros((n_groups, T))
    np.add.at(cnt, group_ids, mask.astype(np.float64))
    if kind == "count":
        out = cnt
    elif kind in ("sum", "avg", "stddev", "stdvar"):
        s = np.zeros((n_groups, T))
        np.add.at(s, group_ids, z)
        if kind == "sum":
            out = s
        else:
            mu = s / np.maximum(cnt, 1)
            if kind == "avg":
                out = mu
            else:
                dev = np.where(mask, values - mu[group_ids], 0.0)
                m2 = np.zeros((n_groups, T))
                np.add.at(m2, group_ids, dev * dev)
                var = m2 / np.maximum(cnt, 1)
                out = np.sqrt(var) if kind == "stddev" else var
    elif kind == "min":
        out = np.full((n_groups, T), np.inf)
        np.minimum.at(out, group_ids, np.where(mask, values, np.inf))
    elif kind == "max":
        out = np.full((n_groups, T), -np.inf)
        np.maximum.at(out, group_ids, np.where(mask, values, -np.inf))
    else:
        raise ValueError(kind)
    return np.where(cnt > 0, out, np.nan)


def grouped_quantile(values: np.ndarray, group_ids: np.ndarray,
                     n_groups: int, q: float) -> np.ndarray:
    """promql quantile(): linear-interpolated quantile across the series of
    each group, per step (host — group sizes are ragged and small)."""
    S, T = values.shape
    out = np.full((n_groups, T), np.nan)
    for g in range(n_groups):
        rows = values[group_ids == g]
        if rows.size == 0:
            continue
        with np.errstate(invalid="ignore"):
            out[g] = np.nanquantile(rows, q, axis=0)
    return out


def topk_mask(values: np.ndarray, group_ids: np.ndarray, n_groups: int,
              k: int, largest: bool) -> np.ndarray:
    """Per-step membership mask for topk/bottomk (aggregation/take.go):
    True where the series is among its group's k best at that step."""
    S, T = values.shape
    keep = np.zeros((S, T), dtype=bool)
    for g in range(n_groups):
        sel = np.flatnonzero(group_ids == g)
        if sel.size == 0:
            continue
        rows = values[sel]  # [Sg, T]
        filled = np.where(np.isfinite(rows), rows,
                          -np.inf if largest else np.inf)
        order = np.argsort(-filled if largest else filled, axis=0, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order, np.arange(sel.size)[:, None], axis=0)
        keep[sel] = (ranks < k) & np.isfinite(rows)
    return keep


# ------------------------------------------------- packed rank selection
#
# Group-packed forms of topk_mask / grouped_quantile for the whole-plan
# compiler (parallel/compile.py; m3_tpu/ops/series_agg.py's
# packed_*_math): bind() packs each group's rows contiguously into a
# [G_pad, Smax_pad] permutation (original row order within the group, -1
# padding), the device sorts along the packed axis, and only the plan's
# value planes move. Every sort is stable, as jnp's are, and treats -0.0
# and +0.0 as equal keys, as XLA's sort does.


def packed_gather_math(values, perm, g_pad: int, smax_pad: int):
    """[S_pad, T] plane + flat perm [G_pad*Smax_pad] -> packed
    [G_pad, Smax_pad, T] volume with NaN at unused slots."""
    valid = (perm >= 0)[:, None]
    packed = torch.where(valid, values[perm.clamp(min=0)], float("nan"))
    return packed.reshape(g_pad, smax_pad, values.shape[-1])


def packed_topk_keep_math(packed_hi, packed_lo, k, largest: bool):
    """Per-step membership mask in packed space: True where the slot's
    value is among its group's k best at that step (ties broken by slot
    order — original row order within the group, the same stable-argsort
    tie-break as topk_mask).

    Membership is DISCRETE, so ranking must not lose to f32 granularity:
    callers pass the value as an exact double-f32 split (hi = f32(v),
    lo = f32(v - hi) — zeros when the plane is f32-native; |lo| <
    ulp(hi)/2, so v-order IS lexicographic (hi, lo)-order), and the
    rank comes from a two-pass stable sort — secondary key lo first,
    then primary key hi — which is exactly the interpreter's f64 sort
    for every value the split round-trips. Sorting hi alone would let
    sub-ulp counter differences (64 at 1e9) scramble the surviving
    series set."""
    finite = torch.isfinite(packed_hi)
    s = -1.0 if largest else 1.0   # -v = (-hi) + (-lo): exact either way
    hi_key = torch.where(finite, s * packed_hi, float("inf"))
    lo_key = torch.where(finite, s * packed_lo, 0.0)
    order1 = torch.argsort(lo_key, dim=1, stable=True)
    hi_by_lo = torch.gather(hi_key, 1, order1)
    order2 = torch.argsort(hi_by_lo, dim=1, stable=True)
    order = torch.gather(order1, 1, order2)
    ranks = torch.argsort(order, dim=1)
    return (ranks < k) & finite


def packed_quantile_math(packed, q):
    """promql quantile() over the packed volume: linearly-interpolated
    quantile at rank q*(n-1) across each group's slots, per step
    (grouped_quantile's np.nanquantile semantics, on the device)."""
    smax = packed.shape[1]
    finite = torch.isfinite(packed)
    cnt = finite.sum(1)
    s = torch.sort(torch.where(finite, packed, float("inf")), dim=1,
                   stable=True).values
    pos = q * (cnt - 1).to(F32)
    lo = torch.floor(pos).to(torch.int64).clamp(0, smax - 1)
    hi = (lo + 1).clamp(0, smax - 1)
    frac = pos - lo.to(F32)
    zs = torch.where(torch.isfinite(s), s, 0.0)
    v_lo = torch.gather(zs, 1, lo[:, None, :])[:, 0, :]
    v_hi = torch.where(hi < cnt, torch.gather(zs, 1, hi[:, None, :])[:, 0, :],
                       v_lo)
    out = v_lo + (v_hi - v_lo) * frac
    return torch.where(cnt > 0, out, float("nan"))


def count_values(values: np.ndarray, group_ids: np.ndarray,
                 n_groups: int) -> dict:
    """promql count_values(): per (group, step, value) counts; returns
    {(g, value): [T] counts} (aggregation/count_values.go)."""
    out = {}
    S, T = values.shape
    for g in range(n_groups):
        rows = values[group_ids == g]
        for t in range(T):
            col = rows[:, t]
            col = col[np.isfinite(col)]
            for v in np.unique(col):
                key = (g, float(v))
                if key not in out:
                    out[key] = np.zeros(T)
                out[key][t] = (col == v).sum()
    return out
