"""Batched temporal (sliding-window) functions for the query engine
(reference: src/query/functions/temporal/{base,rate,aggregation}.go).
Counterpart of m3_tpu/ops/temporal.py: the rate family, irate/idelta and
the *_over_time moments.

Precision is the reference's, on purpose: the host keeps f64 (a
per-series baseline from `center`, the consecutive-diff pass
`_host_diff_grid`), the device computes on f32 residuals, and the
absolute-valued *_over_time results are finished either on the host in
f64 (exact) or on the device in f32 for large result grids, at the
reference's threshold. An f64 device path would give a different result,
not a faster one.

Window convention: output step t of the extended [S, K] grid reads
columns [t * stride, t * stride + W); T_out = (K - W) // stride + 1.
Every windowed reduction is a per-window accumulation over the unfolded
[S, T_out, W] view, never a cumsum difference (a global f32 prefix sum
cancels catastrophically on 1e13-sized counters). The masked window
moments run through K4 (ops/window_kernels.py) on the card.

Every public function takes `device` (None = the CUDA device, see
device.resolve); results come back to the host as numpy f64, once per
query, through the fetch closures of the *_async forms.

The device functions are built by cached builders under
`guard.guarded_builder` (routes temporal.rate, temporal.last_two_idx,
temporal.over_time, temporal.over_time_finish): every call dispatches
through the compute-fault guard, which raises a typed ComputeError on a
fault and never falls back."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve
from ..parallel import guard
from . import window_kernels

F32 = torch.float32


def extend_window_cells(range_ns: int, step_ns: int) -> int:
    """Number of grid cells per window: ceil-less R/s (prom half-open
    (t-R, t] with samples gridded at s)."""
    if range_ns % step_ns:
        raise ValueError(
            f"range {range_ns} not a multiple of step {step_ns}; "
            "the storage adapter grids at a divisor of the query step")
    return max(1, range_ns // step_ns)


def center(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split [S, T] f64 grid into (residual f32, baseline f64 [S])."""
    finite = np.isfinite(values)
    first_idx = np.argmax(finite, axis=1)
    has = finite.any(axis=1)
    baseline = np.where(
        has, values[np.arange(values.shape[0]), first_idx], 0.0)
    resid = (values - baseline[:, None]).astype(np.float32)
    return resid, baseline


def _put(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _window_volume(x, W: int, stride: int = 1):
    """[S, T_out, W] view of every stride-th window."""
    return x.unfold(-1, W, stride)


def _wsum(x, W: int, stride: int = 1):
    """Windowed f32 sum over the last axis, every stride-th window: each
    window accumulates only its own W cells (never a prefix-sum
    difference), so the error stays at W ulps of the window's own sum."""
    return _window_volume(x.to(F32), W, stride).sum(-1)


def _first_abs(finite, W: int, stride: int = 1):
    """Absolute index of each window's first valid cell (T when empty)."""
    T = finite.shape[-1]
    idxv = torch.where(finite, torch.arange(T, dtype=torch.int32,
                                            device=finite.device), T)
    return _window_volume(idxv, W, stride).amin(-1)


def _last_abs(finite, W: int, stride: int = 1):
    """Absolute index of each window's last valid cell (-1 when empty)."""
    T = finite.shape[-1]
    idxv = torch.where(finite, torch.arange(T, dtype=torch.int32,
                                            device=finite.device), -1)
    return _window_volume(idxv, W, stride).amax(-1)


def _take_t(grid, abs_idx):
    """Gather [S, T_out] values from [S, T] by absolute time index."""
    return torch.gather(grid, -1,
                        abs_idx.clamp(0, grid.shape[-1] - 1).to(torch.int64))


def rate_math(adj, finite, grid32=None, *, W, step_s, range_s, is_counter,
              is_rate, stride=1):
    """Fused rate/increase/delta: the window structure and promql's
    extrapolatedRate finish on f32 device tensors, already at the output
    step grid. The f64-sensitive consecutive-diff adjustment arrives
    pre-computed from the host (`rate_inputs`); abs_first (the counter
    zero clamp) reads the f32 absolute grid."""
    T = finite.shape[-1]
    T_out = (T - W) // stride + 1
    t_off = (torch.arange(T_out, dtype=torch.int32, device=finite.device)
             * stride)[None, :]
    cnt = _wsum(finite, W, stride)
    fa = _first_abs(finite, W, stride)
    la = _last_abs(finite, W, stride)
    # Only cells strictly after the window's first valid sample count:
    # the first valid cell's adj refers to a sample before the window.
    increase = _wsum(adj, W, stride) - _take_t(adj, fa)
    ok = cnt >= 2
    fi = (fa - t_off).to(F32)
    li = (la - t_off).to(F32)
    dur_start = (fi + 1) * step_s
    dur_end = (W - 1 - li) * step_s
    sampled = (li - fi) * step_s
    avg_dur = sampled / (cnt - 1).clamp(min=1)
    threshold = avg_dur * 1.1
    if is_counter:
        abs_first = _take_t(grid32, fa)
        dur_zero = torch.where(
            (increase > 0) & (abs_first >= 0),
            sampled * (abs_first / torch.where(increase > 0, increase, 1.0)),
            float("inf"))
        dur_start = torch.minimum(dur_start, dur_zero)
    extrap = (
        sampled
        + torch.where(dur_start < threshold, dur_start, avg_dur / 2)
        + torch.where(dur_end < threshold, dur_end, avg_dur / 2)
    )
    out = increase * (extrap / torch.where(sampled > 0, sampled, 1.0))
    if is_rate:
        out = out / range_s
    return torch.where(ok & (sampled > 0), out, float("nan"))


@guard.guarded_builder("temporal.rate")
@functools.lru_cache(maxsize=256)
def _rate_fn(W: int, step_s: float, range_s: float, is_counter: bool,
             is_rate: bool, stride: int = 1):
    """rate_math for one static (window, step, range, kind, stride)."""
    return functools.partial(rate_math, W=W, step_s=step_s, range_s=range_s,
                             is_counter=is_counter, is_rate=is_rate,
                             stride=stride)


def _host_diff_grid(grid: np.ndarray, is_counter: bool):
    """f64 host pass: per-cell adjusted diff vs the previous valid sample.
    adj[i] = v[i] - prev_valid (or v[i] itself at a counter reset, promql's
    reset correction). Small by construction — consecutive counter deltas
    and post-reset restart values — so the f32 device windowed sums hold
    full precision even for 1e9-magnitude counters."""
    finite = np.isfinite(grid)
    S, T = grid.shape
    idx = np.where(finite, np.arange(T)[None, :], -1)
    run = np.maximum.accumulate(idx, axis=1)
    prev_run = np.concatenate([np.full((S, 1), -1, run.dtype), run[:, :-1]], axis=1)
    rows = np.arange(S)[:, None]
    prev_val = np.where(prev_run >= 0, grid[rows, np.clip(prev_run, 0, T - 1)], np.nan)
    d = grid - prev_val
    if is_counter:
        adj = np.where(d < 0, grid, d)
    else:
        adj = d
    adj = np.where(finite & (prev_run >= 0), adj, 0.0)
    return adj.astype(np.float32), finite


def rate_inputs(grid: np.ndarray, is_counter: bool):
    """Host prep of the rate family: (adj f32, finite bool, grid32
    f32-or-None). NaNs become 0 in the f32 grid copy (validity rides
    `finite`), so the gather target is NaN-free; grid32 is None for
    non-counters — only the counter zero clamp reads it."""
    adj, finite = _host_diff_grid(grid, is_counter)
    grid32 = (np.where(finite, grid, 0.0).astype(np.float32)
              if is_counter else None)
    return adj, finite, grid32


def _extrapolated_async(grid: np.ndarray, W: int, step_ns: int, range_ns: int,
                        is_counter: bool, is_rate: bool, stride: int, device):
    """Dispatch side of rate/increase/delta: the f64 diff pass feeds the
    device math; returns a fetch closure for the one f32 result (already
    at the output step grid)."""
    dev = resolve(device)
    arrs = [_put(a, dev) if a is not None else None
            for a in rate_inputs(grid, is_counter)]
    out = _rate_fn(W, step_ns / 1e9, range_ns / 1e9, is_counter, is_rate,
                   stride)(*arrs)
    return lambda: _fetch(out)


def rate(grid, W, step_ns, range_ns, stride=1, device=None) -> np.ndarray:
    return _extrapolated_async(grid, W, step_ns, range_ns, True, True,
                               stride, device)()


def rate_async(grid, W, step_ns, range_ns, stride=1, device=None):
    return _extrapolated_async(grid, W, step_ns, range_ns, True, True,
                               stride, device)


def increase(grid, W, step_ns, range_ns, stride=1, device=None) -> np.ndarray:
    return _extrapolated_async(grid, W, step_ns, range_ns, True, False,
                               stride, device)()


def increase_async(grid, W, step_ns, range_ns, stride=1, device=None):
    return _extrapolated_async(grid, W, step_ns, range_ns, True, False,
                               stride, device)


def delta(grid, W, step_ns, range_ns, stride=1, device=None) -> np.ndarray:
    return _extrapolated_async(grid, W, step_ns, range_ns, False, False,
                               stride, device)()


def delta_async(grid, W, step_ns, range_ns, stride=1, device=None):
    return _extrapolated_async(grid, W, step_ns, range_ns, False, False,
                               stride, device)


@guard.guarded_builder("temporal.last_two_idx")
@functools.lru_cache(maxsize=256)
def _last_two_idx_fn(W: int, stride: int = 1):
    """irate/idelta index pass: last two valid window indices, [2, S,
    T_out] (-1 where missing)."""

    def fn(finite):
        mvol = _window_volume(finite, W, stride)
        Wr = torch.arange(W, device=finite.device)
        last_i = torch.where(mvol, Wr, -1).amax(-1)
        prev_i = torch.where(mvol & (Wr < last_i[..., None]), Wr, -1).amax(-1)
        return torch.stack([last_i, prev_i])

    return fn


def _instant(grid: np.ndarray, W: int, step_ns: int, is_rate: bool,
             stride: int, device) -> np.ndarray:
    """temporal/rate.go irateFn / promql instantValue: last two valid
    samples; a counter reset (v_last < v_prev) rates from zero. Values are
    gathered from the f64 grid by device-computed indices."""
    dev = resolve(device)
    finite = np.isfinite(grid)
    packed = _last_two_idx_fn(W, stride)(_put(finite, dev)).cpu().numpy()
    last_i, prev_i = packed[0], packed[1]
    ok = prev_i >= 0
    S, T_out = last_i.shape
    rows = np.arange(S)[:, None]
    t_base = np.arange(T_out)[None, :] * stride
    v_last = grid[rows, t_base + np.clip(last_i, 0, W - 1)]
    v_prev = grid[rows, t_base + np.clip(prev_i, 0, W - 1)]
    dt = (last_i - prev_i) * (step_ns / 1e9)
    with np.errstate(divide="ignore", invalid="ignore"):
        if is_rate:
            dv = np.where(v_last < v_prev, v_last, v_last - v_prev)
            out = dv / np.where(ok, dt, 1.0)
        else:
            out = v_last - v_prev
    return np.where(ok, out, np.nan)


def irate(grid, W, step_ns, stride=1, device=None) -> np.ndarray:
    return _instant(grid, W, step_ns, True, stride, device)


def idelta(grid, W, step_ns, stride=1, device=None) -> np.ndarray:
    return _instant(grid, W, step_ns, False, stride, device)


_OVER_TIME_STATS = {
    # kind -> which masked window moment the device returns
    "count": "count", "present": "count", "sum": "sum", "avg": "sum",
    "min": "min", "max": "max", "last": "last",
    "stdvar": "m2", "stddev": "m2",
}


def _window_stat_strided(resid, W: int, stat: str, stride: int):
    """(stat, count) f32 planes already consolidated to the output stride:
    K4 on a CUDA tensor, its plain version (window_kernels.
    window_stat_plain, the reference's _window_stat semantics) on a CPU
    tensor. A grid narrower than one window gives the empty [S, 0]
    planes without a launch."""
    if resid.shape[-1] < W:
        empty = resid.new_zeros((resid.shape[0], 0))
        return empty, empty.clone()
    return window_kernels.window_stat(resid, W, stride, stat)


def _finish_over_time(xp, kind: str, stat, cnt, b):
    """The *_over_time correction ladder — one source of truth for the
    device finish (xp=torch, f32) and the host finish (xp=np, f64);
    callers apply their own cnt>0 NaN mask around it."""
    if kind == "count":
        return cnt
    if kind == "present":
        return xp.ones_like(cnt)
    if kind == "sum":
        return stat + cnt * b
    if kind == "avg":
        return stat / cnt.clip(min=1) + b
    if kind in ("min", "max", "last"):
        return stat + b
    if kind == "stdvar":  # population variance (promql stdvar_over_time)
        return stat / cnt.clip(min=1)
    if kind == "stddev":
        return xp.sqrt(stat / cnt.clip(min=1))
    raise ValueError(f"unknown over_time kind {kind!r}")


def over_time_math(resid, base32, *, W: int, kind: str, stride: int = 1):
    """*_over_time finished on the device in f32: the window moment, the
    baseline correction and the NaN mask; one f32 plane comes back."""
    stat, cnt = _window_stat_strided(resid, W, _OVER_TIME_STATS[kind], stride)
    out = _finish_over_time(torch, kind, stat, cnt, base32[:, None])
    return torch.where(cnt > 0, out, float("nan")).to(F32)


@guard.guarded_builder("temporal.over_time")
@functools.lru_cache(maxsize=256)
def _over_time_fn(W: int, stat: str, stride: int = 1):
    """One masked window moment for *_over_time: (stat, count) f32
    planes at the output stride (K4 on the card)."""
    return lambda resid: _window_stat_strided(resid, W, stat, stride)


@guard.guarded_builder("temporal.over_time_finish")
@functools.lru_cache(maxsize=256)
def _over_time_finish_fn(W: int, kind: str, stride: int = 1):
    """The fully-finished *_over_time on the device: one f32 plane."""
    return functools.partial(over_time_math, W=W, kind=kind, stride=stride)


# A result grid this big finishes on the device and ships one f32 plane;
# smaller grids keep the exact f64 host finish. The reference's threshold
# (M3_TPU_F32_RESULT_MIN_CELLS's default), so both choose alike.
_F32_FINISH_MIN_CELLS = 256 * 1024


def over_time_async(grid: np.ndarray, W: int, kind: str, stride: int = 1,
                    finish: str = "host", device=None):
    """Dispatch side of sum|avg|min|max|count|last|stddev|stdvar|present
    _over_time; returns a fetch closure.

    finish="host": (stat, count) planes come back and the absolute-valued
    correction happens on the host in f64 (exact). "device": everything
    runs on the device and one f32 plane comes back. "auto": device for
    result grids of at least _F32_FINISH_MIN_CELLS cells, host otherwise."""
    stat_name = _OVER_TIME_STATS.get(kind)
    if stat_name is None:
        raise ValueError(f"unknown over_time kind {kind!r}")
    dev = resolve(device)
    if finish == "auto":
        t_out = max(0, grid.shape[1] - W + 1)
        result_cells = grid.shape[0] * ((t_out + stride - 1) // stride)
        finish = ("device" if result_cells >= _F32_FINISH_MIN_CELLS
                  else "host")
    resid, base = center(grid)
    resid_dev = _put(resid, dev)
    if finish == "device":
        out = _over_time_finish_fn(W, kind, stride)(
            resid_dev, _put(base.astype(np.float32), dev))
        return lambda: _fetch(out)
    stat_dev, cnt_dev = _over_time_fn(W, stat_name, stride)(resid_dev)

    def fetch() -> np.ndarray:
        stat = _fetch(stat_dev)
        cnt = _fetch(cnt_dev)
        out = _finish_over_time(np, kind, stat, cnt, base[:, None])
        return np.where(cnt > 0, out, np.nan)

    return fetch


def over_time(grid: np.ndarray, W: int, kind: str, stride: int = 1,
              finish: str = "host", device=None) -> np.ndarray:
    return over_time_async(grid, W, kind, stride, finish, device)()
