"""Batched temporal (sliding-window) functions for the query engine
(reference: src/query/functions/temporal/{base,rate,aggregation}.go).
Counterpart of m3_tpu/ops/temporal.py: the rate family, irate/idelta,
the *_over_time moments, quantile_over_time, changes/resets,
deriv/predict_linear and holt_winters.

Precision is the reference's, on purpose: the host keeps f64 (a
per-series baseline from `center`, the consecutive-diff pass
`_host_diff_grid`), the device computes on f32 residuals, and the
absolute-valued *_over_time results are finished either on the host in
f64 (exact) or on the device in f32 for large result grids, at the
reference's threshold. An f64 device path would give a different result,
not a faster one. Quantiles return window indices from the device and the
host gathers the exact f64 values.

Window convention: output step t of the extended [S, K] grid reads
columns [t * stride, t * stride + W); T_out = (K - W) // stride + 1.
Every windowed reduction is a per-window accumulation over the unfolded
[S, T_out, W] view, never a cumsum difference (a global f32 prefix sum
cancels catastrophically on 1e13-sized counters). The masked window
moments run through K4 (ops/window_kernels.py) on the card.

Every public function takes `device` (None = the CUDA device, see
device.resolve); results come back to the host as numpy f64, once per
query, through the fetch closures of the *_async forms.

Inputs reach the device through two caches, as in the reference. The
derived-input cache keeps each grid's prepared device tensors (the rate
family's adj/finite/grid32, the centred family's resid/baseline): an
id-keyed fast path returns them for the same grid object on every
device, and a content-hash tier below it (blake2b of the f64 grid) runs
only when the evaluation is placed on `cuda`. The upload cache keeps
content-hashed uploads (irate/idelta's validity mask), on `cuda` only.
Their three tenants (upload, derived, derived_id) share the process-wide
utils.hbm budget; keys carry the device, so a host-placed and a
card-placed evaluation of one grid never collide.

The device functions are built by cached builders under
`guard.guarded_builder` (routes temporal.rate, temporal.last_two_idx,
temporal.over_time, temporal.over_time_finish, temporal.quantile_idx,
temporal.changes_resets, temporal.regression, temporal.holt_winters):
every call dispatches through the compute-fault guard, which raises a
typed ComputeError on a fault and never falls back."""

from __future__ import annotations

import collections
import functools
import hashlib
import threading
from typing import Tuple

import numpy as np
import torch

from ..device import resolve
from ..parallel import guard, telemetry
from ..utils.hbm import tensor_nbytes
from ..utils.instrument import ROOT
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
    # the upload cache's one put: _cached_put charges what it keeps to the
    # shared budget, and the uncached callers' planes die with the evaluation
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)  # m3lint: disable=unbudgeted-device-put


def _fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


# ------------------------------------------------------------- input caches
#
# Hit/miss/eviction counts of the two caches below, so cold and warm
# query splits are readable from the metrics alone.
_UPLOAD_METRICS = ROOT.sub_scope("ops.upload_cache")
_DERIVED_METRICS = ROOT.sub_scope("ops.derived_cache")

# Byte ceilings, each a share of the process-wide utils.hbm budget that
# bounds their sum with the storage block cache's: the reference's
# defaults, fixed here (the port reads no environment knob).
_PUT_CACHE_MAX_BYTES = 512 * 1024 * 1024
_DERIVED_CACHE_MAX_BYTES = 256 * 1024 * 1024
_DERIVED_ID_FAST_MAX_BYTES = 256 * 1024 * 1024

_PUT_CACHE_LOCK = threading.Lock()
# Upload cache: content digest + shape + dtype + device -> (device tensor,
# charged bytes). A mutated array re-uploads: correctness does not rest on
# object identity.
_PUT_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_put_cache_bytes = 0
# Derived-input cache: grid digest + shape + kind + device -> (prepared
# device tensors, charged bytes). One 16-byte blake2b of the f64 grid
# replaces its f64 host prep and its uploads.
_DERIVED_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_derived_cache_bytes = 0
# Identity fast path in front of the content hash: the executor's grid
# cache returns the same grid object for a repeat selector evaluation, so
# two dict probes replace the hash. An entry holds a strong reference to
# its grid, so the grid's id() cannot be recycled while the entry lives.
_DERIVED_ID_FAST: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_derived_id_fast_bytes = 0


@functools.lru_cache(maxsize=1)
def _hbm_budget():
    """The process-wide budget (utils.hbm) with the three caches
    registered as tenants: usage probes read the live byte counters,
    evictors pop one LRU entry each."""
    from ..utils import hbm

    budget = hbm.shared_budget()
    budget.register("upload", lambda: _put_cache_bytes, _evict_one_upload)
    budget.register("derived", lambda: _derived_cache_bytes,
                    _evict_one_derived)
    budget.register("derived_id", lambda: _derived_id_fast_bytes,
                    _evict_one_id_fast)
    return budget


def _evict_one_upload() -> int:
    global _put_cache_bytes
    with _PUT_CACHE_LOCK:
        if len(_PUT_CACHE) <= 1:
            return 0
        _, (_, freed) = _PUT_CACHE.popitem(last=False)
        _put_cache_bytes -= freed
        _UPLOAD_METRICS.counter("evictions").inc()
        return freed


def _evict_one_derived() -> int:
    global _derived_cache_bytes
    with _PUT_CACHE_LOCK:
        if len(_DERIVED_CACHE) <= 1:
            return 0
        _, (_, freed) = _DERIVED_CACHE.popitem(last=False)
        _derived_cache_bytes -= freed
        _DERIVED_METRICS.counter("evictions").inc()
        return freed


def _evict_one_id_fast() -> int:
    global _derived_id_fast_bytes
    with _PUT_CACHE_LOCK:
        if len(_DERIVED_ID_FAST) <= 1:
            return 0
        _, (_, _, freed) = _DERIVED_ID_FAST.popitem(last=False)
        _derived_id_fast_bytes -= freed
        return freed


def _derived(grid: np.ndarray, kind: str, build, dev: torch.device):
    """build(grid) -> (value tuple, charged bytes), cached. The id-keyed
    fast path returns the cached tuple when the same grid object comes
    back, on every device. The content-hash tier below it runs only when
    the evaluation is placed on `cuda`: on the host the hash costs more
    than the prep and the copy it would save (the reference's
    _cache_enabled, decided per call)."""
    global _derived_cache_bytes
    fast_key = (id(grid), kind, str(dev))
    with _PUT_CACHE_LOCK:
        fast = _DERIVED_ID_FAST.get(fast_key)
        if fast is not None and fast[0] is grid:
            _DERIVED_ID_FAST.move_to_end(fast_key)
            _DERIVED_METRICS.counter("hits").inc()
            return fast[1]
    if dev.type != "cuda":
        val, _ = build(grid)
        with _PUT_CACHE_LOCK:
            _id_fast_store(fast_key, grid, val)
        _hbm_budget().reclaim()
        return val
    g = np.ascontiguousarray(grid)
    key = (hashlib.blake2b(g, digest_size=16).digest(), g.shape, kind,
           str(dev))
    with _PUT_CACHE_LOCK:
        hit = _DERIVED_CACHE.get(key)
        if hit is not None:
            _DERIVED_CACHE.move_to_end(key)
            _id_fast_store(fast_key, grid, hit[0])
            _DERIVED_METRICS.counter("hits").inc()
            return hit[0]
    _DERIVED_METRICS.counter("misses").inc()
    val, nbytes = build(g)
    with _PUT_CACHE_LOCK:
        if key not in _DERIVED_CACHE:
            _DERIVED_CACHE[key] = (val, nbytes)
            _derived_cache_bytes += nbytes
        while (_derived_cache_bytes > _DERIVED_CACHE_MAX_BYTES
               and len(_DERIVED_CACHE) > 1):
            _, (_, freed) = _DERIVED_CACHE.popitem(last=False)
            _derived_cache_bytes -= freed
            _DERIVED_METRICS.counter("evictions").inc()
        _id_fast_store(fast_key, grid, val)
    _hbm_budget().reclaim()
    return val


def _id_fast_store(fast_key, grid, val):
    """Store an id-keyed alias entry (the caller holds _PUT_CACHE_LOCK).
    Its charge covers the pinned grid and the value tuple: on the host
    the tuple is arrays no other tenant counts."""
    global _derived_id_fast_bytes
    old = _DERIVED_ID_FAST.pop(fast_key, None)
    if old is not None:
        _derived_id_fast_bytes -= old[2]
    cost = grid.nbytes + sum(tensor_nbytes(a) for a in val)
    _DERIVED_ID_FAST[fast_key] = (grid, val, cost)
    _derived_id_fast_bytes += cost
    while (_derived_id_fast_bytes > _DERIVED_ID_FAST_MAX_BYTES
           and len(_DERIVED_ID_FAST) > 1):
        _, (_, _, freed) = _DERIVED_ID_FAST.popitem(last=False)
        _derived_id_fast_bytes -= freed


def _cached_put(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """`arr` on `dev`; on `cuda`, through the content-keyed upload cache
    (a miss is the H2D copy, counted at this choke point)."""
    global _put_cache_bytes
    if dev.type != "cuda":
        return _put(arr, dev)
    arr = np.ascontiguousarray(arr)
    key = (hashlib.blake2b(arr, digest_size=16).digest(), arr.shape,
           arr.dtype.str, str(dev))
    with _PUT_CACHE_LOCK:
        hit = _PUT_CACHE.get(key)
        if hit is not None:
            _PUT_CACHE.move_to_end(key)
            _UPLOAD_METRICS.counter("hits").inc()
            return hit[0]
    _UPLOAD_METRICS.counter("misses").inc()
    out = _put(arr, dev)
    charged = tensor_nbytes(out)
    telemetry.count_h2d(charged)
    with _PUT_CACHE_LOCK:
        if key not in _PUT_CACHE:
            _PUT_CACHE[key] = (out, charged)
            _put_cache_bytes += charged
        while _put_cache_bytes > _PUT_CACHE_MAX_BYTES and len(_PUT_CACHE) > 1:
            _, (_, freed) = _PUT_CACHE.popitem(last=False)
            _put_cache_bytes -= freed
            _UPLOAD_METRICS.counter("evictions").inc()
    _hbm_budget().reclaim()
    return out


def _window_volume(x, W: int, stride: int = 1):
    """[S, T_out, W] view of every stride-th window (T_out = 0 when the
    grid is narrower than one window, as the reference's gather gives)."""
    if x.shape[-1] < W:
        return x.new_empty((*x.shape[:-1], 0, W))
    return x.unfold(-1, W, stride)


def _first_last(mask):
    """First/last valid window indices + validity counts."""
    W = mask.shape[-1]
    ar = torch.arange(W, dtype=torch.int32, device=mask.device)
    cnt = mask.sum(-1)
    first_i = torch.where(mask, ar, W).amin(-1)
    last_i = torch.where(mask, ar, -1).amax(-1)
    return first_i, last_i, cnt


def _take_w(vol, idx):
    """vol[..., idx] along the window axis (idx clipped into it)."""
    return torch.gather(
        vol, -1, idx.clamp(0, vol.shape[-1] - 1).to(torch.int64)[..., None]
    )[..., 0]


def _ffill(vol, mask):
    """Forward-fill invalid cells with the last valid value (0 before the
    first valid cell) via a running max over valid indices (the
    reference's associative_scan(maximum) is torch.cummax)."""
    W = vol.shape[-1]
    idx = torch.where(mask, torch.arange(W, device=vol.device), -1)
    run = torch.cummax(idx, dim=-1).values
    return torch.where(run >= 0, _gather_last(vol, run), 0.0)


def _gather_last(vol, run):
    return torch.gather(vol, -1, run.clamp(0, vol.shape[-1] - 1))


def _wsum(x, W: int, stride: int = 1):
    """Windowed f32 sum over the last axis, every stride-th window: each
    window accumulates only its own W cells (never a prefix-sum
    difference), so the error stays at W ulps of the window's own sum.

    The cells are added left to right into an f32 accumulator that
    starts at 0.0, one column at a time, as the reference's
    `lax.reduce_window` does: a window that opens on a counter reset adds
    the whole reset value to small diffs and takes it away again, and
    `sum(-1)`'s other order rounds that to another ulp."""
    vol = _window_volume(x.to(F32), W, stride)
    acc = torch.zeros(vol.shape[:-1], dtype=F32, device=vol.device)
    for j in range(W):
        acc.add_(vol[..., j])
    return acc


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


def _rate_args(grid: np.ndarray, is_counter: bool, dev: torch.device):
    """(adj, finite[, grid32]) on `dev` for rate_math, behind the
    derived-input cache."""

    def build(g):
        devs = tuple(_put(a, dev) for a in rate_inputs(g, is_counter)
                     if a is not None)
        return devs, sum(tensor_nbytes(t) for t in devs)

    return _derived(grid, f"rate:{is_counter}", build, dev)


def _extrapolated_async(grid: np.ndarray, W: int, step_ns: int, range_ns: int,
                        is_counter: bool, is_rate: bool, stride: int, device):
    """Dispatch side of rate/increase/delta: the f64 diff pass feeds the
    device math; returns a fetch closure for the one f32 result (already
    at the output step grid)."""
    dev = resolve(device)
    out = _rate_fn(W, step_ns / 1e9, range_ns / 1e9, is_counter, is_rate,
                   stride)(*_rate_args(grid, is_counter, dev))
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
    packed = _last_two_idx_fn(W, stride)(_cached_put(finite, dev)).cpu().numpy()
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
    # The compiled plan hands in column slices of its padded planes: one
    # copy makes them the contiguous rows the kernel reads.
    # Reached only under a guarded route: the temporal.over_time and
    # temporal.over_time_finish builders, and the plan route's dispatch.
    # m3lint: disable=unguarded-kernel-dispatch
    return window_kernels.window_stat(resid.contiguous(), W, stride, stat)


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


def _resid_args(grid: np.ndarray, dev: torch.device):
    """(resid f32 on `dev`, baseline f64 on the host, baseline f32 on
    `dev`) for the centred family, behind the derived-input cache."""

    def build(g):
        resid, base = center(g)
        resid_dev = _put(resid, dev)
        base32_dev = _put(base.astype(np.float32), dev)
        return ((resid_dev, base, base32_dev),
                tensor_nbytes(resid_dev) + tensor_nbytes(base32_dev))

    return _derived(grid, "resid", build, dev)


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
    resid_dev, base, base32_dev = _resid_args(grid, dev)
    if finish == "device":
        out = _over_time_finish_fn(W, kind, stride)(resid_dev, base32_dev)
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


@guard.guarded_builder("temporal.quantile_idx")
@functools.lru_cache(maxsize=256)
def _quantile_idx_fn(W: int, stride: int = 1):
    """Window-quantile index selection: one packed f32 [4, S, T_out] plane
    (lo index, hi index, fraction, count); the host gathers the exact f64
    values. As in the reference, the windows are taken unstrided and the
    plane is strided after."""

    def fn(resid, q: float):
        vol = _window_volume(resid, W)
        mask = torch.isfinite(vol)
        cnt = mask.sum(-1)
        # Stable, as jnp.argsort is: distinct f64 values that collapse to
        # one f32 residual keep their window order.
        order = torch.argsort(torch.where(mask, vol, float("inf")), dim=-1,
                              stable=True)
        # promql quantile_over_time: linear interpolation at rank q*(n-1).
        pos = q * (cnt - 1).to(F32)
        lo = torch.floor(pos).to(torch.int32).clamp(0, W - 1)
        hi = (lo + 1).clamp(0, W - 1)
        frac = pos - lo.to(F32)
        lo_idx = _take_w(order, lo)
        hi_idx = torch.where(hi < cnt, _take_w(order, hi), lo_idx)
        # Window indices and counts are < W, so f32 holds them exactly.
        return torch.stack([lo_idx.to(F32), hi_idx.to(F32), frac,
                            cnt.to(F32)])[..., ::stride]

    return fn


def quantile_over_time(grid: np.ndarray, W: int, q: float, stride: int = 1,
                       device=None) -> np.ndarray:
    resid, _, _ = _resid_args(grid, resolve(device))
    # q rounds to f32 once, as the reference's np.float32(q) does.
    packed = _quantile_idx_fn(W, stride)(
        resid, float(np.float32(q))).cpu().numpy()
    lo_idx, hi_idx = packed[0].astype(np.int64), packed[1].astype(np.int64)
    frac, cnt = packed[2], packed[3]
    S, T_out = lo_idx.shape
    t_base = np.arange(T_out)[None, :] * stride
    rows = np.arange(S)[:, None]
    v_lo = grid[rows, t_base + lo_idx]
    v_hi = grid[rows, t_base + hi_idx]
    out = v_lo + (v_hi - v_lo) * frac
    return np.where(cnt > 0, out, np.nan)


def changes_resets_math(resid, *, W: int, count_resets: bool,
                        stride: int = 1):
    """changes()/resets(): value changes (or decreases) between
    consecutive valid samples of each window, NaN where it is empty."""
    vol = _window_volume(resid, W, stride)
    mask = torch.isfinite(vol)
    filled = _ffill(vol, mask)
    prev = torch.cat([filled[..., :1], filled[..., :-1]], dim=-1)
    first_i, _, cnt = _first_last(mask)
    after_first = torch.arange(W, device=vol.device) > first_i[..., None]
    valid_pair = mask & after_first
    d = vol - prev
    hits = valid_pair & ((d < 0) if count_resets else (d != 0))
    return torch.where(cnt > 0, hits.sum(-1).to(F32), float("nan"))


@guard.guarded_builder("temporal.changes_resets")
@functools.lru_cache(maxsize=256)
def _changes_resets_fn(W: int, count_resets: bool, stride: int = 1):
    return functools.partial(changes_resets_math, W=W,
                             count_resets=count_resets, stride=stride)


def changes(grid: np.ndarray, W: int, stride: int = 1,
            device=None) -> np.ndarray:
    resid, _, _ = _resid_args(grid, resolve(device))
    return _fetch(_changes_resets_fn(W, False, stride)(resid))


def resets(grid: np.ndarray, W: int, stride: int = 1,
           device=None) -> np.ndarray:
    resid, _, _ = _resid_args(grid, resolve(device))
    return _fetch(_changes_resets_fn(W, True, stride)(resid))


def regression_math(resid, *, W: int, step_s: float,
                    predict_offset_s: float, is_deriv: bool,
                    stride: int = 1):
    """deriv()/predict_linear(): least squares over each window's valid
    (t, v) points, t relative to the window's first valid sample
    (promql linearRegression; temporal/linear_regression.go). f32 sums
    over a cancelling denominator, as in the reference. predict_linear
    results are in residual space: callers add the baseline back."""
    vol = _window_volume(resid, W, stride)
    mask = torch.isfinite(vol)
    first_i, _, cnt = _first_last(mask)
    ok = cnt >= 2
    ar = torch.arange(W, dtype=torch.int32, device=vol.device)
    t = (ar - first_i[..., None]).to(F32) * step_s
    tm = torch.where(mask, t, 0.0)
    v = torch.where(mask, vol, 0.0)
    n = cnt.to(F32)
    st = tm.sum(-1)
    sv = v.sum(-1)
    stt = (tm * tm).sum(-1)
    stv = (tm * v).sum(-1)
    denom = n * stt - st * st
    slope = torch.where(denom != 0, (n * stv - st * sv) / denom,
                        float("nan"))
    if is_deriv:
        return torch.where(ok, slope, float("nan"))
    intercept = (sv - slope * st) / n
    # The output time is the window's last cell: t = (W-1-first_i)*step
    # relative to the regression's origin.
    t_eval = (W - 1 - first_i).to(F32) * step_s + predict_offset_s
    return torch.where(ok, intercept + slope * t_eval, float("nan"))


@guard.guarded_builder("temporal.regression")
@functools.lru_cache(maxsize=256)
def _regression_fn(W: int, step_s: float, predict_offset_s: float,
                   is_deriv: bool, stride: int = 1):
    return functools.partial(
        regression_math, W=W, step_s=step_s,
        predict_offset_s=predict_offset_s, is_deriv=is_deriv, stride=stride)


def deriv(grid: np.ndarray, W: int, step_ns: int, stride: int = 1,
          device=None) -> np.ndarray:
    resid, _, _ = _resid_args(grid, resolve(device))
    return _fetch(_regression_fn(W, step_ns / 1e9, 0.0, True, stride)(resid))


def predict_linear(grid: np.ndarray, W: int, step_ns: int, offset_s: float,
                   stride: int = 1, device=None) -> np.ndarray:
    resid, base, _ = _resid_args(grid, resolve(device))
    out = _fetch(_regression_fn(W, step_ns / 1e9, float(offset_s), False,
                                stride)(resid))
    return out + base[:, None]


def holt_winters_math(resid, *, W: int, sf: float, tf: float,
                      stride: int = 1):
    """holt_winters(): double exponential smoothing over each window,
    skipping invalid cells (temporal/holt_winters.go; promql holtWinters:
    s0 = v0, b0 = v1 - v0 once the second valid sample arrives). The
    reference's lax.scan over the window becomes a loop over the W
    columns of [S, T_out] planes carrying (s, b, n). Results are in
    residual space: callers add the baseline back."""
    vol = _window_volume(resid, W, stride)
    mask = torch.isfinite(vol)
    s = vol.new_zeros(vol.shape[:-1])
    b = vol.new_zeros(vol.shape[:-1])
    n = torch.zeros(vol.shape[:-1], dtype=torch.int32, device=vol.device)
    for j in range(W):
        x, m = vol[..., j], mask[..., j]
        b_eff = torch.where(n == 1, x - s, b)
        s1 = torch.where(n == 0, x, sf * x + (1 - sf) * (s + b_eff))
        b1 = torch.where(n == 0, 0.0, tf * (s1 - s) + (1 - tf) * b_eff)
        s = torch.where(m, s1, s)
        b = torch.where(m, b1, b)
        n = n + m.to(torch.int32)
    return torch.where(n >= 2, s, float("nan"))


@guard.guarded_builder("temporal.holt_winters")
@functools.lru_cache(maxsize=256)
def _holt_winters_fn(W: int, sf: float, tf: float, stride: int = 1):
    return functools.partial(holt_winters_math, W=W, sf=float(sf),
                             tf=float(tf), stride=stride)


def holt_winters(grid: np.ndarray, W: int, sf: float, tf: float,
                 stride: int = 1, device=None) -> np.ndarray:
    resid, base, _ = _resid_args(grid, resolve(device))
    out = _fetch(_holt_winters_fn(W, float(sf), float(tf), stride)(resid))
    return out + base[:, None]


# --------------------------------------------------- traced input preps
#
# Device twins of the HOST preps (center / rate_inputs) and of the
# host-finished irate/idelta and quantile_over_time, for planes that only
# exist ON DEVICE — the whole-plan compiler (parallel/compile.py)
# evaluates an inner expression inside its program and re-windows its
# output, so nothing may round-trip to the host there (on the card a
# host sync would break the CUDA-graph capture). The host versions stay
# the exact-f64 path for staged selector grids; these run at the plane's
# own f32 precision, which is why the plan lowering only admits them over
# difference-space planes (query/plan.py bails with F64_ARITH on
# absolute-magnitude composite subquery planes). Counterparts of
# m3_tpu/ops/temporal.py's center_math, rate_inputs_math, instant_math
# and quantile_ot_math.


def center_math(plane):
    """Device center(): (residual, per-row baseline = first finite
    value, 0 for an empty row). The baseline choice is arbitrary (every
    consumer adds it back or is shift-invariant), so f32 costs nothing
    beyond the plane's own f32."""
    finite = torch.isfinite(plane)
    T = plane.shape[-1]
    first = torch.where(finite, torch.arange(T, device=plane.device),
                        T).amin(-1)
    picked = torch.gather(torch.where(finite, plane, 0.0), -1,
                          first.clamp(max=T - 1)[..., None])[..., 0]
    base = torch.where(first < T, picked, 0.0)
    return plane - base[..., None], base


def rate_inputs_math(plane, is_counter: bool):
    """Device rate_inputs(): (adj, finite, grid32) with the same per-cell
    semantics as _host_diff_grid — adj[i] = v[i] - prev_valid, a counter
    reset (d < 0) contributes v[i] itself, cells with no previous valid
    sample (and invalid cells) contribute 0. The reference's
    associative_scan(maximum) is torch.cummax."""
    finite = torch.isfinite(plane)
    T = plane.shape[-1]
    idx = torch.where(finite, torch.arange(T, device=plane.device), -1)
    run = torch.cummax(idx, dim=-1).values
    prev_run = torch.cat([torch.full_like(run[..., :1], -1), run[..., :-1]],
                         dim=-1)
    z = torch.where(finite, plane, 0.0)
    prev_val = torch.gather(z, -1, prev_run.clamp(0, T - 1))
    d = z - prev_val
    adj = torch.where(d < 0, z, d) if is_counter else d
    adj = torch.where(finite & (prev_run >= 0), adj, 0.0)
    return adj, finite, z


def instant_math(resid, grid32, *, W: int, step_s: float, is_rate: bool,
                 stride: int = 1):
    """Device irate()/idelta() (temporal/rate.go irateFn): last two valid
    samples per window. Differences compute in RESIDUAL space (exact for
    the small consecutive deltas even at 1e9 counter magnitudes); only a
    counter reset's restart value reads the absolute f32 plane, where
    post-reset values are small. The reset COMPARE is residual-space too
    (shift-invariant, so it agrees with the interpreter's f64 compare
    wherever the residuals are exact)."""
    finite = torch.isfinite(resid)
    mvol = _window_volume(finite, W, stride)
    Wr = torch.arange(W, device=resid.device)
    last_i = torch.where(mvol, Wr, -1).amax(-1)
    prev_i = torch.where(mvol & (Wr < last_i[..., None]), Wr, -1).amax(-1)
    ok = prev_i >= 0
    rvol = _window_volume(torch.where(finite, resid, 0.0), W, stride)
    r_last = _take_w(rvol, last_i)
    r_prev = _take_w(rvol, prev_i)
    if not is_rate:
        return torch.where(ok, r_last - r_prev, float("nan"))
    g_last = _take_w(_window_volume(grid32, W, stride), last_i)
    dv = torch.where(r_last < r_prev, g_last, r_last - r_prev)
    dt = (last_i - prev_i).to(F32) * step_s
    return torch.where(ok, dv / torch.where(ok, dt, 1.0), float("nan"))


def quantile_ot_math(resid, base32, *, W: int, q: float, stride: int = 1):
    """Device quantile_over_time(): promql's linearly-interpolated window
    quantile at rank q*(n-1), computed in residual space (quantiles are
    shift-equivariant) with the per-row baseline added back. The sort is
    stable, as jnp.argsort is; q rounds to f32 once."""
    vol = _window_volume(resid, W, stride)
    mask = torch.isfinite(vol)
    cnt = mask.sum(-1)
    order = torch.argsort(torch.where(mask, vol, float("inf")), dim=-1,
                          stable=True)
    pos = float(np.float32(q)) * (cnt - 1).to(F32)
    lo = torch.floor(pos).to(torch.int64).clamp(0, W - 1)
    hi = (lo + 1).clamp(0, W - 1)
    frac = pos - lo.to(F32)
    zvol = torch.where(mask, vol, 0.0)
    v_lo = _take_w(zvol, _take_w(order, lo))
    v_hi = torch.where(hi < cnt, _take_w(zvol, _take_w(order, hi)), v_lo)
    out = v_lo + (v_hi - v_lo) * frac + base32[..., None]
    return torch.where(cnt > 0, out, float("nan"))

