"""Batched windowed aggregation (counter/gauge/timer rollups) in PyTorch.

Port of m3_tpu/ops/aggregation.py. Stats dict layout (every leaf shaped
like the reduced window axis): sum, sumsq, count, min, max, last, first,
m2. Derived values (mean, stdev) come from the mergeable moments.

Bit-exactness against the reference: count, min, max, last, first and the
quantiles are order-insensitive and match bit for bit. Two places need
care for that. min/max follow XLA's ordering of signed zeros (-0.0 below
+0.0), where torch.minimum/amin would return whichever zero comes first;
`_minimum`/`_maximum`/`_amin`/`_amax` restore it. last/first are picked
through the raw bit pattern, so a selected -0.0 survives. sum, sumsq and
m2 are accumulated in another order than XLA's and agree within the f32
reduction-reorder bound (tests/test_torch_aggregation.py).
"""

from __future__ import annotations

import functools

import torch

STAT_KEYS = ("sum", "sumsq", "count", "min", "max", "last", "first", "m2")

_SIGN = torch.iinfo(torch.int32).min  # the f32 sign bit as int32


def _masked(values, mask, fill):
    return torch.where(mask, values, torch.tensor(fill, dtype=values.dtype,
                                                  device=values.device))


def _both_zero_bits(a, b, out, combine):
    """Where a and b are both zeros, take the zero whose sign `combine`
    (| for min, & for max) of the two sign bits gives."""
    both = (a == 0) & (b == 0)
    bits = combine(a.view(torch.int32), b.view(torch.int32)) & _SIGN
    return torch.where(both, bits.view(torch.float32), out)


def _minimum(a, b):
    """Elementwise min with NaN propagation and -0.0 < +0.0 (XLA's min)."""
    return _both_zero_bits(a, b, torch.minimum(a, b), torch.bitwise_or)


def _maximum(a, b):
    return _both_zero_bits(a, b, torch.maximum(a, b), torch.bitwise_and)


def _amin(x, dim):
    """Reduce-min with NaN propagation and -0.0 < +0.0."""
    r = x.amin(dim=dim)
    neg_zero = ((x == 0) & torch.signbit(x)).any(dim=dim)
    return torch.where(r == 0, torch.where(neg_zero, -0.0, 0.0), r)


def _amax(x, dim):
    r = x.amax(dim=dim)
    pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=dim)
    return torch.where(r == 0, torch.where(pos_zero, 0.0, -0.0), r)


def _pick(values, idx, has, dim):
    """values[..., idx, ...] by raw bits where `has`, else +0.0."""
    bits = values.contiguous().view(torch.int32)
    picked = torch.gather(bits, dim, idx.unsqueeze(dim)).squeeze(dim)
    return torch.where(has, picked, 0).view(torch.float32)


def window_stats(values, mask, dim=-1):
    """Reduce a window axis of f32 `values` to mergeable moments.

    mask: bool, broadcastable to values; True = datapoint present. Empty
    windows yield sum=0, count=0, min=+inf, max=-inf, last=0, first=0."""
    mask = torch.broadcast_to(mask, values.shape)
    dim = dim % values.dim()
    w = values.shape[dim]
    zero = _masked(values, mask, 0.0)
    cnt = mask.sum(dim=dim).to(values.dtype)
    shape = [1] * values.dim()
    shape[dim] = w
    idx = torch.arange(w, device=values.device).reshape(shape)
    last_i = torch.where(mask, idx, -1).amax(dim=dim)
    first_i = torch.where(mask, idx, w).amin(dim=dim)
    has = cnt > 0
    total = zero.sum(dim=dim)
    # Centered second moment (two-pass): raw n*sumsq - sum^2 cancels
    # catastrophically in f32 for offset values.
    mu = torch.where(has, total / cnt.clamp(min=1), 0.0)
    dev = _masked(values - mu.unsqueeze(dim), mask, 0.0)
    return {
        "sum": total,
        "sumsq": (zero * zero).sum(dim=dim),
        "count": cnt,
        "min": _amin(_masked(values, mask, float("inf")), dim),
        "max": _amax(_masked(values, mask, float("-inf")), dim),
        "last": _pick(values, last_i.clamp(min=0), has, dim),
        "first": _pick(values, first_i.clamp(max=w - 1), has, dim),
        "m2": (dev * dev).sum(dim=dim),
    }


def _rollup_slices(values, mask, factor: int):
    """[..., W] -> `factor` pairs of ([..., W//factor] slice, mask slice):
    slice i holds points i, i + factor, i + 2 factor, ..."""
    w = values.shape[-1]
    if w % factor:
        raise ValueError(f"window {w} not divisible by rollup factor {factor}")
    mask = torch.broadcast_to(mask, values.shape)
    return [(values[..., i::factor], mask[..., i::factor]) for i in range(factor)]


def rollup_stats(values, mask, factor: int):
    """Roll a [..., W] window up into W//factor sub-windows of `factor`
    points (the 10s -> 1m rollup), unrolled over the factor in the
    reference's order. Returns stats shaped [..., W//factor]."""
    sl = _rollup_slices(values, mask, factor)
    dt = values.dtype
    cnt = sum(m.to(dt) for _, m in sl)
    total = sum(torch.where(m, v, 0.0) for v, m in sl)
    sumsq = sum(torch.where(m, v * v, 0.0) for v, m in sl)
    mn = functools.reduce(_minimum, [_masked(v, m, float("inf")) for v, m in sl])
    mx = functools.reduce(_maximum, [_masked(v, m, float("-inf")) for v, m in sl])
    last = torch.zeros_like(sl[0][0])
    first = torch.zeros_like(sl[0][0])
    seen = torch.zeros_like(sl[0][1])
    for v, m in sl:
        last = torch.where(m, v, last)
        first = torch.where(m & ~seen, v, first)
        seen = seen | m
    mu = torch.where(cnt > 0, total / cnt.clamp(min=1), 0.0)
    m2 = sum(torch.where(m, (v - mu) * (v - mu), 0.0) for v, m in sl)
    return {"sum": total, "sumsq": sumsq, "count": cnt, "min": mn, "max": mx,
            "last": last, "first": first, "m2": m2}


def mean(stats):
    """Mean with the empty-window convention of 0."""
    n = stats["count"]
    return torch.where(n > 0, stats["sum"] / n.clamp(min=1), 0.0)


def merge_stats(a, b, b_is_later=True):
    """Merge two partial aggregates over the same key space (cross-flush
    and cross-device merges). last/first resolve by which operand is
    later, falling back to whichever side has data; m2 by Chan's update."""
    later, earlier = (b, a) if b_is_later else (a, b)
    na, nb = a["count"], b["count"]
    n = na + nb
    delta = mean(b) - mean(a)
    both = (na > 0) & (nb > 0)
    return {
        "sum": a["sum"] + b["sum"],
        "sumsq": a["sumsq"] + b["sumsq"],
        "count": n,
        "min": _minimum(a["min"], b["min"]),
        "max": _maximum(a["max"], b["max"]),
        "last": torch.where(later["count"] > 0, later["last"], earlier["last"]),
        "first": torch.where(earlier["count"] > 0, earlier["first"],
                             later["first"]),
        "m2": a["m2"] + b["m2"]
        + torch.where(both, delta * delta * na * nb / n.clamp(min=1), 0.0),
    }


def stdev(stats):
    """Sample standard deviation (ddof=1, 0 if n < 2) from m2."""
    n = stats["count"]
    return torch.where(n > 1, torch.sqrt(stats["m2"] / (n - 1).clamp(min=1)), 0.0)


def _rank_index(q: float, n, width: int):
    """Index of the ceil(q*n)-th smallest (q=0 -> the smallest), with
    q*n computed in f32 as the reference does."""
    rank = torch.ceil(q * n.to(torch.float32)).to(torch.int32)
    return (torch.clamp(rank, min=1) - 1).clamp(0, width - 1)


def quantiles(values, mask, qs: tuple):
    """Exact per-window quantiles, [..., W] -> [..., len(qs)].

    Rank ceil(q*n) (the CM stream's target rank), q=0 -> min; empty
    windows return 0; NaN samples count as missing."""
    mask = torch.broadcast_to(mask, values.shape) & ~torch.isnan(values)
    n = mask.sum(dim=-1)
    w = values.shape[-1]
    s = torch.sort(_masked(values, mask, float("inf")), dim=-1, stable=True).values
    iota = torch.arange(w, device=values.device)
    outs = []
    for q in qs:
        idx = _rank_index(q, n, w)
        # one-hot sum, as the reference selects (a selected -0.0 sums to +0.0)
        v = torch.where(iota == idx.unsqueeze(-1), s, 0.0).sum(dim=-1)
        outs.append(torch.where(n > 0, v, 0.0))
    return torch.stack(outs, dim=-1)


def quantile_rank_select(values, counts, qs: tuple):
    """Batched rank selection over padded value rows: [B, W] f32 values +
    [B] int32 valid counts -> [B, len(qs)] int32 indices of each quantile
    element WITHIN its row (the aggregator flush's ordering; the caller
    gathers the exact f64 values by index on the host).

    Padding past each row's count is +inf, so real elements order first;
    rank ceil(q*n) with q*n in f32, q=0 -> rank 1 (cm/stream.go:160),
    clipped to the row. The sort is stable over canonical keys: -0.0 is
    sorted as +0.0 and every NaN as the one positive NaN, largest of all,
    so ties keep input order on every backend, as jnp.argsort orders
    them (XLA standardizes zeros and NaNs in its sort comparator)."""
    width = values.shape[-1]
    mask = (torch.arange(width, device=values.device)[None, :]
            < counts[:, None])
    keys = torch.where(mask, values, float("inf"))
    keys = torch.where(torch.isnan(keys), float("nan"), keys + 0.0)
    order = torch.argsort(keys, dim=-1, stable=True)
    n = counts.to(torch.float32)
    idx = torch.stack([_rank_index(q, n, width) for q in qs], dim=-1)
    return torch.gather(order, -1, idx.to(torch.int64)).to(torch.int32)


def _sorted_columns(cols):
    """Sort a short list of same-shaped arrays elementwise across the list
    with an odd-even transposition network of min/max compare-exchanges."""
    xs = list(cols)
    k = len(xs)
    for rnd in range(k):
        for i in range(rnd & 1, k - 1, 2):
            xs[i], xs[i + 1] = _minimum(xs[i], xs[i + 1]), _maximum(xs[i], xs[i + 1])
    return xs


def rollup_quantiles(values, mask, factor: int, qs: tuple):
    """Quantiles per rollup sub-window: [..., W] -> [..., W//factor, len(qs)].

    Factors up to 16 sort elementwise across the factor slices with a
    sorting network; larger factors take the generic sort. NaN samples
    count as missing in both."""
    if factor > 16:
        w = values.shape[-1]
        if w % factor:
            raise ValueError(f"window {w} not divisible by rollup factor {factor}")
        shape = values.shape[:-1] + (w // factor, factor)
        return quantiles(values.reshape(shape),
                         torch.broadcast_to(mask, values.shape).reshape(shape), qs)
    sl = [(v, m & ~torch.isnan(v)) for v, m in _rollup_slices(values, mask, factor)]
    n = sum(m.to(torch.int32) for _, m in sl)
    s = _sorted_columns([_masked(v, m, float("inf")) for v, m in sl])
    outs = []
    for q in qs:
        idx = _rank_index(q, n, factor)
        v = torch.zeros_like(s[0])
        for i, si in enumerate(s):
            v = torch.where(idx == i, si, v)
        outs.append(torch.where(n > 0, v, 0.0))
    return torch.stack(outs, dim=-1)
