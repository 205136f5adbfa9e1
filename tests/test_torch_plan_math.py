"""The device forms whose only caller is the port's whole-plan compiler
(m3_tpu_torch/ops/temporal.py: center_math, rate_inputs_math,
instant_math, quantile_ot_math; m3_tpu_torch/ops/series_agg.py:
packed_gather_math, packed_topk_keep_math, packed_quantile_math) against
the reference's jnp functions on the same seeded f32 inputs, on the CPU.

The inputs hold NaN runs, +-0.0, +-inf, counter resets, ties across a
group, empty groups (all-padding slots), all-NaN rows and rows with one
sample.

Masks, indices, counts and topk membership must be equal; center_math
and rate_inputs_math bit-equal (their signed zeros included); instant_math
bit-equal (the same f32 differences and divide). The interpolated
quantiles (quantile_ot_math, packed_quantile_math) pick the same sorted
values — both sorts are stable and treat -0.0 and +0.0 as equal keys —
and interpolate with the same f32 multiply and adds: bit-equal too, which
is stronger than the rtol 1e-6 they are allowed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.ops import series_agg as jsa
from m3_tpu.ops import temporal as jt
from m3_tpu_torch.ops import series_agg as tsa
from m3_tpu_torch.ops import temporal as tt


def plane(seed: int, s: int = 48, t: int = 96) -> np.ndarray:
    """f32 [s, t]: counters with resets, gauges with NaN runs, signed
    zeros, infinities, an all-NaN row and one-sample rows."""
    rng = np.random.default_rng(seed)
    x = np.empty((s, t), np.float64)
    kind = np.arange(s) % 4
    n0 = int((kind == 0).sum())
    counters = np.cumsum(rng.poisson(4.0, (n0, t)), axis=1).astype(np.float64)
    resets = rng.random((n0, t)) < 0.05
    counters = np.where(np.cumsum(resets, axis=1) % 2 == 1,
                        counters - counters[:, :1] * 0.5, counters)
    x[kind == 0] = counters
    x[kind == 1] = rng.normal(0.0, 10.0, ((kind == 1).sum(), t))
    x[kind == 2] = np.round(rng.normal(0.0, 1.0, ((kind == 2).sum(), t)))
    x[kind == 3] = rng.integers(0, 3, ((kind == 3).sum(), t))  # many ties
    x = x.astype(np.float32)
    zeros = rng.random((s, t)) < 0.08
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    x[rng.random((s, t)) < 0.2] = np.nan
    runs = rng.integers(0, t - 12, s)
    for i, r in enumerate(runs[::3]):
        x[3 * i, r:r + 12] = np.nan                    # NaN runs
    x[rng.random((s, t)) < 0.01] = np.inf
    x[rng.random((s, t)) < 0.01] = -np.inf
    x[0] = np.nan
    x[1] = np.nan
    x[1, t // 2] = 5.0                                 # one sample
    x[2] = -0.0
    x[2, 1::2] = 0.0
    return x


def bits_equal(got: torch.Tensor, want) -> bool:
    w = np.asarray(want)
    g = got.numpy()
    if g.shape != w.shape:
        return False
    if g.dtype == np.float32:
        return np.array_equal(g.view(np.int32), w.astype(np.float32)
                              .view(np.int32))
    return np.array_equal(g, w)


SEEDS = range(3)
WINDOWS = [(10, 1), (31, 3), (4, 4), (7, 2)]


@pytest.mark.parametrize("seed", SEEDS)
def test_center_math_bit_equal(seed):
    x = plane(seed)
    resid, base = tt.center_math(torch.from_numpy(x))
    jresid, jbase = jt.center_math(jnp.asarray(x))
    assert bits_equal(resid, jresid)
    assert bits_equal(base, jbase)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("is_counter", [True, False])
def test_rate_inputs_math_bit_equal(seed, is_counter):
    x = plane(seed)
    got = tt.rate_inputs_math(torch.from_numpy(x), is_counter)
    want = jt.rate_inputs_math(jnp.asarray(x), is_counter)
    for g, w in zip(got, want):
        assert bits_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("W,stride", WINDOWS)
@pytest.mark.parametrize("is_rate", [True, False])
def test_instant_math_matches(seed, W, stride, is_rate):
    x = plane(seed)
    resid, _ = tt.center_math(torch.from_numpy(x))
    jresid, _ = jt.center_math(jnp.asarray(x))
    got = tt.instant_math(resid, torch.from_numpy(x), W=W, step_s=15.0,
                          is_rate=is_rate, stride=stride)
    want = jt.instant_math(jresid, jnp.asarray(x), W=W, step_s=15.0,
                           is_rate=is_rate, stride=stride)
    assert bits_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("W,stride", WINDOWS)
@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_quantile_ot_math_matches(seed, W, stride, q):
    x = plane(seed)
    resid, base = tt.center_math(torch.from_numpy(x))
    jresid, jbase = jt.center_math(jnp.asarray(x))
    got = tt.quantile_ot_math(resid, base, W=W, q=q, stride=stride)
    want = jt.quantile_ot_math(jresid, jbase, W=W, q=q, stride=stride)
    assert bits_equal(got, want)


def packing(seed: int, s: int, n_groups: int):
    """Bind-time group packing as parallel/compile.py builds it: flat
    perm [g_pad * smax_pad] (original row order within a group, -1 in
    unused slots, one group left empty) and the inverse [s]."""
    rng = np.random.default_rng(seed)
    gids = rng.integers(0, n_groups - 1, s)          # group n-1 stays empty
    smax = int(np.bincount(gids, minlength=n_groups).max())
    g_pad, smax_pad = n_groups + 1, smax + 2
    order = np.argsort(gids, kind="stable")
    starts = np.searchsorted(gids[order], np.arange(n_groups))
    slot = np.arange(s) - starts[gids[order]]
    packed_idx = gids[order] * smax_pad + slot
    perm = np.full(g_pad * smax_pad, -1, np.int64)
    perm[packed_idx] = order
    return perm, g_pad, smax_pad


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_gather_math_equal(seed):
    x = plane(seed)
    perm, g_pad, smax_pad = packing(seed, x.shape[0], 5)
    got = tsa.packed_gather_math(torch.from_numpy(x), torch.from_numpy(perm),
                                 g_pad, smax_pad)
    want = jsa.packed_gather_math(jnp.asarray(x), jnp.asarray(perm), g_pad,
                                  smax_pad)
    assert bits_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [0.0, 1.0, 2.0, 3.0, 50.0])
@pytest.mark.parametrize("largest", [True, False])
def test_packed_topk_keep_membership_equal(seed, k, largest):
    """The double-f32 split of 1e9-sized counters that differ below one
    f32 ulp (64 at 1e9), plus the plane's ties and signed zeros."""
    rng = np.random.default_rng(50 + seed)
    base = plane(seed).astype(np.float64)
    big = 1e9 + rng.integers(0, 200, base.shape).astype(np.float64)
    v = np.where(np.arange(base.shape[0])[:, None] % 2 == 0, big, base)
    v[np.isnan(base)] = np.nan
    hi = v.astype(np.float32)
    with np.errstate(invalid="ignore"):               # inf - inf
        lo = (v - hi.astype(np.float64)).astype(np.float32)
    perm, g_pad, smax_pad = packing(seed, v.shape[0], 4)
    ph = tsa.packed_gather_math(torch.from_numpy(hi), torch.from_numpy(perm),
                                g_pad, smax_pad)
    pl = tsa.packed_gather_math(torch.from_numpy(lo), torch.from_numpy(perm),
                                g_pad, smax_pad)
    jph = jsa.packed_gather_math(jnp.asarray(hi), jnp.asarray(perm), g_pad,
                                 smax_pad)
    jpl = jsa.packed_gather_math(jnp.asarray(lo), jnp.asarray(perm), g_pad,
                                 smax_pad)
    got = tsa.packed_topk_keep_math(ph, pl, torch.tensor(k), largest)
    want = jsa.packed_topk_keep_math(jph, jpl, jnp.float32(k), largest)
    assert bits_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 1.0])
def test_packed_quantile_math_matches(seed, q):
    x = plane(seed)
    perm, g_pad, smax_pad = packing(seed, x.shape[0], 6)
    packed = tsa.packed_gather_math(torch.from_numpy(x),
                                    torch.from_numpy(perm), g_pad, smax_pad)
    jpacked = jsa.packed_gather_math(jnp.asarray(x), jnp.asarray(perm),
                                     g_pad, smax_pad)
    got = tsa.packed_quantile_math(packed, torch.tensor(np.float32(q)))
    want = jsa.packed_quantile_math(jpacked, jnp.float32(q))
    assert bits_equal(got, want)
    # The empty group is all NaN in both.
    assert torch.isnan(got[-1]).all()
