"""m3_tpu_torch.ops.series_agg against m3_tpu.ops.series_agg on the same
inputs, on the CPU.

The f64 host forms (grouped_reduce_f64, grouped_quantile, topk_mask,
count_values) are copies and must match exactly. The f32 device segment
reduce (grouped_reduce) adds in another order than XLA's segment_sum:
count, min and max are exact, signed zeros included (-0.0 orders below
+0.0, as XLA's min and max do); sum, avg, stddev and stdvar are held to
rtol 1e-5, atol 1e-6 (an f32 sum of at most 40 rows, each O(1e3))."""

import numpy as np
import pytest

from m3_tpu.ops import series_agg as jsa
from m3_tpu_torch.ops import series_agg as tsa

KINDS = ("sum", "avg", "min", "max", "count", "stddev", "stdvar")


def _values(seed, s=150, t=37, groups=7):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((s, t)) * 10.0 ** rng.integers(-1, 3, (s, 1))
    v[rng.random((s, t)) < 0.15] = np.nan
    v[rng.random((s, t)) < 0.05] = 0.0
    v[rng.random((s, t)) < 0.05] = -0.0
    v[3] = -0.0
    v[5, ::2] = np.nan
    gid = rng.integers(0, groups, s)
    gid[gid == 2] = 1          # group 2 has no series
    gid[7] = groups - 1        # the last group has one series
    gid[np.flatnonzero(gid == groups - 1)[1:]] = 0
    return v, gid, groups


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_reduce_f32_device_form(kind, seed):
    v, gid, g = _values(seed)
    got = tsa.grouped_reduce(v, gid, g, kind, device="cpu")
    ref = jsa.grouped_reduce(v, gid, g, kind)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    if kind in ("count", "min", "max"):
        np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)


def test_grouped_reduce_signed_zeros():
    v = np.array([[0.0, -0.0, 0.0, -0.0],
                  [-0.0, -0.0, 0.0, 0.0],
                  [1.0, -0.0, np.nan, -1.0]])
    gid = np.array([0, 0, 1])
    for kind in ("min", "max"):
        got = tsa.grouped_reduce(v, gid, 2, kind, device="cpu")
        ref = jsa.grouped_reduce(v, gid, 2, kind)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))
        np.testing.assert_array_equal(got, ref)


def test_grouped_reduce_empty_input():
    v = np.zeros((0, 5))
    got = tsa.grouped_reduce(v, np.zeros(0, np.int64), 3, "sum", device="cpu")
    np.testing.assert_array_equal(got, jsa.grouped_reduce(
        v, np.zeros(0, np.int64), 3, "sum"))


@pytest.mark.parametrize("kind", KINDS)
def test_grouped_reduce_f64_host_form(kind):
    v, gid, g = _values(2)
    np.testing.assert_array_equal(tsa.grouped_reduce_f64(v, gid, g, kind),
                                  jsa.grouped_reduce_f64(v, gid, g, kind))


def test_quantile_topk_count_values_host_forms():
    v, gid, g = _values(3, s=40, t=9)
    for q in (0.0, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(tsa.grouped_quantile(v, gid, g, q),
                                      jsa.grouped_quantile(v, gid, g, q))
    for k in (1, 3):
        for largest in (True, False):
            np.testing.assert_array_equal(
                tsa.topk_mask(v, gid, g, k, largest),
                jsa.topk_mask(v, gid, g, k, largest))
    vr = np.round(v)
    got, ref = tsa.count_values(vr, gid, g), jsa.count_values(vr, gid, g)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
