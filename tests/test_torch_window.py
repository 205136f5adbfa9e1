"""K4's plain version (m3_tpu_torch.ops.window_kernels.window_stat_plain,
what the wrapper runs on a CPU tensor) against the reference's window
moments on the same f32 grids, on the CPU.

Oracles: temporal._window_stat at stride 1 followed by [..., ::stride]
(the reference's default route) and pallas_window.window_stat in interpret
mode (the TPU kernel K4 replaces). The contract covers windows with
count > 0; both finishes mask the rest to NaN.

Tolerances: count, min, max and last are selections or integer counts and
must match bit for bit, signed zeros included (the Pallas kernel's `last`
is a one-hot sum that turns a selected -0.0 into +0.0, so against it
`last` compares by value). sum and m2 are f32 sums in another order, held
to the per-window reorder bound of m3_tpu_torch.testing.window_reorder_
bounds (2 n eps sqrt(n sum x^2) for the sum; the m2 bound adds the
effect of the two means differing)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.ops import pallas_window as jpw
from m3_tpu.ops import temporal as jt
from m3_tpu_torch.ops import temporal as tt
from m3_tpu_torch.ops import window_kernels as wk
from m3_tpu_torch.testing import hostile_residuals, window_reorder_bounds

EXACT = ("count", "min", "max", "last")


def _ref(x, W, stride, stat):
    s, c = jt._window_stat(jnp.asarray(x), W, stat)
    return np.asarray(s)[:, ::stride], np.asarray(c)[:, ::stride]


def _check(got, got_c, ref, ref_c, x, W, stride, stat, exact_last=True):
    np.testing.assert_array_equal(got_c, ref_c.astype(np.float32))
    assert got.shape == ref.shape
    pop = ref_c > 0
    if stat in EXACT and (stat != "last" or exact_last):
        np.testing.assert_array_equal(got[pop].view(np.uint32),
                                      ref[pop].view(np.uint32), err_msg=stat)
    elif stat == "last":
        np.testing.assert_array_equal(got[pop], ref[pop], err_msg=stat)
    else:
        sum_b, m2_b = window_reorder_bounds(torch.from_numpy(x), W, stride)
        bound = (sum_b if stat == "sum" else m2_b).numpy() + 1e-12
        err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
        assert (err[pop] <= bound[pop]).all(), (
            f"{stat}: beyond the reorder bound by {(err - bound)[pop].max()}")


@pytest.mark.parametrize("stat", wk.STATS)
@pytest.mark.parametrize("K,W,stride", [
    (67, 6, 1), (67, 6, 2), (67, 6, 3), (67, 6, 4),   # strides 1-4
    (119, 10, 1),                                     # the slice's shape
    (358, 31, 3),                                     # [5m10s] at step 30 s
    (90, 30, 30),                                     # packed subquery form
    (67, 67, 1), (30, 30, 3),                         # K = W
])
def test_plain_matches_reference_window_stat(stat, K, W, stride):
    x = hostile_residuals(K + W + stride, 23, K)
    got, got_c = wk.window_stat(torch.from_numpy(x), W, stride, stat)
    ref, ref_c = _ref(x, W, stride, stat)
    _check(got.numpy(), got_c.numpy(), ref, ref_c, x, W, stride, stat)


@pytest.mark.parametrize("stride", [1, 3, 6])
def test_plain_matches_pallas_interpret(stride):
    """13 x 67 grids, as tests/test_temporal.py runs the Pallas kernel."""
    x = hostile_residuals(40 + stride, 13, 67)
    for stat in wk.STATS:
        got, got_c = wk.window_stat(torch.from_numpy(x), 6, stride, stat)
        ref, ref_c = jpw.window_stat(jnp.asarray(x), 6, stride, stat)
        _check(got.numpy(), got_c.numpy(), np.asarray(ref), np.asarray(ref_c),
               x, 6, stride, stat, exact_last=False)


def test_empty_windows_have_the_documented_planes():
    """count 0 gives 0 (sum, last, m2), +inf (min), -inf (max): the values
    the CUDA kernel writes there too."""
    x = np.full((2, 12), np.nan, np.float32)
    x[1, :3] = [1.0, -0.0, 2.0]
    want = {"count": 0.0, "sum": 0.0, "last": 0.0, "m2": 0.0,
            "min": np.inf, "max": -np.inf}
    for stat, v in want.items():
        out, cnt = wk.window_stat(torch.from_numpy(x), 4, 2, stat)
        assert (cnt[0] == 0).all() and (out[0] == v).all(), stat
        assert (torch.signbit(out[0]) == (v < 0)).all(), stat


def test_all_nan_rows_and_signed_zeros():
    x = np.full((3, 8), np.nan, np.float32)
    x[1] = [0.0, -0.0, np.nan, 0.0, -0.0, -0.0, np.inf, 0.0]
    x[2] = -0.0
    for stat in wk.STATS:
        got, got_c = wk.window_stat(torch.from_numpy(x), 4, 2, stat)
        ref, ref_c = _ref(x, 4, 2, stat)
        _check(got.numpy(), got_c.numpy(), ref, ref_c, x, 4, 2, stat)
    mn, _ = wk.window_stat(torch.from_numpy(x), 4, 2, "min")
    mx, _ = wk.window_stat(torch.from_numpy(x), 4, 2, "max")
    assert torch.signbit(mn[1]).all() and not torch.signbit(mx[1]).any()


@pytest.mark.parametrize("K", [0, 5, 9])
def test_grid_narrower_than_a_window_gives_empty_planes(K):
    """K < W: the reference's strided window path returns [S, 0] planes;
    the port's returns them without a launch, and the wrapper refuses."""
    x = hostile_residuals(7, 4, K)
    for stat in wk.STATS:
        got, got_c = tt._window_stat_strided(torch.from_numpy(x), 10, stat, 2)
        ref, ref_c = jt._window_stat_strided(jnp.asarray(x), 10, stat, 2)
        assert got.shape == got_c.shape == np.asarray(ref).shape == (4, 0)
        assert np.asarray(ref_c).shape == (4, 0)
        with pytest.raises(ValueError):
            wk.window_stat(torch.from_numpy(x), 10, 2, stat)


def test_wrapper_checks_its_inputs():
    x = torch.zeros((4, 16))
    with pytest.raises(TypeError):
        wk.window_stat(x.double(), 4, 1, "sum")
    with pytest.raises(TypeError):
        wk.window_stat(x[0], 4, 1, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x.t(), 4, 1, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x, 4, 0, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x, 4, 1, "median")
