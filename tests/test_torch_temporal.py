"""m3_tpu_torch.ops.temporal against m3_tpu.ops.temporal on the same f64
grids, on the CPU (device="cpu": the plain versions of the kernels).

The grids carry NaN holes (a whole missing row too) and counters in three
families: 1e9..1e13 with resets to near zero ("hostile"), the same without
resets ("large"), and 0..1e3 with resets ("small").

Tolerances: under the host finish, count, min, max, last and present are
exact on every family (integer counts and selections of the same f32
residuals, corrected by the same f64 baseline). Everything else is an f32
sum or an f32 finish in another order: rtol 1e-5, atol 1e-8, the oracle
tolerance of bench.py's compiled-vs-interpreter check. That holds where
the reference's f32 arithmetic is well conditioned: rate and increase on
every family (the host diff pass restarts at a reset), delta and the
summed *_over_time kinds on "large" and "small". On "hostile", a window
that sums residuals across a reset of a 1e13 counter carries the f32
rounding of 1e13 (about 1e6) in both packages; there the window moments
are held to their reorder bound in tests/test_torch_window.py."""

import numpy as np
import pytest

from m3_tpu.ops import temporal as jt
from m3_tpu_torch.ops import temporal as tt

STEP_NS = 10_000_000_000
KINDS = ("count", "present", "sum", "avg", "min", "max", "last", "stdvar",
         "stddev")
EXACT = ("count", "present", "min", "max", "last")


FAMILIES = {"hostile": ((9, 14), True), "large": ((9, 14), False),
            "small": ((0, 4), True)}


def _grid(seed, s=24, k=139, family="hostile"):
    """Poisson(5) counters with NaN holes; see FAMILIES."""
    (lo, hi), with_resets = FAMILIES[family]
    rng = np.random.default_rng(seed)
    base = 10.0 ** rng.integers(lo, hi, (s, 1))
    g = base + np.cumsum(rng.poisson(5.0, (s, k)), axis=1)
    if with_resets:
        for r, c in zip(*np.nonzero(rng.random((s, k)) < 0.02)):
            g[r, c:] -= g[r, c] - rng.integers(0, 50)   # restart near zero
    g[rng.random((s, k)) < 0.1] = np.nan
    g[0] = np.nan
    g[1, :5] = np.nan
    return g


def _same(got, ref, exact, what):
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    if exact:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-8,
                                   equal_nan=True, err_msg=what)


@pytest.mark.parametrize("fn,family", [
    ("rate", "hostile"), ("increase", "hostile"), ("rate", "small"),
    ("delta", "large"), ("delta", "small")])
@pytest.mark.parametrize("W,stride", [(30, 1), (30, 3), (10, 2), (31, 3)])
def test_extrapolated_family(fn, family, W, stride):
    g = _grid(W * 7 + stride, family=family)
    args = (g, W, STEP_NS, W * STEP_NS, stride)
    _same(getattr(tt, fn)(*args, device="cpu"), getattr(jt, fn)(*args),
          False, fn)


@pytest.mark.parametrize("fn", ["irate", "idelta"])
@pytest.mark.parametrize("W,stride", [(30, 1), (30, 3), (5, 5)])
def test_instant_family(fn, W, stride):
    g = _grid(W + stride + 1, family="hostile")
    args = (g, W, STEP_NS, stride)
    _same(getattr(tt, fn)(*args, device="cpu"), getattr(jt, fn)(*args),
          True, fn)


@pytest.mark.parametrize("finish", ["host", "device", "auto"])
@pytest.mark.parametrize("W,stride", [(10, 1), (30, 3), (31, 3), (30, 30)])
@pytest.mark.parametrize("family", ["large", "small"])
def test_over_time(finish, W, stride, family):
    g = _grid(W * 3 + stride, k=W + 30 * stride, family=family)
    for kind in KINDS:
        got = tt.over_time(g, W, kind, stride, finish=finish, device="cpu")
        ref = jt.over_time(g, W, kind, stride, finish=finish)
        _same(got, ref, finish != "device" and kind in EXACT,
              f"{kind} finish={finish}")


@pytest.mark.parametrize("W,stride", [(10, 1), (31, 3), (30, 30)])
def test_over_time_exact_kinds_on_hostile_counters(W, stride):
    g = _grid(W * 5 + stride, k=W + 30 * stride, family="hostile")
    for kind in EXACT:
        got = tt.over_time(g, W, kind, stride, finish="host", device="cpu")
        _same(got, jt.over_time(g, W, kind, stride, finish="host"), True, kind)


def test_over_time_auto_picks_the_device_finish_on_large_results(monkeypatch):
    """The 262,144-cell threshold: above it "auto" runs the f32 device
    finish, below it the exact host finish, as in the reference."""
    g = _grid(5, s=40, k=60, family="large")
    monkeypatch.setattr(tt, "_F32_FINISH_MIN_CELLS", 40 * 51)
    dev = tt.over_time(g, 10, "sum", finish="device", device="cpu")
    np.testing.assert_array_equal(
        tt.over_time(g, 10, "sum", finish="auto", device="cpu"), dev)
    monkeypatch.setattr(tt, "_F32_FINISH_MIN_CELLS", 40 * 51 + 1)
    np.testing.assert_array_equal(
        tt.over_time(g, 10, "sum", finish="auto", device="cpu"),
        tt.over_time(g, 10, "sum", finish="host", device="cpu"))
    monkeypatch.undo()
    assert tt._F32_FINISH_MIN_CELLS == jt._F32_FINISH_MIN_CELLS == 262_144


def test_rate_no_cancellation_on_huge_counter():
    """A quiet window late in a 1e13 counter keeps its small increase: the
    windowed sums accumulate per window, never as a global prefix sum."""
    T, W = 139, 30
    inc = np.concatenate([[0.0], np.full(60, 2e11), np.full(T - 61, 1.0)])
    grid = np.cumsum(inc)[None, :]
    got = tt.increase(grid, W, STEP_NS, W * STEP_NS, device="cpu")
    ref = jt.increase(grid, W, STEP_NS, W * STEP_NS)
    _same(got, ref, False, "increase")
    assert got[0, -1] == pytest.approx(W, rel=1e-6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("W,stride", [(1, 1), (5, 1), (11, 3), (30, 2)])
def test_wsum_bit_equal_to_reference(seed, W, stride):
    """The windowed f32 sum adds each window left to right from 0.0, as
    the reference's reduce_window does: bit-equal on seeded diff grids,
    whose rows open windows on a 2e9 counter reset (the whole reset value
    summed with small diffs and taken away again) and carry zeros and
    NaN holes."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(600 + seed)
    S, T = 9, 70
    g = np.cumsum(rng.poisson(3.0, (S, T)), axis=1).astype(np.float64)
    g *= 10.0 ** rng.integers(0, 7, (S, 1))
    g[0, :35] += 2e9                      # the reset: down by 2e9 at 35
    d = np.diff(g, axis=1, prepend=0.0)
    d[0, 35] = g[0, 35]                   # adj of a reset is the new value
    d[1, ::7] = 2e9
    x = d.astype(np.float32)
    x[rng.random(x.shape) < 0.1] = 0.0
    x[2, rng.random(T) < 0.2] = np.nan
    want = np.asarray(jt._wsum(jnp.asarray(x), W, stride))
    got = tt._wsum(torch.from_numpy(x), W, stride).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_center_and_host_prep_are_the_reference_s():
    g = _grid(9, family="hostile")
    for a, b in zip(tt.center(g), jt.center(g)):
        np.testing.assert_array_equal(a, b)
    for counter in (True, False):
        for a, b in zip(tt.rate_inputs(g, counter), jt.rate_inputs(g, counter)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    assert tt.extend_window_cells(300, 10) == jt.extend_window_cells(300, 10)
    with pytest.raises(ValueError):
        tt.extend_window_cells(305, 10)


def test_entry_points_need_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _grid(1, s=2, k=40, family="small")
    for call in (lambda: tt.rate(g, 10, STEP_NS, 10 * STEP_NS),
                 lambda: tt.irate(g, 10, STEP_NS),
                 lambda: tt.over_time(g, 10, "sum")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
