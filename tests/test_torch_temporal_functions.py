"""The six range functions of m3_tpu_torch.ops.temporal that the rate
family and *_over_time left (quantile_over_time, changes, resets, deriv,
predict_linear, holt_winters) against m3_tpu.ops.temporal on the same f64
grids, on the CPU (device="cpu"); their scalar Prometheus oracles; and the
upload and derived-input caches.

Grids (all [24, 80], each with an all-NaN row 0 and a constant row 1):
counters with resets and 20% NaN (tests/test_temporal.py make_grid),
mixed-sign gauges (normal x 10, 25% NaN) at offsets 0, 100 and 1e7, and a
gauge with +-Inf and +-0 cells.

Bounds:
- changes and resets: equal, NaN where the window is empty: both count
  comparisons of the same f32 residuals.
- quantile_over_time: bit for bit. The f32 indices and fractions come
  from the same residuals through a stable argsort (jnp.argsort is
  stable) and the same f32 arithmetic; the gather is host f64.
- deriv: rtol 1e-3, atol 1e-4; predict_linear and holt_winters: rtol
  2e-3, atol 1e-2. These are the reference's own bounds for the family
  (tests/test_plan_compile.py:170-175): f32 sums over a cancelling
  denominator in another order."""

import math

import numpy as np
import pytest
import torch

from m3_tpu.ops import temporal as jt
from m3_tpu_torch.ops import temporal as tt

S_NS = 1_000_000_000
STEP_NS = 10 * S_NS
STEP_S = 10.0
Q, OFFSET_S, SF, TF = 0.9, 3600.0, 0.3, 0.6

FAMILY_TOL = {"deriv": dict(rtol=1e-3, atol=1e-4),
              "predict_linear": dict(rtol=2e-3, atol=1e-2),
              "holt_winters": dict(rtol=2e-3, atol=1e-2)}
WINDOWS = [(1, 1), (2, 1), (5, 3), (10, 1), (17, 3), (31, 1), (31, 3)]


def make_grid(rng, n_series=24, n_cells=80, nan_frac=0.2, counter=True,
              offset=0.0):
    """tests/test_temporal.py's make_grid: exponential-increment counters
    with a reset in every third series, or normal(offset, 10) gauges."""
    if counter:
        inc = rng.exponential(5.0, size=(n_series, n_cells))
        vals = np.cumsum(inc, axis=1) + offset
        for i in range(0, n_series, 3):
            vals[i, n_cells // 2:] = np.cumsum(inc[i, n_cells // 2:])
    else:
        vals = rng.normal(offset, 10, size=(n_series, n_cells))
    vals[rng.random((n_series, n_cells)) < nan_frac] = np.nan
    return vals


def _grid(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "counter":
        g = make_grid(rng)
    elif kind == "special":
        g = make_grid(rng, counter=False, nan_frac=0.2)
        cells = rng.random(g.shape)
        g[cells < 0.05] = np.inf
        g[(cells >= 0.05) & (cells < 0.1)] = -np.inf
        g[(cells >= 0.1) & (cells < 0.15)] = 0.0
        g[(cells >= 0.15) & (cells < 0.2)] = -0.0
        g[2, ::2], g[2, 1::2] = 0.0, -0.0
    else:
        g = make_grid(rng, counter=False, nan_frac=0.25,
                      offset=float(kind.split(":")[1]))
    g[0] = np.nan
    g[1] = 42.5
    return g


GRIDS = ["counter", "gauge:0", "gauge:100", "gauge:1e7", "special"]


def _call(mod, fn, g, W, stride, **kw):
    args = {"quantile_over_time": (g, W, Q, stride),
            "changes": (g, W, stride), "resets": (g, W, stride),
            "deriv": (g, W, STEP_NS, stride),
            "predict_linear": (g, W, STEP_NS, OFFSET_S, stride),
            "holt_winters": (g, W, SF, TF, stride)}[fn]
    return getattr(mod, fn)(*args, **kw)


@pytest.mark.parametrize("W,stride", WINDOWS)
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("fn", ["quantile_over_time", "changes", "resets",
                                "deriv", "predict_linear", "holt_winters"])
def test_function_matches_reference(fn, grid, W, stride):
    g = _grid(grid, seed=W * 7 + stride)
    got = _call(tt, fn, g, W, stride, device="cpu")
    ref = _call(jt, fn, g, W, stride)
    what = f"{fn} {grid} W={W} stride={stride}"
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
    if fn == "quantile_over_time":
        np.testing.assert_array_equal(got.view(np.uint64),
                                      ref.view(np.uint64), err_msg=what)
    elif fn in ("changes", "resets"):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, equal_nan=True, err_msg=what,
                                   **FAMILY_TOL[fn])


def test_window_wider_than_grid_gives_an_empty_plane():
    g = _grid("gauge:0")[:, :4]
    for fn in ("quantile_over_time", "changes", "deriv", "holt_winters"):
        got = _call(tt, fn, g, 6, 1, device="cpu")
        assert got.shape == _call(jt, fn, g, 6, 1).shape == (24, 0), fn


def test_quantile_ties_keep_the_window_order():
    """Distinct f64 values that collapse to one f32 residual: only a
    stable argsort picks the reference's index, and the host gathers the
    exact f64 value at it."""
    base = 1e9
    row = base + np.array([3e-7, 1e-7, 2e-7, 0.0, 4e-7, 1.0])
    g = np.stack([row, row[::-1]])
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        got = tt.quantile_over_time(g, 6, q, device="cpu")
        ref = jt.quantile_over_time(g, 6, q)
        np.testing.assert_array_equal(got.view(np.uint64),
                                      ref.view(np.uint64))


# ---------------------------------------------- the reference's scalar oracles
# (tests/test_temporal.py:156-241, run on the port)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_quantile_over_time_exact_values(rng):
    W = 6
    grid = make_grid(rng, n_series=7, n_cells=40, counter=False,
                     nan_frac=0.3, offset=1e7)
    out = tt.quantile_over_time(grid, W, 0.5, device="cpu")
    for s in range(grid.shape[0]):
        for t in range(out.shape[1]):
            win = grid[s, t:t + W]
            vals = np.sort(win[np.isfinite(win)])
            if vals.size == 0:
                assert math.isnan(out[s, t])
                continue
            pos = 0.5 * (vals.size - 1)
            lo, hi = int(np.floor(pos)), min(int(np.floor(pos)) + 1,
                                             vals.size - 1)
            exp = vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
            assert out[s, t] == pytest.approx(exp, rel=1e-9), (s, t)


def test_changes_resets():
    grid = np.array([[1.0, 1.0, 2.0, np.nan, 2.0, 1.0, 3.0]])
    # changes: 1->2, 2->1, 1->3 (2->2 across the NaN is none)
    assert tt.changes(grid, 7, device="cpu")[0, 0] == 3
    assert tt.resets(grid, 7, device="cpu")[0, 0] == 1    # only 2->1


def test_deriv_predict_linear(rng):
    W = 8
    slope_true = 2.5
    t = np.arange(30) * STEP_S
    grid = 1e6 + slope_true * t[None, :] + rng.normal(0, 0.01, size=(2, 30))
    d = tt.deriv(grid, W, STEP_NS, device="cpu")
    p = tt.predict_linear(grid, W, STEP_NS, 60.0, device="cpu")
    for s in range(2):
        for i in range(d.shape[1]):
            assert d[s, i] == pytest.approx(slope_true, rel=1e-3)
            t_now = (i + W - 1) * STEP_S
            exp = 1e6 + slope_true * (t_now + 60.0)
            assert p[s, i] == pytest.approx(exp, rel=1e-6)


def test_holt_winters_matches_scalar(rng):
    W = 10
    grid = make_grid(rng, n_series=7, n_cells=40, counter=False,
                     nan_frac=0.2, offset=100.0)
    out = tt.holt_winters(grid, W, SF, TF, device="cpu")

    def scalar_hw(win):
        vals = [v for v in win if not math.isnan(v)]
        if len(vals) < 2:
            return math.nan
        s_prev, b_prev = vals[0], vals[1] - vals[0]
        for x in vals[1:]:
            s1 = SF * x + (1 - SF) * (s_prev + b_prev)
            b_prev = TF * (s1 - s_prev) + (1 - TF) * b_prev
            s_prev = s1
        return s_prev

    for s in range(grid.shape[0]):
        for t in range(out.shape[1]):
            exp = scalar_hw(grid[s, t:t + W])
            if math.isnan(exp):
                assert math.isnan(out[s, t])
            else:
                assert out[s, t] == pytest.approx(exp, rel=1e-3, abs=1e-3)


def test_irate_idelta(rng):
    W = 5
    grid = make_grid(rng, n_series=7, n_cells=40, counter=True, nan_frac=0.3)
    out_ir = tt.irate(grid, W, STEP_NS, device="cpu")
    out_id = tt.idelta(grid, W, STEP_NS, device="cpu")
    for s in range(grid.shape[0]):
        for t in range(out_ir.shape[1]):
            win = grid[s, t:t + W]
            valid = np.flatnonzero(np.isfinite(win))
            if valid.size < 2:
                assert math.isnan(out_ir[s, t])
                continue
            i2, i1 = valid[-1], valid[-2]
            dv, dt = win[i2] - win[i1], (i2 - i1) * STEP_S
            exp_ir = (win[i2] if win[i2] < win[i1] else dv) / dt
            assert out_ir[s, t] == pytest.approx(exp_ir, rel=1e-4, abs=1e-6)
            assert out_id[s, t] == pytest.approx(dv, rel=1e-4, abs=1e-3)


# ---------------------------------------------------------------- the caches
# The cases of tests/test_query_cache.py:183-215 (TestDerivedIdFastPath).


@pytest.fixture()
def fresh_caches(monkeypatch):
    """Empty caches for the test, with the real budget registration."""
    for name in ("_DERIVED_CACHE", "_DERIVED_ID_FAST", "_PUT_CACHE"):
        monkeypatch.setattr(tt, name, type(getattr(tt, name))())
    for name in ("_derived_cache_bytes", "_derived_id_fast_bytes",
                 "_put_cache_bytes"):
        monkeypatch.setattr(tt, name, 0)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(tt, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tt, name, wrapped)
    return calls


def _hashes(monkeypatch):
    import hashlib as real_hashlib

    calls = []

    class _H:
        def __getattr__(self, name):
            return getattr(real_hashlib, name)

        @staticmethod
        def blake2b(*a, **k):
            calls.append(1)
            return real_hashlib.blake2b(*a, **k)

    monkeypatch.setattr(tt, "hashlib", _H())
    return calls


def _derived_hits():
    return tt._DERIVED_METRICS.counter("hits").value()


def test_same_grid_object_hits_the_id_path(monkeypatch, fresh_caches):
    preps = _counting(monkeypatch, "rate_inputs")
    puts = _counting(monkeypatch, "_put")
    grid = np.random.default_rng(0).random((16, 50)).cumsum(axis=1)
    r1 = tt.rate(grid, 6, 10 * S_NS, 60 * S_NS, 3, device="cpu")
    n_preps, n_puts, hits = len(preps), len(puts), _derived_hits()
    assert n_preps == 1 and n_puts == 3        # adj, finite, grid32
    r2 = tt.rate(grid, 6, 10 * S_NS, 60 * S_NS, 3, device="cpu")
    assert len(preps) == n_preps and len(puts) == n_puts
    assert _derived_hits() == hits + 1
    np.testing.assert_array_equal(r1, r2)


def test_rebuilt_equal_grid_misses_the_id_path(monkeypatch, fresh_caches):
    preps = _counting(monkeypatch, "center")
    grid = np.random.default_rng(0).random((16, 50))
    r1 = tt.over_time(grid, 6, "sum", 3, device="cpu")
    hits = _derived_hits()
    r2 = tt.over_time(grid.copy(), 6, "sum", 3, device="cpu")
    assert len(preps) == 2 and _derived_hits() == hits
    np.testing.assert_array_equal(r1, r2)


def test_every_centred_function_shares_one_derived_entry(monkeypatch,
                                                         fresh_caches):
    preps = _counting(monkeypatch, "center")
    grid = _grid("gauge:100")
    for fn in ("quantile_over_time", "changes", "resets", "deriv",
               "predict_linear", "holt_winters"):
        _call(tt, fn, grid, 5, 1, device="cpu")
    tt.over_time(grid, 5, "sum", device="cpu")
    assert len(preps) == 1


def test_id_path_byte_ceiling_evicts(monkeypatch, fresh_caches):
    monkeypatch.setattr(tt, "_DERIVED_ID_FAST_MAX_BYTES", 1)
    g1 = np.random.default_rng(1).random((8, 30))
    g2 = np.random.default_rng(2).random((8, 30))
    tt.over_time(g1, 3, "sum", 2, device="cpu")
    tt.over_time(g2, 3, "sum", 2, device="cpu")
    assert len(tt._DERIVED_ID_FAST) <= 1


def test_content_tier_is_off_on_the_cpu(monkeypatch, fresh_caches):
    calls = _hashes(monkeypatch)
    grid = np.random.default_rng(3).random((8, 30))
    tt.rate(grid, 3, 10 * S_NS, 30 * S_NS, device="cpu")
    tt.irate(grid, 3, 10 * S_NS, device="cpu")
    tt.over_time(grid.copy(), 3, "max", device="cpu")
    assert calls == [] and len(tt._DERIVED_CACHE) == 0
    assert len(tt._PUT_CACHE) == 0


def test_content_tier_on_a_card_placement(monkeypatch, fresh_caches):
    """The content tier's logic with the device key of a card placement
    (the uploads stay on the host here: _put is replaced): an equal grid
    in a new object re-hashes and hits the prepared tensors; the upload
    cache hits on equal content."""
    card = torch.device("cuda")
    monkeypatch.setattr(tt, "_put", lambda arr, dev: torch.from_numpy(
        np.ascontiguousarray(arr)))
    calls = _hashes(monkeypatch)
    builds = []

    def build(g):
        builds.append(1)
        return (torch.from_numpy(g.astype(np.float32)),), g.nbytes // 2

    grid = np.random.default_rng(4).random((8, 30))
    misses = tt._DERIVED_METRICS.counter("misses").value()
    first = tt._derived(grid, "k", build, card)
    again = tt._derived(grid.copy(), "k", build, card)
    assert again is first and len(builds) == 1 and len(calls) == 2
    assert tt._DERIVED_METRICS.counter("misses").value() == misses + 1
    assert tt._derived(grid, "k", build, card) is first
    assert len(calls) == 2                      # the id path: no hash
    assert tt._derived(grid.copy(), "k", build, torch.device("cpu")) \
        is not first                            # the device is in the key
    mask = np.isfinite(grid)
    up = tt._cached_put(mask, card)
    assert tt._cached_put(mask.copy(), card) is up
    assert tt._UPLOAD_METRICS.counter("hits").value() >= 1
    assert tt._derived_cache_bytes == grid.nbytes // 2
    assert tt._put_cache_bytes == mask.nbytes


def test_three_tenants_are_reclaimed_by_the_shared_budget(monkeypatch,
                                                          fresh_caches):
    from m3_tpu_torch.utils import hbm

    budget = hbm.shared_budget()
    for i in range(3):
        tt.over_time(np.random.default_rng(i).random((8, 30)), 3, "sum",
                     device="cpu")
    usage = budget.usage()
    assert {"upload", "derived", "derived_id"} <= set(usage)
    before = tt._derived_id_fast_bytes
    assert usage["derived_id"] == before > 0
    monkeypatch.setattr(budget, "limit", 1)
    freed = budget.reclaim()
    assert freed > 0 and tt._derived_id_fast_bytes < before
    assert len(tt._DERIVED_ID_FAST) == 1    # an evictor keeps its last entry
