"""The six range functions through the port's Engine against the
reference's interpreter, on the CPU: m3_tpu_torch.query.executor.Engine(
storage, device="cpu").execute_range against m3_tpu.query.Engine(storage,
mesh=None).execute_range_ref (the per-node interpreter: the route the port
has; mesh=None keeps the reference on one device), and the instant form
(one step) of both.

Two corpora: bench_promql-shaped counters (promql_corpus, 200 series) and
mixed-sign gauges (gauge_corpus: normal x 10, 20% NaN, 200 series).

Bounds are the reference's own (tests/test_plan_compile.py:170-185), not
the flat rtol 1e-5 / atol 1e-8 of tests/test_torch_query.py, which holds
only for counters and positive levels: on windows that cancel, two f32
sums in different orders are equally far from the exact sum (ROADMAP C1).
- deriv: rtol 1e-3, atol 1e-4; predict_linear and holt_winters: rtol
  2e-3, atol 1e-2;
- everything else: rtol 2e-5 with atol max(1e-8, 1e-6 * max|ref|);
- changes, resets and quantile_over_time over a matrix selector: equal
  (the same comparisons and indices of the same f32 residuals, gathered
  from the same f64 grid)."""

import numpy as np
import pytest

from m3_tpu.query import Engine as JEngine
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import DictStorage, gauge_corpus, promql_corpus

S = 1_000_000_000
STEP = 30 * S

_LOOSE = {"predict_linear": dict(rtol=2e-3, atol=1e-2),
          "holt_winters": dict(rtol=2e-3, atol=1e-2),
          "deriv": dict(rtol=1e-3, atol=1e-4)}
_EXACT = ("changes(", "resets(", "quantile_over_time(")


def _tol(query, ref):
    """tests/test_plan_compile.py:179-185's _tol."""
    for fn, tol in _LOOSE.items():
        if query.startswith(fn):
            return tol
    finite = ref[np.isfinite(ref)]
    scale = float(np.abs(finite).max()) if finite.size else 1.0
    return dict(rtol=2e-5, atol=max(1e-8, 1e-6 * scale))


def _same(got, ref, q):
    assert [t.id() for t in got.series_tags] == [
        t.id() for t in ref.series_tags], q
    g, r = np.asarray(got.values), np.asarray(ref.values)
    assert g.shape == r.shape, q
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=q)
    if q.startswith(_EXACT) and "[" in q and ":" not in q.split("[")[1]:
        np.testing.assert_array_equal(g, r, err_msg=q)
    else:
        np.testing.assert_allclose(g, r, equal_nan=True, err_msg=q,
                                   **_tol(q, r))


SIX = ("deriv({x}[5m])", "predict_linear({x}[5m], 3600)",
       "holt_winters({x}[10m], 0.3, 0.6)", "changes({x}[5m])",
       "resets({x}[5m])", "quantile_over_time(0.9, {x}[5m])")
MORE = ("deriv({x}[5m10s])", "predict_linear({x}[2m] offset 3m, 600)",
        "holt_winters({x}[5m], 0.1, 0.9)", "changes({x}[1m])",
        "resets({x}[5m10s])", "quantile_over_time(0.5, {x}[5m10s])",
        "quantile_over_time(0, {x}[3m])", "quantile_over_time(1, {x}[3m])",
        "quantile_over_time(0.25, {x}[5m] @ 1700002000)",
        "changes({x}[10m:30s])", "deriv(sum_over_time({x}[1m])[10m:1m])",
        "holt_winters(max_over_time({x}[1m])[10m:45s], 0.5, 0.5)",
        "quantile_over_time(0.9, avg_over_time({x}[2m])[10m:30s])",
        "sum by (i) (deriv({x}[5m]))", "predict_linear({x}[5m], 0) - {x}")
# The flat-bound corpora of tests/test_torch_query.py stay counters; the
# gauge corpus adds the summed kinds under the scale-aware bound (C1).
GAUGE_ONLY = ("sum_over_time({x}[5m])", "avg_over_time({x}[5m])",
              "delta({x}[5m])", "stddev_over_time({x}[5m])")


@pytest.fixture(scope="module")
def engines():
    counters, t = promql_corpus(200, 11)
    gauges, _ = gauge_corpus(200, 5)
    st = DictStorage({**counters, **gauges})
    return Engine(st, device="cpu"), JEngine(st, mesh=None), t


CASES = ([(q.format(x="bench_metric"), "counter") for q in SIX + MORE]
         + [(q.format(x="bench_gauge"), "gauge")
            for q in SIX + MORE + GAUGE_ONLY]
         + [("rate(bench_metric[5m:30s])", "counter"),
            ("deriv(rate(bench_metric[5m])[30m:1m])", "counter")])


@pytest.mark.parametrize("q,corpus", CASES)
def test_range_query_matches_reference(engines, q, corpus):
    eng, ref, t = engines
    start, end = int(t[30]), int(t[-1])
    _same(eng.execute_range(q, start, end, STEP),
          ref.execute_range_ref(q, start, end, STEP), q)


@pytest.mark.parametrize("q", [q.format(x=x) for q in SIX
                               for x in ("bench_metric", "bench_gauge")])
def test_instant_query_matches_reference(engines, q):
    eng, ref, t = engines
    at = int(t[200])
    _same(eng.execute_instant(q, at), ref.execute_range_ref(q, at, at, S), q)


def test_the_six_functions_no_longer_raise(engines):
    eng, _, t = engines
    for q in SIX:
        blk = eng.execute_range(q.format(x="bench_gauge"), int(t[30]),
                                int(t[-1]), STEP)
        assert blk.values.shape == (200, 110)
        assert np.isfinite(blk.values).any(), q
