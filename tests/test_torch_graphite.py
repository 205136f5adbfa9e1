"""The port's Graphite engine against the reference's, on the CPU:
m3_tpu_torch.query.graphite.GraphiteEngine(storage, device="cpu") against
m3_tpu.query.graphite.GraphiteEngine(storage) on the same storage, plus
the carbon parser, the target parser and the path matchers.

Every builtin of the reference's registry renders a target template over
a seeded DictStorage of carbon series: 40 positive-level series
(app.h0-9.{cpu,mem,req,err}) and 20 mixed-sign gauges
(gauge.h0-9.{delta,temp}), 5% of their points missing. Host-only builtins
run the same numpy code in both engines and must be bit-identical. The
window builtins (moving*, stdev) run ops/temporal: f32 window sums in
another order, so they are held to rtol 1e-5, atol 1e-8 (bench.py's
oracle tolerance) on the positive levels and to the reference's own
scale-aware bound for cancelling windows on the gauges (`_tol` below:
tests/test_plan_compile.py:179-185, rtol 2e-5 with atol
max(1e-8, 1e-6 * max|ref|))."""

import numpy as np
import pytest

from m3_tpu.metrics import carbon as jcarbon
from m3_tpu.query import graphite as jg
from m3_tpu_torch.metrics import carbon
from m3_tpu_torch.query import graphite as tg
from m3_tpu_torch.testing import DictStorage

S = 1_000_000_000
T0 = 1_600_000_000 * S
POINTS, STEP = 720, 60 * S          # 2 h of points at 10 s; render at 60 s
START, END = T0 + 30 * 60 * S, T0 + (POINTS - 1) * 10 * S

FAMILIES = {
    "positive": dict(a="app.*.cpu", b="app.*.mem", one="app.h1.cpu",
                     two="app.h2.mem", all="app.*.*", thr="5"),
    "gauge": dict(a="gauge.*.delta", b="gauge.*.temp", one="gauge.h1.delta",
                  two="gauge.h2.temp", all="gauge.*.*", thr="0"),
}

# One target template per registered name.
TEMPLATES = {
    "absolute": "absolute({a})",
    "aggregateLine": 'aggregateLine({one}, "max")',
    "alias": 'alias({a}, "x")',
    "aliasByMetric": "aliasByMetric({a})",
    "aliasByNode": "aliasByNode({a}, 1)",
    "aliasSub": 'aliasSub({a}, "h", "host")',
    "asPercent": "asPercent({a})",
    "averageAbove": "averageAbove({a}, {thr})",
    "averageBelow": "averageBelow({a}, {thr})",
    "averageOutsidePercentile": "averageOutsidePercentile({a}, 30)",
    "averageSeries": "averageSeries({a})",
    "averageSeriesWithWildcards": "averageSeriesWithWildcards({all}, 1)",
    "avg": "avg({a})",
    "cactiStyle": "cactiStyle({a})",
    "changed": "changed({a})",
    "consolidateBy": 'consolidateBy({a}, "max")',
    "constantLine": "constantLine(5)",
    "countSeries": "countSeries({a})",
    "currentAbove": "currentAbove({a}, {thr})",
    "currentBelow": "currentBelow({a}, {thr})",
    "dashed": "dashed({a})",
    "delay": "delay({a}, 2)",
    "derivative": "derivative({a})",
    "diffSeries": "diffSeries({one}, {two})",
    "divideSeries": "divideSeries({a}, {two})",
    "exclude": 'exclude({a}, "h1")',
    "fallbackSeries": "fallbackSeries(none.x.y, {a})",
    "grep": 'grep({a}, "h1")',
    "group": "group({one}, {two})",
    "groupByNode": 'groupByNode({all}, 2, "sum")',
    "groupByNodes": 'groupByNodes({all}, "max", 2)',
    "highestAverage": "highestAverage({a}, 3)",
    "highestCurrent": "highestCurrent({a}, 3)",
    "highestMax": "highestMax({a}, 3)",
    "hitcount": 'hitcount({a}, "5min")',
    "holtWintersAberration": "holtWintersAberration({one}, 3)",
    "holtWintersConfidenceBands": "holtWintersConfidenceBands({one}, 3)",
    "holtWintersForecast": "holtWintersForecast({one})",
    "identity": 'identity("x")',
    "integral": "integral({a})",
    "invert": "invert({a})",
    "isNonNull": "isNonNull({a})",
    "keepLastValue": "keepLastValue({a})",
    "legendValue": 'legendValue({a}, "avg")',
    "limit": "limit({a}, 3)",
    "log": "log({a}, 10)",
    "logarithm": "logarithm({a})",
    "lowestAverage": "lowestAverage({a}, 3)",
    "lowestCurrent": "lowestCurrent({a}, 3)",
    "maxSeries": "maxSeries({a})",
    "maximumAbove": "maximumAbove({a}, {thr})",
    "maximumBelow": "maximumBelow({a}, {thr})",
    "minSeries": "minSeries({a})",
    "minimumAbove": "minimumAbove({a}, {thr})",
    "minimumBelow": "minimumBelow({a}, {thr})",
    "mostDeviant": "mostDeviant({a}, 3)",
    "movingAverage": 'movingAverage({a}, "5min")',
    "movingMax": 'movingMax({a}, "5min")',
    "movingMedian": 'movingMedian({a}, "5min")',
    "movingMin": "movingMin({a}, 4)",
    "movingSum": 'movingSum({a}, "10min")',
    "multiplySeries": "multiplySeries({one}, {two})",
    "nPercentile": "nPercentile({a}, 50)",
    "nonNegativeDerivative": "nonNegativeDerivative({a})",
    "offset": "offset({a}, 10)",
    "offsetToZero": "offsetToZero({a})",
    "perSecond": "perSecond({a})",
    "percentileOfSeries": "percentileOfSeries({a}, 90)",
    "pow": "pow({a}, 2)",
    "randomWalk": 'randomWalk("r")',
    "randomWalkFunction": 'randomWalkFunction("r")',
    "rangeOfSeries": "rangeOfSeries({a})",
    "removeAbovePercentile": "removeAbovePercentile({a}, 80)",
    "removeAboveValue": "removeAboveValue({a}, {thr})",
    "removeBelowPercentile": "removeBelowPercentile({a}, 20)",
    "removeBelowValue": "removeBelowValue({a}, {thr})",
    "removeEmptySeries": "removeEmptySeries({a})",
    "scale": "scale({a}, 2.5)",
    "scaleToSeconds": "scaleToSeconds({a}, 30)",
    "sortByMaxima": "sortByMaxima({a})",
    "sortByMinima": "sortByMinima({a})",
    "sortByName": "sortByName({a})",
    "sortByTotal": "sortByTotal({a})",
    "squareRoot": "squareRoot({a})",
    "stacked": "stacked({a})",
    "stddev": "stddev({a}, 5)",
    "stddevSeries": "stddevSeries({a})",
    "stdev": "stdev({a}, 7, 0.5)",
    "substr": "substr({a}, 1, 2)",
    "sum": "sum({a})",
    "sumSeries": "sumSeries({a})",
    "sumSeriesWithWildcards": "sumSeriesWithWildcards({all}, 1)",
    "summarize": 'summarize({a}, "5min", "sum")',
    "sustainedAbove": 'sustainedAbove({a}, {thr}, "2min")',
    "sustainedBelow": 'sustainedBelow({a}, {thr}, "2min")',
    "threshold": 'threshold(5, "five")',
    "time": 'time("t")',
    "timeFunction": 'timeFunction("t")',
    "timeShift": 'timeShift({a}, "5min")',
    "timeSlice": 'timeSlice({a}, "-40min", "-10min")',
    "transformNull": "transformNull({a}, -1)",
    "weightedAverage": "weightedAverage({a}, {b}, 1)",
}
# The builtins whose math runs in ops/temporal on the engine's device.
WINDOWED = {"movingAverage", "movingMax", "movingMedian", "movingMin",
            "movingSum", "stddev", "stdev"}


def _tol(ref):
    """The reference's scale-aware bound (tests/test_plan_compile.py:
    179-185) for f32 sums of windows that cancel."""
    finite = ref[np.isfinite(ref)]
    scale = float(np.abs(finite).max()) if finite.size else 1.0
    return dict(rtol=2e-5, atol=max(1e-8, 1e-6 * scale))


def _corpus():
    """{id: {tags, t, v}}: carbon-tagged series on a 10 s grid with 5% of
    the points dropped; positive levels (lognormal drift) and mixed-sign
    gauges (normal x 10)."""
    rng = np.random.default_rng(29)
    t = T0 + np.arange(POINTS, dtype=np.int64) * 10 * S
    series = {}
    paths = ([b"app.h%d.%s" % (h, m) for h in range(10)
              for m in (b"cpu", b"mem", b"req", b"err")]
             + [b"gauge.h%d.%s" % (h, m) for h in range(10)
                for m in (b"delta", b"temp")])
    for path in paths:
        if path.startswith(b"app"):
            v = np.exp(rng.normal(1.5, 0.8) + np.cumsum(
                rng.normal(0, 0.02, POINTS)))
        else:
            v = rng.normal(0, 10, POINTS)
        keep = rng.random(POINTS) >= 0.05
        series[path] = {"tags": carbon.path_to_tags(path), "t": t[keep],
                        "v": v[keep]}
    return series


@pytest.fixture(scope="module")
def engines():
    st = DictStorage(_corpus())
    return (tg.GraphiteEngine(st, step_ns=STEP, device="cpu"),
            jg.GraphiteEngine(st, step_ns=STEP))


def _same(got, ref, what, tol=None):
    assert [tg.series_name(t) for t in got.series_tags] == [
        jg.series_name(t) for t in ref.series_tags], what
    assert (got.meta.start_ns, got.meta.step_ns, got.meta.steps) == (
        ref.meta.start_ns, ref.meta.step_ns, ref.meta.steps), what
    g, r = np.asarray(got.values), np.asarray(ref.values)
    assert g.shape == r.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=what)
    if tol is None:
        np.testing.assert_array_equal(g, r, err_msg=what)
    else:
        np.testing.assert_allclose(g, r, equal_nan=True, err_msg=what, **tol)


def test_registry_names_match_the_reference():
    assert sorted(tg._FUNCTIONS) == sorted(jg._FUNCTIONS)
    assert sorted(TEMPLATES) == sorted(jg._FUNCTIONS)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_builtin_matches_reference(engines, name, family):
    eng, ref = engines
    target = TEMPLATES[name].format(**FAMILIES[family])
    want = ref.render(target, START, END)
    tol = None
    if name in WINDOWED:
        tol = (dict(rtol=1e-5, atol=1e-8) if family == "positive"
               else _tol(np.asarray(want.values)))
    _same(eng.render(target, START, END), want, target, tol)


@pytest.mark.parametrize("line", [
    b"servers.web01.cpu 42.5 1600000000", b"", b"onlypath", b"a.b 1.0",
    b"a.b x 123", b".lead 1 2", b"trail. 1 2", b"a.b nan 123",
    b"a.b inf 1600000000", b"a.b.c -1e-3 1.6e9"])
def test_carbon_parse_line_matches_reference(line):
    assert carbon.parse_line(line) == jcarbon.parse_line(line)


def test_carbon_lines_and_tags_match_reference():
    data = b"a.b 1 2\n\nbad\nx.y.z 3.5 4\n"
    assert list(carbon.parse_lines(data)) == list(jcarbon.parse_lines(data))
    for path in (b"a", b"a.b.c", b"servers.web-01.cpu_total"):
        tags = carbon.path_to_tags(path)
        assert tags == jcarbon.path_to_tags(path)
        assert carbon.tags_to_path(tags) == jcarbon.tags_to_path(tags) == path


@pytest.mark.parametrize("target", [
    "servers.*.cpu", 'scale(sumSeries(servers.*.cpu), 0.5)',
    'summarize(a.b, "1min", "max", true)', "aliasByNode(a.{x,y}.c, -1)",
    'groupByNodes(a.*.*, "sum", 1, 2)', "offset(a.b, -2.5e-1)"])
def test_parse_target_matches_reference(target):
    def shape(node):
        if isinstance(node, (tg.CallExpr, jg.CallExpr)):
            return ("call", node.func, [shape(a) for a in node.args])
        if isinstance(node, (tg.PathExpr, jg.PathExpr)):
            return ("path", node.path)
        return ("lit", node.value)

    assert shape(tg.parse_target(target)) == shape(jg.parse_target(target))


@pytest.mark.parametrize("path", [
    "servers.*.cpu", "servers.{web01,web02}.cpu", "a.b?.c[0-9]", "a.b.c",
    "x.*.y.*"])
def test_path_to_matchers_matches_reference(path):
    got, want = tg.path_to_matchers(path), jg.path_to_matchers(path)
    assert [(m.type.name, m.name, m.value) for m in got] == [
        (m.type.name, m.name, m.value) for m in want]
    for value in (b"web01", b"web03", b"b1", b"c7", b"", b"cpu"):
        assert [m.matches(value) for m in got] == [
            m.matches(value) for m in want]


def test_parse_errors_match_reference():
    for bad in ("sumSeries(a.b", "a.b)", "f(,)x"):
        with pytest.raises(ValueError) as want:
            jg.parse_target(bad)
        with pytest.raises(tg.GraphiteParseError) as got:
            tg.parse_target(bad)
        assert str(got.value) == str(want.value)


def test_render_over_stored_data_equals_dictstorage():
    """The carbon corpus written through the port's Database (one
    write_batch per 10 s step, with the __gN__ tags) and sealed: renders
    through LocalStorage equal the same renders over DictStorage."""
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.query.storage import LocalStorage
    from m3_tpu_torch.storage.database import Database

    series = _corpus()
    now = {"t": T0}
    db = Database(ShardSet(4), clock=lambda: now["t"], device="cpu")
    db.ensure_namespace(b"default")
    sids = list(series)
    for j in range(POINTS):
        tj = T0 + j * 10 * S
        ids, vals, tags = [], [], []
        for sid in sids:
            e = series[sid]
            hit = np.flatnonzero(e["t"] == tj)
            if hit.size:
                ids.append(sid)
                vals.append(e["v"][hit[0]])
                tags.append(e["tags"])
        now["t"] = tj
        db.write_batch(b"default", ids, np.full(len(ids), tj, np.int64),
                       np.asarray(vals), tags=tags)
    now["t"] = T0 + 4 * 3600 * S
    assert db.tick()["sealed"] > 0
    stored = tg.GraphiteEngine(LocalStorage(db, b"default"), step_ns=STEP,
                               device="cpu")
    plain = tg.GraphiteEngine(DictStorage(series), step_ns=STEP, device="cpu")
    for target in ('movingAverage(app.*.cpu, "5min")', "sumSeries(app.*.*)",
                   "stdev(gauge.*.delta, 7, 0.5)",
                   'groupByNode(app.*.*, 2, "sum")'):
        _same(stored.render(target, START, END),
              plain.render(target, START, END), target)
    db.close()


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.GraphiteEngine(DictStorage({}))
    assert tg.GraphiteEngine(DictStorage({}), device="cpu").device.type == "cpu"
