"""The port's standing rules engine (m3_tpu_torch/coordinator/
rules_engine.py) over Engine(DictStorage, device="cpu") against the
reference's (m3_tpu/coordinator/rules_engine.py) over
m3_tpu.query.Engine(DictStorage, mesh=None) (mesh=None: the conftest
forces eight CPU devices), paired as tests/test_torch_plan_compile.py
pairs the two engines.

Tolerances: recorded rows have the same (tags, time) keys in both
packages and values within the reference's plan bounds
(tests/test_plan_compile.py _tol: rtol 2e-5 with atol max(1e-8, 1e-6
max|ref|)); transitions are equal as sets (rule, series, kind, time), with
their values within the same bound. Alert thresholds sit at midpoints of
gaps in the data wider than that bound on both sides
(testing.gap_thresholds), so answers within the bound compare alike.

The compare's precision split is the reference's and is held exactly: at
4,096 cells or more it compares in f32 (the reference's jit, without
x64), below in f64 on the host, so 1.0 + 2**-30 > 1.0 fires at [2, 2] and
does not at [100, 50] in both packages."""

import numpy as np
import pytest

from m3_tpu.coordinator import rules_engine as jre
from m3_tpu.query import Engine as JEngine
from m3_tpu.query import block as jblock
from m3_tpu.query import model as jmodel
from m3_tpu.query import plan as jplan
from m3_tpu_torch.coordinator import rules_engine as tre
from m3_tpu_torch.query import block as tblock
from m3_tpu_torch.query import model as tmodel
from m3_tpu_torch.query import plan as tplan
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import DictStorage, gap_thresholds, promql_corpus
from test_plan_compile import _tol

S = 1_000_000_000
STEP = 30 * S
N_SERIES, N_HOSTS = 64, 8
AVG = "avg_over_time(bench_requests[5m])"
RECORDS = ("sum by (host) (rate(bench_requests[5m]))",
           "max_over_time(bench_requests[5m])")


@pytest.fixture(params=["compiled", "floor"])
def route(request, monkeypatch):
    """"compiled": both packages' plan floors at 1, so every expression
    takes the compiled plan route; "floor": the default 4,096-cell floor
    (these small rounds take the interpreter)."""
    if request.param == "compiled":
        monkeypatch.setattr(tplan, "PLAN_MIN_CELLS", 1)
        monkeypatch.setattr(jplan, "PLAN_MIN_CELLS", 1)
    return request.param


def rule_sets(thresholds, re_mod):
    recs = [re_mod.RecordingRule(b"rec:%d" % i, q,
                                 labels=((b"rule", b"r%d" % i),))
            for i, q in enumerate(RECORDS)]
    alerts = [re_mod.AlertRule(b"hot:%02d" % i, AVG, ">", th)
              for i, th in enumerate(thresholds)]
    alerts.append(re_mod.AlertRule(b"sticky", AVG, ">",
                                   thresholds[len(thresholds) // 2],
                                   for_steps=3))
    return recs, alerts


def run_rounds(re_mod, engine, recs, alerts, clocks):
    written = []
    eng = re_mod.RulesEngine(engine, written.append, step_ns=STEP,
                             clock=lambda: clocks[0])
    for r in recs:
        eng.add_recording(r)
    for a in alerts:
        eng.add_alert(a)
    results = []
    for now in clocks:
        res = eng.evaluate(now)
        results.append((res.steps, res.exprs_evaluated, res.recorded_rows,
                        res.transitions))
    rows = [r for batch in written for r in batch]
    return results, rows, eng


def corpus():
    series, t = promql_corpus(N_SERIES, 17, hosts=N_HOSTS,
                              metric=b"bench_requests")
    return DictStorage(series), t


def thresholds_for(storage, t, k=16):
    blk = JEngine(storage, mesh=None).execute_range_ref(
        AVG, int(t[30]), int(t[-1]), STEP)
    return gap_thresholds(np.asarray(blk.values), k)


def rows_key(rows):
    return {(tuple(sorted(tags.items())), t): v for tags, t, v in rows}


def assert_same_rounds(got, want):
    (g_res, g_rows, _), (w_res, w_rows, _) = got, want
    assert [r[:3] for r in g_res] == [r[:3] for r in w_res]
    gk, wk = rows_key(g_rows), rows_key(w_rows)
    assert len(gk) == len(g_rows) and gk.keys() == wk.keys()
    for name in (b"rec:0", b"rec:1"):
        keys = [k for k in wk if dict(k[0])[b"__name__"] == name]
        ref = np.array([wk[k] for k in keys])
        got_v = np.array([gk[k] for k in keys])
        np.testing.assert_allclose(got_v, ref, err_msg=name,
                                   **_tol("", ref[None, :]))
    for (_, _, _, gt), (_, _, _, wt) in zip(g_res, w_res):
        assert {(x.rule, x.series, x.kind, x.time_nanos) for x in gt} == \
            {(x.rule, x.series, x.kind, x.time_nanos) for x in wt}
        gv = {(x.rule, x.series, x.time_nanos): x.value for x in gt}
        for x in wt:
            ref = np.array([x.value])
            np.testing.assert_allclose([gv[(x.rule, x.series, x.time_nanos)]],
                                       ref, **_tol("", ref[None, :]))


def test_four_rounds_equal_reference(route):
    """Two recording rules, a 16-rule alert class and a for_steps=3 rule
    over 4 rounds on an advancing clock (1, 2, 3 and 4 new steps)."""
    storage, t = corpus()
    ths = thresholds_for(storage, t)
    clocks = [int(t[200]) + k * STEP for k in (0, 2, 5, 9)]
    got = run_rounds(tre, Engine(storage, device="cpu"),
                     *rule_sets(ths, tre), clocks)
    want = run_rounds(jre, JEngine(storage, mesh=None),
                      *rule_sets(ths, jre), clocks)
    assert_same_rounds(got, want)
    assert sum(len(r[3]) for r in want[0]) > 0, "no transition to compare"
    assert got[2].firing() == want[2].firing()
    assert got[2].transitions_emitted == want[2].transitions_emitted


def test_empty_round_and_bounded_catchup(route):
    """A round at the same step boundary evaluates nothing; a long stall
    evaluates only the last max_steps_per_round steps — in both."""
    storage, t = corpus()
    outs = []
    for re_mod, eng in ((tre, Engine(storage, device="cpu")),
                        (jre, JEngine(storage, mesh=None))):
        e = re_mod.RulesEngine(eng, lambda rows: None, step_ns=STEP,
                               max_steps_per_round=4)
        e.add_recording(re_mod.RecordingRule(b"x", RECORDS[0]))
        first = e.evaluate(int(t[100]))
        same = e.evaluate(int(t[100]) + STEP - 1)
        stall = e.evaluate(int(t[100]) + 100 * STEP)
        outs.append([(r.steps, r.exprs_evaluated, r.recorded_rows)
                     for r in (first, same, stall)])
    assert outs[0] == outs[1]
    assert outs[0][1] == (0, 0, 0) and outs[0][2][0] == 4


def test_for_steps_needs_consecutive_steps(route):
    """A for_steps=3 rule fires on the third consecutive step above its
    threshold and resolves on the first step below, in both packages."""
    storage, t = corpus()
    ths = thresholds_for(storage, t, k=3)
    outs = []
    for re_mod, eng in ((tre, Engine(storage, device="cpu")),
                        (jre, JEngine(storage, mesh=None))):
        e = re_mod.RulesEngine(eng, lambda rows: None, step_ns=STEP)
        for i, th in enumerate(ths):
            e.add_alert(re_mod.AlertRule(b"s%d" % i, AVG, ">", th,
                                         for_steps=3))
        trans = []
        for k in range(6):
            trans += e.evaluate(int(t[60]) + k * 2 * STEP).transitions
        outs.append(sorted((x.rule, x.series, x.kind, x.time_nanos)
                           for x in trans))
    assert outs[0] == outs[1] and outs[0]


class _StubEngine:
    """An engine whose every query answers one fixed f64 block (the
    compare split needs values no f32 route would keep)."""

    def __init__(self, block, device="cpu"):
        self.block = block
        self.device = device

    def execute_range(self, query, start, end, step):
        return self.block


def _fixed_block(block_mod, model_mod, n, k, value, start):
    tags = [model_mod.Tags.of({b"__name__": b"g", b"i": b"%d" % i})
            for i in range(n)]
    return block_mod.Block(block_mod.BlockMeta(start, STEP, k), tags,
                           np.full((n, k), value, np.float64))


@pytest.mark.parametrize("shape,fires", [((2, 2), True), ((100, 50), False)])
def test_compare_split_at_4096_cells(shape, fires):
    """1.0 + 2**-30 > 1.0: exact in f64 (fires), 1.0 > 1.0 in f32 (does
    not); [2, 2] x 1 rule is 4 cells (host f64), [100, 50] x 1 is 5,000
    (device f32). Both packages agree on each side of the split."""
    n, k = shape
    v = 1.0 + 2.0 ** -30
    start = 1_700_000_000 * S
    got = []
    for re_mod, blk in ((tre, _fixed_block(tblock, tmodel, n, k, v, start)),
                        (jre, _fixed_block(jblock, jmodel, n, k, v, start))):
        e = re_mod.RulesEngine(_StubEngine(blk), lambda rows: None,
                               step_ns=STEP)
        e.add_alert(re_mod.AlertRule(b"a", "g", ">", 1.0))
        got.append(len(e.evaluate(start).transitions))
        cmp = re_mod._compile_compare(">", "cpu") if re_mod is tre \
            else re_mod._compile_compare(">")
        cond = cmp(np.full((n, k), v), np.array([1.0]))
        assert bool(cond.all()) is fires and cond.shape == (1, n, k)
    assert got[0] == got[1] == (n if fires else 0)


def test_compare_treats_nan_as_missing():
    """A NaN step satisfies no comparison, on both sides of the split."""
    for n in (2, 100):
        vals = np.full((n, 50), 5.0)
        vals[:, ::2] = np.nan
        for op in (">", "<", "!=", "=="):
            got = tre._compile_compare(op, "cpu")(vals, np.array([1.0, 5.0]))
            want = jre._compile_compare(op)(vals, np.array([1.0, 5.0]))
            assert np.array_equal(got, want), (n, op)
            assert not got[:, :, ::2].any()
