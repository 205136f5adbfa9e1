"""The port's query observatory on the CPU, the non-HTTP classes of
tests/test_explain.py against m3_tpu_torch (the HTTP surfaces wait for
the port's coordinator): the typed fallback taxonomy (every
`NotCompilable` raise site in the port's query/plan.py names a
catalogued `FallbackReason`; reason- and scope-tagged
`telemetry.plan_fallback` counters), the EXPLAIN tree (equal to the
reference's dict for every query), the slow-query ring's route fields,
ANALYZE stages, the corpus normalizer (equal to the reference's) and the
corpus recorder; then the plan-site cases of
tests/test_numerics_witness.py against the port's utils/numwatch.py,
with the compiled route's observation point driven through the port's
Engine."""

import ast as pyast
import inspect
import json
import os
import pathlib

import numpy as np
import pytest

from m3_tpu.analysis import numeric_rules
from m3_tpu.query import corpus as jcorpus
from m3_tpu.query import explain as jexplain
from m3_tpu.query import promql as jpromql
from m3_tpu.query.executor import QueryParams as JQueryParams
from m3_tpu_torch.query import corpus as qcorpus
from m3_tpu_torch.query import explain as qexplain
from m3_tpu_torch.query import plan as qplan
from m3_tpu_torch.query import promql
from m3_tpu_torch.query.executor import (DEFAULT_LOOKBACK_NS, Engine,
                                         QueryParams)
from m3_tpu_torch.query.plan import FallbackReason
from m3_tpu_torch.utils import numwatch
from m3_tpu_torch.utils.instrument import ROOT
from m3_tpu_torch.utils.tracing import SLOW_QUERIES
from test_explain import END, START, STEP, MemStorage
from test_plan_compile import COMPILED_QUERIES, FALLBACK_QUERIES

S = 1_000_000_000
PARAMS = QueryParams(START, END, STEP)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def no_floor(monkeypatch):
    monkeypatch.setattr(qplan, "PLAN_MIN_CELLS", 1)


def engine():
    return Engine(MemStorage(), device="cpu")


def _explain(q):
    return qexplain.explain(promql.parse(q), PARAMS, DEFAULT_LOOKBACK_NS,
                            query=q)


# ------------------------------------------------------- fallback taxonomy


class TestFallbackTaxonomy:
    def test_every_raise_site_uses_catalogued_reason(self):
        """No free-form NotCompilable strings: every construction in the
        port's query/plan.py passes a FallbackReason attribute first."""
        tree = pyast.parse(inspect.getsource(qplan))
        checked = 0
        for node in pyast.walk(tree):
            if not (isinstance(node, pyast.Call)
                    and isinstance(node.func, pyast.Name)
                    and node.func.id == "NotCompilable"):
                continue
            assert node.args, "NotCompilable() constructed with no reason"
            first = node.args[0]
            assert isinstance(first, pyast.Attribute) and \
                isinstance(first.value, pyast.Name) and \
                first.value.id == "FallbackReason", (
                    f"line {node.lineno}: NotCompilable first arg is not "
                    "a FallbackReason attribute")
            assert first.attr in FallbackReason.__members__, (
                f"line {node.lineno}: unknown reason {first.attr}")
            checked += 1
        assert checked >= 12, f"only {checked} sites scanned"

    def test_reason_values_are_the_references(self):
        from m3_tpu.query.plan import FallbackReason as JReason

        assert {r.value for r in FallbackReason} == {r.value for r in JReason}
        assert qplan.RUNTIME_REASONS == __import__(
            "m3_tpu.query.plan", fromlist=["x"]).RUNTIME_REASONS

    def test_reasons_match_expected_per_query(self):
        expected = {
            "sum(topk(3, m))": FallbackReason.UNSUPPORTED_AGG,
            'count_values("v", m)': FallbackReason.UNSUPPORTED_AGG,
            "absent(m)": FallbackReason.UNSUPPORTED_FUNC,
            "sort(m)": FallbackReason.UNSUPPORTED_FUNC,
            "absent_over_time(m[10m:1m])": FallbackReason.UNSUPPORTED_FUNC,
            "irate(abs(m)[10m:1m])": FallbackReason.F64_ARITH,
            "m and b": FallbackReason.SET_OP,
            "m % 7": FallbackReason.F64_ARITH,
            "m > 2e9": FallbackReason.ABS_COMPARISON,
            "timestamp(m) > 2e9": FallbackReason.ABS_COMPARISON,
            "m[5m]": FallbackReason.MATRIX_SELECTOR,
            "m @ 100": FallbackReason.AT_MODIFIER,
            "2 + 2": FallbackReason.SCALAR_ONLY,
            "clamp_min(m, scalar(b))": FallbackReason.NON_CONSTANT_PARAM,
        }
        for q, want in expected.items():
            plan, err, _ = qplan.lower_and_collect(
                promql.parse(q), PARAMS, DEFAULT_LOOKBACK_NS)
            assert plan is None, q
            assert err.reason is want, f"{q}: {err.reason} != {want}"

    def test_telemetry_counts_reason_and_scope_tagged(self, no_floor):
        eng = engine()
        before = ROOT.snapshot()
        eng.execute_range("sum(topk(3, m))", START, END, STEP)
        after = ROOT.snapshot()
        key = ("telemetry.plan_fallback.count"
               "{reason=unsupported-agg,scope=structural}")
        assert after.get(key, 0) - before.get(key, 0) == 1
        assert after.get("telemetry.plan_fallback.total", 0) \
            - before.get("telemetry.plan_fallback.total", 0) == 1

    def test_below_floor_counted(self):
        eng = Engine(MemStorage(n=2), device="cpu")
        before = ROOT.snapshot()
        eng.execute_range("sum(rate(m[5m]))", START, END, STEP).values
        after = ROOT.snapshot()
        key = ("telemetry.plan_fallback.count"
               "{reason=below-floor,scope=runtime}")
        assert after.get(key, 0) - before.get(key, 0) == 1
        assert eng.last_route()["fallback_reason"] == "below-floor"
        assert qplan.fallback_scope("below-floor") == "runtime"
        assert qplan.fallback_scope("unsupported-agg") == "structural"

    def test_plan_fallback_exception_carries_backend_gap(self):
        from m3_tpu_torch.parallel.compile import PlanFallback

        e = PlanFallback("weird shape")
        assert e.reason is FallbackReason.BACKEND_GAP
        assert "backend-gap" in str(e)


# ----------------------------------------------------------------- EXPLAIN


class TestExplainTree:
    @pytest.mark.parametrize("q", COMPILED_QUERIES + FALLBACK_QUERIES + [
        "m[5m]", "m @ 100", "2 + 2", "clamp_min(m, scalar(b))",
        "sum by (host) (rate(m{host=\"h1\"}[5m] offset 5m))"])
    def test_tree_equals_the_references(self, q):
        """The port's EXPLAIN dict, tree and all, is the reference's."""
        jparams = JQueryParams(START, END, STEP)
        want = jexplain.explain(jpromql.parse(q), jparams,
                                DEFAULT_LOOKBACK_NS, query=q)
        assert _explain(q) == want

    def test_compiled_tree_nodes_and_sharding(self):
        out = _explain("sum by (host) (rate(m[5m]))")
        assert out["route"] == "compiled"
        assert out["fallback_reason"] is None
        assert out["mesh_ok"] is True
        nodes = list(qexplain.walk(out["root"]))
        assert [n["node"] for n in nodes] == ["Aggregate", "RangeFunc",
                                              "Fetch"]
        assert all(n["route"] == "compiled" for n in nodes)
        assert nodes[0]["sharding"] == qplan.REPLICATED
        assert nodes[2]["sharding"] == qplan.SHARDED
        assert nodes[2]["kind"] == qplan.SERIES

    def test_vv_match_not_mesh_ok(self):
        out = _explain("m * on(host, i) b")
        assert out["route"] == "compiled"
        assert out["mesh_ok"] is False

    def test_fallback_tree_pins_reason_on_raising_node(self):
        out = _explain("sum(topk(3, m))")
        assert out["route"] == "interpreter"
        assert out["fallback_reason"] == "unsupported-agg"
        nodes = list(qexplain.walk(out["root"]))
        assert all(n["route"] == "interpreter" for n in nodes)
        culprits = [n for n in nodes if "reason" in n]
        assert len(culprits) == 1
        assert culprits[0]["node"] == "Aggregation"
        assert culprits[0]["detail"] == "topk"
        assert culprits[0]["reason"] == "unsupported-agg"


# ---------------------------------------------------------------- slow ring


class TestSlowRingRoute:
    def test_slow_interpreted_query_records_fallback_reason(
            self, monkeypatch, no_floor):
        monkeypatch.setattr(SLOW_QUERIES, "threshold_ns", 0)
        SLOW_QUERIES.clear()
        engine().execute_range("sum(topk(3, m))", START, END, STEP)
        entries = [e for e in SLOW_QUERIES.entries()
                   if e["name"] == "sum(topk(3, m))"]
        assert entries, "slow entry missing"
        assert entries[-1]["route"] == "interpreter"
        assert entries[-1]["plan_fallback"] == "unsupported-agg"

    def test_compiled_entry_has_route_no_fallback(self, monkeypatch,
                                                  no_floor):
        monkeypatch.setattr(SLOW_QUERIES, "threshold_ns", 0)
        SLOW_QUERIES.clear()
        engine().execute_range("sum by (host) (rate(m[5m]))", START, END,
                               STEP).values
        entries = [e for e in SLOW_QUERIES.entries()
                   if e["name"] == "sum by (host) (rate(m[5m]))"]
        assert entries[-1]["route"] == "compiled"
        assert "plan_fallback" not in entries[-1]


# ----------------------------------------------------------------- ANALYZE


class TestAnalyze:
    def test_plan_route_stages(self, no_floor):
        eng = engine()
        with qexplain.analyzing() as actx:
            eng.execute_range("sum by (host) (rate(m[5m]))", START, END,
                              STEP).values
        d = actx.to_dict()
        assert "bind" in d["stages_ms"]
        dev = [k for k in d["stages_ms"] if k.startswith("device_program[")]
        assert dev, d["stages_ms"]
        assert "result_materialize" in d["stages_ms"]
        assert d["events"].get("d2h_bytes", 0) > 0
        assert d["events"].get("grid_cache_miss", 0) \
            + d["events"].get("grid_cache_hit", 0) >= 1

    def test_miss_stage_is_named_compile(self, no_floor):
        eng = engine()
        with qexplain.analyzing() as actx:
            eng.execute_range("clamp_max(resets(m[13m]), 2)", START, END,
                              STEP).values
        d = actx.to_dict()
        assert any(k.endswith("+compile") for k in d["stages_ms"]), d
        assert d["events"].get("plan_cache_miss") == 1

    def test_interpreter_route_stage(self, no_floor):
        with qexplain.analyzing() as actx:
            engine().execute_range("sum(topk(3, m))", START, END, STEP)
        assert "interpreter_eval" in actx.to_dict()["stages_ms"]

    def test_disabled_is_inert(self, no_floor):
        assert qexplain.current() is None
        engine().execute_range("sum(m)", START, END, STEP).values
        assert qexplain.current() is None

    def test_context_restores_previous(self):
        with qexplain.analyzing() as outer:
            with qexplain.analyzing() as inner:
                assert qexplain.current() is inner
            assert qexplain.current() is outer
        assert qexplain.current() is None


# ------------------------------------------------------------------ corpus


class TestCorpusNormalize:
    @pytest.mark.parametrize("q", COMPILED_QUERIES + FALLBACK_QUERIES + [
        'sum by (host) (rate(http_req{job="secret-app",inst=~"prod-.*"}'
        '[5m])) > 99.5', "histogram_quantile(0.9, m)",
        "sum(m offset 5m)", 'rate(m{host="h1"}[7m])', "m @ end()",
        "(m) > (1)", "topk (1, m)", 'label_replace(m, "a", "$1", "b", "c")'])
    def test_normalize_equals_the_references(self, q):
        assert qcorpus.normalize(q) == jcorpus.normalize(q)

    def test_label_values_and_literals_stripped(self):
        shape = qcorpus.normalize(
            'sum by (host) (rate(http_req{job="secret-app",'
            'inst=~"prod-.*"}[5m])) > 99.5')
        assert "secret-app" not in shape and "prod-" not in shape
        assert "99.5" not in shape
        assert "job=" in shape and "inst=~" in shape
        assert "[300s]" in shape

    def test_normalized_shape_preserves_route(self):
        for q in ("sum by (host) (rate(m[5m]))", "topk(3, m)",
                  "max_over_time(rate(m[5m])[10m:1m])", "m > 2e9",
                  "m and b", 'rate(m{host="h1"}[7m])', "clamp(m, 10, 60)",
                  "m * on(host, i) b", "histogram_quantile(0.9, m)",
                  "sum(m offset 5m)", "quantile_over_time(0.9, m[5m])"):
            shape = qcorpus.normalize(q)
            p1, e1, _ = qplan.lower_and_collect(
                promql.parse(q), PARAMS, DEFAULT_LOOKBACK_NS)
            p2, e2, _ = qplan.lower_and_collect(
                promql.parse(shape), PARAMS, DEFAULT_LOOKBACK_NS)
            assert (p1 is None) == (p2 is None), (q, shape)
            if p1 is None:
                assert e1.reason is e2.reason, (q, shape)

    def test_normalize_idempotent(self):
        for q in ("sum by (host) (rate(m[5m]))", "(m) > (1)",
                  "topk (1, m)"):
            once = qcorpus.normalize(q)
            assert qcorpus.normalize(once) == once


class TestCorpusRecorder:
    def test_bounded_and_counts(self, tmp_path):
        path = str(tmp_path / "corpus.jsonl")
        rec = qcorpus.CorpusRecorder(path, sample=1.0, max_records=3)
        for i in range(5):
            rec.record("sum(m)", route="compiled", series=i)
        assert rec.written == 3 and rec.dropped == 2
        assert len(qcorpus.read_corpus(path)) == 3
        rec2 = qcorpus.CorpusRecorder(path, sample=1.0, max_records=3)
        assert rec2.record("sum(m)") is False
        assert rec2.dropped == 1

    def test_sample_zero_records_nothing(self, tmp_path):
        path = str(tmp_path / "c.jsonl")
        rec = qcorpus.CorpusRecorder(path, sample=0.0)
        assert rec.record("sum(m)") is False
        assert not os.path.exists(path)

    def test_unparseable_query_counts_error_not_raise(self, tmp_path):
        rec = qcorpus.CorpusRecorder(str(tmp_path / "c.jsonl"), sample=1.0)
        assert rec.record("sum(((") is False
        assert rec.errors == 1

    def test_executor_integration_and_coverage(self, tmp_path, no_floor):
        path = str(tmp_path / "corpus.jsonl")
        qcorpus.install(qcorpus.CorpusRecorder(path, sample=1.0))
        try:
            eng = engine()
            for q in ("sum by (host) (rate(m[5m]))", "sum(topk(3, m))",
                      "sum(m)", "m > 2e9", "sum by (host) (rate(m[5m]))"):
                eng.execute_range(q, START, END, STEP).values
        finally:
            qcorpus.install(None)
        records = qcorpus.read_corpus(path)
        assert len(records) == 5
        cov = qcorpus.coverage(records)
        assert cov["total"] == 5
        assert cov["compiled"] == 3
        assert cov["fallbacks"] == {"unsupported-agg": 1,
                                    "abs-comparison": 1}
        assert cov["structural_compiled"] == 3
        assert all(r["latency_ms"] >= 0 for r in records)
        assert any(r["series"] > 0 for r in records)
        assert cov == jcorpus.coverage(records)

    def test_env_opt_in(self, tmp_path, monkeypatch, no_floor):
        path = str(tmp_path / "env.jsonl")
        monkeypatch.setenv("M3_TPU_QUERY_CORPUS", path)
        monkeypatch.setenv("M3_TPU_CORPUS_SAMPLE", "1.0")
        monkeypatch.setattr(qcorpus, "_RECORDER", None)
        monkeypatch.setattr(qcorpus, "_RESOLVED", False)
        try:
            engine().execute_range("sum(m)", START, END, STEP).values
        finally:
            qcorpus.install(None)
        assert len(qcorpus.read_corpus(path)) == 1

    def test_maybe_record_materializes_lazy_result(self, tmp_path):
        import time as _time

        path = str(tmp_path / "lazy.jsonl")
        qcorpus.install(qcorpus.CorpusRecorder(path, sample=1.0))
        touched = {}

        class FakeLazy:
            series_tags = [object(), object()]

            @property
            def values(self):
                touched["materialized"] = True
                return np.zeros((2, 1))

        try:
            qcorpus.maybe_record("sum(m)", {"route": "compiled"},
                                 FakeLazy(), _time.perf_counter_ns(), 30 * S)
        finally:
            qcorpus.install(None)
        assert touched.get("materialized")
        recs = qcorpus.read_corpus(path)
        assert len(recs) == 1 and recs[0]["series"] == 2

    def test_corrupt_lines_skipped(self, tmp_path):
        path = str(tmp_path / "c.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps({"shape": "sum(m)", "route": "compiled"})
                    + "\n")
            f.write("{torn line\n")
        assert len(qcorpus.read_corpus(path)) == 1


# ------------------------------------------------- numerics witness: plan


@pytest.fixture
def witness():
    numwatch.install()
    numwatch.reset()
    yield numwatch
    numwatch.reset()
    numwatch.uninstall()


def kinds(w):
    return sorted((f["site"], f["kind"]) for f in w.findings())


class TestWitnessObserveResult:
    def test_masked_pad_passes(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert witness.findings() == []
        assert witness.observed_count() == 1

    def test_nan_in_live_lane_trips(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[2, 3] = np.nan
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "nan-live")]

    def test_inf_in_live_lane_trips(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[0, 0] = np.inf
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "inf-live")]

    def test_padding_lane_value_trips(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[6, 2] = 42.0
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "pad-finite")]

    def test_pad_row_pad_column_leak_trips(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[6, 14] = 42.0
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "pad-finite")]

    def test_column_padding_is_time_slack_not_a_finding(self, witness):
        plane = np.full((1, 16), np.nan)
        plane[0, :12] = 1.0
        plane[0, 14] = 1.0
        witness.observe_result("plan", plane, live_rows=1, live_cols=12)
        assert witness.findings() == []

    def test_tensor_planes_observed(self, witness):
        import torch

        plane = torch.full((4, 6), float("nan"))
        plane[:2, :4] = 1.0
        plane[3, 0] = 5.0
        witness.observe_result("plan", plane, live_rows=2, live_cols=4)
        witness.observe_result("plan", torch.tensor(3.0))
        assert kinds(witness) == [("plan", "pad-finite")]
        assert witness.observed_count() == 2

    def test_disabled_witness_is_free(self):
        numwatch.uninstall()
        numwatch.reset()
        numwatch.observe_result("plan", np.full((2, 2), np.inf))
        assert numwatch.findings() == []
        assert numwatch.observed_count() == 0

    def test_dump_round_trip(self, witness, tmp_path):
        plane = np.full((4, 4), np.nan)
        plane[:2, :] = 1.0
        plane[3, 0] = 5.0
        witness.observe_result("plan", plane, live_rows=2, live_cols=4)
        path = witness.dump_now(str(tmp_path / "numerics-1.json"))
        payload = json.loads(pathlib.Path(path).read_text())
        assert payload["observed"] == 1
        assert payload["findings"][0]["kind"] == "pad-finite"


class TestWitnessPlanHookEndToEnd:
    """The compiled plan's observation point through the port's Engine:
    padded planes of one query per padded-output family are observed,
    and every finding is inside the reference's statically accepted set
    (no padding-lane leak)."""

    def test_compiled_queries_witnessed_within_accepted(self, witness,
                                                        no_floor):
        from test_plan_compile import END as E, START as B, STEP as P
        from test_plan_compile import make_storage

        eng = Engine(make_storage(7), device="cpu")
        for q in ("sum by (host) (m)", "rate(m[5m])", "m * on(host, i) b",
                  "topk(2, m)", "quantile by (host) (0.5, m)",
                  "absent_over_time(m[5m])"):
            eng.execute_range(q, B, E, P)
            assert eng.last_route()["route"] == "compiled", q
        assert witness.observed_count() == 6
        accepted = numeric_rules.accepted_witness(str(REPO / "m3_tpu"))
        assert numwatch.unaccepted(witness.findings(), accepted) == []
        assert not [f for f in witness.findings()
                    if f["kind"] == "pad-finite"]
