"""The port's whole-plan compiled route (m3_tpu_torch/query/plan.py ->
m3_tpu_torch/parallel/compile.py) on the CPU, the port of
tests/test_plan_compile.py (its mesh class is in
tests/test_torch_mesh_routes.py): the same seeded
`make_storage` corpus (86 compiled and 20 fallback queries) and the same
`_tol` bounds (rtol 2e-5 with atol max(1e-8, 1e-6 max|ref|); deriv rtol
1e-3, atol 1e-4; predict_linear and holt_winters rtol 2e-3, atol 1e-2;
`rate(rate` rtol 2e-3, atol 1e-5).

The port's Engine(device="cpu").execute_range is held against
- the port's own interpreter (execute_range_ref) on all 10 seeds;
- the reference's compiled route (m3_tpu.query.Engine(mesh=None)
  .execute_range; mesh=None: the conftest forces eight CPU devices) on 3
  seeds, with the same typed route and fallback reason for every query;
- on the 16 seeded counter grids, the port's interpreter and the
  reference's interpreter, bit for bit, for sum/avg over raw counters
  (the exact f64 baseline finish).

A fallback query is an interpreter evaluation in both packages, and it
is held to the port's own interpreter and to the reference's under the
same `_tol`. Two of them, `rate` and `increase` over packed-grid
subqueries of 2e9 counters, open windows on a counter reset whose f32 sum
cancels 1e9-sized adjustments: the port's `_wsum` adds each window left
to right from 0.0 as the reference's `reduce_window` does, so both round
alike (`tests/test_torch_temporal.py::test_wsum_bit_equal_to_reference`)."""

import numpy as np
import pytest

from m3_tpu.query import Engine as JEngine
from m3_tpu.query import plan as jplan
from m3_tpu_torch.parallel import compile as pcompile
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.query import plan as qplan
from m3_tpu_torch.query.executor import Engine, QueryError
from m3_tpu_torch.testing import faultcomp
from m3_tpu_torch.utils.instrument import ROOT
from test_plan_compile import (COMPILED_QUERIES, END, FALLBACK_QUERIES, NPTS,
                               RES, START, STEP, T0, MemStorage, _tol,
                               make_storage)

S = 1_000_000_000


def assert_matches(got, ref, query, exact=False, **tol_override):
    """Same series set, values within the query's bounds (or bit-equal)."""
    gtags = [bytes(t.id()) for t in got.series_tags]
    rtags = [bytes(t.id()) for t in ref.series_tags]
    assert sorted(gtags) == sorted(rtags), \
        f"{query}: series set diverged ({len(gtags)} vs {len(rtags)})"
    order = {k: i for i, k in enumerate(rtags)}
    g = np.asarray(got.values)
    r = np.asarray(ref.values)[[order[k] for k in gtags]]
    if exact:
        assert np.array_equal(g, r, equal_nan=True), (
            f"{query}: not bit-equal (max abs diff "
            f"{np.nanmax(np.abs(g - r))})")
        return
    tol = tol_override or _tol(query, r)
    np.testing.assert_allclose(g, r, equal_nan=True, err_msg=query, **tol)


def executed():
    return ROOT.snapshot().get("query.plan.executed", 0)


@pytest.fixture
def no_floor(monkeypatch):
    """Route every corpus query through the compiled path regardless of
    size (the floor itself is covered by TestFallback), in both
    packages."""
    monkeypatch.setattr(qplan, "PLAN_MIN_CELLS", 1)
    monkeypatch.setattr(jplan, "PLAN_MIN_CELLS", 1)


def counter_storage(seed):
    """tests/test_plan_compile.py's TestCounterSumExactness grid: 32
    counters at 1e9-1e12 over 5 hosts, every fourth gappy."""
    rng = np.random.default_rng(7000 + seed)
    st = MemStorage()
    t = T0 + np.arange(NPTS, dtype=np.int64) * RES
    for i in range(32):
        base = float(rng.choice([1e9, 3e10, 1e12])) * (1 + i % 4)
        v = base + np.cumsum(rng.poisson(50.0, NPTS)).astype(np.float64)
        tt = t
        if i % 4 == 0:
            keep = rng.random(NPTS) > 0.3
            keep[0] = True
            tt, v = t[keep], v[keep]
        st.add({b"__name__": b"m", b"host": b"h%d" % (i % 5),
                b"i": str(i).encode()}, tt, v)
    return st


class TestCompiledVsOracle:
    """10 seeded storages x 106 queries: the compiled route against the
    port's interpreter, identical series sets and values within bounds;
    every compiled query counted, no fallback query compiled."""

    @pytest.mark.parametrize("seed", range(10))
    def test_seeded_corpus(self, seed, no_floor):
        eng = Engine(make_storage(seed), device="cpu")
        before = executed()
        for q in COMPILED_QUERIES:
            got = eng.execute_range(q, START, END, STEP)
            assert eng.last_route()["route"] == "compiled", q
            ref = eng.execute_range_ref(q, START, END, STEP)
            assert_matches(got, ref, q)
        assert executed() - before == len(COMPILED_QUERIES), \
            "a corpus query silently fell back to the interpreter"
        for q in FALLBACK_QUERIES:
            got = eng.execute_range(q, START, END, STEP)
            ref = eng.execute_range_ref(q, START, END, STEP)
            assert_matches(got, ref, q)
        assert executed() - before == len(COMPILED_QUERIES), \
            "a fallback query took the compiled route"


class TestCompiledVsReference:
    """The port's compiled route against the reference's, with the same
    route and typed fallback reason and values within `_tol` for every
    query, the fallback queries' interpreter answers included."""

    @pytest.mark.parametrize("seed", range(3))
    def test_seeded_corpus_against_reference(self, seed, no_floor):
        st = make_storage(seed)
        eng, ref = Engine(st, device="cpu"), JEngine(st, mesh=None)
        for q in COMPILED_QUERIES + FALLBACK_QUERIES:
            got = eng.execute_range(q, START, END, STEP)
            want = ref.execute_range(q, START, END, STEP)
            mine, theirs = eng.last_route(), ref.last_route()
            assert (mine["route"], mine["fallback_reason"]) == (
                theirs["route"], theirs["fallback_reason"]), q
            assert_matches(got, want, q)


class TestCounterSumExactness:
    """The interpreter's f64 host-reduce contract: a compiled sum/avg
    over raw counters decomposes into f32 residuals (exact integers here)
    + f64 baseline mass, so the result is BIT-EQUAL to the port's
    interpreter and to the reference's, even at 1e12 magnitudes."""

    @pytest.mark.parametrize("seed", range(16))
    def test_exact_over_seeded_counter_grids(self, seed, no_floor):
        st = counter_storage(seed)
        eng, ref = Engine(st, device="cpu"), JEngine(st, mesh=None)
        before = executed()
        for q in ("sum(m)", "sum by (host) (m)", "avg(m)"):
            got = eng.execute_range(q, START, END, STEP)
            assert_matches(got, eng.execute_range_ref(q, START, END, STEP),
                           f"{q} seed {seed} (port interpreter)", exact=True)
            assert_matches(got, ref.execute_range_ref(q, START, END, STEP),
                           f"{q} seed {seed} (reference interpreter)",
                           exact=True)
        assert executed() - before == 3


class TestPlanCache:
    def test_structure_hit_across_metrics_and_thresholds(self, no_floor):
        # A unique plan STRUCTURE (so the first run must miss): the chain
        # below appears nowhere else in the port's tests.
        e1 = Engine(make_storage(101), device="cpu")
        e2 = Engine(make_storage(102), device="cpu")
        q1 = "floor(clamp_min(sqrt(abs(delta(m[7m]))), 123.5))"
        before = ROOT.snapshot()
        e1.execute_range(q1, START, END, STEP).values
        mid = ROOT.snapshot()
        assert mid.get("telemetry.plan_cache.misses", 0) \
            - before.get("telemetry.plan_cache.misses", 0) == 1
        # Same structure: different storage content, different scalar
        # threshold — both served by the SAME cached executable.
        q2 = "floor(clamp_min(sqrt(abs(delta(m[7m]))), 567.25))"
        b2 = e2.execute_range(q2, START, END, STEP)
        b2.values
        after = ROOT.snapshot()
        assert after.get("telemetry.plan_cache.misses", 0) \
            - mid.get("telemetry.plan_cache.misses", 0) == 0
        assert after.get("telemetry.plan_cache.hits", 0) \
            - mid.get("telemetry.plan_cache.hits", 0) == 1
        assert_matches(b2, e2.execute_range_ref(q2, START, END, STEP), q2)

    def test_build_wall_recorded(self, no_floor):
        eng = Engine(make_storage(103), device="cpu")
        before = ROOT.snapshot()
        eng.execute_range("clamp_max(changes(m[11m]), 0.5)", START, END,
                          STEP).values
        after = ROOT.snapshot()
        assert after.get("telemetry.plan_cache.misses", 0) \
            == before.get("telemetry.plan_cache.misses", 0) + 1
        for hist in ("telemetry.plan_cache.compile_s",
                     "telemetry.build.build_s"):
            assert after[hist]["count"] \
                == before.get(hist, {}).get("count", 0) + 1, hist

    def test_cpu_executables_charge_nothing(self, no_floor):
        Engine(make_storage(104), device="cpu").execute_range(
            "rate(m[5m])", START, END, STEP).values
        cached = pcompile.executables()
        assert cached and all(e.charged == 0 and e.graph is None
                              for _, e in cached)
        assert all(label.endswith(":cpu") for label, _ in cached)


class TestFallback:
    def test_below_floor_stays_on_interpreter(self):
        # Default floor (4096 cells): this 2-series query is far below.
        eng = Engine(make_storage(104, n_m=2, n_b=0), device="cpu")
        before = ROOT.snapshot()
        got = eng.execute_range("sum(rate(m[5m]))", START, END, STEP)
        after = ROOT.snapshot()
        assert after.get("query.plan.executed", 0) == \
            before.get("query.plan.executed", 0)
        assert after.get("query.plan.below_floor", 0) == \
            before.get("query.plan.below_floor", 0) + 1
        assert eng.last_route()["fallback_reason"] == "below-floor"
        ref = eng.execute_range_ref("sum(rate(m[5m]))", START, END, STEP)
        assert_matches(got, ref, "sum(rate(m[5m]))")

    def test_default_floor_compiles_dashboard_sized_queries(self):
        """120 series x a 39-cell window grid (30 steps, W 10) clear the
        4,096-cell floor."""
        eng = Engine(make_storage(109, n_m=120), device="cpu")
        got = eng.execute_range("sum by (host) (rate(m[5m]))", START, END,
                                STEP)
        assert eng.last_route()["route"] == "compiled"
        assert_matches(got, eng.execute_range_ref(
            "sum by (host) (rate(m[5m]))", START, END, STEP), "sum by")

    def test_non_lowerable_query_never_binds(self, no_floor):
        eng = Engine(make_storage(105), device="cpu")
        before = executed()
        fetches = ROOT.snapshot().get("query.grid_cache.miss", 0)
        got = eng.execute_range("sum(topk(2, m))", START, END, STEP)
        assert executed() == before
        # One interpreter fetch, no bind fetch before it.
        assert ROOT.snapshot().get("query.grid_cache.miss", 0) \
            - fetches == 1
        ref = eng.execute_range_ref("sum(topk(2, m))", START, END, STEP)
        assert_matches(got, ref, "sum(topk(2, m))")

    def test_fallback_reuses_the_bound_selectors(self, monkeypatch):
        """A below-floor fallback evaluates over the blocks bind fetched
        (the one-query selector overlay): storage is read once."""
        st = make_storage(110, n_m=2, n_b=0)
        calls = []
        real = st.fetch_raw
        monkeypatch.setattr(st, "fetch_raw",
                            lambda *a: calls.append(a) or real(*a))
        Engine(st, device="cpu").execute_range("sum(rate(m[5m]))", START,
                                               END, STEP)
        assert len(calls) == 1

    def test_backend_gap_takes_the_interpreter(self, monkeypatch, no_floor):
        def gap(bound, device, mesh=None):
            raise pcompile.PlanFallback("no such shape")

        monkeypatch.setattr(pcompile, "execute", gap)
        eng = Engine(make_storage(111), device="cpu")
        before = ROOT.snapshot()
        got = eng.execute_range("rate(m[5m])", START, END, STEP)
        after = ROOT.snapshot()
        assert eng.last_route()["fallback_reason"] == "backend-gap"
        key = ("telemetry.plan_fallback.count"
               "{reason=backend-gap,scope=runtime}")
        assert after.get(key, 0) - before.get(key, 0) == 1
        assert after.get("query.plan.fallback", 0) \
            - before.get("query.plan.fallback", 0) == 1
        assert_matches(got, eng.execute_range_ref("rate(m[5m])", START, END,
                                                  STEP), "rate(m[5m])")

    def test_route_tagged_on_query_span(self, no_floor):
        from m3_tpu_torch.utils import tracing

        eng = Engine(make_storage(106), device="cpu")
        with tracing.span("test_root") as sp:
            eng.execute_range("sum by (host) (rate(m[5m]))", START, END,
                              STEP).values
            eng.execute_range("sum(topk(2, m))", START, END, STEP)
        routes = [c.tags.get("route") for c in sp.children
                  if c.name == "query.execute_range"]
        assert routes == ["plan", "interpreter"]
        fb = [c.tags.get("plan_fallback") for c in sp.children
              if c.name == "query.execute_range"]
        assert fb[1] == "unsupported-agg"

    def test_matching_violation_raises_like_interpreter(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        for i in range(4):
            st.add({b"__name__": b"m", b"host": b"h", b"i": str(i).encode()},
                   t, np.full(NPTS, float(i)))
            st.add({b"__name__": b"b", b"host": b"h", b"i": str(i).encode()},
                   t, np.full(NPTS, 1.0))
        eng = Engine(st, device="cpu")
        # on(host) collapses the 'one' side to duplicate keys.
        with pytest.raises(QueryError):
            eng.execute_range("m * on(host) b", START, END, STEP)
        with pytest.raises(QueryError):
            eng.execute_range_ref("m * on(host) b", START, END, STEP)

    def test_execute_range_ref_records_disabled(self, no_floor):
        eng = Engine(make_storage(112), device="cpu")
        eng.execute_range_ref("rate(m[5m])", START, END, STEP)
        assert eng.last_route()["fallback_reason"] == "disabled"
        eng.execute_range("rate(m[5m])", START, END, STEP)
        assert eng.last_route() == {"route": "compiled",
                                    "fallback_reason": None,
                                    "fallback_detail": None}

    def test_instant_query_takes_the_plan_route(self, no_floor):
        eng = Engine(make_storage(113), device="cpu")
        at = START + 40 * RES
        got = eng.execute_instant("sum by (host) (rate(m[5m]))", at)
        assert eng.last_route()["route"] == "compiled"
        assert_matches(got, eng.execute_range_ref(
            "sum by (host) (rate(m[5m]))", at, at, S), "instant")


class TestGuard:
    """The whole program dispatches through the guard under the route
    `plan`, keyed by its shape bucket: an injected fault raises typed
    (never the interpreter), quarantines the bucket, and the bucket then
    raises at once, without a rebuild, until guard.reset()."""

    def test_fault_raises_typed_and_quarantines_the_bucket(self, no_floor):
        eng = Engine(make_storage(114), device="cpu")
        q = "max_over_time(m[3m])"
        guard.reset()
        try:
            with faultcomp.injected(faultcomp.ComputeFaultPlan(
                    seed=3, dispatch_raise=1.0, route_filter="plan")) as seam:
                mark = seam.mark()
                with pytest.raises(guard.KernelFault):
                    eng.execute_range(q, START, END, STEP)
                assert guard.quarantined_keys("plan")
                before = ROOT.snapshot()
                with pytest.raises(guard.KernelFault, match="quarantined"):
                    eng.execute_range(q, START, END, STEP)
                after = ROOT.snapshot()
                # The quarantine answered before the seam or a rebuild.
                assert seam.since(mark) == {"plan": ["dispatch_raise"]}
                assert after.get("telemetry.plan_cache.misses", 0) == \
                    before.get("telemetry.plan_cache.misses", 0)
        finally:
            guard.reset()
        got = eng.execute_range(q, START, END, STEP)
        assert eng.last_route()["route"] == "compiled"
        assert_matches(got, eng.execute_range_ref(q, START, END, STEP), q)


class TestLazyMaterialization:
    def test_series_root_shape_and_f32_plane(self, no_floor):
        eng = Engine(make_storage(108), device="cpu")
        blk = eng.execute_range("rate(m[5m])", START, END, STEP)
        vals = blk.values
        assert vals.shape == (len(blk.series_tags), blk.meta.steps)
        assert vals.dtype == np.float32
        ref = eng.execute_range_ref("rate(m[5m])", START, END, STEP)
        assert_matches(blk, ref, "rate(m[5m])")

    @pytest.mark.parametrize("q", ["sum(m)", "avg by (host) (m)",
                                   "sum(rate(m[5m]))"])
    def test_sum_avg_roots_finish_in_f64(self, q, no_floor):
        eng = Engine(make_storage(115), device="cpu")
        blk = eng.execute_range(q, START, END, STEP)
        assert blk.values.dtype == np.float64
        assert blk.values.shape == (len(blk.series_tags), blk.meta.steps)

    def test_two_live_lazy_blocks_read_in_reverse(self, no_floor):
        """Two queries of one plan shape, read last-first: each keeps its
        own answer."""
        eng = Engine(make_storage(116), device="cpu")
        a = eng.execute_range("rate(m[5m])", START, END, STEP)
        b = eng.execute_range("rate(b[5m])", START, END, STEP)
        vb, va = b.values, a.values
        assert_matches(b, eng.execute_range_ref("rate(b[5m])", START, END,
                                                STEP), "b")
        assert_matches(a, eng.execute_range_ref("rate(m[5m])", START, END,
                                                STEP), "a")
        assert va.shape != vb.shape


class TestRound16Lowerings:
    """Edge cases of the reference's round-16 lowerings against the
    port's interpreter: topk ties, group_left label-copy collisions,
    irate across gaps, quantile over all-NaN windows, absent_over_time of
    an empty selector, shared and packed subquery geometry."""

    def test_topk_ties_stable_order(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        for i in range(8):
            st.add({b"__name__": b"m", b"host": b"h", b"i": str(i).encode()},
                   t, np.full(NPTS, 7.0))  # all tied
        eng = Engine(st, device="cpu")
        got = eng.execute_range("topk(3, m)", START, END, STEP)
        ref = eng.execute_range_ref("topk(3, m)", START, END, STEP)
        assert_matches(got, ref, "topk(3, m) ties")
        assert got.n_series == 3  # first three rows win every step

    def test_bottomk_ties_with_nan_rows(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        for i in range(6):
            v = np.full(NPTS, float(i % 2))
            if i == 4:
                v = np.full(NPTS, np.nan)  # never sampled -> dropped
            st.add({b"__name__": b"m", b"host": b"h",
                    b"i": str(i).encode()}, t, v)
        eng = Engine(st, device="cpu")
        got = eng.execute_range("bottomk(2, m)", START, END, STEP)
        ref = eng.execute_range_ref("bottomk(2, m)", START, END, STEP)
        assert_matches(got, ref, "bottomk(2, m) ties+nan")

    def test_signed_zeros_in_min_max_topk_quantile(self, no_floor):
        """Rows of +0.0 and -0.0 in one group: min/max keep XLA's signed
        zero, the sorts treat both zeros as equal keys (stable), as the
        reference's compiled route does."""
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        for i in range(6):
            v = np.full(NPTS, -0.0 if i % 2 else 0.0)
            v[::7] = 1.0 + i
            st.add({b"__name__": b"m", b"host": b"h",
                    b"i": str(i).encode()}, t, v)
        eng, ref = Engine(st, device="cpu"), JEngine(st, mesh=None)
        for q in ("min(m)", "max(m)", "topk(2, m)", "bottomk(3, m)",
                  "quantile(0.5, m)", "quantile_over_time(0.5, m[2m])",
                  "min_over_time(m[2m])"):
            got = eng.execute_range(q, START, END, STEP)
            want = ref.execute_range(q, START, END, STEP)
            assert eng.last_route()["route"] == "compiled", q
            assert [x.id() for x in got.series_tags] == [
                x.id() for x in want.series_tags], q
            g, w = np.asarray(got.values), np.asarray(want.values)
            assert np.array_equal(g, w, equal_nan=True), q
            assert np.array_equal(np.signbit(g), np.signbit(w)), q

    def test_group_left_label_copy_collision(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        for i in range(4):
            st.add({b"__name__": b"m", b"host": b"h0",
                    b"i": str(i).encode()}, t, np.full(NPTS, 10.0 + i))
        st.add({b"__name__": b"c", b"host": b"h0"}, t, np.full(NPTS, 2.0))
        eng = Engine(st, device="cpu")
        q = "m * on(host) group_left(i) c"
        got = eng.execute_range(q, START, END, STEP)
        ref = eng.execute_range_ref(q, START, END, STEP)

        def rowset(blk):
            return sorted(
                (bytes(tags.id()), np.asarray(vals, np.float32).tobytes())
                for tags, vals in zip(blk.series_tags, blk.values))

        assert rowset(got) == rowset(ref)

    def test_irate_across_block_boundary_gaps(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        rng = np.random.default_rng(99)
        for i in range(12):
            keep = np.ones(NPTS, bool)
            keep[(np.arange(NPTS) // 7) % 2 == i % 2] = False
            keep[0] = True
            v = 1e9 + np.cumsum(rng.poisson(3.0, NPTS)).astype(np.float64)
            st.add({b"__name__": b"m", b"host": b"h",
                    b"i": str(i).encode()}, t[keep], v[keep])
        eng = Engine(st, device="cpu")
        for q in ("irate(m[2m])", "idelta(m[2m])"):
            got = eng.execute_range(q, START, END, STEP)
            ref = eng.execute_range_ref(q, START, END, STEP)
            assert_matches(got, ref, q)

    def test_quantile_over_time_nan_windows(self, no_floor):
        st = MemStorage()
        t = T0 + np.arange(NPTS, dtype=np.int64) * RES
        rng = np.random.default_rng(7)
        for i in range(10):
            keep = rng.random(NPTS) > 0.6  # sparse: many empty windows
            keep[0] = True
            st.add({b"__name__": b"m", b"host": b"h",
                    b"i": str(i).encode()},
                   t[keep], rng.normal(50.0, 10.0, int(keep.sum())))
        eng = Engine(st, device="cpu")
        for q in ("quantile_over_time(0, m[2m])",
                  "quantile_over_time(1, m[2m])",
                  "quantile_over_time(0.37, m[2m])"):
            got = eng.execute_range(q, START, END, STEP)
            ref = eng.execute_range_ref(q, START, END, STEP)
            assert_matches(got, ref, q)

    def test_absent_over_time_empty_selector(self):
        eng = Engine(make_storage(120, n_m=2, n_b=0, n_c=0), device="cpu")
        q = "absent_over_time(nosuch[5m])"
        got = eng.execute_range(q, START, END, STEP)
        ref = eng.execute_range_ref(q, START, END, STEP)
        assert_matches(got, ref, q)

    def test_subquery_shared_vs_packed_geometry(self, no_floor):
        eng = Engine(make_storage(121), device="cpu")
        q = "max_over_time(rate(m[5m])[10m:1m])"
        for step in (60 * S, 30 * S, 45 * S):
            got = eng.execute_range(q, START, END, step)
            assert eng.last_route()["route"] == "compiled"
            ref = eng.execute_range_ref(q, START, END, step)
            assert_matches(got, ref, f"{q} @step={step}")


class TestExplainCorpus:
    """EXPLAIN over the corpus: compiled queries render compiled on
    every node, fallback queries report the EXACT typed reason the
    lowering raised, and the output is stable."""

    def _explain(self, q):
        from m3_tpu_torch.query import explain as qexplain
        from m3_tpu_torch.query import promql
        from m3_tpu_torch.query.executor import (DEFAULT_LOOKBACK_NS,
                                                 QueryParams)

        return qexplain.explain(promql.parse(q),
                                QueryParams(START, END, STEP),
                                DEFAULT_LOOKBACK_NS, query=q)

    def test_compiled_queries_every_node_compiled(self):
        from m3_tpu_torch.query import explain as qexplain

        for q in COMPILED_QUERIES:
            out = self._explain(q)
            assert out["route"] == "compiled", q
            assert out["fallback_reason"] is None, q
            for n in qexplain.walk(out["root"]):
                assert n["route"] == "compiled", (q, n)
                assert n["sharding"] in (qplan.SHARDED, qplan.REPLICATED)
                assert n["kind"] in (qplan.SERIES, qplan.SCALAR)
            assert out == self._explain(q), f"{q}: output not stable"

    def test_fallback_queries_report_exact_lowering_reason(self):
        from m3_tpu_torch.query import explain as qexplain
        from m3_tpu_torch.query import promql
        from m3_tpu_torch.query.executor import (DEFAULT_LOOKBACK_NS,
                                                 QueryParams)

        params = QueryParams(START, END, STEP)
        for q in FALLBACK_QUERIES:
            out = self._explain(q)
            assert out["route"] == "interpreter", q
            _, err, _ = qplan.lower_and_collect(
                promql.parse(q), params, DEFAULT_LOOKBACK_NS)
            assert out["fallback_reason"] == err.reason.value, q
            nodes = list(qexplain.walk(out["root"]))
            assert all(n["route"] == "interpreter" for n in nodes), q
            culprits = [n for n in nodes if n.get("reason")]
            assert culprits and culprits[0]["reason"] == err.reason.value, q
