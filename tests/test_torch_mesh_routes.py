"""The port's mesh routes on the CPU under `attach([cpu] * 8)`, each held
against the reference on its eight virtual devices (tests/conftest.py)
and against the port's own single-device route, on the same seeded
inputs. The mirrored reference cases:

  * tests/test_agg_mesh.py::test_mesh_flush_bit_identical_to_ref — the
    aggregator flush with its quantile ordering over the mesh, every sink
    row bit-equal to the reference oracle's;
  * tests/test_write_path.py::TestMeshFlushEncode — the seal's encode
    over the mesh, bit-equal to the single-device encode and to the
    reference's mesh encode;
  * tests/test_plan_compile.py::TestMeshVsSingleDevice — compiled plans
    over the mesh against one device and against the reference's engine
    on its eight devices, plus the whole corpus against the port's
    interpreter and the reference's mesh answers under the "compiled
    query answers" bounds (`_tol`), with the reference's route and
    fallback reason;
  * tests/test_query_engine.py::test_sharded_fast_path_skips_at;
  * tests/test_compute_faults.py's two `one_device_mesh` classes
    (TestAggFlushCampaign, TestFlushEncodeAllOrNothing). The reference's
    mesh routes fall back to the single-device path on a fault and its
    tests assert that fallback's answer (or None from
    flush_encode_prepared); the port takes no second path, so here every
    faulted call answers the clean result or raises a typed
    ComputeError, and a shard whose mesh seal faulted keeps its points
    and seals them on the next tick;
  * the sharding cases of tests/test_explain.py: mesh_ok and the edge
    annotations equal the reference's, and the executed route names what
    the sharded executable ran."""

import numpy as np
import pytest
import torch

from m3_tpu.ops import tsz as jtsz
from m3_tpu.query import Engine as JEngine
from m3_tpu.query import explain as jexplain
from m3_tpu.query import plan as jplan
from m3_tpu.query import promql as jpromql
from m3_tpu.query.executor import QueryParams as JQueryParams
from m3_tpu.storage import block as jblock
from m3_tpu_torch.device import attach
from m3_tpu_torch.ops import tsz
from m3_tpu_torch.parallel import agg_flush, guard, ingest
from m3_tpu_torch.query import explain as qexplain
from m3_tpu_torch.query import plan as qplan
from m3_tpu_torch.query import promql
from m3_tpu_torch.query.executor import DEFAULT_LOOKBACK_NS, Engine, QueryParams
from m3_tpu_torch.storage import block as storage_block
from m3_tpu_torch.storage.block import encode_block
from m3_tpu_torch.storage.shard import Shard, ShardOptions
from m3_tpu_torch.testing import faultcomp
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.instrument import ROOT
from test_agg_mesh import _build_population
from test_compute_faults import MIXED, _corpus
from test_plan_compile import (COMPILED_QUERIES, END, FALLBACK_QUERIES,
                               START, STEP, make_storage)
from test_query_engine import MIN, STEP as QSTEP, MemStorage
from test_torch_aggregator import (assert_rows_equal, port_population,
                                   run_port, run_reference)
from test_torch_plan_compile import assert_matches
from test_write_path import BLOCK, S, T0

CPU = torch.device("cpu")


@pytest.fixture
def cpu8():
    with attach([CPU] * 8) as devs:
        yield devs


@pytest.fixture
def no_floor(monkeypatch):
    monkeypatch.setattr(qplan, "PLAN_MIN_CELLS", 1)
    monkeypatch.setattr(jplan, "PLAN_MIN_CELLS", 1)


@pytest.fixture
def clean_guard():
    faultcomp.uninstall()
    guard.reset()
    yield
    faultcomp.uninstall()
    guard.reset()


def dispatches(kernel: str) -> int:
    return ROOT.snapshot().get(
        f"telemetry.mesh.dispatches{{kernel={kernel}}}", 0)


# ------------------------------------------------------ aggregator flush


@pytest.mark.parametrize("seed", range(16))
def test_mesh_flush_bit_identical_to_ref(seed, cpu8):
    """MetricList.flush with its timer quantiles ordered over the mesh:
    every sink row equals the reference oracle's, bit for bit (NaN equal
    to NaN), and the mesh route really ran."""
    before = dispatches("agg_flush")
    lists, lst = port_population(seed)
    got = run_port(lists, lst, "flush")
    assert dispatches("agg_flush") == before + 1
    want = run_reference(_build_population(seed)[0])
    assert_rows_equal(got, want, f"seed {seed}")


@pytest.mark.parametrize("seed", range(4))
def test_rank_rows_mesh_equals_one_device(seed, cpu8):
    """quantile_rank_rows over the mesh (rows padded with count-0 windows
    to a multiple of eight) equals the single-device selection."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 300, 37).astype(np.int64)
    counts[:3] = 0
    buckets = [rng.lognormal(0, 1, int(c)) for c in counts]
    tile, _, _ = agg_flush.build_quantile_tile(buckets, counts)
    qs = (0.5, 0.9, 0.99)
    before = dispatches("agg_flush")
    got = agg_flush.quantile_rank_rows(tile, counts.astype(np.int32), qs)
    assert dispatches("agg_flush") == before + 1
    with attach([CPU]):
        one = agg_flush.quantile_rank_rows(tile, counts.astype(np.int32), qs,
                                           device="cpu")
    np.testing.assert_array_equal(got, one)


def test_rank_rows_below_floor_stays_on_one_device(cpu8, monkeypatch):
    monkeypatch.setenv("M3_TPU_MESH_AGG_MIN_CELLS", str(10**9))
    tile = np.zeros((16, 128), np.float32)
    before = dispatches("agg_flush")
    agg_flush.quantile_rank_rows(tile, np.ones(16, np.int32), (0.5,),
                                 device="cpu")
    assert dispatches("agg_flush") == before


# ------------------------------------------------------- the seal encode


class TestMeshFlushEncode:
    @staticmethod
    def _dense(rng, s=32, w=64):
        ts = T0 + np.arange(w, dtype=np.int64)[None, :] * 10 * S \
            + np.zeros((s, 1), np.int64)
        vals = np.floor(rng.standard_normal((s, w)) * 100)
        return (np.arange(s, dtype=np.int32), ts, vals,
                np.full(s, w, np.int32))

    def test_mesh_encode_bit_identical_to_single_device(self, rng, cpu8,
                                                        monkeypatch):
        """The seal's mesh encode: words/nbits bit-equal to the
        single-device encode and to the reference's mesh encode, and the
        counter proves the mesh route ran."""
        series, ts, vals, npts = self._dense(rng)
        counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
        before = counter.value()
        assert ingest.flush_mesh() is not None
        mesh_blk = encode_block(T0, series, ts, vals, npts, device="cpu")
        assert counter.value() == before + 1
        monkeypatch.setenv("M3_TPU_MESH_FLUSH", "0")
        ingest.flush_mesh.cache_clear()
        try:
            single_blk = encode_block(T0, series, ts, vals, npts,
                                      device="cpu")
            assert counter.value() == before + 1  # did NOT route
        finally:
            monkeypatch.undo()
            ingest.flush_mesh.cache_clear()
        ref = jblock.encode_block(T0, series, ts, vals, npts)
        for blk in (single_blk, ref):
            np.testing.assert_array_equal(mesh_blk.words, blk.words)
            np.testing.assert_array_equal(mesh_blk.nbits, blk.nbits)
            np.testing.assert_array_equal(mesh_blk.npoints, blk.npoints)
        dt, dv, _ = mesh_blk.read_all()
        np.testing.assert_array_equal(dt, ts)
        np.testing.assert_array_equal(dv, vals)

    def test_tick_seal_routes_through_mesh(self, cpu8):
        """Shard._tick_locked's seal takes the mesh route when the padded
        tile divides the device count and clears the floor (32 series x
        64 points = 2048 cells)."""
        shard = Shard(0, ShardOptions(), device="cpu")
        bs, ids = self._write(shard)
        counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
        before = counter.value()
        shard.tick(bs + BLOCK + 11 * xtime.MINUTE)
        assert counter.value() == before + 1
        t_r, v_r = shard.read(ids[5], bs, bs + BLOCK)
        np.testing.assert_array_equal(v_r, np.arange(64.0) + 5.0)

    @staticmethod
    def _write(shard):
        bs = (T0 // BLOCK) * BLOCK
        ids = [b"mesh-%02d" % i for i in range(32)]
        base = bs + xtime.MINUTE
        for p in range(64):
            t = base + p * xtime.SECOND
            shard.write_batch(ids, np.full(32, t, np.int64),
                              np.arange(32.0) + p, t)
        return bs, ids

    def test_below_floor_or_indivisible_takes_one_device(self, rng, cpu8):
        counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
        before = counter.value()
        for s, w in ((8, 16), (12, 256)):   # 128 cells; 12 % 8 rows
            _, ts, vals, npts = self._dense(rng, s=s, w=w)
            inp = tsz.prepare_encode_inputs(ts // S, vals, npts)
            assert ingest.flush_encode_prepared(
                inp, tsz.max_words_for(w)) is None
        assert counter.value() == before

    def test_seal_mesh_encode_prepared(self, rng, cpu8):
        """ops.tsz.encode_prepared's mesh route (the reference's
        _seal_mesh route; in the port the seal's one mesh route,
        flush_encode_prepared) equals one device and the reference's
        encode on its eight devices."""
        _, ts, vals, npts = self._dense(rng, s=64, w=32)   # 2048 cells
        inp = tsz.prepare_encode_inputs(ts // S, vals, npts)
        mw = tsz.max_words_for(32)
        before = dispatches("flush_encode")
        got = tsz.encode_prepared(inp, mw, device="cpu")
        assert dispatches("flush_encode") == before + 1
        with attach([CPU]):
            want = tsz.encode_prepared(inp, mw, device="cpu")
        assert dispatches("flush_encode") == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ref_w, ref_nb = jtsz.encode_prepared(
            jtsz.prepare_encode_inputs(ts // S, vals, npts), mw)
        np.testing.assert_array_equal(
            got[0].numpy().view(np.uint32), np.asarray(ref_w).view(np.uint32))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_nb))


# --------------------------------------------- the caller's device type


@pytest.fixture
def two_cards_listed(monkeypatch):
    """The device list a host with two cards gives (attached() by
    default, or attach([cuda] * 2) there), set without resolving it:
    building a mesh touches no card, so this holds on the CPU. A route
    that took the mesh here would move its slices to a card and raise."""
    from m3_tpu_torch import device as devmod

    monkeypatch.setattr(devmod, "_ATTACHED", [torch.device("cuda", 0)] * 2)
    devmod._clear_meshes()
    yield
    monkeypatch.undo()
    devmod._clear_meshes()


def test_a_cpu_call_stays_off_a_mesh_of_cards(two_cards_listed, no_floor,
                                              rng):
    """encode_block, Shard.tick, encode_prepared, quantile_rank_rows and
    Engine(mesh="auto") asked for the CPU run on the CPU, not on the
    listed cards: no mesh dispatch, no mesh_encode, no mesh route."""
    assert ingest.flush_mesh().first.type == "cuda"
    kernels = ("flush_encode", "agg_flush", "plan")
    before = [dispatches(k) for k in kernels]
    counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
    sealed = counter.value()
    series, ts, vals, npts = TestMeshFlushEncode._dense(rng)
    blk = encode_block(T0, series, ts, vals, npts, device="cpu")
    dt, dv, _ = blk.read_all()
    np.testing.assert_array_equal(dv, vals)
    inp = tsz.prepare_encode_inputs(ts // S, vals, npts)
    words, _ = tsz.encode_prepared(inp, tsz.max_words_for(64), device="cpu")
    assert words.device.type == "cpu"
    shard = Shard(0, ShardOptions(), device="cpu")
    bs, ids = TestMeshFlushEncode._write(shard)
    assert shard.tick(bs + BLOCK + 11 * xtime.MINUTE)["sealed"] == 1
    counts = np.full(16, 100, np.int32)
    tile = rng.standard_normal((16, 128)).astype(np.float32)   # 2048 cells
    idx = agg_flush.quantile_rank_rows(tile, counts, (0.5,), device="cpu")
    assert idx.shape == (16, 1)
    eng = Engine(make_storage(5), device="cpu")
    assert eng.mesh is None
    eng.execute_range("sum by (host) (rate(m[5m]))", START, END, STEP)
    assert eng.last_route()["route"] == "compiled"
    assert "mesh" not in eng.last_route()
    assert [dispatches(k) for k in kernels] == before
    assert counter.value() == sealed


# ------------------------------------------------------------ compute faults


def _one_device_mesh(monkeypatch, module, env):
    mesh = ingest.make_mesh(1, devices=[CPU])
    monkeypatch.setattr(module, "flush_mesh", lambda: mesh)
    monkeypatch.setenv(env, "0")
    return mesh


class TestAggFlushCampaign:
    """The reference's campaign serves the single-device fallback under
    faults; the port's mesh route answers the clean values or raises
    typed."""

    @pytest.mark.parametrize("kinds", [
        dict(dispatch_raise=1.0), dict(corrupt=1.0), MIXED])
    def test_quantile_values_exact_or_typed_under_faults(
            self, kinds, monkeypatch, clean_guard):
        _one_device_mesh(monkeypatch, agg_flush, "M3_TPU_MESH_AGG_MIN_CELLS")
        rng = np.random.default_rng(17)
        counts = rng.integers(0, 40, 12).astype(np.int64)
        counts[0] = 0
        buckets = [np.sort(rng.normal(100, 20, int(c))) for c in counts]
        qs = (0.5, 0.99)
        before = dispatches("agg_flush")
        oracle = agg_flush.exact_quantile_values(buckets, counts, qs)
        assert dispatches("agg_flush") == before + 1
        plan = faultcomp.ComputeFaultPlan(seed=23, route_filter="agg_flush",
                                          **kinds)
        answered = 0
        with faultcomp.injected(plan) as seam:
            for _ in range(3):
                mark = seam.mark()
                try:
                    got = agg_flush.exact_quantile_values(buckets, counts, qs)
                except guard.ComputeError as err:
                    assert faultcomp.unexplained(seam.since(mark), err) is None
                    guard.reset()
                    continue
                assert faultcomp.unexplained(seam.since(mark), None) is None
                np.testing.assert_array_equal(got, oracle)
                answered += 1
        assert len(seam.decisions.get("agg_flush", [])) > 0
        if kinds.get("dispatch_raise") == 1.0 or kinds.get("corrupt") == 1.0:
            assert answered == 0


class TestFlushEncodeAllOrNothing:
    def test_fault_raises_typed_nothing_partially_applied(
            self, monkeypatch, clean_guard):
        _one_device_mesh(monkeypatch, ingest, "M3_TPU_MESH_FLUSH_MIN_CELLS")
        ts, vals, npoints = _corpus(51, 4, 8)
        inp = tsz.prepare_encode_inputs(ts, vals, npoints)
        mw = tsz.max_words_for(8)
        clean = ingest.flush_encode_prepared(inp, mw)
        assert clean is not None
        plain_w, plain_nb = tsz.encode_prepared(inp, mw, device="cpu")
        assert torch.equal(clean[0], plain_w) and torch.equal(clean[1],
                                                              plain_nb)
        plan = faultcomp.ComputeFaultPlan(
            seed=0, route_filter="flush_encode", dispatch_raise=1.0)
        with faultcomp.injected(plan):
            with pytest.raises(guard.ComputeError) as err:
                ingest.flush_encode_prepared(inp, mw)
        assert err.value.route == "flush_encode"

    def test_corrupt_mesh_flush_never_surfaces(self, monkeypatch,
                                               clean_guard):
        _one_device_mesh(monkeypatch, ingest, "M3_TPU_MESH_FLUSH_MIN_CELLS")
        ts, vals, npoints = _corpus(53, 4, 8)
        inp = tsz.prepare_encode_inputs(ts, vals, npoints)
        mw = tsz.max_words_for(8)
        plan = faultcomp.ComputeFaultPlan(
            seed=1, route_filter="flush_encode", corrupt=1.0)
        with faultcomp.injected(plan):
            with pytest.raises(guard.KernelFault, match="corrupted output"):
                ingest.flush_encode_prepared(inp, mw)

    def test_faulted_seal_keeps_acked_points_for_the_next_tick(
            self, cpu8, clean_guard):
        """A fault in the mesh seal raises out of tick() before the
        bucket is dropped; the next tick seals every acked point."""
        shard = Shard(0, ShardOptions(), device="cpu")
        bs, ids = TestMeshFlushEncode._write(shard)
        now = bs + BLOCK + 11 * xtime.MINUTE
        counter = storage_block._FLUSH_METRICS.counter("mesh_encode")
        before = counter.value()
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=2, route_filter="flush_encode", dispatch_raise=1.0)):
            with pytest.raises(guard.ComputeError):
                shard.tick(now)
        assert counter.value() == before and bs not in shard.blocks
        for i in (0, 5, 31):          # still served from the buffer
            _, v = shard.read(ids[i], bs, bs + BLOCK)
            np.testing.assert_array_equal(v, np.arange(64.0) + i)
        guard.reset()
        assert shard.tick(now)["sealed"] == 1
        assert counter.value() == before + 1 and bs in shard.blocks
        for i in range(32):
            _, v = shard.read(ids[i], bs, bs + BLOCK)
            np.testing.assert_array_equal(v, np.arange(64.0) + i)


# ------------------------------------------------------- compiled plans


class TestMeshVsSingleDevice:
    def test_sharded_equals_single(self, no_floor, cpu8):
        st = make_storage(107)
        e_mesh = Engine(st, device="cpu")          # auto: the eight entries
        e_one = Engine(st, device="cpu", mesh=None)
        ref = JEngine(st)                          # its eight devices
        for q in ("sum by (host) (rate(m[5m]))", "max(rate(m[5m]))",
                  "sum(m)", "avg_over_time(m[5m])"):
            before = dispatches("plan")
            a = e_mesh.execute_range(q, START, END, STEP)
            assert dispatches("plan") == before + 1, q
            assert e_mesh.last_route()["mesh"] == {"shards": 8,
                                                    "executable": "cpu"}
            b = e_one.execute_range(q, START, END, STEP)
            assert "mesh" not in e_one.last_route()
            assert_matches(a, b, q, rtol=1e-6, atol=1e-6)
            assert_matches(a, ref.execute_range(q, START, END, STEP), q)
            assert ref.last_route()["route"] == "compiled", q
        assert e_mesh.mesh is not None

    @pytest.mark.parametrize("seed", range(2))
    def test_corpus_over_the_mesh(self, seed, no_floor, cpu8):
        """Every corpus query over the mesh: held to the port's
        interpreter under the compiled-answer bounds, with the reference
        mesh route's route and fallback reason, and every compiled
        answer to the reference's on its eight devices under the same
        bounds (as TestCompiledVsReference holds one device's); mesh_ok
        plans run sharded, the others on one device."""
        st = make_storage(seed)
        eng = Engine(st, device="cpu")
        ref = JEngine(st)                          # its eight devices
        sharded = 0
        for q in COMPILED_QUERIES + FALLBACK_QUERIES:
            got = eng.execute_range(q, START, END, STEP)
            want = ref.execute_range(q, START, END, STEP)
            mine, theirs = eng.last_route(), ref.last_route()
            assert (mine["route"], mine["fallback_reason"]) == (
                theirs["route"], theirs["fallback_reason"]), q
            assert_matches(got, eng.execute_range_ref(q, START, END, STEP), q)
            if mine["route"] != "compiled":
                continue
            assert_matches(got, want, q)
            ok = explain(q)["mesh_ok"]
            assert ("mesh" in mine) == ok, q
            sharded += ok
        assert sharded >= len(COMPILED_QUERIES) // 2

    def test_counter_sums_stay_exact_over_the_mesh(self, no_floor, cpu8):
        """A sum/avg over raw counters: the slices' exact-integer residual
        sums fan in exactly, so the f64 finish is still bit-equal to the
        interpreter's and to the reference's mesh answer."""
        from test_torch_plan_compile import counter_storage

        st = counter_storage(3)
        eng, ref = Engine(st, device="cpu"), JEngine(st)
        for q in ("sum(m)", "sum by (host) (m)", "avg(m)"):
            got = eng.execute_range(q, START, END, STEP)
            assert "mesh" in eng.last_route(), q
            assert_matches(got, eng.execute_range_ref(q, START, END, STEP), q,
                           exact=True)
            assert_matches(got, ref.execute_range(q, START, END, STEP), q,
                           exact=True)


def test_sharded_fast_path_skips_at(cpu8):
    """@ on the inner selector must not take the mesh route blindly: the
    answer is the host path's, and query.sharded_agg does not fire."""
    st = MemStorage()
    t = np.arange(0, 40) * 15 * S
    for inst, rate in ((b"a", 10.0), (b"b", 5.0), (b"c", 2.0)):
        st.add({"__name__": "http_requests_total", "instance": inst}, t,
               np.arange(40) * rate)
    eng = Engine(st, device="cpu")
    assert eng.mesh is not None
    before = ROOT.counter("query.sharded_agg").value()
    got = eng.execute_range("sum(increase(http_requests_total[2m] @ 480))",
                            5 * MIN, 9 * MIN, QSTEP)
    assert ROOT.counter("query.sharded_agg").value() == before
    # all three counters: (10+5+2)/15s * 120s = 136
    assert np.allclose(got.values, 17 / 15 * 120, rtol=1e-6)


# ------------------------------------------------------------ explain


def explain(q: str) -> dict:
    return qexplain.explain(promql.parse(q), QueryParams(START, END, STEP),
                            DEFAULT_LOOKBACK_NS, query=q)


@pytest.mark.parametrize("q", [
    "sum by (host) (rate(m[5m]))", "max_over_time(rate(m[5m])[10m:1m])",
    "topk(3, m)", "m * on(host) group_left c", "absent_over_time(m[5m])",
    "stddev by (host) (m) + 1"])
def test_explain_sharding_equals_the_references(q):
    """mesh_ok and every node's sharding annotation are the reference's."""
    want = jexplain.explain(jpromql.parse(q), JQueryParams(START, END, STEP),
                            DEFAULT_LOOKBACK_NS, query=q)
    got = explain(q)
    assert got["mesh_ok"] == want["mesh_ok"]
    assert ([n["sharding"] for n in qexplain.walk(got["root"])]
            == [n["sharding"] for n in jexplain.walk(want["root"])])


def test_executed_route_names_the_sharded_executable(no_floor, cpu8):
    """The executed record of a mesh_ok query names its slices and its
    executable; a query that is not mesh_ok runs on one device."""
    eng = Engine(make_storage(5), device="cpu")
    eng.execute_range("max_over_time(rate(m[5m])[10m:1m])", START, END, STEP)
    route = eng.last_route()
    assert route["route"] == "compiled"
    assert route["mesh"] == {"shards": 8, "executable": "cpu"}
    eng.execute_range("topk(3, m)", START, END, STEP)
    assert eng.last_route()["route"] == "compiled"
    assert "mesh" not in eng.last_route()
