"""The port's aggregator tier (m3_tpu_torch/aggregator) on the CPU against
the reference (m3_tpu/aggregator).

Tolerance: none. Moments are host f64 in both packages and quantiles are
exact f64 values gathered by device-ordered index, so every emitted row
(id, time, value, policy) and every forwarded partial is held equal bit
for bit, with NaN equal to NaN (`_eq` of tests/test_agg_mesh.py), on:
- the 16-seed mixed population of tests/test_agg_mesh.py
  (_build_population), through the port's MetricList.flush,
  reduce_and_emit and reduce_and_emit_ref, against the reference's
  reduce_and_emit_ref via plan_jobs;
- transform state threaded across rounds;
- bench_counter_gauge's and _agg10x_build's populations at 2,000 metrics.
- the reference's aggregator scenarios (tests/test_aggregator.py) on
  both packages: windows, policies, pipelines, failover, flush times,
  entries.
Then the tier's own semantics: forward batching in the local loop-back,
one flush-times transaction a round, MEDIAN/P50 tuple-index keying, the
leader/follower flush, forward routing over the placement, and the
producer handler's payloads against the reference's."""

import numpy as np
import pytest

import bench
from m3_tpu.aggregator import elem as jelem
from m3_tpu.aggregator import list as jlist
from m3_tpu.aggregator.flush import plan_jobs as jplan_jobs
from m3_tpu.metrics.metric import MetricType as JMetricType
from m3_tpu_torch import testing as T
from m3_tpu_torch.aggregator import elem as elem_mod
from m3_tpu_torch.aggregator import list as list_mod
from m3_tpu_torch.aggregator.aggregator import Aggregator
from m3_tpu_torch.aggregator.election import ElectionManager, ElectionState
from m3_tpu_torch.aggregator.flush import (FlushManager, FlushTimesManager,
                                           plan_jobs)
from m3_tpu_torch.aggregator.handler import CaptureHandler
from m3_tpu_torch.cluster import kv as cluster_kv
from m3_tpu_torch.cluster.services import LeaderService
from m3_tpu_torch.metrics import aggregation as magg
from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                           StagedMetadata)
from m3_tpu_torch.metrics.metric import MetricType, MetricUnion
from m3_tpu_torch.metrics.pipeline import Op, Pipeline
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.transformation import TransformType
from test_agg_mesh import BASE, S, _build_population, _eq

CPU = "cpu"
POL = StoragePolicy.parse("1m:40h")


def port_population(seed: int, n: int = 240):
    """tests/test_agg_mesh.py's _build_population, on the port's modules
    (the same draws in the same order)."""
    rng = np.random.default_rng(seed)
    lists = list_mod.MetricLists(CPU)
    lst = lists.for_resolution(60 * S)
    for i in range(n):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            key, mt = elem_mod.ElemKey(b"t.c.%d" % i, POL), MetricType.COUNTER
        elif kind == 1:
            key, mt = elem_mod.ElemKey(b"t.g.%d" % i, POL), MetricType.GAUGE
        elif kind == 2:
            key, mt = elem_mod.ElemKey(b"t.t.%d" % i, POL), MetricType.TIMER
        elif kind == 3:
            key = elem_mod.ElemKey(b"t.x.%d" % i, POL, magg.AggID.compress(
                [magg.AggType.MEAN, magg.AggType.STDEV, magg.AggType.SUMSQ,
                 magg.AggType.MIN, magg.AggType.MAX, magg.AggType.P99]))
            mt = MetricType.TIMER
        elif kind == 4:
            pipe = Pipeline((
                Op.transform(TransformType.PERSECOND),
                Op.roll(b"t.roll.%d" % (i % 5), (b"host",),
                        magg.AggID.compress([magg.AggType.SUM])),
            ))
            key = elem_mod.ElemKey(
                b"t.p.%d" % i, POL,
                magg.AggID.compress([magg.AggType.LAST]), pipe)
            mt = MetricType.GAUGE
        else:
            key, mt = elem_mod.ElemKey(b"t.e.%d" % i, POL), MetricType.GAUGE
        e = lst.get_or_create(key, lambda k=key, m=mt: elem_mod.Elem(k, m))
        nw = int(rng.integers(1, 4))
        for w in range(nw):
            nv = int(rng.integers(0, 8)) if kind != 5 else 0
            vals = rng.lognormal(0, 1, nv)
            if nv and rng.random() < 0.3:
                vals[int(rng.integers(0, nv))] = np.nan
            e.add_values(BASE + w * 60 * S, vals)
    return lists, lst


def sinks():
    sink = []

    def cap(mid, t, v, p):
        sink.append((mid, t, v, str(p)))

    def fwd(new_id, t, v, meta, src):
        sink.append((b"FWD:" + new_id, t, v,
                     str(meta.storage_policy) + ":" + src.decode()))

    return sink, cap, fwd


def run_port(lists, lst, route: str):
    sink, cap, fwd = sinks()
    target = BASE + 10 * 60 * S
    if route == "flush":
        lst.flush(target, cap, fwd)
        return sink
    jobs, _ = plan_jobs(lists, target, 0, cap, fwd)
    if route == "oracle":
        list_mod.reduce_and_emit_ref(jobs, device=CPU)
    else:
        list_mod.reduce_and_emit(jobs, device=CPU)
    return sink


def run_reference(lists):
    sink, cap, fwd = sinks()
    jobs, _ = jplan_jobs(lists, BASE + 10 * 60 * S, 0, cap, fwd)
    jlist.reduce_and_emit_ref(jobs)
    return sink


def assert_rows_equal(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(sorted(got, key=repr), sorted(want, key=repr)):
        assert _eq(g, w), (what, g, w)


@pytest.mark.parametrize("route", ["flush", "oracle", "jobs"])
@pytest.mark.parametrize("seed", range(16))
def test_flush_bit_identical_to_reference(seed, route):
    """Every sink row of the port's MetricList.flush (route "flush"), of
    the port's own oracle (route "oracle") and of its tuple-job shim
    reduce_and_emit (route "jobs") equals the reference oracle's, bit for
    bit."""
    got = run_port(*port_population(seed), route)
    want = run_reference(_build_population(seed)[0])
    assert got, "the population always emits"
    assert_rows_equal(got, want, seed)


def test_transform_state_threads_across_rounds():
    """PerSecond's previous-window datapoint threads identically through
    the port's columnar flush and the reference's oracle over successive
    rounds."""
    port_lists, port_lst = port_population(101)
    ref_lists, ref_lst, _ = _build_population(101)
    for rnd in range(3):
        for lst in (port_lst, ref_lst):
            for e in lst.elems():
                e.add_values(BASE + (5 + rnd) * 60 * S,
                             np.full(3, float(rnd + 1)))
        got = run_port(port_lists, port_lst, "flush")
        want = run_reference(ref_lists)
        assert any(r[0].startswith(b"FWD:") for r in want)
        assert_rows_equal(got, want, rnd)


def reference_loopback(lst):
    """The reference's twin of testing.loopback_forward (elems of the
    reference's own module)."""
    def forward_fn(new_id, t_nanos, value, meta, source_id):
        key = jelem.ElemKey(new_id, meta.storage_policy, meta.aggregation_id,
                            meta.pipeline, meta.num_forwarded_times)
        lst.get_or_create(key, lambda: jelem.Elem(
            key, JMetricType.GAUGE)).add_value(t_nanos, value)

    forward_fn.forward_batch = lambda items: [forward_fn(*it) for it in items]
    return forward_fn


def test_agg10x_population_at_2000_equals_reference():
    """_agg10x_build's population (40/40/20, 10% piped gauges) at 2,000
    metrics: both windows and the second-stage flush, the port's flush
    against the reference's, and the port's oracle against both."""
    n = 2_000
    planes = T.agg10x_planes(n)
    t1, t2 = T.AGG_BASE_NS + 120 * S, T.AGG_BASE_NS + 180 * S
    out = {}
    for who in ("port", "port_oracle", "reference"):
        if who == "reference":
            lists, elems, n_piped, n_ids = bench._agg10x_build(
                n, jlist, jelem)
        else:
            lists, elems, n_piped, n_ids = T.agg10x_build(n, CPU)
        assert (n_piped, n_ids) == (80, 2)
        lst = lists.for_resolution(60 * S)
        T.agg10x_stage(elems, planes)
        sink = []

        def cap(mid, t, v, p, _s=sink):
            _s.append((mid, t, v))

        if who == "port":
            fwd = T.loopback_forward(lst)
            assert lst.flush(t1, cap, fwd) == 2 * n
            assert lst.flush(t2, cap, fwd) == 2 * n_ids
        else:
            fwd = (reference_loopback(lst) if who == "reference"
                   else T.loopback_forward(lst))
            for t in (t1, t2):
                if who == "reference":
                    jlist.reduce_and_emit_ref(
                        jplan_jobs(lists, t, 0, cap, fwd)[0])
                else:
                    list_mod.reduce_and_emit_ref(
                        plan_jobs(lists, t, 0, cap, fwd)[0], device=CPU)
        out[who] = sorted(sink)
    # 800 counters and 720 plain gauges x 2 windows, 400 timers x 2 x 11
    # suffixed outputs, 2 rollup ids x 2 second-stage windows
    assert len(out["port"]) == 2 * (800 + 720) + 2 * 400 * 11 + 4
    assert out["port"] == out["reference"]
    assert out["port_oracle"] == out["reference"]


def test_counter_gauge_population_at_2000_equals_reference():
    """bench_counter_gauge's population at 2,000 metrics (1m and 5m
    policies, seed 23): the port's flush of both lists against the
    reference's lists built as the bench builds them."""
    from m3_tpu.aggregator.elem import Elem, ElemKey
    from m3_tpu.aggregator.list import MetricList
    from m3_tpu.metrics.policy import StoragePolicy as JPolicy

    n = 2_000
    lists, stage, target = T.counter_gauge_population(n, CPU)
    stage()
    got = []
    for lst in lists.values():
        got_n = lst.flush(target, lambda m, t, v, p: got.append((m, t, v)))
        assert got_n == n * (5 if lst.resolution_ns == 60 * S else 1)
    # the reference, as bench.py's bench_counter_gauge builds and stages it
    rng = np.random.default_rng(23)
    cvals = rng.poisson(5.0, (n // 2, 30)).astype(np.float64)
    gvals = rng.standard_normal((n - n // 2, 30))
    base = 1_700_000_000 * S
    want = []
    for res, pol in ((60, JPolicy.parse("1m:40h")),
                     (300, JPolicy.parse("5m:40h"))):
        lst = MetricList(res * S)
        for i in range(n):
            mt = JMetricType.COUNTER if i < n // 2 else JMetricType.GAUGE
            vals = cvals[i] if i < n // 2 else gvals[i - n // 2]
            e = lst.get_or_create(ElemKey(b"bench.cg.%d" % i, pol),
                                  lambda m=mt, i=i, pol=pol: Elem(
                                      ElemKey(b"bench.cg.%d" % i, pol), m))
            if res == 60:
                for wi in range(5):
                    e.add_values(base + wi * 60 * S, vals[wi * 6:(wi + 1) * 6])
            else:
                e.add_values(base, vals)
        lst.flush(target, lambda m, t, v, p: want.append((m, t, v)))
    assert len(got) == n * 6
    assert sorted(got) == sorted(want)


def test_forward_batching_in_loopback_form():
    """An Aggregator's flush ships the round's rollup forwards as ONE
    forward_batch into its local loop-back, in ascending window order per
    elem, and the partials land in second-stage entries."""
    agg = Aggregator(num_shards=4, clock=lambda: BASE, device=CPU,
                     flush_handler=CaptureHandler())
    pipe = Pipeline((Op.roll(b"roll.x", (b"host",),
                             magg.AggID.compress([magg.AggType.SUM])),))
    meta = StagedMetadata(0, False, Metadata((PipelineMetadata(
        magg.AggID.compress([magg.AggType.LAST]), (POL,), pipe),)))
    for i in range(12):
        mu = MetricUnion.gauge(b"src.%d" % i, float(i))
        agg.add_untimed_batch([mu], (meta,))
    calls = []
    orig = agg._forward.forward_batch
    agg._forward.forward_batch = lambda items: (calls.append(list(items)),
                                                orig(items))[1]
    n = agg.flush(BASE + 2 * 60 * S)
    assert n == 12 and len(calls) == 1 and len(calls[0]) == 12
    assert agg.forwarded_received == 12
    sid = agg.shard_for(b"roll.x")
    assert b"roll.x" in agg._shards[sid].map._entries
    # the forwarded partials flush in the next round as one rollup sum
    cap = agg._flush_handler
    agg.flush(BASE + 4 * 60 * S)
    rolled = cap.by_id(b"roll.x.sum")
    assert len(rolled) == 1 and rolled[0].value == float(sum(range(12)))
    # Routed form (forwarded_writer.go): two instances own the 4 shards
    # (RF 1). Each rollup partial goes to its shard's owner: applied
    # locally on "me", one columnar batch a meta group to "other"'s
    # transport; the owners are those of the reference's placement (the
    # same JSON) and murmur3 hash.
    from m3_tpu.cluster import placement as jpl
    from m3_tpu.utils.hashing import murmur3_32 as jmurmur3_32
    from m3_tpu_torch.cluster import placement as pl

    placement = pl.initial_placement(
        [pl.Instance("me", "me:1"), pl.Instance("other", "other:1")], 4, 1)
    jplacement = jpl.Placement.from_json(placement.to_json())
    sent = []

    class Transport:
        def send_forwarded_batch(self, metric_type, items):
            sent.append((metric_type, [(it[0], it[1], it[2]) for it in items]))
            return True

    routed = Aggregator(num_shards=4, clock=lambda: BASE, device=CPU,
                        flush_handler=CaptureHandler())
    routed.set_forward_routing(lambda: placement, {"other": Transport()},
                               "me")
    rids = [b"roll.%d" % k for k in range(6)]
    for i in range(12):
        rpipe = Pipeline((Op.roll(rids[i % 6], (b"host",),
                                  magg.AggID.compress([magg.AggType.SUM])),))
        rmeta = StagedMetadata(0, False, Metadata((PipelineMetadata(
            magg.AggID.compress([magg.AggType.LAST]), (POL,), rpipe),)))
        routed.add_untimed_batch([MetricUnion.gauge(b"src.%d" % i,
                                                    float(i))], (rmeta,))
    assert routed.flush(BASE + 2 * 60 * S) == 12
    owner = {rid: jplacement.replicas_for(jmurmur3_32(rid) % 4)[0].id
             for rid in rids}
    assert set(owner.values()) == {"me", "other"}
    remote = [it for mt, items in sent for it in items]
    assert all(mt == MetricType.GAUGE for mt, _ in sent) and len(sent) == 1
    assert sorted(it[0] for it in remote) == sorted(
        rid for i, rid in enumerate(rids * 2) if owner[rid] == "other")
    assert sorted((it[0], it[2]) for it in remote) == sorted(
        (rids[i % 6], float(i)) for i in range(12)
        if owner[rids[i % 6]] == "other")
    local = sum(2 for rid in rids if owner[rid] == "me")
    assert routed.forwarded_received == local and routed._forward.dropped == 0
    for rid in rids:
        entries = routed._shards[routed.shard_for(rid)].map._entries \
            if routed.shard_for(rid) in routed._shards else {}
        assert (rid in entries) == (owner[rid] == "me")
    routed.set_forward_routing(lambda: placement, {}, "me")
    for i in range(12):
        routed.add_untimed_batch([MetricUnion.gauge(b"src.%d" % i, 1.0)], (
            StagedMetadata(0, False, Metadata((PipelineMetadata(
                magg.AggID.compress([magg.AggType.LAST]), (POL,),
                Pipeline((Op.roll(rids[i % 6], (b"host",), magg.AggID.compress(
                    [magg.AggType.SUM])),))),))),))
    routed.flush(BASE + 4 * 60 * S)
    assert routed._forward.dropped == sum(
        2 for rid in rids if owner[rid] == "other")


def test_producer_handler_payloads_equal_the_reference():
    """ProducerHandler publishes the reference's bytes (one payload a
    datapoint from handle, one columnar payload a topic shard from
    handle_columnar), which both packages' decode_aggregated(_batch)
    read back; a producer past its watermark counts drops."""
    from m3_tpu.aggregator import handler as jhandler
    from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
    from m3_tpu.utils.limits import Backpressure as JBackpressure
    from m3_tpu_torch.aggregator import handler
    from m3_tpu_torch.utils.limits import Backpressure

    class Producer:
        def __init__(self, full_error=None):
            self.out, self.full_error = [], full_error

        def publish(self, shard, payload):
            if self.full_error is not None:
                raise self.full_error("past the watermark")
            self.out.append((shard, payload))

    rng = np.random.default_rng(3)
    pols = ("1m:40h", "10s:2d")
    rows = [(b"agg.%d" % i, int(BASE + i * S), float(rng.standard_normal()),
             pols[i % 2]) for i in range(40)]
    groups = [([r[0] for r in rows if r[3] == sp],
               np.array([r[1] for r in rows if r[3] == sp], np.int64),
               np.array([r[2] for r in rows if r[3] == sp]), sp)
              for sp in pols]
    got, want = [], []
    for mod, pol_cls, out in ((handler, StoragePolicy, got),
                              (jhandler, JStoragePolicy, want)):
        prod = Producer()
        h = mod.ProducerHandler(prod, num_shards=8)
        for mid, t, v, sp in rows[:5]:
            h.handle(mod.AggregatedMetric(mid, t, v, pol_cls.parse(sp)))
        h.handle_columnar([(ids, ts, vs, pol_cls.parse(sp))
                           for ids, ts, vs, sp in groups])
        assert h.publishes == len(prod.out)
        out.extend(prod.out)
    assert got == want and len(got) > 5
    for shard, payload in got:
        one = [(m.id, m.time_nanos, m.value, str(m.storage_policy))
               for m in handler.decode_aggregated_batch(payload)]
        assert one == [(m.id, m.time_nanos, m.value, str(m.storage_policy))
                       for m in jhandler.decode_aggregated_batch(payload)]
    first = handler.decode_aggregated(got[0][1])
    jfirst = jhandler.decode_aggregated(got[0][1])
    assert (first.id, first.time_nanos, first.value,
            str(first.storage_policy)) == (jfirst.id, jfirst.time_nanos,
                                           jfirst.value,
                                           str(jfirst.storage_policy))
    assert (first.id, first.time_nanos, first.value) == rows[0][:3]
    decoded = sorted((m.id, m.time_nanos, m.value, str(m.storage_policy))
                     for _s, p in got[5:]
                     for m in handler.decode_aggregated_batch(p))
    assert decoded == sorted((mid, t, v, str(StoragePolicy.parse(sp)))
                             for mid, t, v, sp in rows)
    full = handler.ProducerHandler(Producer(Backpressure), num_shards=8)
    full.handle_columnar([(ids, ts, vs, StoragePolicy.parse(sp))
                          for ids, ts, vs, sp in groups])
    full.handle(handler.AggregatedMetric(b"x", 0, 1.0, POL))
    jfull = jhandler.ProducerHandler(Producer(JBackpressure), num_shards=8)
    jfull.handle_columnar([(ids, ts, vs, JStoragePolicy.parse(sp))
                           for ids, ts, vs, sp in groups])
    jfull.handle(jhandler.AggregatedMetric(b"x", 0, 1.0,
                                           JStoragePolicy.parse("1m:40h")))
    assert full.dropped_backpressure == jfull.dropped_backpressure == 41
    assert full.publishes == jfull.publishes == 0


def test_aggregator_flush_commits_flush_times_once():
    """A managed multi-shard Aggregator.flush batches every shard's flush
    times into one store_many call."""
    store = cluster_kv.MemStore()
    many = []
    orig = store.set_many
    store.set_many = lambda items: (many.append(len(items)), orig(items))[1]
    ftimes = FlushTimesManager(store, "ss")
    cap = CaptureHandler()
    clock = {"t": BASE}
    leader = LeaderService(store, "agg-election", "i-0",
                           lease_ttl_ns=3600 * S, clock=lambda: clock["t"])
    agg = Aggregator(num_shards=8, clock=lambda: clock["t"],
                     flush_handler=cap, election=ElectionManager(leader),
                     flush_times=ftimes, default_policies=(POL,), device=CPU)
    for i in range(64):
        agg.add_timed(MetricType.GAUGE, b"ten.m.%d" % i, BASE, float(i), POL)
    clock["t"] = BASE + 2 * 60 * S
    assert agg.flush() == 64
    assert len(cap.metrics) == 64 and len(many) == 1
    used = {agg.shard_for(b"ten.m.%d" % i) for i in range(64)}
    assert {sid for sid in range(8) if ftimes.get(sid)} >= used
    assert sorted(m.value for m in cap.metrics) == [float(i) for i in range(64)]


def test_follower_discards_what_the_leader_flushed():
    """Two flush managers on one election: the leader emits and persists
    its flush times; the follower emits nothing, discards the covered
    windows and confirms it caught up."""
    store = cluster_kv.MemStore()
    ftimes = FlushTimesManager(store, "ss")
    clock = {"t": BASE}
    mgrs = []
    for inst in ("a", "b"):
        lists = list_mod.MetricLists(CPU)
        lst = lists.for_resolution(60 * S)
        e = lst.get_or_create(elem_mod.ElemKey(b"m", POL),
                              lambda: elem_mod.Elem(elem_mod.ElemKey(b"m", POL),
                                                    MetricType.COUNTER))
        e.add_values(BASE, np.array([1.0, 2.0]))
        cap = CaptureHandler()
        el = ElectionManager(LeaderService(store, "e", inst,
                                           clock=lambda: clock["t"]))
        mgrs.append((FlushManager(lists, el, ftimes, cap), el, cap))
    clock["t"] = BASE + 60 * S
    assert mgrs[0][0].flush(clock["t"]) == 1
    assert mgrs[1][0].flush(clock["t"]) == 0
    assert mgrs[0][1].state == ElectionState.LEADER
    assert mgrs[1][1].state == ElectionState.FOLLOWER
    assert [m.value for m in mgrs[0][2].metrics] == [3.0]
    assert mgrs[1][2].metrics == [] and mgrs[1][0].windows_discarded == 1


def test_quantile_rows_keyed_by_tuple_index():
    """MEDIAN and P50 share q=0.5: both read the SAME position of the
    elem's _quantiles tuple, on the scalar emit and the columnar flush."""
    key = elem_mod.ElemKey(b"t.q", POL, magg.AggID.compress(
        [magg.AggType.MEDIAN, magg.AggType.P50, magg.AggType.P99]))
    e = elem_mod.Elem(key, MetricType.TIMER)
    assert e._quantiles == (0.5, 0.99)
    assert e._q_idx[magg.AggType.MEDIAN] == e._q_idx[magg.AggType.P50] == 0
    assert e._q_idx[magg.AggType.P99] == 1
    out = []
    e.emit(BASE, {k: 0.0 for k in list_mod._STAT_KEYS} | {"count": 3.0},
           (41.5, 99.25), lambda mid, t, v, p: out.append((mid, v)))
    got = dict(out)
    assert got[b"t.q.median"] == got[b"t.q.p50"] == 41.5
    assert got[b"t.q.p99"] == 99.25
    lst = list_mod.MetricList(60 * S, CPU)
    lst._elems[key] = e
    e.add_values(BASE, np.arange(1.0, 101.0))
    flushed = []
    lst.flush(BASE + 60 * S, lambda mid, t, v, p: flushed.append((mid, v)))
    got = dict(flushed)
    assert got[b"t.q.median"] == got[b"t.q.p50"] == 50.0
    assert got[b"t.q.p99"] == 99.0


def test_emit_class_interned_and_elem_staging():
    """Elems with one emission signature share ONE interned EmitClass;
    chunked and out-of-order adds still flush exactly."""
    k1, k2 = elem_mod.ElemKey(b"a.x", POL), elem_mod.ElemKey(b"b.y", POL)
    e1 = elem_mod.Elem(k1, MetricType.COUNTER)
    assert e1._eclass is elem_mod.Elem(k2, MetricType.COUNTER)._eclass
    e1.add_values(BASE + 60 * S, np.array([1.0, 2.0]))
    e1.add_values(BASE, np.array([3.0]))
    e1.add_values(BASE + 60 * S, np.array([4.0]))
    assert e1._degraded
    lst = list_mod.MetricList(60 * S, CPU)
    lst._elems[k1] = e1
    out = []
    assert lst.flush(BASE + 2 * 60 * S,
                     lambda mid, t, v, p: out.append((t, v))) == 2
    assert out == [(BASE + 60 * S, 3.0), (BASE + 2 * 60 * S, 7.0)]
    assert not e1._degraded


def test_columnar_handler_gets_the_round_in_one_call():
    """A flush_fn with handle_columnar receives the round's groups in ONE
    call; the values equal the per-datapoint shim's."""
    class Columnar:
        def __init__(self):
            self.calls = []

        def __call__(self, *a):
            raise AssertionError("per-datapoint path must not be used")

        def handle_columnar(self, groups):
            self.calls.append(groups)

    lists, lst = port_population(3)
    h = Columnar()
    lst.flush(BASE + 10 * 60 * S, h)
    assert len(h.calls) == 1
    rows = sorted((m, t, v) for ids, ts, vs, _p in h.calls[0]
                  for m, t, v in zip(ids, ts.tolist(), vs.tolist()))
    lists2, lst2 = port_population(3)
    shim = []
    lst2.flush(BASE + 10 * 60 * S, lambda m, t, v, p: shim.append((m, t, v)))
    assert len(rows) == len(shim)
    for a, b in zip(rows, sorted(shim)):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2], equal_nan=True)


# -- the reference's aggregator scenarios (tests/test_aggregator.py), run
#    on both packages: every emitted datapoint and counter equal --------

def _pkg(port: bool):
    """The classes a scenario drives, from the port or the reference; the
    port's Aggregator runs on the CPU."""
    import types

    if port:
        from m3_tpu_torch.aggregator import Aggregator as A
        from m3_tpu_torch.aggregator import CaptureHandler as C
        from m3_tpu_torch.aggregator.election import ElectionManager as EM
        from m3_tpu_torch.aggregator.flush import FlushTimesManager as FT
        from m3_tpu_torch.cluster.kv import MemStore
        from m3_tpu_torch.cluster.services import LeaderService as LS
        from m3_tpu_torch.metrics import aggregation as ma
        from m3_tpu_torch.metrics import metadata as md
        from m3_tpu_torch.metrics import metric as mm
        from m3_tpu_torch.metrics import pipeline as mp
        from m3_tpu_torch.metrics import policy as mpol
        from m3_tpu_torch.metrics import transformation as mt
        agg = lambda clock, **kw: A(clock=clock, device=CPU, **kw)  # noqa: E731
    else:
        from m3_tpu.aggregator import Aggregator as A
        from m3_tpu.aggregator import CaptureHandler as C
        from m3_tpu.aggregator.election import ElectionManager as EM
        from m3_tpu.aggregator.flush import FlushTimesManager as FT
        from m3_tpu.cluster.kv import MemStore
        from m3_tpu.cluster.services import LeaderService as LS
        from m3_tpu.metrics import aggregation as ma
        from m3_tpu.metrics import metadata as md
        from m3_tpu.metrics import metric as mm
        from m3_tpu.metrics import pipeline as mp
        from m3_tpu.metrics import policy as mpol
        from m3_tpu.metrics import transformation as mt
        agg = lambda clock, **kw: A(clock=clock, **kw)  # noqa: E731
    return types.SimpleNamespace(
        agg=agg, Capture=C, Election=EM, FlushTimes=FT, MemStore=MemStore,
        Leader=LS, magg=ma, md=md, MU=mm.MetricUnion, Op=mp.Op,
        Pipeline=mp.Pipeline, TT=mt.TransformType,
        ten=mpol.StoragePolicy.of("10s", "2d"),
        one=mpol.StoragePolicy.of("1m", "40d"))


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _meta(p, *pipelines):
    return (p.md.StagedMetadata(0, False, p.md.Metadata(tuple(pipelines))),)


def _pm(p, aggid=0, policies=None, pipe=None):
    return p.md.PipelineMetadata(aggid, policies or (p.ten,),
                                 pipe or p.Pipeline())


def _rows(cap):
    return [(m.id, m.time_nanos, m.value, str(m.storage_policy))
            for m in cap.metrics]


def _sc_windows(p):
    """Counter sum, gauge last, timer quantiles and suffixes, explicit
    aggregation types, two windows of one counter."""
    clock = _Clock(100 * S)
    a = p.agg(clock, num_shards=8, flush_handler=p.Capture())
    md = _meta(p, _pm(p))
    for v in (1, 2, 3):
        a.add_untimed(p.MU.counter(b"requests+service=api", v), md)
    for v in (0.3, 0.9, 0.5):
        a.add_untimed(p.MU.gauge(b"cpu+host=a", v), md)
    a.add_untimed(p.MU.batch_timer(b"latency", list(np.arange(1.0, 101.0))),
                  md)
    aggid = p.magg.AggID.compress([p.magg.AggType.MAX, p.magg.AggType.MEAN])
    for v in (5.0, 15.0, 10.0):
        a.add_untimed(p.MU.gauge(b"queue_depth", v), _meta(p, _pm(p, aggid)))
    a.add_untimed(p.MU.counter(b"w", 1), md)
    clock.t += 10 * S
    a.add_untimed(p.MU.counter(b"w", 2), md)
    clock.t += 10 * S
    n = a.flush()
    return n, _rows(a._flush_handler)


def _sc_fanout(p):
    """One sample into a 10s and a 1m elem (one elem per policy)."""
    clock = _Clock(600 * S)
    a = p.agg(clock, num_shards=8, flush_handler=p.Capture())
    for _ in range(6):
        a.add_untimed(p.MU.counter(b"hits", 1),
                      _meta(p, _pm(p, 0, (p.ten, p.one))))
        clock.t += 10 * S
    return a.flush(), _rows(a._flush_handler)


def _sc_pipelines(p):
    """PerSecond over a monotone counter; two gauges rolled up into one
    id through the local forwarded writer's second stage."""
    clock = _Clock(1000 * S)
    a = p.agg(clock, num_shards=8, flush_handler=p.Capture())
    pipe = p.Pipeline((p.Op.transform(p.TT.PERSECOND),))
    for v in (0, 100, 250):
        a.add_untimed(p.MU.counter(b"bytes_total", v),
                      _meta(p, _pm(p, 0, None, pipe)))
        clock.t += 10 * S
    roll = p.Pipeline((p.Op.roll(b"m3+all_latency", (b"region",),
                                 p.magg.AggID.compress([p.magg.AggType.SUM])),))
    last = p.magg.AggID.compress([p.magg.AggType.LAST])
    for mid, v in ((b"lat+svc=a", 10.0), (b"lat+svc=b", 20.0)):
        a.add_untimed(p.MU.gauge(mid, v), _meta(p, _pm(p, last, None, roll)))
    clock.t += 10 * S
    n1 = a.flush()
    clock.t += 10 * S
    n2 = a.flush()
    return n1, n2, a.forwarded_received, _rows(a._flush_handler)


def _sc_failover(p):
    """Leader flushes and a follower discards; the leader resigns and
    the promoted follower emits only windows after the persisted flush
    times (one of them a window the follower never discarded)."""
    store, clock = p.MemStore(), _Clock(100 * S)
    caps = (p.Capture(), p.Capture())
    aggs = []
    for inst, cap in zip("ab", caps):
        lead = p.Leader(store, "e", inst, lease_ttl_ns=30 * S, clock=clock)
        aggs.append(p.agg(clock, num_shards=8, flush_handler=cap,
                          election=p.Election(lead),
                          flush_times=p.FlushTimes(store, "ss")))
    md = _meta(p, _pm(p))
    for i in range(3):
        for a in aggs:
            a.add_untimed(p.MU.counter(b"ha", 1), md)
        clock.t += 10 * S
        aggs[0].flush()
        if i < 2:
            aggs[1].flush()
    aggs[0]._election.resign()
    clock.t += 31 * S
    aggs[1].add_untimed(p.MU.counter(b"ha", 1), md)
    clock.t += 10 * S
    aggs[1].flush()
    return (int(aggs[1]._election.state), _rows(caps[0]), _rows(caps[1]))


def _sc_multi_resolution(p):
    """Per-shard flush-time commits of two resolutions on two shards do
    not clobber each other; the follower holds nothing flushed."""
    store, clock = p.MemStore(), _Clock(600 * S)
    caps = (p.Capture(), p.Capture())
    aggs = []
    for inst, cap in zip("ab", caps):
        lead = p.Leader(store, "e", inst, lease_ttl_ns=3600 * S, clock=clock)
        aggs.append(p.agg(clock, num_shards=64, flush_handler=cap,
                          election=p.Election(lead),
                          flush_times=p.FlushTimes(store, "ss")))
    for _ in range(6):
        for a in aggs:
            a.add_untimed(p.MU.counter(b"fast-metric", 1), _meta(p, _pm(p)))
            a.add_untimed(p.MU.counter(b"slow-metric-2", 1),
                          _meta(p, _pm(p, 0, (p.one,))))
        clock.t += 10 * S
        for a in aggs:
            a.flush()
    held = sum(not e.is_empty() for s in aggs[1]._shards.values()
               for lst in s.lists.lists() for e in lst.elems())
    aggs[0]._election.resign()
    clock.t += S
    aggs[1].flush()
    return held, _rows(caps[0]), _rows(caps[1])


def _sc_entries(p):
    """Metadata changes at one cutover, a tombstoned stage, an unowned
    shard, a cutoff, the rate limit, idle-entry expiry and a re-added
    policy reviving a tombstoned elem."""
    clock = _Clock(600 * S)
    a = p.agg(clock, num_shards=8, flush_handler=p.Capture(),
              rate_limit_per_second=5)
    out = []
    md1, md2 = _meta(p, _pm(p)), _meta(p, _pm(p, 0, (p.ten, p.one)))
    a.add_untimed(p.MU.counter(b"m", 1), md1)
    for _ in range(5):
        clock.t += 10 * S
        a.add_untimed(p.MU.counter(b"m", 1), md2)
    dead = (p.md.StagedMetadata(0, True, p.md.Metadata()),)
    out.append(a.add_untimed(p.MU.counter(b"dead", 1), dead))
    out.append([a.add_untimed(p.MU.counter(b"noisy", 1), md1)
                for _ in range(10)])
    a.add_untimed(p.MU.counter(b"revive", 1), md2)
    a.add_untimed(p.MU.counter(b"revive", 1), _meta(p, _pm(p, 0, (p.one,))))
    a.add_untimed(p.MU.counter(b"revive", 1), md2)
    clock.t += 10 * S
    out.append(a.flush())
    a.add_untimed(p.MU.counter(b"revive", 5), md2)
    clock.t += 10 * S
    out.append(a.flush())
    sid = a.shard_for(b"some_metric")
    a.assign_shards([s for s in range(8) if s != sid])
    out.append(a.add_untimed(p.MU.counter(b"some_metric", 1), md1))
    out.append(a.writes_for_unowned_shard)
    a.assign_shards([])
    out.append(a.add_untimed(p.MU.counter(b"m", 1), md1))
    a.assign_shards(range(8))
    clock.t += 25 * 3600 * S
    a.add_untimed(p.MU.counter(b"new", 1), md1)
    out.append((a.tick(), a.num_entries()))
    return out, _rows(a._flush_handler)


SCENARIOS = {"windows": _sc_windows, "fanout": _sc_fanout,
             "pipelines": _sc_pipelines, "failover": _sc_failover,
             "multi_resolution": _sc_multi_resolution,
             "entries": _sc_entries}


def _canon(x):
    """Rows sorted (emission order across shards is not part of the
    contract), NaN made comparable."""
    if isinstance(x, list) and x and isinstance(x[0], tuple) and \
            len(x[0]) == 4:
        return sorted(((a, b, "nan" if c != c else c, d)
                       for a, b, c, d in x), key=repr)
    if isinstance(x, (list, tuple)):
        return type(x)(_canon(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_aggregator_scenario_equals_reference(name):
    """The reference's aggregator scenarios (tests/test_aggregator.py) on
    both packages: the same windows, counters, acceptances and emitted
    rows, bit for bit."""
    got = _canon(SCENARIOS[name](_pkg(True)))
    want = _canon(SCENARIOS[name](_pkg(False)))
    assert got == want
    assert any(isinstance(v, list) and v for v in want)
