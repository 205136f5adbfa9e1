"""Port of tests/test_observability.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py). The two `jit_builder` cases stay out:
that decorator times an XLA compile and the port has no such API (its
builds are timed by `telemetry.BuildTimed`). The bucket case encodes
through `tsz.encode_prepared`: the port's prepared inputs carry one int64
`v` where the reference's carry `vhi`/`vlo`.

End-to-end observability plane: distributed tracing (ids, sampling,
wire propagation, cross-process graft), per-span cost attribution from
QueryScope charges, the slow-query log's typed reasons, the self-scrape
pipeline (instrument snapshot -> own ingest -> PromQL), JAX runtime
telemetry, and the /debug surface satellites (snapshot-outside-lock,
capped background profiler)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from m3_tpu_torch.utils import tracing
from m3_tpu_torch.utils.tracing import (NOOP_SPAN, PROFILER, SLOW_QUERIES,
                                  ProfileRunner, SlowQueryLog, SpanContext,
                                  Tracer)
from test_torch_cpu_default import cpu_default  # noqa: F401

T0 = 1_700_000_000 * 1_000_000_000
S = 1_000_000_000


# ---------------------------------------------------------------- tracer core


class TestSpanIdentity:
    def test_root_gets_trace_and_span_ids(self):
        tr = Tracer(sample_rate=1.0)
        with tr.span("root") as root:
            assert root.trace_id > 0 and root.span_id > 0
            with tr.span("child") as c:
                assert c.trace_id == root.trace_id
                assert c.span_id != root.span_id
        d = tr.recent_traces()[-1]
        assert d["trace_id"] == root.trace_id
        assert d["children"][0]["trace_id"] == root.trace_id

    def test_context_wire_roundtrip_and_malformed(self):
        ctx = SpanContext(123, 456)
        assert SpanContext.from_wire(ctx.to_wire()) == ctx
        for bad in (None, 7, {"t": "x", "s": 1}, {"t": 1}, {"s": 2},
                    {"t": True, "s": 1}, []):
            assert SpanContext.from_wire(bad) is None

    def test_sampling_zero_yields_noop(self):
        tr = Tracer(sample_rate=0.0)
        sp = tr.span("never")
        assert sp is NOOP_SPAN
        with sp:
            assert tr.current() is None
        assert tr.recent_traces() == []

    def test_child_span_without_parent_is_noop(self):
        tr = Tracer(sample_rate=1.0)
        assert tr.child_span("bare") is NOOP_SPAN
        with tr.span("root"):
            real = tr.child_span("inner")
            assert real is not NOOP_SPAN
            with real:
                pass

    def test_span_from_remote_context(self):
        tr = Tracer(sample_rate=1.0)
        ctx = SpanContext(99, 11)
        with tr.span_from(ctx, "rpc.x") as sp:
            assert sp.trace_id == 99
            assert sp.remote_parent == 11
        d = tr.recent_traces(trace_id=99)
        assert d and d[-1]["remote_parent"] == 11
        assert tr.span_from(None, "rpc.x") is NOOP_SPAN

    def test_activate_propagates_across_threads(self):
        tr = Tracer(sample_rate=1.0)
        seen = {}

        with tr.span("root") as root:
            def worker():
                with tr.activate(root):
                    seen["cur"] = tr.current()
                    with tr.span("in-pool"):
                        pass
                seen["after"] = tr.current()

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen["cur"] is root
        assert seen["after"] is None
        d = tr.recent_traces()[-1]
        assert [c["name"] for c in d["children"]] == ["in-pool"]

    def test_attach_grafts_remote_dict(self):
        tr = Tracer(sample_rate=1.0)
        with tr.span("root") as root:
            root.attach({"name": "rpc.fetch", "trace_id": root.trace_id,
                         "tags": {"endpoint": "h:1"}})
        d = tr.recent_traces()[-1]
        assert d["children"][0]["name"] == "rpc.fetch"

    def test_collect_costs_rolls_up_subtree_and_grafts(self):
        """Review fix: cache events accrue on the INNERMOST span (a
        storage child, or a grafted remote dict) — the slow-query log's
        cold-cache classification reads the subtree rollup."""
        tr = Tracer(sample_rate=1.0)
        with tr.span("root") as root:
            root.add_cost("docs_matched", 5)
            with tr.span("child") as c:
                c.add_cost("block_cache_miss", 2)
            root.attach({"name": "rpc", "costs": {"bytes_read": 7},
                         "children": [{"name": "x",
                                       "costs": {"block_cache_miss": 1}}]})
        assert tracing.collect_costs(root) == {
            "docs_matched": 5, "block_cache_miss": 3, "bytes_read": 7}

    def test_slow_log_lazy_costs_only_evaluated_on_record(self):
        log = SlowQueryLog(threshold_ms=1.0)
        calls = []

        def expensive():
            calls.append(1)
            return {"block_cache_miss": 1}

        log.maybe("query", "fast", duration_ns=100, costs=expensive)
        assert calls == []  # under threshold: rollup never ran
        log.maybe("query", "slow", duration_ns=5_000_000, costs=expensive)
        assert calls == [1]
        assert log.entries()[-1]["reason"] == "cold-cache"

    def test_costs_accumulate(self):
        tr = Tracer(sample_rate=1.0)
        with tr.span("root") as root:
            root.add_cost("bytes_read", 10)
            root.add_cost("bytes_read", 5)
        assert tr.recent_traces()[-1]["costs"] == {"bytes_read": 15}


# ------------------------------------------------------------ slow-query log


class TestSlowQueryLog:
    def test_threshold_and_typed_reasons(self):
        log = SlowQueryLog(threshold_ms=1.0, maxlen=8)
        log.maybe("query", "fast", duration_ns=10_000)  # under threshold
        log.maybe("query", "slow_one", duration_ns=5_000_000)
        log.maybe("query", "shed", duration_ns=10, reason="limit-shed")
        log.maybe("query", "dead", duration_ns=10, reason="deadline")
        entries = log.entries()
        assert [e["name"] for e in entries] == ["slow_one", "shed", "dead"]
        assert [e["reason"] for e in entries] == ["slow", "limit-shed",
                                                 "deadline"]

    def test_cold_cache_reason_from_costs(self):
        log = SlowQueryLog(threshold_ms=0.0)
        log.maybe("query", "q", duration_ns=1,
                  costs={"block_cache_miss": 2, "bytes_read": 5})
        log.maybe("query", "warm", duration_ns=1, costs={"bytes_read": 5})
        assert log.entries()[0]["reason"] == "cold-cache"
        assert log.entries()[1]["reason"] == "slow"

    def test_ring_bounded(self):
        log = SlowQueryLog(threshold_ms=0.0, maxlen=4)
        for i in range(10):
            log.maybe("rpc", f"m{i}", duration_ns=1)
        assert len(log.entries()) == 4
        assert log.entries()[-1]["name"] == "m9"


# --------------------------------------------------- cross-process span trees


def _node_with_data():
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.rpc import NodeServer, NodeService
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    db = Database(ShardSet(2), clock=lambda: T0)
    db.mark_bootstrapped()
    db.ensure_namespace(b"obs", NamespaceOptions(index_enabled=True,
                                                 writes_to_commitlog=False))
    for i in range(6):
        db.write(b"obs", b"s-%02d" % i, T0 - (6 - i) * S, float(i),
                 tags={b"__name__": b"m", b"host": b"h%02d" % i})
    return NodeServer(NodeService(db), port=0).start()


class TestCrossProcessTrace:
    def test_rpc_span_grafted_with_costs_and_storage_children(self):
        from m3_tpu_torch.client.session import HostClient
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.rpc import wire

        srv = _node_with_data()
        hc = HostClient(srv.endpoint, timeout=5)
        try:
            with tracing.TRACER.span("test.root") as root:
                r = hc.call("fetch_tagged", ns=b"obs",
                            query=wire.query_to_wire(iq.AllQuery()),
                            start_ns=0, end_ns=2**62)
                assert len(r["series"]) == 6
                grafted = [c for c in root.children if isinstance(c, dict)]
            assert grafted, "no server span grafted"
            sp = grafted[0]
            assert sp["name"] == "rpc.fetch_tagged"
            assert sp["trace_id"] == root.trace_id
            assert sp["remote_parent"] == root.span_id
            assert sp["tags"]["endpoint"] == srv.endpoint
            # per-span QueryScope cost attribution rode the graft
            assert sp["costs"]["series_fetched"] == 6
            assert sp["costs"]["docs_matched"] >= 6
            assert sp["costs"]["bytes_read"] > 0
            # dbnode-side storage child (index query) inside the rpc span
            names = [c["name"] for c in sp.get("children", [])]
            assert "index.query" in names
        finally:
            hc.close()
            srv.close()

    def test_unsampled_request_attaches_no_context(self):
        from m3_tpu_torch.client.session import HostClient

        srv = _node_with_data()
        hc = HostClient(srv.endpoint, timeout=5)
        try:
            before = len(tracing.TRACER.recent_traces())
            assert hc.call("health")["ok"]  # no active span -> no "tr"
            after = [d for d in tracing.TRACER.recent_traces()[before:]
                     if d["name"].startswith("rpc.")]
            assert after == []
        finally:
            hc.close()
            srv.close()

    def test_session_fetch_tagged_one_tree_three_hops(self):
        from m3_tpu_torch.client.session import Session, SessionOptions
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.testing.cluster import ClusterHarness

        harness = ClusterHarness(n_nodes=2, replica_factor=2, num_shards=4)
        session = Session(harness.topology, SessionOptions(timeout_s=10))
        try:
            t0 = harness.clock.now_ns
            session.write_batch(
                b"default", [b"a", b"b"], np.array([t0 - S] * 2, np.int64),
                np.array([1.0, 2.0]),
                tags=[{b"__name__": b"mm"}, {b"__name__": b"mm"}])
            with tracing.TRACER.span("test.query") as root:
                out = session.fetch_tagged(b"default", iq.AllQuery(),
                                           0, 2**62)
                assert len(out) == 2
            d = root.to_dict()
            client = d["children"][0]
            assert client["name"] == "client.fetch_tagged"
            grafts = [c for c in client.get("children", [])
                      if c.get("name") == "rpc.fetch_tagged"]
            assert grafts, "no dbnode spans under the client fanout span"
            # one trace id across client + every grafted dbnode span
            assert {g["trace_id"] for g in grafts} == {root.trace_id}
            endpoints = {g["tags"]["endpoint"] for g in grafts}
            assert len(endpoints) == 2  # both replicas traced
        finally:
            session.close()
            harness.close()

    def test_gate_shed_logs_empty_costs_not_previous_requests(self):
        """Review fix: a request shed by the admission gate BEFORE its
        QueryScope runs must log empty costs — not the previous
        request's totals left on this reused serving thread."""
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.rpc import wire
        from m3_tpu_torch.rpc.node_server import NodeService
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions
        from m3_tpu_torch.utils.health import AdmissionGate, HealthTracker
        from m3_tpu_torch.utils.limits import ResourceExhausted

        db = Database(ShardSet(2), clock=lambda: T0)
        db.mark_bootstrapped()
        db.ensure_namespace(b"obs", NamespaceOptions(index_enabled=True))
        db.write(b"obs", b"g-0", T0, 1.0, tags={b"__name__": b"m"})
        gate = AdmissionGate(capacity=2, name="",
                             tracker=HealthTracker())
        svc = NodeService(db, gate=gate)
        q = wire.query_to_wire(iq.AllQuery())
        # Request A charges real costs on this thread.
        svc.dispatch("fetch_tagged",
                     {"ns": b"obs", "query": q, "start_ns": 0,
                      "end_ns": 2**62})
        # Fill the gate so request B sheds BEFORE its scope runs.
        gate.admit(2)
        SLOW_QUERIES.clear()
        try:
            with pytest.raises(ResourceExhausted):
                svc.dispatch("fetch_tagged",
                             {"ns": b"obs", "query": q, "start_ns": 0,
                              "end_ns": 2**62})
        finally:
            gate.release(2)
        sheds = [e for e in SLOW_QUERIES.entries()
                 if e["reason"] == "limit-shed"]
        assert sheds and sheds[-1]["costs"] == {}

    def test_slow_log_limit_shed_reason_from_rpc(self):
        from m3_tpu_torch.client.session import HostClient
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.rpc import NodeServer, NodeService, wire
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions
        from m3_tpu_torch.utils.limits import (LimitOptions, QueryLimits,
                                         ResourceExhausted)

        db = Database(ShardSet(2), clock=lambda: T0)
        db.mark_bootstrapped()
        db.ensure_namespace(b"obs", NamespaceOptions(index_enabled=True))
        for i in range(20):
            db.write(b"obs", b"x-%02d" % i, T0, 1.0,
                     tags={b"__name__": b"m"})
        limits = QueryLimits(docs_matched=LimitOptions(per_second=5))
        srv = NodeServer(NodeService(db, limits=limits), port=0).start()
        hc = HostClient(srv.endpoint, timeout=5)
        SLOW_QUERIES.clear()
        try:
            with pytest.raises(ResourceExhausted):
                hc.call("fetch_tagged", ns=b"obs",
                        query=wire.query_to_wire(iq.AllQuery()),
                        start_ns=0, end_ns=2**62)
            sheds = [e for e in SLOW_QUERIES.entries()
                     if e["reason"] == "limit-shed"]
            assert sheds and sheds[-1]["kind"] == "rpc"
        finally:
            hc.close()
            srv.close()


# ------------------------------------------------------- scope cost tagging


class TestScopeCostTagging:
    def test_scope_exit_annotates_active_span(self):
        from m3_tpu_torch.utils import limits as xlimits

        ql = xlimits.QueryLimits()
        with tracing.TRACER.span("q") as sp:
            with ql.scope("test"):
                xlimits.charge("docs_matched", 7)
                xlimits.charge("bytes_read", 100)
                xlimits.charge("docs_matched", 3)
        assert sp.costs["docs_matched"] == 10
        assert sp.costs["bytes_read"] == 100
        # thread-local totals readable after exit (slow-log source)
        assert xlimits.last_scope_totals()["docs_matched"] == 10


# ----------------------------------------------------------- self-scrape


def _embedded():
    from m3_tpu_torch.cluster import kv as cluster_kv
    from m3_tpu_torch.coordinator import run_embedded
    from m3_tpu_torch.index.namespace_index import NamespaceIndex
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    now = {"t": T0}
    db = Database(ShardSet(4), clock=lambda: now["t"])
    db.create_namespace(b"default", NamespaceOptions(),
                        index=NamespaceIndex(clock=lambda: now["t"]))
    coord = run_embedded(db, kv_store=cluster_kv.MemStore(),
                         clock=lambda: now["t"])
    return coord, now


class TestSelfScrape:
    def test_traffic_counter_round_trip_via_promql(self):
        """THE acceptance criterion: an instrument counter incremented
        by real traffic is readable back through the PromQL query path
        against the platform's own storage."""
        from m3_tpu_torch.coordinator.selfscrape import SelfScraper
        from m3_tpu_torch.utils.instrument import ROOT

        coord, now = _embedded()
        try:
            coord.writer.write({b"__name__": b"real"}, T0 - 30 * S, 1.0)
            coord.engine.execute_range("real", T0 - 60 * S, T0, 10 * S)
            executed = ROOT.snapshot()["query.executed"]
            scraper = SelfScraper(coord.writer, clock=lambda: now["t"])
            assert scraper.scrape_once() > 0
            blk = coord.engine.execute_instant("query_executed", T0 + 1)
            assert blk.n_series == 1
            assert blk.values[0][-1] >= executed
            # constant labels identify the scraped process
            assert blk.series_tags[0].get(b"role") == b"coordinator"
        finally:
            coord.close()

    def test_snapshot_delta_skips_unchanged(self):
        from m3_tpu_torch.coordinator.selfscrape import SelfScraper

        coord, now = _embedded()
        try:
            coord.writer.write({b"__name__": b"real"}, T0 - 30 * S, 1.0)
            scraper = SelfScraper(coord.writer, clock=lambda: now["t"])
            first = scraper.scrape_once()
            assert first > 0
            # a second immediate scrape only re-emits what the FIRST
            # scrape itself moved (its own ingest counters), a strict
            # subset of the full registry
            second = scraper.scrape_once()
            assert second < first
        finally:
            coord.close()

    def test_histogram_emits_le_buckets(self):
        from m3_tpu_torch.coordinator.selfscrape import SelfScraper

        coord, now = _embedded()
        try:
            coord.writer.write({b"__name__": b"real"}, T0 - 30 * S, 1.0)
            coord.engine.execute_range("real", T0 - 60 * S, T0, 10 * S)
            SelfScraper(coord.writer,
                        clock=lambda: now["t"]).scrape_once()
            blk = coord.engine.execute_instant(
                'query_latency_s_bucket{le="+Inf"}', T0 + 1)
            assert blk.n_series >= 1
            cnt = coord.engine.execute_instant("query_latency_s_count",
                                               T0 + 1)
            assert cnt.n_series == 1 and cnt.values[0][-1] >= 1
        finally:
            coord.close()

    def test_shed_value_reemits_next_pass(self):
        """Review fix: a value whose write was shed must NOT be marked
        done — if it then stays flat, the next pass re-emits it (the
        'levels, nothing is lost' contract)."""
        from m3_tpu_torch.coordinator.selfscrape import SelfScraper
        from m3_tpu_torch.utils.instrument import Scope

        root = Scope()
        root.counter("stuck").inc(5)

        class FlakyWriter:
            def __init__(self):
                self.fail_first = True
                self.names = []

            def write(self, tags, t_ns, value):
                if self.fail_first:
                    self.fail_first = False
                    raise ConnectionError("down")
                self.names.append(tags[b"__name__"])

        w = FlakyWriter()
        scraper = SelfScraper(w, clock=lambda: T0, scope=root)
        scraper.scrape_once()
        assert b"stuck" not in w.names  # first emit was shed
        scraper.scrape_once()           # value unchanged — must re-emit
        assert b"stuck" in w.names

    def test_shed_scrape_survives(self):
        """A writer that sheds (Backpressure) must not kill the scrape:
        errors count, the pass completes, levels re-emit next pass."""
        from m3_tpu_torch.coordinator.selfscrape import SelfScraper
        from m3_tpu_torch.utils.limits import Backpressure

        class SheddingWriter:
            def __init__(self):
                self.n = 0

            def write(self, tags, t_ns, value):
                self.n += 1
                if self.n % 2:
                    raise Backpressure("shed")

        w = SheddingWriter()
        scraper = SelfScraper(w, clock=lambda: T0)
        scraper.scrape_once()
        assert scraper.errors > 0
        assert w.n > 0


# ------------------------------------------------------------- telemetry


class TestTelemetry:
    def test_shape_bucket_hit_miss(self):
        from m3_tpu_torch.parallel import telemetry
        from m3_tpu_torch.utils.instrument import ROOT

        key = ("test-path", (64, 32, int(time.monotonic_ns())))
        before = ROOT.snapshot().get("telemetry.shape_bucket.misses", 0)
        telemetry.record_bucket(*key)
        telemetry.record_bucket(*key)
        snap = ROOT.snapshot()
        assert snap["telemetry.shape_bucket.misses"] == before + 1
        assert snap["telemetry.shape_bucket.hits"] >= 1

    def test_transfer_counters_and_span_costs(self):
        from m3_tpu_torch.parallel import telemetry
        from m3_tpu_torch.utils.instrument import ROOT

        before = ROOT.snapshot().get("telemetry.transfer.h2d_bytes", 0)
        with tracing.TRACER.span("xfer") as sp:
            telemetry.count_h2d(1024)
            telemetry.count_d2h(2048)
        snap = ROOT.snapshot()
        assert snap["telemetry.transfer.h2d_bytes"] == before + 1024
        assert sp.costs == {"h2d_bytes": 1024, "d2h_bytes": 2048}

    def test_decode_records_bucket(self):
        from m3_tpu_torch.client.decode import decode_segment_groups
        from m3_tpu_torch.ops import tsz
        from m3_tpu_torch.utils.instrument import ROOT

        ts = np.arange(T0, T0 + 5 * S, S, np.int64)
        vals = np.arange(5, dtype=np.float64)
        inp = tsz.prepare_encode_inputs(ts[None, :], vals[None, :],
                                        np.array([5], np.int32))
        words, nbits = tsz.encode_prepared(inp, max_words=64)
        seg = {"bs": T0, "words": np.asarray(words[0]),
               "nbits": int(nbits[0]), "npoints": 5, "window": 8,
               "time_unit": 4}
        before = ROOT.snapshot().get("telemetry.shape_bucket.misses", 0)
        out = decode_segment_groups([seg])
        np.testing.assert_array_equal(out[0][1], vals)
        after = ROOT.snapshot()["telemetry.shape_bucket.misses"]
        assert after >= before  # first geometry may or may not be new
        snap = ROOT.snapshot()
        assert (snap.get("telemetry.shape_bucket.misses{path=client.decode}",
                         0)
                + snap.get("telemetry.shape_bucket.hits{path=client.decode}",
                           0)) >= 1


# ------------------------------------------------- /debug surface satellites


class TestInstrumentSnapshotLock:
    def test_snapshot_does_not_hold_root_lock_over_metric_snapshots(self):
        """Satellite: Scope.snapshot copies refs under the registry lock
        and snapshots outside it — a Histogram whose snapshot itself
        touches the registry (nested root-lock acquisition, guaranteed
        deadlock pre-fix on the non-reentrant Lock) must complete."""
        from m3_tpu_torch.utils.instrument import Scope

        root = Scope()
        h = root.histogram("lat")
        h.record(0.5)
        orig = h.snapshot

        def reentrant_snapshot():
            root.counter("probe").inc()  # takes the root registry lock
            return orig()

        h.snapshot = reentrant_snapshot
        done = {}

        def run():
            done["snap"] = root.snapshot()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=5)
        assert "snap" in done, "snapshot deadlocked on the registry lock"
        assert done["snap"]["lat"]["count"] == 1

    def test_histogram_snapshot_consistent_under_writes(self):
        from m3_tpu_torch.utils.instrument import Histogram

        h = Histogram()
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                h.record(0.01)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            for _ in range(200):
                snap = h.snapshot()
                assert sum(snap["buckets"].values()) == snap["count"]
        finally:
            stop.set()
            t.join()


class TestProfileRunner:
    def test_hard_cap_bounds_the_request(self):
        runner = ProfileRunner(max_seconds=0.3)
        t0 = time.perf_counter()
        out = runner.run(seconds=30.0, hz=50)
        assert time.perf_counter() - t0 < 2.0
        assert isinstance(out, list)

    def test_concurrent_requests_share_one_window(self):
        runner = ProfileRunner(max_seconds=0.5)
        results = []

        def req():
            results.append(runner.run(seconds=0.4, hz=100))

        threads = [threading.Thread(target=req) for _ in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # 4 requests of 0.4s each sharing one window: far under 4x serial
        assert time.perf_counter() - t0 < 1.5
        assert runner.shared >= 1
        assert len(results) == 4

    def test_default_runner_profiles(self):
        stop = threading.Event()

        def hot_loop_for_runner():
            x = 0
            while not stop.is_set():
                x += 1

        t = threading.Thread(target=hot_loop_for_runner)
        t.start()
        try:
            out = PROFILER.run(seconds=0.3, hz=200)
        finally:
            stop.set()
            t.join()
        assert "hot_loop_for_runner" in json.dumps(out)


# ---------------------------------------------------- msg / kv propagation


class TestMsgKvPropagation:
    def test_producer_consumer_joins_trace(self):
        from m3_tpu_torch.msg.consumer import Consumer
        from m3_tpu_torch.msg.producer import Producer
        from m3_tpu_torch.msg.topic import ConsumerService, ConsumptionType, Topic
        from m3_tpu_torch.cluster.placement import Instance, initial_placement

        got = threading.Event()
        consumer = Consumer(lambda shard, val: got.set(), ack_batch=1)
        consumer.start()
        placement = initial_placement(
            [Instance(id="c0", endpoint=consumer.endpoint)], num_shards=1,
            replica_factor=1)
        topic = Topic("t", 1, [ConsumerService("svc",
                                               ConsumptionType.SHARED)])
        producer = Producer(topic, {"svc": lambda: placement})
        try:
            with tracing.TRACER.span("publish.root") as root:
                producer.publish(0, b"payload")
            assert got.wait(5.0)
            deadline = time.monotonic() + 5.0
            consumed = []
            while time.monotonic() < deadline and not consumed:
                consumed = [d for d in tracing.TRACER.recent_traces(
                    trace_id=root.trace_id) if d["name"] == "msg.consume"]
                time.sleep(0.01)
            assert consumed, "consumer span did not join the trace"
            assert consumed[-1]["remote_parent"] == root.span_id
        finally:
            producer.close()
            consumer.close()

    def test_kv_ops_graft_server_span(self):
        from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore

        srv = KVServer().start()
        store = RemoteStore(srv.endpoint)
        try:
            with tracing.TRACER.span("kv.root") as root:
                store.set("k", b"v")
                assert store.get("k").data == b"v"
            grafted = [c for c in root.children if isinstance(c, dict)]
            names = {g["name"] for g in grafted}
            assert "kv.set" in names and "kv.get" in names
            assert all(g["trace_id"] == root.trace_id for g in grafted)
        finally:
            store.close()
            srv.close()


# -------------------------------------------------------- HTTP debug surface


class TestHTTPSurface:
    def test_coordinator_debug_traces_slow_and_trace_filter(self):
        coord, now = _embedded()
        try:
            old = SLOW_QUERIES.threshold_ns
            SLOW_QUERIES.threshold_ns = 0
            try:
                coord.writer.write({b"__name__": b"real"}, T0 - 30 * S, 1.0)
                coord.engine.execute_range("real", T0 - 60 * S, T0, 10 * S)
            finally:
                SLOW_QUERIES.threshold_ns = old
            d = json.load(urllib.request.urlopen(
                coord.endpoint + "/debug/traces"))
            assert "slow" in d
            entry = [e for e in d["slow"] if e["name"] == "real"][-1]
            assert entry["reason"] in ("slow", "cold-cache")
            assert entry["costs"].get("datapoints_decoded", 0) >= 1
            roots = [t for t in d["traces"]
                     if t["name"] == "query.execute_range"]
            tid = roots[-1]["trace_id"]
            filtered = json.load(urllib.request.urlopen(
                coord.endpoint + f"/debug/traces?trace_id={tid}"))
            assert all(t["trace_id"] == tid for t in filtered["traces"])
        finally:
            coord.close()

    def test_http_trace_header_ingress(self):
        coord, now = _embedded()
        try:
            req = urllib.request.Request(coord.endpoint + "/health")
            req.add_header("X-M3-Trace", "777:42")
            urllib.request.urlopen(req)
            spans = tracing.TRACER.recent_traces(trace_id=777)
            assert spans and spans[-1]["name"].startswith("http.GET")
            assert spans[-1]["remote_parent"] == 42
        finally:
            coord.close()

    def test_dbnode_httpjson_debug_surface(self):
        from m3_tpu_torch.rpc.httpjson import HTTPJSONServer
        from m3_tpu_torch.rpc.node_server import NodeService
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database

        db = Database(ShardSet(2), clock=lambda: T0)
        db.mark_bootstrapped()
        srv = HTTPJSONServer(NodeService(db)).start()
        try:
            dvars = json.load(urllib.request.urlopen(
                srv.endpoint + "/debug/vars"))
            assert "metrics" in dvars
            traces = json.load(urllib.request.urlopen(
                srv.endpoint + "/debug/traces"))
            assert "traces" in traces and "slow" in traces
            prof = json.load(urllib.request.urlopen(
                srv.endpoint + "/debug/pprof/profile?seconds=0.1"))
            assert "profile" in prof
            # malformed params answer a typed 400, never a dropped conn
            try:
                urllib.request.urlopen(
                    srv.endpoint + "/debug/pprof/profile?seconds=abc")
                assert False, "expected HTTP 400"
            except urllib.error.HTTPError as e:
                assert e.code == 400
            stacks = urllib.request.urlopen(
                srv.endpoint + "/debug/pprof/threads").read().decode()
            assert "--- thread" in stacks
        finally:
            srv.close()
