"""Port of tests/test_overload.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py). The raw-TCP shedding stub aggregator
has a `device`, which the port's server reads to place itself.

Overload-protection tests: query limits (sliding windows + enforcer
parent/child budgets), ingest admission control with priority shedding,
the degradation state machine, typed ResourceExhausted over the wire,
and the seeded open-loop load generator (reference test model:
src/dbnode/storage/limits/query_limits_test.go + x/cost enforcer tests;
shedding discipline per "The Tail at Scale" / DAGOR)."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from m3_tpu_torch.utils import limits as xlimits
from m3_tpu_torch.utils.cost import CostLimitExceeded, Enforcer
from m3_tpu_torch.utils.health import (
    DEGRADED,
    OK,
    SHEDDING,
    AdmissionGate,
    HealthTracker,
    Priority,
)
from m3_tpu_torch.utils.limits import (
    Backpressure,
    LimitOptions,
    QueryLimits,
    ResourceExhausted,
    SlidingWindow,
)
from m3_tpu_torch.utils.retry import DeadlineExceeded, default_is_retryable
from test_torch_cpu_default import cpu_default  # noqa: F401

NS = b"t"


@pytest.fixture(autouse=True)
def _isolated_global_limits():
    """Every test sees a fresh (unlimited) global registry; the previous
    one is restored so this suite cannot leak limits into other files."""
    prev = xlimits.set_global(xlimits.QueryLimits())
    yield
    xlimits.set_global(prev)


# ------------------------------------------------------------- cost enforcer


class TestEnforcerRelease:
    def test_release_none_credits_parent(self):
        """THE regression: release(None) zeroed the child but never
        credited the parent, permanently leaking global budget per
        completed query (pre-fix, parent.current() stayed 30 here)."""
        parent = Enforcer(limit=100, name="global")
        child = parent.child(50, name="query")
        child.add(30)
        assert parent.current() == 30
        child.release(None)
        assert child.current() == 0
        assert parent.current() == 0, "release(None) leaked the parent budget"

    def test_release_none_after_partial_release(self):
        parent = Enforcer(limit=100)
        child = parent.child(50)
        child.add(40)
        child.release(15)
        assert parent.current() == 25
        child.release(None)  # remaining 25
        assert child.current() == 0 and parent.current() == 0

    def test_explicit_release_unchanged(self):
        parent = Enforcer(limit=100)
        child = parent.child(50)
        child.add(10)
        child.release(10)
        assert child.current() == 0 and parent.current() == 0

    def test_release_none_through_grandparent_chain(self):
        grand = Enforcer(limit=1000)
        parent = grand.child(100)
        child = parent.child(50)
        child.add(20)
        assert grand.current() == 20
        child.release(None)
        assert (child.current(), parent.current(), grand.current()) == (0, 0, 0)

    def test_rejected_add_rolls_back_every_level(self):
        parent = Enforcer(limit=25)
        child = parent.child(None)
        child.add(20)
        with pytest.raises(CostLimitExceeded):
            child.add(10)  # parent rejects
        assert child.current() == 20 and parent.current() == 20


class TestEnforcerConcurrency:
    def test_sixteen_thread_hammer_never_negative_never_leaks(self):
        """16 threads interleave add/release on children of one parent:
        current() must never go negative mid-flight and must settle at
        exactly zero (no lost or doubled credit)."""
        parent = Enforcer(limit=None, name="global")
        negatives = []
        errors = []

        def hammer(i):
            child = parent.child(None, name=f"w{i}")
            try:
                for _ in range(500):
                    child.add(3)
                    if parent.current() < 0 or child.current() < 0:
                        negatives.append(i)
                    child.release(1)
                    child.release(None)  # the remaining 2
            except Exception as e:  # noqa: BLE001 — surface in main thread
                errors.append(e)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert not negatives, "current() observed negative under contention"
        assert parent.current() == 0

    def test_limited_parent_contention_settles_zero(self):
        parent = Enforcer(limit=48, name="global")

        def worker():
            child = parent.child(None)
            for _ in range(300):
                try:
                    child.add(2)
                except CostLimitExceeded:
                    continue
                child.release(None)

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert parent.current() == 0


# ----------------------------------------------------------- sliding windows


class TestSlidingWindow:
    def test_exact_expiry_after_idle_second(self):
        """Saturate, idle one window, and the whole budget must be back:
        no stuck saturation (the property the reference gets from its
        per-second reset ticker)."""
        t = [0.0]
        w = SlidingWindow(100, clock=lambda: t[0])
        assert w.try_charge(100)
        assert not w.try_charge(1)
        t[0] = 1.0001
        assert w.current() == 0
        assert w.try_charge(100)

    def test_buckets_expire_individually(self):
        t = [0.0]
        w = SlidingWindow(100, buckets=10, clock=lambda: t[0])
        w.try_charge(60)
        t[0] = 0.5
        w.try_charge(40)
        assert not w.try_charge(1)
        # the first bucket (60) leaves the window before the second does
        t[0] = 1.05
        assert w.current() == 40
        assert w.try_charge(60)
        assert not w.try_charge(1)

    def test_refused_charge_consumes_nothing(self):
        t = [0.0]
        w = SlidingWindow(10, clock=lambda: t[0])
        w.try_charge(8)
        assert not w.try_charge(5)
        assert w.current() == 8
        assert w.try_charge(2)

    def test_property_window_sum_matches_reference(self):
        """Seeded random charge/advance sequence: the window total must
        equal a brute-force sum of charges inside the trailing window
        (quantized to bucket granularity) at every step."""
        import random

        rng = random.Random(1234)
        t = [0.0]
        w = SlidingWindow(10_000, buckets=10, clock=lambda: t[0])
        accepted = []  # (time, n)
        bucket_s = w.window_s / 10
        for _ in range(500):
            t[0] += rng.random() * 0.3
            n = rng.randint(1, 400)
            if w.try_charge(n):
                accepted.append((t[0], n))
            now_bucket = int(t[0] / bucket_s)
            floor = (now_bucket - 10 + 1) * bucket_s
            expect = sum(x for ts, x in accepted
                         if int(ts / bucket_s) * bucket_s >= floor)
            assert w.current() == expect

    def test_rejects_nonpositive_limit(self):
        with pytest.raises(ValueError):
            SlidingWindow(0)


# -------------------------------------------------------------- query limits


class TestQueryLimits:
    def test_scope_releases_concurrent_budget(self):
        ql = QueryLimits(docs_matched=LimitOptions(concurrent=100))
        with ql.scope("q") as s:
            s.charge("docs_matched", 60)
            assert ql.enforcer("docs_matched").current() == 60
        assert ql.enforcer("docs_matched").current() == 0

    def test_per_query_cap_spares_the_process(self):
        ql = QueryLimits(docs_matched=LimitOptions(concurrent=1000,
                                                   per_query=50))
        with ql.scope("greedy") as s:
            with pytest.raises(ResourceExhausted):
                s.charge("docs_matched", 51)
            s.charge("docs_matched", 50)  # within the per-query cap
        assert ql.enforcer("docs_matched").current() == 0

    def test_thousand_rejected_queries_leak_nothing(self):
        """The acceptance bar: budget fully released after 1k rejected
        queries (every add that raised was rolled back; every scope exit
        credited the chain)."""
        ql = QueryLimits(series_fetched=LimitOptions(concurrent=10))
        for _ in range(1000):
            with pytest.raises(ResourceExhausted):
                with ql.scope("q") as s:
                    s.charge("series_fetched", 5)
                    s.charge("series_fetched", 50)  # rejected
        assert ql.enforcer("series_fetched").current() == 0

    def test_enforcer_rejection_leaves_no_phantom_window_load(self):
        """A charge the enforcer rejects must not consume window budget:
        a retry storm of rejected queries cannot poison the next second
        for unrelated queries."""
        t = [0.0]
        ql = QueryLimits(clock=lambda: t[0],
                         docs_matched=LimitOptions(per_second=1000,
                                                   concurrent=10))
        for _ in range(100):
            with pytest.raises(ResourceExhausted):
                with ql.scope("q") as s:
                    s.charge("docs_matched", 50)  # enforcer rejects (>10)
        with ql.scope("ok") as s:
            s.charge("docs_matched", 10)  # window must be pristine
        lim = ql._limits["docs_matched"]
        assert lim.window.current() == 10

    def test_window_rejection_releases_enforcer_charge(self):
        ql = QueryLimits(docs_matched=LimitOptions(per_second=5,
                                                   concurrent=1000))
        with ql.scope("q") as s:
            with pytest.raises(ResourceExhausted):
                s.charge("docs_matched", 50)  # window rejects
            assert s.current("docs_matched") == 0
        assert ql.enforcer("docs_matched").current() == 0

    def test_window_shared_across_scopes(self):
        t = [0.0]
        ql = QueryLimits(clock=lambda: t[0],
                         docs_matched=LimitOptions(per_second=100))
        with ql.scope("a") as s:
            s.charge("docs_matched", 80)
        with ql.scope("b") as s:
            with pytest.raises(ResourceExhausted):
                s.charge("docs_matched", 30)
        t[0] = 1.1
        with ql.scope("c") as s:
            s.charge("docs_matched", 100)

    def test_module_charge_routes_to_installed_scope(self):
        ql = QueryLimits(bytes_read=LimitOptions(concurrent=100))
        with ql.scope("q"):
            xlimits.charge("bytes_read", 40)
            assert ql.enforcer("bytes_read").current() == 40
        assert ql.enforcer("bytes_read").current() == 0

    def test_scopeless_charge_hits_global_window(self):
        t = [0.0]
        prev = xlimits.set_global(QueryLimits(
            clock=lambda: t[0],
            series_fetched=LimitOptions(per_second=10)))
        try:
            xlimits.charge("series_fetched", 10)
            with pytest.raises(ResourceExhausted):
                xlimits.charge("series_fetched", 1)
        finally:
            xlimits.set_global(prev)

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            QueryLimits(bogus=LimitOptions(per_second=1))

    def test_saturation_tracks_in_flight(self):
        ql = QueryLimits(datapoints_decoded=LimitOptions(concurrent=100))
        assert ql.saturation() == 0.0
        with ql.scope("q") as s:
            s.charge("datapoints_decoded", 80)
            assert ql.saturation() == pytest.approx(0.8)
        assert ql.saturation() == 0.0

    def test_resource_exhausted_is_retryable_deadline_is_not(self):
        assert default_is_retryable(ResourceExhausted("shed"))
        assert default_is_retryable(Backpressure("shed"))
        assert not default_is_retryable(DeadlineExceeded("late"))


# ---------------------------------------------------------- admission gating


class TestAdmissionGate:
    def _gate(self, capacity=4, high=0.5):
        return AdmissionGate(capacity, high_watermark=high,
                             tracker=HealthTracker())

    def test_watermark_shed_order(self):
        g = self._gate()  # capacity 4, high watermark 2
        assert g.try_admit(2, Priority.BULK)
        assert not g.try_admit(1, Priority.BULK)      # past high: bulk shed
        assert g.try_admit(2, Priority.NORMAL)        # up to capacity
        assert not g.try_admit(1, Priority.NORMAL)    # at capacity: shed
        assert g.try_admit(1, Priority.CRITICAL)      # never shed
        assert g.depth() == 5
        assert g.shed == {"critical": 0, "normal": 1, "bulk": 1}

    def test_release_restores_admission(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL)
        with pytest.raises(Backpressure):
            g.admit(1, Priority.NORMAL)
        g.release(3)
        g.admit(1, Priority.BULK)  # depth 2 == high watermark again
        assert g.depth() == 2

    def test_held_releases_on_exception(self):
        g = self._gate()
        with pytest.raises(RuntimeError):
            with g.held(2, Priority.NORMAL):
                assert g.depth() == 2
                raise RuntimeError("boom")
        assert g.depth() == 0

    def test_max_depth_records_high_water(self):
        g = self._gate()
        with g.held(3):
            pass
        assert g.depth() == 0 and g.max_depth() == 3

    def test_rejects_nonpositive_capacity(self):
        with pytest.raises(ValueError):
            AdmissionGate(0, tracker=HealthTracker())

    def test_oversized_request_admitted_when_idle(self):
        """Semaphore convention: one request larger than the whole budget
        runs ALONE on an idle gate — otherwise an oversized batch frame
        would be deterministically shed forever."""
        g = self._gate(capacity=4)
        assert g.try_admit(100, Priority.NORMAL)   # idle: runs alone
        assert not g.try_admit(1, Priority.NORMAL)  # but nothing joins it
        g.release(100)
        g.admit(1, Priority.NORMAL)
        assert not g.try_admit(100, Priority.BULK)  # busy: oversized sheds


class TestHealthTracker:
    def test_transitions_with_hysteresis(self):
        sat = [0.0]
        tr = HealthTracker(degraded_at=0.7, shedding_at=0.95,
                           recover_margin=0.1)
        tr.register("src", lambda: sat[0])
        assert tr.evaluate() == OK
        sat[0] = 0.75
        assert tr.evaluate() == DEGRADED
        sat[0] = 0.96
        assert tr.evaluate() == SHEDDING
        # hysteresis: just below the threshold is NOT enough to recover
        sat[0] = 0.90
        assert tr.evaluate() == SHEDDING
        sat[0] = 0.80
        assert tr.evaluate() == DEGRADED
        sat[0] = 0.65
        assert tr.evaluate() == DEGRADED  # within recover margin of 0.7
        sat[0] = 0.3
        assert tr.evaluate() == OK
        states = [(old, new) for old, new, _ in tr.transitions]
        assert states == [(OK, DEGRADED), (DEGRADED, SHEDDING),
                          (SHEDDING, DEGRADED), (DEGRADED, OK)]

    def test_dead_probe_reads_saturated(self):
        tr = HealthTracker()

        def boom():
            raise RuntimeError("probe died")

        tr.register("dead", boom)
        assert tr.evaluate() == SHEDDING

    def test_gate_feeds_tracker(self):
        tr = HealthTracker(degraded_at=0.5, shedding_at=0.9)
        g = AdmissionGate(10, name="gate-under-test", tracker=tr)
        assert tr.evaluate() == OK
        g.admit(6)
        assert tr.evaluate() == DEGRADED
        g.admit(3, Priority.CRITICAL)
        assert tr.evaluate() == SHEDDING
        g.release(9)
        assert tr.evaluate() == OK


# ----------------------------------------------------- charge-site threading


def _make_db(n_series=20):
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    db = Database(ShardSet(2), clock=lambda: 10**9)
    db.mark_bootstrapped()
    db.ensure_namespace(NS, NamespaceOptions(index_enabled=True,
                                             writes_to_commitlog=False))
    for i in range(n_series):
        db.write(NS, b"s-%03d" % i, 10**6 * i, float(i),
                 tags={b"__name__": b"m", b"host": b"h%03d" % i})
    return db


class TestChargeSites:
    def test_index_query_charges_docs_matched_before_materialization(self):
        from m3_tpu_torch.index import query as iq

        db = _make_db(30)
        t = [0.0]
        xlimits.set_global(QueryLimits(
            clock=lambda: t[0],
            docs_matched=LimitOptions(per_second=50)))
        assert len(db.query_ids(NS, iq.AllQuery())) == 30
        with pytest.raises(ResourceExhausted):
            db.query_ids(NS, iq.AllQuery())  # 30 + 30 > 50 within a second
        t[0] = 1.1  # window expired: the same query passes again
        assert len(db.query_ids(NS, iq.AllQuery())) == 30

    def test_database_read_charges_datapoints(self):
        db = _make_db(5)
        xlimits.set_global(QueryLimits(
            datapoints_decoded=LimitOptions(per_second=3)))
        db.read(NS, b"s-000", 0, 2**62)  # 1 point: fits
        db.read(NS, b"s-001", 0, 2**62)
        db.read(NS, b"s-002", 0, 2**62)
        with pytest.raises(ResourceExhausted):
            db.read(NS, b"s-003", 0, 2**62)

    def test_query_ids_charges_series_fetched(self):
        from m3_tpu_torch.index import query as iq

        db = _make_db(8)
        xlimits.set_global(QueryLimits(
            series_fetched=LimitOptions(per_second=5)))
        with pytest.raises(ResourceExhausted):
            db.query_ids(NS, iq.AllQuery())

    def test_executor_per_query_datapoint_budget(self):
        from m3_tpu_torch.query.executor import Engine

        class Big:
            def fetch_raw(self, matchers, s, e):
                t = np.arange(50, dtype=np.int64) * 10**9
                return {b"a": {"tags": {b"__name__": b"m"},
                               "t": t, "v": np.ones(50)}}

        ql = QueryLimits(datapoints_decoded=LimitOptions(concurrent=1000,
                                                         per_query=10))
        eng = Engine(Big(), query_limits=ql)
        with pytest.raises(ResourceExhausted):
            eng.execute_range("m", 0, 60 * 10**9, 15 * 10**9)
        assert ql.enforcer("datapoints_decoded").current() == 0, \
            "failed query leaked its datapoint budget"


# ------------------------------------------------------------- wire round-trip


class TestWireRoundTrip:
    def _server(self, gate=None, limits=None, n_series=20):
        from m3_tpu_torch.rpc import NodeServer, NodeService

        db = _make_db(n_series)
        svc = NodeService(db, gate=gate, limits=limits)
        return NodeServer(svc, port=0).start()

    def test_resource_exhausted_rides_the_wire_typed(self):
        from m3_tpu_torch.client.session import HostClient
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.rpc import wire
        from m3_tpu_torch.utils.retry import RetryOptions

        srv = self._server(limits=QueryLimits(
            docs_matched=LimitOptions(per_second=5)), n_series=20)
        try:
            hc = HostClient(srv.endpoint, timeout=5,
                            retry_opts=RetryOptions(max_attempts=3,
                                                    initial_backoff_s=0.01,
                                                    seed=7))
            with pytest.raises(ResourceExhausted):
                hc.call("fetch_tagged", ns=NS,
                        query=wire.query_to_wire(iq.AllQuery()),
                        start_ns=0, end_ns=2**62)
            # classified retryable: the retrier burned every attempt
            assert hc.retrier.attempts == 3
            # the host answered every time: a shedding node must NOT trip
            # the breaker (that would dogpile its replicas)
            assert hc.breaker.state != "open"
            # the connection stayed synced and poolable: health works
            assert hc.call("health")["ok"]
            hc.close()
        finally:
            srv.close()

    def test_admission_shed_write_is_backpressure_but_health_passes(self):
        from m3_tpu_torch.client.session import HostClient
        from m3_tpu_torch.utils.retry import RetryOptions

        gate = AdmissionGate(2, high_watermark=0.5, tracker=HealthTracker())
        srv = self._server(gate=gate)
        try:
            gate.admit(2, Priority.CRITICAL)  # simulate a full node
            hc = HostClient(srv.endpoint, timeout=5,
                            retry_opts=RetryOptions(max_attempts=2,
                                                    initial_backoff_s=0.01,
                                                    seed=7))
            with pytest.raises(ResourceExhausted):
                hc.call("write", ns=NS, id=b"x", t_ns=0, value=1.0)
            # health and replication metadata are CRITICAL: never shed
            assert hc.call("health")["ok"]
            r = hc.call("fetch_blocks_metadata", ns=NS, shard=0,
                        start_ns=0, end_ns=2**62)
            assert "series" in r
            hc.close()
        finally:
            srv.close()

    def test_bulk_priority_hint_sheds_first(self):
        from m3_tpu_torch.rpc.node_server import method_priority

        assert method_priority("write") == Priority.NORMAL
        assert method_priority("write", "bulk") == Priority.BULK
        assert method_priority("health", "bulk") == Priority.CRITICAL
        assert method_priority("fetch_blocks") == Priority.CRITICAL

    def test_deadline_still_not_retryable_alongside(self):
        """The two typed frames stay distinct: deadline never retries."""
        from m3_tpu_torch.client.session import HostClient
        from m3_tpu_torch.utils.retry import Deadline, RetryOptions

        srv = self._server()
        try:
            hc = HostClient(srv.endpoint, timeout=5,
                            retry_opts=RetryOptions(max_attempts=3,
                                                    initial_backoff_s=0.01,
                                                    seed=7))
            with pytest.raises(DeadlineExceeded):
                hc.call("health", _deadline=Deadline.after(-0.001))
            assert hc.retrier.attempts <= 1
            hc.close()
        finally:
            srv.close()


# ------------------------------------------------------------ ingest shedding


class TestCoordinatorIngest:
    def _writer(self, capacity=2):
        from m3_tpu_torch.coordinator.ingest import DownsamplerAndWriter

        class Sink:
            def __init__(self):
                self.writes = []

            def write(self, sid, tags, t, v):
                self.writes.append(sid)

        sink = Sink()
        gate = AdmissionGate(capacity, high_watermark=0.5,
                             tracker=HealthTracker())
        return DownsamplerAndWriter(sink, gate=gate), sink, gate

    def test_sheds_by_priority_past_watermarks(self):
        w, sink, gate = self._writer(capacity=2)
        gate.admit(1, Priority.CRITICAL)  # depth 1 == high watermark
        with pytest.raises(Backpressure):
            w.write({b"__name__": b"m"}, 0, 1.0, priority=Priority.BULK)
        w.write({b"__name__": b"m"}, 0, 1.0)  # NORMAL still fits
        gate.admit(1, Priority.CRITICAL)      # now at capacity
        with pytest.raises(Backpressure):
            w.write({b"__name__": b"m"}, 0, 2.0)
        w.write({b"__name__": b"m"}, 0, 3.0, priority=Priority.CRITICAL)
        assert len(sink.writes) == 2
        assert gate.shed["bulk"] == 1 and gate.shed["normal"] == 1
        assert gate.shed["critical"] == 0

    def test_write_batch_admission_is_all_or_nothing(self):
        """A shed batch writes NOTHING: per-sample admission would leave
        a partially-written prefix that the 429-retrying producer then
        re-writes, double-counting it."""
        w, sink, gate = self._writer(capacity=4)
        gate.admit(2, Priority.CRITICAL)  # 3-sample batch can't fit
        samples = [({b"__name__": b"m"}, i, float(i)) for i in range(3)]
        with pytest.raises(Backpressure):
            w.write_batch(samples)
        assert sink.writes == []  # nothing partial
        gate.release(2)
        w.write_batch(samples)
        assert len(sink.writes) == 3
        assert gate.depth() == 0

    def test_m3msg_ingester_never_shed(self):
        from m3_tpu_torch.coordinator.ingest import M3MsgIngester
        from m3_tpu_torch.metrics import id as metric_id
        from m3_tpu_torch.rpc import wire

        written = []

        class Sink:
            def write(self, sid, tags, t, v):
                written.append(sid)

        gate = AdmissionGate(1, tracker=HealthTracker())
        gate.admit(1, Priority.CRITICAL)  # saturated
        ing = M3MsgIngester(lambda pol: Sink(), gate=gate)
        payload = wire.encode({"id": metric_id.encode(b"cpu", {}),
                               "t": 123, "v": 4.5, "sp": "10s:2d"})
        ing(0, payload)  # must NOT raise: pipeline output is critical
        assert written and ing.ingested == 1
        assert gate.depth() == 1  # released its own admit


class TestRawTCPShedding:
    def _server(self, capacity=2):
        from m3_tpu_torch.aggregator.server import RawTCPServer

        class StubAgg:
            def __init__(self):
                self.device = torch.device("cpu")
                self.timed = []
                self.forwarded_received = 0

            def add_timed(self, mt, mid, t, v, pol, agg_id):
                self.timed.append(mid)

        agg = StubAgg()
        srv = RawTCPServer(agg, port=0,
                           gate=AdmissionGate(capacity, high_watermark=0.5,
                                              tracker=HealthTracker()))
        srv.start()  # close() blocks unless serve_forever is running
        return srv, agg

    def test_sheds_normal_counts_drop(self):
        srv, agg = self._server(capacity=2)
        try:
            entry = {"t": "timed", "mtype": 3, "id": b"x", "time": 0,
                     "value": 1.0, "policy": "10s:2d", "agg_id": 0}
            assert srv._handle(dict(entry)) == 1
            srv.gate.admit(2, Priority.CRITICAL)  # saturate
            assert srv._handle(dict(entry)) == 0
            assert srv.shed == 1 and srv.errors == 0
            assert len(agg.timed) == 1
        finally:
            srv.close()

    def test_bulk_marked_frames_shed_at_high_watermark(self):
        srv, agg = self._server(capacity=2)
        try:
            entry = {"t": "timed", "mtype": 3, "id": b"x", "time": 0,
                     "value": 1.0, "policy": "10s:2d", "agg_id": 0,
                     "pri": "bulk"}
            srv.gate.admit(1, Priority.CRITICAL)  # depth 1 == high
            assert srv._handle(dict(entry)) == 0
            assert srv.shed == 1
        finally:
            srv.close()


# ------------------------------------------------------------ msg backpressure


class TestProducerBackpressure:
    def _dead_endpoint(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return f"127.0.0.1:{port}"

    def test_publish_backpressure_at_high_watermark(self):
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import ConsumerService, Producer, Topic

        placement = initial_placement(
            [Instance(id="c0", endpoint=self._dead_endpoint())],
            num_shards=2, replica_factor=1)
        prod = Producer(Topic("t", 2, (ConsumerService("svc"),)),
                        {"svc": lambda: placement},
                        max_buffer_bytes=1000, high_watermark=0.5,
                        retry_delay_s=5.0)
        try:
            payload = b"x" * 100
            sent = 0
            with pytest.raises(Backpressure):
                for _ in range(50):
                    prod.publish(0, payload)
                    sent += 1
            # the watermark held BEFORE drop-oldest data loss kicked in
            assert prod.buffered_bytes() <= 500
            assert prod.dropped_oldest == 0
            assert prod.backpressure_rejections >= 1
            assert 0 < sent <= 5
        finally:
            prod.close()

    def test_writer_unacked_entry_cap(self):
        from m3_tpu_torch.msg.producer import MessageWriter, _Message

        def connect():
            raise OSError("consumer down")

        w = MessageWriter(connect, retry_delay_s=5.0, max_unacked=4)
        for i in range(4):
            w.write(_Message(i, 0, b"v", refs=1))
        with pytest.raises(Backpressure):
            w.write(_Message(99, 0, b"v", refs=1))
        # re-write of an ALREADY-QUEUED id is not new growth: allowed
        w.write(_Message(2, 0, b"v", refs=1))
        assert w.unacked() == 4
        w.close()

    def test_unrouted_buffer_cap(self):
        from m3_tpu_torch.msg.producer import ConsumerServiceWriter, _Message

        csw = ConsumerServiceWriter("svc", lambda: None,
                                    connect=lambda ep: None,
                                    max_unacked=3)
        for i in range(3):
            assert not csw.write(_Message(i, 0, b"v", refs=1))
        with pytest.raises(Backpressure):
            csw.write(_Message(9, 0, b"v", refs=1))
        assert csw.unacked() == 3

    def test_partial_fanout_unwound_on_backpressure(self):
        """Two consumer services, the second full: the message must not
        stay queued on the first (a half-delivered message retried
        forever on one service while the caller saw failure)."""
        from m3_tpu_torch.msg import ConsumerService, Producer, Topic

        prod = Producer(Topic("t", 2, (ConsumerService("a"),
                                       ConsumerService("b"))),
                        {"a": lambda: None, "b": lambda: None},
                        retry_delay_s=5.0, max_unacked=2)
        try:
            prod.publish(0, b"m1")
            prod.publish(0, b"m2")
            with pytest.raises(Backpressure):
                prod.publish(0, b"m3")
            # m3 is tracked NOWHERE: both unrouted pens hold exactly m1,m2
            assert prod.unacked() == 4  # 2 messages x 2 services
            assert prod.buffered_bytes() == 4  # m1+m2 only
        finally:
            prod.close()


class TestConsumerInflightWatermark:
    def test_bounded_concurrent_handler_work(self):
        from m3_tpu_torch.msg.consumer import Consumer
        from m3_tpu_torch.rpc import wire

        active = [0]
        max_active = [0]
        done = [0]
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                active[0] += 1
                max_active[0] = max(max_active[0], active[0])
            time.sleep(0.05)
            with lock:
                active[0] -= 1
                done[0] += 1

        cons = Consumer(handler, max_inflight=1).start()
        socks = []
        try:
            host, port = cons.endpoint.rsplit(":", 1)
            for ci in range(3):
                s = socket.create_connection((host, int(port)), timeout=5)
                wire.write_frame(s, {"t": "msg", "shard": 0, "id": ci,
                                     "sent_at": 0, "value": b"v",
                                     "src": 1000 + ci})
                socks.append(s)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                with lock:
                    if done[0] == 3:
                        break
                time.sleep(0.01)
            with lock:
                assert done[0] == 3
                assert max_active[0] == 1, \
                    f"inflight watermark violated: {max_active[0]}"
        finally:
            for s in socks:
                s.close()
            cons.close()


# ------------------------------------------------------------------- loadgen


class TestLoadGen:
    def test_schedule_is_pure_function_of_seed(self):
        from m3_tpu_torch.testing.loadgen import LoadSchedule, Phase

        kw = dict(base_rate=200,
                  phases=(Phase("base", 0.5, 1.0), Phase("spike", 0.5, 3.0)),
                  kinds=(("q", 3.0), ("w", 1.0)))
        a = LoadSchedule(seed=7, **kw)
        assert a.arrivals() == LoadSchedule(seed=7, **kw).arrivals()
        assert a.arrivals() != LoadSchedule(seed=8, **kw).arrivals()

    def test_phase_counts_exact_and_sorted(self):
        from m3_tpu_torch.testing.loadgen import LoadSchedule, Phase

        sched = LoadSchedule(seed=3, base_rate=100,
                             phases=(Phase("base", 0.5, 1.0),
                                     Phase("spike", 0.5, 3.0)))
        arr = sched.arrivals()
        times = [t for t, _, _ in arr]
        assert times == sorted(times)
        assert sum(1 for _, _, ph in arr if ph == "base") == 50
        assert sum(1 for _, _, ph in arr if ph == "spike") == 150
        assert all(0 <= t < 1.0 for t in times)

    def test_open_loop_records_every_arrival(self):
        from m3_tpu_torch.testing.loadgen import LoadGen, LoadSchedule, Phase

        sched = LoadSchedule(seed=5, base_rate=100,
                             phases=(Phase("p", 0.3, 1.0),),
                             kinds=(("ok", 3.0), ("boom", 1.0)))

        def fn(kind):
            if kind == "boom":
                raise ValueError("injected")

        report = LoadGen(sched).run(fn)
        assert len(report.records) == 30
        out = report.outcomes()
        assert out.get("ok", 0) + out.get("ValueError", 0) == 30
        assert out.get("ValueError", 0) > 0
        assert report.throughput("p") == pytest.approx(
            out.get("ok", 0) / 0.3)


# ------------------------------------------------- per-tenant fair share


class TestTenantFairShareWindow:
    """Per-tenant weighted fair-share over the sliding window
    (utils/limits.py, DAGOR-style): one noisy tenant saturates its OWN
    share of a kind's per-second budget, never the whole window."""

    def _limits(self, per_second=100.0, weights=None):
        t = [0.0]
        lims = QueryLimits(
            clock=lambda: t[0],
            docs_matched=LimitOptions(
                per_second=per_second, tenant_fair=True,
                tenant_weights=weights))
        return lims, t

    def test_noisy_tenant_capped_at_its_share(self):
        lims, _ = self._limits()
        # Lone tenant's share: 100 * 1/(0 active + 1 + 1 reserve) = 50.
        lims.charge("docs_matched", 50, tenant=b"noisy")
        with pytest.raises(ResourceExhausted, match="fair share"):
            lims.charge("docs_matched", 1, tenant=b"noisy")
        assert lims.tenant_usage("docs_matched", b"noisy") == 50

    def test_quiet_tenant_unaffected_by_noisy_burst(self):
        lims, _ = self._limits()
        lims.charge("docs_matched", 50, tenant=b"noisy")
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 10, tenant=b"noisy")
        # The noisy tenant consumed only ITS share: a quiet tenant
        # arriving mid-burst still finds budget (share with one other
        # active tenant: 100 * 1/(1 + 1 + 1) = 33.3).
        lims.charge("docs_matched", 30, tenant=b"quiet")
        assert lims.tenant_usage("docs_matched", b"quiet") == 30

    def test_rejected_tenant_charge_leaves_nothing_charged(self):
        lims, _ = self._limits()
        lims.charge("docs_matched", 50, tenant=b"noisy")
        before = lims.tenant_usage("docs_matched", b"noisy")
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 25, tenant=b"noisy")
        assert lims.tenant_usage("docs_matched", b"noisy") == before
        # the global window was not charged either: an untenanted charge
        # can still spend the remaining 50
        lims.charge("docs_matched", 50)

    def test_critical_bypasses_tenant_cap_never_the_window(self):
        lims, _ = self._limits()
        lims.charge("docs_matched", 50, tenant=b"noisy")
        # CRITICAL work from the saturated tenant is not tenant-shed...
        lims.charge("docs_matched", 40, tenant=b"noisy", critical=True)
        # ...but the docs-matched WINDOW itself still applies to it.
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 20, tenant=b"noisy", critical=True)

    def test_weighted_tenants_split_proportionally(self):
        lims, _ = self._limits(weights=((b"big", 3.0),))
        # big alone: 100 * 3/(0 + 3 + 1) = 75; default-weight tenant
        # alongside: 100 * 1/(3 + 1 + 1) = 20.
        lims.charge("docs_matched", 75, tenant=b"big")
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 1, tenant=b"big")
        lims.charge("docs_matched", 20, tenant=b"small")
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 1, tenant=b"small")

    def test_idle_tenant_expires_and_share_recovers(self):
        lims, t = self._limits()
        lims.charge("docs_matched", 40, tenant=b"a")
        lims.charge("docs_matched", 30, tenant=b"b")
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 30, tenant=b"b")  # share is 33.3
        t[0] += 1.1  # a's window usage fully expires
        # with a idle, b is alone again: share back to 50
        lims.charge("docs_matched", 20, tenant=b"b")
        assert lims.tenant_usage("docs_matched", b"a") == 0

    def test_untenanted_charges_see_only_the_global_window(self):
        lims, _ = self._limits()
        lims.charge("docs_matched", 90)
        with pytest.raises(ResourceExhausted):
            lims.charge("docs_matched", 20)

    def test_scope_carries_tenant(self):
        lims, _ = self._limits()
        with lims.scope("q", tenant=b"noisy") as sc:
            sc.charge("docs_matched", 50)
            with pytest.raises(ResourceExhausted, match="fair share"):
                sc.charge("docs_matched", 10)

    def test_tenant_of_extraction(self):
        from m3_tpu_torch.utils.limits import tenant_of

        assert tenant_of(b"acme.requests.count;host=x") == b"acme"
        assert tenant_of(b"acme.requests") == b"acme"
        # an id without a dot is its own tenant (single-tenant degrade)
        assert tenant_of(b"requests;host=x") == b"requests"
        assert tenant_of(b"bare") == b"bare"


class TestTenantFairShareGate:
    """Per-tenant fair-share on the ingest AdmissionGate
    (utils/health.py): engaged only past the high watermark, CRITICAL
    never tenant-shed."""

    def _gate(self, capacity=8, high=0.5, weights=None):
        return AdmissionGate(capacity, high_watermark=high,
                             tracker=HealthTracker(),
                             tenant_weights=weights)

    def test_noisy_tenant_sheds_at_its_share(self):
        g = self._gate()  # capacity 8, high watermark 4
        # below the watermark the tenant cap is not engaged
        assert g.try_admit(4, Priority.NORMAL, tenant=b"noisy")
        # past it, a lone tenant's share is 8 * 1/(0 + 1 + 1) = 4
        assert not g.try_admit(1, Priority.NORMAL, tenant=b"noisy")
        assert g.shed_tenant == 1
        assert g.stats()["tenants"] == {b"noisy": 4}

    def test_quiet_tenant_still_admitted_past_watermark(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL, tenant=b"noisy")
        # quiet tenant mid-burst: share 8 * 1/(1 + 1 + 1) = 2.67
        assert g.try_admit(2, Priority.NORMAL, tenant=b"quiet")
        assert not g.try_admit(1, Priority.NORMAL, tenant=b"quiet")
        assert g.depth() == 6

    def test_critical_never_tenant_shed(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL, tenant=b"noisy")
        assert not g.try_admit(1, Priority.NORMAL, tenant=b"noisy")
        assert g.try_admit(1, Priority.CRITICAL, tenant=b"noisy")
        assert g.shed["critical"] == 0

    def test_release_clears_tenant_depth(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL, tenant=b"noisy")
        g.release(4, tenant=b"noisy")
        assert g.stats()["tenants"] == {}
        assert g.try_admit(4, Priority.NORMAL, tenant=b"noisy")

    def test_weighted_tenant_gets_bigger_share(self):
        g = self._gate(weights={b"big": 3.0})
        # big alone past the watermark: share 8 * 3/(0 + 3 + 1) = 6
        assert g.try_admit(4, Priority.NORMAL, tenant=b"big")
        assert g.try_admit(2, Priority.NORMAL, tenant=b"big")
        assert not g.try_admit(1, Priority.NORMAL, tenant=b"big")

    def test_untenanted_admits_unchanged_by_fairness(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL, tenant=b"noisy")
        # untenanted NORMAL work is still bounded only by capacity
        assert g.try_admit(4, Priority.NORMAL)
        assert not g.try_admit(1, Priority.NORMAL)

    def test_backpressure_message_names_tenant(self):
        g = self._gate()
        g.admit(4, Priority.NORMAL, tenant=b"noisy")
        with pytest.raises(Backpressure, match="tenant b'noisy'"):
            g.admit(1, Priority.NORMAL, tenant=b"noisy")
