"""The port's m3msg producer and consumer (m3_tpu_torch.msg) and the
collector (m3_tpu_torch.collector) against the reference's, on the CPU:
publish, consume and ack; redelivery after a consumer restart, across a
placement gap and after a raising handler; batched acks flushed on idle;
backpressure before drop-oldest; duplicate deliveries re-acked without
re-running the handler; each package's producer feeding the other's
consumer; producer frames byte-equal to the reference's for one fixed
identity; the producer handler's flush over m3msg; the collector's
Reporter through the aggregator client, in process and over TCP into an
aggregator whose flush rides m3msg into storage, with the stored rows
bit-equal to the reference Aggregator's for the same samples, also after
a redelivery. Servers are real localhost listeners, closed in `finally`;
every wait has a deadline."""

import math
import random
import socket
import threading
import time

import numpy as np
import pytest

from m3_tpu.aggregator import Aggregator as JAggregator
from m3_tpu.aggregator import CaptureHandler as JCaptureHandler
from m3_tpu.cluster import placement as jpl
from m3_tpu.collector import Reporter as JReporter
from m3_tpu.aggregator.client import AggregatorClient as JAggregatorClient
from m3_tpu.metrics.matcher import Matcher as JMatcher
from m3_tpu.metrics.matcher import RuleSetStore as JRuleSetStore
from m3_tpu.cluster import kv as jkv
from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
from m3_tpu.msg import consumer as jconsumer
from m3_tpu.msg import producer as jproducer
from m3_tpu.msg import topic as jtopic
from m3_tpu_torch.aggregator import (Aggregator, AggregatorClient,
                                     CaptureHandler, ProducerHandler,
                                     decode_aggregated_batch)
from m3_tpu_torch.aggregator.server import RawTCPServer, TCPTransport
from m3_tpu_torch.cluster import kv as cluster_kv
from m3_tpu_torch.cluster.placement import Instance, initial_placement
from m3_tpu_torch.collector import Reporter
from m3_tpu_torch.coordinator.ingest import M3MsgIngester
from m3_tpu_torch.metrics import aggregation as magg
from m3_tpu_torch.metrics import id as metric_id
from m3_tpu_torch.metrics.filters import TagsFilter
from m3_tpu_torch.metrics.matcher import Matcher, RuleSetStore
from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                           StagedMetadata)
from m3_tpu_torch.metrics.metric import MetricUnion
from m3_tpu_torch.metrics.pipeline import Op, Pipeline
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.rules import (MappingRuleSnapshot,
                                        RollupRuleSnapshot, RollupTarget,
                                        Rule, RuleSet)
from m3_tpu_torch.msg import (Consumer, ConsumerService, Producer, Topic,
                              TopicService)
from m3_tpu_torch.msg import producer as producer_mod
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.query.storage import LocalStorage
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.testing.cluster import SettableClock
from m3_tpu_torch.utils.limits import Backpressure

S = 1_000_000_000
T0 = 1_700_000_000 * S - (1_700_000_000 * S) % (300 * S)
TEN_S = StoragePolicy.of("10s", "2d")
POLS = ("1m:40h", "5m:40h")


def _await(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def one_instance_placement(endpoint, num_shards=4, mod=None):
    mod = mod or __import__("m3_tpu_torch.cluster.placement",
                            fromlist=["placement"])
    return mod.initial_placement([mod.Instance(id="c0", endpoint=endpoint)],
                                 num_shards=num_shards, replica_factor=1)


class TestTopicService:
    def test_crud_and_watch(self):
        store = cluster_kv.MemStore()
        svc = TopicService(store)
        t = Topic("aggregated_metrics", 4).add_consumer(
            ConsumerService("coordinator"))
        svc.upsert(t)
        got = svc.get("aggregated_metrics")
        assert got.num_shards == 4
        assert got.consumer_services[0].service_id == "coordinator"
        seen = []
        svc.on_change("aggregated_metrics", lambda topic: seen.append(topic))
        svc.upsert(got.remove_consumer("coordinator"))
        assert seen and not seen[-1].consumer_services


PAIRS = {
    "port-port": (Producer, Consumer, Topic, ConsumerService, None),
    "port-producer-ref-consumer": (Producer, jconsumer.Consumer, Topic,
                                   ConsumerService, None),
    "ref-producer-port-consumer": (jproducer.Producer, Consumer, jtopic.Topic,
                                   jtopic.ConsumerService, jpl),
}


class TestProducerConsumer:
    @pytest.mark.parametrize("pair", sorted(PAIRS))
    def test_publish_consume_ack(self, pair):
        prod_cls, cons_cls, topic_cls, cs_cls, pl_mod = PAIRS[pair]
        received = []
        consumer = cons_cls(
            lambda shard, value: received.append((shard, value))).start()
        prod = None
        try:
            topic = topic_cls("t", 4, (cs_cls("svc"),))
            p = one_instance_placement(consumer.endpoint, mod=pl_mod)
            prod = prod_cls(topic, {"svc": lambda: p})
            for i in range(20):
                prod.publish(i % 4, b"payload-%d" % i)
            assert _await(lambda: len(received) == 20)
            assert _await(lambda: prod.unacked() == 0)
            assert _await(lambda: prod.buffered_bytes() == 0)
            assert sorted(received) == sorted(
                (i % 4, b"payload-%d" % i) for i in range(20))
        finally:
            if prod is not None:
                prod.close()
            consumer.close()

    def test_redelivery_after_consumer_restart(self):
        received = []
        consumer = Consumer(lambda s, v: received.append(v)).start()
        endpoint = consumer.endpoint
        port = int(endpoint.rpartition(":")[2])
        topic = Topic("t", 1, (ConsumerService("svc"),))
        p = one_instance_placement(endpoint, num_shards=1)
        prod = Producer(topic, {"svc": lambda: p}, retry_delay_s=0.05)
        try:
            prod.publish(0, b"before")
            assert _await(lambda: received == [b"before"])
            consumer.close()
            prod.publish(0, b"during")  # the connection may be dead
            consumer = Consumer(lambda s, v: received.append(v),
                                port=port).start()
            assert _await(lambda: b"during" in received, timeout=10)
            assert _await(lambda: prod.unacked() == 0, timeout=10)
        finally:
            prod.close()
            consumer.close()

    def test_unrouted_messages_recover_when_placement_appears(self):
        received = []
        consumer = Consumer(lambda s, v: received.append(v)).start()
        placement = {"p": None}
        topic = Topic("t", 1, (ConsumerService("svc"),))
        prod = Producer(topic, {"svc": lambda: placement["p"]},
                        retry_delay_s=0.05)
        try:
            prod.publish(0, b"early")
            assert prod.unacked() == 1 and received == []
            placement["p"] = one_instance_placement(consumer.endpoint, 1)
            assert _await(lambda: received, timeout=10)
            assert set(received) == {b"early"}
            assert _await(lambda: prod.unacked() == 0)
        finally:
            prod.close()
            consumer.close()

    def test_partial_ack_batch_flushes_on_idle(self):
        received = []
        consumer = Consumer(lambda s, v: received.append(v),
                            ack_batch=10).start()
        topic = Topic("t", 1, (ConsumerService("svc"),))
        p = one_instance_placement(consumer.endpoint, 1)
        prod = Producer(topic, {"svc": lambda: p})
        try:
            for i in range(3):
                prod.publish(0, b"m%d" % i)
            assert _await(lambda: len(received) == 3)
            assert _await(lambda: prod.unacked() == 0, timeout=3.0)
        finally:
            prod.close()
            consumer.close()

    def test_publish_backpressure_before_drop_oldest(self):
        topic = Topic("t", 1, (ConsumerService("svc"),))
        dead = one_instance_placement("127.0.0.1:1", num_shards=1)
        prod = Producer(topic, {"svc": lambda: dead}, max_buffer_bytes=1000)
        try:
            with pytest.raises(Backpressure):
                for _ in range(50):
                    prod.publish(0, b"x" * 100)
            assert prod.buffered_bytes() <= 1000
            assert prod.backpressure_rejections >= 1
            assert prod.dropped_oldest == 0
        finally:
            prod.close()

    def test_drop_oldest_bounds_buffer(self):
        topic = Topic("t", 1, (ConsumerService("svc"),))
        dead = one_instance_placement("127.0.0.1:1", num_shards=1)
        prod = Producer(topic, {"svc": lambda: dead}, max_buffer_bytes=1000,
                        high_watermark=2.0)
        try:
            for _ in range(50):
                prod.publish(0, b"x" * 100)
            assert prod.buffered_bytes() <= 1000
            assert prod.dropped_oldest >= 40
        finally:
            prod.close()

    def test_writer_unacked_cap_raises_backpressure(self):
        topic = Topic("t", 1, (ConsumerService("svc"),))
        dead = one_instance_placement("127.0.0.1:1", num_shards=1)
        prod = Producer(topic, {"svc": lambda: dead}, max_unacked=3)
        try:
            for i in range(3):
                prod.publish(0, b"m%d" % i)
            with pytest.raises(Backpressure):
                prod.publish(0, b"m3")
            assert prod.unacked() == 3
        finally:
            prod.close()

    def test_handler_failure_redelivered_not_fatal(self):
        seen = {}
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                seen[value] = seen.get(value, 0) + 1
                n = seen[value]
            if value == b"poison" and n == 1:
                raise ValueError("injected handler failure")

        consumer = Consumer(handler).start()
        topic = Topic("t", 2, (ConsumerService("svc"),))
        p = one_instance_placement(consumer.endpoint)
        prod = Producer(topic, {"svc": lambda: p}, retry_delay_s=0.05)
        try:
            prod.publish(0, b"ok-1")
            prod.publish(1, b"poison")
            prod.publish(0, b"ok-2")
            assert _await(lambda: seen.get(b"poison", 0) >= 2, timeout=10)
            assert _await(lambda: prod.unacked() == 0, timeout=10)
            assert seen.get(b"ok-1") and seen.get(b"ok-2")
        finally:
            prod.close()
            consumer.close()

    def test_duplicate_delivery_reacked_without_rerunning_handler(self):
        """The same (src, id) on two connections: the handler runs once
        and both copies are acked; another producer's id is new."""
        from m3_tpu_torch.rpc import wire

        calls = []
        consumer = Consumer(lambda s, v: calls.append(v)).start()
        socks = []
        try:
            host, _, port = consumer.endpoint.rpartition(":")
            for src in (7, 7, 8):
                sock = socket.create_connection((host, int(port)), timeout=5)
                socks.append(sock)
                wire.write_frame(sock, {"t": "msg", "shard": 0, "id": 1,
                                        "sent_at": 0, "value": b"v",
                                        "src": src})
                assert wire.read_dict_frame(sock) == {"t": "ack", "ids": [1]}
            assert calls == [b"v", b"v"]
            assert consumer.duplicates_dropped == 1
        finally:
            for sock in socks:
                sock.close()
            consumer.close()


class _FixedTime:
    """A stand-in for the producer module's `time`: a fixed monotonic
    clock, so `sent_at` (and the retry schedule) are the same for both
    packages' frames."""

    sleep = staticmethod(time.sleep)

    @staticmethod
    def monotonic_ns():
        return 1_234_567_890


class _Recorder:
    """A consumer endpoint that records the bytes of every connection and
    acks every message."""

    def __init__(self):
        from m3_tpu_torch.rpc import wire

        self._wire = wire
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self.endpoint = "127.0.0.1:%d" % self._lsock.getsockname()[1]
        self.frames = []
        self._socks = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            self._socks.append(c)
            try:
                while True:
                    head = self._recv(c, 4)
                    body = self._recv(c, int.from_bytes(head, "little"))
                    self.frames.append(head + body)
                    frame = self._wire.decode(body)
                    self._wire.write_frame(c, {"t": "ack",
                                               "ids": [frame["id"]]})
            except (OSError, ConnectionError):
                pass

    @staticmethod
    def _recv(c, n):
        out = bytearray()
        while len(out) < n:
            chunk = c.recv(n - len(out))
            if not chunk:
                raise ConnectionError("closed")
            out += chunk
        return bytes(out)

    def close(self):
        for s in [self._lsock] + self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        self._thread.join(timeout=5)


def test_producer_frames_byte_equal_reference(monkeypatch):
    """One identity (the port's generator and the reference's global
    random seeded alike) and one fixed clock: the frames both packages'
    producers put on the wire are equal byte for byte."""
    monkeypatch.setattr(producer_mod, "time", _FixedTime)
    monkeypatch.setattr(jproducer, "time", _FixedTime)
    out = []
    for make, pl_mod in (
            (lambda t, sp: Producer(t, sp, retry_delay_s=0.2,
                                    identity_rng=random.Random(42)), None),
            (lambda t, sp: (random.seed(42), jproducer.Producer(
                jtopic.Topic(t.name, t.num_shards,
                             (jtopic.ConsumerService("svc"),)),
                sp, retry_delay_s=0.2))[1], jpl)):
        rec = _Recorder()
        p = one_instance_placement(rec.endpoint, mod=pl_mod)
        prod = make(Topic("t", 4, (ConsumerService("svc"),)),
                    {"svc": lambda: p})
        try:
            for i in range(6):
                prod.publish(i % 4, b"payload-%d" % i)
            assert _await(lambda: prod.unacked() == 0)
        finally:
            prod.close()
            rec.close()
        out.append(rec.frames)
    assert len(out[0]) == 6 and out[0] == out[1]


def test_producer_identity_from_its_generator():
    topic = Topic("t", 1, (ConsumerService("svc"),))
    placement = one_instance_placement("127.0.0.1:1", num_shards=1)
    prods = [Producer(topic, {"svc": lambda: placement}) for _ in range(2)]
    fixed = [Producer(topic, {"svc": lambda: placement},
                      identity_rng=random.Random(3)) for _ in range(2)]
    try:
        assert prods[0]._src != prods[1]._src
        assert fixed[0]._src == fixed[1]._src == random.Random(3).getrandbits(63)
    finally:
        for p in prods + fixed:
            p.close()


class TestProducerHandler:
    def test_flush_rides_m3msg_to_consumer(self):
        received = []
        consumer = Consumer(lambda shard, value: received.extend(
            decode_aggregated_batch(value))).start()
        prod = None
        try:
            topic = Topic("aggregated_metrics", 4, (ConsumerService("coord"),))
            p = one_instance_placement(consumer.endpoint)
            prod = Producer(topic, {"coord": lambda: p})
            clock = SettableClock(100 * S)
            agg = Aggregator(num_shards=8, clock=clock, device="cpu",
                             flush_handler=ProducerHandler(prod, 4))
            md = (StagedMetadata(0, False, Metadata((
                PipelineMetadata(0, (TEN_S,)),))),)
            agg.add_untimed(MetricUnion.counter(b"total_requests", 41), md)
            agg.add_untimed(MetricUnion.counter(b"total_requests", 1), md)
            clock.advance(10 * S)
            agg.flush()
            assert _await(lambda: len(received) == 1)
            m = received[0]
            assert (m.id, m.value, m.time_nanos, m.storage_policy) == (
                b"total_requests", 42.0, 110 * S, TEN_S)
        finally:
            if prod is not None:
                prod.close()
            consumer.close()


def _rules(mod_rules, mod_filters, mod_policy):
    return mod_rules.RuleSet(b"default", 1, mapping_rules=[mod_rules.Rule([
        mod_rules.MappingRuleSnapshot(
            "all", 0, mod_filters.TagsFilter({"service": "api"}), 0,
            tuple(mod_policy.StoragePolicy.parse(p) for p in POLS))])])


class TestCollectorEndToEnd:
    def test_report_through_aggregator(self):
        store = cluster_kv.MemStore()
        clock = SettableClock(600 * S)
        rs = RuleSet(
            b"default", 1,
            mapping_rules=[Rule([MappingRuleSnapshot(
                "all", 0, TagsFilter({"service": "api"}), 0, (TEN_S,))])],
            rollup_rules=[Rule([RollupRuleSnapshot(
                "sum-by-region", 0, TagsFilter({"service": "api"}),
                (RollupTarget(
                    Pipeline((Op.roll(b"api_region_total", (b"region",),
                                      magg.AggID.compress([magg.AggType.SUM])),)),
                    (TEN_S,)),))])],
        )
        rstore = RuleSetStore(store)
        rstore.publish(rs)
        matcher = Matcher(rstore, b"default", clock=clock)
        cap = CaptureHandler()
        agg = Aggregator(num_shards=16, clock=clock, flush_handler=cap,
                         device="cpu")
        p = initial_placement([Instance(id="agg0", endpoint="l:0")],
                              num_shards=16, replica_factor=1)
        client = AggregatorClient(16, lambda: p, {"agg0": agg.add_untimed})
        rep = Reporter(matcher, client)
        for host, v in [(b"a", 5), (b"b", 7)]:
            mid = metric_id.encode(
                b"requests", {b"service": b"api", b"region": b"us",
                              b"host": host})
            assert rep.report_counter(mid, v)
        assert not rep.report_gauge(metric_id.encode(b"x", {b"service": b"w"}),
                                    1.0)
        clock.advance(10 * S)
        agg.flush()
        assert rep.reported == 2
        originals = [m for m in cap.metrics if b"host=" in m.id]
        assert sorted(m.value for m in originals) == [5.0, 7.0]
        rollups = [m for m in cap.metrics
                   if m.id.startswith(b"api_region_total")]
        assert len(rollups) == 1 and rollups[0].value == 12.0

    def test_client_drops_unowned_and_counts(self):
        p = initial_placement([Instance(id="agg0", endpoint="l:0")],
                              num_shards=4, replica_factor=1)
        client = AggregatorClient(4, lambda: p, {})
        assert not client.write_untimed_gauge(b"x", 1.0)
        assert client.dropped == 1


def _report(rep, samples):
    for kind, mid, v in samples:
        ok = (rep.report_counter(mid, v) if kind == "c"
              else rep.report_gauge(mid, v) if kind == "g"
              else rep.report_batch_timer(mid, v))
        assert ok


def _samples(rng, n_metrics, points):
    """Per point, every metric's sample: counters (Poisson(5)), gauges
    (normal) and batch timers of 4 values, with tagged ids."""
    ids = [metric_id.encode(b"cg", {b"service": b"api",
                                    b"instance": b"%d" % i})
           for i in range(n_metrics)]
    out = []
    for _ in range(points):
        pt = []
        for i, mid in enumerate(ids):
            if i % 3 == 0:
                pt.append(("c", mid, int(rng.poisson(5.0))))
            elif i % 3 == 1:
                pt.append(("g", mid, float(rng.standard_normal())))
            else:
                pt.append(("t", mid, rng.lognormal(0, 1, 4).tolist()))
        out.append(pt)
    return out


def _stored_rows(db, ids):
    rows = set()
    for ns in (b"agg_1m", b"agg_5m"):
        for mid in ids:
            try:
                t, v = db.read(ns, mid, 0, 2**62)
            except KeyError:
                continue
            for ti, vi in zip(t.tolist(), v.tolist()):
                rows.add((ns, mid, ti, "nan" if math.isnan(vi) else vi.hex()))
    return rows


def _oracle_rows(cap):
    ns = {str(JStoragePolicy.parse(p)): name
          for p, name in zip(POLS, (b"agg_1m", b"agg_5m"))}
    return {(ns[str(m.storage_policy)], m.id, m.time_nanos,
             "nan" if math.isnan(m.value) else float(m.value).hex())
            for m in cap.metrics}


@pytest.mark.parametrize("fail_first", [False, True],
                         ids=["clean", "redelivered"])
def test_report_over_tcp_and_m3msg_stores_reference_rows(fail_first):
    """Reporter -> AggregatorClient -> TCPTransport -> RawTCPServer ->
    Aggregator (two instances, RF 1) -> ProducerHandler -> Producer ->
    Consumer -> M3MsgIngester -> Database. The stored rows of the 1m and
    5m namespaces equal the reference Aggregator's rows for the same
    samples fed in process. With `redelivered`, the ingester raises after
    writing its first payload, so the producer redelivers it and storage
    sees its rows twice: the stored rows are the same."""
    clock = SettableClock(T0)
    kv = cluster_kv.MemStore()
    RuleSetStore(kv).publish(_rules(
        __import__("m3_tpu_torch.metrics.rules", fromlist=["r"]),
        __import__("m3_tpu_torch.metrics.filters", fromlist=["f"]),
        __import__("m3_tpu_torch.metrics.policy", fromlist=["p"])))
    jkvs = jkv.MemStore()
    JRuleSetStore(jkvs).publish(_rules(
        __import__("m3_tpu.metrics.rules", fromlist=["r"]),
        __import__("m3_tpu.metrics.filters", fromlist=["f"]),
        __import__("m3_tpu.metrics.policy", fromlist=["p"])))
    db = Database(ShardSet(4), clock=clock, device="cpu")
    for ns in (b"agg_1m", b"agg_5m"):
        db.create_namespace(ns, NamespaceOptions(index_enabled=False))
    storages = {StoragePolicy.parse(p): LocalStorage(db, ns)
                for p, ns in zip(POLS, (b"agg_1m", b"agg_5m"))}
    ingester = M3MsgIngester(storages.get)
    failed = []

    def handler(shard, payload):
        ingester(shard, payload)
        if fail_first and not failed:
            failed.append(shard)
            raise RuntimeError("injected failure after the writes")

    consumer = Consumer(handler).start()
    closers = [consumer.close]
    try:
        cpl = initial_placement([Instance("coord", consumer.endpoint)], 8, 1)
        topic = Topic("aggregated_metrics", 8, (ConsumerService("coord"),))
        agg_pl = initial_placement([Instance("a0", "a0:1"),
                                    Instance("a1", "a1:1")], 16, 1)
        prods, servers, transports = [], [], {}
        for iid in ("a0", "a1"):
            prod = Producer(topic, {"coord": lambda: cpl}, retry_delay_s=0.05)
            prods.append(prod)
            closers.append(prod.close)
            agg = Aggregator(num_shards=16, clock=clock, device="cpu",
                             flush_handler=ProducerHandler(prod, 8))
            agg.assign_shards(agg_pl.instances[iid].shard_ids())
            srv = RawTCPServer(agg).start()
            closers.append(srv.close)
            servers.append((agg, srv))
            transports[iid] = TCPTransport(srv.endpoint, batch_size=32)
            closers.append(transports[iid].close)
        rep = Reporter(Matcher(RuleSetStore(kv), b"default", clock=clock),
                       AggregatorClient(16, lambda: agg_pl, transports))
        oracle = JCaptureHandler()
        jagg = JAggregator(num_shards=16, clock=clock, flush_handler=oracle)
        jrep = JReporter(JMatcher(JRuleSetStore(jkvs), b"default",
                                  clock=clock),
                         JAggregatorClient(16, lambda: jpl.initial_placement(
                             [jpl.Instance("j", "j:1")], 16, 1),
                             {"j": jagg.add_untimed}))
        points = _samples(np.random.default_rng(23), 60, 30)
        sent = 0
        for pt in points:
            _report(rep, pt)
            _report(jrep, pt)
            for tr in transports.values():
                assert tr.flush()
            sent += len(pt)
            assert _await(lambda n=sent: sum(s.frames for _, s in servers)
                          == n)
            clock.advance(10 * S)
        assert clock() == T0 + 300 * S
        for agg, _ in servers:
            agg.flush()
        jagg.flush()
        assert _await(lambda: all(p.unacked() == 0 for p in prods),
                      timeout=10)
        ids = sorted({m.id for m in oracle.metrics})
        want = _oracle_rows(oracle)
        assert len(want) == len(oracle.metrics) > 40 * 6
        assert _stored_rows(db, ids) == want
        assert bool(failed) == fail_first
        # a redelivered payload is written twice; storage keeps one
        assert (ingester.ingested > len(want)) == fail_first
        assert ingester.ingested >= len(want)
    finally:
        for c in closers:
            c()
