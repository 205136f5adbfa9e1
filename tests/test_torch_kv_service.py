"""The port's networked KV service (m3_tpu_torch.cluster.kv_service)
against the reference's (m3_tpu.cluster.kv_service), on the CPU: the
MemStore surface over the wire (versions, set-if-not-exists, CAS, delete,
keys, reconnect), watch pushes across clients, leader election and flush
times over a RemoteStore, and the cluster client's endpoint form. Every
case runs for each server/client pairing of the two packages, and the
request frames a port RemoteStore sends are byte-equal to the
reference's for the same calls. Servers are real localhost listeners,
closed in fixtures; every wait has a deadline."""

import socket
import threading
import time

import pytest

from m3_tpu.cluster import kv_service as jkvs
from m3_tpu.cluster.client import ClusterClient as JClusterClient
from m3_tpu_torch.aggregator import FlushTimesManager
from m3_tpu_torch.cluster import kv_service as kvs
from m3_tpu_torch.cluster.client import ClusterClient
from m3_tpu_torch.cluster.placement import Instance
from m3_tpu_torch.cluster.services import (CampaignState, LeaderService,
                                           ServiceInstance)

PAIRS = {
    "port-port": (kvs.KVServer, kvs.RemoteStore),
    "ref-server-port-client": (jkvs.KVServer, kvs.RemoteStore),
    "port-server-ref-client": (kvs.KVServer, jkvs.RemoteStore),
}


def _await(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(params=sorted(PAIRS))
def kv(request):
    """(server, make_client): the server closes, and every client made
    through make_client closes, when the test ends."""
    server_cls, client_cls = PAIRS[request.param]
    srv = server_cls().start()
    clients = []

    def make_client():
        c = client_cls(srv.endpoint)
        clients.append(c)
        return c

    yield srv, make_client
    for c in clients:
        c.close()
    srv.close()


class TestRemoteStoreParity:
    def test_get_set_versioning(self, kv):
        _, client = kv
        st = client()
        assert st.get("k") is None
        assert st.set("k", b"v1") == 1
        assert st.set("k", b"v2") == 2
        v = st.get("k")
        assert v.data == b"v2" and v.version == 2

    def test_setnx_and_cas(self, kv):
        _, client = kv
        st = client()
        assert st.set_if_not_exists("k", b"a") == 1
        with pytest.raises(KeyError):
            st.set_if_not_exists("k", b"b")
        assert st.check_and_set("k", 1, b"c") == 2
        with pytest.raises(ValueError):
            st.check_and_set("k", 1, b"d")  # stale version
        with pytest.raises(ValueError):
            st.check_and_set("new", 5, b"x")  # 0 means not-exists

    def test_delete_and_keys(self, kv):
        _, client = kv
        st = client()
        st.set("a/1", b"x")
        st.set("a/2", b"y")
        st.set("b/1", b"z")
        assert st.keys("a/") == ["a/1", "a/2"]
        assert st.delete("a/1") is not None
        assert st.delete("a/1") is None
        assert st.keys("a/") == ["a/2"]

    def test_reconnect_after_server_side_close(self, kv):
        _, client = kv
        st = client()
        st.set("k", b"v")
        # Kill the pooled connection; the next request reconnects.
        st._sock.close()
        assert st.get("k").data == b"v"

    def test_store_behind_the_server_sees_remote_writes(self, kv):
        srv, client = kv
        st = client()
        st.set("x", b"1")
        assert srv.store.get("x").data == b"1"
        srv.store.set("x", b"2")
        assert st.get("x").version == 2


class TestWatchPush:
    def test_watch_fires_across_clients(self, kv):
        _, client = kv
        writer, reader = client(), client()
        w = reader.watch("key")
        writer.set("key", b"v1")
        assert w.wait(timeout=5.0)
        assert w.get().data == b"v1"
        writer.set("key", b"v2")
        assert w.wait(timeout=5.0)
        assert w.get().version == 2

    def test_on_change_pushes_values(self, kv):
        _, client = kv
        writer, reader = client(), client()
        seen = []
        reader.on_change("cfg", lambda key, v: seen.append((v.version, v.data)))
        writer.set("cfg", b"one")
        assert _await(lambda: (1, b"one") in seen)
        writer.set("cfg", b"two")
        assert _await(lambda: (2, b"two") in seen)

    def test_watch_delivers_current_value_immediately(self, kv):
        _, client = kv
        writer = client()
        writer.set("pre", b"existing")
        reader = client()
        seen = []
        reader.on_change("pre", lambda key, v: seen.append(v.data))
        assert _await(lambda: b"existing" in seen)

    def test_off_change_stops_delivery(self, kv):
        _, client = kv
        writer, reader = client(), client()
        seen, kept = [], []
        fn = lambda key, v: seen.append(v.data)  # noqa: E731
        reader.on_change("k", fn)
        reader.on_change("k", lambda key, v: kept.append(v.data))
        writer.set("k", b"a")
        assert _await(lambda: seen == [b"a"] and kept == [b"a"])
        reader.off_change("k", fn)
        writer.set("k", b"b")
        assert _await(lambda: kept == [b"a", b"b"])
        assert seen == [b"a"]


class TestServicesOverNetworkedKV:
    def test_election_and_flush_times_across_clients(self, kv):
        """LeaderService + FlushTimesManager work unchanged over a
        RemoteStore: one KV process serves the cluster."""
        _, client = kv
        st_a, st_b = client(), client()
        clock = time.time_ns
        la = LeaderService(st_a, "e1", "inst-a", clock=clock)
        lb = LeaderService(st_b, "e1", "inst-b", clock=clock)
        assert la.campaign() == CampaignState.LEADER
        assert lb.campaign() == CampaignState.FOLLOWER
        assert lb.leader() == "inst-a"
        fa = FlushTimesManager(st_a, "ss")
        fb = FlushTimesManager(st_b, "ss")
        fa.store(0, {10_000_000_000: 123})
        assert _await(lambda: fb.get(0).get(10_000_000_000) == 123)
        # A remote store has no set_many: a round's times go per shard.
        fa.store_many({1: {60: 7}, 2: {60: 8}})
        assert fb.get(1) == {60: 7} and fb.get(2) == {60: 8}
        la.resign()
        assert lb.campaign() == CampaignState.LEADER


class TestClusterClient:
    """The composed cluster client's endpoint form: one endpoint yields
    KV, scoped stores, services, elections and placements."""

    def test_scoped_stores_isolate(self, kv):
        srv, _ = kv
        c1 = ClusterClient(endpoint=srv.endpoint, zone="z1", env="prod")
        c2 = ClusterClient(endpoint=srv.endpoint, zone="z2", env="prod")
        try:
            c1.kv().set("cfg", b"one")
            c2.kv().set("cfg", b"two")
            assert c1.kv().get("cfg").data == b"one"
            assert c2.kv().get("cfg").data == b"two"
            sub = c1.store("rules")
            sub.set("r1", b"x")
            assert sub.keys() == ["r1"]
            assert c1.kv().get("rules/r1").data == b"x"
        finally:
            c1.close()
            c2.close()

    def test_scoped_watch_pushes(self, kv):
        srv, _ = kv
        ca = ClusterClient(endpoint=srv.endpoint, zone="zz")
        cb = ClusterClient(endpoint=srv.endpoint, zone="zz")
        try:
            seen = []
            ca.kv().on_change("watched", lambda k, v: seen.append((k, v.data)))
            cb.kv().set("watched", b"pushed")
            assert _await(lambda: ("watched", b"pushed") in seen)
        finally:
            ca.close()
            cb.close()

    def test_composed_services_over_one_endpoint(self, kv):
        srv, _ = kv
        clock = time.time_ns
        c = ClusterClient(endpoint=srv.endpoint)
        try:
            svcs = c.services(clock=clock)
            svcs.advertise("m3dbnode", ServiceInstance("n1", "h1:9000"))
            assert [i.instance_id for i in svcs.instances("m3dbnode")] == ["n1"]
            leader = c.leader_service("e1", "n1", clock=clock)
            assert leader.campaign() == CampaignState.LEADER
            psvc = c.placement_service("m3aggregator")
            psvc.init([Instance("a", "a:1")], num_shards=4, replica_factor=1)
            assert set(psvc.get().instances) == {"a"}
            # Distinct per-service placements don't collide.
            assert c.placement_service("m3db").get() is None
        finally:
            c.close()

    def test_port_and_reference_clients_share_one_service(self, kv):
        """Both packages' cluster clients over one endpoint see each
        other's keys under the same scope."""
        srv, _ = kv
        c = ClusterClient(endpoint=srv.endpoint, zone="z", env="e")
        j = JClusterClient(endpoint=srv.endpoint, zone="z", env="e")
        try:
            c.kv().set("from-port", b"p")
            j.kv().set("from-ref", b"r")
            assert j.kv().get("from-port").data == b"p"
            assert c.kv().get("from-ref").data == b"r"
            assert sorted(c.kv().keys()) == sorted(j.kv().keys())
        finally:
            c.close()
            j.close()

    def test_close_leaves_an_injected_store_open(self, kv):
        _, client = kv
        st = client()
        ClusterClient(store=st).close()
        st.set("still", b"open")
        assert st.get("still").data == b"open"


class _RecordingProxy:
    """A localhost TCP proxy in front of an upstream endpoint that records
    every byte each client connection sends, per connection."""

    def __init__(self, upstream: str):
        host, _, port = upstream.rpartition(":")
        self._upstream = (host, int(port))
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self.endpoint = "127.0.0.1:%d" % self._lsock.getsockname()[1]
        self.sent = []
        self._socks = []
        self._threads = []
        self._closed = False
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        while not self._closed:
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            u = socket.create_connection(self._upstream, timeout=10)
            buf = bytearray()
            self.sent.append(buf)
            self._socks += [c, u]
            for src, dst, rec in ((c, u, buf), (u, c, None)):
                t = threading.Thread(target=self._pump, args=(src, dst, rec),
                                     daemon=True)
                t.start()
                self._threads.append(t)

    @staticmethod
    def _pump(src, dst, rec):
        try:
            while True:
                chunk = src.recv(1 << 16)
                if not chunk:
                    break
                if rec is not None:
                    rec += chunk
                dst.sendall(chunk)
        except OSError:
            pass
        finally:
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def close(self):
        self._closed = True
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)  # wakes the accept
        except OSError:
            pass
        self._lsock.close()
        for s in self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)  # wakes a blocked recv
            except OSError:
                pass
            s.close()
        for t in self._threads:
            t.join(timeout=5)


def _drive(store):
    """One fixed sequence over the MemStore surface (no deadline: its
    budget rides the frame as a time)."""
    store.set("a", b"1")
    store.set_if_not_exists("b", b"2")
    with pytest.raises(KeyError):
        store.set_if_not_exists("b", b"3")
    store.check_and_set("a", 1, b"4")
    with pytest.raises(ValueError):
        store.check_and_set("a", 1, b"5")
    store.get("a")
    store.get("missing")
    store.keys("")
    store.delete("b")
    store.delete("b")


def test_request_frames_byte_equal_reference():
    """The port's RemoteStore sends the reference's request bytes for the
    same calls, and a watch opens its stream with the same frame."""
    servers = [kvs.KVServer().start() for _ in range(2)]
    proxies = [_RecordingProxy(s.endpoint) for s in servers]
    stores = []
    try:
        for proxy, cls in zip(proxies, (kvs.RemoteStore, jkvs.RemoteStore)):
            st = cls(proxy.endpoint)
            stores.append(st)
            _drive(st)
            w = st.watch("w")
            st.set("w", b"x")
            assert w.wait(timeout=5.0)
            assert _await(lambda p=proxy: len(p.sent) == 2 and p.sent[1])
        port, ref = ([bytes(b) for b in p.sent] for p in proxies)
        assert port[0] and port == ref
    finally:
        for st in stores:
            st.close()
        for p in proxies:
            p.close()
        for s in servers:
            s.close()
