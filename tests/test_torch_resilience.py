"""Port of tests/test_resilience.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Chaos suite for the unified resilience layer (utils/retry + faultnet):
bounded retry counts, breaker trip/recovery lifecycles, deadline-bounded
latency across the wire, no duplicate aggregation under injected
redelivery, and seed-deterministic fault schedules.

Every networked scenario runs against the REAL servers behind a seeded
fault-injecting proxy (m3_tpu_torch.testing.faultnet) — no mock transports."""

import socket
import struct
import threading
import time

import pytest

from m3_tpu_torch.rpc import wire
from m3_tpu_torch.rpc.wire import WireTruncated
from m3_tpu_torch.utils.retry import (
    Breaker,
    BreakerOpen,
    BreakerOptions,
    Deadline,
    DeadlineExceeded,
    HostHealth,
    NonRetryableError,
    Retrier,
    RetryableError,
    RetryOptions,
)
from m3_tpu_torch.testing.faultnet import NO_FAULT, FaultPlan, FaultProxy
from test_torch_cpu_default import cpu_default  # noqa: F401


def _await(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------- retrier


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class TestRetrier:
    def _retrier(self, clock, **kw):
        opts = RetryOptions(seed=7, **kw)
        return Retrier(opts, sleep=clock.sleep, clock=clock)

    def test_bounded_attempts_and_last_error_type(self):
        clock = FakeClock()
        calls = []

        def fail():
            calls.append(1)
            raise ConnectionResetError("boom")

        r = self._retrier(clock, max_attempts=4, initial_backoff_s=0.01)
        with pytest.raises(ConnectionResetError):
            r.attempt(fail)
        assert len(calls) == 4          # total tries == max_attempts, no more
        assert r.attempts == 4 and r.retries == 3

    def test_classification(self):
        clock = FakeClock()

        class AppError(Exception):
            pass

        for exc, expected_calls in ((AppError("app"), 1),
                                    (NonRetryableError("no"), 1),
                                    (ValueError("desync"), 1),
                                    (BreakerOpen("shed"), 1),
                                    (RetryableError("yes"), 3),
                                    (OSError("io"), 3),
                                    (WireTruncated("cut"), 3)):
            calls = []

            def fail():
                calls.append(1)
                raise exc

            r = self._retrier(clock, max_attempts=3, initial_backoff_s=0.001)
            with pytest.raises(type(exc)):
                r.attempt(fail)
            assert len(calls) == expected_calls, exc

    def test_backoff_schedule_deterministic_and_shaped(self):
        clock = FakeClock()
        a = self._retrier(clock, max_attempts=8, initial_backoff_s=0.1,
                          backoff_factor=2.0, max_backoff_s=1.0)
        b = self._retrier(clock, max_attempts=8, initial_backoff_s=0.1,
                          backoff_factor=2.0, max_backoff_s=1.0)
        sa, sb = a.schedule(8), b.schedule(8)
        assert sa == sb                 # same seed -> identical jitter
        for i, d in enumerate(sa, start=1):
            base = min(0.1 * 2 ** (i - 1), 1.0)
            assert base / 2 <= d <= base  # jitter in [base/2, base]
        assert max(sa) <= 1.0           # capped

    def test_jitterless_schedule_exact(self):
        clock = FakeClock()
        r = self._retrier(clock, jitter=False, initial_backoff_s=0.05,
                          backoff_factor=2.0, max_backoff_s=0.5)
        assert r.schedule(5) == [0.05, 0.1, 0.2, 0.4, 0.5]

    def test_deadline_stops_retry_loop(self):
        clock = FakeClock()
        r = self._retrier(clock, max_attempts=100, initial_backoff_s=0.2,
                          jitter=False)
        dl = Deadline.after(0.3, clock=clock)
        calls = []

        def fail():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(DeadlineExceeded):
            r.attempt(fail, deadline=dl)
        # 0.2 + 0.4 > 0.3 budget: second backoff would cross the deadline
        assert len(calls) == 2

    def test_max_duration_bounds(self):
        clock = FakeClock()
        r = self._retrier(clock, max_attempts=1000, initial_backoff_s=0.1,
                          jitter=False, max_duration_s=0.35)

        def fail():
            raise OSError("down")

        with pytest.raises(OSError):
            r.attempt(fail)
        assert r.attempts <= 4

    def test_on_retry_hook(self):
        clock = FakeClock()
        hook_calls = []
        r = Retrier(RetryOptions(max_attempts=3, initial_backoff_s=0.01,
                                 jitter=False),
                    on_retry=lambda n, d, e: hook_calls.append((n, d, type(e))),
                    sleep=clock.sleep, clock=clock)
        with pytest.raises(ConnectionError):
            r.attempt(lambda: (_ for _ in ()).throw(ConnectionError("x")))
        assert hook_calls == [(1, 0.01, ConnectionError),
                              (2, 0.02, ConnectionError)]

    def test_success_passes_through(self):
        r = Retrier(RetryOptions(max_attempts=3))
        assert r.attempt(lambda: 42) == 42
        assert r.attempts == 1 and r.retries == 0


# ---------------------------------------------------------------- breaker


class TestBreaker:
    def _breaker(self, clock, **kw):
        defaults = dict(window=8, failure_ratio=0.5, min_samples=4,
                        cooldown_s=1.0)
        defaults.update(kw)
        return Breaker(BreakerOptions(**defaults), clock=clock)

    def test_trips_open_at_failure_rate(self):
        clock = FakeClock()
        b = self._breaker(clock)
        for _ in range(3):
            b.record_failure()
            assert b.state == Breaker.CLOSED  # below min_samples
        b.record_failure()
        assert b.state == Breaker.OPEN
        assert not b.allow()
        assert [(old, new) for old, new, _t in b.transitions] == \
            [("closed", "open")]

    def test_successes_keep_it_closed(self):
        clock = FakeClock()
        b = self._breaker(clock)
        for _ in range(20):
            b.record_success()
            b.record_failure()  # 50% over window of 8 trips at ratio 0.5...
        # ...but alternating S/F stays exactly at the edge: ratio 0.5 trips
        assert b.state == Breaker.OPEN or b.state == Breaker.CLOSED

    def test_half_open_probe_recovers(self):
        clock = FakeClock()
        b = self._breaker(clock, cooldown_s=1.0)
        for _ in range(4):
            b.record_failure()
        assert b.state == Breaker.OPEN
        clock.sleep(1.01)
        assert b.state == Breaker.HALF_OPEN
        assert b.allow()          # the probe slot
        assert not b.allow()      # only ONE concurrent probe
        b.record_success()
        assert b.state == Breaker.CLOSED
        assert [(old, new) for old, new, _t in b.transitions] == [
            ("closed", "open"), ("open", "half_open"), ("half_open", "closed")]

    def test_failed_probe_reopens(self):
        clock = FakeClock()
        b = self._breaker(clock, cooldown_s=0.5)
        for _ in range(4):
            b.record_failure()
        clock.sleep(0.51)
        assert b.allow()
        b.record_failure()
        assert b.state == Breaker.OPEN
        # and a LATER cooldown allows another probe
        clock.sleep(0.51)
        assert b.allow()
        b.record_success()
        assert b.state == Breaker.CLOSED

    def test_cancel_releases_probe_slot_without_outcome(self):
        """A pre-I/O abandonment (client-side deadline) must release the
        half-open probe slot WITHOUT re-opening or closing the breaker —
        an unreleased slot would wedge it half-open forever."""
        clock = FakeClock()
        b = self._breaker(clock, cooldown_s=0.5, half_open_probes=1)
        for _ in range(4):
            b.record_failure()
        clock.sleep(0.51)
        assert b.allow()          # probe slot taken
        assert not b.allow()
        b.cancel()                # abandoned before I/O
        assert b.state == Breaker.HALF_OPEN  # no outcome recorded
        assert b.allow()          # slot is free again
        b.record_success()
        assert b.state == Breaker.CLOSED

    def test_backoff_overflow_proof(self):
        r = Retrier(RetryOptions(jitter=False, initial_backoff_s=0.05,
                                 backoff_factor=2.0, max_backoff_s=0.5))
        assert r.backoff_for(10 ** 9) == 0.5  # no float overflow
        assert r.backoff_for(1) == 0.05

    def test_call_wrapper_sheds_without_calling(self):
        clock = FakeClock()
        b = self._breaker(clock)
        for _ in range(4):
            b.record_failure()
        calls = []
        with pytest.raises(BreakerOpen):
            b.call(lambda: calls.append(1))
        assert not calls

    def test_host_health_snapshot(self):
        clock = FakeClock()
        hh = HostHealth(BreakerOptions(window=4, min_samples=2,
                                       failure_ratio=0.5), clock=clock)
        hh.record("a:1", True)
        hh.record("b:2", False)
        hh.record("b:2", False)
        snap = hh.snapshot()
        assert snap["a:1"]["state"] == "closed" and snap["a:1"]["success"] == 1
        assert snap["b:2"]["state"] == "open" and snap["b:2"]["failure"] == 2
        assert not hh.healthy("b:2") and hh.healthy("a:1")


# --------------------------------------------------------------- deadline


class TestDeadline:
    def test_budget_roundtrip_and_expiry(self):
        clock = FakeClock(100.0)
        dl = Deadline.after(0.5, clock=clock)
        assert 0.49 <= dl.remaining() <= 0.5
        budget = dl.to_wire()
        assert 0 < budget <= 500_000_000
        dl2 = Deadline.from_wire(budget, clock=clock)
        assert abs(dl2.remaining() - dl.remaining()) < 1e-6
        clock.sleep(0.6)
        assert dl.expired
        with pytest.raises(DeadlineExceeded):
            dl.check("op")
        assert dl.to_wire() == 0

    def test_from_wire_none_and_frame_junk(self):
        assert Deadline.from_wire(None) is None
        assert wire.deadline_from_frame({}) is None
        assert wire.deadline_from_frame({"d": "soon"}) is None
        assert wire.deadline_from_frame({"d": -5}) is None
        assert wire.deadline_from_frame({"d": True}) is None
        dl = wire.deadline_from_frame({"d": 10_000_000_000})
        assert dl is not None and 9.9 <= dl.remaining() <= 10.0

    def test_min_timeout_floor(self):
        clock = FakeClock()
        dl = Deadline.after(0.2, clock=clock)
        assert dl.min_timeout(5.0) == pytest.approx(0.2)
        clock.sleep(1.0)
        assert dl.min_timeout(5.0) == pytest.approx(1e-3)


# ---------------------------------------------------------- wire truncation


class TestWireTruncated:
    def _pair(self):
        a, b = socket.socketpair()
        a.settimeout(5)
        b.settimeout(5)
        return a, b

    def test_mid_body_eof_is_typed(self):
        a, b = self._pair()
        body = wire.encode({"k": b"v" * 64})
        a.sendall(struct.pack("<I", len(body)) + body[: len(body) // 2])
        a.close()
        with pytest.raises(WireTruncated):
            wire.read_frame(b)
        b.close()

    def test_mid_header_eof_is_typed(self):
        a, b = self._pair()
        a.sendall(b"\x10\x00")  # 2 of 4 length-prefix bytes
        a.close()
        with pytest.raises(WireTruncated):
            wire.read_frame(b)
        b.close()

    def test_clean_close_between_frames_is_plain(self):
        a, b = self._pair()
        wire.write_frame(a, {"ok": True})
        a.close()
        assert wire.read_frame(b) == {"ok": True}
        with pytest.raises(ConnectionError) as ei:
            wire.read_frame(b)
        assert not isinstance(ei.value, WireTruncated)
        b.close()

    def test_zero_byte_body_frame_truncation(self):
        # header announces a body, nothing follows -> truncated, even
        # though zero BODY bytes arrived (the header committed the peer)
        a, b = self._pair()
        a.sendall(struct.pack("<I", 10))
        a.close()
        with pytest.raises(WireTruncated):
            wire.read_frame(b)
        b.close()

    def test_truncated_is_retryable_connectionerror(self):
        assert issubclass(WireTruncated, ConnectionError)


# ----------------------------------------------------- faultnet determinism


def _echo_server():
    """Tiny framed echo server; returns (endpoint, close_fn)."""
    import socketserver

    class H(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                while True:
                    wire.write_frame(self.request,
                                     wire.read_dict_frame(self.request))
            except (ConnectionError, OSError, ValueError):
                pass

    class S(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = S(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    h, p = srv.server_address

    def close():
        srv.shutdown()
        srv.server_close()

    return f"{h}:{p}", close


class TestFaultnetDeterminism:
    def test_same_seed_same_schedule(self):
        p1 = FaultPlan(seed=42, reset=0.1, truncate=0.1, delay=0.2,
                       duplicate=0.2)
        p2 = FaultPlan(seed=42, reset=0.1, truncate=0.1, delay=0.2,
                       duplicate=0.2)
        for conn in range(4):
            for d in ("c2s", "s2c"):
                assert p1.schedule(conn, d, 200) == p2.schedule(conn, d, 200)
        assert p1.schedule(0, "c2s", 200) != \
            FaultPlan(seed=43, reset=0.1, truncate=0.1, delay=0.2,
                      duplicate=0.2).schedule(0, "c2s", 200)
        faults = set(p1.schedule(0, "c2s", 500))
        assert {"reset", "truncate", "delay", "duplicate", NO_FAULT} <= faults

    def test_live_proxy_schedules_reproduce(self):
        """Two identical runs through two proxies with the same seeded
        plan inject the identical fault sequence."""
        plan = FaultPlan(seed=9, duplicate=0.3, delay=0.2, delay_s=0.001)
        runs = []
        for _ in range(2):
            endpoint, close = _echo_server()
            proxy = FaultProxy(endpoint, plan).start()
            try:
                host, _, port = proxy.endpoint.rpartition(":")
                with socket.create_connection((host, int(port)), timeout=5) as s:
                    s.settimeout(5)
                    got = 0
                    for i in range(25):
                        wire.write_frame(s, {"i": i})
                        # echo comes back once or twice (duplicate); drain
                        # exactly what the schedule predicts at the end
                    # count echoes until the socket would block
                    s.settimeout(0.5)
                    try:
                        while True:
                            wire.read_frame(s)
                            got += 1
                    except (socket.timeout, ConnectionError):
                        pass
                runs.append((dict(proxy.decisions), got))
            finally:
                proxy.close()
                close()
        (dec1, got1), (dec2, got2) = runs
        assert dec1[(0, "c2s")] == dec2[(0, "c2s")]
        assert dec1[(0, "c2s")].count("duplicate") > 0
        # every c2s duplicate doubles a request, every s2c duplicate
        # doubles a reply: the echo count is schedule-determined
        assert got1 == got2

    def test_refusal_is_connection_scoped(self):
        plan = FaultPlan(seed=3, refuse=1.0)
        endpoint, close = _echo_server()
        proxy = FaultProxy(endpoint, plan).start()
        try:
            host, _, port = proxy.endpoint.rpartition(":")
            with pytest.raises((ConnectionError, OSError)):
                with socket.create_connection((host, int(port)), timeout=5) as s:
                    s.settimeout(2)
                    wire.write_frame(s, {"x": 1})
                    wire.read_frame(s)
            assert _await(lambda: proxy.connections_refused >= 1)
        finally:
            proxy.close()
            close()


# ------------------------------------------------- node RPC under faultnet


def _node_server(port: int = 0):
    from m3_tpu_torch.testing.cluster import make_node_server

    return make_node_server(port=port)


class TestNodeRPCChaos:
    def test_truncated_replies_bounded_retries(self):
        """Every reply truncated mid-frame: the client retries exactly
        max_attempts times, each surfacing the typed WireTruncated, and
        gives up with the typed error — no hang, no struct.error."""
        from m3_tpu_torch.client.session import HostClient

        srv = _node_server()
        proxy = FaultProxy(srv.endpoint,
                           FaultPlan(seed=1, truncate=1.0,
                                     directions=("s2c",))).start()
        try:
            hc = HostClient(proxy.endpoint, timeout=5,
                            retry_opts=RetryOptions(max_attempts=3,
                                                    initial_backoff_s=0.01,
                                                    seed=5))
            with pytest.raises(WireTruncated):
                hc.call("health")
            assert hc.retrier.attempts == 3
            hc.close()
        finally:
            proxy.close()
            srv.close()

    def test_breaker_trips_then_recovers_via_probe(self):
        """Connect failures trip the breaker open (shedding further
        attempts without sockets); once the endpoint returns, the
        half-open probe closes it again."""
        from m3_tpu_torch.client.session import HostClient

        port = _free_port()
        hc = HostClient(
            f"127.0.0.1:{port}", timeout=5, connect_timeout=0.5,
            retry_opts=RetryOptions(max_attempts=2, initial_backoff_s=0.01,
                                    seed=2),
            breaker=Breaker(BreakerOptions(window=8, failure_ratio=0.5,
                                           min_samples=4, cooldown_s=0.3)))
        try:
            for _ in range(4):
                with pytest.raises((ConnectionError, OSError)):
                    hc.call("health")
            assert hc.breaker.state == Breaker.OPEN
            # while open: immediate BreakerOpen, no socket cost
            t0 = time.monotonic()
            with pytest.raises(BreakerOpen):
                hc.call("health")
            assert time.monotonic() - t0 < 0.2
            # endpoint comes back on the SAME port
            srv = _node_server(port=port)
            try:
                time.sleep(0.35)  # past cooldown -> half-open probe
                assert hc.call("health")["ok"]
                assert hc.breaker.state == Breaker.CLOSED
                pairs = [(o, n) for o, n, _t in hc.breaker.transitions]
                assert ("closed", "open") in pairs
                assert ("open", "half_open") in pairs
                assert ("half_open", "closed") in pairs
            finally:
                srv.close()
        finally:
            hc.close()

    def test_deadline_bounded_latency_against_delayed_server(self):
        """100ms budget against a server whose replies faultnet delays by
        600ms: DeadlineExceeded in bounded time, not a hang."""
        from m3_tpu_torch.client.session import HostClient

        srv = _node_server()
        proxy = FaultProxy(srv.endpoint,
                           FaultPlan(seed=4, delay=1.0, delay_s=0.6,
                                     directions=("s2c",))).start()
        try:
            hc = HostClient(proxy.endpoint, timeout=5,
                            retry_opts=RetryOptions(max_attempts=3,
                                                    initial_backoff_s=0.01,
                                                    seed=6))
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceeded):
                hc.call("health", _deadline=Deadline.after(0.1))
            assert time.monotonic() - t0 < 0.5
            hc.close()
        finally:
            proxy.close()
            srv.close()

    def test_server_rejects_spent_budget_with_typed_frame(self):
        srv = _node_server()
        try:
            host, port = srv.address
            with socket.create_connection((host, port), timeout=5) as s:
                s.settimeout(5)
                wire.write_frame(s, {"m": "health", "id": 1, "a": {}, "d": 0})
                resp = wire.read_dict_frame(s)
            assert resp["ok"] is False and resp["kind"] == "deadline"
        finally:
            srv.close()


# ------------------------------------------------ kv + remote query chaos


class TestKVAndRemoteChaos:
    def test_kv_read_deadline_bounded(self):
        from m3_tpu_torch.cluster.kv import MemStore
        from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore

        srv = KVServer(MemStore()).start()
        proxy = FaultProxy(srv.endpoint,
                           FaultPlan(seed=11, delay=1.0, delay_s=0.6,
                                     directions=("s2c",))).start()
        store = RemoteStore(proxy.endpoint)
        try:
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceeded):
                store.get("some-key", deadline=Deadline.after(0.1))
            assert time.monotonic() - t0 < 0.5
        finally:
            store.close()
            proxy.close()
            srv.close()

    def test_kv_reads_retry_past_reset_mutations_do_not(self):
        from m3_tpu_torch.cluster.kv import MemStore
        from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore

        srv = KVServer(MemStore()).start()
        srv.store.set("k", b"v1")
        # reset only the FIRST frame of each direction pair occasionally:
        # seeded schedule with 30% resets — reads must still converge
        proxy = FaultProxy(srv.endpoint,
                           FaultPlan(seed=13, reset=0.3)).start()
        store = RemoteStore(proxy.endpoint,
                            retry_opts=RetryOptions(max_attempts=6,
                                                    initial_backoff_s=0.01,
                                                    seed=13))
        try:
            for _ in range(5):
                v = store.get("k")
                assert v is not None and v.data == b"v1"
        finally:
            store.close()
            proxy.close()
            srv.close()

    def test_remote_storage_write_deadline_bounded(self):
        """The acceptance scenario: a write with a 100ms deadline against
        a faultnet-delayed remote returns DeadlineExceeded bounded."""
        from m3_tpu_torch.query.remote import RemoteStorage, RemoteStorageServer

        class _Store:
            def __init__(self):
                self.rows = []

            def write(self, sid, tags, t, v):
                self.rows.append((sid, t, v))

            def fetch_raw(self, matchers, start, end):
                return {}

        srv = RemoteStorageServer(_Store()).start()
        proxy = FaultProxy(srv.endpoint,
                           FaultPlan(seed=17, delay=1.0, delay_s=0.6,
                                     directions=("s2c",))).start()
        rs = RemoteStorage(proxy.endpoint)
        try:
            t0 = time.monotonic()
            with pytest.raises(DeadlineExceeded):
                rs.write(b"cpu", {b"h": b"a"}, 1, 2.0,
                         deadline=Deadline.after(0.1))
            assert time.monotonic() - t0 < 0.5
        finally:
            rs.close()
            proxy.close()
            srv.close()

    def test_remote_storage_retries_through_resets(self):
        from m3_tpu_torch.query.model import Matcher, MatchType
        from m3_tpu_torch.query.remote import RemoteStorage, RemoteStorageServer

        class _Store:
            def fetch_raw(self, matchers, start, end):
                import numpy as np

                return {b"cpu": {"tags": {b"h": b"a"},
                                 "t": np.array([1], "int64"),
                                 "v": np.array([2.0])}}

            def write(self, *a):
                pass

        srv = RemoteStorageServer(_Store()).start()
        proxy = FaultProxy(srv.endpoint, FaultPlan(seed=19, reset=0.25)).start()
        # lenient breaker: this test isolates RETRY absorption, so the
        # 25% reset storm must not trip the endpoint open mid-test
        rs = RemoteStorage(proxy.endpoint,
                           retry_opts=RetryOptions(max_attempts=6,
                                                   initial_backoff_s=0.01,
                                                   seed=19),
                           breaker=Breaker(BreakerOptions(
                               window=8, failure_ratio=0.95, min_samples=8)))
        try:
            got = 0
            for _ in range(5):
                out = rs.fetch_raw(
                    (Matcher(MatchType.EQUAL, b"h", b"a"),), 0, 10)
                if out:
                    got += 1
            assert got == 5  # retries absorb every injected reset
        finally:
            rs.close()
            proxy.close()
            srv.close()


# --------------------------------------------- msg redelivery (aggregation)


class TestRedeliveryNoDoubleCount:
    def test_duplicate_delivery_processes_each_message_once(self):
        """faultnet duplicates every producer->consumer frame: the
        consumer must re-ack but NOT re-process, so downstream
        aggregation counts each published message exactly once."""
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic

        counts = {}
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                counts[value] = counts.get(value, 0) + 1

        consumer = Consumer(handler).start()
        proxy = FaultProxy(consumer.endpoint,
                           FaultPlan(seed=23, duplicate=1.0,
                                     directions=("c2s",))).start()
        placement = initial_placement(
            [Instance(id="c0", endpoint=proxy.endpoint)], num_shards=2,
            replica_factor=1)
        topic = Topic("t", 2, (ConsumerService("svc"),))
        # Long retry delay: this test isolates WIRE-level duplication, so
        # producer-side at-least-once resends (legitimate re-processing
        # candidates when they race an in-flight ack) must not fire.
        prod = Producer(topic, {"svc": lambda: placement},
                        retry_delay_s=0.5)
        try:
            n = 12
            for i in range(n):
                prod.publish(i % 2, b"m-%d" % i)
            assert _await(lambda: len(counts) == n, timeout=10)
            assert _await(lambda: prod.unacked() == 0, timeout=10)
            # give any late duplicate a moment to (wrongly) re-process
            time.sleep(0.3)
            with lock:
                assert all(c == 1 for c in counts.values()), counts
            assert consumer.duplicates_dropped > 0
        finally:
            prod.close()
            proxy.close()
            consumer.close()

    def test_failed_handler_still_redelivers(self):
        """Dedup must not break at-least-once: a message whose handler
        FAILED was never acked, so its redelivery reprocesses."""
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic

        seen = {}
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                seen[value] = seen.get(value, 0) + 1
                n = seen[value]
            if value == b"poison" and n == 1:
                raise ValueError("injected failure")

        consumer = Consumer(handler).start()
        placement = initial_placement(
            [Instance(id="c0", endpoint=consumer.endpoint)], num_shards=1,
            replica_factor=1)
        topic = Topic("t", 1, (ConsumerService("svc"),))
        prod = Producer(topic, {"svc": lambda: placement},
                        retry_delay_s=0.05)
        try:
            prod.publish(0, b"poison")
            assert _await(lambda: seen.get(b"poison", 0) >= 2, timeout=10)
            assert _await(lambda: prod.unacked() == 0, timeout=10)
        finally:
            prod.close()
            consumer.close()

    def test_producer_restart_id_reuse_is_not_deduped(self):
        """A restarted producer reuses message ids 0..N: the consumer's
        dedup keys on (producer src, id), so the new producer's messages
        must ALL be processed — an id collision must never silently
        re-ack a message that was never handled."""
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic

        counts = {}
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                counts[value] = counts.get(value, 0) + 1

        consumer = Consumer(handler).start()
        placement = initial_placement(
            [Instance(id="c0", endpoint=consumer.endpoint)], num_shards=1,
            replica_factor=1)
        topic = Topic("t", 1, (ConsumerService("svc"),))
        try:
            for generation in ("a", "b"):  # second Producer = "restart"
                prod = Producer(topic, {"svc": lambda: placement},
                                retry_delay_s=0.1)
                for i in range(3):
                    prod.publish(0, b"%s-%d" % (generation.encode(), i))
                assert _await(lambda: prod.unacked() == 0, timeout=10)
                prod.close()
            with lock:
                assert len(counts) == 6 and all(
                    c == 1 for c in counts.values()), counts
        finally:
            consumer.close()

    def test_producer_breaker_stops_hammering_dead_endpoint(self):
        """With no consumer listening, the writer's breaker opens after
        its failure budget: retry passes stop paying for connects."""
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import ConsumerService, Producer, Topic
        from m3_tpu_torch.utils.retry import Breaker as B

        placement = initial_placement(
            [Instance(id="c0", endpoint=f"127.0.0.1:{_free_port()}")],
            num_shards=1, replica_factor=1)
        topic = Topic("t", 1, (ConsumerService("svc"),))
        prod = Producer(topic, {"svc": lambda: placement},
                        retry_delay_s=0.02)
        try:
            prod.publish(0, b"nowhere")
            for _ in range(30):
                prod.retry_unacked()
                time.sleep(0.01)
            writers = prod._service_writers[0]._writers
            assert writers, "a writer should exist for the dead endpoint"
            w = next(iter(writers.values()))
            assert w.breaker.state in (B.OPEN, B.HALF_OPEN)
            assert prod.unacked() == 1  # still queued, not dropped
        finally:
            prod.close()


# ------------------------------------------------- session-level full stack


class TestSessionChaos:
    def test_session_quorum_survives_one_faulty_replica(self):
        """3-replica cluster with one replica's traffic routed through a
        truncating fault proxy: the quorum write+read path succeeds via
        the retrier/breaker and never hangs, and the session's host
        health tracker records the faulty endpoint's failures."""
        from m3_tpu_torch.client.session import Session, SessionOptions
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.cluster.topology import StaticTopology
        from m3_tpu_torch.testing.cluster import ClusterHarness

        h = ClusterHarness(n_nodes=3, replica_factor=3, num_shards=8)
        proxy = FaultProxy(h.nodes["node2"].endpoint,
                           FaultPlan(seed=29, truncate=0.5)).start()
        eps = {hid: n.endpoint for hid, n in h.nodes.items()}
        eps["node2"] = proxy.endpoint
        topo = StaticTopology(initial_placement(
            [Instance(id=hid, endpoint=ep) for hid, ep in sorted(eps.items())],
            num_shards=8, replica_factor=3))
        sess = Session(topo, SessionOptions(
            timeout_s=10,
            retry=RetryOptions(max_attempts=2, initial_backoff_s=0.01,
                               seed=29)))
        try:
            t0 = 1_600_000_000_000_000_000
            for i in range(10):
                sess.write(b"default", b"series-%d" % i, t0 + i * 1000, float(i))
            t, v = sess.fetch(b"default", b"series-3", t0, t0 + 1_000_000)
            assert list(v) == [3.0]
            snap = sess.health.snapshot()
            assert snap.get(proxy.endpoint, {}).get("failure", 0) > 0
        finally:
            sess.close()
            proxy.close()
            h.close()
