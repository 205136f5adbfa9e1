"""The port's aggregator network side (m3_tpu_torch.aggregator.{server,
migration,client}) against the reference's, on the CPU with
device="cpu" aggregators: the dual-format migration reader (framed
binary and legacy JSON lines on one connection, bad records, oversize
frames, desync), the raw TCP server, the HTTP admin sidecar (/health,
/status, /resign, /ingest) and its HTTP transport, columnar timed
(tbatch) and forwarded (fbatch) batches; the bytes every TCPTransport
send and write_legacy put on the wire equal the reference's; each
package's transport feeds the other's server to bit-equal rows;
forwarded pipelines cross instances over TCPTransport; and a leader
/resign hands the flush to its follower with no gap and no duplicate
window in the stored rows. Servers are real localhost listeners, closed
in `finally`; every wait has a deadline."""

import json
import math
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from m3_tpu.aggregator import Aggregator as JAggregator
from m3_tpu.aggregator import CaptureHandler as JCaptureHandler
from m3_tpu.aggregator import migration as jmigration
from m3_tpu.aggregator import server as jserver
from m3_tpu.metrics import aggregation as jmagg
from m3_tpu.metrics import metadata as jmeta
from m3_tpu.metrics import pipeline as jpipe
from m3_tpu.metrics.metric import MetricUnion as JMetricUnion
from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
from m3_tpu.rpc import wire as jwire
from m3_tpu_torch.aggregator import (Aggregator, AggregatorClient,
                                     CaptureHandler, ElectionManager,
                                     FlushTimesManager, ProducerHandler)
from m3_tpu_torch.aggregator.migration import (MIGRATION_MAX_FRAME,
                                               MigrationReader,
                                               RecoverableRecordError,
                                               legacy_to_entry, write_legacy)
from m3_tpu_torch.aggregator.server import (HTTPAdminServer, HTTPTransport,
                                            RawTCPServer, TCPTransport,
                                            union_to_wire)
from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore
from m3_tpu_torch.cluster.placement import Instance, initial_placement
from m3_tpu_torch.cluster.services import LeaderService
from m3_tpu_torch.coordinator.ingest import M3MsgIngester
from m3_tpu_torch.metrics import aggregation as magg
from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                           StagedMetadata)
from m3_tpu_torch.metrics.metric import MetricType, MetricUnion
from m3_tpu_torch.metrics.pipeline import Op, Pipeline
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.query.storage import LocalStorage
from m3_tpu_torch.rpc import wire
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.testing.cluster import SettableClock

S = 1_000_000_000
T0 = 1_700_000_000 * S - (1_700_000_000 * S) % (60 * S)
TEN_S = StoragePolicy.of("10s", "2d")
ONE_M = StoragePolicy.parse("1m:40h")
CPU = "cpu"


def _await(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _md(policy=TEN_S, agg_id=0, pipeline=None):
    pm = (PipelineMetadata(agg_id, (policy,)) if pipeline is None
          else PipelineMetadata(agg_id, (policy,), pipeline))
    return (StagedMetadata(0, False, Metadata((pm,))),)


def _jmd(policy="10s:2d", agg_id=0, pipeline=None):
    pol = JStoragePolicy.parse(policy)
    pm = (jmeta.PipelineMetadata(agg_id, (pol,)) if pipeline is None
          else jmeta.PipelineMetadata(agg_id, (pol,), pipeline))
    return (jmeta.StagedMetadata(0, False, jmeta.Metadata((pm,))),)


def _row(m):
    """(id, time, value bits, policy); every NaN is one NaN."""
    v = "nan" if math.isnan(m.value) else float(m.value).hex()
    return (bytes(m.id), int(m.time_nanos), v, str(m.storage_policy))


def _rows(cap):
    return sorted(_row(m) for m in cap.metrics)


def _agg(clock, cap=None, **kw):
    return Aggregator(num_shards=8, clock=clock,
                      flush_handler=cap if cap is not None else CaptureHandler(),
                      device=CPU, **kw)


def _connect(endpoint):
    host, _, port = endpoint.rpartition(":")
    return socket.create_connection((host, int(port)), timeout=5)


# -- the migration reader -----------------------------------------------------

LEGACY = [
    {"type": "counter", "id": "req.count", "value": 7,
     "policies": ["10s:2d", "1m:40d"]},
    {"type": "timer", "id": "lat", "value": [1, 2.5], "policies": ["10s:2d"]},
    {"type": "gauge", "id": "g", "value": -0.0, "policies": []},
    {"type": "counter", "id": "c", "value": 3.0},
]


@pytest.mark.parametrize("rec", LEGACY, ids=[r["type"] + ":" + r["id"]
                                             for r in LEGACY])
def test_legacy_to_entry_equal_reference(rec):
    entry = legacy_to_entry(dict(rec))
    assert entry == jmigration.legacy_to_entry(dict(rec))
    assert entry["t"] == "untimed" and entry["id"] == rec["id"].encode()
    pipes = entry["metadatas"][0]["pipelines"]
    assert pipes[0]["agg_id"] == 0 and pipes[0]["pipeline"] == []


def test_legacy_to_entry_refuses_unknown_type():
    with pytest.raises(ValueError):
        legacy_to_entry({"type": "histogram", "id": "x", "value": 1})


def _pair_bytes(write):
    a, b = socket.socketpair()
    try:
        write(a)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return bytes(out)
            out += chunk
    finally:
        a.close()
        b.close()


def test_write_legacy_bytes_equal_reference():
    for rec in LEGACY:
        args = (rec["type"], rec["id"], rec["value"], rec.get("policies", []))
        assert _pair_bytes(lambda s: write_legacy(s, *args)) == \
            _pair_bytes(lambda s: jmigration.write_legacy(s, *args))


def test_reader_reads_a_mixed_stream_like_the_reference():
    """Frames written by the reference's wire and legacy lines, read by
    both packages' readers: the same entries, in order."""
    ts = np.array([T0, T0 + 10 * S], np.int64)
    vs = np.array([1.5, -2.0])

    def write(s):
        jwire.write_frame(s, jserver.union_to_wire(
            JMetricUnion.counter(b"a", 3), _jmd()))
        jmigration.write_legacy(s, "gauge", "b", 1.25, ["10s:2d"])
        jwire.write_frame(s, {"t": "batch", "entries": [
            jserver.union_to_wire(JMetricUnion.batch_timer(b"t", [1.0, 2.0]),
                                  _jmd())]})
        jwire.write_frame(s, {"t": "tbatch", "mtype": 2, "policy": "10s:2d",
                              "agg_id": 0, "ids": [b"x", b"y"],
                              "times": ts, "values": vs})

    data = _pair_bytes(write)
    out = []
    for cls in (MigrationReader, jmigration.MigrationReader):
        a, b = socket.socketpair()
        try:
            a.sendall(data)
            a.shutdown(socket.SHUT_WR)
            reader, got = cls(b), []
            with pytest.raises(ConnectionError):
                while True:
                    got += reader.read_entries()
            out.append(got)
        finally:
            a.close()
            b.close()
    assert [e["t"] for e in out[0]] == ["untimed", "untimed", "untimed",
                                        "tbatch"]
    assert _pair_bytes(lambda s: wire.write_frame(s, out[0])) == \
        _pair_bytes(lambda s: jwire.write_frame(s, out[1]))


def test_migration_reader_oversize_frame_rejected():
    a, b = socket.socketpair()
    try:
        a.sendall((MIGRATION_MAX_FRAME + 1).to_bytes(4, "little") + b"x")
        with pytest.raises(ValueError):
            MigrationReader(b).read_entries()
    finally:
        a.close()
        b.close()


def test_migration_reader_desync_line_is_unrecoverable():
    a, b = socket.socketpair()
    try:
        a.sendall(b"\x7b\xff\xfe\xfd\x00\x01binary\n")
        with pytest.raises(ValueError, match="desync") as err:
            MigrationReader(b).read_entries()
        assert not isinstance(err.value, RecoverableRecordError)
    finally:
        a.close()
        b.close()


# -- the raw TCP server -------------------------------------------------------

def test_server_takes_the_aggregator_device():
    agg = _agg(SettableClock(T0))
    srv, admin = RawTCPServer(agg), HTTPAdminServer(agg)
    try:
        assert srv.device == admin.device == agg.device == torch.device(CPU)
    finally:
        srv._server.server_close()
        admin._server.server_close()


def test_mixed_format_stream_one_connection():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    try:
        sock = _connect(srv.endpoint)
        wire.write_frame(sock, union_to_wire(
            MetricUnion.counter(b"mixed.count", 3), _md()))
        write_legacy(sock, "counter", "mixed.count", 4, ["10s:2d"])
        wire.write_frame(sock, union_to_wire(
            MetricUnion.counter(b"mixed.count", 5), _md()))
        assert _await(lambda: srv.frames >= 3)
        assert agg.num_entries() == 1
        clock.advance(10 * S)
        agg.flush()
        out = cap.by_id(b"mixed.count")
        assert len(out) == 1 and out[0].value == 12.0
        assert srv.errors == 0
        sock.close()
    finally:
        srv.close()


def test_legacy_only_client_gauge_and_timer():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    try:
        sock = _connect(srv.endpoint)
        write_legacy(sock, "gauge", "legacy.gauge", 42.5, ["10s:2d"])
        write_legacy(sock, "timer", "legacy.timer", [1.0, 3.0, 2.0],
                     ["10s:2d"])
        assert _await(lambda: srv.frames >= 2)
        clock.advance(10 * S)
        agg.flush()
        gauges = cap.by_id(b"legacy.gauge")
        assert len(gauges) == 1 and gauges[0].value == 42.5
        assert any(m.id.startswith(b"legacy.timer") for m in cap.metrics)
        sock.close()
    finally:
        srv.close()


def test_bad_legacy_record_does_not_kill_connection():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    try:
        sock = _connect(srv.endpoint)
        write_legacy(sock, "histogram", "bad.type", 1, ["10s:2d"])
        write_legacy(sock, "counter", "good.count", 2, ["10s:2d"])
        assert _await(lambda: srv.frames >= 1)
        assert srv.errors == 1
        clock.advance(10 * S)
        agg.flush()
        out = cap.by_id(b"good.count")
        assert len(out) == 1 and out[0].value == 2.0
        sock.close()
    finally:
        srv.close()


def test_columnar_timed_batch_roundtrip():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    try:
        n = 300
        ids = [b"tb.%d" % (i % 50) for i in range(n)]
        times = np.array([T0 + (i % 3) * 10 * S for i in range(n)], np.int64)
        values = np.arange(n, dtype=np.float64)
        sock = _connect(srv.endpoint)
        wire.write_frame(sock, {
            "t": "tbatch", "mtype": int(MetricType.COUNTER),
            "policy": "10s:2d", "agg_id": 0,
            "ids": ids, "times": times, "values": values})
        assert _await(lambda: srv.frames >= n)  # records, not frames
        assert srv.errors == 0
        clock.advance(40 * S)
        agg.flush()
        want = {}
        for mid, t, v in zip(ids, times.tolist(), values.tolist()):
            want[(mid, t // (10 * S))] = want.get((mid, t // (10 * S)), 0.0) + v
        got = {}
        for m in cap.metrics:
            key = (m.id, m.time_nanos // (10 * S) - 1)  # window end stamp
            got[key] = got.get(key, 0.0) + m.value
        assert got == want
        sock.close()
    finally:
        srv.close()


def test_columnar_timed_batch_via_transport():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    tr = TCPTransport(srv.endpoint)
    try:
        assert tr.send_timed_batch(
            MetricType.GAUGE, TEN_S, [b"tg.1", b"tg.2"], [T0, T0], [4.5, 6.5])
        assert _await(lambda: srv.frames >= 2)
        clock.advance(10 * S)
        agg.flush()
        assert cap.by_id(b"tg.1")[0].value == 4.5
        assert cap.by_id(b"tg.2")[0].value == 6.5
    finally:
        tr.close()
        srv.close()


def test_columnar_batches_with_bad_columns_count_errors():
    """Ragged or mistyped tbatch/fbatch frames are rejected whole (no
    partial prefix aggregates), counted in records, and the connection
    keeps ingesting."""
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = RawTCPServer(agg).start()
    try:
        sock = _connect(srv.endpoint)
        wire.write_frame(sock, {
            "t": "tbatch", "mtype": int(MetricType.COUNTER),
            "policy": "10s:2d", "agg_id": 0,
            "ids": [b"ragged.1", b"ragged.2"],
            "times": np.array([T0], np.int64),
            "values": np.array([1.0, 2.0], np.float64)})
        wire.write_frame(sock, {
            "t": "tbatch", "mtype": int(MetricType.COUNTER),
            "policy": "10s:2d", "agg_id": 0,
            "ids": [b"typed.ok", "typed.bad-str"],
            "times": np.array([T0, T0], np.int64),
            "values": np.array([1.0, 2.0], np.float64)})
        wire.write_frame(sock, {
            "t": "fbatch", "mtype": int(MetricType.GAUGE), "agg_id": 0,
            "policy": "10s:2d", "pipeline": [], "num_times": 1,
            "ids": [b"f.1", b"f.2"], "source_ids": [b"s"],
            "times": np.array([T0, T0], np.int64),
            "values": np.array([1.0, 2.0])})
        wire.write_frame(sock, {
            "t": "timed", "mtype": int(MetricType.COUNTER),
            "id": b"after.ragged", "time": T0, "value": 7.0,
            "policy": "10s:2d"})
        assert _await(lambda: srv.errors >= 6 and srv.frames >= 1)
        clock.advance(10 * S)
        agg.flush()
        assert cap.by_id(b"after.ragged")[0].value == 7.0
        for mid in (b"typed.ok", b"ragged.1", b"f.1"):
            assert not cap.by_id(mid)
        sock.close()
    finally:
        srv.close()


def test_shed_records_are_counted_not_ingested():
    """A full admission gate drops raw-TCP records and counts them."""
    from m3_tpu_torch.utils.health import AdmissionGate

    clock = SettableClock(T0)
    agg = _agg(clock)
    gate = AdmissionGate(capacity=4, name="test.rawtcp")
    srv = RawTCPServer(agg, gate=gate).start()
    try:
        gate.admit(4)
        sock = _connect(srv.endpoint)
        wire.write_frame(sock, union_to_wire(MetricUnion.counter(b"x", 1), _md()))
        assert _await(lambda: srv.shed == 1)
        gate.release(4)
        wire.write_frame(sock, union_to_wire(MetricUnion.counter(b"x", 1), _md()))
        assert _await(lambda: srv.frames == 1)
        assert agg.num_entries() == 1
        sock.close()
    finally:
        srv.close()


# -- the admin sidecar ---------------------------------------------------------

def _get(endpoint, path):
    with urllib.request.urlopen(endpoint + path, timeout=10) as r:
        return json.loads(r.read())


def _post(endpoint, path, body=b""):
    req = urllib.request.Request(endpoint + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_ingest_variant():
    clock = SettableClock(T0)
    cap = CaptureHandler()
    agg = _agg(clock, cap)
    srv = HTTPAdminServer(agg).start()
    try:
        body = (b'{"type": "counter", "id": "http.count", "value": 7, '
                b'"policies": ["10s:2d"]}\n'
                b'{"type": "bogus", "id": "x", "value": 1}\n')
        code, out = _post(srv.endpoint, "/ingest", body)
        assert code == 400 and out["accepted"] == 1, out
        tr = HTTPTransport(srv.endpoint, batch_size=1)
        assert tr(MetricUnion.counter(b"http.count", 5), _md())
        tr2 = HTTPTransport(srv.endpoint, batch_size=8)
        assert tr2(MetricUnion.gauge(b"http.gauge", 2.5), _md())
        assert tr2.flush()
        assert agg.num_entries() == 2
        clock.advance(10 * S)
        agg.flush()
        out = cap.by_id(b"http.count")
        assert len(out) == 1 and out[0].value == 12.0
        assert cap.by_id(b"http.gauge")[0].value == 2.5
    finally:
        srv.close()


def test_http_admin_health_status_resign_without_election():
    clock = SettableClock(T0)
    agg = _agg(clock)
    srv = HTTPAdminServer(agg).start()
    try:
        assert _get(srv.endpoint, "/health") == {"state": "OK"}
        st = _get(srv.endpoint, "/status")["status"]
        assert st == {"flushStatus": {"electionState": "leader",
                                      "canLead": True},
                      "numEntries": 0, "forwardedReceived": 0}
        assert _post(srv.endpoint, "/resign")[0] == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.endpoint, "/nope")
        assert err.value.code == 404
        assert _post(srv.endpoint, "/nope")[0] == 404
    finally:
        srv.close()


def test_admin_answers_equal_reference():
    """The same requests to both packages' sidecars give the same JSON."""
    clock = SettableClock(T0)
    agg, jagg = _agg(clock), JAggregator(num_shards=8, clock=clock,
                                         flush_handler=JCaptureHandler())
    srvs = [HTTPAdminServer(agg).start(), jserver.HTTPAdminServer(jagg).start()]
    try:
        body = (b'{"type": "gauge", "id": "g", "value": 1.5}\n'
                b'{"type": "counter", "id": 5, "value": 1}\n'
                b'\n{"type": "timer", "id": "t", "value": [1, 2]}\n')
        answers = []
        for srv in srvs:
            answers.append([_post(srv.endpoint, "/ingest", body),
                            _get(srv.endpoint, "/status"),
                            _get(srv.endpoint, "/health"),
                            _post(srv.endpoint, "/resign")])
        assert answers[0] == answers[1]
    finally:
        for srv in srvs:
            srv.close()


# -- transports: bytes and cross-package pairs --------------------------------

class _Capture:
    """A localhost listener that records every byte of its connections."""

    def __init__(self):
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self.endpoint = "127.0.0.1:%d" % self._lsock.getsockname()[1]
        self.data = bytearray()
        self.finished = 0  # connections read to their end
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            while True:
                try:
                    chunk = c.recv(1 << 16)
                except OSError:
                    break
                if not chunk:
                    break
                self.data += chunk
            c.close()
            self.finished += 1

    def close(self):
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._lsock.close()
        self._thread.join(timeout=5)


def _transport_traffic(mods, tr):
    """One fixed session of sends through a TCPTransport of `mods`."""
    agg_mod, pipe_mod, meta_mod, metric_mod, pol_mod = mods
    pol = pol_mod.StoragePolicy.parse("1m:40h")
    pipe = pipe_mod.Pipeline((pipe_mod.Op.roll(
        b"roll", (b"host",), agg_mod.AggID.compress([agg_mod.AggType.SUM])),))
    md = (meta_mod.StagedMetadata(5, False, meta_mod.Metadata((
        meta_mod.PipelineMetadata(agg_mod.AggID.compress(
            [agg_mod.AggType.LAST, agg_mod.AggType.MAX]), (pol,), pipe),
        meta_mod.PipelineMetadata(0, (pol,))))),)
    MU = metric_mod.MetricUnion
    MT = metric_mod.MetricType
    assert tr(MU.counter(b"c{a=b}", 7), md)
    assert tr(MU.gauge(b"g", -0.0), md)
    assert tr(MU.batch_timer(b"t", [1.0, float("nan"), 3.5]), md)  # full
    assert tr(MU.gauge(b"g2", 1e300), ())
    assert tr.flush()
    assert tr.send_timed_batch(MT.GAUGE, pol, [b"x", b"y"],
                               [T0, T0 + 1], [0.5, float("inf")], agg_id=3)
    fmeta = meta_mod.ForwardMetadata(
        aggregation_id=agg_mod.AggID.compress([agg_mod.AggType.SUM]),
        storage_policy=pol, pipeline=pipe, source_id=b"src",
        num_forwarded_times=2)
    assert tr(MU.counter(b"pending", 1), md)
    assert tr.send_forwarded_batch(MT.GAUGE, [
        (b"r1", T0, 1.5, fmeta, b"s1"), (b"r2", T0 + 60 * S, -2.0, fmeta, b"s2")])
    assert tr.send_forwarded(MT.COUNTER, b"r3", T0, 4.0, fmeta)


def test_tcp_transport_frames_byte_equal_reference():
    from m3_tpu.metrics import metric as jmetric
    from m3_tpu_torch.metrics import metadata, metric, pipeline, policy

    out = []
    for mods, cls in (((magg, pipeline, metadata, metric, policy),
                       TCPTransport),
                      ((jmagg, jpipe, jmeta, jmetric,
                        __import__("m3_tpu.metrics.policy",
                                   fromlist=["policy"])),
                       jserver.TCPTransport)):
        cap = _Capture()
        tr = cls(cap.endpoint, batch_size=3)
        try:
            _transport_traffic(mods, tr)
        finally:
            tr.close()
            assert _await(lambda: cap.finished == 1)
            cap.close()
        out.append(bytes(cap.data))
    assert out[0] and out[0] == out[1]


def _traffic(rng, n_ids=40, n=400):
    """(kind, id, value) samples: counters, gauges (NaN and -0.0 among
    them) and batch timers."""
    out = []
    for i in range(n):
        k = i % n_ids
        if k % 3 == 0:
            out.append(("c", b"c.%d" % k, int(rng.integers(0, 9))))
        elif k % 3 == 1:
            v = float(rng.standard_normal())
            out.append(("g", b"g.%d" % k,
                        float("nan") if i % 97 == 0 else -0.0 if i % 89 == 0
                        else v))
        else:
            out.append(("t", b"t.%d" % k, rng.lognormal(0, 1, 4).tolist()))
    return out


def _send(tr, MU, md, samples):
    for kind, mid, v in samples:
        mu = (MU.counter(mid, v) if kind == "c" else MU.gauge(mid, v)
              if kind == "g" else MU.batch_timer(mid, v))
        assert tr(mu, md)
    assert tr.flush()


@pytest.mark.parametrize("direction", ["port-client-ref-server",
                                       "ref-client-port-server"])
def test_cross_package_transport_and_server_rows_equal(direction):
    """One package's TCPTransport feeding the other's RawTCPServer: the
    flushed rows equal, bit for bit, those of the reference Aggregator
    fed the same samples in process."""
    samples = _traffic(np.random.default_rng(5))
    clock = SettableClock(T0)
    if direction == "port-client-ref-server":
        cap = JCaptureHandler()
        agg = JAggregator(num_shards=8, clock=clock, flush_handler=cap)
        srv = jserver.RawTCPServer(agg).start()
        tr, MU, md = TCPTransport(srv.endpoint, batch_size=16), MetricUnion, \
            _md(ONE_M)
    else:
        cap = CaptureHandler()
        agg = _agg(clock, cap)
        srv = RawTCPServer(agg).start()
        tr, MU, md = jserver.TCPTransport(srv.endpoint, batch_size=16), \
            JMetricUnion, _jmd("1m:40h")
    oracle = JCaptureHandler()
    jagg = JAggregator(num_shards=8, clock=clock, flush_handler=oracle)
    try:
        half = len(samples) // 2
        for done, part in ((half, samples[:half]),
                           (len(samples), samples[half:])):
            _send(tr, MU, md, part)
            for kind, mid, v in part:
                jagg.add_untimed(
                    JMetricUnion.counter(mid, v) if kind == "c"
                    else JMetricUnion.gauge(mid, v) if kind == "g"
                    else JMetricUnion.batch_timer(mid, v), _jmd("1m:40h"))
            assert _await(lambda n=done: srv.frames + srv.errors >= n)
            clock.advance(60 * S)
        assert srv.errors == 0
        agg.flush()
        jagg.flush()
        assert _rows(cap) == _rows(oracle) and len(oracle.metrics) > 40
    finally:
        tr.close()
        srv.close()


def test_forwarded_pipeline_crosses_instances_over_tcp():
    """Two port aggregators (RF 1, 8 shards) forward rollup partials to
    the owner of each rolled-up id through TCPTransport; the rollups
    equal those of one reference Aggregator fed the same samples."""
    clock = SettableClock(T0)
    placement = initial_placement(
        [Instance("a", "a:1"), Instance("b", "b:1")], 8, 1)
    caps = {"a": CaptureHandler(), "b": CaptureHandler()}
    aggs = {k: _agg(clock, caps[k]) for k in caps}
    for k, agg in aggs.items():
        agg.assign_shards(placement.instances[k].shard_ids())
    srvs = {k: RawTCPServer(agg).start() for k, agg in aggs.items()}
    trs = {k: TCPTransport(srv.endpoint) for k, srv in srvs.items()}
    for k, agg in aggs.items():
        other = "b" if k == "a" else "a"
        agg.set_forward_routing(lambda: placement, {other: trs[other]}, k)
    client = AggregatorClient(8, lambda: placement,
                              {k: agg.add_untimed for k, agg in aggs.items()})
    oracle = JCaptureHandler()
    jagg = JAggregator(num_shards=8, clock=clock, flush_handler=oracle)
    rids = [b"roll.%d" % k for k in range(6)]
    try:
        for i in range(60):
            rid = rids[i % 6]
            pipe = Pipeline((Op.roll(rid, (b"host",), magg.AggID.compress(
                [magg.AggType.SUM])),))
            jp = jpipe.Pipeline((jpipe.Op.roll(rid, (b"host",),
                                               jmagg.AggID.compress(
                                                   [jmagg.AggType.SUM])),))
            agg_id = magg.AggID.compress([magg.AggType.LAST])
            assert client.write_untimed(MetricUnion.gauge(b"src.%d" % i, i * 0.5),
                                        _md(ONE_M, agg_id, pipe))
            jagg.add_untimed(JMetricUnion.gauge(b"src.%d" % i, i * 0.5),
                             _jmd("1m:40h", agg_id, jp))
        clock.advance(2 * 60 * S)
        for agg in aggs.values():
            agg.flush()
        jagg.flush()
        remote = sum(1 for i in range(60) if placement.replicas_for(
            aggs["a"].shard_for(rids[i % 6]))[0].id !=
            placement.replicas_for(aggs["a"].shard_for(b"src.%d" % i))[0].id)
        assert remote > 0
        assert _await(lambda: sum(a.forwarded_received for a in aggs.values())
                      == 60)
        clock.advance(2 * 60 * S)
        for agg in aggs.values():
            agg.flush()
        jagg.flush()
        got = sorted(_row(m) for c in caps.values() for m in c.metrics)
        assert got == _rows(oracle)
        assert sum(r[0].startswith(b"roll.") for r in got) == 6
    finally:
        for tr in trs.values():
            tr.close()
        for srv in srvs.values():
            srv.close()


# -- failover ---------------------------------------------------------------------

def test_resign_hands_the_flush_over_without_gap_or_duplicate():
    """A leader and a follower (one shard set, both fed every sample over
    TCP) over a KV service, flushing through m3msg into storage. The
    leader flushes the first window and resigns over /resign; the
    follower flushes the next. Stored rows equal the reference's
    leaderless Aggregator fed the same samples: every window once."""
    clock = SettableClock(T0)
    kv = KVServer().start()
    stores, servers, closers = [], [], []
    db = Database(ShardSet(4), clock=clock, device=CPU)
    db.create_namespace(b"agg_1m", NamespaceOptions(index_enabled=False))
    ingester = M3MsgIngester(lambda p: LocalStorage(db, b"agg_1m")
                             if str(p) == str(ONE_M) else None)
    consumer = Consumer(ingester).start()
    closers.append(consumer.close)
    placement = initial_placement([Instance("c0", consumer.endpoint)], 4, 1)
    topic = Topic("aggregated_metrics", 4, (ConsumerService("coordinator"),))
    try:
        aggs = {}
        producers = []
        for iid in ("leader", "follower"):
            st = RemoteStore(kv.endpoint)
            stores.append(st)
            prod = Producer(topic, {"coordinator": lambda: placement},
                            retry_delay_s=0.05)
            producers.append(prod)
            closers.append(prod.close)
            election = ElectionManager(LeaderService(st, "ss0", iid,
                                                     clock=clock))
            aggs[iid] = _agg(clock, ProducerHandler(prod, 4),
                             election=election,
                             flush_times=FlushTimesManager(st, "ss0"))
        srvs = {k: RawTCPServer(a).start() for k, a in aggs.items()}
        admin = HTTPAdminServer(aggs["leader"]).start()
        servers += list(srvs.values()) + [admin]
        agg_pl = initial_placement([Instance("leader", "l:1"),
                                    Instance("follower", "f:1")], 8, 2)
        trs = {k: TCPTransport(s.endpoint, batch_size=8)
               for k, s in srvs.items()}
        client = AggregatorClient(8, lambda: agg_pl, trs)
        oracle = JCaptureHandler()
        jagg = JAggregator(num_shards=8, clock=clock, flush_handler=oracle)
        rng = np.random.default_rng(9)

        def window():
            for i in range(30):
                v = int(rng.integers(0, 100))
                assert client.write_untimed_counter(b"c.%d" % (i % 10), v,
                                                    _md(ONE_M))
                jagg.add_untimed(JMetricUnion.counter(b"c.%d" % (i % 10), v),
                                 _jmd("1m:40h"))
            for tr in trs.values():
                assert tr.flush()

        window()
        assert _await(lambda: sum(s.frames for s in srvs.values()) == 60)
        clock.advance(60 * S)
        aggs["leader"].flush()
        aggs["follower"].flush()
        assert _get(admin.endpoint, "/status")["status"]["flushStatus"] == {
            "electionState": "leader", "canLead": True}
        window()
        assert _await(lambda: sum(s.frames for s in srvs.values()) == 120)
        assert _post(admin.endpoint, "/resign") == (200, {"state": "OK"})
        assert _get(admin.endpoint, "/status")["status"]["flushStatus"][
            "electionState"] == "follower"
        clock.advance(60 * S)
        aggs["follower"].flush()   # campaigns first: takes the lease
        aggs["leader"].flush()     # now a follower: discards the window
        assert aggs["follower"]._election.is_leader()
        assert not aggs["leader"]._election.is_leader()
        assert _await(lambda: all(p.unacked() == 0 for p in producers))
        jagg.flush()
        want = {}
        for m in oracle.metrics:
            want.setdefault(m.id, []).append((m.time_nanos, m.value))
        assert len(want) == 10
        for mid, pts in want.items():
            t, v = db.read(b"agg_1m", mid, 0, 2**62)
            assert list(zip(t.tolist(), v.tolist())) == sorted(pts)
        assert ingester.ingested == 20
    finally:
        for c in closers:
            c()
        for s in servers:
            s.close()
        for st in stores:
            st.close()
        kv.close()


# -- the flush handlers ----------------------------------------------------------

def test_file_logging_broadcast_callback_handlers(tmp_path, caplog):
    """FileHandler writes the reference's durable lines byte for byte;
    LoggingHandler logs each datapoint; BroadcastHandler fans out both a
    datapoint and a columnar round; CallbackHandler bridges to a
    callable."""
    import logging

    from m3_tpu.aggregator import handler as jhandler
    from m3_tpu_torch.aggregator.handler import (AggregatedMetric,
                                                 BroadcastHandler,
                                                 CallbackHandler, FileHandler,
                                                 LoggingHandler)

    pol, jpol = ONE_M, JStoragePolicy.parse("1m:40h")
    rows = [(b"a{x=1}", T0, 1.5), (b"b", T0 + 60 * S, -0.0),
            (b"c", T0, float("nan")), (b"d", T0, 1e300)]
    paths = [str(tmp_path / "port.log"), str(tmp_path / "ref.log")]
    for path, mod, p in ((paths[0], None, pol), (paths[1], jhandler, jpol)):
        fh = (FileHandler if mod is None else mod.FileHandler)(path)
        for mid, t, v in rows:
            fh(mid, t, v, p)
        fh.close()
    data = [open(p, "rb").read() for p in paths]
    assert data[0] and data[0] == data[1]

    seen, cols = [], []
    cap = CaptureHandler()

    class Columnar(CaptureHandler):
        def handle_columnar(self, groups):
            cols.extend(groups)

    bc = BroadcastHandler([cap, Columnar(), CallbackHandler(seen.append)])
    bc(b"x", T0, 2.0, pol)
    groups = [([b"y", b"z"], np.array([T0, T0], np.int64),
               np.array([3.0, 4.0]), pol)]
    bc.handle_columnar(groups)
    assert [m.id for m in cap.metrics] == [b"x", b"y", b"z"]
    assert [m.id for m in seen] == [b"x", b"y", b"z"]
    assert seen[0] == AggregatedMetric(b"x", T0, 2.0, pol)
    assert len(cols) == 1 and cols[0][0] == [b"y", b"z"]
    with caplog.at_level(logging.INFO, logger="m3_tpu_torch.aggregator.flush"):
        LoggingHandler()(b"x", T0, 2.5, pol)
    assert "flush" in caplog.text and "2.5" in caplog.text
