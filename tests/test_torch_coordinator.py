"""The port's coordinator (m3_tpu_torch/coordinator: run_embedded,
run_clustered, the HTTP API, the downsampler, remote write and read, the
carbon listener, Graphite, the rules engine) against the reference's
(m3_tpu/coordinator), on the CPU.

Each case starts the reference's run_embedded over a reference Database
and the port's run_embedded(device="cpu") over a port Database, with the
same namespaces, the same rule set in KV and one shared clock, sends
both the same requests over real localhost HTTP, and holds the answers
to each other:

  * every route of tests/test_coordinator.py (and the remote write and
    read, Graphite, search, OpenAPI and admin routes) answers with the
    same status in both packages;
  * non-numeric bodies are byte-equal (labels, series, routes, OpenAPI,
    admin JSON, the remote-read protobuf, Graphite find);
  * query bodies have the same series in the same order, the same
    timestamps and the same missing (NaN) cells, with values within
    tests/test_plan_compile.py:170-185's bounds (_tol: rtol 2e-5, atol
    max(1e-8, 1e-6 max|ref|), looser for the regression family);
  * Graphite renders the same targets with the same timestamps and null
    cells, values within the same bound.

The port's one intended divergence is held too: a typed ComputeError on
the card's plan route answers 503 (the reference falls back inside its
guard and answers 200), and 200 again after guard.reset(). /debug/vars
is compared by its keys (its counters are process-wide)."""

import json
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from m3_tpu.cluster import kv as jkv
from m3_tpu.coordinator import promremote as jpr
from m3_tpu.coordinator import run_embedded as j_run_embedded
from m3_tpu.coordinator.carbon_ingest import CarbonServer as JCarbonServer
from m3_tpu.coordinator.rules_engine import AlertRule as JAlertRule
from m3_tpu.coordinator.rules_engine import RecordingRule as JRecordingRule
from m3_tpu.index.namespace_index import NamespaceIndex as JNamespaceIndex
from m3_tpu.metrics import aggregation as jmagg
from m3_tpu.metrics.filters import TagsFilter as JTagsFilter
from m3_tpu.metrics.matcher import RuleSetStore as JRuleSetStore
from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
from m3_tpu.metrics.rules import MappingRuleSnapshot, Rule, RuleSet
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu_torch.cluster import kv as tkv
from m3_tpu_torch.coordinator import run_clustered, run_embedded
from m3_tpu_torch.coordinator.carbon_ingest import CarbonServer
from m3_tpu_torch.coordinator.rules_engine import AlertRule, RecordingRule
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.metrics.matcher import RuleSetStore
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.query import plan as tplan
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.testing import faultcomp
from test_plan_compile import _tol
from test_torch_metrics_rules import to_port

S = 1_000_000_000
T0 = 1_600_000_000 * S
STEP = 30 * S


def _ruleset():
    ten_s = JStoragePolicy.of("10s", "2d")
    return ten_s, RuleSet(b"default", 1, mapping_rules=[Rule([
        MappingRuleSnapshot(
            "downsample-api", 0, JTagsFilter({"service": "api"}),
            jmagg.AggID.compress([jmagg.AggType.MAX]), (ten_s,))])])


class Pair:
    """The two coordinators over one clock: `ref` (m3_tpu) and `port`
    (m3_tpu_torch on device="cpu")."""

    def __init__(self, kv=True):
        self.now = {"t": T0}
        clock = lambda: self.now["t"]  # noqa: E731
        ten_s, rs = _ruleset()
        self.jdb = JDatabase(JShardSet(8), clock=clock)
        self.tdb = Database(ShardSet(8), clock=clock, device="cpu")
        for ns in (b"default", b"agg_10s"):
            self.jdb.create_namespace(ns, JNamespaceOptions(),
                                      index=JNamespaceIndex(clock=clock))
            self.tdb.create_namespace(ns, NamespaceOptions(),
                                      index=NamespaceIndex(clock=clock))
        jstore, tstore = jkv.MemStore(), tkv.MemStore()
        JRuleSetStore(jstore).publish(rs)
        RuleSetStore(tstore).publish(to_port(rs))
        self.ref = j_run_embedded(
            self.jdb, kv_store=jstore if kv else None,
            aggregated_namespaces={ten_s: b"agg_10s"}, clock=clock)
        self.port = run_embedded(
            self.tdb, kv_store=tstore if kv else None,
            aggregated_namespaces={StoragePolicy.of("10s", "2d"): b"agg_10s"},
            clock=clock, device="cpu")

    def both(self, method, path, body=None, ctype="application/json"):
        """((status, headers, bytes) of the reference, ... of the port)."""
        return tuple(_call(c.endpoint + path, method, body, ctype)
                     for c in (self.ref, self.port))

    def write(self, doc):
        for (code, _, _) in self.both("POST", "/api/v1/json/write",
                                      json.dumps(doc).encode()):
            assert code == 200

    def close(self):
        self.ref.close()
        self.port.close()


def _call(url, method, body, ctype):
    req = urllib.request.Request(url, data=body, method=method)
    req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def _points(res):
    return res["values"] if "values" in res else [res["value"]]


def assert_prom_close(jbody, tbody, query):
    """Same series, order, timestamps and missing cells; values within
    the reference's plan bounds (_tol)."""
    j, t = json.loads(jbody), json.loads(tbody)
    assert t["status"] == j["status"] == "success"
    assert t["data"]["resultType"] == j["data"]["resultType"]
    if j["data"]["resultType"] == "scalar":
        jr, tr = [j["data"]["result"]], [t["data"]["result"]]
    else:
        jr, tr = j["data"]["result"], t["data"]["result"]
        assert [r["metric"] for r in tr] == [r["metric"] for r in jr]
        jr, tr = [p for r in jr for p in _points(r)], \
            [p for r in tr for p in _points(r)]
    assert [p[0] for p in tr] == [p[0] for p in jr]
    want = np.array([float(p[1]) for p in jr])
    got = np.array([float(p[1]) for p in tr])
    np.testing.assert_allclose(got, want, **_tol(query, want))
    return len(jr)


def _q(path, **params):
    return f"{path}?{urllib.parse.urlencode(params, doseq=True)}"


def _feed(pair, n=30):
    for i in range(n):
        pair.now["t"] = T0 + i * 15 * S
        for host in ("a", "b"):
            pair.write({"tags": {"__name__": "reqs_total", "job": host,
                                 "service": "api" if host == "a" else "web"},
                        "timestamp": (T0 + i * 15 * S) / S,
                        "value": 10.0 * i + (host == "b")})
        pair.write({"tags": {"__name__": "cpu_percent", "host": "a"},
                    "timestamp": (T0 + i * 15 * S) / S, "value": 50.0 + i})


QUERIES = ["cpu_percent", "rate(reqs_total[2m])", "sum(rate(reqs_total[2m]))",
           "max_over_time(cpu_percent[1m])", "reqs_total * 2",
           "deriv(cpu_percent[2m])", "absent(nothing_here)"]


@pytest.mark.parametrize("q", QUERIES)
def test_query_range_and_instant_equal_reference(pair, q):
    """tests/test_coordinator.py's json write -> query_range, a function
    over HTTP and an instant query, over more query shapes."""
    _feed(pair)
    path = _q("/api/v1/query_range", query=q, start=(T0 + 120 * S) / S,
              end=(T0 + 420 * S) / S, step="30s")
    (jc, _, jb), (tc, th, tb) = pair.both("GET", path)
    assert tc == jc == 200 and th["Content-Type"] == "application/json"
    assert assert_prom_close(jb, tb, q) > 0 or q.startswith("absent")
    path = _q("/api/v1/query", query=q, time=(T0 + 300 * S) / S)
    (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
    assert tc == jc == 200
    assert_prom_close(jb, tb, q)


@pytest.mark.parametrize("q,want", [("1+1", "2"), ("vector(42)", "42")])
def test_instant_scalar_result_type_equal_reference(pair, q, want):
    (jc, _, jb), (tc, _, tb) = pair.both(
        "GET", _q("/api/v1/query", query=q, time="1700000000"))
    assert tc == jc == 200
    assert tb == jb
    assert want in tb.decode()


@pytest.mark.parametrize("path", [
    "/api/v1/labels", "/api/v1/label/job/values", "/api/v1/series",
    "/api/v1/search", "/api/v1/search?result=tagNamesOnly",
    "/api/v1/search?result=bogus", "/routes", "/api/v1/openapi",
    "/api/v1/status/buildinfo", "/api/v1/metadata", "/api/v1/query_range",
    "/api/v1/query?query=sum(", "/no/such/route", "/api/v1/topic?name=x",
    "/api/v1/services/m3db/placement"])
def test_metadata_and_error_routes_byte_equal_reference(pair, path):
    """Label, series and search answers, the route table and its OpenAPI,
    the compatibility probes, a missing parameter, a bad query, an
    unknown route and 404s of the admin API: same status, same bytes."""
    _feed(pair, 4)
    if "?" not in path and path.startswith("/api/v1/") and \
            path.split("/")[3] in ("labels", "label", "series", "search"):
        path += "?" + urllib.parse.urlencode(
            {"match[]": "reqs_total", "start": T0 / S - 60,
             "end": T0 / S + 120})
    (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
    assert tc == jc
    assert tb == jb


def test_health_and_debug_routes_equal_reference(pair):
    for path in ("/health", "/debug/vars", "/debug/traces",
                 _q("/debug/explain", query="rate(reqs_total[2m])",
                    start=T0 / S, end=(T0 + 600) / S, step="30")):
        (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
        assert tc == jc == 200, path
        j, t = json.loads(jb), json.loads(tb)
        assert sorted(t) == sorted(j), path
    (jc, _, jb), (tc, _, tb) = pair.both("GET", "/health")
    assert json.loads(tb)["ok"] and json.loads(tb)["state"] == \
        json.loads(jb)["state"]
    (_, _, tb), = pair.both("GET", "/debug/vars")[1:]
    assert "compute" in json.loads(tb) and "metrics" in json.loads(tb)
    (jc, _, _), (tc, th, _) = pair.both("GET", "/debug/pprof/goroutine")
    assert tc == jc == 200 and th["Content-Type"].startswith("text/plain")


def test_downsampler_flush_equal_reference(pair):
    """tests/test_coordinator.py TestDownsampler: service=api matches the
    MAX/10s rule in both packages; the flushed series read back equal
    from the aggregated namespace and over HTTP."""
    for i in range(12):
        pair.now["t"] = T0 + i * 2 * S
        for c in (pair.ref, pair.port):
            for svc in (b"api", b"web"):
                c.writer.write({b"__name__": b"lat", b"service": svc},
                               T0 + i * 2 * S, float(i))
    pair.now["t"] = T0 + 40 * S
    assert pair.port.flush_downsampler() == pair.ref.flush_downsampler()
    assert pair.port.downsampler.samples_matched == \
        pair.ref.downsampler.samples_matched == 12
    from m3_tpu.index import query as jiq
    from m3_tpu_torch.index import query as tiq

    jids = pair.jdb.query_ids(b"agg_10s", jiq.new_term(b"service", b"api"))
    tids = pair.tdb.query_ids(b"agg_10s", tiq.new_term(b"service", b"api"))
    assert tids == jids and len(tids) == 1
    jt, jv = pair.jdb.read(b"agg_10s", jids[0], T0, T0 + 60 * S)
    tt, tv = pair.tdb.read(b"agg_10s", tids[0], T0, T0 + 60 * S)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, [4.0, 9.0, 11.0])


def test_admin_routes_equal_reference(pair):
    """tests/test_coordinator.py TestAdmin: database create, namespaces,
    placement and topics answer the same JSON."""
    for method, path, body in [
            ("POST", "/api/v1/database/create",
             {"type": "local", "namespaceName": "quickstart",
              "retentionTime": "12h"}),
            ("GET", "/api/v1/namespace", None),
            ("POST", "/api/v1/namespace", {"name": "other"}),
            ("GET", "/api/v1/services/m3db/placement", None),
            ("POST", "/api/v1/topic/init",
             {"name": "aggregated_metrics", "numberOfShards": 4,
              "consumerServices": [{"serviceId": "coordinator"}]}),
            ("GET", "/api/v1/topic?name=aggregated_metrics", None)]:
        data = None if body is None else json.dumps(body).encode()
        (jc, _, jb), (tc, _, tb) = pair.both(method, path, data)
        assert tc == jc == 200, path
        assert json.loads(tb) == json.loads(jb), path
    assert b"quickstart" in pair.tdb.namespaces


def _read_request(name, start_ms, end_ms):
    q = bytearray()
    jpr._put_uvarint(q, (1 << 3) | 0)
    jpr._put_uvarint(q, start_ms)
    jpr._put_uvarint(q, (2 << 3) | 0)
    jpr._put_uvarint(q, end_ms)
    m = bytearray()
    jpr._put_uvarint(m, (1 << 3) | 0)
    jpr._put_uvarint(m, 0)
    jpr._put_field_bytes(m, 2, b"__name__")
    jpr._put_field_bytes(m, 3, name)
    jpr._put_field_bytes(q, 3, bytes(m))
    req = bytearray()
    jpr._put_field_bytes(req, 1, bytes(q))
    return jpr.snappy_compress(bytes(req))


def test_remote_write_and_read_equal_reference(pair):
    """Snappy protobuf remote write of seeded series (tests/
    test_prom_remote.py's shape, 40 series), then query_range and a
    remote read: the read's protobuf bytes are equal, and a bad body
    answers 400 with the same error in both."""
    rng = np.random.default_rng(5)
    t0_ms = T0 // 1_000_000
    series = [({b"__name__": b"rw_metric", b"host": b"h%d" % k},
               [(t0_ms + i * 10_000, float(v)) for i, v in
                enumerate(np.cumsum(rng.poisson(3.0, 12)))])
              for k in range(40)]
    pair.now["t"] = T0 + 120 * S
    body = jpr.snappy_compress(jpr.encode_write_request(series))
    (jc, _, jb), (tc, _, tb) = pair.both(
        "POST", "/api/v1/prom/remote/write", body, "application/x-protobuf")
    assert tc == jc == 200 and tb == jb
    q = "rate(rw_metric[1m])"
    (jc, _, jb), (tc, _, tb) = pair.both("GET", _q(
        "/api/v1/query_range", query=q, start=(T0 + 60 * S) / S,
        end=(T0 + 110 * S) / S, step="10"))
    assert tc == jc == 200
    assert assert_prom_close(jb, tb, q) == 40 * 6
    (jc, jh, jb), (tc, th, tb) = pair.both(
        "POST", "/api/v1/prom/remote/read",
        _read_request(b"rw_metric", t0_ms, t0_ms + 120_000),
        "application/x-protobuf")
    assert tc == jc == 200 and tb == jb
    assert th["Content-Type"] == jh["Content-Type"] == "application/x-protobuf"
    # A point older than buffer_past: 400 in both, with the same error.
    old = jpr.snappy_compress(jpr.encode_write_request(
        [({b"__name__": b"rw_old"}, [(t0_ms - 3600_000, 1.0)])]))
    (jc, _, jb), (tc, _, tb) = pair.both(
        "POST", "/api/v1/prom/remote/write", old, "application/x-protobuf")
    assert tc == jc == 400 and tb == jb
    for bad in (b"not snappy", jpr.snappy_compress(b"\x0a\x05\x01")):
        (jc, _, jb), (tc, _, tb) = pair.both(
            "POST", "/api/v1/prom/remote/write", bad,
            "application/x-protobuf")
        assert tc == jc == 400 and tb == jb


def _stored(pair, namespace, name, start_ns, end_ns, field=b"__name__"):
    """{series id: (timestamps, values)} of every series whose tag
    `field` is `name` in `namespace`, read back from the reference's and
    the port's Database."""
    from m3_tpu.index import query as jiq
    from m3_tpu_torch.index import query as tiq

    out = []
    for db, iq in ((pair.jdb, jiq), (pair.tdb, tiq)):
        ids = db.query_ids(namespace, iq.new_term(field, name))
        out.append({sid: tuple(np.asarray(a).tolist() for a in
                               db.read(namespace, sid, start_ns, end_ns))
                    for sid in ids})
    return out


def test_remote_write_mixed_validity_body_equal_reference(pair):
    """A remote-write body whose 23rd sample lies outside buffer_past:
    400 with the same error in both, and afterwards the same rows stored
    (the samples before the bad one) and the same downsampled aggregates
    (the bad sample included: both downsample a sample before storing
    it), compared exactly after a flush."""
    t0_ms = T0 // 1_000_000
    rng = np.random.default_rng(11)
    series = [({b"__name__": b"rw_mix", b"host": b"h%d" % k,
                b"service": b"api" if k % 2 else b"web"},
               [(t0_ms + i * 2_000, float(v)) for i, v in
                enumerate(rng.integers(0, 100, 6))])
              for k in range(8)]
    tags, samples = series[3]
    samples[4] = (t0_ms - 3600_000, 1000.0)
    pair.now["t"] = T0 + 20 * S
    body = jpr.snappy_compress(jpr.encode_write_request(series))
    (jc, _, jb), (tc, _, tb) = pair.both(
        "POST", "/api/v1/prom/remote/write", body, "application/x-protobuf")
    assert tc == jc == 400 and tb == jb
    jrows, trows = _stored(pair, b"default", b"rw_mix", T0 - 3600 * S,
                           T0 + 60 * S)
    assert trows == jrows
    assert sum(len(t) for t, _ in trows.values()) == 3 * 6 + 4
    assert pair.port.writer.written == pair.ref.writer.written
    assert pair.port.writer.downsampled == pair.ref.writer.downsampled
    pair.now["t"] = T0 + 40 * S
    assert pair.port.flush_downsampler() == pair.ref.flush_downsampler()
    jagg, tagg = _stored(pair, b"agg_10s", b"api", T0 - 3600 * S,
                         T0 + 60 * S, field=b"service")
    assert tagg == jagg and len(tagg) == 2


def test_remote_write_concurrent_bodies_and_carbon_equal_reference(pair):
    """Writes that overlap: a body larger than the ingest gate (4,096)
    that arrives while another write holds the gate, then four bodies
    posted at once from four threads while a carbon stream feeds the
    listener. Every body answers 200 in both packages (the reference
    admits sample by sample, the port one unit a request), every carbon
    line is ingested, and the stored rows are equal."""
    import threading

    t0_ms = T0 // 1_000_000
    pair.now["t"] = T0 + 300 * S

    def body(name, n_series, n_points):
        return jpr.snappy_compress(jpr.encode_write_request(
            [({b"__name__": name, b"host": b"h%d" % k},
              [(t0_ms + i * 1_000, float(k * n_points + i))
               for i in range(n_points)]) for k in range(n_series)]))

    big = body(b"rw_big", 100, 50)
    for c in (pair.ref, pair.port):
        c.writer.gate.admit(1)
    try:
        (jc, _, jb), (tc, _, tb) = pair.both(
            "POST", "/api/v1/prom/remote/write", big,
            "application/x-protobuf")
    finally:
        for c in (pair.ref, pair.port):
            c.writer.gate.release(1)
    assert tc == jc == 200 and tb == jb

    bodies = [body(b"rw_conc%d" % j, 50, 50) for j in range(4)]
    base = T0 // S
    lines = [b"conc.h%d.cpu %r %d\n" % (h, float(i + h), base + i)
             for i in range(200) for h in range(5)]
    servers = [JCarbonServer(pair.ref.writer).start(),
               CarbonServer(pair.port.writer).start()]
    codes = []
    try:
        start = threading.Barrier(len(bodies) + 1)

        def post(b):
            start.wait()
            codes.append([code for code, _, _ in pair.both(
                "POST", "/api/v1/prom/remote/write", b,
                "application/x-protobuf")])

        threads = [threading.Thread(target=post, args=(b,)) for b in bodies]
        for th in threads:
            th.start()
        start.wait()
        for srv in servers:
            _send_carbon(srv.endpoint, lines)
        for th in threads:
            th.join(60)
        deadline = time.time() + 30
        while time.time() < deadline and any(
                s.lines_ingested + s.lines_malformed < len(lines)
                for s in servers):
            time.sleep(0.05)
        assert [s.lines_ingested for s in servers] == [len(lines)] * 2
    finally:
        for srv in servers:
            srv.close()
    assert codes == [[200, 200]] * len(bodies)
    for name, n in [(b"rw_big", 100)] + [(b"rw_conc%d" % j, 50)
                                         for j in range(4)]:
        jrows, trows = _stored(pair, b"default", name, T0, T0 + 300 * S)
        assert trows == jrows and len(trows) == n, name
    assert pair.port.writer.written == pair.ref.writer.written == \
        5_000 + 4 * 2_500 + len(lines)


def _send_carbon(endpoint, lines):
    host, port = endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port))) as sock:
        sock.sendall(b"".join(lines))


def test_carbon_and_graphite_equal_reference(pair):
    """The carbon listener in each package fed the same plaintext lines
    (3 hosts x 2 metrics x 30 points and two malformed lines), then
    Graphite renders and finds over HTTP: same targets, timestamps and
    null cells, values within the plan bounds; find byte-equal."""
    base = T0 // S
    lines = [b"svc.h%d.%s %r %d\n" % (h, m, float(i * (h + 1)), base + 10 * i)
             for i in range(30) for h in range(3) for m in (b"cpu", b"mem")]
    lines += [b"garbage\n", b"svc.x.cpu notanumber 1\n"]
    servers = [JCarbonServer(pair.ref.writer).start(),
               CarbonServer(pair.port.writer).start()]
    try:
        pair.now["t"] = T0 + 300 * S
        for srv in servers:
            _send_carbon(srv.endpoint, lines)
        deadline = time.time() + 30
        while time.time() < deadline and any(
                s.lines_ingested + s.lines_malformed < len(lines)
                for s in servers):
            time.sleep(0.05)
        assert [s.lines_ingested for s in servers] == [180, 180]
        assert servers[1].lines_malformed == servers[0].lines_malformed
    finally:
        for srv in servers:
            srv.close()
    for target in ("svc.*.cpu", "sumSeries(svc.*.mem)",
                   "movingAverage(svc.h1.cpu, 3)", "perSecond(svc.h2.*)"):
        (jc, _, jb), (tc, _, tb) = pair.both("GET", _q(
            "/api/v1/graphite/render", target=target, **{
                "from": base, "until": base + 290, "step": "10"}))
        assert tc == jc == 200, target
        j, t = json.loads(jb), json.loads(tb)
        assert [s["target"] for s in t] == [s["target"] for s in j]
        for js, ts in zip(j, t):
            assert [p[1] for p in ts["datapoints"]] == \
                [p[1] for p in js["datapoints"]]
            jv = np.array([np.nan if p[0] is None else p[0]
                           for p in js["datapoints"]])
            tv = np.array([np.nan if p[0] is None else p[0]
                           for p in ts["datapoints"]])
            np.testing.assert_allclose(tv, jv, **_tol(target, jv))
    for query in ("svc.*", "svc.h1.*", "*"):
        (jc, _, jb), (tc, _, tb) = pair.both("GET", _q(
            "/api/v1/graphite/find", query=query, **{"from": base - 10}))
        assert tc == jc == 200 and tb == jb, query


def test_compute_error_answers_503(pair, monkeypatch):
    """An injected device fault on the port's `plan` route raises a typed
    KernelFault, which the HTTP API answers with 503 and the error's type
    (the reference answers the same request 200: it falls back); after
    guard.reset() the port answers 200 with the reference's values."""
    monkeypatch.setattr(tplan, "PLAN_MIN_CELLS", 1)
    _feed(pair)
    q = "avg_over_time(cpu_percent[2m])"
    path = _q("/api/v1/query_range", query=q, start=(T0 + 120 * S) / S,
              end=(T0 + 420 * S) / S, step="30s")
    guard.reset()
    try:
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=7, dispatch_raise=1.0, route_filter="plan")):
            (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
    finally:
        guard.reset()
    assert jc == 200
    assert tc == 503
    err = json.loads(tb)
    assert err["status"] == "error" and err["errorType"] == "KernelFault"
    assert "plan" in err["error"]
    (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
    assert tc == jc == 200
    assert_prom_close(jb, tb, q)


def test_rules_engine_round_equal_reference(pair):
    """Coordinator.rules_engine() (tests/test_rules_engine.py's
    coordinator cases): a recording rule and an alert rule over fed
    series, two rounds, equal results in both packages, and the recorded
    series queryable over HTTP with equal answers."""
    _feed(pair)
    engines = []
    for c, rec, alert in ((pair.ref, JRecordingRule, JAlertRule),
                          (pair.port, RecordingRule, AlertRule)):
        re = c.rules_engine(step_ns=STEP)
        re.add_recording(rec(b"cpu:avg", "avg(cpu_percent)",
                             labels=((b"rule", b"r1"),)))
        re.add_recording(rec(b"reqs:rate", "sum by (job) "
                             "(rate(reqs_total[2m]))"))
        re.add_alert(alert(b"hot", "max_over_time(cpu_percent[1m])", ">",
                           60.0))
        engines.append(re)
    for t in (T0 + 240 * S, T0 + 435 * S):
        pair.now["t"] = t
        jres, tres = (re.evaluate() for re in engines)
        assert (tres.steps, tres.exprs_evaluated, tres.recorded_rows) == \
            (jres.steps, jres.exprs_evaluated, jres.recorded_rows)
        assert sorted((x.rule, x.series, x.kind, x.time_nanos)
                      for x in tres.transitions) == \
            sorted((x.rule, x.series, x.kind, x.time_nanos)
                   for x in jres.transitions)
    for q in ("cpu:avg", "reqs:rate"):
        (jc, _, jb), (tc, _, tb) = pair.both("GET", _q(
            "/api/v1/query_range", query=q, start=(T0 + 30 * S) / S,
            end=(T0 + 420 * S) / S, step="30s"))
        assert tc == jc == 200
        assert assert_prom_close(jb, tb, q) > 0


def test_run_clustered_equals_reference_embedded(tmp_path):
    """run_clustered(session, device="cpu") over an in-process 3-node,
    replication-factor-3 cluster (writes at ALL) against the reference's
    run_embedded over one Database with the same JSON writes: equal
    query_range answers and label values."""
    from m3_tpu_torch.client import Session, SessionOptions
    from m3_tpu_torch.cluster.topology import ConsistencyLevel
    from m3_tpu_torch.testing.cluster import ClusterHarness
    from m3_tpu_torch.testing.faultnet import FaultPlan

    ref = Pair(kv=False)
    h = ClusterHarness(3, 3, 4, start_ns=T0, data_root=str(tmp_path),
                       fault_plan=FaultPlan(), device="cpu")
    session = Session(h.topology, SessionOptions(
        timeout_s=10, write_consistency=ConsistencyLevel.ALL), device="cpu")
    c = run_clustered(session, clock=h.clock, device="cpu")
    try:
        for i in range(20):
            h.clock.now_ns = ref.now["t"] = T0 + i * 15 * S
            for host in ("a", "b", "c"):
                doc = {"tags": {"__name__": "reqs_total", "job": host},
                       "timestamp": (T0 + i * 15 * S) / S,
                       "value": 7.0 * i + ord(host)}
                for url in (ref.ref.endpoint, c.endpoint):
                    code, _, _ = _call(url + "/api/v1/json/write", "POST",
                                       json.dumps(doc).encode(),
                                       "application/json")
                    assert code == 200
        for q in ("rate(reqs_total[1m])", "sum(reqs_total)"):
            path = _q("/api/v1/query_range", query=q,
                      start=(T0 + 60 * S) / S, end=(T0 + 285 * S) / S,
                      step="15")
            jc, _, jb = _call(ref.ref.endpoint + path, "GET", None, "")
            tc, _, tb = _call(c.endpoint + path, "GET", None, "")
            assert tc == jc == 200
            assert assert_prom_close(jb, tb, q) > 0
        path = _q("/api/v1/label/job/values", **{"match[]": "reqs_total"},
                  start=T0 / S, end=(T0 + 300 * S) / S)
        assert _call(c.endpoint + path, "GET", None, "")[2] == \
            _call(ref.ref.endpoint + path, "GET", None, "")[2]
    finally:
        c.close()
        session.close()
        h.close()
        ref.close()
