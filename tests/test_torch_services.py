"""The port's service assembly (m3_tpu_torch/services: config, run_kv,
run_dbnode, run_aggregator, run_coordinator, run_coordinator_standalone,
run_collector; m3_tpu_torch/utils/panicmon.py) against the reference's
(m3_tpu/services, m3_tpu/utils/panicmon.py), on the CPU.

Mirrors tests/test_services_tools.py's TestConfig, TestDBNodeService,
TestAggregatorNetworkPath and TestRemoteFederation,
tests/test_kv_service.py's placement-watch case,
tests/test_migration_http_admin.py's admin sidecar through the service
assembly, and tests/test_x_utils.py's TestPanicmon. Both packages'
run_dbnode start side by side on one clock dict with the port on
device="cpu", receive the same HTTP requests, and their answers (under
tests/test_plan_compile.py's bounds), stored rows (bit for bit) and
/debug/vars keys compare equal; examples/*.yml load to equal configs in
both packages; the port's load_file reads JSON without PyYAML and refuses
a YAML-only file with ConfigError. Every server closes in a finally or a
fixture and every wait has a deadline."""

import dataclasses
import json
import os
import socket
import sys
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest

from m3_tpu.aggregator import Aggregator as JAggregator
from m3_tpu.aggregator import CaptureHandler as JCaptureHandler
from m3_tpu.aggregator.server import RawTCPServer as JRawTCPServer
from m3_tpu.aggregator.server import TCPTransport as JTCPTransport
from m3_tpu.cluster import kv_service as jkvs
from m3_tpu.metrics.metadata import Metadata as JMetadata
from m3_tpu.metrics.metadata import PipelineMetadata as JPipelineMetadata
from m3_tpu.metrics.metadata import StagedMetadata as JStagedMetadata
from m3_tpu.metrics.metric import MetricUnion as JMetricUnion
from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
from m3_tpu.query import model as jmodel
from m3_tpu.services import config as jcfg
from m3_tpu.services import run as jrun
from m3_tpu.utils.panicmon import Panicmon as JPanicmon
from m3_tpu_torch.aggregator import Aggregator, CaptureHandler
from m3_tpu_torch.aggregator.server import RawTCPServer, TCPTransport
from m3_tpu_torch.cluster import kv_service as kvs
from m3_tpu_torch.cluster.placement import Instance, PlacementService
from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                           StagedMetadata)
from m3_tpu_torch.metrics.metric import MetricUnion
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.query import model
from m3_tpu_torch.services import config as cfg
from m3_tpu_torch.services import run
from m3_tpu_torch.testing.cluster import SettableClock
from m3_tpu_torch.utils.panicmon import Panicmon
from test_torch_coordinator import _call, assert_prom_close

S = 1_000_000_000
T0 = 1_600_000_000 * S
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f[:-4] for f in os.listdir(os.path.join(ROOT, "examples"))
                  if f.endswith(".yml"))


def _await(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _fields(c):
    """A config dataclass as plain data (either package's)."""
    return json.loads(json.dumps(dataclasses.asdict(c)))


# --------------------------------------------------------------- config


class TestConfig:
    def test_yaml_roundtrip(self, tmp_path):
        cfg_file = tmp_path / "cfg.yml"
        cfg_file.write_text(
            "listen_address: 127.0.0.1:0\n"
            f"data_dir: {tmp_path}/data\n"
            "num_shards: 16\n"
            "namespaces:\n"
            "  - name: metrics\n"
            "    retention: 24h\n"
            "coordinator:\n"
            "  namespace: metrics\n")
        c = cfg.load_file(str(cfg_file), "dbnode")
        assert c.num_shards == 16
        assert c.namespaces[0].retention_ns == 24 * 3600 * S
        assert c.coordinator.namespace == "metrics"
        assert _fields(c) == _fields(jcfg.load_file(str(cfg_file), "dbnode"))

    @pytest.mark.parametrize("service", ["dbnode", "aggregator", "kv",
                                         "coordinator", "collector"])
    def test_unknown_key_rejected(self, service):
        for mod in (cfg, jcfg):
            with pytest.raises(mod.ConfigError, match="bogus_key"):
                mod.load_dict({"bogus_key": 1}, service)
        with pytest.raises(cfg.ConfigError):
            cfg.load_dict({}, "nope")

    @pytest.mark.parametrize("name", EXAMPLES)
    def test_examples_load_equal(self, name):
        path = os.path.join(ROOT, "examples", f"{name}.yml")
        want = jcfg.load_file(path, name)
        got = cfg.load_file(path, name)
        assert _fields(got) == _fields(want)
        assert type(got).__name__ == type(want).__name__

    def test_defaults_and_durations_equal(self):
        for service in ("dbnode", "aggregator", "kv", "coordinator",
                        "collector"):
            assert _fields(cfg.load_dict({}, service)) == _fields(
                jcfg.load_dict({}, service))
        raw = {"dbnode": {"namespaces": [{"name": "a", "block_size": "1m",
                                          "buffer_past": "10s"}],
                          "coordinator": {"self_scrape_interval": "10s"}}}
        got, want = cfg.load_dict(raw, "dbnode"), jcfg.load_dict(raw, "dbnode")
        for attr in ("retention_ns", "block_size_ns", "buffer_past_ns",
                     "buffer_future_ns"):
            assert getattr(got.namespaces[0], attr) == getattr(
                want.namespaces[0], attr)
        assert got.coordinator.self_scrape_interval_s == 10.0 == \
            want.coordinator.self_scrape_interval_s

    def test_json_without_pyyaml(self, tmp_path, monkeypatch):
        doc = {"listen_address": "127.0.0.1:0", "num_shards": 4,
               "data_dir": str(tmp_path / "d"), "commitlog_strategy":
               "write_wait", "namespaces": [{"name": "default",
                                             "block_size": "1m"}],
               "coordinator": {"namespace": "default"}}
        path = tmp_path / "node.json"
        path.write_text(json.dumps(doc, indent=1))
        yml = tmp_path / "node.yml"
        yml.write_text("num_shards: 4\nnamespaces:\n  - name: x\n")
        want = jcfg.load_file(str(path), "dbnode")  # PyYAML reads the JSON
        monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
        assert _fields(cfg.load_file(str(path), "dbnode")) == _fields(want)
        with pytest.raises(cfg.ConfigError, match="PyYAML"):
            cfg.load_file(str(yml), "dbnode")
        empty = tmp_path / "empty.json"
        empty.write_text("")
        assert _fields(cfg.load_file(str(empty), "kv")) == _fields(
            jcfg.load_dict({}, "kv"))


# --------------------------------------------------------------- dbnode


class NodePair:
    """Both packages' run_dbnode over one clock dict: `ref` (m3_tpu) and
    `port` (m3_tpu_torch on device="cpu"), each with its own data dir."""

    def __init__(self, root, **extra):
        self.root = root
        self.now = {"t": T0}
        self.extra = extra
        self.ref = self.port = None
        self.start()

    def raw(self, which):
        return {"num_shards": 8, "data_dir": str(self.root / which),
                "coordinator": {"namespace": "default"}, **self.extra}

    def start(self, **more):
        self.extra.update(more)
        clock = lambda: self.now["t"]  # noqa: E731
        self.ref = jrun.run_dbnode(jcfg.load_dict(self.raw("ref"), "dbnode"),
                                   clock=clock)
        self.port = run.run_dbnode(cfg.load_dict(self.raw("port"), "dbnode"),
                                   clock=clock, device="cpu")

    def both(self, method, path, body=None, ctype="application/json"):
        return tuple(_call(h.coordinator.endpoint + path, method, body, ctype)
                     for h in (self.ref, self.port))

    def write(self, doc):
        for code, _, out in self.both("POST", "/api/v1/json/write",
                                      json.dumps(doc).encode()):
            assert code == 200, out

    def stored(self, metric):
        """{series id: (times, values)} of each package's database."""
        out = []
        for h, mod in ((self.ref, jmodel), (self.port, model)):
            m = mod.Matcher(mod.MatchType.EQUAL, b"__name__", metric)
            got = h.coordinator.engine.storage.fetch_raw([m], 0, 2**62)
            out.append({sid: (np.asarray(e["t"]), np.asarray(e["v"]))
                        for sid, e in got.items()})
        return out

    def close(self):
        for h in (self.ref, self.port):
            if h is not None:
                h.close()
        self.ref = self.port = None


def _feed(pair, n=20):
    for i in range(n):
        pair.now["t"] = T0 + i * 15 * S
        for job in ("a", "b"):
            pair.write({"tags": {"__name__": "svc_total", "job": job},
                        "timestamp": pair.now["t"] / S,
                        "value": float(i * (2 if job == "a" else 3))})


def _same_rows(ref, port):
    assert sorted(port) == sorted(ref)
    for sid, (t, v) in ref.items():
        assert port[sid][0].tobytes() == t.tobytes(), sid
        assert port[sid][1].tobytes() == v.tobytes(), sid


@pytest.fixture
def nodes(tmp_path):
    pair = NodePair(tmp_path)
    try:
        yield pair
    finally:
        pair.close()


class TestDBNodeService:
    def test_run_with_embedded_coordinator(self, tmp_path):
        c = cfg.load_dict({
            "data_dir": str(tmp_path / "d"),
            "num_shards": 8,
            "coordinator": {"namespace": "default"},
        }, "dbnode")
        clock = SettableClock(T0)
        handle = run.run_dbnode(c, clock=clock, device="cpu")
        jclock = SettableClock(T0)
        jhandle = jrun.run_dbnode(jcfg.load_dict({
            "data_dir": str(tmp_path / "j"), "num_shards": 8,
            "coordinator": {"namespace": "default"}}, "dbnode"), clock=jclock)
        try:
            assert handle.endpoint
            for h, ck in ((handle, clock), (jhandle, jclock)):
                for i in range(10):
                    ck.advance(10 * S)
                    h.coordinator.writer.write(
                        {b"__name__": b"svc_metric"}, ck(), float(i))
            blk = handle.coordinator.engine.execute_range(
                "svc_metric", T0 + 50 * S, T0 + 100 * S, 10 * S)
            want = jhandle.coordinator.engine.execute_range(
                "svc_metric", T0 + 50 * S, T0 + 100 * S, 10 * S)
            assert blk.n_series == want.n_series == 1
            assert np.asarray(blk.values).tobytes() == \
                np.asarray(want.values).tobytes()
        finally:
            handle.close()
            jhandle.close()

    def test_every_part_on_the_requested_device(self, nodes):
        h = nodes.port
        assert str(h.db.device) == "cpu"
        assert h.coordinator.engine.device == h.db.device
        assert h.server.service.device == h.db.device
        assert h.ns_watch.device == h.db.device

    @pytest.mark.parametrize("query", [
        "svc_total", "rate(svc_total[1m])", "sum by (job) (svc_total)",
        "sum(rate(svc_total[2m]))"])
    def test_http_answers_and_rows_equal(self, nodes, query):
        _feed(nodes)
        (jc, _, jb), (tc, _, tb) = nodes.both(
            "GET", "/api/v1/query_range?" + urllib.parse.urlencode({
                "query": query, "start": (T0 + 60 * S) / S,
                "end": (T0 + 285 * S) / S, "step": "15"}))
        assert tc == jc == 200
        assert assert_prom_close(jb, tb, query) > 0
        (jc, _, jb), (tc, _, tb) = nodes.both(
            "GET", "/api/v1/query?" + urllib.parse.urlencode({
                "query": query, "time": (T0 + 285 * S) / S}))
        assert tc == jc == 200
        assert_prom_close(jb, tb, query)
        ref, port = nodes.stored(b"svc_total")
        assert len(ref) == 2
        _same_rows(ref, port)

    def test_metadata_routes_and_debug_vars_equal(self, nodes):
        _feed(nodes, 4)
        for path in ("/api/v1/labels", "/api/v1/label/job/values",
                     "/api/v1/series?match[]=svc_total"):
            (jc, _, jb), (tc, _, tb) = nodes.both("GET", path)
            assert tc == jc == 200, path
            assert tb == jb, path
        for path in ("/health", "/debug/vars"):
            (jc, _, jb), (tc, _, tb) = nodes.both("GET", path)
            assert tc == jc == 200, path
            assert sorted(json.loads(tb)) == sorted(json.loads(jb)), path
        # The node's RPC answers health over the framed wire in both.
        from m3_tpu.rpc import wire as jwire
        from m3_tpu_torch.rpc import wire

        answers = []
        for h, w in ((nodes.ref, jwire), (nodes.port, wire)):
            host, _, port = h.endpoint.rpartition(":")
            with socket.create_connection((host, int(port)), timeout=10) as s:
                s.settimeout(10)
                w.write_frame(s, {"m": "health", "a": {}, "id": 1})
                answers.append(w.read_frame(s))
        assert answers[0]["ok"] and answers[1]["ok"]
        assert sorted(answers[1]["r"]) == sorted(answers[0]["r"])

    def test_restart_bootstraps_acknowledged_writes(self, tmp_path, capsys):
        """write_wait commit log, close, restart with the bootstrap on:
        both print the reference's serving-ready line with the same series
        count, and every acknowledged point reads back bit for bit."""
        pair = NodePair(tmp_path, commitlog_strategy="write_wait",
                        http_listen_address="127.0.0.1:0",
                        kv_path=str(tmp_path / "kv.json"),
                        scrub_interval="1h")
        try:
            _feed(pair, 12)
            before = pair.stored(b"svc_total")
            _same_rows(*before)
            pair.close()
            capsys.readouterr()
            pair.start(bootstrap_enabled=True)
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("dbnode serving-ready")]
            assert len(lines) == 2
            counts = [ln.split(" series=")[1] for ln in lines]
            assert counts[0] == counts[1] and counts[0].startswith("2 ")
            after = pair.stored(b"svc_total")
            _same_rows(*after)
            _same_rows(before[0], after[1])
            assert pair.port.bootstrap_results is not None
            assert pair.port.scrubber is not None
            got = []
            for h in (pair.ref, pair.port):
                health = _call(h.httpjson.endpoint + "/health", "POST",
                               b"{}", "application/json")
                dvars = _call(h.httpjson.endpoint + "/debug/vars", "GET",
                              None, "application/json")
                assert health[0] == dvars[0] == 200
                got.append((sorted(json.loads(health[2])),
                            sorted(json.loads(dvars[2]))))
            assert got[1] == got[0]
        finally:
            pair.close()

    def test_mediator_seals_and_flushes(self, tmp_path):
        """tick_interval starts the mediator: a block past buffer_past is
        sealed and flushed to a fileset in both packages."""
        pair = NodePair(tmp_path, tick_interval="50ms", namespaces=[
            {"name": "default", "block_size": "1m", "buffer_past": "10s"}])
        try:
            _feed(pair, 4)
            pair.now["t"] = T0 + 600 * S
            for h in (pair.ref, pair.port):
                assert _await(lambda h=h: any(
                    h.persist.list_filesets(b"default", s)
                    for s in range(8))), "no fileset flushed"
            _same_rows(*pair.stored(b"svc_total"))
        finally:
            pair.close()

    def test_lock_refuses_a_second_node(self, nodes):
        c = cfg.load_dict(nodes.raw("port"), "dbnode")
        with pytest.raises(RuntimeError):
            run.run_dbnode(c, device="cpu")


# --------------------------------------------------------------- coordinator


class TestCoordinator:
    def test_run_coordinator_over_db_takes_its_device(self, tmp_path):
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        db = Database(ShardSet(4), device="cpu")
        db.create_namespace(b"default", NamespaceOptions())
        with pytest.raises(ValueError, match="exactly one"):
            run.run_coordinator(cfg.load_dict({}, "coordinator"))
        with pytest.raises(ValueError, match="runs on cpu"):
            run.run_coordinator(cfg.load_dict({}, "coordinator"), db=db,
                                device="meta")
        coord = run.run_coordinator(cfg.load_dict({}, "coordinator"), db=db)
        try:
            assert coord.engine.device == db.device
        finally:
            coord.close()
            db.close()

    def test_standalone_equals_embedded(self, tmp_path):
        """A standalone coordinator discovers the port node through a
        placement in a KV service; its answers equal the node's embedded
        coordinator's and the reference's embedded coordinator's, and a
        remote and a carbon listener come up from its config."""
        kv = kvs.KVServer().start()
        pair = NodePair(tmp_path)
        coord = admin = None
        try:
            _feed(pair)
            admin = kvs.RemoteStore(kv.endpoint)
            PlacementService(admin, "_placement").init(
                [Instance("node0", pair.port.endpoint)], 8, 1)
            coord = run.run_coordinator_standalone(cfg.load_dict({
                "kv_endpoint": kv.endpoint,
                "carbon_listen_address": "127.0.0.1:0"}, "coordinator"),
                device="cpu")
            assert str(coord.engine.device) == "cpu"
            assert coord.carbon.endpoint
            for query in ("rate(svc_total[1m])", "sum by (job) (svc_total)"):
                path = "/api/v1/query_range?" + urllib.parse.urlencode({
                    "query": query, "start": (T0 + 60 * S) / S,
                    "end": (T0 + 285 * S) / S, "step": "15"})
                sc, _, sb = _call(coord.endpoint + path, "GET", None,
                                  "application/json")
                (jc, _, jb), (tc, _, tb) = pair.both("GET", path)
                assert sc == tc == jc == 200
                assert_prom_close(tb, sb, query)
                assert_prom_close(jb, sb, query)
        finally:
            if coord is not None:
                coord.carbon.close()
                coord.close()
            if admin is not None:
                admin.close()
            pair.close()
            kv.close()

    def test_standalone_refuses_without_placement(self):
        kv = kvs.KVServer().start()
        try:
            with pytest.raises(RuntimeError, match="no placement"):
                run.run_coordinator_standalone(cfg.load_dict(
                    {"kv_endpoint": kv.endpoint}, "coordinator"),
                    device="cpu")
            with pytest.raises(ValueError, match="kv_endpoint"):
                run.run_coordinator_standalone(
                    cfg.load_dict({}, "coordinator"), device="cpu")
        finally:
            kv.close()

    def test_collector_reports_like_reference(self):
        """run_collector over KV rules: the same metrics, with the same
        values and matched policies, reach each package's aggregator
        client transport."""
        from m3_tpu.cluster.placement import Instance as JInstance
        from m3_tpu.cluster.placement import initial_placement as jinit
        from m3_tpu.metrics import id as jid
        from m3_tpu.metrics.filters import TagsFilter
        from m3_tpu.metrics.matcher import RuleSetStore as JRuleSetStore
        from m3_tpu.metrics.rules import MappingRuleSnapshot, Rule, RuleSet
        from m3_tpu_torch.cluster.placement import initial_placement
        from m3_tpu_torch.metrics.matcher import RuleSetStore
        from test_torch_metrics_rules import to_port

        rs = RuleSet(b"default", 1, mapping_rules=[Rule([MappingRuleSnapshot(
            "cpu", 0, TagsFilter({"__name__": "cpu*"}), 0,
            (JStoragePolicy.of("10s", "2d"),))])])
        got = {}
        for name, mod, cmod, init, inst, store_cls, pub in (
                ("ref", jrun, jcfg, jinit, JInstance, JRuleSetStore, rs),
                ("port", run, cfg, initial_placement, Instance, RuleSetStore,
                 to_port(rs))):
            sink = []

            def send(mu, md, sink=sink):
                sink.append((mu.id, int(mu.type), mu.counter_val,
                             mu.gauge_val, [str(sp) for m in md
                                            for p in m.metadata.pipelines
                                            for sp in p.storage_policies]))
                return True

            pl = init([inst("a", "a:1")], 8, 1)
            rep, store = mod.run_collector(
                cmod.load_dict({"num_shards": 8}, "collector"),
                lambda pl=pl: pl, {"a": send})
            store_cls(store).publish(pub)
            for i in range(5):
                rep.report_counter(jid.encode(b"cpu_total",
                                              {b"i": b"%d" % i}), i + 1)
                rep.report_gauge(jid.encode(b"mem", {b"i": b"%d" % i}),
                                 float(i))
            got[name] = (sink, rep.reported, rep.unmatched)
        assert got["port"] == got["ref"]
        sent = got["port"][0]
        assert len(sent) == got["port"][1] == 10
        assert sum(row[4] == ["10s:2d"] for row in sent) == 5


# --------------------------------------------------------------- aggregator


def _md(pkg, policy="10s"):
    sm, m, pm, sp = ((JStagedMetadata, JMetadata, JPipelineMetadata,
                      JStoragePolicy) if pkg == "ref" else
                     (StagedMetadata, Metadata, PipelineMetadata,
                      StoragePolicy))
    return (sm(0, False, m((pm(0, (sp.of(policy, "2d"),)),))),)


class TestAggregatorNetworkPath:
    @pytest.mark.parametrize("pkg", ["ref", "port"])
    def test_rawtcp_ingest_to_flush(self, pkg):
        agg_cls, cap_cls, srv_cls, tr_cls, mu = (
            (JAggregator, JCaptureHandler, JRawTCPServer, JTCPTransport,
             JMetricUnion) if pkg == "ref" else
            (Aggregator, CaptureHandler, RawTCPServer, TCPTransport,
             MetricUnion))
        clock = SettableClock(100 * S)
        cap = cap_cls()
        kw = {} if pkg == "ref" else {"device": "cpu"}
        agg = agg_cls(num_shards=8, clock=clock, flush_handler=cap, **kw)
        srv = srv_cls(agg).start()
        transport = tr_cls(srv.endpoint, batch_size=4)
        try:
            for _ in range(8):
                assert transport(mu.counter(b"net_metric", 1), _md(pkg))
            transport.flush()
            assert _await(lambda: srv.frames >= 8)
            assert agg.num_entries() == 1
            clock.advance(10 * S)
            agg.flush()
            out = cap.by_id(b"net_metric")
            assert len(out) == 1 and out[0].value == 8.0
        finally:
            transport.close()
            srv.close()

    def test_multi_server_forwarding_pipeline(self):
        """Rollup pipeline crossing two port aggregator instances over TCP:
        the rolled-up metric lands exactly once, on the owner of the
        rollup ID's shard, with the reference's value."""
        from m3_tpu_torch.cluster.placement import initial_placement
        from m3_tpu_torch.metrics import aggregation as magg
        from m3_tpu_torch.metrics.pipeline import Op, Pipeline
        from m3_tpu_torch.utils.hashing import murmur3_32

        num_shards = 4
        placement = initial_placement(
            [Instance("agg-a", "a:1"), Instance("agg-b", "b:1")],
            num_shards, replica_factor=1)
        owned = {iid: set(placement.instances[iid].shard_ids())
                 for iid in ("agg-a", "agg-b")}
        clock = SettableClock(100 * S)
        caps = {iid: CaptureHandler() for iid in owned}
        aggs = {iid: Aggregator(num_shards=num_shards, clock=clock,
                                flush_handler=caps[iid], device="cpu")
                for iid in owned}
        for iid, agg in aggs.items():
            agg.assign_shards(sorted(owned[iid]))
        srvs = {iid: RawTCPServer(agg).start() for iid, agg in aggs.items()}
        transports = {iid: TCPTransport(srv.endpoint)
                      for iid, srv in srvs.items()}
        try:
            for iid, agg in aggs.items():
                agg.set_forward_routing(
                    lambda: placement,
                    {peer: transports[peer].send_forwarded
                     for peer in owned if peer != iid},
                    iid)

            def owner(mid: bytes) -> str:
                shard = murmur3_32(mid) % num_shards
                return next(i for i, s in owned.items() if shard in s)

            rollup_id = next(b"cross+n=%d" % i for i in range(64)
                             if owner(b"cross+n=%d" % i) == "agg-b")
            sources = [m for m in (b"lat+svc=%d" % i for i in range(64))
                       if owner(m) == "agg-a"][:2]
            pipe = Pipeline((Op.roll(rollup_id, (b"region",),
                                     magg.AggID.compress([magg.AggType.SUM])),))
            md = (StagedMetadata(0, False, Metadata((PipelineMetadata(
                magg.AggID.compress([magg.AggType.LAST]),
                (StoragePolicy.of("10s", "2d"),), pipe),))),)
            for mid, v in zip(sources, (10.0, 20.0)):
                assert aggs["agg-a"].add_untimed(MetricUnion.gauge(mid, v), md)
            assert aggs["agg-b"].num_entries() == 0
            clock.advance(10 * S)
            aggs["agg-a"].flush()
            assert _await(lambda: aggs["agg-b"].forwarded_received == 2)
            clock.advance(10 * S)
            for agg in aggs.values():
                agg.flush()
            out = caps["agg-b"].by_id(rollup_id + b".sum")
            assert len(out) == 1 and out[0].value == 30.0
            assert not caps["agg-a"].by_id(rollup_id + b".sum")
            assert aggs["agg-a"]._forward.dropped == 0
        finally:
            for tr in transports.values():
                tr.close()
            for srv in srvs.values():
                srv.close()

    def test_aggregator_service_flush_loop(self):
        """run_aggregator in both packages: a gauge sent over TCP flushes
        from the service's own loop with the same value."""
        got = {}
        for pkg, mod, cmod, tr_cls, mu, cap in (
                ("ref", jrun, jcfg, JTCPTransport, JMetricUnion,
                 JCaptureHandler()),
                ("port", run, cfg, TCPTransport, MetricUnion,
                 CaptureHandler())):
            conf = cmod.load_dict({"flush_interval": "50ms", "num_shards": 8},
                                  "aggregator")
            kw = {} if pkg == "ref" else {"device": "cpu"}
            handle = mod.run_aggregator(conf, flush_handler=cap, **kw)
            transport = tr_cls(handle.endpoint, batch_size=1)
            try:
                transport(mu.gauge(b"live_metric", 3.5), _md(pkg, "100ms"))
                assert _await(lambda: len(cap.by_id(b"live_metric")) >= 1)
                got[pkg] = cap.by_id(b"live_metric")[0].value
            finally:
                transport.close()
                handle.close()
        assert got["port"] == got["ref"] == 3.5
        assert str(handle.aggregator.device) == "cpu"

    def test_flush_log_and_device(self, tmp_path):
        """flush_log opens the reference's FileHandler; the handle closes
        it; the aggregator runs on the requested device."""
        conf = cfg.load_dict({"flush_interval": "50ms", "num_shards": 4,
                              "flush_log": str(tmp_path / "flush.log")},
                             "aggregator")
        handle = run.run_aggregator(conf, device="cpu")
        transport = TCPTransport(handle.endpoint, batch_size=1)
        try:
            assert str(handle.aggregator.device) == "cpu"
            transport(MetricUnion.gauge(b"logged", 2.0), _md("port", "100ms"))
            assert _await(lambda: os.path.getsize(tmp_path / "flush.log") > 0)
        finally:
            transport.close()
            handle.close()
        assert b"logged" in (tmp_path / "flush.log").read_bytes()


@pytest.mark.parametrize("mix", ["port", "port-and-ref"])
def test_aggregator_placement_watch_assigns_shards(mix):
    """tests/test_kv_service.py's case: a placement written to the KV
    service reaches running aggregators through the watch; shard ownership
    changes without restart. `port-and-ref` runs agg-b from the reference
    on the same KV service."""
    server = kvs.KVServer().start()
    admin = kvs.RemoteStore(server.endpoint)
    handles = {}
    assigns = {"agg-a": [], "agg-b": []}
    try:
        psvc = PlacementService(admin, "_placement/agg")
        psvc.init([Instance("agg-a", "a:1"), Instance("agg-b", "b:1")],
                  num_shards=8, replica_factor=1)
        for iid in ("agg-a", "agg-b"):
            ref = mix == "port-and-ref" and iid == "agg-b"
            raw = {"instance_id": iid, "num_shards": 8,
                   "kv_endpoint": server.endpoint,
                   "placement_key": "_placement/agg",
                   "election_id": f"e-{iid}", "flush_interval": "10s"}
            if ref:
                handles[iid] = jrun.run_aggregator(
                    jcfg.load_dict(raw, "aggregator"),
                    on_placement=assigns[iid].append)
            else:
                handles[iid] = run.run_aggregator(
                    cfg.load_dict(raw, "aggregator"),
                    on_placement=assigns[iid].append, device="cpu")
        assert _await(lambda: assigns["agg-a"] and assigns["agg-b"])
        a_owned = set(handles["agg-a"].aggregator.owned_shards())
        b_owned = set(handles["agg-b"].aggregator.owned_shards())
        assert a_owned | b_owned == set(range(8))
        assert a_owned.isdisjoint(b_owned)
        psvc.remove_instance("agg-b")
        assert _await(lambda: set(handles["agg-a"].aggregator.owned_shards())
                      == set(range(8)))
        assert _await(lambda: handles["agg-b"].aggregator.owned_shards() == [])
    finally:
        for h in handles.values():
            h.close()
            h.kv.close()
        admin.close()
        server.close()


def test_admin_sidecar_via_service_assembly():
    """run_aggregator with admin_address starts the sidecar; /health,
    /status and /resign answer as the reference's do."""
    answers = {}
    for pkg, mod, cmod, cap in (("ref", jrun, jcfg, JCaptureHandler()),
                                ("port", run, cfg, CaptureHandler())):
        conf = cmod.load_dict({"flush_interval": "1s", "num_shards": 4,
                               "admin_address": "127.0.0.1:0"}, "aggregator")
        kw = {} if pkg == "ref" else {"device": "cpu"}
        handle = mod.run_aggregator(conf, flush_handler=cap, **kw)
        try:
            assert handle.admin_endpoint
            with urllib.request.urlopen(handle.admin_endpoint + "/health",
                                        timeout=10) as r:
                health = json.loads(r.read())
            with urllib.request.urlopen(handle.admin_endpoint + "/status",
                                        timeout=10) as r:
                st = json.loads(r.read())["status"]
            req = urllib.request.Request(handle.admin_endpoint + "/resign",
                                         data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                resign = json.loads(r.read())
            answers[pkg] = (health, sorted(st), resign)
            assert health == {"state": "OK"} and resign == {"state": "OK"}
            assert st["flushStatus"]["electionState"] in (
                "leader", "follower", "pending_follower")
        finally:
            handle.close()
    assert answers["port"] == answers["ref"]


def test_admin_bind_failure_closes_the_ingest_server():
    """An admin port that cannot bind raises and leaves no listener."""
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        port = blocker.getsockname()[1]
        conf = cfg.load_dict({"num_shards": 4,
                              "admin_address": f"127.0.0.1:{port}"},
                             "aggregator")
        with pytest.raises(OSError):
            run.run_aggregator(conf, device="cpu")
    finally:
        blocker.close()


def test_kv_service_serves_both_packages(tmp_path):
    """run_kv (FileStore-backed): a port and a reference client see each
    other's writes; the file survives a restart."""
    conf = cfg.load_dict({"kv_path": str(tmp_path / "kv")}, "kv")
    handle = run.run_kv(conf)
    try:
        a, b = kvs.RemoteStore(handle.endpoint), jkvs.RemoteStore(
            handle.endpoint)
        try:
            a.set("k", b"v1")
            assert b.get("k").data == b"v1"
        finally:
            a.close()
            b.close()
    finally:
        handle.close()
    handle = run.run_kv(conf)
    try:
        assert handle.store.get("k").data == b"v1"
    finally:
        handle.close()


# --------------------------------------------------------------- federation


class TestRemoteFederation:
    def test_fanout_across_remote(self):
        from m3_tpu_torch.query.executor import Engine
        from m3_tpu_torch.query.remote import RemoteStorage, RemoteStorageServer
        from m3_tpu_torch.query.storage import FanoutStorage
        from m3_tpu.query import Engine as JEngine
        from m3_tpu.query.remote import RemoteStorage as JRemoteStorage
        from m3_tpu.query.remote import RemoteStorageServer as JRSS
        from m3_tpu.query.storage import FanoutStorage as JFanout
        from tests.test_query_engine import MemStorage

        local = MemStorage()
        remote_backing = MemStorage()
        t = np.arange(0, 40) * 15 * S
        local.add({"__name__": "m", "dc": "local"}, t, np.full(40, 1.0))
        remote_backing.add({"__name__": "m", "dc": "remote"}, t,
                           np.full(40, 2.0))
        got = {}
        for pkg, srv_cls, rs_cls, fan, eng in (
                ("ref", JRSS, JRemoteStorage, JFanout, JEngine),
                ("port", RemoteStorageServer, RemoteStorage, FanoutStorage,
                 lambda s: Engine(s, device="cpu"))):
            srv = srv_cls(remote_backing).start()
            try:
                blk = eng(fan([local, rs_cls(srv.endpoint)])).execute_range(
                    "m", 5 * 60 * S, 9 * 60 * S, 30 * S)
                got[pkg] = {tg.as_dict()[b"dc"]: np.asarray(v).tobytes()
                            for tg, v in zip(blk.series_tags, blk.values)}
            finally:
                srv.close()
        assert got["port"] == got["ref"]
        assert sorted(got["port"]) == [b"local", b"remote"]


# --------------------------------------------------------------- panicmon


class TestPanicmon:
    @pytest.mark.parametrize("cls", [Panicmon, JPanicmon],
                             ids=["port", "ref"])
    def test_restart_on_crash(self, cls):
        mon = cls([sys.executable, "-c", "import sys; sys.exit(3)"],
                  restart_on_crash=True, max_restarts=2, backoff_s=0.05)
        mon.start()
        try:
            deadline = time.time() + 60
            while mon.restarts < 2 and time.time() < deadline:
                time.sleep(0.05)
            assert _await(lambda: len(mon.exit_codes) == 3, 60)
        finally:
            mon.stop()
        assert mon.restarts == 2
        assert all(rc == 3 for rc in mon.exit_codes[:3])

    def test_clean_exit_no_restart(self):
        seen = []
        mon = Panicmon([sys.executable, "-c", "pass"], on_exit=seen.append,
                       restart_on_crash=True, backoff_s=0.05)
        mon.start()
        try:
            deadline = time.time() + 60
            while not mon.exit_codes and time.time() < deadline:
                time.sleep(0.05)
        finally:
            mon.stop()
        assert mon.exit_codes[0] == 0 and seen == [0]
        assert mon.restarts == 0
        assert not mon.alive()

    def test_stop_terminates_a_running_child(self):
        mon = Panicmon([sys.executable, "-c", "import time; time.sleep(60)"],
                       restart_on_crash=True, backoff_s=0.05).start()
        try:
            assert _await(mon.alive, 30)
        finally:
            mon.stop()
        assert not mon.alive() and mon.restarts == 0
        assert mon.exit_codes == [-15]


def test_collector_config_is_host_only():
    """run_kv and run_collector take no device: they build nothing on
    one (the reference's signatures)."""
    import inspect

    assert "device" not in inspect.signature(run.run_kv).parameters
    assert "device" not in inspect.signature(run.run_collector).parameters
    for fn in (run.run_dbnode, run.run_aggregator, run.run_coordinator,
               run.run_coordinator_standalone):
        assert inspect.signature(fn).parameters["device"].default is None

