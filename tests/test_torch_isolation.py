"""The port stands alone: it never imports JAX or the m3_tpu package, and
its entry points never fall back to the CPU on their own."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SLICE = r"""
import json, sys
import numpy as np
from m3_tpu_torch.ops import tsz
from m3_tpu_torch.parallel import ingest
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch import convert

ids = [b"series-%d" % i for i in range(32)]
shards = ShardSet().lookup_batch(ids, device="cpu")
ts, vals, npts = ingest.make_example_raw(32, 24, np.random.default_rng(7))
order = np.argsort(shards.numpy(), kind="stable")
raw = ingest.make_raw_batch(ts[order], vals[order], npts[order], device="cpu")
out = ingest.ingest_step_raw(raw, rollup_factor=6, max_words=tsz.max_words_for(24),
                             device="cpu")
dts, dvals = tsz.decode_plane(out[0], npts[order], window=24, device="cpu")
ok = bool(out[-1]) and (dts.numpy() == ts[order]).all() and (
    dvals.numpy().view(np.uint64) == vals[order].view(np.uint64)).all()

import torch
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import DictStorage, promql_corpus

series, t = promql_corpus(16, 11)
for q in ("rate(bench_metric[5m])", "sum_over_time(bench_metric[5m])",
          "max by (i) (irate(bench_metric[1m]))", "deriv(bench_metric[5m])",
          "predict_linear(bench_metric[5m], 600)", "changes(bench_metric[5m])",
          "holt_winters(bench_metric[5m], 0.3, 0.6)", "resets(bench_metric[5m])",
          "quantile_over_time(0.9, bench_metric[5m])"):
    blk = Engine(DictStorage(series), device="cpu").execute_range(
        q, int(t[30]), int(t[-1]), 30 * 10**9)
    ok = ok and blk.values.shape == (16, 110) and np.isfinite(blk.values).any()

# Past the plan floor (64 series x 119 cells): the compiled route.
plan_series, _ = promql_corpus(64, 17, hosts=8, metric=b"bench_requests")
eng = Engine(DictStorage(plan_series), device="cpu")
for q in ("sum by (host) (rate(bench_requests[5m]))",
          "avg_over_time(bench_requests[5m])",
          "topk(3, irate(bench_requests[1m]))"):
    blk = eng.execute_range(q, int(t[30]), int(t[-1]), 30 * 10**9)
    ok = ok and eng.last_route()["route"] == "compiled"
    ok = ok and np.isfinite(blk.values).any()

from m3_tpu_torch.metrics import carbon
from m3_tpu_torch.query.graphite import GraphiteEngine
from m3_tpu_torch.query.placement import QueryPlacement

gseries = {b"a.h%d.cpu" % i: {"tags": carbon.path_to_tags(b"a.h%d.cpu" % i),
                              "t": t, "v": series[sid]["v"]}
           for i, sid in enumerate(series)}
for target in ("movingMedian(a.*.cpu, '5min')", "stdev(a.*.cpu, 10)",
               "sumSeries(a.*.cpu)"):
    blk = GraphiteEngine(DictStorage(gseries), device="cpu").render(
        target, int(t[60]), int(t[-1]))
    ok = ok and np.isfinite(blk.values).any()
ok = ok and QueryPlacement("cpu").choose(10**6, 10**5) is None

from m3_tpu_torch.query.storage import LocalStorage
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.testing import write_corpus

now = {"t": int(t[0])}
db = Database(ShardSet(4), clock=lambda: now["t"], device="cpu")
db.ensure_namespace(b"default")
write_corpus(db, b"default", series, t, now, steps_per_batch=30)
now["t"] = int(t[-1]) + 3 * 3600 * 10**9
ok = ok and db.tick()["sealed"] > 0
sid = next(iter(series))
rt, rv = db.read(b"default", sid, int(t[0]), int(t[-1]) + 1)
ok = ok and (rt == t).all() and (rv == series[sid]["v"]).all()
blk = Engine(LocalStorage(db, b"default"), device="cpu").execute_range(
    "rate(bench_metric[5m])", int(t[30]), int(t[-1]), 30 * 10**9)
ok = ok and blk.values.shape == (16, 110) and np.isfinite(blk.values).any()
db.close()

from m3_tpu_torch.parallel import guard
from m3_tpu_torch.storage.block import encode_block, merge_sealed_blocks
from m3_tpu_torch.testing import faultcomp

bt = 1_600_000_000 * 10**9 + np.arange(8, dtype=np.int64)[None, :] * 10**10
bv = np.arange(16, dtype=np.float64).reshape(2, 8)
b1, b2 = (encode_block(k, [3, 4], np.repeat(bt + k * 8 * 10**10, 2, 0), bv,
                       np.full(2, 8, np.int32), device="cpu") for k in (0, 1))
merged = merge_sealed_blocks(b1, b2)
mt, mv = merged.read(4)
ok = ok and (mv == np.concatenate([bv[1], bv[1]])).all() and len(mt) == 16
with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0, corrupt=1.0)):
    try:
        merged.read_all()
        ok = False
    except guard.KernelFault:
        pass
guard.reset()

from m3_tpu_torch.aggregator import Aggregator, CaptureHandler, MetricList
from m3_tpu_torch.aggregator.flush import FlushTimesManager
from m3_tpu_torch.aggregator.election import ElectionManager
from m3_tpu_torch.cluster.kv import MemStore
from m3_tpu_torch.cluster.services import LeaderService
from m3_tpu_torch.coordinator.rules_engine import (AlertRule, RecordingRule,
                                                   RulesEngine)
from m3_tpu_torch.metrics.metric import MetricType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.metrics.transformation import per_second_batch
from m3_tpu_torch.testing import (AGG_BASE_NS, agg10x_build, agg10x_planes,
                                  agg10x_stage, loopback_forward)

lists, elems, _, n_ids = agg10x_build(200, "cpu")
lst = lists.for_resolution(60 * 10**9)
agg10x_stage(elems, agg10x_planes(200))
rows = []
cap = lambda m, t, v, p: rows.append(v)
fwd = loopback_forward(lst)
ok = ok and lst.flush(AGG_BASE_NS + 120 * 10**9, cap, fwd) == 400
ok = ok and lst.flush(AGG_BASE_NS + 180 * 10**9, cap, fwd) == 2 * n_ids
ok = ok and len(rows) == 2 * (80 + 72) + 2 * 40 * 11 + 2 * n_ids
store, clock = MemStore(), {"t": AGG_BASE_NS}
pol = StoragePolicy.parse("1m:40h")
agg = Aggregator(num_shards=8, clock=lambda: clock["t"],
                 flush_handler=CaptureHandler(),
                 election=ElectionManager(LeaderService(
                     store, "e", "i", clock=lambda: clock["t"])),
                 flush_times=FlushTimesManager(store, "ss"), device="cpu")
for i in range(32):
    agg.add_timed(MetricType.TIMER, b"tm.%d" % i, AGG_BASE_NS, float(i), pol)
clock["t"] = AGG_BASE_NS + 120 * 10**9
ok = ok and agg.flush() == 32 and len(agg._flush_handler.metrics) == 32 * 11
re = RulesEngine(Engine(DictStorage(plan_series), device="cpu"),
                 lambda rows: None, step_ns=30 * 10**9)
re.add_recording(RecordingRule(b"r", "sum by (host) (rate(bench_requests[5m]))"))
re.add_alert(AlertRule(b"a", "avg_over_time(bench_requests[5m])", ">", 1.0))
res = re.evaluate(int(t[100]))
ok = ok and res.recorded_rows == 8 and len(res.transitions) == 64
ok = ok and torch.isnan(per_second_batch(torch.arange(3), torch.ones(3)))[0]

import os
import tempfile
from m3_tpu_torch.index import persist as idx_persist
from m3_tpu_torch.persist import commitlog as cl
from m3_tpu_torch.persist.fs import PersistManager
from m3_tpu_torch.rpc import wire
from m3_tpu_torch.storage.bootstrap import BootstrapContext, BootstrapProcess
from m3_tpu_torch.storage.mediator import Mediator
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.retriever import BlockRetriever
from m3_tpu_torch.storage.scrub import DatabaseScrubber
from m3_tpu_torch.testing import faultfs
from m3_tpu_torch.utils.lockfile import Lockfile

root = tempfile.mkdtemp()
lock = Lockfile(os.path.join(root, "node.lock")).acquire()
hour = 3600 * 10**9
t0 = (int(t[0]) // (2 * hour)) * 2 * hour
now = {"t": t0 + 60 * 10**9}
pm = PersistManager(os.path.join(root, "data"))
ddb = Database(ShardSet(4), commitlog=cl.CommitLog(os.path.join(root, "cl")),
               clock=lambda: now["t"], retriever=BlockRetriever(pm, device="cpu"),
               device="cpu")
ddb.ensure_namespace(b"d", NamespaceOptions())
dids = [b"dur-%d" % i for i in range(40)]
dtags = [{b"__name__": b"dur", b"i": b"%d" % i} for i in range(40)]
ddb.write_batch(b"d", dids, np.full(40, t0), np.arange(40.0), tags=dtags)
now["t"] = t0 + 2 * hour + 11 * 60 * 10**9
ddb.tick()
ok = ok and ddb.flush(pm) >= 4 and ddb.evict_flushed() >= 1
ddb.write_batch(b"d", dids, np.full(40, now["t"]), -np.arange(40.0), tags=dtags)
ok = ok and Mediator(ddb, pm).snapshot(now["t"]) >= 1
fresh = Database(ShardSet(4), clock=lambda: now["t"], device="cpu")
fresh.ensure_namespace(b"d", NamespaceOptions())
BootstrapProcess(chain=("filesystem", "commitlog"), ctx=BootstrapContext(
    persist=pm, commitlog_dir=os.path.join(root, "cl"),
    shard_lookup=fresh.shard_set.lookup)).run(fresh)
for sid in dids:
    a, b = ddb.read(b"d", sid, 0, now["t"] + 1), fresh.read(b"d", sid, 0, now["t"] + 1)
    ok = ok and len(a[0]) == 2 and (a[0] == b[0]).all() and (a[1] == b[1]).all()
ok = ok and DatabaseScrubber(fresh, pm).run(now["t"] + 2 * hour)[b"d"].corrupt_found == 0
ok = ok and idx_persist.list_segments(pm.root, b"d") == [t0 - t0 % (4 * hour)]
ok = ok and wire.decode(wire.encode({b"k": [1, 2.5]})) == {b"k": [1, 2.5]}
ok = ok and faultfs.DiskFaultPlan(seed=1, write_eio=1.0).schedule("write", "a", 1) == ["eio"]
lock.release()

from m3_tpu_torch.aggregator import ProducerHandler, decode_aggregated_batch
from m3_tpu_torch.client import Session, SessionOptions
from m3_tpu_torch.cluster import placement as cpl
from m3_tpu_torch.cluster.client import ClusterClient
from m3_tpu_torch.cluster.topology import ConsistencyLevel, StaticTopology
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.query.remote import RemoteStorage, RemoteStorageServer
from m3_tpu_torch.query.storage import FanoutStorage, SessionStorage
from m3_tpu_torch.rpc import NodeServer, NodeService
from m3_tpu_torch.storage.repair import ShardRepairer
from m3_tpu_torch.testing.cluster import ClusterHarness, make_node_server
from m3_tpu_torch.testing.faultnet import FaultPlan

ch = ClusterHarness(3, 3, 4, start_ns=int(t[0]), data_root=os.path.join(root, "c"),
                    fault_plan=FaultPlan(), device="cpu")
cs = Session(ch.topology, SessionOptions(
    timeout_s=10, write_consistency=ConsistencyLevel.ALL), device="cpu")
csids = list(series)[:8]
for k in range(20):
    ch.clock.now_ns = int(t[k])
    cs.write_batch(b"default", csids, np.full(8, t[k]),
                   [series[x]["v"][k] for x in csids],
                   [series[x]["tags"] for x in csids])
ch.clock.advance(2 * hour + 11 * 60 * 10**9)
ch.tick_all()
got = cs.fetch_tagged(b"default", iq.TermQuery(b"__name__", b"bench_metric"),
                      0, ch.clock.now_ns)
ok = ok and sorted(got) == sorted(csids) and all(
    (got[x]["v"] == series[x]["v"][:20]).all() for x in csids)
srv = RemoteStorageServer(FanoutStorage([SessionStorage(cs, b"default")])).start()
rs = RemoteStorage(srv.endpoint)
blk = Engine(rs, device="cpu").execute_range(
    "rate(bench_metric[1m])", int(t[8]), int(t[19]), 30 * 10**9)
ok = ok and blk.values.shape[0] == 8 and np.isfinite(blk.values).any()
rs.close()
srv.close()
st = ShardRepairer(cs, host_id="node0").repair_shard(
    ch.nodes["node0"].db.namespace(b"default"), 0, 0, ch.clock.now_ns)
ok = ok and st.checksum_mismatches == 0 and st.peer_errors == 0
ok = ok and ClusterClient(store=MemStore()).placement_service().init(
    [cpl.Instance("a", "a:1")], 4, 1).num_shards == 4
pubs = []
ProducerHandler(type("P", (), {"publish": lambda self, s, p: pubs.append(p)})(),
                4).handle_columnar([([b"x"], np.array([1]), np.array([2.0]),
                                     pol)])
ok = ok and decode_aggregated_batch(pubs[0])[0].value == 2.0
cs.close()
ch.close()

import socket
import time
import urllib.parse
import urllib.request
from m3_tpu_torch.coordinator import Downsampler, run_clustered, run_embedded
from m3_tpu_torch.coordinator import promremote
from m3_tpu_torch.coordinator.carbon_ingest import CarbonServer
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.metrics.filters import TagsFilter
from m3_tpu_torch.metrics.matcher import Matcher, RuleSetStore
from m3_tpu_torch.metrics.rules import MappingRuleSnapshot, Rule, RuleSet

cnow = {"t": int(t[0])}
cclock = lambda: cnow["t"]
cdb = Database(ShardSet(4), clock=cclock, device="cpu")
for cns in (b"default", b"agg"):
    cdb.create_namespace(cns, NamespaceOptions(), index=NamespaceIndex(clock=cclock))
ckv = MemStore()
RuleSetStore(ckv).publish(RuleSet(b"default", 1, [Rule([MappingRuleSnapshot(
    "all", 0, TagsFilter({"__name__": "rw*"}), 0, (pol,))])]))
coord = run_embedded(cdb, kv_store=ckv, aggregated_namespaces={pol: b"agg"},
                     clock=cclock, device="cpu")
t0_ms = int(t[0]) // 10**6
body = promremote.snappy_compress(promremote.encode_write_request(
    [({b"__name__": b"rw", b"k": b"%d" % k},
      [(t0_ms + 10_000 * i, float(i * k)) for i in range(12)]) for k in range(4)]))
cnow["t"] = int(t[0]) + 120 * 10**9
req = urllib.request.Request(coord.endpoint + "/api/v1/prom/remote/write",
                             data=body, method="POST",
                             headers={"Content-Type": "application/x-protobuf"})
ok = ok and json.loads(urllib.request.urlopen(req).read())["wrote"] == 48
qs = urllib.parse.urlencode({"query": "rate(rw[1m])", "start": int(t[6]) / 1e9,
                             "end": int(t[11]) / 1e9, "step": "10"})
out = json.loads(urllib.request.urlopen(
    coord.endpoint + "/api/v1/query_range?" + qs).read())
ok = ok and len(out["data"]["result"]) == 4
carbon_srv = CarbonServer(coord.writer).start()
chost, cport = carbon_srv.endpoint.rsplit(":", 1)
with socket.create_connection((chost, int(cport))) as sock:
    sock.sendall(b"a.b.c 1.5 %d\n" % (int(t[5]) // 10**9))
for _ in range(200):
    if carbon_srv.lines_ingested:
        break
    time.sleep(0.05)
ok = ok and carbon_srv.lines_ingested == 1
carbon_srv.close()
cnow["t"] = int(t[0]) + 600 * 10**9
ok = ok and coord.flush_downsampler() > 0
rre = coord.rules_engine(step_ns=30 * 10**9)
rre.add_recording(RecordingRule(b"rw:sum", "sum(rw)"))
ok = ok and rre.evaluate(int(t[0]) + 120 * 10**9).recorded_rows > 0
coord.close()

import json as _json
from m3_tpu_torch.aggregator import AggregatorClient, ProducerHandler
from m3_tpu_torch.aggregator.server import HTTPAdminServer, RawTCPServer, TCPTransport
from m3_tpu_torch.cluster.client import ClusterClient
from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore
from m3_tpu_torch.collector import Reporter
from m3_tpu_torch.coordinator.ingest import M3MsgIngester
from m3_tpu_torch.metrics import id as metric_id
from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic
from m3_tpu_torch.rpc import HTTPJSONServer
from m3_tpu_torch.storage.namespace_watch import NamespaceWatch
from m3_tpu_torch.storage.runtime import RuntimeOptionsManager, watch_kv_runtime_options
from m3_tpu_torch.testing.cluster import SettableClock

kvsrv = KVServer().start()
pclock = SettableClock(int(t[0]) - int(t[0]) % (60 * 10**9))
pdb = Database(ShardSet(4), clock=pclock, device="cpu")
pst = RemoteStore(kvsrv.endpoint)
watch = NamespaceWatch(pdb, pst).start()
watch.add(b"agg", retention_ns=40 * 3600 * 10**9, index_enabled=False)
mgr = watch_kv_runtime_options(pst, RuntimeOptionsManager())
ClusterClient(endpoint=kvsrv.endpoint).kv().set("_kvconfig/client-write-consistency-level", b'"all"')
for _ in range(500):
    if mgr.get().write_consistency == "all":
        break
    time.sleep(0.01)
ok = ok and mgr.get().write_consistency == "all" and b"agg" in pdb.namespaces
hj = HTTPJSONServer(NodeService(pdb, device="cpu")).start()
hreq = urllib.request.Request(hj.endpoint + "/write_batch", method="POST", data=_json.dumps(
    {"ns": "agg", "ids": [{"b64": "YQ=="}], "ts": [pclock()], "vals": [2.5]}).encode())
ok = ok and _json.loads(urllib.request.urlopen(hreq).read())["r"] == 1
hj.close()
consumer = Consumer(M3MsgIngester(lambda p: LocalStorage(pdb, b"agg"))).start()
cpl0 = cpl.initial_placement([cpl.Instance("c", consumer.endpoint)], 4, 1)
prod = Producer(Topic("aggregated_metrics", 4, (ConsumerService("c"),)),
                {"c": lambda: cpl0}, retry_delay_s=0.05)
pagg = Aggregator(num_shards=8, clock=pclock, flush_handler=ProducerHandler(prod, 4),
                  device="cpu")
rsrv = RawTCPServer(pagg).start()
asrv = HTTPAdminServer(pagg).start()
tr = TCPTransport(rsrv.endpoint)
rep = Reporter(Matcher(RuleSetStore(ckv), b"default", clock=pclock),
               AggregatorClient(8, lambda: cpl.initial_placement(
                   [cpl.Instance("a", "a:1")], 8, 1), {"a": tr}))
rw_id = metric_id.encode(b"rw", {b"k": b"1"})
for k in range(3):
    ok = ok and rep.report_counter(rw_id, k + 1)
ok = ok and tr.flush()
for _ in range(500):
    if rsrv.frames == 3:
        break
    time.sleep(0.01)
pclock.advance(60 * 10**9)
ok = ok and pagg.flush() == 1
for _ in range(500):
    if prod.unacked() == 0:
        break
    time.sleep(0.01)
ok = ok and pdb.read(b"agg", rw_id, 0, 2**62)[1].tolist() == [6.0]
tr.close()
for closer in (prod.close, consumer.close, rsrv.close, asrv.close, pst.close,
               kvsrv.close):
    closer()

from m3_tpu_torch import nsch
from m3_tpu_torch.services import load_dict, run_aggregator, run_dbnode
from m3_tpu_torch.services.run import run_coordinator_standalone, run_kv
from m3_tpu_torch.tools import fileset_tools

sroot = tempfile.mkdtemp()
snode = run_dbnode(load_dict({"data_dir": os.path.join(sroot, "n"),
                              "num_shards": 4, "coordinator": {}}, "dbnode"),
                   device="cpu")
sreq = urllib.request.Request(
    snode.coordinator.endpoint + "/api/v1/json/write", method="POST",
    data=_json.dumps({"tags": {"__name__": "svc"}, "timestamp": time.time(),
                      "value": 2.0}).encode(),
    headers={"Content-Type": "application/json"})
ok = ok and _json.loads(urllib.request.urlopen(sreq).read())["wrote"] == 1
ok = ok and snode.coordinator.engine.device.type == "cpu"
skv = run_kv(load_dict({}, "kv"))
sagg = run_aggregator(load_dict({"num_shards": 4, "kv_endpoint": skv.endpoint},
                                "aggregator"), device="cpu")
ok = ok and sagg.aggregator.device.type == "cpu"
for closer in (sagg.close, sagg.kv.close, skv.close, snode.close):
    closer()
srows = [r for s in range(4)
         for r in fileset_tools.read_data_files(pm.root, b"d", s, device="cpu")]
ok = ok and len(srows) == 40 and sorted(r[0] for r in srows) == sorted(dids)
agent = nsch.Agent(nsch.Workload(cardinality=3), lambda *a: None)
ok = ok and agent.run_for(6) == 6

from m3_tpu_torch.testing import loadgen, scenario
from m3_tpu_torch.utils import lockdep, racewatch

lgr = loadgen.LoadGen(loadgen.LoadSchedule(
    seed=1, base_rate=40, phases=(loadgen.Phase("p", 0.1, 1.0),))).run(
        lambda kind: None)
ok = ok and len(lgr.records) == 4 and lgr.outcomes() == {"ok": 4}
lg = lockdep.LockdepGraph()
la, lb = object(), object()
for x, y in ((la, lb), (lb, la)):
    lg.on_acquire("A" if x is la else "B", x, False, "s")
    lg.on_acquire("A" if y is la else "B", y, False, "s")
    lg.on_release("A", la)
    lg.on_release("B", lb)
ok = ok and len(lg.cycles) == 1 and not lockdep.installed()
ok = ok and len(racewatch.racy_pairs([
    {"thread": 1, "locks": [], "write": True},
    {"thread": 2, "locks": [], "write": False}])) == 1
drill = scenario.ChurnScenario(scenario.ChurnScenarioOptions(
    seed=13, duration_s=0.3, base_rate=20, n_series=8, num_shards=4,
    device="cpu"))
try:
    res = drill.verify(drill.run())
    ok = ok and res.verified_points > 0
finally:
    drill.close()
kd = scenario.KillRestartScenario(scenario.KillRestartOptions(device="cpu"))
ok = ok and kd.argv()[1:3] == ["-m", "m3_tpu_torch.services"]
kd.close()

from m3_tpu_torch.device import attach
from m3_tpu_torch.parallel import query as pquery
from m3_tpu_torch.parallel.dryrun import dryrun_multichip
from m3_tpu_torch.query import executor as qexec

ok = ok and ingest.flush_mesh() is None
ok = ok and qexec._default_query_mesh() is None
dr = dryrun_multichip([torch.device("cpu")] * 4)
ok = ok and dr["sharded_agg"] == 1 and dr["mesh"] == {"shard": 2, "time": 2}
ok = ok and ingest.flush_mesh() is None and Engine(DictStorage(series),
                                                   device="cpu").mesh is None
with attach([torch.device("cpu")] * 2):
    ok = ok and ingest.flush_mesh().shape == {"shard": 2, "time": 1}
    ok = ok and pquery.sum_rate(np.cumsum(np.ones((3, 12)), 1), ingest.flush_mesh(),
                                W=4, step_ns=10**10, range_ns=4 * 10**10)[-1] > 0

torch.cuda.is_available = lambda: False
ddb.device = torch.device("cuda")
cagg = Aggregator(device="cpu")
cagg.device = torch.device("cuda")
csvc = NodeService(fresh, device="cpu")
csvc.device = torch.device("cuda")
for make in (lambda: Engine(DictStorage(series)),
             lambda: Database(ShardSet(4)), lambda: Aggregator(),
             lambda: MetricList(60 * 10**9), lambda: BlockRetriever(pm),
             lambda: BootstrapProcess().run(ddb),
             lambda: Session(StaticTopology(cpl.initial_placement(
                 [cpl.Instance("a", "a:1")], 4, 1))),
             lambda: ClusterHarness(1, 1, 2), lambda: make_node_server(2),
             lambda: NodeService(fresh), lambda: run_embedded(cdb),
             lambda: run_clustered(cs),
             lambda: Downsampler(Matcher(RuleSetStore(ckv), b"default"),
                                 lambda *a: None),
             lambda: NamespaceWatch(ddb, MemStore()),
             lambda: HTTPJSONServer(csvc), lambda: RawTCPServer(cagg),
             lambda: HTTPAdminServer(cagg),
             lambda: run_dbnode(load_dict({"data_dir": os.path.join(
                 sroot, "refused")}, "dbnode")),
             lambda: run_aggregator(load_dict({}, "aggregator")),
             lambda: run_coordinator_standalone(load_dict(
                 {"kv_endpoint": "127.0.0.1:1"}, "coordinator")),
             lambda: fileset_tools.read_data_files(pm.root, b"d", 0),
             lambda: scenario.ChurnScenario(),
             lambda: scenario.ComputeFaultChurnScenario(),
             lambda: scenario.DiskFaultScenario(),
             lambda: scenario.KillRestartScenario(scenario.KillRestartOptions(
                 data_dir=os.path.join(sroot, "refused"))),
             lambda: dryrun_multichip([torch.device("cuda")] * 2)):
    try:
        make()
        ok = False
    except RuntimeError:
        pass
ok = ok and not os.path.exists(os.path.join(sroot, "refused"))
# m3lint on the port: every module of the analyzer, a run of its CLI and
# a witness check that refuses an empty dump directory
import contextlib, importlib, io, pkgutil
import m3_tpu_torch.analysis as m3lint
for info in pkgutil.walk_packages(m3lint.__path__, "m3_tpu_torch.analysis."):
    importlib.import_module(info.name)
from m3_tpu_torch.analysis import __main__ as lint_main, witness
with contextlib.redirect_stdout(io.StringIO()):
    ok = ok and lint_main.main(["m3_tpu_torch/analysis", "--no-cache"]) == 0
    ok = ok and witness.main(["numerics", sroot]) == 2
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "m3_tpu"
              or m.startswith("m3_tpu."))
print(json.dumps({"ok": bool(ok), "mods": mods}))
"""


def test_port_slice_imports_neither_jax_nor_m3_tpu():
    """The ingest slice, a few Engine queries (the six functions of the
    query path's last slice among them, and queries on the compiled plan
    route), Graphite renders and a placement
    decision, the storage path (write, tick, read and a LocalStorage
    query), a block merge and a guarded decode under an injected fault,
    the aggregator tier (the agg_rollup_10x population's two flushes, a
    managed Aggregator.flush), a rules engine round, and the durable path
    (a lockfile, a commit-logged write, flush with index segments,
    eviction, a snapshot, a bootstrap from filesystem and commit log, a
    scrub, the wire codec and a disk-fault plan), and the replicated
    cluster (a 3-node harness behind fault proxies, writes and a
    fetch_tagged through a Session, a query over a RemoteStorage in front
    of a FanoutStorage of a SessionStorage, a repair sweep, a placement
    through the cluster client and a producer handler's payload), and the
    coordinator (run_embedded over a Database with the index, a snappy
    protobuf remote write, a query_range over HTTP, a carbon line through
    the listener, a downsampler flush and a rules engine round), in a
    fresh process; the Engine, the Database, the Aggregator, a
    MetricList, a BlockRetriever, a Session, a ClusterHarness, a node
    server, a NodeService, run_embedded, run_clustered and a Downsampler
    also refuse to start without a card unless asked for the CPU, and a
    bootstrap of a database placed on the card refuses to run without
    one. Then the metadata plane and the aggregation pipeline over the
    network: a namespace added through a NamespaceWatch over a KV
    service, a runtime option folded from KV, a write_batch through the
    HTTP JSON server, and a collector Reporter's counters over TCP into an
    aggregator whose flush rides m3msg into storage; a namespace watch, an
    HTTP JSON server and the aggregator's raw TCP and admin servers refuse
    to start over objects placed on a card that is not there. Then the
    service assembly: run_dbnode(device="cpu") with a coordinator section
    taking a JSON write over HTTP, run_kv and run_aggregator over it, a
    tools read of the durable path's filesets and an nsch agent; run_dbnode
    (which touches no data dir), run_aggregator, run_coordinator_standalone
    and fileset_tools.read_data_files refuse to start without a card. Then
    the harnesses: an open-loop LoadGen run, a lockdep graph closing a
    cycle, a racy pair, a small churn drill held to its verify, and the
    kill drill's child command line; the four drills refuse to start
    without a card. Then the multi-device layer: no mesh with nothing
    attached, the dry run over four CPU entries (sharded ingest, decode
    round trip, sum_rate, a coordinator's sharded aggregation over HTTP),
    a mesh sum_rate under attach; the dry run over cards refuses without
    one. Then m3lint on the port: every module of m3_tpu_torch.analysis,
    its CLI over its own directory and a witness check."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _SLICE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"]
    assert out["mods"] == []


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from m3_tpu_torch.persist.fs import FilesetReader, PersistManager
    from m3_tpu_torch.storage.block import encode_block as enc
    from m3_tpu_torch.storage.bootstrap import BootstrapProcess
    from m3_tpu_torch.storage.database import Database as Db
    from m3_tpu_torch.storage.retriever import BlockRetriever
    from m3_tpu_torch.storage.series import SeriesRegistry
    from m3_tpu_torch.utils.bloom import BloomFilter

    reg = SeriesRegistry()
    reg.get_or_create(b"a")
    pm = PersistManager(str(tmp_path))
    path = pm.write_block(b"ns", 0, enc(
        0, np.zeros(1, np.int32), np.arange(4, dtype=np.int64)[None, :],
        np.ones((1, 4)), np.full(1, 4, np.int32), device="cpu"), reg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from m3_tpu_torch.ops import tsz
    from m3_tpu_torch.parallel import ingest
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.ops import series_agg, temporal
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.query.graphite import GraphiteEngine
    from m3_tpu_torch.testing import DictStorage
    from m3_tpu_torch.client.decode import decode_tile
    from m3_tpu_torch.storage.block import SealedBlock, encode_block
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.shard import Shard, ShardOptions
    from m3_tpu_torch.utils import hashing
    from m3_tpu_torch.utils.hbm import HBMBudget
    from m3_tpu_torch.aggregator import Aggregator, MetricList, MetricLists
    from m3_tpu_torch.cluster.kv import MemStore
    from m3_tpu_torch.coordinator import (Downsampler, run_clustered,
                                          run_embedded)
    from m3_tpu_torch.metrics.matcher import Matcher, RuleSetStore
    from m3_tpu_torch.parallel import agg_flush

    from m3_tpu_torch.services import load_dict, run_aggregator, run_dbnode
    from m3_tpu_torch.services.run import run_coordinator_standalone
    from m3_tpu_torch.tools import fileset_tools
    from m3_tpu_torch.aggregator.server import HTTPAdminServer, RawTCPServer
    from m3_tpu_torch.rpc import HTTPJSONServer, NodeService
    from m3_tpu_torch.storage.namespace_watch import NamespaceWatch
    from m3_tpu_torch.testing import scenario
    from m3_tpu_torch.rpc import node_server
    from m3_tpu_torch.testing import faultnet
    from m3_tpu_torch.device import attach
    from m3_tpu_torch.parallel import dryrun

    # The drills must refuse before they spawn a child or open a listener.
    started = []
    monkeypatch.setattr(scenario.subprocess, "Popen",
                        lambda *a, **k: started.append("spawn"))
    monkeypatch.setattr(node_server.NodeServer, "__init__",
                        lambda self, *a, **k: started.append("listen"))
    monkeypatch.setattr(faultnet.FaultProxy, "__init__",
                        lambda self, *a, **k: started.append("proxy"))

    placed = Db(ShardSet(4), device="cpu")
    placed_svc = NodeService(placed, device="cpu")
    placed_agg = Aggregator(device="cpu")
    for obj in (placed, placed_svc, placed_agg):
        obj.device = torch.device("cuda")  # placed on the card

    ts, vals, npts = ingest.make_example_raw(4, 12, np.random.default_rng(0))
    calls = [
        lambda: tsz.encode(ts, vals, npts),
        lambda: tsz.decode_plane(np.zeros((4, 8), np.uint32), npts, window=12),
        lambda: tsz.decode(np.zeros((4, 8), np.uint32), npts, 12),
        lambda: hashing.hash_batch([b"a"]),
        lambda: ShardSet().lookup_batch([b"a"]),
        lambda: ingest.make_raw_batch(ts, vals, npts),
        lambda: ingest.ingest_step_raw(
            ingest.make_raw_batch(ts, vals, npts, device="cpu"),
            rollup_factor=6, max_words=tsz.max_words_for(12)),
        lambda: Engine(DictStorage({})),
        lambda: temporal.rate(vals, 4, 10, 40),
        lambda: temporal.over_time(vals, 4, "sum"),
        lambda: temporal.quantile_over_time(vals, 4, 0.5),
        lambda: temporal.changes(vals, 4),
        lambda: temporal.resets(vals, 4),
        lambda: temporal.deriv(vals, 4, 10),
        lambda: temporal.predict_linear(vals, 4, 10, 60.0),
        lambda: temporal.holt_winters(vals, 4, 0.3, 0.6),
        lambda: GraphiteEngine(DictStorage({})),
        lambda: series_agg.grouped_reduce(vals, np.zeros(4, int), 1, "sum"),
        lambda: Database(ShardSet(4)),
        lambda: Shard(0, ShardOptions()),
        lambda: encode_block(0, np.arange(4, dtype=np.int32), ts, vals, npts),
        lambda: SealedBlock(0, 8, np.zeros(1, np.int32),
                            np.zeros((1, 8), np.uint32), np.zeros(1, np.int32),
                            np.ones(1, np.int32)),
        lambda: decode_tile(np.zeros((4, 8), np.uint32), npts, 12, 4),
        lambda: HBMBudget(1 << 20).device_put(vals),
        lambda: Aggregator(),
        lambda: MetricList(60 * 10**9),
        lambda: MetricLists(),
        lambda: agg_flush.exact_quantile_values(
            [np.ones(3)], np.array([3]), (0.5,)),
        lambda: BloomFilter(64, 3).add_batch([b"a"]),
        lambda: FilesetReader(path).to_block(),
        lambda: FilesetReader(path).verify_rows(),
        lambda: BlockRetriever(pm),
        lambda: BootstrapProcess().run(placed),
        lambda: run_embedded(Db(ShardSet(4), device="cpu")),
        lambda: run_clustered(None),
        lambda: Downsampler(Matcher(RuleSetStore(MemStore()), b"default"),
                            lambda *a: None),
        lambda: NamespaceWatch(placed, MemStore()),
        lambda: HTTPJSONServer(placed_svc),
        lambda: RawTCPServer(placed_agg),
        lambda: HTTPAdminServer(placed_agg),
        lambda: run_dbnode(load_dict({"data_dir": str(tmp_path / "node")},
                                     "dbnode")),
        lambda: run_aggregator(load_dict({}, "aggregator")),
        lambda: run_coordinator_standalone(load_dict(
            {"kv_endpoint": "127.0.0.1:1"}, "coordinator")),
        lambda: fileset_tools.read_data_files(str(tmp_path), b"ns", 0),
        lambda: fileset_tools.verify_index_files(str(tmp_path), b"ns", 0),
        lambda: scenario.ChurnScenario(),
        lambda: scenario.ChurnScenario(scenario.ChurnScenarioOptions(
            seed=13, n_series=8)),
        lambda: scenario.ComputeFaultChurnScenario(),
        lambda: scenario.DiskFaultScenario(),
        lambda: scenario.KillRestartScenario(),
        lambda: scenario.KillRestartScenario(scenario.KillRestartOptions(
            data_dir=str(tmp_path / "drill"))),
        lambda: dryrun.dryrun_multichip([torch.device("cuda")] * 2),
        lambda: attach(["cuda"] * 2).__enter__(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "node").exists()
    assert not (tmp_path / "drill").exists() and started == []


def test_explicit_cuda_request_raises_without_cuda(monkeypatch):
    from m3_tpu_torch.device import resolve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve("cuda")
    assert resolve("cpu").type == "cpu"


def test_services_cli_runs_on_the_cpu_or_refuses(tmp_path):
    """`python -m m3_tpu_torch.services dbnode -f examples/dbnode.yml`
    without a card exits non-zero with the resolve message and starts
    nothing; with --device cpu (its data dir under tmp_path) it names the
    device, serves a health RPC and exits 0 on SIGTERM."""
    import signal
    import socket

    from m3_tpu_torch.rpc import wire

    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    example = os.path.join(ROOT, "examples", "dbnode.yml")
    res = subprocess.run(
        [sys.executable, "-m", "m3_tpu_torch.services", "dbnode", "-f",
         example], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
    text = open(example).read()
    text = text.replace("127.0.0.1:9000", "127.0.0.1:0").replace(
        "/tmp/m3_tpu_data", str(tmp_path / "data"))
    cfg_path = tmp_path / "dbnode.yml"
    cfg_path.write_text(text)
    proc = subprocess.Popen(
        [sys.executable, "-m", "m3_tpu_torch.services", "dbnode", "-f",
         str(cfg_path), "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "embedded coordinator on" in line:
                break
        assert lines[0].strip() == "m3_tpu_torch dbnode device cpu", lines
        listen = next(ln for ln in lines if "dbnode listening on" in ln)
        host, _, port = listen.rsplit(" ", 1)[-1].strip().rpartition(":")
        with socket.create_connection((host, int(port)), timeout=30) as sock:
            sock.settimeout(30)
            wire.write_frame(sock, {"m": "health", "a": {}, "id": 1})
            assert wire.read_frame(sock)["ok"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        rest = proc.stdout.read().strip().splitlines()
        # The last line: the child's kernel launches, none on the CPU.
        head, _, counts = rest[-1].partition(" kernel launches ")
        assert head == "m3_tpu_torch dbnode" and json.loads(counts) == {
            "pack": 0, "decode": 0, "hash": 0, "window": 0}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()


def test_no_string_names_a_reference_module():
    """No file of the port, and not chip_smoke.py, names a module
    `m3_tpu.<x>` in a string: no spawned `-m` can run the reference. The
    scan covers the modules that spawn children (em, the kill drill), and
    the kill drill's child runs the port's services."""
    import io
    import re
    import tokenize

    ref = re.compile(r"(?<![\w/.])m3_tpu\.[A-Za-z_]")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "m3_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    found = []
    for path in paths:
        with open(path, "rb") as f:
            toks = tokenize.tokenize(io.BytesIO(f.read()).readline)
            found += [(path, t.start[0], t.string) for t in toks
                      if t.type == tokenize.STRING and ref.search(t.string)]
    assert len(paths) > 100 and found == []
    spawners = [os.path.join(ROOT, "m3_tpu_torch", *p) for p in (
        ("em.py",), ("testing", "scenario.py"))]
    assert all(p in paths for p in spawners)
    from m3_tpu_torch.testing import scenario

    drill = scenario.KillRestartScenario(
        scenario.KillRestartOptions(device="cpu"))
    try:
        assert drill.argv()[1:4] == ["-m", "m3_tpu_torch.services", "dbnode"]
    finally:
        drill.close()
    assert ref.search('"m3_tpu.services"') and not ref.search(
        '"m3_tpu_torch.services"')


def test_chip_smoke_defines_every_phase_before_it_runs():
    """chip_smoke.py runs main() under its `if __name__ == "__main__"`
    block: every function it defines must come before that block, or the
    script dies with a NameError at the first phase defined after it."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main_at = next(i for i, node in enumerate(tree.body)
                   if isinstance(node, ast.If)
                   and "__main__" in ast.unparse(node.test))
    late = [ast.unparse(node)[:60] for node in tree.body[main_at + 1:]]
    assert late == [], late
    defined = {node.name for node in tree.body[:main_at]
               if isinstance(node, ast.FunctionDef)}
    assert {"main", "_services_phase", "_harness_phase"} <= defined
