"""The port stands alone: it never imports JAX or the m3_tpu package, and
its entry points never fall back to the CPU on their own."""

import json
import os
import subprocess
import sys

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

torch.cuda.is_available = lambda: False
ddb.device = torch.device("cuda")
for make in (lambda: Engine(DictStorage(series)),
             lambda: Database(ShardSet(4)), lambda: Aggregator(),
             lambda: MetricList(60 * 10**9), lambda: BlockRetriever(pm),
             lambda: BootstrapProcess().run(ddb)):
    try:
        make()
        ok = False
    except RuntimeError:
        pass
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
    scrub, the wire codec and a disk-fault plan), in a fresh process; the
    Engine, the Database, the Aggregator, a MetricList and a
    BlockRetriever also refuse to start without a card unless asked for
    the CPU, and a bootstrap of a database placed on the card refuses to
    run without one."""
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
    from m3_tpu_torch.parallel import agg_flush

    placed = Db(ShardSet(4), device="cpu")
    placed.device = torch.device("cuda")  # a database placed on the card

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
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_explicit_cuda_request_raises_without_cuda(monkeypatch):
    from m3_tpu_torch.device import resolve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve("cuda")
    assert resolve("cpu").type == "cpu"
