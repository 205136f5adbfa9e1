"""The port's durable lifecycle against the reference's, on the CPU: the
flush state machine (tests/test_flush_model.py), flush -> evict_flushed
-> cold reads through the BlockRetriever and its WiredList
(tests/test_cold_read.py), the Mediator's run_once, the quarantine-only
scrubber and the disk-fault plane through the port's faultfs
(tests/test_diskfault.py).

Every case runs the same schedule through both packages and compares:
flush states after every action, read results bit for bit, retriever,
mediator and scrub counts, fault decisions, typed errors and health
outcomes. No tolerance applies."""

import errno
import itertools
import os
import time
import types

import numpy as np
import pytest
import torch

from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.persist import commitlog as jcl
from m3_tpu.persist import diskio as jdiskio
from m3_tpu.persist import fs as jfs
from m3_tpu.storage import block as jblock
from m3_tpu.storage import block_cache as jcache
from m3_tpu.storage import bootstrap as jbs
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.mediator import Mediator as JMediator
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.storage.retriever import BlockRetriever as JBlockRetriever
from m3_tpu.storage.scrub import DatabaseScrubber as JDatabaseScrubber
from m3_tpu.storage.scrub import ScrubOptions as JScrubOptions
from m3_tpu.testing import faultfs as jfaultfs
from m3_tpu.utils.health import Priority as JPriority
from m3_tpu.utils.hbm import HBMBudget as JHBMBudget
from m3_tpu.utils.limits import Backpressure as JBackpressure
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist import commitlog as cl
from m3_tpu_torch.persist import diskio
from m3_tpu_torch.persist import fs as pfs
from m3_tpu_torch.storage import block as pblock
from m3_tpu_torch.storage import block_cache as pcache
from m3_tpu_torch.storage import bootstrap as bs
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.mediator import Mediator, MediatorOptions
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.retriever import BlockRetriever
from m3_tpu_torch.storage.scrub import (DatabaseScrubber, RepairUnsupported,
                                        ScrubOptions)
from m3_tpu_torch.testing import faultfs
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.health import Priority
from m3_tpu_torch.utils.hbm import HBMBudget
from m3_tpu_torch.utils.limits import Backpressure

CPU = "cpu"
NS = b"default"
BLOCK = 2 * xtime.HOUR
S = xtime.SECOND
T0 = 1_600_000_000 * S - (1_600_000_000 * S) % BLOCK

PORT = types.SimpleNamespace(
    name="port", cl=cl, fs=pfs, bs=bs, diskio=diskio, faultfs=faultfs,
    ShardSet=ShardSet, Mediator=Mediator, NamespaceOptions=NamespaceOptions,
    WiredList=pblock.WiredList, Backpressure=Backpressure, Priority=Priority,
    DatabaseScrubber=DatabaseScrubber, ScrubOptions=ScrubOptions,
    Database=lambda *a, **k: Database(*a, device=CPU, **k),
    BlockRetriever=lambda *a, **k: BlockRetriever(*a, device=CPU, **k))
REF = types.SimpleNamespace(
    name="ref", cl=jcl, fs=jfs, bs=jbs, diskio=jdiskio, faultfs=jfaultfs,
    ShardSet=JShardSet, Mediator=JMediator,
    NamespaceOptions=JNamespaceOptions, WiredList=jblock.WiredList,
    Backpressure=JBackpressure, Priority=JPriority,
    DatabaseScrubber=JDatabaseScrubber,
    ScrubOptions=JScrubOptions, Database=JDatabase,
    BlockRetriever=JBlockRetriever)
PKGS = (PORT, REF)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Fresh block caches for both packages; every test starts and ends
    on the real disk seams."""
    monkeypatch.setattr(pcache, "_CACHE", pcache.DeviceBlockCache(
        budget=HBMBudget(64 << 20), admit_after=2))
    monkeypatch.setattr(jcache, "_CACHE", jcache.DeviceBlockCache(
        budget=JHBMBudget(64 << 20), admit_after=2))
    for pkg in PKGS:
        pkg.faultfs.uninstall()
    yield
    for pkg in PKGS:
        pkg.faultfs.uninstall()


def _bits(tv):
    t, v = tv
    return np.asarray(t).tobytes(), np.asarray(v, np.float64).tobytes()


# ---------------------------------------------------------------------------
# the flush state machine (tests/test_flush_model.py)
# ---------------------------------------------------------------------------

MODEL_BLOCK = 10 * xtime.MINUTE
MODEL_T0 = 1_600_000_000 * S - (1_600_000_000 * S) % MODEL_BLOCK


class Model:
    """One shard's flush lifecycle driven by abstract actions, the same
    actions applied to a port and a reference database."""

    ACTIONS = ("write", "advance", "tick", "flush", "flush_fail")

    def __init__(self, pkg, root):
        self.pkg = pkg
        self.now = {"t": MODEL_T0}
        self.db = pkg.Database(pkg.ShardSet(1), clock=lambda: self.now["t"])
        self.db.create_namespace(b"ns", pkg.NamespaceOptions(
            index_enabled=False, block_size_ns=MODEL_BLOCK,
            buffer_past_ns=2 * xtime.MINUTE,
            buffer_future_ns=2 * xtime.MINUTE))
        self.pm = pkg.fs.PersistManager(root)
        self.writes = 0
        self.flushed = []

    @property
    def shard(self):
        return self.db.namespace(b"ns").shards[0]

    def apply(self, action):
        if action == "write":
            self.db.write(b"ns", b"model.series", self.now["t"],
                          float(self.writes))
            self.writes += 1
        elif action == "advance":
            self.now["t"] += 6 * xtime.MINUTE
        elif action == "tick":
            self.db.tick()
        elif action == "flush":
            for bstart in list(self.shard.flushable(self.now["t"])):
                assert bstart in self.shard.blocks
                self.pm.write_block(b"ns", 0, self.shard.blocks[bstart],
                                    self.shard.registry)
                self.shard.mark_flushed(bstart)
                self.flushed.append(bstart)
        else:
            for bstart in list(self.shard.flushable(self.now["t"])):
                self.shard.mark_flushed(bstart, ok=False)

    def state(self):
        return ({k: v.value for k, v in self.shard.flush_states.items()},
                self.shard.flushable(self.now["t"]), list(self.flushed))

    def check_invariants(self):
        assert len(self.flushed) == len(set(self.flushed))
        for bstart, st in self.shard.flush_states.items():
            if st.value == "failed":
                assert bstart in self.shard.flushable(self.now["t"])


def _sequences(depth, n, seed):
    seqs = [s for s in itertools.product(Model.ACTIONS, repeat=depth)
            if "write" in s]
    rng = np.random.default_rng(seed)
    return [seqs[i] for i in rng.choice(len(seqs), n, replace=False)]


@pytest.mark.parametrize("chunk", range(4))
def test_flush_states_follow_the_reference(tmp_path, chunk):
    """Seeded action sequences of depth 5 (a quarter of a 120-sequence
    draw each): after every action the port's flush states, flushable
    set and successful flushes equal the reference's, and the model's
    invariants hold."""
    seqs = _sequences(5, 120, 3)[chunk * 30:(chunk + 1) * 30]
    for k, seq in enumerate(seqs):
        m = Model(PORT, str(tmp_path / f"p{k}"))
        j = Model(REF, str(tmp_path / f"j{k}"))
        for action in seq:
            m.apply(action)
            j.apply(action)
            m.check_invariants()
            assert m.state() == j.state(), (seq, action)


def test_flush_states_exhaustive_depth_3(tmp_path):
    for k, seq in enumerate(s for s in itertools.product(Model.ACTIONS,
                                                         repeat=3)
                            if "write" in s):
        m = Model(PORT, str(tmp_path / f"p{k}"))
        j = Model(REF, str(tmp_path / f"j{k}"))
        for action in seq:
            m.apply(action)
            j.apply(action)
            assert m.state() == j.state(), (seq, action)


def test_durability_after_crash(tmp_path):
    """Seal + flush + crash -> the filesystem bootstrap recovers every
    flushed point."""
    m = Model(PORT, str(tmp_path / "crash"))
    for action in ("write", "advance", "write", "advance", "advance",
                   "tick", "flush"):
        m.apply(action)
    assert m.flushed
    db2 = PORT.Database(ShardSet(1), clock=lambda: m.now["t"])
    db2.create_namespace(b"ns", NamespaceOptions(index_enabled=False,
                                                 block_size_ns=MODEL_BLOCK))
    bs.BootstrapProcess(chain=("filesystem", "uninitialized_topology"),
                        ctx=bs.BootstrapContext(persist=m.pm)).run(db2)
    t, _v = db2.read(b"ns", b"model.series", 0, m.now["t"])
    assert len(t) == sum(m.shard.blocks[b].npoints.sum() for b in m.flushed)


# ---------------------------------------------------------------------------
# flush -> evict -> cold reads (tests/test_cold_read.py)
# ---------------------------------------------------------------------------

COLD_T0 = 1_600_000_000 * S


def _cold_db(pkg, root, n_series=6, n_points=10, shards=4, wired=None):
    now = {"t": COLD_T0}
    pm = pkg.fs.PersistManager(os.path.join(root, "data"))
    retr = pkg.BlockRetriever(pm, wired_list=wired)
    db = pkg.Database(pkg.ShardSet(shards), clock=lambda: now["t"],
                      retriever=retr)
    db.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
    ids = [f"srv-{i}".encode() for i in range(n_series)]
    rng = np.random.default_rng(7)
    for j in range(n_points):
        now["t"] = COLD_T0 + j * 10 * S
        db.write_batch(NS, ids, np.full(n_series, now["t"], np.int64),
                       rng.standard_normal(n_series) * 100)
    return db, pm, retr, ids, now


@pytest.mark.parametrize("n_series,shards", [(6, 4), (40, 2)])
def test_cold_reads_equal_pre_eviction_reads(tmp_path, n_series, shards):
    out = {}
    for pkg in PKGS:
        db, pm, retr, ids, now = _cold_db(pkg, str(tmp_path / pkg.name),
                                          n_series=n_series, shards=shards)
        now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
        db.tick()
        end = COLD_T0 + xtime.HOUR
        before = [_bits(db.read(NS, sid, COLD_T0, end)) for sid in ids]
        flushed = db.flush(pm)
        evicted = db.evict_flushed()
        assert all(not sh.blocks for sh in db.namespace(NS).shards.values())
        cold = [_bits(db.read(NS, sid, COLD_T0, end)) for sid in ids]
        seeks = retr.stats["seeks"]
        again = [_bits(db.read(NS, sid, COLD_T0, end)) for sid in ids]
        assert cold == before == again
        assert retr.stats["seeks"] == seeks == len(ids)
        assert retr.stats["wired_hits"] == len(ids)
        out[pkg.name] = (flushed, evicted, before, dict(retr.stats),
                         len(retr.wired))
    assert out["port"] == out["ref"]


def test_cold_read_unknown_series_bloom_negative(tmp_path):
    db, pm, retr, _ids, now = _cold_db(PORT, str(tmp_path))
    now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    db.flush(pm)
    db.evict_flushed()
    t, v = db.read(NS, b"never-written", COLD_T0, COLD_T0 + xtime.HOUR)
    assert len(t) == 0 and len(v) == 0 and retr.stats["seeks"] == 0


def test_cold_read_merges_disk_and_buffer(tmp_path):
    out = []
    for pkg in PKGS:
        db, pm, _retr, ids, now = _cold_db(pkg, str(tmp_path / pkg.name),
                                           n_series=2)
        now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
        db.tick()
        db.flush(pm)
        db.evict_flushed()
        fresh_t = now["t"]
        db.write(NS, ids[0], fresh_t, 999.0)
        t, v = db.read(NS, ids[0], COLD_T0, fresh_t + 1)
        assert len(t) == 11 and t[-1] == fresh_t and v[-1] == 999.0
        out.append(_bits((t, v)))
    assert out[0] == out[1]


def test_wired_list_byte_bounded_eviction(tmp_path):
    out = []
    for pkg in PKGS:
        db, pm, retr, ids, now = _cold_db(
            pkg, str(tmp_path / pkg.name), n_series=8, shards=1,
            wired=pkg.WiredList(max_bytes=64))
        now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
        db.tick()
        db.flush(pm)
        db.evict_flushed()
        for sid in ids:
            db.read(NS, sid, COLD_T0, COLD_T0 + xtime.HOUR)
        assert len(retr.wired) <= 2
        before = retr.stats["seeks"]
        t, _ = db.read(NS, ids[0], COLD_T0, COLD_T0 + xtime.HOUR)
        assert len(t) == 10 and retr.stats["seeks"] == before + 1
        out.append((dict(retr.stats), len(retr.wired)))
    assert out[0] == out[1]


def test_evict_needs_a_retriever_and_a_fileset_on_disk(tmp_path):
    now = {"t": COLD_T0}
    db = PORT.Database(ShardSet(2), clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    db.write(NS, b"a", COLD_T0, 1.0)
    now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    assert db.evict_flushed() == 0
    pm = pfs.PersistManager(str(tmp_path))
    db.set_retriever(BlockRetriever(pm, device=CPU))
    assert db.evict_flushed() == 0  # sealed, not yet flushed
    assert db.flush(pm) == 1 and db.evict_flushed() == 1
    assert db.read(NS, b"a", 0, now["t"])[1].tolist() == [1.0]


# ---------------------------------------------------------------------------
# the mediator
# ---------------------------------------------------------------------------


def _mediator_run(pkg, root, index):
    now = {"t": T0 + 5 * xtime.MINUTE}
    log = pkg.cl.CommitLog(os.path.join(root, "cl"),
                           strategy=pkg.cl.Strategy.WRITE_WAIT)
    db = pkg.Database(pkg.ShardSet(4), commitlog=log, clock=lambda: now["t"])
    db.ensure_namespace(NS, pkg.NamespaceOptions(
        index_enabled=index, retention_ns=6 * xtime.HOUR))
    pm = pkg.fs.PersistManager(os.path.join(root, "data"))
    med = pkg.Mediator(db, pm)
    rng = np.random.default_rng(31)
    ids = [b"med-%03d" % i for i in range(24)]
    tags = [{b"__name__": b"med", b"i": b"%d" % i} for i in range(24)]
    stats = []
    for step in range(14):
        now["t"] = T0 + 5 * xtime.MINUTE + step * 40 * xtime.MINUTE
        db.write_batch(NS, ids, np.full(24, now["t"] - xtime.MINUTE, np.int64),
                       rng.standard_normal(24), tags=tags)
        stats.append(med.run_once(now["t"]))
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(os.path.join(root, "data"))
                   for f in fs)
    reads = [_bits(db.read(NS, sid, 0, now["t"] + 1)) for sid in ids]
    return stats, files, reads


@pytest.mark.parametrize("index", [False, True])
def test_mediator_run_once_counts_equal_the_reference(tmp_path, index):
    """14 mediator cycles 40 minutes apart over 7 blocks: tick, flush
    (index segments too), snapshot and cleanup count the same in both
    packages, leave the same files on disk, and serve the same points."""
    port = _mediator_run(PORT, str(tmp_path / "port"), index)
    ref = _mediator_run(REF, str(tmp_path / "ref"), index)
    assert port == ref
    stats = port[0]
    assert sum(s["flushed"] for s in stats) > 0
    assert sum(s["snapshotted"] for s in stats) > 0
    assert sum(s["cleaned"] for s in stats) > 0
    assert sum(s["expired"] for s in stats) > 0


def test_mediator_start_stop_cycle(tmp_path):
    now = {"t": T0 + 5 * xtime.MINUTE}
    db = PORT.Database(ShardSet(2), clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    db.write(NS, b"a", now["t"], 1.0)
    med = Mediator(db, pfs.PersistManager(str(tmp_path)),
                   MediatorOptions(tick_interval_ns=10_000_000))
    med.start()
    try:
        for _ in range(500):
            if med.last_stats:
                break
            time.sleep(0.01)
    finally:
        med.stop()
    assert med.last_stats.get("snapshotted", 0) >= 1
    assert not med._thread.is_alive()


def test_snapshot_keeps_no_device_tensors(tmp_path, monkeypatch):
    """A snapshot's encode keeps nothing for retain_encoded: the block is
    written and dropped, its device tensors released at once."""
    seen = []
    real = pblock.encode_block

    def spy(*a, **k):
        blk = real(*a, **k)
        blk._encoded_dev = (torch.zeros(4), torch.zeros(1))
        seen.append(blk)
        return blk

    from m3_tpu_torch.storage import mediator as med_mod

    monkeypatch.setattr(med_mod, "encode_block", spy)
    now = {"t": T0 + 5 * xtime.MINUTE}
    db = PORT.Database(ShardSet(2), clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    db.write_batch(NS, [b"a", b"b", b"c"], np.full(3, now["t"], np.int64),
                   np.arange(3.0))
    assert Mediator(db, pfs.PersistManager(str(tmp_path))).snapshot(
        now["t"]) == len(seen) > 0
    assert all("_encoded_dev" not in blk.__dict__ for blk in seen)


# ---------------------------------------------------------------------------
# the quarantine-only scrubber
# ---------------------------------------------------------------------------


def _scrub_db(pkg, root):
    now = {"t": T0 + 5 * xtime.MINUTE}
    db = pkg.Database(pkg.ShardSet(2), clock=lambda: now["t"])
    db.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
    pm = pkg.fs.PersistManager(os.path.join(root, "data"))
    db.set_retriever(pkg.BlockRetriever(pm))
    ids = [b"scrub-%d" % i for i in range(8)]
    rng = np.random.default_rng(9)
    db.write_batch(NS, ids, np.full(8, T0 + 4 * xtime.MINUTE, np.int64),
                   rng.standard_normal(8))
    now["t"] = T0 + 3 * BLOCK
    db.tick()
    assert db.flush(pm) >= 1
    return db, pm, now, ids


def _flip_data_byte(path, offset=3):
    with open(os.path.join(path, pfs.DATA_FILE), "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x10]))


def _stats(st):
    return {k: getattr(st, k) for k in (
        "filesets_scanned", "bytes_verified", "corrupt_found", "quarantined",
        "repair_attempts", "blocks_repaired", "unquarantined")}


def test_scrub_detects_quarantines_and_reschedules_like_the_reference(
        tmp_path):
    out = {}
    for pkg in PKGS:
        db, pm, now, ids = _scrub_db(pkg, str(tmp_path / pkg.name))
        path = dict(pm.list_filesets(NS, 1))[T0]
        _flip_data_byte(path)
        st = pkg.DatabaseScrubber(db, pm, opts=pkg.ScrubOptions(seed=1)).run(
            now_ns=now["t"])[NS]
        assert st.corrupt_found == 1 and st.quarantined == 1
        assert st.unquarantined == 1 and pm.list_quarantined(NS, 1) == []
        assert db.flush(pm) >= 1
        pkg.fs.FilesetReader(dict(pm.list_filesets(NS, 1))[T0],
                             **({"device": CPU} if pkg is PORT else {})
                             ).verify_rows()
        out[pkg.name] = (_stats(st),
                         [_bits(db.read(NS, sid, 0, now["t"])) for sid in ids])
    assert out["port"] == out["ref"]


def test_scrub_clean_sweep_and_warm_head(tmp_path):
    out = []
    for pkg in PKGS:
        db, pm, now, _ = _scrub_db(pkg, str(tmp_path / pkg.name))
        clean = pkg.DatabaseScrubber(db, pm, opts=pkg.ScrubOptions(seed=1)
                                     ).run(now_ns=now["t"])[NS]
        assert clean.corrupt_found == 0 and clean.bytes_verified > 0
        now["t"] = T0 + BLOCK + 11 * xtime.MINUTE
        warm = pkg.DatabaseScrubber(db, pm, opts=pkg.ScrubOptions(seed=1)
                                    ).run(now_ns=now["t"])[NS]
        assert warm.filesets_scanned == 0
        out.append((_stats(clean), _stats(warm)))
    assert out[0] == out[1]


def test_scrub_without_a_resident_block_quarantines_only(tmp_path):
    """Evicted block + corrupt fileset: quarantined, nothing to repair
    from, the read serves no wrong points (typed quarantine, empty)."""
    out = []
    for pkg in PKGS:
        db, pm, now, ids = _scrub_db(pkg, str(tmp_path / pkg.name))
        assert db.evict_flushed() >= 1
        path = dict(pm.list_filesets(NS, 1))[T0]
        _flip_data_byte(path)
        st = pkg.DatabaseScrubber(db, pm, opts=pkg.ScrubOptions(seed=1)).run(
            now_ns=now["t"])[NS]
        assert st.quarantined == 1 and st.unquarantined == 0
        assert [b for b, _p in pm.list_quarantined(NS, 1)] == [T0]
        reads = [_bits(db.read(NS, sid, 0, now["t"])) for sid in ids]
        out.append((_stats(st), reads))
    assert out[0] == out[1]


def test_scrub_quarantined_past_retention_cleared_and_jitter(tmp_path):
    db, pm, now, _ = _scrub_db(PORT, str(tmp_path))
    assert pfs.quarantine_fileset(dict(pm.list_filesets(NS, 1))[T0],
                                  reason="test") is not None
    now["t"] = T0 + BLOCK + db.namespace(NS).opts.retention_ns + xtime.MINUTE
    st = DatabaseScrubber(db, pm, opts=ScrubOptions(seed=1)).run(
        now_ns=now["t"])[NS]
    assert st.unquarantined == 1 and st.repair_attempts == 0
    a = DatabaseScrubber(db, None, opts=ScrubOptions(seed=5))
    b = JDatabaseScrubber(JDatabase(JShardSet(1), clock=lambda: T0), None,
                          opts=JScrubOptions(seed=5))
    assert [a.next_delay_s() for _ in range(4)] == \
        [b.next_delay_s() for _ in range(4)]
    a.consecutive_failures = b.consecutive_failures = 3
    assert a.next_delay_s() == b.next_delay_s()


def test_scrub_start_stop_and_repairer_refused(tmp_path):
    db, pm, _now, _ = _scrub_db(PORT, str(tmp_path))
    sc = DatabaseScrubber(db, pm, opts=ScrubOptions(
        interval_s=0.01, jitter_frac=0.0, max_bytes_per_s=0)).start()
    try:
        for _ in range(500):
            if sc.runs:
                break
            time.sleep(0.01)
    finally:
        sc.stop()
    assert sc.runs >= 1 and sc._thread is None
    with pytest.raises(RepairUnsupported, match="A13.2"):
        DatabaseScrubber(db, pm, repairer=object())


# ---------------------------------------------------------------------------
# the disk-fault plane (tests/test_diskfault.py)
# ---------------------------------------------------------------------------


def test_faultfs_decisions_equal_the_reference(tmp_path):
    plan_kw = dict(seed=3, read_flip=0.3, read_short=0.2, write_eio=0.2,
                   write_enospc=0.1, fsync_eio=0.1, fsync_lie=0.2)
    p = os.path.join(str(tmp_path), "dir", "blob.bin")
    os.makedirs(os.path.dirname(p))
    with open(p, "wb") as f:
        f.write(bytes(range(64)))
    logs = []
    for pkg in PKGS:
        io = pkg.faultfs.FaultIO(pkg.faultfs.DiskFaultPlan(**plan_kw))
        reads = []
        for _ in range(12):
            with io.open(p, "rb") as f:
                reads.append(f.read())
        logs.append((io.decisions, reads, io.faults_injected))
        key = pkg.faultfs._path_key(p)
        assert io.decisions[("read", key)] == \
            io.plan.schedule("read", key, 12)
    assert logs[0] == logs[1]
    for op in ("read", "write", "fsync", "replace"):
        assert faultfs.DiskFaultPlan(**plan_kw).schedule(op, "d/a", 40) == \
            jfaultfs.DiskFaultPlan(**plan_kw).schedule(op, "d/a", 40)


def test_fsync_lie_power_cut_and_write_faults(tmp_path):
    p = os.path.join(str(tmp_path), "d", "wal.bin")
    os.makedirs(os.path.dirname(p))
    io = faultfs.FaultIO(faultfs.DiskFaultPlan(seed=2, fsync_lie=1.0))
    f = io.open(p, "wb")
    f.write(b"acked-but-never-synced")
    io.fsync(f)
    f.close()
    assert io.fsync_lies == 1 and io.power_cut() == 1
    assert os.path.getsize(p) == 0
    for kind, code, typ in (("write_eio", errno.EIO, diskio.DiskWriteError),
                            ("write_enospc", errno.ENOSPC,
                             diskio.DiskFullError)):
        io = faultfs.FaultIO(faultfs.DiskFaultPlan(seed=2, **{kind: 1.0}))
        with pytest.raises(OSError) as ei:
            with io.open(p, "wb") as f:
                f.write(b"data")
        assert ei.value.errno == code and os.path.getsize(p) == 0
        assert isinstance(diskio.classify_write_error(ei.value, p), typ)


def _wal_fault(pkg, root, plan_kw, batch):
    pkg.faultfs.install(pkg.faultfs.DiskFaultPlan(**plan_kw))
    try:
        log = pkg.cl.CommitLog(os.path.join(root, "cl"),
                               strategy=pkg.cl.Strategy.WRITE_WAIT)
        db = pkg.Database(pkg.ShardSet(2), commitlog=log,
                          clock=lambda: T0 + 1)
        db.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
        outcomes = []
        for i in range(6):
            try:
                if batch:
                    db.write_batch(NS, [b"wal-%d" % i, b"wal-x"],
                                   np.full(2, T0, np.int64),
                                   np.array([float(i), 0.5]))
                else:
                    db.write(NS, b"wal-%d" % i, T0, float(i))
                outcomes.append("ok")
            except (pkg.diskio.DiskWriteError, pkg.Backpressure) as e:
                outcomes.append(type(e).__name__)
        health = (db.disk_health.failures, db.disk_health.read_only())
    finally:
        pkg.faultfs.uninstall()
    log.close()
    return outcomes, health, list(pkg.cl.replay(os.path.join(root, "cl")))


@pytest.mark.parametrize("plan_kw", [dict(seed=9, write_eio=1.0),
                                     dict(seed=9, write_enospc=1.0),
                                     dict(seed=4, write_eio=0.5),
                                     dict(seed=5, fsync_eio=0.5)],
                         ids=["eio", "enospc", "eio-half", "fsync-half"])
@pytest.mark.parametrize("batch", [False, True], ids=["write", "batch"])
def test_wal_faults_are_typed_ack_failures_like_the_reference(
        tmp_path, plan_kw, batch):
    """EIO and ENOSPC on the WAL append: a typed DiskWriteError (or
    DiskFullError) per failed ack, health degrading to the read-only
    posture (NORMAL writes then shed with Backpressure), and the WAL
    holding exactly the acked entries — all as the reference does."""
    port = _wal_fault(PORT, str(tmp_path / "port"), plan_kw, batch)
    ref = _wal_fault(REF, str(tmp_path / "ref"), plan_kw, batch)
    assert port == ref
    assert any(o != "ok" for o in port[0])


def _flush_fault(pkg, root, plan_kw):
    now = {"t": T0 + xtime.MINUTE}
    db = pkg.Database(pkg.ShardSet(8), clock=lambda: now["t"])
    db.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
    pm = pkg.fs.PersistManager(os.path.join(root, "data"))
    ids = [b"deg-%d" % i for i in range(32)]
    rng = np.random.default_rng(2)
    db.write_batch(NS, ids, np.full(32, T0 + 30 * S, np.int64),
                   rng.standard_normal(32))
    now["t"] = T0 + BLOCK + 11 * xtime.MINUTE
    db.tick()
    pkg.faultfs.install(pkg.faultfs.DiskFaultPlan(**plan_kw))
    try:
        flushed = db.flush(pm)
        failed = sorted(
            (s, b) for s, sh in db.namespace(NS).shards.items()
            for b, st in sh.flush_states.items() if st.value == "failed")
        read_only = db.disk_health.read_only()
        shed = None
        try:
            db.write(NS, b"deg-0", now["t"], 1.0)
        except pkg.Backpressure:
            shed = "Backpressure"
        db.write(NS, b"deg-0", now["t"], 2.0,
                 priority=pkg.Priority.CRITICAL)
        mid_read = _bits(db.read(NS, b"deg-0", 0, now["t"] + 1))
    finally:
        pkg.faultfs.uninstall()
    recovered = db.flush(pm)
    after = (db.disk_health.read_only(), len(pm.list_filesets(NS, 0)) +
             sum(len(pm.list_filesets(NS, s)) for s in range(1, 8)))
    db.write(NS, b"deg-0", now["t"], 3.0)
    return (flushed, failed, read_only, shed, mid_read, recovered, after,
            db.disk_health.failures)


@pytest.mark.parametrize("plan_kw", [dict(seed=9, write_enospc=1.0),
                                     dict(seed=9, write_eio=1.0),
                                     dict(seed=4, torn_replace=1.0),
                                     dict(seed=6, write_eio=0.05)],
                         ids=["enospc", "eio", "torn", "eio-sparse"])
def test_fileset_write_faults_fail_the_block_like_the_reference(
        tmp_path, plan_kw):
    """ENOSPC, EIO and torn renames on the fileset writes: the block is
    marked FAILED and stays on the schedule, health degrades, NORMAL
    writes shed with Backpressure while CRITICAL ones and reads flow, and
    the next clean flush recovers — the same outcomes as the
    reference's for the same injected faults."""
    port = _flush_fault(PORT, str(tmp_path / "port"), plan_kw)
    ref = _flush_fault(REF, str(tmp_path / "ref"), plan_kw)
    assert port == ref


def test_retriever_quarantines_and_serves_none(tmp_path):
    db, pm, retr, ids, now = _cold_db(PORT, str(tmp_path), n_series=8,
                                      shards=1)
    now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    db.flush(pm)
    db.evict_flushed()
    bstart = COLD_T0 - COLD_T0 % BLOCK
    _flip_data_byte(dict(pm.list_filesets(NS, 0))[bstart])
    assert retr.retrieve(NS, 0, bstart, ids[0]) is None
    assert [b for b, _p in pm.list_quarantined(NS, 0)] == [bstart]
    assert pm.list_filesets(NS, 0) == [] and retr.block_starts(NS, 0) == {}
    t, _v = db.read(NS, ids[1], COLD_T0, COLD_T0 + xtime.HOUR)
    assert len(t) == 0  # not served from the rotten fileset


def test_memmap_fault_never_reads_clean(tmp_path):
    root = str(tmp_path)
    db, pm, _retr, _ids, now = _cold_db(PORT, root, n_series=8, shards=1)
    now["t"] = COLD_T0 - COLD_T0 % BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    db.flush(pm)
    path = pm.list_filesets(NS, 0)[0][1]
    clean = np.asarray(pfs.FilesetReader(path, device=CPU)._words).copy()
    faultfs.install(faultfs.DiskFaultPlan(seed=6, read_flip=1.0))
    with pytest.raises((diskio.CorruptionError, FileNotFoundError)):
        r = pfs.FilesetReader(path, verify=False, device=CPU)
        assert not np.array_equal(np.asarray(r._words), clean)
        r.verify_rows()
    faultfs.uninstall()
    assert np.array_equal(
        np.asarray(pfs.FilesetReader(path, device=CPU)._words), clean)
