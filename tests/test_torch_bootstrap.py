"""Crash bootstrap of the port (m3_tpu_torch.storage.bootstrap) against the
reference's (m3_tpu.storage.bootstrap), on the CPU.

BASELINE config #12's data dir (bench.py:bench_bootstrap_replay) at a
small size: 2,000 series in 4 shards, a flushed 2 h block, 3 WAL waves
into the next block and one snapshot of it, the process abandoned
without close() (the disk as a SIGKILL leaves it). The dir is built by
each package in turn — the two builds are byte-identical — and each
build is bootstrapped by both packages. Recovered registries (creation
order included: it decides the sealed rows' order), every block's words,
nbits and npoints, reads over both blocks, bootstrap notes and replayed
buffer columns must be equal, bit for bit. The columnar paths are also
held to the retained per-entry oracles (`replay_wal_ref`,
`load_snapshots_ref`), as tests/test_durability.py:521-800 holds the
reference's. The kill-restart drills are not used: they fail on the
reference itself (ROADMAP C3)."""

import os
import types

import numpy as np
import pytest

from m3_tpu.index.query import TermQuery as JTermQuery
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.persist import commitlog as jcl
from m3_tpu.persist import fs as jfs
from m3_tpu.storage import block_cache as jcache
from m3_tpu.storage import bootstrap as jbs
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.mediator import Mediator as JMediator
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.utils.hbm import HBMBudget as JHBMBudget
from m3_tpu_torch.index.query import TermQuery
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist import commitlog as cl
from m3_tpu_torch.persist import fs as pfs
from m3_tpu_torch.storage import block_cache as pcache
from m3_tpu_torch.storage import bootstrap as bs
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.mediator import Mediator
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hbm import HBMBudget
from m3_tpu_torch.utils.instrument import ROOT

NS = b"bench"
BLOCK = 2 * xtime.HOUR
MINUTE = xtime.MINUTE
T0 = (1_700_000_000 * xtime.SECOND // BLOCK) * BLOCK
N_SERIES, N_SHARDS, WAVES, SEED = 2_000, 4, 3, 83

PORT = types.SimpleNamespace(
    name="port", cl=cl, fs=pfs, bs=bs, ShardSet=ShardSet, Mediator=Mediator,
    NamespaceOptions=NamespaceOptions, TermQuery=TermQuery,
    Database=lambda *a, **k: Database(*a, device="cpu", **k))
REF = types.SimpleNamespace(
    name="ref", cl=jcl, fs=jfs, bs=jbs, ShardSet=JShardSet,
    Mediator=JMediator, NamespaceOptions=JNamespaceOptions,
    TermQuery=JTermQuery, Database=JDatabase)
PKGS = (PORT, REF)


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Fresh, isolated process block caches for both packages."""
    monkeypatch.setattr(pcache, "_CACHE", pcache.DeviceBlockCache(
        budget=HBMBudget(64 << 20), admit_after=2))
    monkeypatch.setattr(jcache, "_CACHE", jcache.DeviceBlockCache(
        budget=JHBMBudget(64 << 20), admit_after=2))


def _build(pkg, root, tail=False):
    """Config #12's dir at N_SERIES (bench.py:1477-1515); with `tail`,
    also a WAL tail past the snapshot that overwrites 5 points of the
    last (snapshotted) wave. Returns the abandoned (never closed)
    database, the ids and the clock."""
    now = {"t": T0 + MINUTE}
    log = pkg.cl.CommitLog(os.path.join(root, "commitlog"))
    db = pkg.Database(pkg.ShardSet(N_SHARDS), commitlog=log,
                      clock=lambda: now["t"])
    db.ensure_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
    pm = pkg.fs.PersistManager(os.path.join(root, "data"))
    ids = [b"boot-%07d" % i for i in range(N_SERIES)]
    rng = np.random.default_rng(SEED)
    db.write_batch(NS, ids, np.full(N_SERIES, T0, np.int64),
                   rng.standard_normal(N_SERIES))
    now["t"] = T0 + BLOCK + 11 * MINUTE
    db.tick()
    assert db.flush(pm) >= N_SHARDS
    bs1 = T0 + BLOCK
    step = BLOCK // (WAVES + 2)
    for wv in range(WAVES):
        ts_w = bs1 + wv * step + 23 * MINUTE
        now["t"] = ts_w
        db.write_batch(NS, ids, np.full(N_SERIES, ts_w, np.int64),
                       rng.standard_normal(N_SERIES))
        log.flush()
    pkg.Mediator(db, pm).snapshot(now["t"])
    if tail:
        now["t"] += MINUTE
        half = N_SERIES // 2
        db.write_batch(NS, ids[:half], np.full(half, now["t"], np.int64),
                       rng.standard_normal(half))
        db.write_batch(NS, ids[:5], np.full(5, ts_w, np.int64),
                       np.full(5, 424242.0))
        log.flush()
    return db, ids, now


def _recover(pkg, root, now, path="chain",
             chain=("filesystem", "commitlog")):
    """path 'chain': the real BootstrapProcess; 'new': the filesystem
    bootstrapper then the batched snapshot tiles and WAL replay; 'ref':
    the filesystem bootstrapper then the per-entry oracles."""
    db = pkg.Database(pkg.ShardSet(N_SHARDS), clock=lambda: now["t"])
    db.ensure_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
    ctx = pkg.bs.BootstrapContext(
        persist=pkg.fs.PersistManager(os.path.join(root, "data")),
        commitlog_dir=os.path.join(root, "commitlog"),
        shard_lookup=db.shard_set.lookup)
    proc = pkg.bs.BootstrapProcess(chain=chain, ctx=ctx)
    if path == "chain":
        return db, proc.run(db, now_ns=now["t"])
    ns = db.namespace(NS)
    req = proc.target_ranges(ns, now["t"])
    rem = req.subtract(proc.bootstrappers[0].bootstrap(ns, req, ctx))
    if path == "new":
        assert pkg.bs.replay_wal(ns, rem, ctx, pkg.bs.load_snapshots(
            ns, rem, ctx))
    else:
        pkg.bs.load_snapshots_ref(ns, rem, ctx)
        assert pkg.bs.replay_wal_ref(ns, rem, ctx)
    db.mark_bootstrapped()
    return db, None


def _tree(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _same_reads(a, b, ids, end):
    for sid in ids:
        ta, va = a.read(NS, sid, 0, end)
        tb, vb = b.read(NS, sid, 0, end)
        assert ta.tobytes() == tb.tobytes(), sid
        assert np.asarray(va, np.float64).tobytes() == \
            np.asarray(vb, np.float64).tobytes(), sid


def _same_state(a, b):
    """Registries (ids in creation order), sealed blocks field by field,
    flush states and buffer columns of two recovered databases."""
    na, nb = a.namespace(NS), b.namespace(NS)
    assert sorted(na.shards) == sorted(nb.shards)
    for s in na.shards:
        sa, sb = na.shards[s], nb.shards[s]
        assert sa.registry.all_ids() == sb.registry.all_ids()
        assert sorted(sa.blocks) == sorted(sb.blocks)
        for bstart in sa.blocks:
            x, y = sa.blocks[bstart], sb.blocks[bstart]
            assert np.asarray(x.words).tobytes() == \
                np.asarray(y.words).tobytes()
            for f in ("nbits", "npoints", "series_indices"):
                assert np.array_equal(getattr(x, f), np.asarray(getattr(y, f)))
            assert (x.window, int(x.time_unit)) == (y.window, int(y.time_unit))
        assert {k: v.value for k, v in sa.flush_states.items()} == \
            {k: v.value for k, v in sb.flush_states.items()}
        assert sorted(sa.buffer.buckets) == sorted(sb.buffer.buckets)
        for bstart, bucket in sa.buffer.buckets.items():
            for x, y in zip(bucket.cols.view(),
                            sb.buffer.buckets[bstart].cols.view()):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def config12(tmp_path_factory):
    """Config #12's dir built by each package, and each build's pre-kill
    database."""
    out = {}
    for pkg in PKGS:
        root = str(tmp_path_factory.mktemp(f"c12_{pkg.name}"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pcache, "_CACHE", pcache.DeviceBlockCache(
                budget=HBMBudget(64 << 20)))
            mp.setattr(jcache, "_CACHE", jcache.DeviceBlockCache(
                budget=JHBMBudget(64 << 20)))
            db, ids, now = _build(pkg, root)
        out[pkg.name] = (root, db, ids, now)
    return out


def test_config12_builds_are_byte_identical(config12):
    port, ref = _tree(config12["port"][0]), _tree(config12["ref"][0])
    assert sorted(port) == sorted(ref)
    assert sum(k.startswith("commitlog") for k in port) == 2
    assert sum("snapshot-1-" in k for k in port) == 7 * N_SHARDS
    for name in port:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("built_by", ["port", "ref"])
def test_config12_recovery_equal_across_packages(config12, built_by):
    root, pre_kill, ids, now = config12[built_by]
    got, res = _recover(PORT, root, now)
    want, jres = _recover(REF, root, now)
    assert sum(s.num_series() for s in got.namespace(NS).shards.values()) \
        == N_SERIES
    assert res[NS].notes == jres[NS].notes == []
    assert res[NS].claimed["filesystem"].m == jres[NS].claimed["filesystem"].m
    assert res[NS].unfulfilled.is_empty() and got.bootstrapped
    _same_state(got, want)
    end = now["t"] + BLOCK
    _same_reads(got, want, ids, end)
    _same_reads(got, pre_kill, ids, end)
    # Seal the recovered warm block in both (the snapshot tile merges
    # with whatever the replay left in the buffer) and compare again.
    now2 = {"t": T0 + 2 * BLOCK + 11 * MINUTE}
    got.clock = want.clock = lambda: now2["t"]
    assert got.tick() == want.tick()
    _same_state(got, want)
    _same_reads(got, want, ids, end)


def test_config12_batched_replay_equals_the_oracles(config12):
    root, _db, ids, now = config12["port"]
    d = os.path.join(root, "commitlog")
    ref = list(cl.replay_ref(d))
    assert len(ref) == N_SERIES * (1 + WAVES)
    assert [(ns, sid, int(t), float(v)) for b in cl.replay_batches(d)
            for ns, sid, t, v in zip(b.namespaces, b.ids, b.t_ns, b.values)
            ] == ref == list(jcl.replay_ref(d))
    new, _ = _recover(PORT, root, now, path="new")
    old, _ = _recover(PORT, root, now, path="ref")
    jnew, _ = _recover(REF, root, now, path="new")
    for s in range(N_SHARDS):
        assert new.namespace(NS).shards[s].registry.all_ids() == \
            old.namespace(NS).shards[s].registry.all_ids()
    _same_state(new, jnew)
    _same_reads(new, old, ids, now["t"] + BLOCK)


@pytest.mark.parametrize("path", ["new", "ref", "chain"])
def test_snapshot_position_skip_equal_to_reference(tmp_path, path):
    """A WAL tail past the snapshot (an overwrite of 5 snapshotted points
    among it): chunks at or before the snapshot's position skip its
    block, the tail replays on top, and the port's recovered state equals
    the reference's on each path."""
    root = str(tmp_path)
    pre_kill, ids, now = _build(PORT, root, tail=True)
    got, _ = _recover(PORT, root, now, path=path)
    want, _ = _recover(REF, root, now, path=path)
    _same_state(got, want)
    end = now["t"] + BLOCK
    _same_reads(got, want, ids, end)
    _same_reads(got, pre_kill, ids, end)
    t, v = got.read(NS, ids[0], T0 + BLOCK, end)
    assert 424242.0 in v.tolist()
    buffered = sum(len(b.cols.view()[0]) for sh in got.namespace(NS)
                   .shards.values() for b in sh.buffer.buckets.values())
    if path != "ref":
        # Only the tail replays: the waves sit inside the snapshot tile.
        assert buffered == N_SERIES // 2 + 5
    else:
        # The oracles write the snapshot's rows into the buffer and replay
        # every chunk, the waves a second time.
        assert buffered == 2 * N_SERIES * WAVES + N_SERIES // 2 + 5


def test_wal_only_buffer_bit_identity(tmp_path):
    """Pure-WAL recovery: the port's batched replay leaves buffer columns
    and registries bit-identical to its per-entry oracle and to the
    reference's batched replay."""
    root = str(tmp_path)
    now = {"t": T0 + MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = PORT.Database(ShardSet(4), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    rng = np.random.default_rng(5)
    ids = [b"wal-%03d" % i for i in range(40)]
    for w in range(4):
        tsw = T0 + w * MINUTE
        now["t"] = tsw + MINUTE
        db.write_batch(NS, ids, np.full(len(ids), tsw, np.int64),
                       rng.standard_normal(len(ids)))
        log.flush()
    dbs = {}
    for key, pkg, fn in (("new", PORT, bs.replay_wal),
                         ("ref", PORT, bs.replay_wal_ref),
                         ("jnew", REF, jbs.replay_wal)):
        db2 = pkg.Database(pkg.ShardSet(4), clock=lambda: now["t"])
        db2.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
        ns = db2.namespace(NS)
        ctx = pkg.bs.BootstrapContext(commitlog_dir=os.path.join(root, "cl"),
                                      shard_lookup=db2.shard_set.lookup)
        req = pkg.bs.BootstrapProcess(ctx=ctx).target_ranges(ns, now["t"])
        assert fn(ns, req, ctx) is True
        dbs[key] = db2
    _same_state(dbs["new"], dbs["ref"])
    _same_state(dbs["new"], dbs["jnew"])


@pytest.mark.parametrize("lookup", ["bound", "murmur"])
def test_replay_routes_like_the_reference(tmp_path, lookup):
    """The replay's routing on the namespace's device: through a bound
    ShardSet.lookup's lookup_batch, or (no lookup, the full contiguous
    shard set) murmur3 % N over hash_batch — the same shards as the
    reference's."""
    root = str(tmp_path)
    now = {"t": T0 + MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = PORT.Database(ShardSet(8), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    ids = [b"route-%d" % i for i in range(300)]
    db.write_batch(NS, ids, np.full(300, T0, np.int64), np.arange(300.0))
    log.flush()
    out = []
    for pkg in PKGS:
        db2 = pkg.Database(pkg.ShardSet(8), clock=lambda: now["t"])
        db2.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
        ctx = pkg.bs.BootstrapContext(
            commitlog_dir=os.path.join(root, "cl"),
            shard_lookup=db2.shard_set.lookup if lookup == "bound" else None)
        pkg.bs.BootstrapProcess(chain=("commitlog",), ctx=ctx).run(
            db2, now_ns=now["t"])
        out.append(db2)
    _same_state(*out)
    for s, shard in out[0].namespace(NS).shards.items():
        assert all(ShardSet(8).lookup(sid) == s
                   for sid in shard.registry.all_ids())


def test_recovery_rebuilds_reverse_index_from_wal_tags(tmp_path):
    """Tagged series come back queryable: the WAL's meta entries carry
    encoded tags and the replay re-indexes series whose data the
    snapshot position skips. Both packages answer the same index query
    with the same ids and serve the same points."""
    root = str(tmp_path)
    now = {"t": T0 + 2 * xtime.HOUR}
    log = cl.CommitLog(os.path.join(root, "cl"), strategy=cl.Strategy.WRITE_WAIT)
    db = PORT.Database(ShardSet(4), commitlog=log, clock=lambda: now["t"])
    db.ensure_namespace(NS, NamespaceOptions())
    pm = pfs.PersistManager(os.path.join(root, "data"))
    med = Mediator(db, pm)
    base = now["t"]
    for i in range(1, 9):
        sid = b"idx_cpu;host=h%d" % (i % 3)
        db.write(NS, sid, base - 60 * xtime.SECOND + i * xtime.SECOND,
                 100.0 + i,
                 tags={b"__name__": b"idx_cpu", b"host": b"h%d" % (i % 3)})
        med.run_once(now["t"])
    got = {}
    for pkg in PKGS:
        db2 = pkg.Database(pkg.ShardSet(4), clock=lambda: now["t"])
        db2.ensure_namespace(NS, pkg.NamespaceOptions())
        pkg.bs.BootstrapProcess(
            chain=("filesystem", "commitlog", "uninitialized_topology"),
            ctx=pkg.bs.BootstrapContext(
                persist=pkg.fs.PersistManager(os.path.join(root, "data")),
                commitlog_dir=os.path.join(root, "cl"),
                shard_lookup=db2.shard_set.lookup)).run(db2, now_ns=now["t"])
        ids = sorted(db2.query_ids(NS, pkg.TermQuery(b"__name__", b"idx_cpu")))
        got[pkg.name] = (db2, ids)
    want_ids = sorted(db.query_ids(NS, TermQuery(b"__name__", b"idx_cpu")))
    assert got["port"][1] == got["ref"][1] == want_ids and len(want_ids) == 3
    _same_reads(got["port"][0], got["ref"][0], want_ids, base + 1)
    _same_reads(got["port"][0], db, want_ids, base + 1)
    db2 = got["port"][0]
    for sid in want_ids:
        shard = db2.namespace(NS).shards[db2.shard_set.lookup(sid)]
        assert shard.registry.tags_of(shard.registry.get(sid))[b"__name__"] \
            == b"idx_cpu"


def test_same_chunk_untagged_then_tagged_series_indexed(tmp_path):
    root = str(tmp_path)
    now = {"t": T0 + 30 * MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = PORT.Database(ShardSet(2), commitlog=log, clock=lambda: now["t"])
    db.ensure_namespace(NS, NamespaceOptions())
    tg = {b"__name__": b"mix", b"host": b"a"}
    db.write_batch(NS, [b"mix;host=a", b"mix;host=a"],
                   np.full(2, now["t"], np.int64), np.array([1.0, 2.0]),
                   tags=[None, tg])
    log.flush()
    for pkg in PKGS:
        db2 = pkg.Database(pkg.ShardSet(2), clock=lambda: now["t"])
        db2.ensure_namespace(NS, pkg.NamespaceOptions())
        pkg.bs.BootstrapProcess(
            chain=("commitlog", "uninitialized_topology"),
            ctx=pkg.bs.BootstrapContext(
                commitlog_dir=os.path.join(root, "cl"),
                shard_lookup=db2.shard_set.lookup)).run(db2, now_ns=now["t"])
        assert sorted(db2.query_ids(NS, pkg.TermQuery(b"__name__", b"mix"))) \
            == [b"mix;host=a"]


def test_warm_snapshot_tile_not_flushed_before_seal(tmp_path, rng):
    """A snapshot tile recovered for a still-writable window must not
    flush (the next restart would claim its whole range from a tile-only
    fileset and lose the WAL tail); once cold, the merged block flushes."""
    root = str(tmp_path)
    now = {"t": T0 + 30 * MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"), strategy=cl.Strategy.WRITE_WAIT)
    db = PORT.Database(ShardSet(2), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    pm = pfs.PersistManager(os.path.join(root, "data"))
    ids = [b"warm-%02d" % i for i in range(12)]
    db.write_batch(NS, ids, np.full(12, now["t"], np.int64),
                   rng.standard_normal(12))
    Mediator(db, pm).snapshot(now["t"])
    now["t"] += MINUTE
    db.write_batch(NS, ids[:6], np.full(6, now["t"], np.int64),
                   rng.standard_normal(6))

    def restart():
        d = PORT.Database(ShardSet(2), clock=lambda: now["t"])
        d.create_namespace(NS, NamespaceOptions(index_enabled=False))
        bs.BootstrapProcess(
            chain=("filesystem", "commitlog", "uninitialized_topology"),
            ctx=bs.BootstrapContext(
                persist=pm, commitlog_dir=os.path.join(root, "cl"),
                shard_lookup=d.shard_set.lookup)).run(d, now_ns=now["t"])
        return d

    db2 = restart()
    med2 = Mediator(db2, pm)
    med2.run_once(now["t"])
    assert pm.list_filesets(NS, 0) == pm.list_filesets(NS, 1) == []
    db3 = restart()
    _same_reads(db3, db, ids, now["t"] + xtime.HOUR)
    now["t"] = T0 + BLOCK + 11 * MINUTE
    med2.run_once(now["t"])
    assert any(pm.list_filesets(NS, sh) for sh in (0, 1))


def test_async_insert_queue_never_loses_to_snapshot_position(tmp_path):
    root = str(tmp_path)
    now = {"t": T0 + MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = PORT.Database(ShardSet(2), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(
        index_enabled=False, write_new_series_async=True))
    pm = pfs.PersistManager(os.path.join(root, "data"))
    db.write_batch(NS, [b"async-1", b"async-2"], np.full(2, T0, np.int64),
                   np.array([7.0, 8.0]))
    assert any(sh.insert_queue.pending()
               for sh in db.namespace(NS).shards.values())
    Mediator(db, pm).snapshot(now["t"])
    db2 = PORT.Database(ShardSet(2), clock=lambda: now["t"])
    db2.create_namespace(NS, NamespaceOptions(index_enabled=False))
    bs.BootstrapProcess(chain=("commitlog",), ctx=bs.BootstrapContext(
        persist=pm, commitlog_dir=os.path.join(root, "cl"),
        shard_lookup=db2.shard_set.lookup)).run(db2, now_ns=now["t"])
    for sid, want in ((b"async-1", 7.0), (b"async-2", 8.0)):
        assert db2.read(NS, sid, 0, now["t"] + 1)[1].tolist() == [want]


def test_skipped_replay_is_surfaced_as_the_reference_does(tmp_path):
    root = str(tmp_path)
    now = {"t": T0 + MINUTE}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = PORT.Database(ShardSet(4), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    db.write_batch(NS, [b"skip-1"], np.array([T0], np.int64), np.array([1.0]))
    log.close()
    notes = []
    for pkg in PKGS:
        db2 = pkg.Database(pkg.ShardSet(4), clock=lambda: now["t"])
        db2.create_namespace(NS, pkg.NamespaceOptions(index_enabled=False))
        for sid in (1, 3):
            db2.namespace(NS).shards.pop(sid)
        counter = ROOT.sub_scope("bootstrap.commitlog").counter("replay_skipped")
        before = counter.value()
        res = pkg.bs.BootstrapProcess(
            chain=("commitlog",),
            ctx=pkg.bs.BootstrapContext(commitlog_dir=os.path.join(root, "cl"))
        ).run(db2, now_ns=now["t"])
        notes.append(res[NS].notes)
        if pkg is PORT:
            assert counter.value() == before + 1
    assert notes[0] == notes[1] and any("SKIPPED" in n for n in notes[0])
    db3 = PORT.Database(ShardSet(4), clock=lambda: now["t"])
    db3.create_namespace(NS, NamespaceOptions(index_enabled=False))
    res = bs.BootstrapProcess(chain=("commitlog",), ctx=bs.BootstrapContext(
        commitlog_dir=os.path.join(root, "cl"),
        shard_lookup=db3.shard_set.lookup)).run(db3, now_ns=now["t"])
    assert res[NS].notes == []
    assert db3.read(NS, b"skip-1", 0, now["t"] + 1)[1].tolist() == [1.0]


def test_corrupt_fileset_quarantined_and_left_to_the_commitlog(tmp_path):
    """A fileset flunking verification at bootstrap is quarantined, its
    range unclaimed by the filesystem bootstrapper; the commit log then
    replays it — in both packages alike, the notes included."""
    root = str(tmp_path)
    _db, ids, now = _build(PORT, root)
    pm = pfs.PersistManager(os.path.join(root, "data"))
    path = pm.list_filesets(NS, 2)[0][1]
    with open(os.path.join(path, pfs.DATA_FILE), "rb+") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0x10]))
    got, res = _recover(PORT, root, now)
    assert [bs_ for bs_, _p in pm.list_quarantined(NS, 2)] == [T0]
    assert any("quarantined" in n for n in res[NS].notes)
    assert 2 not in res[NS].claimed["filesystem"].m or not any(
        s <= T0 < e for s, e in res[NS].claimed["filesystem"].ranges(2))
    want, jres = _recover(REF, root, now)
    assert jres[NS].notes == [] and res[NS].claimed["commitlog"].m == \
        jres[NS].claimed["commitlog"].m
    _same_reads(got, want, ids, now["t"] + BLOCK)
    assert all(len(got.read(NS, sid, T0, T0 + BLOCK)[0]) == 1 for sid in ids)


def test_peers_and_placement_need_the_cluster(tmp_path):
    db = PORT.Database(ShardSet(2), clock=lambda: T0)
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    ns = db.namespace(NS)
    req = bs.BootstrapProcess().target_ranges(ns, T0)
    assert bs.PeersBootstrapper().bootstrap(
        ns, req, bs.BootstrapContext()).is_empty()
    assert bs.UninitializedTopologyBootstrapper().bootstrap(
        ns, req, bs.BootstrapContext()) == req
    with pytest.raises(bs.PeersBootstrapUnsupported, match="A13.2"):
        bs.PeersBootstrapper().bootstrap(
            ns, req, bs.BootstrapContext(session=object()))
    with pytest.raises(bs.PeersBootstrapUnsupported, match="A13.2"):
        bs.UninitializedTopologyBootstrapper().bootstrap(
            ns, req, bs.BootstrapContext(placement=object()))
    assert bs.DEFAULT_CHAIN == jbs.DEFAULT_CHAIN
    assert sorted(bs._REGISTRY) == sorted(jbs._REGISTRY)
    res = bs.BootstrapProcess().run(db, now_ns=T0)
    assert res[NS].claimed["uninitialized_topology"] == req
