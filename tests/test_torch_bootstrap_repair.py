"""Port of tests/test_bootstrap_repair.py on m3_tpu_torch: the same cases
on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Bootstrap chain + repair tests (reference test model:
src/dbnode/integration peers_bootstrap_*.go, fs_bootstrap tests,
storage/repair tests)."""

import time

import numpy as np
import pytest

from m3_tpu_torch.client import Session, SessionOptions
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist.commitlog import CommitLog
from m3_tpu_torch.persist.fs import PersistManager
from m3_tpu_torch.storage.bootstrap import (
    BootstrapContext,
    BootstrapProcess,
    apply_peer_tiles,
    apply_peer_tiles_ref,
)
from m3_tpu_torch.storage.block import encode_block
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.repair import DatabaseRepairer, RepairOptions, ShardRepairer
from m3_tpu_torch.storage.shard import Shard, ShardOptions
from m3_tpu_torch.storage.timerange import ShardTimeRanges, intersect, normalize, subtract
from m3_tpu_torch.testing import ClusterHarness, FaultPlan, FaultProxy
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.retry import RetryOptions
from test_torch_cpu_default import cpu_default  # noqa: F401

NS = b"default"
T0 = 1_600_000_000_000_000_000


def test_timerange_algebra():
    assert normalize([(5, 10), (0, 6)]) == [(0, 10)]
    assert normalize([(0, 5), (5, 10)]) == [(0, 10)]
    assert subtract([(0, 10)], [(3, 5)]) == [(0, 3), (5, 10)]
    assert subtract([(0, 10)], [(0, 10)]) == []
    assert subtract([(0, 4), (6, 10)], [(2, 8)]) == [(0, 2), (8, 10)]
    assert intersect([(0, 10)], [(5, 15)]) == [(5, 10)]
    str_ = ShardTimeRanges.uniform([1, 2], 0, 100)
    rem = str_.subtract(ShardTimeRanges({1: [(0, 100)], 2: [(0, 40)]}))
    assert rem.m == {2: [(40, 100)]}
    assert not rem.is_empty() and rem.total_ns() == 60


def _mk_db(tmp, with_cl=False, num_shards=8):
    cl = CommitLog(str(tmp / "commitlog")) if with_cl else None
    db = Database(ShardSet(num_shards), commitlog=cl, clock=lambda: _mk_db.now)
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    return db


_mk_db.now = T0


def test_fs_then_commitlog_chain(tmp_path):
    _mk_db.now = T0
    db = _mk_db(tmp_path, with_cl=True)
    pm = PersistManager(str(tmp_path / "data"))
    # Old block (will be sealed + flushed) ...
    old_ts = [T0 - i * xtime.SECOND for i in range(1, 11)]
    db.write_batch(NS, [b"series.flushed"] * 10, old_ts, np.arange(10.0))
    # ... advance past block end so it seals, write fresh points (commitlog only)
    _mk_db.now = T0 + 2 * xtime.HOUR + 11 * xtime.MINUTE
    db.tick()
    assert db.flush(pm) >= 1
    fresh_ts = [_mk_db.now - i * xtime.SECOND for i in range(1, 6)]
    db.write_batch(NS, [b"series.walonly"] * 5, fresh_ts, np.arange(5.0) + 100)
    db.commitlog.flush()

    # A fresh db bootstraps: fs claims the flushed block, commitlog the rest.
    db2 = _mk_db(tmp_path / "node2")
    proc = BootstrapProcess(
        chain=("filesystem", "commitlog", "uninitialized_topology"),
        ctx=BootstrapContext(
            persist=pm, commitlog_dir=str(tmp_path / "commitlog"),
            shard_lookup=db2.shard_set.lookup),
    )
    results = proc.run(db2, now_ns=_mk_db.now)
    res = results[NS]
    assert res.unfulfilled.is_empty()
    assert not res.claimed["filesystem"].is_empty()
    assert db2.bootstrapped

    t, v = db2.read(NS, b"series.flushed", T0 - xtime.HOUR, T0 + xtime.HOUR)
    np.testing.assert_array_equal(v, np.arange(9.0, -1.0, -1))
    t, v = db2.read(NS, b"series.walonly", _mk_db.now - xtime.HOUR, _mk_db.now + 1)
    np.testing.assert_array_equal(v, np.array([104.0, 103, 102, 101, 100]))


@pytest.fixture(scope="module")
def cluster():
    h = ClusterHarness(n_nodes=3, replica_factor=3, num_shards=8,
                       ns_opts=NamespaceOptions())
    yield h
    h.close()


def _seed_and_seal(cluster, session, ids, base_val=0.0):
    now = cluster.clock.now_ns
    ts = [now - i * xtime.SECOND for i in range(12)]
    for j, sid in enumerate(ids):
        session.write_batch(NS, [sid] * 12, ts,
                            np.arange(12.0) + base_val + 10 * j,
                            [{b"role": b"seed"}] * 12)
    cluster.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
    cluster.tick_all()
    return ts


def test_peers_bootstrap(cluster):
    session = Session(cluster.topology, SessionOptions(timeout_s=10))
    ids = [b"peer.a", b"peer.b", b"peer.c"]
    _seed_and_seal(cluster, session, ids)

    # Replacement node: empty db, same shard space, bootstraps from peers.
    newdb = Database(ShardSet(cluster.num_shards), clock=cluster.clock)
    newdb.create_namespace(NS, NamespaceOptions(index_enabled=False))
    proc = BootstrapProcess(
        chain=("peers", "uninitialized_topology"),
        ctx=BootstrapContext(session=session,
                             placement=cluster.placement_svc.get()),
    )
    res = proc.run(newdb)[NS]
    assert res.unfulfilled.is_empty()
    for j, sid in enumerate(ids):
        t, v = newdb.read(NS, sid, 0, cluster.clock.now_ns)
        assert len(t) == 12
        np.testing.assert_array_equal(np.sort(v), np.arange(12.0) + 10 * j)
    session.close()


def _assert_shards_bit_identical(sh_new: Shard, sh_ref: Shard):
    assert sh_new.registry.all_ids() == sh_ref.registry.all_ids()
    assert sorted(sh_new.blocks) == sorted(sh_ref.blocks)
    for bs, blk in sh_new.blocks.items():
        ref = sh_ref.blocks[bs]
        np.testing.assert_array_equal(blk.series_indices, ref.series_indices)
        np.testing.assert_array_equal(blk.words, ref.words)
        np.testing.assert_array_equal(blk.nbits, ref.nbits)
        np.testing.assert_array_equal(blk.npoints, ref.npoints)
        assert blk.window == ref.window and blk.time_unit == ref.time_unit


def _tile_from_block(blk, ids):
    return {"ids": ids, "words": blk.words, "nbits": blk.nbits,
            "npoints": blk.npoints, "window": int(blk.window),
            "time_unit": int(blk.time_unit)}


def _random_tile(rng, bs, n_series, prefix, nanos=False):
    """Encode a random tile the way a peer block would arrive: real
    encode path, optional sub-second timestamps (NANOSECOND unit) to
    exercise the mixed-unit merge."""
    npts = rng.integers(1, 5, n_series).astype(np.int32)
    w = int(npts.max())
    ts = np.zeros((n_series, w), np.int64)
    vs = rng.standard_normal((n_series, w))
    for i in range(n_series):
        step = xtime.SECOND if not nanos else xtime.SECOND + 7
        pts = bs + np.arange(w, dtype=np.int64) * step + i * xtime.SECOND
        ts[i] = pts
        ts[i, npts[i]:] = pts[npts[i] - 1]
        vs[i, npts[i]:] = vs[i, npts[i] - 1]
    blk = encode_block(bs, np.arange(n_series, dtype=np.int32), ts, vs, npts)
    ids = [b"%s-%04d" % (prefix, i) for i in range(n_series)]
    return _tile_from_block(blk, ids)


def test_batched_apply_matches_per_row_oracle_synthetic():
    """Property: apply_peer_tiles (batched registry + columnar install)
    is bit-identical to the retained per-row oracle across seeded tile
    maps — multiple blocks, multiple tiles per block (split holders),
    shared series across blocks, tags, and mixed time units."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        tiles = {}
        tags = {}
        n_blocks = int(rng.integers(1, 4))
        for b in range(n_blocks):
            bs = T0 + b * 2 * xtime.HOUR
            tlist = []
            n_tiles = int(rng.integers(1, 3))
            for t in range(n_tiles):
                prefix = b"s%d" % t if rng.random() < 0.5 else b"s0"
                tile = _random_tile(rng, bs, int(rng.integers(1, 9)),
                                    prefix, nanos=(seed % 4 == 3 and t == 1))
                tlist.append(tile)
                for sid in tile["ids"]:
                    if rng.random() < 0.5:
                        tags.setdefault(sid, {b"case": b"%d" % seed})
            # distinct sids per (bs): dedupe tile ids across the block
            seen = set()
            for tile in tlist:
                keep = [i for i, sid in enumerate(tile["ids"])
                        if sid not in seen and not seen.add(sid)]
                tile["ids"] = [tile["ids"][i] for i in keep]
                tile["words"] = np.asarray(tile["words"])[keep]
                tile["nbits"] = np.asarray(tile["nbits"])[keep]
                tile["npoints"] = np.asarray(tile["npoints"])[keep]
            tiles[bs] = [t for t in tlist if len(t["ids"])]
        opts = ShardOptions()
        sh_new, sh_ref = Shard(0, opts), Shard(0, opts)
        n_new = apply_peer_tiles(sh_new, tiles, tags)
        n_ref = apply_peer_tiles_ref(sh_ref, tiles, tags)
        assert n_new == n_ref
        _assert_shards_bit_identical(sh_new, sh_ref)
        for sid, tg in tags.items():
            idx = sh_new.registry.get(sid)
            assert sh_new.registry.tags_of(idx) == tg
            assert sh_ref.registry.tags_of(sh_ref.registry.get(sid)) == tg


def test_batched_apply_matches_per_row_oracle_cluster(cluster):
    """End-to-end oracle cases: seeded writes through the real session,
    tiles fetched over the real peer-streaming RPC, both apply paths
    asserted bit-identical per shard (the bench runs the same check on
    its 100k-series migration)."""
    session = Session(cluster.topology, SessionOptions(timeout_s=10))
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        ids = [b"oracle%d.%03d" % (seed, i) for i in range(24)]
        _seed_and_seal(cluster, session, ids, base_val=float(seed) * 100)
        shard_ids = sorted({cluster.nodes["node0"].db.shard_set.lookup(s)
                            for s in ids})
        checked = 0
        for shard_id in shard_ids[:3]:
            exclude = rng.choice(["node0", "node1", "node2", None])
            tiles, tags, failed = session.fetch_block_tiles_from_peers(
                NS, int(shard_id), 0, cluster.clock.now_ns,
                exclude_host=None if exclude is None else str(exclude))
            assert not failed
            if not tiles:
                continue
            opts = ShardOptions()
            sh_new, sh_ref = Shard(0, opts), Shard(0, opts)
            apply_peer_tiles(sh_new, tiles, tags)
            apply_peer_tiles_ref(sh_ref, tiles, tags)
            _assert_shards_bit_identical(sh_new, sh_ref)
            checked += 1
        assert checked > 0
    session.close()


def test_mid_stream_peer_death_replans_to_next_holder(cluster):
    """A dead holder ranked first in the plan must fail over to the next
    checksum holder instead of dropping the block (the wave-based
    fetch_block_tiles fallback), and typed errors must be surfaced."""
    session = Session(cluster.topology, SessionOptions(
        timeout_s=10, retry=RetryOptions(max_attempts=1)))
    ids = [b"replan.a", b"replan.b"]
    _seed_and_seal(cluster, session, ids)
    shard_id = cluster.nodes["node0"].db.shard_set.lookup(ids[0])
    meta = session.fetch_blocks_metadata_from_peers(
        NS, shard_id, 0, cluster.clock.now_ns)
    live = sorted(h for h in meta if meta[h].get(ids[0]))
    assert len(live) >= 2
    dead, backup = live[0], live[1]
    # Kill the primary AFTER metadata: the fetch wave must re-plan. A
    # fresh session forces real (re)connects — the stopped listener
    # refuses them (established handler threads would otherwise keep
    # serving the old session's pooled sockets).
    cluster.stop_node(dead)
    session2 = Session(cluster.topology, SessionOptions(
        timeout_s=10, retry=RetryOptions(max_attempts=1)))
    try:
        shard_ids = [s for s in ids
                     if cluster.nodes["node0"].db.shard_set.lookup(s)
                     == shard_id]
        keys = [(sid, b["bs"]) for sid in shard_ids
                for b in meta[backup][sid]["blocks"]]
        holders = {k: [dead, backup] for k in keys}
        errors = {}
        tiles, failed = session2.fetch_block_tiles(
            NS, shard_id, holders, errors=errors)
        assert not failed, failed
        assert dead in errors  # typed, surfaced — not silently skipped
        got = {(sid, bs) for bs, tlist in tiles.items()
               for t in tlist for sid in t["ids"]}
        assert got == set(keys)
    finally:
        # Restart the dead node so the module-scoped cluster stays
        # 3/3 for the remaining tests.
        from m3_tpu_torch.rpc import NodeServer, NodeService

        node = cluster.nodes[dead]
        node.server = NodeServer(NodeService(node.db)).start()
        p = cluster.placement_svc.get()
        p.instances[dead].endpoint = node.endpoint
        cluster.placement_svc._put(p, p.version)
        session.close()
        session2.close()


def test_deadline_bounded_bootstrap_against_delayed_peer():
    """A faultnet-delayed peer must bound the peers bootstrap at the
    configured budget and surface partial coverage (unfulfilled ranges),
    not stall the whole chain."""
    from m3_tpu_torch.cluster.placement import Instance, initial_placement
    from m3_tpu_torch.cluster.topology import StaticTopology
    from m3_tpu_torch.rpc import NodeServer, NodeService

    db = Database(ShardSet(2), clock=lambda: T0)
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    now = {"t": T0}
    db.clock = lambda: now["t"]
    ids = [b"slow.%02d" % i for i in range(8)]
    db.write_batch(NS, ids, np.full(len(ids), T0, np.int64),
                   np.arange(8.0))
    now["t"] = T0 + 2 * xtime.HOUR + 11 * xtime.MINUTE
    db.tick()
    db.mark_bootstrapped()
    srv = NodeServer(NodeService(db)).start()
    # Every frame in BOTH directions held 0.4s: a full metadata+tile
    # exchange costs far more than the 0.6s budget.
    proxy = FaultProxy(srv.endpoint,
                       FaultPlan(seed=3, delay=1.0, delay_s=0.4)).start()
    placement = initial_placement(
        [Instance(id="donor", endpoint=proxy.endpoint)], 2, 1)
    session = Session(StaticTopology(placement), SessionOptions(
        timeout_s=30, retry=RetryOptions(max_attempts=1)))
    fresh = Database(ShardSet(2), clock=lambda: now["t"])
    fresh.create_namespace(NS, NamespaceOptions(index_enabled=False))
    proc = BootstrapProcess(
        chain=("peers",),
        ctx=BootstrapContext(session=session, placement=placement,
                             host_id="joiner", peer_deadline_s=0.6))
    t0 = time.monotonic()
    res = proc.run(fresh, now_ns=now["t"])[NS]
    elapsed = time.monotonic() - t0
    # Two shards, each bounded by its own 0.6s budget (+ slack for the
    # delayed in-flight frame): nowhere near the unbounded many-page
    # exchange, and the hole is SURFACED as unfulfilled ranges.
    assert elapsed < 5.0, f"bootstrap not deadline-bounded: {elapsed:.1f}s"
    assert not res.unfulfilled.is_empty()
    session.close()
    proxy.close()
    srv.close()


def test_repairer_scheduling_jitter_and_backoff():
    """dbRepairer cadence: seeded jitter within [interval, interval*(1+f)),
    failure backoff stretches the next delay, success resets it."""
    db = Database(ShardSet(2), clock=lambda: T0)
    rep = DatabaseRepairer(
        db, session=None,
        opts=RepairOptions(interval_s=10.0, jitter_frac=0.5, seed=11))
    delays = [rep.next_delay_s() for _ in range(50)]
    assert all(10.0 <= d < 15.0 for d in delays)
    # deterministic under the seed
    rep2 = DatabaseRepairer(
        db, session=None,
        opts=RepairOptions(interval_s=10.0, jitter_frac=0.5, seed=11))
    assert [rep2.next_delay_s() for _ in range(50)] == delays
    rep.consecutive_failures = 3
    assert rep.next_delay_s() > 10.0 + rep._backoff.backoff_for(3) - 1e-9
    rep.consecutive_failures = 0
    assert rep.next_delay_s() < 15.0


def test_repair_detects_and_heals_divergence(cluster):
    session = Session(cluster.topology, SessionOptions(timeout_s=10))
    ids = [b"repair.x", b"repair.y"]
    _seed_and_seal(cluster, session, ids, base_val=500.0)

    # Damage node0: drop one sealed block containing repair.x.
    node0 = cluster.nodes["node0"]
    shard_id = node0.db.shard_set.lookup(b"repair.x")
    shard = node0.db.namespace(NS).shards[shard_id]
    victim_bs = None
    idx = shard.registry.get(b"repair.x")
    for bs, blk in list(shard.blocks.items()):
        if blk.row_of(idx) is not None:
            victim_bs = bs
            del shard.blocks[bs]
            break
    assert victim_bs is not None

    rep = ShardRepairer(session, host_id="node0")
    stats = rep.repair_shard(node0.db.namespace(NS), shard_id,
                             0, cluster.clock.now_ns)
    assert stats.rows_missing_locally >= 1
    assert stats.blocks_rebuilt >= 1
    assert victim_bs in shard.blocks
    t, v = shard.read(b"repair.x", 0, cluster.clock.now_ns)
    assert len(t) >= 12
    session.close()
