"""Peer streaming and repair of the port (m3_tpu_torch.storage.bootstrap's
peers half, m3_tpu_torch.storage.repair) against the reference's, on the
CPU.

A port ClusterHarness(device="cpu") and a reference ClusterHarness (3
nodes, replication factor 3, 8 shards) get the same writes (40 tagged
series x 12 points, sealed by a tick). A fresh database bootstrapped
from peers through each package's Session gets registries and sealed
words equal to the reference's and to the donors'. apply_peer_tiles
equals its per-row oracle apply_peer_tiles_ref and the reference's
(mixed time units included: the decode and pack kernels' plain
versions); a holder that dies mid-stream re-plans onto the next; a
deadline bounds the stream against a delayed peer; and a repairer heals
a replica whose sealed block was overwritten, to the words of the other
replicas and of the reference's repair."""

import time

import numpy as np
import pytest

from m3_tpu.client import Session as JSession, SessionOptions as JSessionOptions
from m3_tpu.cluster import placement as jpl
from m3_tpu.cluster import topology as jtopo
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.storage import bootstrap as jbs
from m3_tpu.storage import repair as jrepair
from m3_tpu.storage.block import encode_block as jencode_block
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.storage.shard import Shard as JShard, ShardOptions as JShardOptions
from m3_tpu.testing import ClusterHarness as JClusterHarness
from m3_tpu_torch.client import Session, SessionOptions
from m3_tpu_torch.cluster import placement as pl
from m3_tpu_torch.cluster import topology as topo
from m3_tpu_torch.cluster.topology import StaticTopology
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.rpc import NodeServer, NodeService
from m3_tpu_torch.storage import bootstrap as bs
from m3_tpu_torch.storage import repair
from m3_tpu_torch.storage.block import encode_block
from m3_tpu_torch.storage.buffer import to_dense
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.shard import Shard, ShardOptions
from m3_tpu_torch.testing.cluster import ClusterHarness
from m3_tpu_torch.testing.faultnet import FaultPlan, FaultProxy
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.retry import RetryOptions

NS = b"default"
BLOCK = 2 * xtime.HOUR
T0 = (1_600_000_000 * xtime.SECOND // BLOCK) * BLOCK
START = T0 + 12 * 10 * xtime.SECOND
N_SERIES, N_SHARDS = 40, 8

PORT = dict(Harness=lambda **k: ClusterHarness(device="cpu", **k),
            Session=lambda topology, opts: Session(topology, opts,
                                                   device="cpu"),
            Opts=SessionOptions, bs=bs, repair=repair, topo=topo,
            Database=lambda *a, **k: Database(*a, device="cpu", **k),
            ShardSet=ShardSet, NamespaceOptions=NamespaceOptions,
            Shard=lambda i, o: Shard(i, o, device="cpu"),
            ShardOptions=ShardOptions,
            encode=lambda *a: encode_block(*a, device="cpu"))
REF = dict(Harness=JClusterHarness, Session=JSession, Opts=JSessionOptions,
           topo=jtopo, bs=jbs, repair=jrepair, Database=JDatabase, ShardSet=JShardSet,
           NamespaceOptions=JNamespaceOptions, Shard=JShard,
           ShardOptions=JShardOptions, encode=jencode_block)


def _ids():
    return [b"peer.%03d" % i for i in range(N_SERIES)]


def _seed(pkg, root):
    h = pkg["Harness"](n_nodes=3, replica_factor=3, num_shards=N_SHARDS,
                       start_ns=START, data_root=root)
    # Writes at ALL: every replica holds every point before the tick (a
    # MAJORITY write may still be in the third replica's queue).
    s = pkg["Session"](h.topology, pkg["Opts"](
        timeout_s=10, write_consistency=pkg["topo"].ConsistencyLevel.ALL))
    ids = _ids()
    vals = np.random.default_rng(71).standard_normal((12, N_SERIES))
    for k in range(12):
        s.write_batch(NS, ids, np.full(N_SERIES, T0 + k * 10 * xtime.SECOND),
                      vals[k], [{b"__name__": b"peer", b"i": b"%d" % i}
                                for i in range(N_SERIES)])
    h.clock.advance(BLOCK + 11 * xtime.MINUTE)
    h.tick_all()
    return h, s


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    port = _seed(PORT, str(tmp_path_factory.mktemp("port")))
    ref = _seed(REF, str(tmp_path_factory.mktemp("ref")))
    yield port, ref
    for h, s in (port, ref):
        s.close()
        h.close()


def _same_shard(a, b, rows_only=False):
    assert a.registry.all_ids() == b.registry.all_ids()
    assert sorted(a.blocks) == sorted(b.blocks)
    for start, blk in a.blocks.items():
        other = b.blocks[start]
        assert np.array_equal(blk.series_indices, other.series_indices)
        assert np.asarray(blk.words).tobytes() == \
            np.asarray(other.words).tobytes()
        assert np.array_equal(blk.nbits, other.nbits)
        assert np.array_equal(blk.npoints, other.npoints)
        assert blk.window == other.window
        assert int(blk.time_unit) == int(other.time_unit)
    for sid in a.registry.all_ids():
        assert a.registry.tags_of(a.registry.get(sid)) == \
            b.registry.tags_of(b.registry.get(sid))


def _rows_by_id(shard, bs_):
    """{series id: (words row, nbits, npoints)} of one sealed block."""
    blk = shard.blocks[bs_]
    out = {}
    for row, idx in enumerate(blk.series_indices.tolist()):
        sid = shard.registry.all_ids()[idx]
        out[sid] = (np.asarray(blk.words[row]).tobytes(),
                    int(blk.nbits[row]), int(blk.npoints[row]))
    return out


def _bootstrap(pkg, h, s):
    db = pkg["Database"](pkg["ShardSet"](N_SHARDS), clock=h.clock)
    db.create_namespace(NS, pkg["NamespaceOptions"](index_enabled=False))
    res = pkg["bs"].BootstrapProcess(
        chain=("peers", "uninitialized_topology"),
        ctx=pkg["bs"].BootstrapContext(session=s,
                                       placement=h.placement_svc.get(),
                                       host_id="joiner")).run(db)[NS]
    return db, res


def test_peers_bootstrap_equals_the_reference(clusters):
    (h, s), (jh, js) = clusters
    db, res = _bootstrap(PORT, h, s)
    jdb, jres = _bootstrap(REF, jh, js)
    assert res.unfulfilled.is_empty() and jres.unfulfilled.is_empty()
    assert res.claimed["peers"].m == jres.claimed["peers"].m
    donor = h.nodes["node0"].db.namespace(NS)
    for shard_id in range(N_SHARDS):
        got = db.namespace(NS).shards[shard_id]
        _same_shard(got, jdb.namespace(NS).shards[shard_id])
        for start in got.blocks:
            assert _rows_by_id(got, start) == _rows_by_id(
                donor.shards[shard_id], start)
    for sid in _ids()[::7]:
        t, v = db.read(NS, sid, 0, h.clock.now_ns)
        dt, dv = h.nodes["node1"].db.read(NS, sid, 0, h.clock.now_ns)
        assert len(t) == 12 and t.tobytes() == dt.tobytes()
        assert v.tobytes() == dv.tobytes()


def _random_tile(pkg, rng, bs_, n_series, prefix, nanos=False):
    """A tile as a peer block arrives: the package's real encode path,
    optional sub-second timestamps (NANOSECOND unit) for the mixed-unit
    merge."""
    npts = rng.integers(1, 5, n_series).astype(np.int32)
    w = int(npts.max())
    ts = np.zeros((n_series, w), np.int64)
    vs = rng.standard_normal((n_series, w))
    for i in range(n_series):
        step = xtime.SECOND if not nanos else xtime.SECOND + 7
        pts = bs_ + np.arange(w, dtype=np.int64) * step + i * xtime.SECOND
        ts[i] = pts
        ts[i, npts[i]:] = pts[npts[i] - 1]
        vs[i, npts[i]:] = vs[i, npts[i] - 1]
    blk = pkg["encode"](bs_, np.arange(n_series, dtype=np.int32), ts, vs,
                        npts)
    return {"ids": [b"%s-%04d" % (prefix, i) for i in range(n_series)],
            "words": np.asarray(blk.words), "nbits": np.asarray(blk.nbits),
            "npoints": np.asarray(blk.npoints), "window": int(blk.window),
            "time_unit": int(blk.time_unit)}


def _tile_map(seed):
    rng = np.random.default_rng(seed)
    tiles, tags = {}, {}
    for b in range(int(rng.integers(1, 4))):
        bs_ = T0 + b * BLOCK
        tlist, seen = [], set()
        for t in range(int(rng.integers(1, 3))):
            prefix = b"s%d" % t if rng.random() < 0.5 else b"s0"
            tile = _random_tile(PORT, rng, bs_, int(rng.integers(1, 9)),
                                prefix, nanos=(seed % 4 == 3 and t == 1))
            keep = [i for i, sid in enumerate(tile["ids"])
                    if sid not in seen and not seen.add(sid)]
            tile["ids"] = [tile["ids"][i] for i in keep]
            for k in ("words", "nbits", "npoints"):
                tile[k] = tile[k][keep]
            for sid in tile["ids"]:
                if rng.random() < 0.5:
                    tags.setdefault(sid, {b"case": b"%d" % seed})
            if tile["ids"]:
                tlist.append(tile)
        tiles[bs_] = tlist
    return tiles, tags


@pytest.mark.parametrize("seed", range(8))
def test_apply_peer_tiles_equals_its_oracle_and_the_reference(seed):
    """Seeded tile maps (several blocks, split holders, shared series,
    tags; seeds 3 and 7 mix time units): the batched apply equals the
    per-row oracle and the reference's apply, bit for bit."""
    tiles, tags = _tile_map(seed)
    port = PORT["Shard"](0, ShardOptions())
    oracle = PORT["Shard"](0, ShardOptions())
    ref = JShard(0, JShardOptions())
    n = bs.apply_peer_tiles(port, tiles, tags)
    assert n == bs.apply_peer_tiles_ref(oracle, tiles, tags)
    assert n == jbs.apply_peer_tiles(ref, tiles, tags)
    _same_shard(port, oracle)
    _same_shard(port, ref)
    for sid, tg in tags.items():
        assert port.registry.tags_of(port.registry.get(sid)) == tg


def test_the_mixed_unit_merge_decodes_and_re_encodes():
    """Replicas that sealed one block at different tick scales: the rows
    decode at their own units and the tile re-encodes at one, equal to
    the reference's re-encode and reading back every point."""
    rng = np.random.default_rng(5)
    secs = _random_tile(PORT, rng, T0, 6, b"a")
    nanos = _random_tile(PORT, rng, T0, 5, b"b", nanos=True)
    assert secs["time_unit"] != nanos["time_unit"]
    tiles = {T0: [secs, nanos]}
    port = PORT["Shard"](0, ShardOptions())
    ref = JShard(0, JShardOptions())
    bs.apply_peer_tiles(port, tiles, {})
    jbs.apply_peer_tiles(ref, tiles, {})
    _same_shard(port, ref)
    assert int(port.blocks[T0].time_unit) == int(xtime.Unit.NANOSECOND)
    t, v = port.read(b"b-0003", 0, T0 + BLOCK)
    jt, jv = ref.read(b"b-0003", 0, T0 + BLOCK)
    assert len(t) == int(nanos["npoints"][3])
    assert t.tobytes() == jt.tobytes() and v.tobytes() == jv.tobytes()


def test_mid_stream_peer_death_replans_to_the_next_holder(clusters, tmp_path):
    """A holder ranked first that is gone after the metadata phase: the
    fetch wave re-plans onto the next checksum holder, and the dead host's
    typed error is surfaced."""
    (h, s), _ = clusters
    shard_id = h.nodes["node0"].db.shard_set.lookup(_ids()[0])
    meta_errors = {}
    meta = s.fetch_blocks_metadata_from_peers(
        NS, shard_id, 0, h.clock.now_ns, errors=meta_errors)
    assert sorted(meta) == ["node0", "node1", "node2"] and not meta_errors
    keys = [(sid, b["bs"]) for sid in _ids()
            if h.nodes["node0"].db.shard_set.lookup(sid) == shard_id
            for b in meta["node1"][sid]["blocks"]]
    assert keys
    # A placement whose first host is a closed port, the second node1.
    dead = NodeServer(NodeService(h.nodes["node0"].db, device="cpu"))
    dead_ep = dead.endpoint
    dead._server.server_close()
    placement = pl.initial_placement(
        [pl.Instance("dead", dead_ep),
         pl.Instance("node1", h.nodes["node1"].endpoint)], N_SHARDS, 2)
    s2 = Session(StaticTopology(placement), SessionOptions(
        timeout_s=5, retry=RetryOptions(max_attempts=1)), device="cpu")
    try:
        errors = {}
        tiles, failed = s2.fetch_block_tiles(
            NS, shard_id, {k: ["dead", "node1"] for k in keys},
            errors=errors)
        assert not failed and "dead" in errors
        got = {(sid, b) for b, tl in tiles.items() for t in tl
               for sid in t["ids"]}
        assert got == set(keys)
        tiles, failed = s2.fetch_block_tiles(
            NS, shard_id, {k: ["dead"] for k in keys})
        assert sorted(failed) == sorted(keys) and not tiles
    finally:
        s2.close()


def test_a_deadline_bounds_the_stream_from_a_delayed_peer(tmp_path):
    """Every frame through the donor's proxy held 0.3 s against a 0.4 s
    budget a shard: the peers bootstrap ends quickly and leaves the
    shards it could not stream unfulfilled."""
    db = Database(ShardSet(2), clock=lambda: T0, device="cpu")
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    now = {"t": T0}
    db.clock = lambda: now["t"]
    db.write_batch(NS, [b"slow.%d" % i for i in range(8)],
                   np.full(8, T0, np.int64), np.arange(8.0))
    now["t"] = T0 + BLOCK + 11 * xtime.MINUTE
    db.tick()
    srv = NodeServer(NodeService(db, device="cpu")).start()
    proxy = FaultProxy(srv.endpoint, FaultPlan(seed=3, delay=1.0,
                                               delay_s=0.3)).start()
    placement = pl.initial_placement([pl.Instance("donor", proxy.endpoint)],
                                     2, 1)
    s = Session(StaticTopology(placement), SessionOptions(
        timeout_s=30, retry=RetryOptions(max_attempts=1)), device="cpu")
    try:
        fresh = Database(ShardSet(2), clock=lambda: now["t"], device="cpu")
        fresh.create_namespace(NS, NamespaceOptions(index_enabled=False))
        t0 = time.monotonic()
        res = bs.BootstrapProcess(chain=("peers",), ctx=bs.BootstrapContext(
            session=s, placement=placement, host_id="joiner",
            peer_deadline_s=0.4)).run(fresh, now_ns=now["t"])[NS]
        assert time.monotonic() - t0 < 4.0
        assert not res.unfulfilled.is_empty()
    finally:
        s.close()
        proxy.close()
        srv.close()


def test_uninitialized_topology_reads_the_placement():
    """A shard whose every replica is INITIALIZING (a brand-new topology)
    is claimed; one with an AVAILABLE replica is left to the peers."""
    db = Database(ShardSet(4), clock=lambda: T0, device="cpu")
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    ns = db.namespace(NS)
    req = bs.BootstrapProcess().target_ranges(ns, T0)
    for p, jp in ((pl.initial_placement([pl.Instance("a", "a:1"),
                                         pl.Instance("b", "b:1")], 4, 2),
                   None),):
        fresh = pl.replace_instance(p, "a", pl.Instance("c", "c:1"))
        jfresh = jpl.Placement.from_json(fresh.to_json())
        got = bs.UninitializedTopologyBootstrapper().bootstrap(
            ns, req, bs.BootstrapContext(placement=fresh))
        jdb = JDatabase(JShardSet(4), clock=lambda: T0)
        jdb.create_namespace(NS, JNamespaceOptions(index_enabled=False))
        want = jbs.UninitializedTopologyBootstrapper().bootstrap(
            jdb.namespace(NS), jbs.BootstrapProcess().target_ranges(
                jdb.namespace(NS), T0), jbs.BootstrapContext(
                    placement=jfresh))
        assert got.m == want.m and got.is_empty()
        empty = pl.Placement({iid: pl.Instance(iid, iid, shards={
            s: pl.ShardAssignment(s) for s in range(4)})
            for iid in ("x", "y")}, 4, 2)
        assert bs.UninitializedTopologyBootstrapper().bootstrap(
            ns, req, bs.BootstrapContext(placement=empty)) == req


def _diverge(pkg, h):
    """Overwrite one value of one series on node0's sealed block (decode,
    change, re-encode, install): node0's replica diverges. Returns the
    shard id, the block start and the series id."""
    sid = _ids()[3]
    node0 = h.nodes["node0"].db.namespace(NS)
    shard_id = h.nodes["node0"].db.shard_set.lookup(sid)
    shard = node0.shards[shard_id]
    blk = shard.blocks[T0]
    ts, vs, npts = blk.read_all()
    vs = np.array(vs)
    row = blk.row_of(shard.registry.get(sid))
    vs[row, 4] += 1000.0
    counts = np.asarray(npts)
    sidx = np.repeat(np.asarray(blk.series_indices), counts)
    mask = np.arange(ts.shape[1]) < counts[:, None]
    series, td, vd, cnt = to_dense(sidx, np.asarray(ts)[mask], vs[mask])
    with shard.write_lock:
        shard.blocks[T0] = pkg["encode"](T0, series, td, vd, cnt)
    return shard_id, sid


@pytest.mark.parametrize("stage", ["repair", "database_repairer"])
def test_repair_heals_a_divergence_like_the_reference(clusters, stage):
    """node0's copy of one value is overwritten; a ShardRepairer (or one
    DatabaseRepairer sweep) over the session heals it: the rebuilt
    block's rows equal the other replicas' and the reference's repair,
    and the healed series reads back bit for bit."""
    outs = []
    for pkg, (h, s) in zip((PORT, REF), clusters):
        shard_id, sid = _diverge(pkg, h)
        ns = h.nodes["node0"].db.namespace(NS)
        before = ns.shards[shard_id].read(sid, 0, h.clock.now_ns)[1]
        if stage == "repair":
            stats = pkg["repair"].ShardRepairer(s, host_id="node0") \
                .repair_shard(ns, shard_id, 0, h.clock.now_ns)
        else:
            rep = pkg["repair"].DatabaseRepairer(
                h.nodes["node0"].db, s, host_id="node0",
                opts=pkg["repair"].RepairOptions(seed=1))
            stats = rep.run()[NS]
        shard = ns.shards[shard_id]
        peer = h.nodes["node1"].db.namespace(NS).shards[shard_id]
        assert _rows_by_id(shard, T0) == _rows_by_id(peer, T0)
        t, v = shard.read(sid, 0, h.clock.now_ns)
        pt, pv = peer.read(sid, 0, h.clock.now_ns)
        assert t.tobytes() == pt.tobytes() and v.tobytes() == pv.tobytes()
        assert before.tobytes() != v.tobytes()
        outs.append((stats, _rows_by_id(shard, T0)))
    (stats, rows), (jstats, jrows) = outs
    assert rows == jrows
    assert stats.checksum_mismatches == jstats.checksum_mismatches >= 1
    assert stats.blocks_rebuilt == jstats.blocks_rebuilt >= 1
    assert stats.peer_errors == jstats.peer_errors == 0


def test_repairer_scheduling_equals_the_reference():
    db = Database(ShardSet(2), clock=lambda: T0, device="cpu")
    jdb = JDatabase(JShardSet(2), clock=lambda: T0)
    rep = repair.DatabaseRepairer(db, None, opts=repair.RepairOptions(
        interval_s=10.0, jitter_frac=0.5, seed=11))
    jrep = jrepair.DatabaseRepairer(jdb, None, opts=jrepair.RepairOptions(
        interval_s=10.0, jitter_frac=0.5, seed=11))
    assert [rep.next_delay_s() for _ in range(20)] == \
        [jrep.next_delay_s() for _ in range(20)]
    rep.consecutive_failures = jrep.consecutive_failures = 3
    assert rep.next_delay_s() == jrep.next_delay_s()
