"""The port's storage node (m3_tpu_torch.storage, client.decode, convert)
against the reference's (m3_tpu.storage, m3_tpu.client.decode) on the same
seeded writes, on the CPU (the plain versions of the pack, decode and hash
kernels).

Sealing and reading are exact integer work: every SealedBlock field
(words, nbits, npoints, window, time_unit, series_indices, boundary) and
every decoded plane must be identical bit for bit, so no tolerance applies
anywhere in this file (values compare as u64 bit patterns, so NaN
payloads and signed zeros count).

Both packages' process block caches are replaced by fresh ones for each
test, so no residency crosses tests or packages. The sizes keep to a few
padded block geometries, since the reference compiles its encode and
decode once per geometry."""

import numpy as np
import pytest
import torch

from m3_tpu.client import decode as jdecode
from m3_tpu.ops import tsz as jtsz
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.storage import block as jblock
from m3_tpu.storage import block_cache as jcache
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.utils import xtime as jxtime
from m3_tpu.utils.hbm import HBMBudget as JHBMBudget
from m3_tpu_torch import convert
from m3_tpu_torch.client import decode as pdecode
from m3_tpu_torch.ops import tsz as ptsz
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.storage import block as pblock
from m3_tpu_torch.storage import block_cache as pcache
from m3_tpu_torch.storage.buffer import ShardBuffer, dedup_sorted
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.testing import hostile_block
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hbm import HBMBudget

CPU = "cpu"
BLOCK = 2 * xtime.HOUR
T0 = 1_600_000_000 * xtime.SECOND
T0_BLOCK = T0 - T0 % BLOCK
FIELDS = ("words", "nbits", "npoints", "series_indices")


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Fresh, isolated process caches for both packages."""
    port = pcache.DeviceBlockCache(budget=HBMBudget(64 << 20), admit_after=2)
    ref = jcache.DeviceBlockCache(budget=JHBMBudget(64 << 20), admit_after=2)
    monkeypatch.setattr(pcache, "_CACHE", port)
    monkeypatch.setattr(jcache, "_CACHE", ref)
    return port, ref


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float64:
        a, b = a.view(np.uint64), np.asarray(b, np.float64).view(np.uint64)
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def assert_same_block(blk, ref):
    for f in FIELDS:
        assert same_bits(getattr(blk, f), getattr(ref, f)), f
    assert blk.window == ref.window
    assert int(blk.time_unit) == int(ref.time_unit)
    assert blk.block_start == ref.block_start
    assert blk.checksum == ref.checksum
    assert (blk.boundary is None) == (ref.boundary is None)
    if ref.boundary is not None:
        assert sorted(blk.boundary) == sorted(ref.boundary)
        for k, v in ref.boundary.items():
            assert same_bits(blk.boundary[k], v), k


def dense_tiles(seed, s, w, hostile=False, bs=T0_BLOCK):
    """Seeded dense tiles as ShardBuffer.drain hands them to encode_block:
    rows padded with their last real point, npoints >= 1. hostile mixes in
    the codec corpus (NaN holes, signed zeros, denormals, raw bit
    patterns); otherwise a 10 s grid with float and int-mode rows."""
    rng = np.random.default_rng(seed)
    if hostile:
        ts, vals, npoints = hostile_block(seed, s, w)
        ts = ts - ts[:, :1] + bs
        npoints = np.maximum(npoints, 1)
    else:
        ts = bs + np.arange(w, dtype=np.int64)[None, :] * 10 * xtime.SECOND \
            + np.zeros((s, 1), np.int64)
        vals = rng.standard_normal((s, w)) * 100
        vals[::2] = np.round(vals[::2])
        npoints = rng.integers(1, w + 1, size=s).astype(np.int32)
    for i in range(s):
        n = npoints[i]
        ts[i, n:] = ts[i, n - 1]
        vals[i, n:] = vals[i, n - 1]
    return np.arange(s, dtype=np.int32) * 3, ts, vals, npoints


# Three padded geometries ([8, 8], [32, 64], [32, 128]: encode_block pads
# both axes to powers of two) and a one-row, one-point block.
CASES = [(0, 5, 4, False), (1, 8, 8, True), (2, 17, 33, False),
         (3, 21, 40, True), (4, 32, 64, True), (5, 24, 90, False),
         (6, 30, 120, True), (7, 1, 1, False)]


@pytest.mark.parametrize("seed,s,w,hostile", CASES)
def test_encode_block_bit_identical(seed, s, w, hostile):
    tiles = dense_tiles(seed, s, w, hostile)
    blk = pblock.encode_block(T0_BLOCK, *tiles, device=CPU)
    ref = jblock.encode_block(T0_BLOCK, *tiles)
    assert_same_block(blk, ref)
    assert blk.device == torch.device(CPU)


@pytest.mark.parametrize("seed,s,w,hostile", CASES)
def test_read_and_read_all_bit_identical(seed, s, w, hostile):
    tiles = dense_tiles(seed, s, w, hostile)
    blk = pblock.encode_block(T0_BLOCK, *tiles, device=CPU)
    ref = jblock.encode_block(T0_BLOCK, *tiles)
    # Cold single-row reads of a few rows (read_all covers every row) and
    # a series the block does not hold.
    for sidx in list(tiles[0][:3]) + [tiles[0][-1], 1]:
        got, want = blk.read(int(sidx)), ref.read(int(sidx))
        if want is None:
            assert got is None
            continue
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
        assert not got[0].flags.writeable and not got[1].flags.writeable
    for _ in range(3):  # cold, admission, hit
        got, want = blk.read_all(), ref.read_all()
        for a, b in zip(got, want):
            assert same_bits(a, b)


def test_merge_same_start_last_arrival_wins():
    tiles1 = dense_tiles(11, 4, 4)
    sidx, ts, vals, npts = dense_tiles(12, 4, 4)
    vals = vals + 1000.0  # every b2 value differs from b1's
    ts[1::2] += 5 * xtime.SECOND  # half of b2's rows interleave with b1's
    tiles2 = (np.arange(4, dtype=np.int32) * 2, ts, vals, npts)
    b1 = pblock.encode_block(T0_BLOCK, *tiles1, device=CPU)
    b2 = pblock.encode_block(T0_BLOCK, *tiles2, device=CPU)
    merged = pblock.merge_same_start(b1, b2)
    ref = jblock.merge_same_start(jblock.encode_block(T0_BLOCK, *tiles1),
                                  jblock.encode_block(T0_BLOCK, *tiles2))
    assert_same_block(merged, ref)
    # Series in both: duplicate timestamps take b2's value.
    for sid in (0, 6):
        t2, v2 = b2.read(sid)
        mt, mv = merged.read(sid)
        pos = np.searchsorted(mt, t2)
        np.testing.assert_array_equal(mt[pos], t2)
        np.testing.assert_array_equal(mv[pos], v2)
    t2, v2 = b2.read(6)
    mt, mv = merged.read(6)
    pos = np.searchsorted(mt, t2)
    np.testing.assert_array_equal(mv[pos], v2)
    with pytest.raises(ValueError):
        pblock.merge_same_start(b1, pblock.encode_block(
            T0_BLOCK + BLOCK, *dense_tiles(13, 2, 4, bs=T0_BLOCK + BLOCK),
            device=CPU))


def test_merge_by_full_recode_bit_identical():
    t1 = dense_tiles(21, 5, 8)
    t2 = dense_tiles(22, 7, 8, bs=T0_BLOCK + BLOCK)
    got = pblock._merge_by_full_recode(
        pblock.encode_block(T0_BLOCK, *t1, device=CPU),
        pblock.encode_block(T0_BLOCK + BLOCK, *t2, device=CPU))
    want = jblock._merge_by_full_recode(
        jblock.encode_block(T0_BLOCK, *t1),
        jblock.encode_block(T0_BLOCK + BLOCK, *t2))
    assert_same_block(got, want)


@pytest.mark.parametrize("seed,n,w", [(0, 8, 8), (1, 32, 64), (2, 4, 8)])
def test_encode_with_boundary_bit_identical(seed, n, w):
    ts, vals, npoints = hostile_block(seed, n, w)
    npoints = np.maximum(npoints, 1)
    words, nbits, bnd = ptsz.encode_with_boundary(ts, vals, npoints,
                                                  device=CPU)
    jw, jn, jb = jtsz.encode_with_boundary(ts, vals, npoints)
    np.testing.assert_array_equal(convert.words_to_numpy(words), np.asarray(jw))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(jn))
    assert sorted(bnd) == sorted(jb)
    for k in jb:
        assert same_bits(bnd[k], jb[k]), k


# ------------------------------------------------------------ the database


def make_dbs(num_shards=8, index=False):
    now = {"t": T0}
    clock = lambda: now["t"]  # noqa: E731
    db = Database(ShardSet(num_shards), clock=clock, device=CPU)
    db.create_namespace(b"default", NamespaceOptions(index_enabled=index))
    jdb = JDatabase(JShardSet(num_shards), clock=clock)
    jdb.create_namespace(b"default", JNamespaceOptions(index_enabled=index))
    return db, jdb, now


def both(dbs, method, *args, **kw):
    return [getattr(d, method)(*args, **kw) for d in dbs]


def test_shard_write_seal_read_expire():
    db, jdb, now = make_dbs()
    dbs = (db, jdb)
    base = T0_BLOCK
    ids = [f"series-{i}".encode() for i in range(20)]
    for step in range(6):
        t = T0 + step * 10 * xtime.SECOND
        for sid in ids:
            both(dbs, "write", b"default", sid, t, float(step))
    assert both(dbs, "tick") == [{"sealed": 0, "expired": 0}] * 2
    got, want = both(dbs, "read", b"default", ids[0], base, base + BLOCK)
    assert len(got[1]) == 6 and same_bits(got[1], want[1])

    now["t"] = base + BLOCK + 11 * xtime.MINUTE
    r, jr = both(dbs, "tick")
    assert r == jr and r["sealed"] > 0
    for sid in ids:
        got, want = both(dbs, "read", b"default", sid, T0 - xtime.MINUTE,
                         T0 + xtime.HOUR)
        np.testing.assert_array_equal(got[1], np.arange(6.0))
        assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    ns, jns = db.namespace(b"default"), jdb.namespace(b"default")
    for sh, shard in ns.shards.items():
        assert sorted(shard.blocks) == sorted(jns.shards[sh].blocks)
        for bs, blk in shard.blocks.items():
            assert_same_block(blk, jns.shards[sh].blocks[bs])

    now["t"] = base + 2 * xtime.DAY + BLOCK + xtime.MINUTE
    r, jr = both(dbs, "tick")
    assert r == jr and r["expired"] > 0
    got, _ = both(dbs, "read", b"default", ids[0], base, base + BLOCK)
    assert len(got[1]) == 0


def test_shard_rejects_out_of_window_writes():
    db, _, _ = make_dbs()
    with pytest.raises(ValueError):
        db.write(b"default", b"s", T0 - xtime.DAY, 1.0)
    with pytest.raises(ValueError):
        db.write(b"default", b"s", T0 + xtime.HOUR, 1.0)
    with pytest.raises(ValueError):
        db.write_batch(b"default", [b"s"], [T0 + xtime.HOUR], [1.0])


def test_duplicate_timestamp_last_wins_through_seal():
    db, jdb, now = make_dbs()
    for d in (db, jdb):
        d.write(b"default", b"dup", T0, 1.0)
        d.write(b"default", b"dup", T0, 2.0)
        d.write_batch(b"default", [b"dup2", b"dup2"], [T0, T0], [3.0, 4.0])
    now["t"] = T0_BLOCK + BLOCK + 11 * xtime.MINUTE
    both((db, jdb), "tick")
    for sid, want in ((b"dup", 2.0), (b"dup2", 4.0)):
        got, ref = both((db, jdb), "read", b"default", sid, T0 - 1, T0 + 1)
        np.testing.assert_array_equal(got[1], [want])
        assert same_bits(got[1], ref[1])


def test_write_batch_routes_shards(rng):
    db, jdb, _ = make_dbs()
    ids = [f"m-{i}".encode() for i in range(100)]
    ts = np.full(100, T0, np.int64)
    vals = rng.standard_normal(100)
    both((db, jdb), "write_batch", b"default", ids, ts, vals)
    for i in (0, 50, 99):
        t, v = db.read(b"default", ids[i], T0 - 1, T0 + 1)
        np.testing.assert_allclose(v, [vals[i]])
    ns, jns = db.namespace(b"default"), jdb.namespace(b"default")
    assert sum(s.num_series() for s in ns.shards.values()) == 100
    for sh, shard in ns.shards.items():
        assert shard.registry.all_ids() == jns.shards[sh].registry.all_ids()


def test_hot_set_writes_seal_and_read_like_the_reference(fresh_caches):
    """bench_hot_set_read's build at a small size: 4 shards, two sealed
    2 h blocks of 8 points per series, every block and every read
    identical to the reference's."""
    n, ppb = 20, 8
    step = BLOCK // ppb
    ids = [b"hot-%06d" % i for i in range(n)]
    vals = np.random.default_rng(53).standard_normal((2 * ppb, n))
    opts = dict(index_enabled=False, snapshot_enabled=False,
                retention_ns=4 * xtime.DAY, writes_to_commitlog=False)
    now = {"t": T0_BLOCK}
    db = Database(ShardSet(4), clock=lambda: now["t"], device=CPU)
    db.ensure_namespace(b"bench", NamespaceOptions(**opts))
    jdb = JDatabase(JShardSet(4), clock=lambda: now["t"])
    jdb.ensure_namespace(b"bench", JNamespaceOptions(**opts))
    for s in range(2 * ppb):
        now["t"] = T0_BLOCK + s * step
        both((db, jdb), "write_batch", b"bench", ids,
             np.full(n, now["t"], np.int64), vals[s])
    now["t"] = T0_BLOCK + 2 * BLOCK + 11 * xtime.MINUTE
    st, jst = both((db, jdb), "tick")
    assert st == jst == {"sealed": 8, "expired": 0}
    ns, jns = db.namespace(b"bench"), jdb.namespace(b"bench")
    for sh, shard in ns.shards.items():
        for bs, blk in shard.blocks.items():
            ref = jns.shards[sh].blocks[bs]
            assert_same_block(blk, ref)
            for a, b in zip(blk.read_all(), ref.read_all()):
                assert same_bits(a, b)
    for _ in range(2):
        for sid in ids:
            got, want = both((db, jdb), "read", b"bench", sid, T0_BLOCK,
                             T0_BLOCK + 2 * BLOCK)
            assert len(got[0]) == 2 * ppb
            assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    port, _ = fresh_caches
    assert port.stats()["hits"] > 0 and port.stats()["admitted"] == 8


def test_commitlog_replays_after_abandon(tmp_path):
    """A commit-logged Database abandoned without close() (the disk as a
    SIGKILL leaves it) comes back through the commit-log bootstrap with
    every acknowledged point, bit for bit, the reference reading the same
    WAL to the same points."""
    from m3_tpu.persist import commitlog as jcl
    from m3_tpu.storage import bootstrap as jbs
    from m3_tpu_torch.persist import commitlog as cl
    from m3_tpu_torch.storage import bootstrap as bs

    d = str(tmp_path / "commitlog")
    now = {"t": T0}
    db = Database(ShardSet(4), commitlog=cl.CommitLog(
        d, strategy=cl.Strategy.WRITE_WAIT), clock=lambda: now["t"],
        device=CPU)
    db.ensure_namespace(b"default", NamespaceOptions(index_enabled=False))
    ids = [b"wal-%d" % i for i in range(12)]
    vals = np.array([-0.0, np.inf, -np.inf, np.nan, 5e-324] + [1.5] * 7)
    db.write_batch(b"default", ids, np.full(12, T0), vals)
    db.write(b"default", ids[0], T0 + 1, 7.0)
    assert len(list(jcl.replay(d))) == 13
    end = T0 + xtime.HOUR
    want = [db.read(b"default", sid, 0, end) for sid in ids]
    back = Database(ShardSet(4), clock=lambda: now["t"], device=CPU)
    back.ensure_namespace(b"default", NamespaceOptions(index_enabled=False))
    ref = JDatabase(JShardSet(4), clock=lambda: now["t"])
    ref.ensure_namespace(b"default", JNamespaceOptions(index_enabled=False))
    for mod, target in ((bs, back), (jbs, ref)):
        mod.BootstrapProcess(chain=("commitlog",), ctx=mod.BootstrapContext(
            commitlog_dir=d, shard_lookup=target.shard_set.lookup)).run(
                target, now_ns=now["t"])
    assert back.bootstrapped
    for sid, (wt, wv) in zip(ids, want):
        for other in (back, ref):
            gt, gv = other.read(b"default", sid, 0, end)
            assert same_bits(gt, wt) and same_bits(gv, wv)


def test_close_drains_and_leaves_no_residency(fresh_caches):
    db, _, now = make_dbs()
    ids = [b"c-%d" % i for i in range(12)]
    db.write_batch(b"default", ids, np.full(12, T0), np.arange(12.0))
    now["t"] = T0_BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    for _ in range(2):
        db.read(b"default", ids[0], T0_BLOCK, T0_BLOCK + BLOCK)
    port, _ = fresh_caches
    assert port.stats()["bytes"] > 0
    db.close()
    assert port.stats()["bytes"] == 0


def test_buffer_out_of_order_and_dedup():
    buf = ShardBuffer(BLOCK, 10 * xtime.MINUTE, 2 * xtime.MINUTE)
    buf.write(0, T0_BLOCK + 30 * xtime.SECOND, 3.0)
    buf.write(0, T0_BLOCK + 10 * xtime.SECOND, 1.0)
    buf.write(0, T0_BLOCK + 20 * xtime.SECOND, 2.0)
    _, v = buf.read(0, T0_BLOCK, T0_BLOCK + xtime.HOUR)
    np.testing.assert_array_equal(v, [1.0, 2.0, 3.0])
    s, t, v = dedup_sorted(np.array([0, 0, 0, 1], np.int32),
                           np.array([10, 5, 10, 7], np.int64),
                           np.array([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(t, [5, 10, 7])
    np.testing.assert_array_equal(v, [2.0, 3.0, 4.0])


# ------------------------------------------------------------- client decode


@pytest.mark.parametrize("seed,s,w,hostile", CASES[:5])
def test_decode_tile_bit_identical(seed, s, w, hostile):
    tiles = dense_tiles(seed, s, w, hostile)
    ref = jblock.encode_block(T0_BLOCK, *tiles)
    got = pdecode.decode_tile(ref.words, ref.npoints, ref.window,
                              int(ref.time_unit), device=CPU)
    want = jdecode.decode_tile(ref.words, ref.npoints, ref.window,
                               int(ref.time_unit))
    for a, b in zip(got, want):
        assert same_bits(a, b)


def test_decode_segment_groups_bit_identical():
    segs = []
    for seed, s, w, hostile in (CASES[0], CASES[1], CASES[2], CASES[3]):
        ref = jblock.encode_block(T0_BLOCK, *dense_tiles(seed, s, w, hostile))
        # 5 + 3 rows of window 8 and 17 + 15 of window 64: one pow2 batch
        # of each geometry.
        for r in range(min(ref.num_series, {5: 5, 8: 3, 17: 17, 21: 15}[s])):
            segs.append({"words": ref.words[r], "npoints": int(ref.npoints[r]),
                         "window": ref.window,
                         "time_unit": int(ref.time_unit)})
    segs.append({"words": segs[0]["words"], "npoints": 0, "window": 8})
    got = pdecode.decode_segment_groups(segs, device=CPU)
    want = jdecode.decode_segment_groups(segs)
    assert len(got) == len(want) == len(segs)
    for (gt, gv), (wt, wv) in zip(got, want):
        assert same_bits(gt, wt) and same_bits(gv, wv)


@pytest.mark.parametrize("strategy", list(pdecode.ConflictStrategy))
def test_merge_replica_points_matches_reference(strategy, rng):
    parts_t = [np.sort(rng.integers(0, 30, 25)) for _ in range(3)]
    parts_v = [rng.integers(0, 4, 25).astype(np.float64) for _ in range(3)]
    got = pdecode.merge_replica_points(parts_t, parts_v, strategy)
    want = jdecode.merge_replica_points(
        parts_t, parts_v, jdecode.ConflictStrategy(strategy.value))
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])


# -------------------------------------------------------------- conversion


@pytest.mark.parametrize("seed,s,w,hostile", CASES[:4])
def test_convert_sealed_block_round_trip(seed, s, w, hostile):
    tiles = dense_tiles(seed, s, w, hostile)
    ref = jblock.encode_block(T0_BLOCK, *tiles)
    blk = convert.sealed_block_to_torch(ref, CPU)
    assert_same_block(blk, ref)
    for a, b in zip(blk.read_all(), ref.read_all()):
        assert same_bits(a, b)
    # Sealed by the port, read back by the reference.
    own = pblock.encode_block(T0_BLOCK, *tiles, device=CPU)
    kw = convert.sealed_block_to_numpy(own)
    back = jblock.SealedBlock(**dict(kw, time_unit=jxtime.Unit(kw["time_unit"])))
    assert_same_block(own, back)
    for a, b in zip(back.read_all(), own.read_all()):
        assert same_bits(a, b)
    again = convert.sealed_block_to_torch(back, CPU)
    assert_same_block(again, back)
    assert again.gen != own.gen


def test_reference_block_loads_into_a_port_shard():
    db, _, _ = make_dbs(num_shards=1)
    shard = db.namespace(b"default").shards[0]
    idx = [shard.registry.get_or_create(b"s-%d" % i)[0] for i in range(5)]
    ref = jblock.encode_block(T0_BLOCK, np.array(idx, np.int32),
                              *dense_tiles(31, 5, 8)[1:])
    shard.load_block(convert.sealed_block_to_torch(ref, CPU))
    for i in idx:
        t, v = shard.read(b"s-%d" % i, T0_BLOCK, T0_BLOCK + BLOCK)
        wt, wv = ref.read(i)
        assert same_bits(t, wt) and same_bits(v, wv)
