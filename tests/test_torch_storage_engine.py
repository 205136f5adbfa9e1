"""Port of tests/test_storage_engine.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Storage engine: buffer, blocks, shard/namespace/database lifecycle
(reference behaviors from src/dbnode/storage)."""

import numpy as np
import pytest

from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.storage.block import WiredList, encode_block
from m3_tpu_torch.storage.buffer import ShardBuffer, dedup_sorted, to_dense
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hashing import hash_batch, murmur3_32
from test_torch_cpu_default import cpu_default  # noqa: F401

BLOCK = 2 * xtime.HOUR
T0 = 1_600_000_000 * xtime.SECOND
T0_BLOCK = T0 - T0 % BLOCK


def make_db(num_shards=8):
    now = {"t": T0}
    db = Database(ShardSet(num_shards), clock=lambda: now["t"])
    db.create_namespace(b"default", NamespaceOptions(index_enabled=False))
    return db, now


def test_murmur3_reference_vectors():
    # Standard MurmurHash3 x86-32 test vectors.
    assert murmur3_32(b"") == 0
    assert murmur3_32(b"", seed=1) == 0x514E28B7
    assert murmur3_32(b"hello") == 0x248BFA47
    assert murmur3_32(b"hello, world") == 0x149BBB7F
    assert murmur3_32(b"The quick brown fox jumps over the lazy dog") == 0x2E4FF723


def test_hash_batch_matches_scalar(rng):
    ids = [bytes(rng.integers(0, 256, size=rng.integers(0, 40), dtype=np.uint8)) for _ in range(200)]
    got = hash_batch(ids)
    want = np.array([murmur3_32(i) for i in ids], np.uint32)
    np.testing.assert_array_equal(got, want)


def test_dedup_last_arrival_wins():
    sidx = np.array([0, 0, 0, 1], np.int32)
    ts = np.array([10, 5, 10, 7], np.int64)
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    s, t, v = dedup_sorted(sidx, ts, vals)
    np.testing.assert_array_equal(t, [5, 10, 7])
    np.testing.assert_array_equal(v, [2.0, 3.0, 4.0])  # 3.0 arrived after 1.0


def test_buffer_out_of_order_and_read():
    buf = ShardBuffer(BLOCK, 10 * xtime.MINUTE, 2 * xtime.MINUTE)
    base = T0_BLOCK
    buf.write(0, base + 30 * xtime.SECOND, 3.0)
    buf.write(0, base + 10 * xtime.SECOND, 1.0)
    buf.write(0, base + 20 * xtime.SECOND, 2.0)
    t, v = buf.read(0, base, base + xtime.HOUR)
    np.testing.assert_array_equal(v, [1.0, 2.0, 3.0])
    # Range filter.
    t, v = buf.read(0, base + 15 * xtime.SECOND, base + 25 * xtime.SECOND)
    np.testing.assert_array_equal(v, [2.0])


def test_block_encode_decode_roundtrip(rng):
    n, w = 10, 50
    ts = T0_BLOCK + np.arange(w, dtype=np.int64)[None, :] * 10 * xtime.SECOND + np.zeros((n, 1), np.int64)
    vals = rng.integers(0, 100, size=(n, w)).astype(np.float64)
    npoints = np.full(n, w, np.int32)
    blk = encode_block(T0_BLOCK, np.arange(n, dtype=np.int32), ts, vals, npoints)
    got = blk.read(3)
    assert got is not None
    np.testing.assert_array_equal(got[0], ts[3])
    np.testing.assert_allclose(got[1], vals[3])
    assert blk.read(99) is None
    assert blk.checksum != 0


def test_shard_write_seal_read_expire():
    db, now = make_db()
    base = T0_BLOCK
    ids = [f"series-{i}".encode() for i in range(20)]
    for step in range(6):
        t = T0 + step * 10 * xtime.SECOND
        for sid in ids:
            db.write(b"default", sid, t, float(step))
    # Nothing sealed yet.
    assert db.tick()["sealed"] == 0
    t, v = db.read(b"default", ids[0], base, base + BLOCK)
    assert len(v) == 6

    # Advance past block end + buffer_past: seals into device-encoded blocks.
    now["t"] = base + BLOCK + 11 * xtime.MINUTE
    r = db.tick()
    assert r["sealed"] > 0
    t, v = db.read(b"default", ids[0], T0 - xtime.MINUTE, T0 + xtime.HOUR)
    np.testing.assert_array_equal(v, np.arange(6.0))

    # Advance past retention: blocks expire.
    now["t"] = base + 2 * xtime.DAY + BLOCK + xtime.MINUTE
    r = db.tick()
    assert r["expired"] > 0
    t, v = db.read(b"default", ids[0], base, base + BLOCK)
    assert len(v) == 0


def test_shard_rejects_out_of_window_writes():
    db, now = make_db()
    with pytest.raises(ValueError):
        db.write(b"default", b"s", T0 - xtime.DAY, 1.0)
    with pytest.raises(ValueError):
        db.write(b"default", b"s", T0 + xtime.HOUR, 1.0)


def test_write_batch_routes_shards(rng):
    db, now = make_db()
    ids = [f"m-{i}".encode() for i in range(100)]
    ts = np.full(100, T0, np.int64)
    vals = rng.standard_normal(100)
    db.write_batch(b"default", ids, ts, vals)
    for i in (0, 50, 99):
        t, v = db.read(b"default", ids[i], T0 - 1, T0 + 1)
        np.testing.assert_allclose(v, [vals[i]])
    # All shards collectively hold 100 series.
    ns = db.namespace(b"default")
    assert sum(s.num_series() for s in ns.shards.values()) == 100


def test_duplicate_timestamp_last_wins_through_seal():
    db, now = make_db()
    db.write(b"default", b"dup", T0, 1.0)
    db.write(b"default", b"dup", T0, 2.0)
    now["t"] = T0_BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    t, v = db.read(b"default", b"dup", T0 - 1, T0 + 1)
    np.testing.assert_array_equal(v, [2.0])


def test_wired_list_lru_eviction(rng):
    wl = WiredList(max_bytes=1)  # tiny: every put evicts previous
    w = 8
    ts = T0_BLOCK + np.arange(w, dtype=np.int64)[None, :] * xtime.SECOND
    vals = rng.standard_normal((1, w))
    b1 = encode_block(T0_BLOCK, np.array([0], np.int32), ts, vals, np.array([w], np.int32))
    b2 = encode_block(T0_BLOCK + BLOCK, np.array([0], np.int32), ts + BLOCK, vals, np.array([w], np.int32))
    wl.put(("ns", 0, T0_BLOCK), b1)
    wl.put(("ns", 0, T0_BLOCK + BLOCK), b2)
    assert wl.get(("ns", 0, T0_BLOCK)) is None
    assert wl.get(("ns", 0, T0_BLOCK + BLOCK)) is b2
