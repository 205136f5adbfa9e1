"""Port of tests/test_persist.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Persistence: fileset write/read/seek invariants + commitlog WAL replay."""

import os

import numpy as np
import pytest

from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist import commitlog as cl
from m3_tpu_torch.persist.fs import (
    CHECKPOINT_FILE,
    FilesetReader,
    PersistManager,
    Seeker,
    fileset_complete,
)
from m3_tpu_torch.storage.block import encode_block
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.series import SeriesRegistry
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.bloom import BloomFilter
from test_torch_cpu_default import cpu_default  # noqa: F401

BLOCK = 2 * xtime.HOUR
T0 = 1_600_000_000 * xtime.SECOND
T0_BLOCK = T0 - T0 % BLOCK


def make_block(rng, n=12, w=30):
    reg = SeriesRegistry()
    ids = [f"srv.{i}.latency".encode() for i in range(n)]
    for sid in ids:
        reg.get_or_create(sid)
    ts = T0_BLOCK + np.arange(w, dtype=np.int64)[None, :] * 10 * xtime.SECOND + np.zeros((n, 1), np.int64)
    vals = rng.integers(0, 50, size=(n, w)).astype(np.float64)
    blk = encode_block(T0_BLOCK, np.arange(n, dtype=np.int32), ts, vals, np.full(n, w, np.int32))
    return reg, ids, ts, vals, blk


def test_bloom_filter(rng):
    bf = BloomFilter.for_capacity(1000, 0.01)
    items = [f"id-{i}".encode() for i in range(1000)]
    bf.add_batch(items)
    assert all(i in bf for i in items)
    fp = sum(f"other-{i}".encode() in bf for i in range(1000))
    assert fp < 50
    bf2 = BloomFilter.frombytes(bf.tobytes(), bf.m, bf.k)
    assert items[0] in bf2


def test_fileset_roundtrip(tmp_path, rng):
    reg, ids, ts, vals, blk = make_block(rng)
    pm = PersistManager(str(tmp_path))
    path = pm.write_block(b"ns1", 7, blk, reg)
    assert fileset_complete(path)
    assert pm.list_filesets(b"ns1", 7) == [(T0_BLOCK, path)]
    assert pm.shards_with_data(b"ns1") == [7]

    reader = FilesetReader(path)
    blk2, row_ids = reader.to_block()
    assert set(row_ids) == set(ids)
    for row, sid in enumerate(row_ids):
        orig_row = ids.index(sid)
        t, v = blk2.read(row)
        np.testing.assert_array_equal(t, ts[orig_row])
        np.testing.assert_allclose(v, vals[orig_row])


def test_fileset_incomplete_without_checkpoint(tmp_path, rng):
    reg, ids, ts, vals, blk = make_block(rng)
    pm = PersistManager(str(tmp_path))
    path = pm.write_block(b"ns1", 0, blk, reg)
    os.remove(os.path.join(path, CHECKPOINT_FILE))
    assert not fileset_complete(path)
    with pytest.raises(FileNotFoundError):
        FilesetReader(path)
    assert pm.list_filesets(b"ns1", 0) == []


def test_seeker_bloom_and_lookup(tmp_path, rng):
    reg, ids, ts, vals, blk = make_block(rng)
    pm = PersistManager(str(tmp_path))
    path = pm.write_block(b"ns1", 1, blk, reg)
    seeker = Seeker(path)
    row = seeker.seek(ids[5])
    assert row is not None
    words, nbits, npoints = row
    assert npoints == 30
    assert seeker.seek(b"nope") is None


def test_snapshot_volumes(tmp_path, rng):
    reg, ids, ts, vals, blk = make_block(rng)
    pm = PersistManager(str(tmp_path))
    pm.write_snapshot(b"ns1", 2, blk, reg, version=1)
    pm.write_snapshot(b"ns1", 2, blk, reg, version=2)
    snaps = pm.list_snapshots(b"ns1", 2)
    assert [(s[0], s[1]) for s in snaps] == [(T0_BLOCK, 1), (T0_BLOCK, 2)]
    assert pm.list_filesets(b"ns1", 2) == []


def test_commitlog_roundtrip_and_torn_tail(tmp_path):
    d = str(tmp_path / "cl")
    log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_WAIT)
    log.write(b"ns1", b"a", 100, 1.5)
    log.write(b"ns1", b"b", 110, 2.5)
    log.write(b"ns2", b"a", 120, 3.5)
    log.rotate()
    log.write(b"ns1", b"a", 130, 4.5)
    log.close()

    entries = list(cl.replay(d))
    assert entries == [
        (b"ns1", b"a", 100, 1.5),
        (b"ns1", b"b", 110, 2.5),
        (b"ns2", b"a", 120, 3.5),
        (b"ns1", b"a", 130, 4.5),
    ]

    # Torn tail: truncate the last file mid-chunk; replay drops only the tail.
    files = sorted(os.listdir(d))
    last = os.path.join(d, files[-1])
    size = os.path.getsize(last)
    with open(last, "ab") as f:
        f.write(b"\x99\x00\x00\x00garbage")
    entries2 = list(cl.replay(d))
    assert entries2 == entries


def test_commitlog_write_behind_flush_on_interval(tmp_path):
    now = {"t": 0}
    d = str(tmp_path / "cl")
    log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_BEHIND,
                       flush_interval_ns=10, clock=lambda: now["t"])
    log.write(b"ns", b"x", 1, 1.0)
    assert list(cl.replay(d)) == []  # buffered, not yet durable
    now["t"] = 20
    log.write(b"ns", b"x", 2, 2.0)  # interval elapsed -> flush
    assert len(list(cl.replay(d))) == 2
    log.close()


def test_database_flush_rotates_commitlog(tmp_path):
    now = {"t": T0}
    log = cl.CommitLog(str(tmp_path / "cl"), strategy=cl.Strategy.WRITE_WAIT)
    db = Database(ShardSet(4), commitlog=log, clock=lambda: now["t"])
    db.create_namespace(b"default", NamespaceOptions(index_enabled=False))
    for i in range(5):
        db.write(b"default", b"metric-a", T0 + i * 10 * xtime.SECOND, float(i))
    now["t"] = T0_BLOCK + BLOCK + 11 * xtime.MINUTE
    db.tick()
    pm = PersistManager(str(tmp_path / "data"))
    n = db.flush(pm)
    assert n == 1
    files = pm.list_filesets(b"default", db.shard_set.lookup(b"metric-a"))
    assert len(files) == 1
    # Commit log rotated after flush.
    assert len(log.files()) == 2
    log.close()
