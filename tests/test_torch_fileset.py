"""The port's filesets, blooms, index segments and wire codec
(m3_tpu_torch.persist.fs, utils.bloom, index.persist, rpc.wire) against
the reference's, on the CPU (the hash kernel's plain version hashes the
blooms).

For the same SealedBlock (sealed by the reference and carried over with
convert.sealed_block_to_torch) and the same registry, the port's seven
fileset files are byte-identical to the reference's, the bloom included;
each package's FilesetReader and Seeker read the other's filesets to equal
blocks and rows; corruption is detected exactly where the reference
detects it; index segments and wire values cross both ways. Every
comparison is exact (bytes, u32 words, f64 bit patterns)."""

import json
import os
import shutil

import numpy as np
import pytest

from m3_tpu.index import persist as jidx_persist
from m3_tpu.index.segment import Document as JDocument
from m3_tpu.index.segment import ImmutableSegment as JImmutableSegment
from m3_tpu.index.segment import MutableSegment as JMutableSegment
from m3_tpu.persist import fs as jfs
from m3_tpu.rpc import wire as jwire
from m3_tpu.storage import block as jblock
from m3_tpu.storage.series import SeriesRegistry as JSeriesRegistry
from m3_tpu.utils import bloom as jbloom
from m3_tpu_torch import convert
from m3_tpu_torch.index import persist as idx_persist
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.index.segment import (Document, ImmutableSegment,
                                        MutableSegment, execute)
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist import fs as pfs
from m3_tpu_torch.persist.diskio import CorruptionError
from m3_tpu_torch.rpc import wire
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.mediator import Mediator
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.series import SeriesRegistry
from m3_tpu_torch.testing import hostile_block, prometheus_ids
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.bloom import BloomFilter

CPU = "cpu"
NS = b"default"
BLOCK = 2 * xtime.HOUR
T0 = 1_600_000_000 * xtime.SECOND - (1_600_000_000 * xtime.SECOND) % BLOCK
FILES = (pfs.INFO_FILE, pfs.DATA_FILE, pfs.INDEX_FILE, pfs.SUMMARIES_FILE,
         pfs.BLOOM_FILE, pfs.DIGEST_FILE, pfs.CHECKPOINT_FILE)


def _regular(rng, n, w):
    ts = (T0 + np.arange(w, dtype=np.int64)[None, :] * 10 * xtime.SECOND
          + np.zeros((n, 1), np.int64))
    vals = rng.integers(0, 50, size=(n, w)).astype(np.float64)
    return ts, vals, np.full(n, w, np.int32)


def _pair(case, seed):
    """(reference block, the same block in the port, ids, both
    registries). Ids are registered in a shuffled order, so index rows
    and registry order differ."""
    rng = np.random.default_rng(seed)
    if case == "regular":
        n, w = 12, 9
        ts, vals, npts = _regular(rng, n, w)
        ids = [b"fz.%d" % i for i in range(n)]
    else:
        n, w = 40, 24
        ts, vals, npts = hostile_block(seed, n, w)
        ids = prometheus_ids(n, rng)
    jblk = jblock.encode_block(T0, np.arange(n, dtype=np.int32), ts, vals, npts)
    blk = convert.sealed_block_to_torch(jblk, CPU)
    reg, jreg = SeriesRegistry(), JSeriesRegistry()
    for i in rng.permutation(n):
        reg.get_or_create(ids[i])
        jreg.get_or_create(ids[i])
    # Both blocks index rows by registry index.
    order = np.array([reg.get(sid) for sid in ids], np.int32)
    jblk.series_indices = order.copy()
    blk.series_indices = order.copy()
    return jblk, blk, ids, reg, jreg


def _read_files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in FILES}


def _same_blocks(a, b):
    assert np.asarray(a.words).tobytes() == np.asarray(b.words).tobytes()
    for f in ("nbits", "npoints", "series_indices"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert (a.block_start, a.window, int(a.time_unit), a.checksum) == \
        (b.block_start, b.window, int(b.time_unit), b.checksum)


CASES = [("regular", 11), ("regular", 12), ("hostile", 13), ("hostile", 14)]


@pytest.mark.parametrize("case,seed", CASES)
def test_fileset_files_byte_identical(tmp_path, case, seed):
    jblk, blk, _ids, reg, jreg = _pair(case, seed)
    path = pfs.PersistManager(str(tmp_path / "port")).write_block(
        NS, 3, blk, reg)
    jpath = jfs.PersistManager(str(tmp_path / "ref")).write_block(
        NS, 3, jblk, jreg)
    assert os.path.relpath(path, str(tmp_path / "port")) == \
        os.path.relpath(jpath, str(tmp_path / "ref"))
    assert _read_files(path) == _read_files(jpath)
    snap = pfs.PersistManager(str(tmp_path / "port")).write_snapshot(
        NS, 3, blk, reg, 7, wal_position=(2, 4096))
    jsnap = jfs.PersistManager(str(tmp_path / "ref")).write_snapshot(
        NS, 3, jblk, jreg, 7, wal_position=(2, 4096))
    assert _read_files(snap) == _read_files(jsnap)
    assert pfs.FilesetReader(jsnap, device=CPU).wal_position() == (2, 4096)


@pytest.mark.parametrize("case,seed", CASES)
def test_each_package_reads_the_others_filesets(tmp_path, case, seed):
    jblk, blk, ids, reg, jreg = _pair(case, seed)
    path = pfs.PersistManager(str(tmp_path / "port")).write_block(
        NS, 1, blk, reg)
    jpath = jfs.PersistManager(str(tmp_path / "ref")).write_block(
        NS, 1, jblk, jreg)
    reader = pfs.FilesetReader(jpath, device=CPU)
    reader.verify_rows()
    got, got_ids = reader.to_block()
    jreader = jfs.FilesetReader(path)
    jreader.verify_rows()
    want, want_ids = jreader.to_block()
    assert got_ids == want_ids
    _same_blocks(got, want)
    for a, b in zip(got.read_all(), want.read_all()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert np.array_equal(got.expected_row_sums, want.expected_row_sums)
    sk, jsk = pfs.Seeker(jpath), jfs.Seeker(path)
    for sid in ids + [b"never-written"]:
        a, b = sk.seek(sid), jsk.seek(sid)
        if b is None:
            assert a is None
            continue
        assert a[0].tobytes() == b[0].tobytes() and a[1:] == b[1:]


def test_bloom_bytes_equal_reference(rng):
    ids = prometheus_ids(3000, rng) + [b"", b"a", b"ab", b"abc", b"x" * 300]
    bf = BloomFilter.for_capacity(len(ids))
    bf.add_batch(ids, device=CPU)
    jbf = jbloom.BloomFilter.for_capacity(len(ids))
    jbf.add_batch(ids)
    assert (bf.m, bf.k) == (jbf.m, jbf.k)
    assert bf.tobytes() == jbf.tobytes()
    assert all(sid in bf for sid in ids)
    one = BloomFilter(bf.m, bf.k)
    for sid in ids:
        one.add(sid)
    assert one.tobytes() == bf.tobytes()
    back = BloomFilter.frombytes(bf.tobytes(), bf.m, bf.k)
    assert back.tobytes() == bf.tobytes()


# ---------------------------------------------------------------------------
# verification (the reference's tests/test_durability.py:258-450)
# ---------------------------------------------------------------------------


def _mk_fileset(root, seed):
    _jblk, blk, ids, reg, _jreg = _pair("regular", seed)
    return pfs.PersistManager(root).write_block(NS, 1, blk, reg), ids


def _rechain(path, name):
    """Recompute the digest chain around an edited component so the
    file-level checks pass."""
    digests = json.load(open(os.path.join(path, pfs.DIGEST_FILE)))
    digests[name] = pfs._adler(os.path.join(path, name))
    with open(os.path.join(path, pfs.DIGEST_FILE), "w") as f:
        json.dump(digests, f)
    with open(os.path.join(path, pfs.CHECKPOINT_FILE), "w") as f:
        json.dump({"digest": pfs._adler(os.path.join(path, pfs.DIGEST_FILE))},
                  f)


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_one_byte_corruption_detected(tmp_path, seed):
    """One flipped byte in one component file is detected wherever the
    reference detects it: incomplete, raising reader, or raising
    verification, in both packages alike."""
    rng = np.random.default_rng(seed)
    path, _ = _mk_fileset(str(tmp_path), seed)
    names = sorted(os.listdir(path))
    fpath = os.path.join(path, names[int(rng.integers(len(names)))])
    data = bytearray(open(fpath, "rb").read())
    i = int(rng.integers(0, len(data)))
    data[i] ^= int(rng.integers(1, 256))
    with open(fpath, "wb") as f:
        f.write(bytes(data))
    assert pfs.fileset_complete(path) == jfs.fileset_complete(path)
    if not pfs.fileset_complete(path):
        return
    outcomes = []
    for mod, kw in ((pfs, {"device": CPU}), (jfs, {})):
        try:
            reader = mod.FilesetReader(path, verify=True, **kw)
            reader.verify_rows()
            reader.to_block()
            outcomes.append(None)
        except (ValueError, KeyError, OSError, IndexError) as e:
            outcomes.append(type(e).__name__)
    assert outcomes[0] is not None and outcomes[0] == outcomes[1]


def test_row_checksums_vectorized_match_entries(tmp_path):
    path, _ = _mk_fileset(str(tmp_path), 3)
    reader = pfs.FilesetReader(path, device=CPU)
    reader.verify_rows()
    sums = reader.row_checksums()
    assert all(int(sums[e.row]) == e.checksum for e in reader.entries)


def test_row_mismatch_detected_past_digests(tmp_path):
    path, _ = _mk_fileset(str(tmp_path), 4)
    e0 = pfs.FilesetReader(path, device=CPU).entries[0]
    idx_path = os.path.join(path, pfs.INDEX_FILE)
    data = bytearray(open(idx_path, "rb").read())
    data[16] ^= 0xFF
    with open(idx_path, "wb") as f:
        f.write(bytes(data))
    _rechain(path, pfs.INDEX_FILE)
    assert pfs.fileset_complete(path)
    reader = pfs.FilesetReader(path, verify=True, device=CPU)
    with pytest.raises(CorruptionError, match="row checksum mismatch") as ei:
        reader.verify_rows()
    assert reader.entries[0].id == e0.id and ei.value.ids == [e0.id]
    with pytest.raises(IOError, match="row checksum mismatch"):
        jfs.FilesetReader(path).verify_rows()


def test_bloom_divergence_detected(tmp_path):
    path, _ = _mk_fileset(str(tmp_path), 5)
    bloom_path = os.path.join(path, pfs.BLOOM_FILE)
    data = bytearray(open(bloom_path, "rb").read())
    data[0] ^= 0x01
    with open(bloom_path, "wb") as f:
        f.write(bytes(data))
    _rechain(path, pfs.BLOOM_FILE)
    with pytest.raises(IOError, match="bloom"):
        pfs.FilesetReader(path, device=CPU).verify_rows()
    with pytest.raises(IOError, match="bloom"):
        jfs.FilesetReader(path).verify_rows()


def test_tmp_fileset_residue_ignored_and_cleaned(tmp_path):
    root = str(tmp_path)
    path, _ = _mk_fileset(root, 6)
    shutil.copytree(path, path + ".tmp")
    pm = pfs.PersistManager(root)
    assert [p for _bs, p in pm.list_filesets(NS, 1)] == [path]
    assert pm.list_snapshots(NS, 1) == []
    db = Database(ShardSet(2), clock=lambda: T0, device=CPU)
    db.create_namespace(NS, NamespaceOptions(index_enabled=False))
    Mediator(db, pm).cleanup(T0)
    assert not os.path.exists(path + ".tmp") and os.path.exists(path)
    assert [p for _bs, p in pm.list_filesets(NS, 1)] == [path]


def test_quarantine_listing_and_clearing(tmp_path):
    root = str(tmp_path)
    path, _ = _mk_fileset(root, 7)
    pm, jpm = pfs.PersistManager(root), jfs.PersistManager(root)
    dst = pfs.quarantine_fileset(path, reason="test", rows=[1], ids=[b"a"])
    assert dst is not None and not os.path.exists(path)
    assert pm.list_quarantined(NS, 1) == jpm.list_quarantined(NS, 1) == \
        [(T0, dst)]
    assert json.load(open(dst + ".json"))["rows"] == [1]
    assert pm.list_filesets(NS, 1) == []
    assert pm.shards_with_data(NS) == jpm.shards_with_data(NS) == [1]
    assert pm.clear_quarantined(NS, 1, T0) is True
    assert pm.list_quarantined(NS, 1) == []
    assert pm.clear_quarantined(NS, 1, T0) is False


@pytest.mark.parametrize("region", [pfs.INDEX_FILE, pfs.DATA_FILE,
                                    pfs.BLOOM_FILE, pfs.CHECKPOINT_FILE])
@pytest.mark.parametrize("seed", [21, 22])
def test_detect_or_serve_correct(tmp_path, region, seed):
    """One flipped byte in one named region, read through the lazy serve
    path (verify=False reader -> row verification on first read, and the
    Seeker): every read raises typed or returns the written data."""
    rng = np.random.default_rng(seed)
    path, _ = _mk_fileset(str(tmp_path), seed)
    clean_blk, clean_ids = pfs.FilesetReader(path, device=CPU).to_block()
    truth = clean_blk.read_all()
    sk0 = pfs.Seeker(path)
    truth_rows = {sid: sk0.seek(sid) for sid in clean_ids}
    fpath = os.path.join(path, region)
    data = bytearray(open(fpath, "rb").read())
    i = int(rng.integers(0, len(data)))
    data[i] ^= int(rng.integers(1, 256))
    with open(fpath, "wb") as f:
        f.write(bytes(data))
    if not pfs.fileset_complete(path):
        return
    typed = (CorruptionError, ValueError, KeyError, OSError, IndexError)
    try:
        blk, ids = pfs.FilesetReader(path, verify=False, device=CPU).to_block()
        got = blk.read_all()
    except typed:
        pass
    else:
        assert list(ids) == list(clean_ids)
        for a, b in zip(got, truth):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    try:
        sk = pfs.Seeker(path)
        for sid in clean_ids:
            got = sk.seek(sid)
            assert got is not None
            assert got[0].tobytes() == truth_rows[sid][0].tobytes()
            assert got[1:] == truth_rows[sid][1:]
    except typed:
        pass


def test_incomplete_fileset_refused(tmp_path):
    path, _ = _mk_fileset(str(tmp_path), 8)
    os.remove(os.path.join(path, pfs.CHECKPOINT_FILE))
    with pytest.raises(FileNotFoundError):
        pfs.FilesetReader(path, device=CPU)
    assert pfs.PersistManager(str(tmp_path)).list_filesets(NS, 1) == []


# ---------------------------------------------------------------------------
# index segments and the wire codec
# ---------------------------------------------------------------------------


def _docs(n=20):
    return [(b"series-%d" % i, ((b"dc", b"east" if i % 2 else b"west"),
                                (b"host", b"h%d" % (i % 5))))
            for i in range(n)]


def _segments(n=20):
    seg, jseg = MutableSegment(), JMutableSegment()
    for sid, fields in _docs(n):
        seg.insert(Document(sid, fields))
        jseg.insert(JDocument(sid, fields))
    return (ImmutableSegment.from_mutable(seg),
            JImmutableSegment.from_mutable(jseg))


QUERIES = [iq.new_term(b"dc", b"east"), iq.new_regexp(b"host", b"h[12]"),
           iq.new_conjunction(iq.new_term(b"dc", b"west"),
                              iq.new_term(b"host", b"h0"))]


def _ids(seg, q):
    return sorted(seg.doc(int(p)).id for p in execute(seg, q))


def test_index_segments_cross_both_ways(tmp_path):
    seg, jseg = _segments()
    d = idx_persist.write_segment(str(tmp_path / "port"), NS, T0, seg)
    jd = jidx_persist.write_segment(str(tmp_path / "ref"), NS, T0, jseg)
    for name in ("segment.bin", "digest", "checkpoint"):
        assert open(os.path.join(d, name), "rb").read() == \
            open(os.path.join(jd, name), "rb").read(), name
    from_ref = idx_persist.read_segment(str(tmp_path / "ref"), NS, T0)
    jfrom_port = jidx_persist.read_segment(str(tmp_path / "port"), NS, T0)
    assert [tuple(doc) for doc in from_ref._docs] == \
        [tuple(doc) for doc in jfrom_port._docs]
    for q in QUERIES:
        assert _ids(from_ref, q) == _ids(seg, q)
    assert idx_persist.list_segments(str(tmp_path / "ref"), NS) == [T0]


def test_index_segment_digest_and_checkpoint(tmp_path):
    seg, _ = _segments(5)
    d = idx_persist.write_segment(str(tmp_path), NS, T0, seg)
    with open(os.path.join(d, "segment.bin"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff")
    with pytest.raises(IOError):
        idx_persist.read_segment(str(tmp_path), NS, T0)
    os.unlink(os.path.join(d, "checkpoint"))
    with pytest.raises(IOError):
        idx_persist.read_segment(str(tmp_path), NS, T0)
    assert idx_persist.list_segments(str(tmp_path), NS) == []


WIRE_VALUES = [
    None, True, False, 0, -1, 2**62, 1.5, -0.0, float("inf"), b"", b"\x00\xff",
    "téxt", [1, [2, [3, None]]], {b"k": [b"v", 1.0], "s": {}},
    np.arange(12, dtype=np.int64).reshape(3, 4),
    np.array([1.5, np.nan, -0.0], np.float64),
    np.array([[7, 8]], np.uint32), np.zeros((0, 3), np.int32),
    {"block_start": T0, "docs": [{"id": b"a", "tags": b"\x01"}],
     "fields": {b"f": {"terms": [b"x"], "offsets": np.array([0, 1]),
                       "postings": np.array([0], np.int32)}}},
]


def _same_value(a, b):
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(_same_value(a[k], b[k]) for k in b))
    if isinstance(b, list):
        return (isinstance(a, list) and len(a) == len(b)
                and all(_same_value(x, y) for x, y in zip(a, b)))
    if isinstance(b, float):
        return isinstance(a, float) and np.float64(a).tobytes() == \
            np.float64(b).tobytes()
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("value", WIRE_VALUES,
                         ids=[str(i) for i in range(len(WIRE_VALUES))])
def test_wire_codec_round_trips_the_references_values(value):
    buf = jwire.encode(value)
    got = wire.decode(buf)
    assert _same_value(got, jwire.decode(buf))
    assert wire.encode(got) == buf == wire.encode(value)


def test_wire_codec_rejects_what_the_reference_rejects():
    buf = jwire.encode({b"k": [1, 2, 3]})
    for bad in (buf[:-3], buf + b"\x00", b"\x7f"):
        with pytest.raises(ValueError):
            jwire.decode(bad)
        with pytest.raises(ValueError):
            wire.decode(bad)
    deep = []
    for _ in range(wire.MAX_DEPTH + 2):
        deep = [deep]
    with pytest.raises(ValueError):
        wire.encode(deep)
    with pytest.raises(TypeError):
        wire.encode(object())
    assert issubclass(wire.WireTruncated, ConnectionError)
