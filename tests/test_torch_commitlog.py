"""The port's commit log (m3_tpu_torch.persist.commitlog) against the
reference's (m3_tpu.persist.commitlog): the same writes, tags and clock
give byte-identical files; each package replays the other's files to
equal entries; torn, truncated, corrupted and foreign files behave as the
reference's do; and the batched replay equals the retained per-entry
oracle `replay_ref`.

The WAL is host code with a fixed binary format, so every comparison is
exact: bytes, entries, tags and chunk positions, values compared as their
f64 bit patterns (-0.0, infinities and NaN payloads count)."""

import os
import struct
import zlib

import numpy as np
import pytest

from m3_tpu.persist import commitlog as jcl
from m3_tpu_torch.persist import commitlog as cl

FAKE_T0 = 1_700_000_000_000_000_000
SPECIAL = [-0.0, float("inf"), -float("inf"),
           struct.unpack("<d", struct.pack("<Q", 0x7FF8_0000_0000_0BAD))[0],
           5e-324, 1.5]


class _Clock:
    def __init__(self):
        self.t = FAKE_T0

    def __call__(self):
        return self.t


def _schedule(seed, n=160):
    """A seeded script of WAL operations: single and batched writes over
    three namespaces and eight series (some tagged, some str-tagged, one
    with hopeless tags), explicit flushes, clock steps and rotations."""
    rng = np.random.default_rng(seed)
    ops = []
    for seq in range(n):
        ns = b"ns%d" % rng.integers(3)
        sid = b"s%d" % rng.integers(8)
        kind = rng.random()
        if kind < 0.25:
            tags = {b"__name__": b"m", b"host": sid}
        elif kind < 0.3:
            tags = {"host": "h%d" % rng.integers(3)}
        elif kind < 0.32:
            tags = {b"k": object()}
        else:
            tags = None
        value = (SPECIAL[seq % len(SPECIAL)] if rng.random() < 0.2
                 else float(rng.standard_normal()))
        if rng.random() < 0.15:
            k = int(rng.integers(2, 6))
            ops.append(("batch", ns, [b"s%d" % rng.integers(8) for _ in range(k)],
                        np.arange(seq, seq + k, dtype=np.int64),
                        rng.standard_normal(k),
                        [tags] * k if tags is not None else None))
        else:
            ops.append(("write", ns, sid, seq, value, tags))
        r = rng.random()
        if r < 0.08:
            ops.append(("flush",))
        elif r < 0.14:
            ops.append(("rotate",))
        elif r < 0.3:
            ops.append(("tick", int(rng.integers(1, 4)) * 400_000_000))
    return ops


def _run(mod, d, ops, strategy):
    clock = _Clock()
    log = mod.CommitLog(d, strategy=strategy, clock=clock)
    for op in ops:
        if op[0] == "write":
            log.write(*op[1:])
        elif op[0] == "batch":
            log.write_batch(*op[1:])
        elif op[0] == "flush":
            log.flush()
        elif op[0] == "rotate":
            log.rotate()
        else:
            clock.t += op[1]
    position = log.position()
    log.close()
    return position


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _entries(mod, d):
    return [(ns, sid, int(t), struct.pack("<d", v))
            for ns, sid, t, v in mod.replay(d)]


def _batches(mod, d):
    out = []
    for b in mod.replay_batches(d):
        out.append((b.file_num, b.end_offset, list(b.namespaces), list(b.ids),
                    b.t_ns.tobytes(), b.values.tobytes(), list(b.tags)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("strategy", ["WRITE_WAIT", "WRITE_BEHIND"])
def test_files_byte_identical_to_reference(tmp_path, seed, strategy):
    ops = _schedule(seed)
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    pos = _run(cl, pd, ops, cl.Strategy[strategy])
    jpos = _run(jcl, jd, ops, jcl.Strategy[strategy])
    assert pos == jpos
    assert _files(pd) == _files(jd)
    assert len(_files(pd)) > 1


@pytest.mark.parametrize("seed", [4, 5])
def test_each_package_replays_the_others_files(tmp_path, seed):
    ops = _schedule(seed)
    pd, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    _run(cl, pd, ops, cl.Strategy.WRITE_BEHIND)
    _run(jcl, jd, ops, jcl.Strategy.WRITE_BEHIND)
    want = _entries(jcl, jd)
    assert len(want) > 100
    assert _entries(cl, jd) == want          # the port reads the reference's
    assert _entries(jcl, pd) == want         # and the reference the port's
    assert _entries(cl, pd) == want
    assert _batches(cl, jd) == _batches(jcl, jd)
    assert _batches(jcl, pd) == _batches(cl, pd)
    ref = [(ns, sid, int(t), struct.pack("<d", v))
           for ns, sid, t, v in jcl.replay_ref(pd)]
    assert [(ns, sid, int(t), struct.pack("<d", v))
            for ns, sid, t, v in cl.replay_ref(jd)] == ref == want


# ---------------------------------------------------------------------------
# the reference's replay contracts (tests/test_durability.py:78-270)
# ---------------------------------------------------------------------------


def _write_log(mod, d, rng, n_entries=120, rotate_p=0.12):
    log = mod.CommitLog(d, strategy=mod.Strategy.WRITE_WAIT)
    per_file = [[]]
    for seq in range(n_entries):
        entry = (b"ns%d" % rng.integers(3), b"s%d" % rng.integers(8),
                 int(seq), float(seq))
        log.write(*entry[:2], entry[2], entry[3])
        per_file[-1].append(entry)
        if rng.random() < rotate_p:
            log.rotate()
            per_file.append([])
    log.close()
    return per_file


def _run_iter(gen):
    out = []
    try:
        for e in gen:
            out.append(e)
        return out, None
    except Exception as e:  # noqa: BLE001 — equality of failure is the point
        return out, type(e).__name__


def _corrupt(path, rng):
    data = bytearray(open(path, "rb").read())
    kind = ["truncate", "flip", "insert", "delete"][int(rng.integers(4))]
    if not data:
        kind = "insert"
    if kind == "truncate":
        data = data[: int(rng.integers(0, len(data)))]
    elif kind == "flip":
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(0, len(data)))
            data[i] ^= int(rng.integers(1, 256))
    elif kind == "insert":
        i = int(rng.integers(0, len(data) + 1))
        junk = bytes(rng.integers(0, 256, int(rng.integers(1, 17)),
                                  dtype=np.uint8))
        data = bytes(data[:i]) + junk + bytes(data[i:])
    else:
        i = int(rng.integers(0, len(data)))
        j = int(rng.integers(i + 1, min(len(data), i + 64) + 1))
        data = data[:i] + data[j:]
    with open(path, "wb") as f:
        f.write(bytes(data))


def _flat(mod, d):
    return [(ns, sid, int(t), float(v))
            for b in mod.replay_batches(d)
            for ns, sid, t, v in zip(b.namespaces, b.ids, b.t_ns, b.values)]


def test_torn_tail_chunk_dropped(tmp_path, rng):
    d = str(tmp_path)
    want = _write_log(cl, d, rng, rotate_p=0.0)[0]
    fname = sorted(os.listdir(d))[-1]
    with open(os.path.join(d, fname), "ab") as f:
        f.write(cl._CHUNK_HEADER.pack(512, 0xBAD) + b"x" * 24)
    for mod in (cl, jcl):
        assert list(mod.replay(d)) == want
        assert list(mod.replay_ref(d)) == want
        assert _flat(mod, d) == want


def test_mid_file_truncation_keeps_prefix(tmp_path, rng):
    d = str(tmp_path)
    per_file = _write_log(cl, d, rng, n_entries=40, rotate_p=0.0)
    path = os.path.join(d, sorted(os.listdir(d))[-1])
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) - 11)
    got = list(cl.replay(d))
    assert got == per_file[0][: len(got)] and len(got) < len(per_file[0])
    assert got == list(jcl.replay(d))


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_corruption_batched_vs_ref_bit_identity(tmp_path, seed):
    """One corrupted file per round: the port's batched decoder yields the
    same entries and fails the same way as its per-entry oracle and as
    both of the reference's replays."""
    rng = np.random.default_rng(seed)
    d = str(tmp_path)
    per_file = _write_log(cl, d, rng)
    files = sorted(f for f in os.listdir(d) if f.startswith("commitlog-"))
    assert len(files) == len(per_file)
    k = int(rng.integers(len(files)))
    _corrupt(os.path.join(d, files[k]), rng)
    ref = _run_iter(cl.replay_ref(d))
    assert _run_iter(cl.replay(d)) == ref
    assert _run_iter(jcl.replay(d)) == ref == _run_iter(jcl.replay_ref(d))
    pre = [e for i, f in enumerate(per_file) if i < k for e in f]
    assert ref[0][: len(pre)] == pre or ref[1] is not None


def test_str_tags_never_abort_the_append(tmp_path):
    d = str(tmp_path)
    log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_WAIT)
    log.write(b"ns", b"s1", 1, 1.0, tags={"host": "a"})
    log.write(b"ns", b"s2", 2, 2.0, tags={b"k": object()})
    log.close()
    batches = list(cl.replay_batches(d))
    assert [(sid, t.item()) for b in batches
            for sid, t in zip(b.ids, b.t_ns)] == [(b"s1", 1), (b"s2", 2)]
    tags = {sid: tg for b in batches for sid, tg in zip(b.ids, b.tags)}
    assert tags[b"s1"] == {b"host": b"a"} and tags[b"s2"] is None
    jtags = {sid: tg for b in jcl.replay_batches(d)
             for sid, tg in zip(b.ids, b.tags)}
    assert jtags == tags


def test_tagged_write_after_untagged_first_sighting(tmp_path):
    d = str(tmp_path)
    log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_WAIT)
    log.write(b"ns", b"s1", 1, 1.0)
    log.write(b"ns", b"s1", 2, 2.0, tags={b"k": b"v"})
    log.write(b"ns", b"s1", 3, 3.0)
    log.close()
    assert list(cl.replay(d)) == [(b"ns", b"s1", 1, 1.0),
                                  (b"ns", b"s1", 2, 2.0),
                                  (b"ns", b"s1", 3, 3.0)]
    per_entry = [tg for b in cl.replay_batches(d) for tg in b.tags]
    assert per_entry == [None, {b"k": b"v"}, {b"k": b"v"}]
    assert per_entry == [tg for b in jcl.replay_batches(d) for tg in b.tags]


def test_unrecognized_format_file_skipped_not_misparsed(tmp_path, rng):
    d = str(tmp_path)
    per_file = _write_log(cl, d, rng, n_entries=20, rotate_p=0.0)
    body = cl._DATA_ENTRY.pack(1, 0, 5, 5.0)
    with open(os.path.join(d, "commitlog-00000099.bin"), "wb") as f:
        f.write(cl._CHUNK_HEADER.pack(len(body), zlib.adler32(body)))
        f.write(body)
    for mod in (cl, jcl):
        assert list(mod.replay(d)) == per_file[0]
        assert list(mod.replay_ref(d)) == per_file[0]


def test_streaming_positions_and_wrapper_types(tmp_path, rng):
    d = str(tmp_path)
    _write_log(cl, d, rng, n_entries=30, rotate_p=0.3)
    batches = list(cl.replay_batches(d))
    by_file = {}
    for b in batches:
        assert b.end_offset > by_file.get(b.file_num, 0)
        by_file[b.file_num] = b.end_offset
    for b in batches:
        assert b.before((b.file_num, b.end_offset))
        assert not b.before((b.file_num, b.end_offset - 1))
        assert b.before((b.file_num + 1, 0))
        assert not b.before(None)
    assert [(b.file_num, b.end_offset) for b in batches] == \
        [(b.file_num, b.end_offset) for b in jcl.replay_batches(d)]
    for _ns, _sid, t, v in cl.replay(d):
        assert type(t) is int and type(v) is float
        break


def test_position_rotation_and_cleanup_match_reference(tmp_path):
    """position() flushes and lands on a chunk boundary, rotate() returns
    the old file number, remove_files_before() drops older files — the
    same numbers and files in both packages."""
    out = {}
    for name, mod in (("port", cl), ("ref", jcl)):
        d = str(tmp_path / name)
        log = mod.CommitLog(d)
        log.write(b"ns", b"a", 1, 1.0)
        p1 = log.position()
        old = log.rotate()
        log.write(b"ns", b"b", 2, 2.0)
        p2 = log.position()
        log.rotate()
        log.write(b"ns", b"c", 3, 3.0)
        log.remove_files_before(p2[0])
        log.close()
        out[name] = (p1, old, p2, [os.path.basename(f) for f in log.files()],
                     list(mod.replay(d)))
    assert out["port"] == out["ref"]
    assert out["port"][3] == ["commitlog-00000001.bin", "commitlog-00000002.bin"]


def test_closed_log_refuses_writes(tmp_path):
    log = cl.CommitLog(str(tmp_path))
    log.close()
    with pytest.raises(ValueError, match="closed"):
        log.write(b"ns", b"a", 1, 1.0)
    with pytest.raises(ValueError, match="closed"):
        log.position()
