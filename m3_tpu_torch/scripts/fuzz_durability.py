"""Randomized durability campaign on the port: corrupted bytes must never
surface as data (counterpart of scripts/fuzz_durability.py). Three checks
a round, each on the reference campaign's draws for the same seed:

  commitlog replay   write a stream of unique entries across rotated
                     persist/commitlog files, corrupt ONE file (truncate,
                     xor-flip, insert garbage or delete a slice) and
                     replay: replay never raises, every replayed record is
                     one that was written, every other file replays in
                     full, and the damaged file yields at most an in-order
                     subsequence of its records;
  fileset detection  write a complete persist/fs fileset (sealed by the
                     pack kernel, its bloom hashed by the hash kernel on
                     the card), xor-flip one byte of one of its files: the
                     checkpoint/digest chain or a verifying FilesetReader
                     (which rebuilds the bloom through the hash kernel)
                     must detect it;
  region serve       one flipped byte in one named region (index, data,
                     bloom, checkpoint, summaries), read through the lazy
                     serve paths (a non-verifying reader's block: the
                     row-checksum check and the decode kernel; the
                     Seeker's point lookups): every read raises typed or
                     returns the clean bytes.

A failure raises AssertionError naming its check.

Usage:  python -m m3_tpu_torch.scripts.fuzz_durability --rounds 200
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..device import resolve
from ..ops import kernel_launches
from ..persist import commitlog as cl
from ..persist import fs as pfs
from ..persist.diskio import CorruptionError
from ..persist.fs import FilesetReader, PersistManager, fileset_complete
from ..storage.block import encode_block
from ..storage.series import SeriesRegistry
from ..utils import xtime
from . import device_arg, launches_since, sync

BLOCK = 2 * xtime.HOUR
T0 = 1_600_000_000 * xtime.SECOND - (1_600_000_000 * xtime.SECOND) % BLOCK
REGIONS = ("index", "data", "bloom", "checkpoint", "summaries")
_REGION_FILES = {
    "index": pfs.INDEX_FILE, "data": pfs.DATA_FILE, "bloom": pfs.BLOOM_FILE,
    "checkpoint": pfs.CHECKPOINT_FILE, "summaries": pfs.SUMMARIES_FILE,
}
# What a detected corruption may raise on the read paths.
_DETECTED = (CorruptionError, ValueError, KeyError, OSError, IndexError)


def corrupt(path: str, rng) -> str:
    """Apply one random mutation to the file; returns its kind."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    kind = ["truncate", "flip", "insert", "delete"][rng.integers(4)]
    if not data:
        kind = "insert"
    if kind == "truncate":
        data = data[: rng.integers(0, len(data))]
    elif kind == "flip":
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(0, len(data)))
            data[i] ^= int(rng.integers(1, 256))
    elif kind == "insert":
        i = int(rng.integers(0, len(data) + 1))
        junk = bytes(rng.integers(0, 256, int(rng.integers(1, 17)),
                                  dtype=np.uint8))
        data = data[:i] + junk + data[i:]
    else:  # delete a middle slice (always at least one byte)
        i = int(rng.integers(0, len(data)))
        j = int(rng.integers(i + 1, min(len(data), i + 64) + 1))
        data = data[:i] + data[j:]
    with open(path, "wb") as f:
        f.write(bytes(data))
    return kind


def draw_commitlog(rng, seq_start: int):
    """The commit-log round's writes: (entries by file, rotations after
    each entry); entries are (ns, sid, t, v), globally unique."""
    per_file = [[]]
    seq = seq_start
    for _ in range(int(rng.integers(5, 60))):
        ns = b"ns%d" % rng.integers(3)
        sid = b"s%d" % rng.integers(8)
        per_file[-1].append((ns, sid, int(seq), float(seq)))
        seq += 1
        if rng.random() < 0.15:
            per_file.append([])
    return per_file, seq


def commitlog_round(rng, seq_start: int) -> int:
    d = tempfile.mkdtemp(prefix="m3-fuzz-cl-")
    try:
        log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_WAIT)
        per_file, seq = draw_commitlog(rng, seq_start)
        for i, entries in enumerate(per_file):
            if i:
                log.rotate()
            for ns, sid, t, v in entries:
                log.write(ns, sid, t, v)
        log.close()
        files = sorted(f for f in os.listdir(d) if f.startswith("commitlog-"))
        if len(files) != len(per_file):
            raise AssertionError(f"commitlog replay: {len(files)} files for "
                                 f"{len(per_file)} rotations")
        k = int(rng.integers(len(files)))
        kind = corrupt(os.path.join(d, files[k]), rng)
        try:
            replayed = list(cl.replay(d))
        except Exception as e:  # noqa: BLE001 — the invariant under test
            raise AssertionError(f"commitlog replay: raised after {kind} of "
                                 f"file {k}: {type(e).__name__}: {e}")
        pos = 0
        for i, expected in enumerate(per_file):
            if i != k:
                if replayed[pos: pos + len(expected)] != expected:
                    raise AssertionError(
                        f"commitlog replay: undamaged file {i} diverged "
                        f"after {kind} of file {k}")
                pos += len(expected)
                continue
            want = iter(expected)
            while pos < len(replayed) and replayed[pos] in expected:
                e = replayed[pos]
                if not any(x == e for x in want):
                    raise AssertionError(
                        f"commitlog replay: damaged file {k} replayed out "
                        f"of order after {kind}: {e}")
                pos += 1
        if pos != len(replayed):
            raise AssertionError(
                f"commitlog replay: fabricated records after {kind}: "
                f"{replayed[pos:][:3]}")
        return seq
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _fileset(rng, root: str, prefix: bytes, dev) -> str:
    """A complete fileset of a random small block, written by a
    PersistManager: the pack kernel seals it, the hash kernel builds its
    bloom (on `dev`)."""
    n, w = int(rng.integers(2, 20)), int(rng.integers(4, 40))
    reg = SeriesRegistry()
    for i in range(n):
        reg.get_or_create(prefix + b".%d" % i)
    ts = (T0 + np.arange(w, dtype=np.int64)[None, :] * 10 * xtime.SECOND
          + np.zeros((n, 1), np.int64))
    vals = rng.integers(0, 50, size=(n, w)).astype(np.float64)
    blk = encode_block(T0, np.arange(n, dtype=np.int32), ts, vals,
                       np.full(n, w, np.int32), device=dev)
    path = PersistManager(root).write_block(b"ns", 1, blk, reg)
    if not fileset_complete(path):
        raise AssertionError("fileset detection: a clean fileset is "
                             "incomplete")
    return path


def _flip(path: str, rng) -> int:
    """xor-flip one random byte of `path`; returns its offset, -1 when the
    file is empty."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        return -1
    i = int(rng.integers(0, len(data)))
    data[i] ^= int(rng.integers(1, 256))
    with open(path, "wb") as f:
        f.write(bytes(data))
    return i


def fileset_round(rng, dev) -> str:
    """Returns how the flip was detected."""
    root = tempfile.mkdtemp(prefix="m3-fuzz-fs-")
    try:
        path = _fileset(rng, root, b"fz", dev)
        names = sorted(os.listdir(path))
        fname = names[int(rng.integers(len(names)))]
        i = _flip(os.path.join(path, fname), rng)
        if i < 0:
            return "empty"
        if not fileset_complete(path):
            return "checkpoint"
        try:
            FilesetReader(path, verify=True, device=dev).to_block()
        except _DETECTED:
            return "reader"
        raise AssertionError(f"fileset detection: one-byte corruption of "
                             f"{fname} at {i} read back cleanly")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def region_round(rng, region: str, dev) -> str:
    """Returns the outcome: 'detected' or 'served-correct'."""
    root = tempfile.mkdtemp(prefix="m3-fuzz-region-")
    try:
        path = _fileset(rng, root, b"rz", dev)
        clean_blk, clean_ids = FilesetReader(path, verify=True,
                                             device=dev).to_block()
        truth = clean_blk.read_all()
        sk0 = pfs.Seeker(path)
        truth_rows = {sid: sk0.seek(sid) for sid in clean_ids}
        i = _flip(os.path.join(path, _REGION_FILES[region]), rng)
        if i < 0 or not fileset_complete(path):
            return "detected"
        try:
            got_blk, got_ids = FilesetReader(path, verify=False,
                                             device=dev).to_block()
            got = got_blk.read_all()
        except _DETECTED:
            return "detected"
        if list(got_ids) != list(clean_ids):
            raise AssertionError(f"region serve: {region} flip at {i} "
                                 f"served a different id set")
        for want, have, label in zip(truth, got,
                                     ("timestamps", "values", "npoints")):
            if not np.array_equal(want, have, equal_nan=True):
                raise AssertionError(f"region serve: {region} flip at {i} "
                                     f"served wrong {label}")
        try:
            sk = pfs.Seeker(path)
            for sid in clean_ids:
                have = sk.seek(sid)
                if have is None:
                    raise AssertionError(f"region serve: {region} flip at "
                                         f"{i} dropped {sid!r} from seek")
                want = truth_rows[sid]
                if not (np.array_equal(want[0], have[0])
                        and want[1:] == have[1:]):
                    raise AssertionError(f"region serve: {region} flip at "
                                         f"{i} served a wrong row for "
                                         f"{sid!r}")
        except _DETECTED:
            return "detected"
        return "served-correct"
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run(rounds: int, seed: int, device=None, log=print) -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    before = kernel_launches()
    t0 = time.time()
    seq = 0
    detected = {}
    outcomes = {"detected": 0, "served-correct": 0}
    for r in range(rounds):
        seq = commitlog_round(rng, seq)
        how = fileset_round(rng, dev)
        detected[how] = detected.get(how, 0) + 1
        outcomes[region_round(rng, REGIONS[r % len(REGIONS)], dev)] += 1
        if (r + 1) % 25 == 0:
            log(f"  round {r + 1}/{rounds} ({seq} wal records, "
                f"{time.time() - t0:.0f}s)")
    sync(dev)
    return {"rounds": rounds, "wal_records": seq,
            "filesets_detected": detected, "regions": outcomes,
            "launches": launches_since(before), "device": str(dev),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.rounds, args.seed, args.device,
              log=lambda s: print(s, flush=True))
    print(f"DURABILITY FUZZ PASS: {out['rounds']} rounds, "
          f"{out['wal_records']} wal records, fileset flips detected by "
          f"{out['filesets_detected']}, region corpus "
          f"{out['regions']['detected']} detected / "
          f"{out['regions']['served-correct']} served-correct, seed "
          f"{args.seed}, {out['seconds']:.0f}s")
    print(f"fuzz_durability kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
