"""Fileset persistence (port of m3_tpu/persist/fs.py, the same files byte
for byte; reference: src/dbnode/persist/fs).

One fileset per (namespace, shard, block start), same seven-file invariant
structure as the reference's writer (persist/fs/write.go:53-78):

  info.json        fileset metadata (block start, window, time unit, counts)
  data.bin         packed u32 codewords, row-major [S, MW] (mmap-read)
  index.bin        per-series entries sorted by id: {id, row, nbits,
                   npoints, data checksum} (write.go:283-290 equivalent)
  summaries.bin    every Nth index entry for coarse seek (summaries file)
  bloom.bin        bloom filter over ids (bloom_filter.go)
  digest.json      adler32 of every file above (dbnode/digest)
  checkpoint.json  digest-of-digests, written LAST — a fileset without a
                   valid checkpoint is incomplete and ignored (write.go:44)

Readers mmap data.bin (np.memmap; x/mmap analog); the Seeker answers
point-id lookups via bloom -> summaries -> index binary search -> row slice
(seek.go:159,332 flow). Volumes: snapshots write the same structure under a
`snapshot-<version>` suffix with snapshot metadata (snapshot_metadata_write.go).

The device work: every bloom filter (written, and rebuilt by
`verify_rows`) hashes its IDs through the hash kernel, the writer's on
the block's device and the reader's on `device` (None: the CUDA card);
`to_block` builds a SealedBlock whose reads decode there. The rest is
host file work, routed through the disk I/O seam."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve
from ..storage.block import SealedBlock
from ..utils import xtime
from ..utils.bloom import BloomFilter
from ..utils.checksum import adler32_rows
from ..utils.instrument import ROOT
from . import diskio
from .diskio import CorruptionError, DiskWriteError, classify_write_error

# The disk I/O seam: every file operation below routes through this
# module-level indirection (one attribute lookup when no injector is
# installed — zero overhead off). testing/faultfs.py swaps it.
_io = diskio.DEFAULT

# Serve-time integrity observability (quarantines, verify failures);
# shared by name with the storage-side readers (storage/retriever.py).
_CORRUPTION = ROOT.sub_scope("storage.corruption")

INFO_FILE = "info.json"
DATA_FILE = "data.bin"
INDEX_FILE = "index.bin"
SUMMARIES_FILE = "summaries.bin"
BLOOM_FILE = "bloom.bin"
DIGEST_FILE = "digest.json"
CHECKPOINT_FILE = "checkpoint.json"
SUMMARY_EVERY = 32

_IDX_HEADER = struct.Struct("<IIiiI")  # id_len, row, nbits, npoints, checksum


def fileset_dir(root: str, namespace: bytes, shard: int, block_start: int,
                snapshot_version: Optional[int] = None) -> str:
    kind = f"snapshot-{snapshot_version}" if snapshot_version is not None else "fileset"
    return os.path.join(root, namespace.decode(), f"shard-{shard:05d}", f"{kind}-{block_start}")


def _adler(path: str) -> int:
    a = 1
    with _io.open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return a
            a = zlib.adler32(chunk, a)


class FilesetWriter:
    """persist/fs/write.go DataFileSetWriter equivalent."""

    def __init__(self, root: str):
        self.root = root

    def write(self, namespace: bytes, shard: int, blk: SealedBlock, registry,
              snapshot_version: Optional[int] = None,
              wal_position: Optional[Tuple[int, int]] = None) -> str:
        d = fileset_dir(self.root, namespace, shard, blk.block_start, snapshot_version)
        tmp = d + ".tmp"
        try:
            return self._write(d, tmp, blk, registry, snapshot_version,
                               wal_position)
        except OSError as e:
            # Typed classification (EIO -> DiskWriteError, ENOSPC ->
            # DiskFullError): the flush path retries/degrades on these
            # instead of folding a raw OSError into a broad except.
            if isinstance(e, (CorruptionError, DiskWriteError)):
                raise
            raise classify_write_error(e, d) from e

    def _write(self, d: str, tmp: str, blk: SealedBlock, registry,
               snapshot_version: Optional[int],
               wal_position: Optional[Tuple[int, int]]) -> str:
        os.makedirs(tmp, exist_ok=True)

        words = np.ascontiguousarray(blk.words, np.uint32)
        with _io.open(os.path.join(tmp, DATA_FILE), "wb") as f:
            f.write(words.tobytes())

        # Index entries sorted by series id (the write path buffers and sorts,
        # write.go WriteAll) with per-row data checksums — one vectorized
        # adler pass over the whole codeword matrix, not a per-row loop.
        ids = [registry.id_of(int(si)) for si in blk.series_indices]
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        bloom = BloomFilter.for_capacity(len(ids))
        bloom.add_batch([ids[i] for i in order], device=blk.device)
        row_sums = adler32_rows(words) if len(ids) else np.zeros(0, np.int64)
        index_offsets: List[Tuple[bytes, int]] = []
        with _io.open(os.path.join(tmp, INDEX_FILE), "wb") as f:
            for i in order:
                entry = _IDX_HEADER.pack(
                    len(ids[i]), i, int(blk.nbits[i]), int(blk.npoints[i]),
                    int(row_sums[i]),
                )
                index_offsets.append((ids[i], f.tell()))
                f.write(entry)
                f.write(ids[i])
        with _io.open(os.path.join(tmp, SUMMARIES_FILE), "wb") as f:
            for sid, off in index_offsets[::SUMMARY_EVERY]:
                f.write(struct.pack("<IQ", len(sid), off))
                f.write(sid)
        with _io.open(os.path.join(tmp, BLOOM_FILE), "wb") as f:
            f.write(bloom.tobytes())

        info = {
            "block_start": blk.block_start,
            "window": blk.window,
            "time_unit": int(blk.time_unit),
            "num_series": len(ids),
            "max_words": int(words.shape[1]),
            "block_checksum": blk.checksum,
            "bloom_m": bloom.m,
            "bloom_k": bloom.k,
            "snapshot_version": snapshot_version,
            "volume_type": "snapshot" if snapshot_version is not None else "flush",
        }
        if wal_position is not None:
            # Chunk-aligned commit log position taken BEFORE the snapshot
            # read: recovery replays only WAL chunks past it (everything
            # earlier is provably inside this snapshot).
            info["wal_position"] = [int(wal_position[0]), int(wal_position[1])]
        with _io.open(os.path.join(tmp, INFO_FILE), "w") as f:
            json.dump(info, f)

        digests = {
            name: _adler(os.path.join(tmp, name))
            for name in (INFO_FILE, DATA_FILE, INDEX_FILE, SUMMARIES_FILE, BLOOM_FILE)
        }
        with _io.open(os.path.join(tmp, DIGEST_FILE), "w") as f:
            json.dump(digests, f)
        # Checkpoint LAST: its presence + matching digest-of-digests marks the
        # fileset durable (write.go checkpoint semantics).
        with _io.open(os.path.join(tmp, CHECKPOINT_FILE), "w") as f:
            json.dump({"digest": _adler(os.path.join(tmp, DIGEST_FILE))}, f)

        if os.path.exists(d):
            shutil.rmtree(d)
        _io.replace(tmp, d)
        return d


def fileset_complete(d: str) -> bool:
    """Checkpoint present and digest chain intact (read.go validation)."""
    cp = os.path.join(d, CHECKPOINT_FILE)
    dg = os.path.join(d, DIGEST_FILE)
    if not (os.path.exists(cp) and os.path.exists(dg)):
        return False
    try:
        with _io.open(cp) as f:
            want = json.load(f)["digest"]
        return _adler(dg) == want
    except (ValueError, KeyError, OSError):
        return False


# --------------------------------------------------------------- quarantine

QUARANTINE_DIR = "quarantine"


def quarantine_fileset(path: str, reason: str, rows: Sequence[int] = (),
                       ids: Sequence[bytes] = ()) -> Optional[str]:
    """Move a corrupt fileset out of the servable namespace: rename it
    into `<shard-dir>/quarantine/<name>` (outside `list_filesets`'
    `fileset-` prefix by construction) with a JSON sidecar naming the
    failing rows, so an operator — or the scrubber's repair pass — can
    attribute the rot before the copy is replaced from peers. Uses the
    RAW os layer, not the `_io` seam: quarantine is the remediation
    path and must not itself be fault-injected. Returns the quarantine
    path, or None when the rename failed (counted, never raised — the
    caller is already on a corruption error path)."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    qdir = os.path.join(parent, QUARANTINE_DIR)
    dst = os.path.join(qdir, name)
    try:
        os.makedirs(qdir, exist_ok=True)
        if os.path.lexists(dst):
            shutil.rmtree(dst, ignore_errors=True)
        os.replace(path, dst)
        with open(dst + ".json", "w") as f:
            json.dump({
                "reason": reason,
                "source": path,
                "rows": [int(r) for r in rows],
                "ids": [i.decode("utf-8", "replace") for i in ids],
            }, f)
    except OSError:
        _CORRUPTION.counter("quarantine_failed").inc()
        return None
    _CORRUPTION.counter("quarantined").inc()
    return dst


@dataclasses.dataclass
class IndexEntry:
    id: bytes
    row: int
    nbits: int
    npoints: int
    checksum: int


class FilesetReader:
    """persist/fs/read.go DataFileSetReader: full-fileset scans (bootstrap).

    `device` is where `verify_rows` hashes the bloom and where `to_block`'s
    block decodes (None: the CUDA card, resolved when first needed, so a
    Seeker's reader never touches a device)."""

    def __init__(self, path: str, verify: bool = True, *, device=None):
        if not fileset_complete(path):
            raise FileNotFoundError(f"incomplete or missing fileset at {path}")
        self.path = path
        self.device = device
        with _io.open(os.path.join(path, INFO_FILE)) as f:
            self.info = json.load(f)
        # The recorded whole-file adlers ride every reader (cheap: one
        # small json), so each consumer verifies the EXACT bytes it read
        # — a re-read-and-compare pass would leave a window where the
        # verification read is clean and the consuming read is not.
        try:
            with _io.open(os.path.join(path, DIGEST_FILE)) as f:
                self.digests: Dict[str, int] = json.load(f)
        except (OSError, ValueError):
            self.digests = {}
        if verify:
            for name, want in self.digests.items():
                if _adler(os.path.join(path, name)) != want:
                    raise CorruptionError(
                        f"digest mismatch for {name} in {path}", path=path)
        self._words = _io.memmap(
            os.path.join(path, DATA_FILE), dtype=np.uint32,
            shape=(self.info["num_series"], self.info["max_words"]),
        )
        self.entries = list(self._read_index())

    def wal_position(self) -> Optional[Tuple[int, int]]:
        """The commit log position recorded at snapshot time, or None
        (flush filesets, and snapshots from before the field existed)."""
        pos = self.info.get("wal_position")
        return (int(pos[0]), int(pos[1])) if pos else None

    def row_checksums(self) -> np.ndarray:
        """adler32 of every data row, int64 [S] — one vectorized pass
        over the whole codeword matrix (utils.checksum.adler32_rows)."""
        if not self.info["num_series"]:
            return np.zeros(0, np.int64)
        return adler32_rows(np.asarray(self._words))

    def verify_rows(self):
        """Row-granular verification, vectorized over the whole fileset:
        every index entry's recorded adler must match its data row, and
        the bloom filter must be exactly the one the writer would build
        over these ids (a divergent bloom silently turns Seeker lookups
        into false negatives — reads that miss durable data). Raises
        IOError naming the first divergence; the digest chain
        (construction-time verify=True) covers whole-file rot, this
        covers per-row attribution and index/data cross-wiring."""
        sums = self.row_checksums()
        if self.entries:
            rows = np.fromiter((e.row for e in self.entries), np.int64,
                               count=len(self.entries))
            want = np.fromiter((e.checksum for e in self.entries), np.int64,
                               count=len(self.entries))
            if rows.min(initial=0) < 0 or rows.max(initial=-1) >= len(sums):
                raise CorruptionError(
                    f"index entry row out of range in {self.path}",
                    path=self.path)
            bad = np.flatnonzero(sums[rows] != want)
            if len(bad):
                bad_entries = [self.entries[int(b)] for b in bad]
                raise CorruptionError(
                    f"row checksum mismatch for {bad_entries[0].id!r} "
                    f"(row {bad_entries[0].row}) in {self.path}",
                    path=self.path,
                    rows=[e.row for e in bad_entries],
                    ids=[e.id for e in bad_entries])
        bloom = BloomFilter.for_capacity(len(self.entries))
        bloom.add_batch([e.id for e in self.entries],
                        device=resolve(self.device))
        with _io.open(os.path.join(self.path, BLOOM_FILE), "rb") as f:
            if f.read() != bloom.tobytes():
                raise CorruptionError(
                    f"bloom filter diverges from ids in {self.path}",
                    path=self.path)

    def _read_index(self) -> Iterator[IndexEntry]:
        with _io.open(os.path.join(self.path, INDEX_FILE), "rb") as f:
            data = f.read()
        want = self.digests.get(INDEX_FILE)
        if want is not None and zlib.adler32(data) != want:
            # Verify the bytes ABOUT to be parsed: rotten index entries
            # otherwise fail silently (a garbled id misses the binary
            # search — a read that quietly skips durable data).
            raise CorruptionError(
                f"index digest mismatch in {self.path}", path=self.path)
        pos = 0
        while pos < len(data):
            id_len, row, nbits, npoints, checksum = _IDX_HEADER.unpack_from(data, pos)
            pos += _IDX_HEADER.size
            sid = data[pos : pos + id_len]
            pos += id_len
            yield IndexEntry(sid, row, nbits, npoints, checksum)

    def to_block(self, device=None) -> Tuple[SealedBlock, List[bytes]]:
        """Load the whole fileset back as a SealedBlock + ids by row order,
        reading on `device` (None: the reader's).

        series_indices are row numbers; callers remap into their registry
        (Shard.load_block). The words stay the read-only mapping of
        data.bin: every upload copies them, nothing writes through."""
        info = self.info
        rows = sorted(self.entries, key=lambda e: e.row)
        nbits = np.array([e.nbits for e in rows], np.int32)
        npoints = np.array([e.npoints for e in rows], np.int32)
        blk = SealedBlock(
            block_start=info["block_start"],
            window=info["window"],
            series_indices=np.arange(len(rows), dtype=np.int32),
            words=np.asarray(self._words),
            nbits=nbits,
            npoints=npoints,
            time_unit=xtime.Unit(info["time_unit"]),
            checksum=info["block_checksum"],
            device=resolve(device if device is not None else self.device),
        )
        # Serve-time integrity: the index entries' recorded row adlers
        # ride the block, and SealedBlock.read/read_all verify the data
        # rows against them lazily on first touch — once per generation
        # (verified flag cached on the block object), so the hot path
        # pays one vectorized adler pass per loaded block, ever.
        if rows:
            blk.expected_row_sums = np.fromiter(
                (e.checksum for e in rows), np.int64, count=len(rows))
            blk.expected_row_ids = [e.id for e in rows]
            blk.source_path = self.path
        return blk, [e.id for e in rows]


class Seeker:
    """persist/fs/seek.go: point-id lookup without loading the fileset.

    bloom (negative fast path) -> in-memory sorted index (summaries would
    page the index; ours is small enough to hold) -> mmap row slice."""

    def __init__(self, path: str):
        reader = FilesetReader(path, verify=False)
        self.path = path
        self.info = reader.info
        with _io.open(os.path.join(path, BLOOM_FILE), "rb") as f:
            raw = f.read()
        want = reader.digests.get(BLOOM_FILE)
        if want is not None and zlib.adler32(raw) != want:
            # A rotten bloom is the nastiest fileset fault: every lookup
            # turns into a silent false negative. Verify the exact bytes
            # read before trusting a single membership answer.
            raise CorruptionError(
                f"bloom digest mismatch in {path}", path=path)
        self.bloom = BloomFilter.frombytes(raw, self.info["bloom_m"],
                                           self.info["bloom_k"])
        self._entries = sorted(reader.entries, key=lambda e: e.id)
        self._ids = [e.id for e in self._entries]
        self._words = reader._words

    def seek(self, series_id: bytes) -> Optional[Tuple[np.ndarray, int, int]]:
        """-> (packed words row, nbits, npoints) or None (seek.go:332 SeekByID)."""
        if series_id not in self.bloom:
            return None
        import bisect

        i = bisect.bisect_left(self._ids, series_id)
        if i >= len(self._ids) or self._ids[i] != series_id:
            return None
        e = self._entries[i]
        row = np.asarray(self._words[e.row])
        if zlib.adler32(row.tobytes()) != e.checksum:
            _CORRUPTION.counter("seek_mismatch").inc()
            raise CorruptionError(
                f"checksum mismatch for {series_id!r} in {self.path}",
                path=self.path, rows=[e.row], ids=[series_id])
        return row, e.nbits, e.npoints


class PersistManager:
    """persist_manager.go: the flush-side entry point the database calls."""

    def __init__(self, root: str):
        self.root = root
        self.writer = FilesetWriter(root)

    def write_block(self, namespace: bytes, shard: int, blk: SealedBlock, registry) -> str:
        return self.writer.write(namespace, shard, blk, registry)

    def write_snapshot(self, namespace: bytes, shard: int, blk: SealedBlock, registry,
                       version: int,
                       wal_position: Optional[Tuple[int, int]] = None) -> str:
        return self.writer.write(namespace, shard, blk, registry,
                                 snapshot_version=version,
                                 wal_position=wal_position)

    def list_filesets(self, namespace: bytes, shard: int) -> List[Tuple[int, str]]:
        """Complete flush filesets for a shard: [(block_start, path)]."""
        d = os.path.join(self.root, namespace.decode(), f"shard-{shard:05d}")
        out = []
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            # '.tmp' staging dirs are mid-write crash residue (a SIGKILL
            # between the checkpoint write and os.replace): never a
            # servable fileset, and their suffix isn't a block start.
            if name.startswith("fileset-") and not name.endswith(".tmp"):
                path = os.path.join(d, name)
                if fileset_complete(path):
                    out.append((int(name.split("-")[-1]), path))
        return sorted(out)

    def list_snapshots(self, namespace: bytes, shard: int) -> List[Tuple[int, int, str]]:
        """[(block_start, version, path)] for complete snapshots."""
        d = os.path.join(self.root, namespace.decode(), f"shard-{shard:05d}")
        out = []
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            if name.startswith("snapshot-") and not name.endswith(".tmp"):
                path = os.path.join(d, name)
                if fileset_complete(path):
                    _, version, block_start = name.split("-")
                    out.append((int(block_start), int(version), path))
        return sorted(out)

    def list_quarantined(self, namespace: bytes, shard: int
                         ) -> List[Tuple[int, str]]:
        """Quarantined flush filesets for a shard: [(block_start, path)].
        The scrubber routes these into repair and clears them once a
        fresh replica-sourced fileset has replaced them."""
        d = os.path.join(self.root, namespace.decode(),
                         f"shard-{shard:05d}", QUARANTINE_DIR)
        out = []
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            if name.startswith("fileset-") and not name.endswith(".json"):
                out.append((int(name.split("-")[-1]), os.path.join(d, name)))
        return sorted(out)

    def clear_quarantined(self, namespace: bytes, shard: int,
                          block_start: int) -> bool:
        """Drop a quarantined fileset (+ sidecar) after repair rewrote a
        healthy copy — the un-quarantine step. Returns True when one was
        removed."""
        d = os.path.join(self.root, namespace.decode(),
                         f"shard-{shard:05d}", QUARANTINE_DIR)
        path = os.path.join(d, f"fileset-{block_start}")
        if not os.path.isdir(path):
            return False
        shutil.rmtree(path, ignore_errors=True)
        if os.path.exists(path + ".json"):
            try:
                os.remove(path + ".json")
            except OSError:
                pass
        return True

    def shards_with_data(self, namespace: bytes) -> List[int]:
        d = os.path.join(self.root, namespace.decode())
        if not os.path.isdir(d):
            return []
        return sorted(
            int(name.split("-")[1]) for name in os.listdir(d) if name.startswith("shard-")
        )
