"""Commit log WAL (host copy of m3_tpu/persist/commitlog.py, the same
on-disk format byte for byte; reference: src/dbnode/persist/fs/commitlog).

Same invariants as the reference's chunked WAL (commit_log.go:69,205;
writer.go; chunk_reader.go):
  - entries buffer in memory and flush as length-prefixed chunks with an
    adler32 per chunk; a torn final chunk is detected and dropped on replay
  - per-file series dictionary: a series' {namespace, id} metadata is
    written once per file, entries reference it by index
    (docs/m3db/architecture/commitlogs.md:21-33)
  - strategies: WRITE_WAIT flushes synchronously on every write;
    WRITE_BEHIND flushes on the flush interval / explicit flush
    (commit_log.go:241-242)
  - rotation starts a new numbered file; one commit log serves ALL
    namespaces (commitlogs.md:5)
"""

from __future__ import annotations

import enum
import logging
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from . import diskio
from .diskio import classify_write_error

# The disk I/O seam (persist/diskio.py): every file operation below
# routes through this module-level indirection — one attribute lookup
# when no injector is installed. testing/faultfs.py swaps it.
_io = diskio.DEFAULT

# Per-file format header, written before the first chunk: replay
# refuses (skips, with a warning) files whose magic/version don't match
# instead of misparsing a foreign or older layout into garbage entries.
# v2 = meta entries carry encoded tags.
_FILE_MAGIC = b"M3TPUWAL"
_FILE_VERSION = 2
_FILE_HEADER = _FILE_MAGIC + struct.pack("<H", _FILE_VERSION)

_CHUNK_HEADER = struct.Struct("<II")      # payload_len, adler32
# tag=0, ns_len, id_len, tags_len — the tags bytes are the x/serialize
# tag codec (utils.serialize.encode_tags), written once per series per
# file like the rest of the metadata (the reference's commitlog series
# metadata carries EncodedTags the same way, commitlogs.md:21-33): WAL
# replay must be able to REBUILD the reverse index for series whose
# index blocks were never flushed, or recovered data is unreachable by
# query after kill -9.
_META_ENTRY = struct.Struct("<BHHH")
_DATA_ENTRY = struct.Struct("<BIqd")      # tag=1, series_ref, time_ns, value


class Strategy(enum.Enum):
    WRITE_WAIT = "write_wait"
    WRITE_BEHIND = "write_behind"


class CommitLog:
    def __init__(self, directory: str, strategy: Strategy = Strategy.WRITE_BEHIND,
                 flush_interval_ns: int = 1_000_000_000,
                 clock: Optional[Callable[[], int]] = None):
        self.directory = directory
        self.strategy = strategy
        self.flush_interval_ns = flush_interval_ns
        self.clock = clock or time.time_ns
        os.makedirs(directory, exist_ok=True)
        existing = [int(f.split("-")[1].split(".")[0]) for f in os.listdir(directory)
                    if f.startswith("commitlog-")]
        self._file_num = max(existing, default=-1) + 1
        self._f = None
        self._buf = bytearray()
        self._series_refs: Dict[Tuple[bytes, bytes], int] = {}
        # Per-file: keys whose emitted meta carried no tags (a later
        # tagged write re-emits), and the count of metas emitted (the
        # ref numbering replay's append-only table reproduces).
        self._untagged_keys: set = set()
        self._meta_count = 0
        self._last_flush = self.clock()
        # One appender file shared by every shard's write path: the commit
        # log serializes internally (commit_log.go's single writer loop)
        # now that the node no longer holds a global write mutex.
        self._lock = threading.RLock()
        self._open_new_file()

    # ----------------------------------------------------------------- files

    def _path(self, num: int) -> str:
        return os.path.join(self.directory, f"commitlog-{num:08d}.bin")

    def _open_new_file(self):
        if self._f is not None:
            self.flush()
            self._f.close()
        self._f = _io.open(self._path(self._file_num), "ab")
        try:
            if self._f.tell() == 0:
                # Fresh file: stamp the format header before any chunk.
                self._f.write(_FILE_HEADER)
                self._f.flush()
        except OSError:
            # Header write failed (EIO/ENOSPC): deferred — flush()
            # re-stamps before the first chunk, so a headerless file
            # never accumulates chunks replay would refuse to parse.
            pass
        self._series_refs.clear()
        self._untagged_keys.clear()
        self._meta_count = 0

    def rotate(self) -> int:
        """Start a new commit log file (rotation on flush/time window)."""
        with self._lock:
            old = self._file_num
            self._file_num += 1
            self._open_new_file()
            return old

    def active_file(self) -> str:
        return self._path(self._file_num)

    def files(self) -> List[str]:
        return sorted(
            os.path.join(self.directory, f) for f in os.listdir(self.directory)
            if f.startswith("commitlog-")
        )

    def remove_files_before(self, file_num: int):
        """Cleanup after flush durability (storage/cleanup.go)."""
        for f in self.files():
            num = int(os.path.basename(f).split("-")[1].split(".")[0])
            if num < file_num:
                _io.remove(f)

    # ---------------------------------------------------------------- writes

    @staticmethod
    def _encode_tags_safe(tags: Optional[dict]) -> bytes:
        """Best-effort x/serialize encoding: str keys/values (the JSON
        ingest surfaces hand those over) normalize to utf-8, and ANY
        encoding failure degrades to untagged metadata instead of
        raising — the write path has already applied the point to the
        shard buffer, so a tags problem must never abort the append and
        leave served data missing from the WAL."""
        if not tags:
            return b""
        from ..utils import serialize as tag_serialize

        try:
            norm = {
                (k.encode() if isinstance(k, str) else k):
                (v.encode() if isinstance(v, str) else v)
                for k, v in tags.items()}
            return tag_serialize.encode_tags(norm)
        except (tag_serialize.TagEncodeError, TypeError, ValueError,
                AttributeError, UnicodeError):
            return b""

    def _ref(self, namespace: bytes, series_id: bytes,
             tags: Optional[dict] = None) -> int:
        key = (namespace, series_id)
        ref = self._series_refs.get(key)
        if ref is not None and not (tags and key in self._untagged_keys):
            # Steady state (known ref, tags already logged or absent):
            # one dict probe, no per-datapoint tag encode.
            return ref
        encoded = self._encode_tags_safe(tags)
        if ref is not None:
            if not encoded:
                # Tags unencodable: keep the untagged ref, and stop
                # retrying the encode per DATAPOINT — dropping the key
                # from the untagged set means this series' tag upgrade
                # is attempted once per file, not once per write, under
                # the lock every shard's write path serializes on.
                self._untagged_keys.discard(key)
                return ref
            # The series' first sighting this file was UNTAGGED and a
            # tagged write has now arrived: emit a fresh tagged meta
            # (allocating a new ref — replay tables are append-only) so
            # recovery can still rebuild this series' index document.
            ref = None
        if ref is None:
            # Refs are assigned in META EMISSION order (replay's table
            # appends one entry per meta), which diverges from the
            # distinct-key count once a tagged re-emission happens.
            ref = self._meta_count
            self._meta_count += 1
            self._series_refs[key] = ref
            if encoded:
                self._untagged_keys.discard(key)
            else:
                self._untagged_keys.add(key)
            self._buf += _META_ENTRY.pack(0, len(namespace), len(series_id),
                                          len(encoded))
            self._buf += namespace
            self._buf += series_id
            self._buf += encoded
        return ref

    def write(self, namespace: bytes, series_id: bytes, t_ns: int, value: float,
              tags: Optional[dict] = None):
        with self._lock:
            if self._f is None:
                raise ValueError("commit log is closed")
            ref = self._ref(namespace, series_id, tags)
            self._buf += _DATA_ENTRY.pack(1, ref, t_ns, value)
            self._maybe_flush()

    def write_batch(self, namespace: bytes, ids, ts, vals, tags=None):
        with self._lock:
            if self._f is None:
                raise ValueError("commit log is closed")
            for i, (sid, t, v) in enumerate(zip(ids, ts, vals)):
                ref = self._ref(namespace, sid,
                                tags[i] if tags is not None else None)
                self._buf += _DATA_ENTRY.pack(1, ref, int(t), float(v))
            self._maybe_flush()

    def _maybe_flush(self):
        if self.strategy == Strategy.WRITE_WAIT:
            self.flush()
        elif self.clock() - self._last_flush >= self.flush_interval_ns:
            self.flush()

    def flush(self):
        """Write buffered entries as one checksummed chunk (writer.go).

        A failed write/fsync is an ACK failure, not a silent accept: the
        chunk is WITHDRAWN (truncated back, the file rotated so the
        per-file series dictionary can't dangle into the torn region)
        and the error re-raised TYPED — DiskWriteError for EIO-class
        media failures, DiskFullError for ENOSPC — so the write path
        propagates a classified error to the client instead of acking
        bytes that never became durable."""
        with self._lock:
            if not self._buf or self._f is None:
                return
            payload = bytes(self._buf)
            self._buf.clear()
            start = self._f.tell()
            try:
                if start < len(_FILE_HEADER):
                    # Header deferred by an earlier fault (or torn): the
                    # file must open with the format stamp or replay
                    # skips every chunk in it.
                    self._f.truncate(0)
                    start = 0
                    self._f.write(_FILE_HEADER)
                self._f.write(_CHUNK_HEADER.pack(len(payload),
                                                 zlib.adler32(payload)))
                self._f.write(payload)
                self._f.flush()
                _io.fsync(self._f)
            except OSError as e:
                path = self._path(self._file_num)
                self._withdraw_failed_chunk(start)
                raise classify_write_error(e, path) from e
            self._last_flush = self.clock()

    def _withdraw_failed_chunk(self, start: int):
        """Roll back a chunk whose write/fsync failed: truncate the file
        to its pre-chunk length (best effort — a torn half-chunk at EOF
        is dropped by replay either way) and rotate to a fresh file.
        Rotation is unconditional: the failed payload may have carried
        META entries the in-memory series dictionary already counted, so
        appending more chunks to this file would emit data entries whose
        refs dangle into the withdrawn region — replay would clean-stop
        there and strand every later (acked) chunk in the file."""
        try:
            self._f.truncate(start)
        except OSError:
            pass
        try:
            self._f.close()
        except OSError:
            pass
        self._f = None
        self._file_num += 1
        try:
            self._f = _io.open(self._path(self._file_num), "ab")
        except OSError:
            # Could not even open a fresh file: the log stays closed
            # (writes raise "commit log is closed") until rotate().
            self._f = None
        if self._f is not None:
            try:
                if self._f.tell() == 0:
                    self._f.write(_FILE_HEADER)
                    self._f.flush()
            except OSError:
                pass  # deferred: the next flush() re-stamps
        self._series_refs.clear()
        self._untagged_keys.clear()
        self._meta_count = 0

    def position(self) -> Tuple[int, int]:
        """Durable WAL position (file_num, byte offset) AFTER flushing
        the buffered entries: every entry written before this call is
        at or before the returned position, and the position lands on a
        chunk boundary (flush writes whole chunks). Snapshots record it
        so recovery replays only the WAL tail SINCE the snapshot
        (snapshot_metadata's CommitlogIdentifier in the reference)."""
        with self._lock:
            if self._f is None:
                raise ValueError("commit log is closed")
            self.flush()
            return self._file_num, self._f.tell()

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self.flush()
                finally:
                    # A typed flush failure may already have swapped or
                    # dropped the handle (_withdraw_failed_chunk).
                    if self._f is not None:
                        self._f.close()
                    self._f = None


def _iter_chunks(path: str) -> Iterator[Tuple[bytes, int]]:
    """Stream one file's valid chunk bodies in order as (body,
    end_offset), stopping at the first torn/corrupt chunk (reader.go
    chunk validation). Reads ONE chunk at a time, so replay RSS is
    bounded by the largest chunk, never the WAL file size. A file
    without this format's header (foreign layout, older version) is
    SKIPPED with a warning — misparsing would fabricate entries."""
    with _io.open(path, "rb") as f:
        header = f.read(len(_FILE_HEADER))
        if header != _FILE_HEADER:
            logging.getLogger("m3_tpu_torch.persist.commitlog").warning(
                "skipping commitlog file %s: unrecognized format header "
                "%r (want %r)", path, header[:10], _FILE_HEADER)
            return
        offset = len(_FILE_HEADER)
        while True:
            header = f.read(_CHUNK_HEADER.size)
            if len(header) < _CHUNK_HEADER.size:
                return
            plen, checksum = _CHUNK_HEADER.unpack(header)
            body = f.read(plen)
            if len(body) < plen or zlib.adler32(body) != checksum:
                return  # torn/corrupt tail chunk: stop replaying this file
            offset += _CHUNK_HEADER.size + plen
            yield body, offset


# One decoded data entry (tag=1) viewed columnar: numpy's packed layout
# of this dtype is byte-identical to _DATA_ENTRY's struct layout, so a
# run of consecutive data entries decodes as ONE frombuffer view.
_DATA_DTYPE = np.dtype([("tag", "u1"), ("ref", "<u4"),
                        ("t", "<i8"), ("v", "<f8")])
assert _DATA_DTYPE.itemsize == _DATA_ENTRY.size


class ReplayBatch(NamedTuple):
    """One chunk's worth of replayed entries as parallel columns.

    (file_num, end_offset) is the chunk's position in the WAL stream:
    comparing it against a snapshot's recorded `CommitLog.position()`
    tells recovery whether every entry in this chunk predates that
    snapshot (positions are chunk-aligned — position() flushes first)."""

    namespaces: np.ndarray  # object [N] bytes
    ids: np.ndarray         # object [N] bytes
    t_ns: np.ndarray        # int64 [N]
    values: np.ndarray      # float64 [N]
    file_num: int = -1
    end_offset: int = 0
    # Per-entry decoded tag dicts (None for untagged series / undecodable
    # tag bytes): recovery re-indexes series whose index blocks were
    # never flushed.
    tags: Optional[np.ndarray] = None  # object [N] Optional[dict]

    def __len__(self) -> int:
        return len(self.t_ns)

    def before(self, position: Optional[Tuple[int, int]]) -> bool:
        """True when every entry in this chunk was durably logged at or
        before `position` (a (file_num, offset) from position())."""
        if position is None:
            return False
        return (self.file_num, self.end_offset) <= tuple(position)


def replay_batches(directory: str) -> Iterator[ReplayBatch]:
    """Columnar replay: decode each checksummed chunk into (namespaces,
    ids, t_ns[], values[]) ndarray columns, streamed chunk-at-a-time —
    the recovery data plane's input shape (one batch feeds one
    vectorized shard-route + per-shard buffer append downstream,
    instead of one host loop iteration per WAL entry).

    Entry-for-entry bit-identical to `replay_ref` (the retained
    per-entry oracle), including its behavior on corrupt streams that
    still pass the chunk checksum (a delete of exactly chunk-aligned
    bytes realigns the stream): a data entry referencing an unknown
    series, or a truncated entry, stops THIS FILE cleanly after the
    preceding entries are yielded — corruption is a clean stop, never
    a crash, and damage never leaks across files (the durability fuzz
    campaign's contract)."""
    if not os.path.isdir(directory):
        return
    files = sorted(f for f in os.listdir(directory) if f.startswith("commitlog-"))
    rec = _DATA_ENTRY.size
    from ..utils import serialize as tag_serialize

    for fname in files:
        file_num = int(fname.split("-")[1].split(".")[0])
        series_ns: List[bytes] = []
        series_id: List[bytes] = []
        series_tags: List[Optional[dict]] = []
        # Object-array views of the tables, rebuilt only when a chunk
        # appended metas: WRITE_WAIT logs one chunk per write, so
        # rebuilding per chunk would be O(chunks x series) — quadratic
        # over a big file's replay.
        tabs: List[Optional[np.ndarray]] = [None, None, None]

        def _tables() -> List[np.ndarray]:
            if tabs[0] is None or len(tabs[0]) != len(series_ns):
                tabs[0] = np.array(series_ns, object)
                tabs[1] = np.array(series_id, object)
                tag_tab = np.empty(len(series_tags), object)
                tag_tab[:] = series_tags
                tabs[2] = tag_tab
            return tabs

        for body, end_offset in _iter_chunks(os.path.join(directory, fname)):
            tags = np.frombuffer(body, np.uint8)
            pos = 0
            refs_parts: List[np.ndarray] = []
            t_parts: List[np.ndarray] = []
            v_parts: List[np.ndarray] = []
            # Length-1 runs (a fresh file's first chunk alternates meta
            # and data one-to-one) decode scalar into these pending
            # columns — numpy per-call overhead on 21-byte runs would
            # dominate the whole replay; flushed in arrival order.
            ref_s: List[int] = []
            t_s: List[int] = []
            v_s: List[float] = []

            def _flush_scalars():
                if ref_s:
                    refs_parts.append(np.array(ref_s, np.int64))
                    t_parts.append(np.array(t_s, np.int64))
                    v_parts.append(np.array(v_s, np.float64))
                    ref_s.clear()
                    t_s.clear()
                    v_s.clear()

            corrupt = False
            while pos < len(body) and not corrupt:
                if body[pos] == 0:
                    try:
                        _, ns_len, id_len, tags_len = \
                            _META_ENTRY.unpack_from(body, pos)
                    except struct.error:
                        # Truncated trailing meta entry inside a
                        # checksummed chunk (realigned corrupt stream):
                        # clean stop of this file after the preceding
                        # entries are yielded.
                        corrupt = True
                        break
                    pos += _META_ENTRY.size
                    series_ns.append(body[pos : pos + ns_len])
                    pos += ns_len
                    series_id.append(body[pos : pos + id_len])
                    pos += id_len
                    decoded = None
                    if tags_len:
                        try:
                            decoded = tag_serialize.decode_tags(
                                body[pos : pos + tags_len])
                        except tag_serialize.TagEncodeError:
                            decoded = None  # corrupt tag bytes: series
                            #                 still replays, just unindexed
                    series_tags.append(decoded)
                    pos += tags_len
                    continue
                avail = (len(body) - pos) // rec
                if avail == 0:
                    # Trailing partial data entry: same clean-stop
                    # contract as the meta case above.
                    corrupt = True
                    break
                if avail == 1 or body[pos + rec] == 0:
                    # Single data entry before the next meta: scalar
                    # decode, no numpy machinery.
                    _, ref, t_ns, value = _DATA_ENTRY.unpack_from(body, pos)
                    if ref >= len(series_ns):
                        corrupt = True
                        break
                    ref_s.append(ref)
                    t_s.append(t_ns)
                    v_s.append(value)
                    pos += rec
                    continue
                # Maximal run of consecutive data entries: entry
                # boundaries are pos + rec*k while every boundary's tag
                # byte stays nonzero, so the run length is a strided
                # probe and the run itself one structured view. The
                # probe window starts small and grows geometrically —
                # cost stays linear whether the chunk is one giant data
                # run or short mixed stretches.
                probe = 32
                while True:
                    w = min(avail, probe)
                    stops = np.flatnonzero(tags[pos : pos + w * rec : rec] == 0)
                    if len(stops):
                        cnt = int(stops[0])
                        break
                    if w == avail:
                        cnt = avail
                        break
                    probe *= 4
                run = np.frombuffer(body, dtype=_DATA_DTYPE, count=cnt,
                                    offset=pos)
                refs = run["ref"].astype(np.int64)
                # Refs resolve against the table as of THIS run (metas
                # between runs grow it); a fabricated out-of-range ref
                # truncates the run where the per-entry iterator stops.
                # (Refs are stable once assigned — the table only
                # appends — so resolution itself happens ONCE per chunk
                # below, not per run.)
                oob = np.flatnonzero(refs >= len(series_ns))
                if len(oob):
                    corrupt = True
                    refs = refs[: int(oob[0])]
                    run = run[: int(oob[0])]
                _flush_scalars()
                refs_parts.append(refs)
                t_parts.append(run["t"])
                v_parts.append(run["v"])
                pos += cnt * rec
            _flush_scalars()
            if t_parts and sum(map(len, t_parts)):
                refs_all = np.concatenate(refs_parts)
                ns_tab, id_tab, tag_tab = _tables()
                yield ReplayBatch(
                    ns_tab[refs_all], id_tab[refs_all],
                    np.concatenate(t_parts).astype(np.int64, copy=False),
                    np.concatenate(v_parts).astype(np.float64, copy=False),
                    file_num, end_offset, tag_tab[refs_all])
            if corrupt:
                break  # clean stop: skip the rest of THIS file only


def replay(directory: str) -> Iterator[Tuple[bytes, bytes, int, float]]:
    """Iterate all (namespace, series_id, time_ns, value) entries across
    commit log files in order, dropping any torn tail chunk
    (commitlog/reader.go + iterator.go). Streamed chunk-at-a-time over
    the columnar decoder: per-entry consumers keep this shape, the
    batched bootstrapper consumes `replay_batches` directly."""
    for batch in replay_batches(directory):
        for ns, sid, t, v in zip(batch.namespaces, batch.ids,
                                 batch.t_ns, batch.values):
            yield ns, sid, int(t), float(v)


def replay_ref(directory: str) -> Iterator[Tuple[bytes, bytes, int, float]]:
    """The pre-batching per-entry replay path, retained as the
    bit-identity ORACLE (tests/test_durability.py asserts replay and
    replay_batches entry-identical to this, corrupted inputs included).
    Reads each file whole; never used on the recovery path. Two edits
    against the historical verbatim form, matched by the batched
    decoder: the meta layout carries encoded tags (skipped here), and a
    truncated entry or unknown series ref inside a checksum-valid chunk
    (a realigned corrupt stream) is a CLEAN per-file stop instead of a
    raise — corruption must never crash replay (the fuzz campaign's
    contract)."""
    if not os.path.isdir(directory):
        return
    files = sorted(f for f in os.listdir(directory) if f.startswith("commitlog-"))
    for fname in files:
        series: List[Tuple[bytes, bytes]] = []
        with _io.open(os.path.join(directory, fname), "rb") as f:
            data = f.read()
        if not data.startswith(_FILE_HEADER):
            continue  # unrecognized format: same skip as _iter_chunks
        pos = len(_FILE_HEADER)
        corrupt = False
        while pos + _CHUNK_HEADER.size <= len(data) and not corrupt:
            plen, checksum = _CHUNK_HEADER.unpack_from(data, pos)
            body = data[pos + _CHUNK_HEADER.size : pos + _CHUNK_HEADER.size + plen]
            if len(body) < plen or zlib.adler32(body) != checksum:
                break  # torn/corrupt tail chunk: stop replaying this file
            pos += _CHUNK_HEADER.size + plen
            epos = 0
            while epos < len(body):
                tag = body[epos]
                if tag == 0:
                    try:
                        _, ns_len, id_len, tags_len = \
                            _META_ENTRY.unpack_from(body, epos)
                    except struct.error:
                        corrupt = True
                        break
                    epos += _META_ENTRY.size
                    ns = body[epos : epos + ns_len]
                    epos += ns_len
                    sid = body[epos : epos + id_len]
                    epos += id_len + tags_len
                    series.append((ns, sid))
                else:
                    try:
                        _, ref, t_ns, value = _DATA_ENTRY.unpack_from(body, epos)
                    except struct.error:
                        corrupt = True
                        break
                    if ref >= len(series):
                        corrupt = True
                        break
                    epos += _DATA_ENTRY.size
                    ns, sid = series[ref]
                    yield ns, sid, t_ns, value
