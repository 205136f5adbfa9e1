"""Immutable sealed blocks + block LRU (port of m3_tpu/storage/block.py;
reference: src/dbnode/storage/block: DatabaseBlock holding one compressed
segment per series per block window, and wired_list.go's global LRU of
blocks paged in from disk).

A sealed block is batch-first: ONE object holds the compressed streams
of every series in a (shard, block-start) — words [S, MW] u32 — because
that is the unit the card encodes/decodes in a single launch. Per-series
access slices a row.

The block's streams live on the host as numpy (the reference's layout,
bit-identical to its words); `device` is where the block was sealed and
where its reads decode: the pack kernel at seal time, the decode kernel
at read time. A decode fault on the card raises (typed, through the
compute-fault guard's block.decode route); nothing falls back to a host
decoder. `merge_sealed_blocks` compacts two time-adjacent blocks through
the scan-free concat (ops/tsz_concat). Not ported yet: the shard x time
mesh seal."""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ops import tsz
from ..utils import xtime
from ..utils.checksum import adler32_rows
from ..utils.instrument import ROOT
from . import block_cache

# Process-unique block generations (device-block-cache keys): every
# SealedBlock CONSTRUCTION gets a fresh one — merge/re-seal replacement
# produces a new generation by construction, so stale cache entries are
# unreachable even before eager invalidation lands.
_GEN = itertools.count(1)

# Serve-time integrity counters.
_CORRUPTION = ROOT.sub_scope("storage.corruption")


def choose_time_unit(ts: np.ndarray) -> xtime.Unit:
    """Coarsest unit that represents every timestamp losslessly (the codec
    works in scaled integer ticks; the reference keys its DoD bucket scheme
    by time unit, m3tsz/scheme.go:41-52)."""
    for u in (xtime.Unit.MINUTE, xtime.Unit.SECOND, xtime.Unit.MILLISECOND,
              xtime.Unit.MICROSECOND):
        if (ts % u.nanos == 0).all():
            return u
    return xtime.Unit.NANOSECOND


@dataclasses.dataclass
class SealedBlock:
    """Compressed block for all series written in one (shard, block_start)."""

    block_start: int
    window: int                    # static decode window (max points/series)
    series_indices: np.ndarray     # int32 [S] registry indices, sorted
    words: np.ndarray              # uint32 [S, MW] packed streams
    nbits: np.ndarray              # int32 [S]
    npoints: np.ndarray            # int32 [S]
    time_unit: xtime.Unit = xtime.Unit.NANOSECOND  # tick scale of the streams
    checksum: int = 0
    # Seal-time boundary metadata (tsz.boundary_metadata): lets a later
    # adjacent block be appended by scan-free bit concat without decoding
    # this one.
    boundary: Optional[dict] = None
    # Where reads decode: None is the CUDA card (raising without one).
    device: Optional[torch.device] = dataclasses.field(default=None,
                                                       compare=False)

    def __post_init__(self):
        self.gen = next(_GEN)
        self.device = resolve(self.device)
        if self.checksum == 0:
            self.checksum = zlib.adler32(np.ascontiguousarray(self.words).tobytes())

    @property
    def num_series(self) -> int:
        return len(self.series_indices)

    def row_checksums(self) -> np.ndarray:
        """adler32 of every series' packed stream, int64 [S] (the per-row
        checksum convention of repair and the fileset index). Memoized:
        blocks are immutable once published."""
        sums = getattr(self, "_row_sums", None)
        if sums is None:
            sums = adler32_rows(self.words) if len(self.words) \
                else np.zeros(0, np.int64)
            sums.setflags(write=False)
            self._row_sums = sums
        return sums

    def _verify_rows(self) -> None:
        """Lazy serve-time integrity: a block carrying recorded per-row
        adler32s (`expected_row_sums`) compares them against the bytes on
        its FIRST read; divergence raises typed CorruptionError naming
        the rotten rows, so nothing bit-flipped is ever returned."""
        expected = getattr(self, "expected_row_sums", None)
        if expected is None or getattr(self, "_rows_verified", False):
            return
        expected = np.asarray(expected)
        actual = self.row_checksums()
        if actual.shape == expected.shape and bool((actual == expected).all()):
            self._rows_verified = True
            _CORRUPTION.counter("serve_verified").inc()
            return
        from ..persist.diskio import CorruptionError

        if actual.shape == expected.shape:
            bad = [int(b) for b in np.flatnonzero(actual != expected)]
        else:
            bad = list(range(self.num_series))
        ids = getattr(self, "expected_row_ids", None) or []
        _CORRUPTION.counter("serve_verify_failed").inc()
        raise CorruptionError(
            f"row checksum mismatch on read: {len(bad)} row(s) in block "
            f"{self.block_start}",
            path=getattr(self, "source_path", None), rows=bad,
            ids=[ids[b] for b in bad if b < len(ids)])

    def row_of(self, series_idx: int) -> Optional[int]:
        i = int(np.searchsorted(self.series_indices, series_idx))
        if i < len(self.series_indices) and self.series_indices[i] == series_idx:
            return i
        return None

    def read(self, series_idx: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Decode one series' datapoints (one decode launch of one row).

        Consults the device block cache first: a hot block's decoded
        planes are resident (admission after repeated touches), turning
        the per-series read into a row slice with no decode launch.
        Returned arrays are READ-ONLY on every path."""
        self._verify_rows()
        row = self.row_of(series_idx)
        if row is None:
            return None
        cache = block_cache.active()
        if cache is not None:
            dec = cache.decoded(self)
            if dec is not None:
                n = int(self.npoints[row])
                return dec[0][row, :n], dec[1][row, :n]
        ts, vals = _dispatch_decode(
            self.words[row : row + 1], self.npoints[row : row + 1],
            self.window, self.time_unit.nanos, self.device)
        n = int(self.npoints[row])
        t_out = np.ascontiguousarray(ts[0, :n])
        v_out = np.ascontiguousarray(vals[0, :n])
        t_out.setflags(write=False)
        v_out.setflags(write=False)
        return t_out, v_out

    def read_all(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decode every series in one batched launch: (ts [S, W], vals, npoints).

        Hot blocks serve from the device block cache; cold blocks decode
        with pow2 row bucketing. The planes are READ-ONLY on every path."""
        self._verify_rows()
        cache = block_cache.active()
        if cache is not None:
            dec = cache.decoded(self)
            if dec is not None:
                return dec[0], dec[1], self.npoints
        ts, vals = self._decode_plane()
        return ts, vals, self.npoints

    def _decode_plane(self, encoded: Optional[tuple] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole-block decode to (ts_ns [S, W], vals [S, W]).

        Rows are padded to a power of two (replicating the first stream,
        always valid), the decode-side twin of encode_block's shape
        bucketing. `encoded` is the cache's retained (words, padded
        npoints) tensors from the seal-time encode, already on the card:
        decoding from them skips the H2D re-upload of the stream words
        (the row padding matches encode_block's, and decode is
        row-independent, so rows [:S] are bit-identical either way).
        Planes come back read-only — they may be cache-shared."""
        from ..parallel import telemetry

        s = len(self.series_indices)
        if encoded is not None:
            words, npoints = encoded
        else:
            sp = _next_pow2(s, floor=1)
            words, npoints = self.words, self.npoints
            if sp != s:
                words = np.concatenate([words, np.repeat(words[:1], sp - s, 0)])
                npoints = np.concatenate(
                    [npoints, np.repeat(npoints[:1], sp - s)])
        telemetry.record_bucket(
            "block.decode_plane",
            (int(words.shape[0]), int(words.shape[-1]), int(self.window)))
        ts, vals = _dispatch_decode(words, npoints, self.window,
                                    self.time_unit.nanos, self.device)
        ts = np.ascontiguousarray(ts[:s])
        vals = np.ascontiguousarray(vals[:s])
        ts.setflags(write=False)
        vals.setflags(write=False)
        return ts, vals

    def nbytes(self) -> int:
        return int(self.words.nbytes)


def _dispatch_decode(words, npoints, window: int, unit_nanos: int, device):
    """The block plane decode on `device` (tsz.decode_plane: the decode
    kernel on the card, its plain version on the CPU) -> host numpy
    (ts_ns int64, vals f64), through the compute-fault guard (route
    block.decode; the decode kernel inside is guarded again as
    codec.decode). The primary ends in the D2H copy, so the guard's
    timeout sees the whole decode. A fault raises a typed ComputeError:
    there is no host decoder to fall back to.

    The route means something else than in the reference, where
    block.decode exists to choose the host ref_codec fallback: here it is
    the only guard whose timeout and breaker cover the D2H copy and
    decode_plane's finish (a fault inside codec.decode passes through it
    typed, counted once where it happened)."""
    from ..parallel import guard

    def _device():
        ts, vals = tsz.decode_plane(words, npoints, window=window,
                                    unit_nanos=unit_nanos, device=device)
        return ts.cpu().numpy(), vals.cpu().numpy()

    return guard.dispatch("block.decode", _device)


def _next_pow2(n: int, floor: int = 8) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def encode_block(block_start: int, series_indices, tdense, vdense, npoints,
                 max_words: Optional[int] = None, *,
                 device=None) -> SealedBlock:
    """Batch-encode dense tiles (from ShardBuffer.drain) into a SealedBlock
    on `device` (None: the CUDA card).

    Tiles are padded to power-of-two (series, window) geometry, exactly
    as the reference pads them (padding columns replicate the last point,
    padding rows are npoints=1 dummies sliced away afterwards): the
    window and max_words follow from the padded geometry, so the words,
    nbits and boundary are bit-identical to the reference's. The host
    prep (prepare_encode_inputs) is numpy; the chunk build and the pack
    kernel run on the device."""
    dev = resolve(device)
    s, w = tdense.shape
    wp = _next_pow2(w)
    sp = _next_pow2(s, floor=1)
    if wp != w:
        padc_t = np.repeat(tdense[:, -1:], wp - w, axis=1)
        padc_v = np.repeat(vdense[:, -1:], wp - w, axis=1)
        tdense = np.concatenate([tdense, padc_t], axis=1)
        vdense = np.concatenate([vdense, padc_v], axis=1)
    npoints = np.asarray(npoints, np.int32)
    if sp != s:
        tdense = np.concatenate([tdense, np.repeat(tdense[:1], sp - s, axis=0)])
        vdense = np.concatenate([vdense, np.repeat(vdense[:1], sp - s, axis=0)])
        npoints = np.concatenate([npoints, np.ones(sp - s, np.int32)])
    window = wp
    unit = choose_time_unit(tdense)
    mw = max_words if max_words is not None else tsz.max_words_for(window)
    inp = tsz.prepare_encode_inputs(tdense // unit.nanos, vdense, npoints)
    words_dev, nbits_dev = tsz.encode_prepared(inp, max_words=mw, device=dev)
    boundary = tsz.boundary_metadata(inp)
    # Keep the just-encoded DEVICE tensors (padded [sp, mw] words + padded
    # npoints — exactly what a later whole-block decode consumes) for the
    # device block cache: the seal hook (Shard._tick_locked) adopts them
    # via retain_encoded. Transient blocks that nobody retains drop them
    # with the block object.
    encoded_dev = None
    if block_cache.wants_encoded(dev):
        encoded_dev = (words_dev, torch.from_numpy(npoints).to(dev))
    words = words_dev[:s].cpu().numpy().view(np.uint32)
    nbits = nbits_dev[:s].cpu().numpy()
    # Every pack silently drops bits past max_words; an undersized
    # caller-supplied bound would seal truncated, undecodable streams.
    tsz.check_cursor(nbits, mw)
    npoints = npoints[:s]
    boundary = {k: v[:s] for k, v in boundary.items()}
    blk = SealedBlock(
        block_start=block_start,
        window=window,
        series_indices=np.asarray(series_indices, np.int32),
        words=words,
        nbits=np.asarray(nbits, np.int32),
        npoints=np.asarray(npoints, np.int32),
        time_unit=unit,
        boundary=boundary,
        device=dev,
    )
    if encoded_dev is not None:
        blk._encoded_dev = encoded_dev
    return blk


def _union_points(b1: SealedBlock, b2: SealedBlock):
    """Per series of the union of both blocks: its (ts, vals) runs, b1's
    first, from one whole-block read of each."""
    t1, v1, n1 = b1.read_all()
    t2, v2, n2 = b2.read_all()
    union = np.union1d(b1.series_indices, b2.series_indices)
    runs = []
    for sid in union:
        t_parts, v_parts = [], []
        for blk, t, v, n in ((b1, t1, v1, n1), (b2, t2, v2, n2)):
            row = blk.row_of(int(sid))
            if row is not None:
                t_parts.append(t[row, : n[row]])
                v_parts.append(v[row, : n[row]])
        runs.append((np.concatenate(t_parts), np.concatenate(v_parts)))
    return union, runs


def _encode_runs(block_start: int, union, runs, w: int, device) -> SealedBlock:
    """Dense tiles from per-series runs, each padded with its last real
    point (the codec contract), encoded into one block."""
    ts = np.zeros((len(union), w), np.int64)
    vs = np.zeros((len(union), w), np.float64)
    npts = np.zeros(len(union), np.int32)
    for i, (tt, vv) in enumerate(runs):
        npts[i] = tt.size
        ts[i, : tt.size] = tt
        vs[i, : tt.size] = vv
        if tt.size < w:
            ts[i, tt.size:] = tt[-1]
            vs[i, tt.size:] = vv[-1]
    return encode_block(block_start, union.astype(np.int32), ts, vs, npts,
                        device=device)


def merge_sealed_blocks(b1: SealedBlock, b2: SealedBlock) -> SealedBlock:
    """Compact two time-adjacent sealed blocks into one (block compaction;
    the reference's fs merge re-encodes point streams; here series present
    in both blocks take the scan-free concat when eligible, see
    ops/tsz_concat.py). b2 must start at or after b1's window end. The
    merge runs on b1's device: the concat on the card, a recode on the
    CPU (merge_adjacent's "auto").

    Series in only one input copy through untouched. Requires b1's
    seal-time boundary metadata and a shared time unit; otherwise both
    blocks are decoded and re-encoded wholesale. The result is a new
    block (a new generation: block-cache keys of the inputs never reach
    it)."""
    from ..ops import tsz_concat

    if b1.block_start >= b2.block_start:
        raise ValueError("merge_sealed_blocks: blocks must be time-ordered")
    if b1.boundary is None or b1.time_unit != b2.time_unit:
        return _merge_by_full_recode(b1, b2)

    dev = b1.device
    window = b1.window + b2.window
    max_words = tsz.max_words_for(window)
    union = np.union1d(b1.series_indices, b2.series_indices)
    r1 = np.searchsorted(b1.series_indices, union)
    r2 = np.searchsorted(b2.series_indices, union)
    in1 = (r1 < len(b1.series_indices)) & \
        (b1.series_indices[np.minimum(r1, len(b1.series_indices) - 1)] == union)
    in2 = (r2 < len(b2.series_indices)) & \
        (b2.series_indices[np.minimum(r2, len(b2.series_indices) - 1)] == union)

    words = np.zeros((len(union), max_words), np.uint32)
    nbits = np.zeros(len(union), np.int32)
    npoints = np.zeros(len(union), np.int32)

    only1 = in1 & ~in2
    only2 = ~in1 & in2
    for only, blk, rows in ((only1, b1, r1), (only2, b2, r2)):
        src = rows[only]
        w = blk.words[src]
        words[only, :w.shape[1]] = w[:, :max_words]
        nbits[only] = blk.nbits[src]
        npoints[only] = blk.npoints[src]

    both = in1 & in2
    same_epoch = np.ones(len(union), bool)
    if both.any():
        i1, i2 = r1[both], r2[both]
        # One upload of each side's words serves the header parses here
        # and the merge.
        w1 = tsz._as(b1.words[i1], torch.int32, dev)
        w2 = tsz._as(b2.words[i2], torch.int32, dev)
        h1 = tsz_concat.parse_header(w1)
        h2 = tsz_concat.parse_header(w2)
        t0_2 = h2["t0"].cpu().numpy()
        gap = t0_2 - b1.boundary["last_ticks"][i1]
        if (np.abs(gap) >= 2**31).any():
            # The DoD payload is 32-bit: a gap this wide cannot be encoded
            # in one stream at this time unit (prepare_encode_inputs raises
            # the same way on the ingest path).
            raise ValueError(
                "merge_sealed_blocks: inter-block gap exceeds int32 ticks")
        boundary_dt = gap.astype(np.int32)
        stale = ~b1.boundary.get(
            "valid", np.ones(len(b1.series_indices), bool))[i1]
        last_v = b1.boundary["last_v_bits"][i1].view(np.int64)
        mw, mnb = tsz_concat.merge_adjacent(
            w1, b1.nbits[i1], b1.npoints[i1],
            w2, b2.nbits[i2], b2.npoints[i2], boundary_dt,
            last_v, b1.boundary["last_vdelta_bits"][i1].view(np.int64),
            half_window=max(b1.window, b2.window), max_words=max_words,
            force_recode=stale, device=dev)
        words[both] = mw.cpu().numpy().view(np.uint32)
        nbits[both] = mnb.cpu().numpy()
        npoints[both] = b1.npoints[i1] + b2.npoints[i2]
        im2 = h2["int_mode"].cpu().numpy()
        same_epoch[both] = ((h1["int_mode"] == h2["int_mode"])
                            & (h1["k"] == h2["k"])).cpu().numpy()
        # When b2 contributed exactly ONE point, b2's sealed
        # last_vdelta_bits is 0 (there is no intra-b2 value delta), but the
        # MERGED stream's final value-delta is m2[0] - m1[last], the
        # boundary delta the merge just encoded. Copying b2's 0 would make
        # a later concat of the compacted block encode the next
        # double-delta against 0 while the decoder's previous-delta
        # register holds the true delta, silently corrupting values.
        # Recompute it from b1's seal metadata where trustworthy; rows with
        # stale b1 metadata go to the recode path of the NEXT merge.
        single2 = b2.npoints[i2] < 2
        with np.errstate(over="ignore"):
            fixed_vdelta = np.where(
                im2, (h2["v0"].cpu().numpy() - last_v).view(np.uint64),
                np.uint64(0))
        vdelta_trusted = ~stale & single2

    boundary2 = None
    if b2.boundary is not None:
        boundary2 = {}
        for key in ("last_ticks", "last_v_bits", "last_vdelta_bits"):
            col = np.zeros(len(union), b2.boundary[key].dtype)
            col[in2] = b2.boundary[key][r2[in2]]
            col[only1] = b1.boundary[key][r1[only1]]
            boundary2[key] = col
        valid = np.zeros(len(union), bool)
        valid[in2] = b2.boundary.get(
            "valid", np.ones(len(b2.series_indices), bool))[r2[in2]]
        valid[only1] = b1.boundary.get(
            "valid", np.ones(len(b1.series_indices), bool))[r1[only1]]
        # Epoch-mismatched rows were re-encoded with fresh mode detection:
        # b2's stream-space metadata no longer describes the merged stream.
        valid &= same_epoch
        if both.any():
            u_both = np.flatnonzero(both)
            boundary2["last_vdelta_bits"][u_both[vdelta_trusted]] = \
                fixed_vdelta[vdelta_trusted]
            valid[u_both[single2 & stale]] = False
        boundary2["valid"] = valid

    return SealedBlock(
        block_start=b1.block_start, window=window,
        series_indices=union.astype(np.int32), words=words, nbits=nbits,
        npoints=npoints, time_unit=b1.time_unit, boundary=boundary2,
        device=dev)


def _merge_by_full_recode(b1: SealedBlock, b2: SealedBlock) -> SealedBlock:
    """General merge of two blocks: decode both and re-encode the union
    (the fallback of the reference's time-adjacent compaction)."""
    union, runs = _union_points(b1, b2)
    return _encode_runs(b1.block_start, union, runs, b1.window + b2.window,
                        b1.device)


def merge_same_start(b1: SealedBlock, b2: SealedBlock) -> SealedBlock:
    """Merge two sealed blocks covering the SAME block start into one
    (an insert-queue drain racing tick can land late writes for a block
    start that already sealed; the re-seal must union, not overwrite).

    b2 is the later arrival: on duplicate (series, timestamp) pairs its
    value wins, matching the buffer's last-arrival-wins drain dedup."""
    if b1.block_start != b2.block_start:
        raise ValueError("merge_same_start: blocks must share a block start")
    union, runs = _union_points(b1, b2)
    deduped: List[Tuple[np.ndarray, np.ndarray]] = []
    for tt, vv in runs:
        # Stable sort by time keeps b1-then-b2 arrival order within a
        # duplicate timestamp; keep the LAST arrival per timestamp.
        order = np.argsort(tt, kind="stable")
        tt, vv = tt[order], vv[order]
        if len(tt) > 1:
            keep = np.concatenate([tt[:-1] != tt[1:], [True]])
            tt, vv = tt[keep], vv[keep]
        deduped.append((tt, vv))
    w = max((tt.size for tt, _ in deduped), default=1)
    return _encode_runs(b1.block_start, union, deduped, max(w, 1), b1.device)


class WiredList:
    """Capacity-bounded LRU over blocks paged in from disk
    (block/wired_list.go:77): evicts least-recently-read whole blocks.
    Thread-safe — serving threads share one list."""

    def __init__(self, max_bytes: int = 1 << 30):
        import threading

        self.max_bytes = max_bytes
        self._items: "OrderedDict[Tuple, SealedBlock]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key) -> Optional[SealedBlock]:
        with self._lock:
            blk = self._items.get(key)
            if blk is not None:
                self._items.move_to_end(key)
            return blk

    def put(self, key, blk: SealedBlock):
        # Invalidation goes through get_cache(), not active(): dropping
        # residency must happen even while a thread is inside a
        # block_cache.disabled() bypass.
        cache = block_cache.get_cache()
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return
            self._items[key] = blk
            self._bytes += blk.nbytes()
            while self._bytes > self.max_bytes and len(self._items) > 1:
                _, old = self._items.popitem(last=False)
                self._bytes -= old.nbytes()
                # An unwired block can never be read again: drop its
                # decoded residency too.
                cache.invalidate_block(old)

    def drop(self, pred) -> int:
        """Remove entries whose key matches `pred` (fileset invalidation)."""
        cache = block_cache.get_cache()
        with self._lock:
            doomed = [k for k in self._items if pred(k)]
            for k in doomed:
                old = self._items.pop(k)
                self._bytes -= old.nbytes()
                cache.invalidate_block(old)
            return len(doomed)

    def __len__(self):
        with self._lock:
            return len(self._items)
