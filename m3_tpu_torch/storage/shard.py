"""Database shard (port of m3_tpu/storage/shard.py; reference:
src/dbnode/storage/shard.go dbShard).

Owns one virtual shard's series registry, mutable columnar buffer, sealed
blocks, and lifecycle (tick-driven sealing, retention expiry, flush state).
The write path mirrors shard.go:769 writeAndIndex: known-series ids
resolve through a lock-free registry snapshot and append columnar under a
narrowed shard lock (the fast path), while first-seen ids enqueue on the
shard's InsertQueue — new-series registration, their pending datapoints,
and the reverse-index document insert all land in ONE coalesced batch per
drain (shard_insert_queue.go / index_insert_queue.go parity), sync-waited
or async per ShardOptions.write_new_series_async.

`device` (None: the CUDA card) is where the shard's seals encode and its
sealed blocks decode; blocks only on disk are read through the attached
BlockRetriever (storage/retriever.py), which decodes on its device."""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve
from ..persist.diskio import CorruptionError
from ..utils import xtime
from ..utils.health import Priority
from ..utils.instrument import ROOT
from . import block_cache
from .block import SealedBlock, encode_block, merge_same_start
from .buffer import ShardBuffer
from .insert_queue import InsertGroup, InsertQueue
from .series import SeriesRegistry

_CORRUPTION = ROOT.sub_scope("storage.corruption")


class ShardState(enum.Enum):
    """cluster/shard shard states."""

    INITIALIZING = "initializing"
    AVAILABLE = "available"
    LEAVING = "leaving"


class FlushState(enum.Enum):
    """Per-(shard, block) durability state (storage/shard.go flushState)."""

    NOT_STARTED = "not_started"
    IN_PROGRESS = "in_progress"
    SUCCESS = "success"
    FAILED = "failed"


@dataclasses.dataclass
class ShardOptions:
    block_size_ns: int = 2 * xtime.HOUR
    retention_ns: int = 2 * xtime.DAY
    buffer_past_ns: int = 10 * xtime.MINUTE
    buffer_future_ns: int = 2 * xtime.MINUTE
    # Insert-queue knobs (shard_insert_queue.go). write_new_series_async
    # mirrors the reference's WriteNewSeriesAsync: False = writers wait
    # for the batch drain (read-your-write); True = writes return
    # immediately and new series become visible after one drain (tick,
    # background drainer, or shutdown).
    write_new_series_async: bool = False
    insert_max_pending: int = 65536
    insert_high_watermark: float = 0.75
    insert_interval_ns: int = 0


class Shard:
    def __init__(self, shard_id: int, opts: ShardOptions,
                 on_new_series: Optional[Callable] = None,
                 state: ShardState = ShardState.AVAILABLE,
                 on_new_series_batch: Optional[Callable] = None,
                 namespace_name: Optional[bytes] = None, device=None):
        self.shard_id = shard_id
        self.device = resolve(device)
        self.opts = opts
        self.state = state
        # Owning namespace (device-block-cache entry metadata); bound by
        # Namespace.assign_shard.
        self.namespace_name = namespace_name
        # Per-shard write/seal lock (shard.go:769 per-shard RWMutex): writes
        # to different shards never contend; a write only serializes with
        # writes to the same shard and with that shard's tick/seal. Reads
        # take the lock only to snapshot mutable dicts + buffer columns;
        # decode work runs on immutable sealed blocks outside it.
        self.write_lock = threading.RLock()
        self.registry = SeriesRegistry()
        self.buffer = ShardBuffer(opts.block_size_ns, opts.buffer_past_ns, opts.buffer_future_ns)
        self.blocks: Dict[int, SealedBlock] = {}
        self.flush_states: Dict[int, FlushState] = {}
        # Callback (series_id, tags, series_idx) when a series is first seen
        # — the namespace wires this to reverse-index insertion
        # (shard.go:769 writeAndIndex's index hook). The batch form
        # receives one [(series_id, tags, idx)] list per queue drain so a
        # drain costs ONE index insert call, not N; when set it replaces
        # the per-series callback.
        self.on_new_series = on_new_series
        self.on_new_series_batch = on_new_series_batch
        # New-series inserts coalesce here; drains apply the whole batch
        # under one write_lock acquisition (shard_insert_queue.go:52).
        self.insert_queue = InsertQueue(
            self._drain_inserts,
            max_pending=opts.insert_max_pending,
            high_watermark=opts.insert_high_watermark,
            interval_ns=opts.insert_interval_ns)
        # Disk retriever for cold reads (block/retriever_manager.go hook);
        # bound by Namespace.assign_shard when the database has one.
        self._retriever = None
        self._retriever_ns: Optional[bytes] = None
        # Updated each tick; disk reads never serve past it even if cleanup
        # hasn't deleted the fileset yet (None until the first tick).
        self._retention_cutoff: Optional[int] = None

    # ------------------------------------------------------------------ write

    def write(self, series_id: bytes, t_ns: int, value: float, now_ns: int,
              tags: Optional[dict] = None,
              priority: Priority = Priority.NORMAL) -> bool:
        if not self.buffer.accepts(now_ns, t_ns):
            raise ValueError(
                f"datapoint at {t_ns} outside acceptance window at {now_ns} "
                f"(past {self.opts.buffer_past_ns}, future {self.opts.buffer_future_ns})"
            )
        idx = self.registry.get(series_id)  # lock-free snapshot resolve
        if idx is not None:
            self.registry.ensure_tags(idx, tags)
            with self.write_lock:
                self.buffer.write(idx, t_ns, value)
            return False
        self.insert_queue.insert(
            InsertGroup([series_id], [tags] if tags is not None else None,
                        ts=np.array([t_ns], np.int64),
                        vals=np.array([value], np.float64)),
            priority=priority, sync=not self.opts.write_new_series_async)
        return True

    def write_batch(self, ids: Sequence[bytes], ts: np.ndarray, vals: np.ndarray,
                    now_ns: int, tags: Optional[Sequence[Optional[dict]]] = None,
                    priority: Priority = Priority.NORMAL):
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        ok = (ts >= now_ns - self.opts.buffer_past_ns) & (ts <= now_ns + self.opts.buffer_future_ns)
        if not ok.all():
            bad = int((~ok).sum())
            raise ValueError(f"{bad} datapoints outside acceptance window")
        # Fast path: resolve every id against a lock-free registry
        # snapshot; the write lock narrows to the columnar append.
        sidx = self.registry.lookup_batch(ids)
        unknown = sidx < 0
        if tags:
            # Known series first written untagged (bootstrap, tagless
            # writes) backfill their tags here, matching the single-write
            # path and the old get_or_create(sid, tags) behavior.
            ensure = self.registry.ensure_tags
            for i in np.flatnonzero(sidx >= 0):
                t = tags[i]
                if t is not None:
                    ensure(int(sidx[i]), t)
        if not unknown.any():
            with self.write_lock:
                self.buffer.write_batch(sidx, ts, vals)
            return
        # Slow path: coalesce the first-seen remainder into the insert
        # queue as ONE columnar group (distinct new ids + their pending
        # points). Admission happens BEFORE any buffer append, so a
        # Backpressure shed leaves nothing partially written.
        upos = np.flatnonzero(unknown)
        uids = [ids[i] for i in upos]
        utags = [tags[i] for i in upos] if tags else None
        uniq = dict.fromkeys(uids)
        if len(uniq) == len(uids):
            # Common burst shape: every new id distinct -> zero-copy
            # columns, one point per id.
            group = InsertGroup(uids, utags, ts=ts[upos], vals=vals[upos])
        else:
            # Duplicates within the batch: order rows so each id's
            # points are one contiguous counts-run.
            rank = {sid: r for r, sid in enumerate(uniq)}
            rarr = np.fromiter((rank[sid] for sid in uids), np.int64,
                               count=len(uids))
            order = np.argsort(rarr, kind="stable")
            gids = list(uniq)
            gtags = None
            if utags is not None:
                first = {}
                for sid, tg in zip(uids, utags):
                    if sid not in first:
                        first[sid] = tg
                gtags = [first[sid] for sid in gids]
            group = InsertGroup(
                gids, gtags, counts=np.bincount(rarr, minlength=len(gids)),
                ts=ts[upos][order], vals=vals[upos][order])
        batch = self.insert_queue.insert(
            group, priority=priority, sync=False)
        known = ~unknown
        if known.any():
            with self.write_lock:
                self.buffer.write_batch(sidx[known], ts[known], vals[known])
        if not self.opts.write_new_series_async:
            if not batch.drained:
                self.insert_queue.drain()
            batch.wait()

    def _drain_inserts(self, groups: List[InsertGroup]):
        """Insert-queue drain: apply one coalesced batch — register every
        new series, append each group's pending datapoints in ONE
        columnar write, then fire ONE batched reverse-index insert for
        the whole drain. The write lock is held only for the
        registry/buffer mutation; the index insert runs outside it (the
        index has its own lock, and queries never take the shard lock —
        same visibility order as the synchronous path, minus the
        cross-component lock coupling)."""
        new_items: List[Tuple[bytes, Optional[dict], int]] = []
        with self.write_lock:
            for g in groups:
                idxs, created = self.registry.get_or_create_batch_tagged(
                    g.ids, g.tags)
                if g.ts is not None and len(g.ts):
                    sidx = (idxs if g.counts is None
                            else np.repeat(idxs, g.counts).astype(np.int32))
                    self.buffer.write_batch(sidx, g.ts, g.vals)
                if created:
                    gt = g.tags
                    new_items.extend(
                        (g.ids[j], gt[j] if gt is not None else None,
                         int(idxs[j]))
                        for j in created)
        if not new_items:
            return
        if self.on_new_series_batch is not None:
            self.on_new_series_batch(new_items)
        elif self.on_new_series is not None:
            for sid, tg, ix in new_items:
                self.on_new_series(sid, tg, ix)

    def close(self):
        """Shutdown: drain and stop the insert queue — no queued write
        is ever stranded by teardown — and drop this shard's device-
        block-cache residency (zero HBM held after namespace close)."""
        self.insert_queue.stop()
        cache = block_cache.get_cache()
        with self.write_lock:
            for blk in self.blocks.values():
                cache.invalidate_block(blk)

    # ------------------------------------------------------------------- tick

    def tick(self, now_ns: int) -> dict:
        """Seal no-longer-writable buckets into device-encoded blocks and
        expire blocks past retention (shard.go:573 tick + cleanup)."""
        # Pending async inserts land first, so seal decisions see every
        # accepted write (the queue's "visible after one drain" bound).
        self.insert_queue.drain()
        with self.write_lock:
            stats = self._tick_locked(now_ns)
        if stats["sealed"] and block_cache.active() is not None:
            # Newly retained seal buffers count against the shared HBM
            # budget; reclaim OUTSIDE the shard lock (evictors take cache
            # locks of their own).
            block_cache.get_cache().budget.reclaim()
        return stats

    def _tick_locked(self, now_ns: int) -> dict:
        """Runs under the write lock: drain, host prep and the encode on
        the shard's device (encode_block)."""
        sealed, expired = 0, 0
        cache = block_cache.get_cache()
        for bs in self.buffer.sealable(now_ns):
            # The bucket is dropped only after its encode returned: a
            # typed fault in the encode leaves every point in the buffer,
            # and the next tick seals it (the seal is all-or-nothing).
            dense = self.buffer.snapshot(bs)
            if dense is None:
                self.buffer.discard(bs)
            else:
                series, tdense, vdense, npoints = dense
                blk = encode_block(bs, series, tdense, vdense, npoints,
                                   device=self.device)
                self.buffer.discard(bs)
                prev = self.blocks.get(bs)
                if prev is not None:
                    # A drain can land writes for a block start that was
                    # already sealed (async insert racing tick): merge
                    # instead of overwriting, so nothing is lost. Both
                    # inputs' generations die with the merge (a racing
                    # query must not re-pin them; same hazard class the
                    # postings cache handles on index seal).
                    merged = merge_same_start(prev, blk)
                    cache.invalidate_block(prev)
                    cache.invalidate_block(blk)
                    blk = merged
                self.blocks[bs] = blk
                # Hot tier: adopt the seal's still-device-resident encode
                # output so warm reads decode without re-uploading it.
                cache.retain_encoded(blk, self.namespace_name, self.shard_id)
                self.flush_states.setdefault(bs, FlushState.NOT_STARTED)
                if prev is not None and \
                        self.flush_states.get(bs) == FlushState.SUCCESS:
                    # The durable fileset no longer matches the merged
                    # block — re-flush it.
                    self.flush_states[bs] = FlushState.NOT_STARTED
                sealed += 1
        cutoff = now_ns - self.opts.retention_ns
        self._retention_cutoff = cutoff
        for bs in [b for b in self.blocks if b + self.opts.block_size_ns <= cutoff]:
            cache.invalidate_block(self.blocks[bs])
            del self.blocks[bs]
            expired += 1
        # Flush states expire with retention even for blocks already evicted
        # from memory (else the dict grows one entry per block forever).
        for bs in [b for b in self.flush_states
                   if b + self.opts.block_size_ns <= cutoff]:
            del self.flush_states[bs]
        return {"sealed": sealed, "expired": expired}

    # ------------------------------------------------------------------- read

    def attach_retriever(self, retriever, namespace_name: bytes):
        """Hook a BlockRetriever for cold reads (series.go ReadEncoded's
        fall-through to the block retriever when a block isn't cached)."""
        self._retriever = retriever
        self._retriever_ns = namespace_name

    def read(self, series_id: bytes, start_ns: int, end_ns: int) -> Tuple[np.ndarray, np.ndarray]:
        """Merged datapoints from sealed blocks + mutable buffer + disk in
        [start, end).

        Block starts resident in memory are served from `self.blocks`; block
        starts only on disk fall through to the retriever (seek + WiredList,
        one decode launch of one row on a miss), mirroring series.go:292
        ReadEncoded -> buffer, cached blocks, then the retriever for
        everything else."""
        idx = self.registry.get(series_id)
        parts_t: List[np.ndarray] = []
        parts_v: List[np.ndarray] = []

        def overlaps(bs: int) -> bool:
            return not (bs + self.opts.block_size_ns <= start_ns or bs >= end_ns)

        def clip_append(got) -> None:
            if got is None:
                return
            t, v = got
            keep = (t >= start_ns) & (t < end_ns)
            parts_t.append(t[keep])
            parts_v.append(v[keep])

        # Snapshot mutable state under the shard lock (tick deletes expired
        # blocks and creates buffer buckets concurrently); SealedBlocks are
        # immutable once referenced, and the buffer read happens inside the
        # lock, so the decode/clip work below runs lock-free.
        with self.write_lock:
            blocks = dict(self.blocks)
            if idx is not None:
                bt, bv = self.buffer.read(idx, start_ns, end_ns)
            else:
                bt = bv = None
        if idx is not None:
            for bs in sorted(blocks):
                if overlaps(bs):
                    try:
                        clip_append(blocks[bs].read(idx))
                    except CorruptionError:
                        # A block paged in from a fileset flunked its lazy
                        # row verification mid-serve: drop it and keep
                        # serving the window from buffer/disk coverage —
                        # never the rotten bytes. The scrubber handles
                        # the on-disk copy.
                        self._drop_corrupt_block(bs, blocks[bs])
        if self._retriever is not None:
            on_disk = self._retriever.block_starts(self._retriever_ns, self.shard_id)
            for bs in sorted(on_disk):
                if bs in blocks or not overlaps(bs):
                    continue
                if (self._retention_cutoff is not None
                        and bs + self.opts.block_size_ns <= self._retention_cutoff):
                    continue  # past retention; cleanup just hasn't run yet
                clip_append(self._retriever.retrieve(
                    self._retriever_ns, self.shard_id, bs, series_id))
        if bt is not None and len(bt):
            parts_t.append(bt)
            parts_v.append(bv)
        if not parts_t:
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        t = np.concatenate(parts_t)
        v = np.concatenate(parts_v)
        order = np.argsort(t, kind="stable")
        t, v = t[order], v[order]
        if len(t) > 1 and (t[:-1] == t[1:]).any():
            # A sealed block and the mutable buffer can briefly cover the
            # same (series, timestamp): a snapshot-recovered block with
            # the WAL tail replayed on top (the conservative chunk-window
            # overlap), or a write racing a seal before the same-start
            # merge folds it in. Last-arrival wins, matching the buffer's
            # own drain dedup — parts append blocks-then-buffer and the
            # sort is stable, so keeping the final duplicate keeps the
            # buffer's (newer) value.
            keep = np.concatenate([t[:-1] != t[1:], [True]])
            t, v = t[keep], v[keep]
        return t, v

    def _drop_corrupt_block(self, bs: int, blk: SealedBlock) -> None:
        """Evict an in-memory block whose lazy row verification failed.
        Clearing the flush state (instead of marking FAILED) lets a
        repair re-install a clean copy and re-enter the flush schedule."""
        _CORRUPTION.counter("memory_block_dropped").inc()
        with self.write_lock:
            if self.blocks.get(bs) is blk:
                del self.blocks[bs]
            self.flush_states.pop(bs, None)
        block_cache.get_cache().invalidate_block(blk)

    # ------------------------------------------------------- flush/bootstrap

    def flushable(self, now_ns: int) -> List[int]:
        """COLD sealed blocks not yet durably flushed. The writability
        gate matters for recovery: a snapshot-recovered tile installed
        for a still-warm window (load_block NOT_STARTED) must not flush
        yet — a tile-only fileset would make the next restart's
        filesystem bootstrapper claim the whole block range and
        range-filter the WAL tail out of replay, silently dropping
        acked writes. Blocks sealed by tick are past this gate by
        construction (sealable() uses the same bound)."""
        with self.write_lock:
            return sorted(
                bs for bs, st in self.flush_states.items()
                if st in (FlushState.NOT_STARTED, FlushState.FAILED)
                and bs in self.blocks
                and bs + self.opts.block_size_ns + self.opts.buffer_past_ns
                <= now_ns
            )

    def mark_flushed(self, block_start: int, ok: bool = True):
        with self.write_lock:
            self.flush_states[block_start] = FlushState.SUCCESS if ok else FlushState.FAILED

    def evict_flushed(self) -> int:
        """Drop in-memory blocks whose fileset is durable; subsequent reads
        go through the retriever (the CacheNone/LRU cache policies of
        series/policy.go:32-48 — memory holds only what isn't yet on disk).
        The evicted blocks' block-cache residency (retained word tensors,
        decoded planes) is released with them.

        A block is only evicted when its fileset is actually present on
        disk: a block installed as durable elsewhere may be the only local
        copy."""
        if self._retriever is None:
            return 0
        on_disk = self._retriever.block_starts(self._retriever_ns, self.shard_id)
        evicted = 0
        cache = block_cache.get_cache()
        with self.write_lock:
            for bs in [b for b, st in self.flush_states.items()
                       if st == FlushState.SUCCESS and b in self.blocks and b in on_disk]:
                cache.invalidate_block(self.blocks[bs])
                del self.blocks[bs]
                evicted += 1
        return evicted

    # ------------------------------------------------------------ install

    def load_block(self, blk: SealedBlock, remap: Optional[np.ndarray] = None,
                   flush_state: FlushState = FlushState.SUCCESS):
        """Install a block sealed elsewhere (bootstrap result merge; a block
        of the reference package converted by convert.sealed_block_to_torch).

        `remap` translates the block's series indices into this registry's
        (peer blocks arrive with the remote's indices). `flush_state` is
        the durability state the install implies: peer-streamed blocks
        are durable on the donor (SUCCESS, the default); a block rebuilt
        from a SNAPSHOT fileset is NOT durably flushed — NOT_STARTED
        keeps it on the flush schedule so the snapshot+WAL copy stops
        being its only durable form."""
        if remap is not None:
            blk = dataclasses.replace(blk, series_indices=remap.astype(np.int32))
            order = np.argsort(blk.series_indices)
            blk.series_indices = blk.series_indices[order]
            blk.words = blk.words[order]
            blk.nbits = blk.nbits[order]
            blk.npoints = blk.npoints[order]
        with self.write_lock:
            old = self.blocks.get(blk.block_start)
            if old is not None:
                block_cache.get_cache().invalidate_block(old)
            self.blocks[blk.block_start] = blk
            self.flush_states.setdefault(blk.block_start, flush_state)

    def num_series(self) -> int:
        return len(self.registry)
