"""Per-namespace time-partitioned reverse index (reference:
src/dbnode/storage/index nsIndex: per-blockstart index blocks, mutable
segments sealed and compacted into immutable segments, queried via m3ninx
searchers).

Writes land in the active block's mutable segment through the batched
`insert_many` entrypoint: the storage tier's per-shard insert queue
(storage/insert_queue.py, the shard_insert_queue/index_insert_queue
analog) coalesces new-series documents so one queue drain costs one lock
acquisition and one mutable-segment insert call, not N. Tick seals past
blocks (mutable -> immutable compaction) and expires blocks beyond
retention."""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..utils import limits as xlimits
from ..utils import tracing
from ..utils import xtime
from .postings_cache import PostingsListCache
from .query import Query
from .segment import (Document, ImmutableSegment, MutableSegment,
                      dedup_sorted_ids, execute)


class IndexBlock:
    """index/block.go: one index block's segments."""

    def __init__(self, block_start: int,
                 plcache: Optional[PostingsListCache] = None):
        self.block_start = block_start
        self.plcache = plcache
        self.mutable = MutableSegment()
        self.immutable: List[ImmutableSegment] = []
        self.sealed = False
        # Generation-cached frozen view of the mutable segment: queries scan
        # immutable snapshots outside the index lock, so a slow regexp never
        # stalls the write path (which inserts under that lock). The freeze
        # cost is paid once per write burst, not per query.
        self._gen = 0
        self._snap: Optional[ImmutableSegment] = None
        self._snap_gen = -1

    def insert(self, doc):
        self.mutable.insert(doc)
        self._gen += 1

    def insert_many(self, docs):
        """Batched insert: one mutable-segment call and one generation
        bump per queue drain, not per document."""
        self.mutable.insert_batch(docs)
        self._gen += 1

    def segments(self):
        segs = list(self.immutable)
        if len(self.mutable):
            segs.append(self.mutable)
        return segs

    def snapshot_parts(self):
        """Under the index lock: cached frozen view when current, else a
        cheap shallow copy of the mutable docs (Documents are immutable) so
        the O(fields x terms) freeze itself can run OUTSIDE the lock —
        under steady interleaved ingest the cache would never hit, and
        rebuilding inside the lock would stall every shard's write path.
        Returns (immutables, cached_snap_or_None, docs_or_None, gen)."""
        if not len(self.mutable):
            return list(self.immutable), None, None, self._gen
        if self._snap_gen == self._gen:
            return list(self.immutable), self._snap, None, self._gen
        return list(self.immutable), None, list(self.mutable._docs), self._gen

    def store_snapshot(self, snap: ImmutableSegment, gen: int):
        """Under the index lock: publish a freeze built outside it (kept
        only if no newer snapshot landed first)."""
        if gen > self._snap_gen:
            self._drop_segment(self._snap)
            self._snap = snap
            self._snap_gen = gen
        else:
            self._drop_segment(snap)

    def _drop_segment(self, seg: Optional[ImmutableSegment]):
        """A segment left the serving set: purge its cached postings."""
        if seg is not None and self.plcache is not None:
            self.plcache.invalidate_segment(seg.gen)

    def drop_all(self):
        """Block expired: purge every cached segment generation."""
        self._drop_segment(self._snap)
        for seg in self.immutable:
            self._drop_segment(seg)

    def seal(self):
        """Mutable -> immutable compaction; merge accumulated immutables
        (index/compaction/compactor.go plan: fewest, largest segments).
        Every segment this drops — the stale snapshot and the pre-merge
        immutables — is invalidated in the postings cache."""
        if len(self.mutable):
            self.immutable.append(ImmutableSegment.from_mutable(self.mutable))
            self.mutable = MutableSegment()
            self._drop_segment(self._snap)
            self._snap, self._snap_gen = None, -1
        if len(self.immutable) > 1:
            merged = ImmutableSegment.merge(self.immutable)
            for seg in self.immutable:
                self._drop_segment(seg)
            self.immutable = [merged]
        self.sealed = True

    def query(self, q: Query) -> Set[bytes]:
        out: Set[bytes] = set()
        for seg in self.segments():
            pos = execute(seg, q, cache=self.plcache)
            if len(pos):
                out.update(seg.ids_for(pos))
        return out


_tuple_new = tuple.__new__


def tags_to_doc(series_id: bytes, tags: dict) -> Document:
    """index/convert: series id + tags -> indexed document. Runs once
    per new series on the write path's insert-queue drain, so it skips
    the NamedTuple's generated Python-level __new__ and constructs the
    underlying tuple directly (identical object; Document is a plain
    tuple subclass)."""
    return _tuple_new(Document, (series_id, tuple(sorted(tags.items()))))


class NamespaceIndex:
    def __init__(self, block_size_ns: int = 4 * xtime.HOUR,
                 clock=None, postings_cache_capacity: int = 4096):
        self.block_size_ns = block_size_ns
        self.clock = clock
        self.blocks: Dict[int, IndexBlock] = {}
        # Query-scoped postings resolution cache shared by every block
        # (storage/index/postings_list_cache.go): keyed on segment
        # generation, so seal/merge/expiry invalidate per segment.
        self.postings_cache = PostingsListCache(postings_cache_capacity)
        self._known: Set[bytes] = set()
        # Inserts arrive concurrently from every shard's write path and
        # race queries and the mediator's tick/seal (the per-shard locks do
        # not serialize cross-shard index access — reference: index.go
        # nsIndex RWMutex). One reentrant lock guards blocks, _known, and
        # every mutable-segment access; sealed ImmutableSegments are
        # read-only and safe outside it once obtained.
        self._lock = threading.RLock()

    def _block_for(self, t_ns: int) -> IndexBlock:
        bs = xtime.truncate(t_ns, self.block_size_ns)
        blk = self.blocks.get(bs)
        if blk is None:
            blk = self.blocks[bs] = IndexBlock(bs, plcache=self.postings_cache)
        return blk

    def insert(self, series_id: bytes, tags: dict, t_ns: Optional[int] = None):
        """nsIndex.WriteBatch analog (per new series)."""
        with self._lock:
            if series_id in self._known:
                return
            self._known.add(series_id)
            if t_ns is None:
                t_ns = self.clock() if self.clock else 0
            self._block_for(t_ns).insert(tags_to_doc(series_id, tags))

    def insert_batch(self, items: List[Tuple[bytes, dict]], t_ns: int):
        self.insert_many(items, t_ns)

    def insert_many(self, items: List[Tuple[bytes, dict]],
                    t_ns: Optional[int] = None):
        """Batched nsIndex insert — the insert-queue drain entrypoint
        (index_insert_queue.go InsertBatch): documents are built outside
        the lock, the lock is taken ONCE, already-known ids are filtered
        with set ops, and the survivors land in one mutable-segment
        insert call. One drain therefore costs one lock acquisition and
        one segment insert, not N of each."""
        if t_ns is None:
            t_ns = self.clock() if self.clock else 0
        docs = [tags_to_doc(sid, tags) for sid, tags in items]
        with self._lock:
            known = self._known
            fresh = [d for d in docs if d.id not in known]
            if not fresh:
                return
            known.update(d.id for d in fresh)
            self._block_for(t_ns).insert_many(fresh)

    def _snapshot_segments(self, start_ns, end_ns) -> List[ImmutableSegment]:
        """Frozen immutable views of every overlapping block. The lock is
        held only for dict snapshots and doc-list copies; the actual
        freezes (and all scanning) run outside it, so neither a slow query
        nor the freeze itself ever blocks ingest. Freezes are
        generation-cached and published back, amortizing over read-heavy
        periods."""
        segs: List[ImmutableSegment] = []
        pending = []  # (block, docs, gen)
        with self._lock:
            for bs, blk in list(self.blocks.items()):
                if bs + self.block_size_ns <= start_ns or bs >= end_ns:
                    continue
                imm, snap, docs, gen = blk.snapshot_parts()
                segs.extend(imm)
                if snap is not None:
                    segs.append(snap)
                elif docs is not None:
                    pending.append((blk, docs, gen))
        for blk, docs, gen in pending:
            tmp = MutableSegment()
            tmp.insert_batch(docs)
            snap = ImmutableSegment.from_mutable(tmp)
            segs.append(snap)
            with self._lock:
                blk.store_snapshot(snap, gen)
        return segs

    def query(self, q: Query, start_ns: int = 0, end_ns: int = 2**63 - 1,
              limit: int = 0) -> List[bytes]:
        """nsIndex.Query: union across blocks overlapping [start, end).

        Results materialize via one id-array gather per segment (no
        per-posting Python): each segment returns its matches already
        lexicographically sorted through its precomputed rank arrays, so
        the single-segment fast path never compares bytes at query time.
        Leaf postings resolve through the shared postings-list cache.
        `limit` truncates AFTER the sorted union so the prefix is
        deterministic (the RPC's limit semantics).

        Every segment's matched postings are charged to the docs-matched
        query limit BEFORE materialization (query_limits.go charges docs
        at postings evaluation): a regexp matching the whole namespace is
        rejected by ResourceExhausted before it gathers a single id."""
        # child_span: real only under an already-sampled request (rpc
        # dispatch / executor) — a bare index query pays one TLS read
        # (the obs_overhead_guard's index bench contract).
        with tracing.child_span("index.query") as sp:
            parts = []
            segs = 0
            for seg in self._snapshot_segments(start_ns, end_ns):
                segs += 1
                pos = execute(seg, q, cache=self.postings_cache)
                if len(pos):
                    xlimits.charge("docs_matched", int(len(pos)))
                    parts.append(seg.sorted_ids_for(pos))
            if not parts:
                return []
            if len(parts) == 1:
                ids = parts[0]
            else:
                ids = np.concatenate(parts)
                ids.sort(kind="stable")
                ids = dedup_sorted_ids(ids)
            out = ids.tolist()
            sp.set_tag("segments", segs).set_tag("ids", len(out))
            return out[:limit] if limit else out

    def postings_cache_stats(self) -> dict:
        return self.postings_cache.stats()

    def aggregate_terms(self, field: bytes, start_ns: int = 0, end_ns: int = 2**63 - 1) -> List[bytes]:
        """Distinct values for a tag (complete-tags / tag-values API)."""
        vals: Set[bytes] = set()
        for seg in self._snapshot_segments(start_ns, end_ns):
            vals.update(seg.terms(field))
        return sorted(vals)

    def fields(self, start_ns: int = 0, end_ns: int = 2**63 - 1) -> List[bytes]:
        names: Set[bytes] = set()
        for seg in self._snapshot_segments(start_ns, end_ns):
            names.update(seg.fields())
        return sorted(names)

    def tick(self, now_ns: int, retention_ns: int):
        """Seal past blocks; expire blocks beyond retention. Runs under the
        index lock: seal() swaps the mutable segment out, and an insert
        landing between snapshot and swap would silently vanish."""
        with self._lock:
            return self._tick_locked(now_ns, retention_ns)

    def _tick_locked(self, now_ns: int, retention_ns: int):
        for bs, blk in list(self.blocks.items()):
            if not blk.sealed and bs + self.block_size_ns <= now_ns:
                blk.seal()
            if bs + self.block_size_ns <= now_ns - retention_ns:
                for seg in self.blocks[bs].segments():
                    for i in range(len(seg)):
                        self._known.discard(seg.doc(i).id)
                self.blocks[bs].drop_all()
                del self.blocks[bs]
