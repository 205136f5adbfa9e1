"""Segment-scoped postings-list cache (reference:
src/dbnode/storage/index/postings_list_cache.go — an LRU over resolved
postings keyed on (segment UUID, field, pattern), consulted by the
read-through wrappers in postings_list_cache_lru.go before a term or
regexp is re-resolved against the FST).

Keys here are (segment generation, field, kind, pattern-or-term): every
ImmutableSegment carries a process-unique generation id, so a seal or
merge that replaces segments makes the old entries unreachable by
construction — invalidate_segment() additionally purges them eagerly so
a churned block can't hold the LRU's capacity hostage. Values are the
resolved sorted-unique int32 postings arrays, frozen (writeable=False)
because hits hand back the SAME array a cold miss produced.

Field and key are normalized to bytes at the boundary: the wire paths
hand the index bytes/bytearray/memoryview interchangeably, and a
mutable buffer must never become (part of) a cache key — the same
regression class m3lint's cache-key-buffer rule guards for functools
caches (m3_tpu/analysis/cache_rules.py).

Hit/miss/eviction counters export through utils/instrument (scope
`index.postings_cache`), dogfooded into /debug/vars like every other
component's metrics.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..utils import instrument

DEFAULT_CAPACITY = 4096


class PostingsListCache:
    # Bounded memory of invalidated generations: a query racing a seal
    # outside the index lock may try to (re)populate entries for a
    # segment that was just dropped — put() refuses those, so dead
    # segments' postings can't linger until LRU eviction.
    _DEAD_GENS_MAX = 1024

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 scope: Optional[instrument.Scope] = None):
        self.capacity = capacity
        self._lru: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        self._dead: "OrderedDict[int, None]" = OrderedDict()
        self._lock = threading.Lock()
        # Instrument counters are process-wide totals (Scope keys metrics
        # by name, so every cache in the process shares them — the tally
        # convention); per-CACHE numbers come from the plain ints below,
        # which is what stats() reports.
        scope = scope or instrument.ROOT.sub_scope("index.postings_cache")
        self._hits = scope.counter("hits")
        self._misses = scope.counter("misses")
        self._evictions = scope.counter("evictions")
        self._invalidations = scope.counter("invalidations")
        self._n_hits = 0
        self._n_misses = 0
        self._n_evictions = 0
        self._n_invalidations = 0

    @staticmethod
    def _key(seg_gen: int, field: bytes, kind: str, key: bytes) -> Tuple:
        # bytes() is a no-op copy for bytes and a snapshot for bytearray/
        # memoryview — the key must not alias a caller-mutable buffer.
        return (seg_gen, bytes(field), kind, bytes(key))

    def get(self, seg_gen: int, field: bytes, kind: str,
            key: bytes) -> Optional[np.ndarray]:
        k = self._key(seg_gen, field, kind, key)
        with self._lock:
            arr = self._lru.get(k)
            if arr is None:
                self._n_misses += 1
                self._misses.inc()
                return None
            self._lru.move_to_end(k)
            self._n_hits += 1
            self._hits.inc()
            return arr

    def put(self, seg_gen: int, field: bytes, kind: str, key: bytes,
            postings: np.ndarray) -> np.ndarray:
        postings.setflags(write=False)
        k = self._key(seg_gen, field, kind, key)
        with self._lock:
            if seg_gen in self._dead:
                return postings
            self._lru[k] = postings
            self._lru.move_to_end(k)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)
                self._n_evictions += 1
                self._evictions.inc()
        return postings

    def invalidate_segment(self, seg_gen: int) -> int:
        """Purge every entry of one segment generation (seal/merge/expiry
        dropped it); later put()s for it are refused (in-flight queries
        may still hold the dropped segment)."""
        with self._lock:
            self._dead[seg_gen] = None
            while len(self._dead) > self._DEAD_GENS_MAX:
                self._dead.popitem(last=False)
            dead = [k for k in self._lru if k[0] == seg_gen]
            for k in dead:
                del self._lru[k]
            if dead:
                self._n_invalidations += len(dead)
                self._invalidations.inc(len(dead))
            return len(dead)

    def clear(self):
        with self._lock:
            self._lru.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def stats(self) -> dict:
        """THIS cache's counters (the instrument scope aggregates across
        every cache in the process)."""
        with self._lock:
            return {"hits": self._n_hits, "misses": self._n_misses,
                    "evictions": self._n_evictions,
                    "invalidations": self._n_invalidations,
                    "size": len(self._lru)}
