"""Device-memory hot tier for read serving (port of
m3_tpu/storage/block_cache.py; reference: the dbnode block retriever's
series cache policies — src/dbnode/storage/series/policy.go CacheAll /
CacheRecentlyRead / CacheLRU — and the byte-bounded WiredList of
block/wired_list.go:77 that keeps hot blocks decodable without disk).

Sealed blocks are ENCODED ON THE CARD by the seal (storage/block.py
encode_block through the pack kernel); the host keeps the words, and
`DeviceBlockCache` keeps the card's copy so the next read need not
re-upload them:

  (a) retain — at seal time the shard hands the just-encoded int32 word
      tensor ([S_pad, MW], u32 bit patterns, on the card) and the padded
      npoints tensor to the cache instead of dropping them after the
      host copy, so the block stays decodable with zero H2D traffic.
  (b) serve — `SealedBlock.read`/`read_all` consult the cache before any
      decode: a hit returns the block's decoded (ts_ns int64, vals f64)
      planes (read-only numpy arrays, shared across readers); a miss on a
      HOT block (admission: `admit_after` touches per generation, the
      RecentlyRead policy's "promote on re-read") decodes the whole block
      ONCE — from the retained word tensor when present — and caches the
      planes.
  (c) bound — residency is charged to the process-wide `HBMBudget`
      (utils/hbm.py), tensors at numel() * element_size() and numpy
      planes at nbytes, evicted LRU under one global ceiling, and
      invalidated through the seal / merge / expiry / close drop hooks:
      every hook that replaces or drops a SealedBlock invalidates its
      generation, and put()s for dead generations are refused so a query
      racing a seal can never re-pin a dropped block's buffers.

Keys are block GENERATIONS: every SealedBlock construction gets a
process-unique `gen` (storage/block.py), so a merge/re-seal replacement
produces a new key by construction. Entry metadata carries (namespace,
shard, block_start) for observability.

Counters (hits/misses/evictions/invalidations/admitted/retained) export in
instrument scope `storage.block_cache`; bytes ride the shared budget's
gauges, and budget pressure is the HealthTracker memory-pressure probe.
This module's process cache and the budget under it are the port's own:
nothing here is shared with the reference package's.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils import instrument, tracing
from ..utils.hbm import HBMBudget, shared_budget, tensor_nbytes

__all__ = ["DeviceBlockCache", "get_cache", "active", "disabled",
           "wants_encoded"]

# Generations a query may still try to (re)populate after their block was
# dropped; bounded like the postings cache's dead-gen memory.
_DEAD_GENS_MAX = 4096
# Touch counters for not-yet-admitted generations (bounded; cold blocks
# cycling through fall off the end and simply restart their count).
_TOUCH_MAX = 8192

DEFAULT_ADMIT_AFTER = 2


class _Entry:
    __slots__ = ("decoded", "encoded", "nbytes", "meta")

    def __init__(self):
        self.decoded: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.encoded: Optional[tuple] = None
        self.nbytes = 0
        self.meta: Optional[Tuple[bytes, int, int]] = None


class DeviceBlockCache:
    """LRU-with-admission over sealed blocks' device buffers and decoded
    planes, keyed by block generation, bounded by the shared HBM budget."""

    def __init__(self, budget: Optional[HBMBudget] = None,
                 admit_after: Optional[int] = None,
                 scope: Optional[instrument.Scope] = None,
                 tenant: str = "block_cache"):
        self.budget = budget if budget is not None else shared_budget()
        self.admit_after = admit_after if admit_after is not None else int(
            os.environ.get("M3_TPU_BLOCK_CACHE_ADMIT",
                           str(DEFAULT_ADMIT_AFTER)))
        self.enabled = os.environ.get("M3_TPU_BLOCK_CACHE", "1") != "0"
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._touch: "OrderedDict[int, int]" = OrderedDict()
        self._dead: "OrderedDict[int, None]" = OrderedDict()
        # Generations with an admission decode in flight (single-flight:
        # a burst of readers crossing the admission threshold must not
        # stampede N whole-block decodes — losers fall back to the plain
        # per-row path until the winner publishes).
        self._decoding: set = set()
        self._bytes = 0
        scope = scope or instrument.ROOT.sub_scope("storage.block_cache")
        self._hits = scope.counter("hits")
        self._misses = scope.counter("misses")
        self._evictions = scope.counter("evictions")
        self._invalidations = scope.counter("invalidations")
        self._admitted = scope.counter("admitted")
        self._retained = scope.counter("retained")
        self._bytes_gauge = scope.gauge("bytes")
        # Per-instance tallies (the instrument scope aggregates
        # process-wide by name — the postings-cache convention).
        self._n = {"hits": 0, "misses": 0, "evictions": 0,
                   "invalidations": 0, "admitted": 0, "retained": 0}
        self.budget.register(tenant, self.resident_bytes, self.evict_one)

    # ---------------------------------------------------------------- serving

    def decoded(self, blk) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The block's decoded (ts_ns [S, W], vals [S, W]) planes — frozen,
        shared — or None when the block hasn't earned admission yet.
        Records the touch either way; an admission decodes the whole block
        once (from retained device buffers when present)."""
        gen = blk.gen
        with self._lock:
            e = self._entries.get(gen)
            if e is not None and e.decoded is not None:
                self._entries.move_to_end(gen)
                self._n["hits"] += 1
                self._hits.inc()
                tracing.count_cost("block_cache_hit")
                return e.decoded
            self._n["misses"] += 1
            self._misses.inc()
            # Per-span cache attribution: a slow query whose span shows
            # block_cache_miss > 0 gets the typed "cold-cache" reason.
            tracing.count_cost("block_cache_miss")
            if gen in self._dead:
                return None
            touches = self._touch.pop(gen, 0) + 1
            self._touch[gen] = touches
            while len(self._touch) > _TOUCH_MAX:
                self._touch.popitem(last=False)
            encoded = e.encoded if e is not None else None
            if touches < self.admit_after or gen in self._decoding:
                return None
            self._decoding.add(gen)
        # Admission (single-flight): decode outside the lock (the decode
        # kernel on the current stream; the planes come back as host
        # arrays, so the copy has synchronised before they are shared),
        # then publish.
        try:
            ts, vals = blk._decode_plane(encoded)
            out = self._put_decoded(gen, blk, ts, vals)
        finally:
            with self._lock:
                self._decoding.discard(gen)
        self.budget.reclaim()
        return out

    def _put_decoded(self, gen: int, blk, ts: np.ndarray, vals: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self._lock:
            if gen in self._dead:
                # A seal/merge/expiry dropped this generation while we
                # decoded: never re-pin its arrays (the postings-cache
                # racing-seal contract). The decode result is still
                # returned to THIS caller — it is correct data.
                return (ts, vals)
            e = self._entries.get(gen)
            if e is None:
                e = self._entries[gen] = _Entry()
            if e.decoded is not None:
                old = sum(a.nbytes for a in e.decoded)
                e.nbytes -= old
                self._bytes -= old
            e.decoded = (ts, vals)
            added = ts.nbytes + vals.nbytes
            e.nbytes += added
            self._bytes += added
            if e.encoded is not None:
                # The decoded planes supersede the retained encode
                # buffers: nothing re-reads them once a plane is resident
                # (eviction drops the whole entry), so keeping both would
                # double-charge every hot block to the budget.
                freed = sum(tensor_nbytes(a) for a in e.encoded)
                e.encoded = None
                e.nbytes -= freed
                self._bytes -= freed
            self._entries.move_to_end(gen)
            self._touch.pop(gen, None)
            self._n["admitted"] += 1
            self._admitted.inc()
            self._bytes_gauge.update(self._bytes)
            return e.decoded

    # --------------------------------------------------------------- retain

    def retain_encoded(self, blk, namespace: Optional[bytes] = None,
                       shard_id: int = -1) -> bool:
        """Adopt the just-encoded device tensors a seal left on `blk`
        (encode_block attaches them when the seal ran on the card) so the
        block stays decodable there. Returns True when the tensors were
        retained."""
        dev = blk.__dict__.pop("_encoded_dev", None)
        if dev is None or not self.enabled:
            return False
        words, npoints = dev
        added = tensor_nbytes(words) + tensor_nbytes(npoints)
        gen = blk.gen
        with self._lock:
            if gen in self._dead:
                return False
            e = self._entries.get(gen)
            if e is None:
                e = self._entries[gen] = _Entry()
            if e.encoded is not None:
                return False  # already retained
            e.encoded = (words, npoints)
            e.nbytes += added
            self._bytes += added
            e.meta = (namespace, shard_id, blk.block_start)
            self._entries.move_to_end(gen)
            self._n["retained"] += 1
            self._retained.inc()
            self._bytes_gauge.update(self._bytes)
        return True

    def encoded(self, blk) -> Optional[tuple]:
        """The retained device (words, npoints) tensors of a block, if
        resident."""
        with self._lock:
            e = self._entries.get(blk.gen)
            if e is None or e.encoded is None:
                return None
            self._entries.move_to_end(blk.gen)
            return e.encoded

    # --------------------------------------------------------- invalidation

    def invalidate(self, gen: int) -> bool:
        """Drop one generation's residency and refuse later puts for it
        (seal/merge/expiry/evict/close hooks). Safe under callers' locks:
        pure dict work, no callbacks, no budget traffic."""
        with self._lock:
            self._dead[gen] = None
            while len(self._dead) > _DEAD_GENS_MAX:
                self._dead.popitem(last=False)
            self._touch.pop(gen, None)
            e = self._entries.pop(gen, None)
            if e is None:
                return False
            self._bytes -= e.nbytes
            self._n["invalidations"] += 1
            self._invalidations.inc()
            self._bytes_gauge.update(self._bytes)
            return True

    def invalidate_block(self, blk) -> bool:
        return self.invalidate(blk.gen)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._touch.clear()
            self._bytes = 0
            self._bytes_gauge.update(0)

    # -------------------------------------------------------------- eviction

    def evict_one(self) -> int:
        """Budget callback: drop the least-recently-used entry; returns
        bytes freed (0 when empty)."""
        with self._lock:
            if not self._entries:
                return 0
            _gen, e = self._entries.popitem(last=False)
            self._bytes -= e.nbytes
            self._n["evictions"] += 1
            self._evictions.inc()
            self._bytes_gauge.update(self._bytes)
            return e.nbytes

    # ----------------------------------------------------------------- intro

    def resident_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {**self._n, "entries": len(self._entries),
                    "bytes": self._bytes}


# ------------------------------------------------------------ process cache

_CACHE: Optional[DeviceBlockCache] = None
_CACHE_LOCK = threading.Lock()
_BYPASS = threading.local()


def get_cache() -> DeviceBlockCache:
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = DeviceBlockCache()
        return _CACHE


def active() -> Optional[DeviceBlockCache]:
    """The process cache when enabled and not bypassed, else None (read
    paths fall back to plain decode — bypass is always correct)."""
    if getattr(_BYPASS, "depth", 0):
        return None
    c = get_cache()
    return c if c.enabled else None


@contextlib.contextmanager
def disabled():
    """Bypass the cache on this thread (correctness A/B: the bench and
    property tests compare cached reads against this path)."""
    _BYPASS.depth = getattr(_BYPASS, "depth", 0) + 1
    try:
        yield
    finally:
        _BYPASS.depth -= 1


def wants_encoded(device) -> bool:
    """Whether a seal that ran on `device` should keep its encoded word
    tensors for the cache: worth it on the card (saves the H2D re-upload
    of every warm decode); on the CPU the retained tensor is just a
    duplicate host allocation. M3_TPU_BLOCK_CACHE_RETAIN=1/0 forces
    either way (tests use it)."""
    forced = os.environ.get("M3_TPU_BLOCK_CACHE_RETAIN")
    if forced is not None:
        return forced == "1" and active() is not None
    if active() is None:
        return False
    return getattr(device, "type", device) == "cuda"
