"""Series registry: id <-> dense index mapping per shard.

The reference's dbShard keeps a concurrent map id -> *dbSeries with each
series owning encoders and cached blocks (storage/shard.go, generated
shard_map_gen.go). In the columnar design, per-series state collapses to a
dense int32 index used across buffer columns and block rows; the registry
is the only id-keyed structure on the hot path.

Host copy of m3_tpu/storage/series.py without the race-witness
registration (the reference's utils/racewatch.py is not ported)."""

from __future__ import annotations

from itertools import repeat
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class SeriesRegistry:
    def __init__(self):
        self._index: Dict[bytes, int] = {}
        self._ids: List[bytes] = []
        self._tags: List[Optional[dict]] = []

    def __len__(self) -> int:
        return len(self._ids)

    def get(self, series_id: bytes) -> Optional[int]:
        return self._index.get(series_id)

    def id_of(self, idx: int) -> bytes:
        return self._ids[idx]

    def tags_of(self, idx: int) -> Optional[dict]:
        return self._tags[idx]

    def get_or_create(self, series_id: bytes, tags: Optional[dict] = None) -> Tuple[int, bool]:
        idx = self._index.get(series_id)
        if idx is not None:
            if tags is not None and self._tags[idx] is None:
                self._tags[idx] = tags
            return idx, False
        idx = len(self._ids)
        # Lists BEFORE the id map: lock-free readers (lookup_batch, the
        # write fast path) resolve through _index and then read
        # _ids/_tags without the shard lock — an index published first
        # would briefly point past the lists.
        self._ids.append(series_id)
        self._tags.append(tags)
        self._index[series_id] = idx
        return idx, True

    def get_or_create_batch(self, ids: Sequence[bytes]) -> Tuple[np.ndarray, List[int]]:
        """Bulk resolve; returns (indices [N], list of newly created idxs)."""
        out, created = self.get_or_create_batch_tagged(ids, None)
        return out, [int(out[j]) for j in created]

    def get_or_create_batch_tagged(
            self, ids: Sequence[bytes],
            tags: Optional[Sequence[Optional[dict]]],
    ) -> Tuple[np.ndarray, List[int]]:
        """Bulk resolve with tags; returns (indices [N], positions in
        `ids` that created a NEW series). This is the insert-queue
        drain's registry cost, paid once per coalesced batch under the
        shard lock (shard_insert_queue.go insertSeriesBatch).

        Queued ids were unknown at enqueue time, so the all-new case is
        the common one: probe it with one C-level membership pass and
        commit with dict.update(zip(...)) instead of a Python-level
        per-id loop; races and duplicate enqueues fall back to the
        general loop."""
        n = len(ids)
        index = self._index
        id_list = self._ids
        tag_list = self._tags
        base = len(id_list)
        if not any(map(index.__contains__, ids)) and \
                len(dict.fromkeys(ids)) == n:
            out = np.arange(base, base + n, dtype=np.int32)
            # Lists BEFORE the id map (see get_or_create): lock-free
            # readers must never resolve an index past the lists' ends.
            id_list.extend(ids)
            tag_list.extend(tags if tags is not None else (None,) * n)
            index.update(zip(ids, range(base, base + n)))
            return out, list(range(n))
        out = np.empty(n, np.int32)
        created: List[int] = []
        get = index.get
        for i, sid in enumerate(ids):
            t = tags[i] if tags is not None else None
            idx = get(sid)
            if idx is None:
                idx = len(id_list)
                id_list.append(sid)
                tag_list.append(t)
                index[sid] = idx
                created.append(i)
            elif t is not None and tag_list[idx] is None:
                tag_list[idx] = t
            out[i] = idx
        return out, created

    def lookup_batch(self, ids: Sequence[bytes]) -> np.ndarray:
        """Lock-free bulk resolve against a registry snapshot (-1 for
        unknown ids). Safe without the shard lock: the id->index map is
        append-only and an index, once assigned, is never reassigned —
        a concurrent insert can only turn a miss into a hit for later
        reads, never corrupt a resolved index. This is the write path's
        fast-path resolve (the lock-free read the reference gets from
        its concurrent shard map, shard.go lookupEntryWithLock's RLock
        fast path)."""
        # map(get, ids, repeat(-1)) iterates at C speed — no Python frame
        # per id, unlike a generator expression.
        return np.fromiter(map(self._index.get, ids, repeat(-1)), np.int32,
                           count=len(ids))

    def ensure_tags(self, idx: int, tags: Optional[dict]):
        """Backfill tags for an existing series (benign when racing: both
        writers carry equivalent tags for the same id)."""
        if tags is not None and self._tags[idx] is None:
            self._tags[idx] = tags

    def all_ids(self) -> List[bytes]:
        return list(self._ids)

    def entry_bytes(self, idx: int) -> int:
        """Approximate wire bytes for serving this series' identity (id +
        tag pairs) — the per-series floor a tagged fetch pays before any
        datapoint bytes. Feeds the bytes-read query limit (the registry
        is the only id-keyed structure on the hot path, so identity-cost
        accounting lives here with it)."""
        n = len(self._ids[idx])
        tags = self._tags[idx]
        if tags:
            for k, v in tags.items():
                n += len(k) + len(v)
        return n


def charge_read(n_series: int = 0, n_points: int = 0, n_bytes: int = 0):
    """Charge a storage read against the query limits registry
    (utils.limits): series materialized, datapoints decoded, encoded
    bytes touched. One helper so every read path (database.read,
    query_ids, the node fetch fan-ins) meters identically; raises
    ResourceExhausted past a budget."""
    from ..utils import limits as xlimits

    if n_series:
        xlimits.charge("series_fetched", n_series)
    if n_points:
        xlimits.charge("datapoints_decoded", n_points)
    if n_bytes:
        xlimits.charge("bytes_read", n_bytes)

