"""Flush management: leader flushes, followers shadow via KV-persisted flush
times (reference: src/aggregator/aggregator/{flush_mgr.go:188,
leader_flush_mgr.go, follower_flush_mgr.go, flush_times_mgr.go}).

The leader consumes closed windows and emits them to handlers, then persists
per-resolution flushed-up-to times to the KV store. Followers run the same
windowed state but, instead of emitting, discard windows the leader has
already flushed — so on failover the new leader resumes exactly one window
after the old leader's last persisted flush, never double-emitting.

Port of m3_tpu/aggregator/flush.py: host code; a standalone flush orders
its quantiles on its lists' device."""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

from ..cluster import kv as cluster_kv
from .election import ElectionManager, ElectionState
from .list import MetricLists


class FlushTimesManager:
    """Persist/read per-(shard, resolution) flush times in KV
    (flush_times_mgr.go; the proto ShardSetFlushTimes is likewise keyed by
    shard within the shard set, so concurrent shard flushes never clobber
    each other's entries)."""

    def __init__(self, store: cluster_kv.MemStore, shard_set_id: str):
        self._store = store
        self._prefix = f"_agg/flush_times/{shard_set_id}"

    def _key(self, shard_id: int) -> str:
        return f"{self._prefix}/{shard_id}"

    def get(self, shard_id: int) -> Dict[int, int]:
        val = self._store.get(self._key(shard_id))
        if val is None:
            return {}
        raw = json.loads(val.data.decode())
        return {int(k): int(v) for k, v in raw.items()}

    def store(self, shard_id: int, flush_times: Dict[int, int]):
        self._store.set(self._key(shard_id), json.dumps(
            {str(k): v for k, v in flush_times.items()}).encode())

    def store_many(self, updates: Dict[int, Dict[int, int]]):
        """Persist one flush round's times for MANY shards as one kv
        transaction (MemStore.set_many): leader flush no longer
        serializes on a kv round trip per shard. Stores without a batch
        API (e.g. the remote kv client) fall back to per-shard sets."""
        if not updates:
            return
        items = {self._key(sid): json.dumps(
            {str(k): v for k, v in ft.items()}).encode()
            for sid, ft in updates.items()}
        set_many = getattr(self._store, "set_many", None)
        if set_many is not None:
            set_many(items)
        else:
            for key, data in items.items():
                self._store.set(key, data)


class FlushManager:
    """Drives per-resolution flushes against election state (flush_mgr.go:188).

    flush(now) aligns each resolution's flush target to its window boundary:
    target = now - now % resolution, consuming every fully-closed window.
    """

    def __init__(self, lists: MetricLists, election: ElectionManager,
                 flush_times: FlushTimesManager,
                 flush_fn: Callable, forward_fn: Optional[Callable] = None,
                 buffer_past_ns: int = 0, shard_id: int = 0):
        self._lists = lists
        self._election = election
        self._flush_times = flush_times
        self._flush_fn = flush_fn
        self._forward_fn = forward_fn
        self._shard_id = shard_id
        # Extra delay before a window is considered closed, allowing late
        # arrivals (list.go flushBeforeFn maxLatenessAllowed analog).
        self._buffer_past_ns = buffer_past_ns
        self.windows_flushed = 0
        self.windows_discarded = 0

    def flush(self, now_nanos: int) -> int:
        """One standalone flush pass; returns number of windows consumed."""
        from .list import FlushBatch, emit_batch

        batch = FlushBatch()
        n, commit = self.plan_into(now_nanos, batch)
        emit_batch(batch, self._flush_fn, self._forward_fn,
                   self._lists.device)
        commit()
        return n if self._election.state == ElectionState.LEADER else 0

    def plan_into(self, now_nanos: int, batch):
        """Collect this manager's closed windows into `batch` (a columnar
        list.FlushBatch, so a caller can batch many managers' shards into
        ONE device reduction — Aggregator.flush does this across shards)
        plus a commit callback. commit(pending=None): with a dict, the
        shard's updated flush times are RECORDED into it for one batched
        FlushTimesManager.store_many; without, they store immediately.
        Returns (windows_collected, commit)."""
        self._election.campaign()
        if self._election.state == ElectionState.LEADER:
            return self._plan_as_leader(now_nanos, batch)
        return self._plan_as_follower(now_nanos)

    def _plan_as_leader(self, now_nanos: int, batch):
        flushed = self._flush_times.get(self._shard_id)
        n = 0
        stale = 0
        for lst in self._lists.lists():
            res = lst.resolution_ns
            target = (now_nanos - self._buffer_past_ns) // res * res
            # Windows the previous leader already flushed (per KV flush
            # times) are discarded, not re-emitted: a promoted follower
            # may still hold closed windows it had not yet discarded, and
            # re-emitting them would double-count in forwarded rollup
            # pipelines.
            c, d = lst.collect_into(target, batch,
                                    already=flushed.get(res, 0))
            n += c
            stale += d
            # Resume after the last persisted flush (leader_flush_mgr.go:
            # flush times seed the flush schedule on promotion).
            flushed[res] = max(flushed.get(res, 0), target)
        self.windows_discarded += stale
        self.windows_flushed += n

        def commit(pending: Optional[Dict[int, Dict[int, int]]] = None):
            if pending is None:
                self._flush_times.store(self._shard_id, flushed)
            else:
                pending[self._shard_id] = flushed

        return n, commit

    def _plan_as_follower(self, now_nanos: int):
        """Discard windows the leader already flushed (follower_flush_mgr.go
        flushersFromKVUpdateFn): keeps follower memory bounded and marks the
        follower caught-up so PendingFollower can complete."""
        flushed = self._flush_times.get(self._shard_id)
        caught_up = True
        discarded = 0
        for lst in self._lists.lists():
            leader_target = flushed.get(lst.resolution_ns)
            if leader_target is None:
                caught_up = False
                continue
            discarded += len(lst.collect(leader_target))
        self.windows_discarded += discarded

        def commit(pending=None):
            if caught_up:
                self._election.confirm_follower()

        return 0, commit


def plan_jobs(lists: MetricLists, now_nanos: int, buffer_past_ns: int,
              flush_fn: Callable, forward_fn: Optional[Callable],
              flushed: Optional[Dict[int, int]] = None):
    """Collect closed-window reduce jobs for every list, with the flush
    target aligned down to each resolution boundary (list.go flush-before
    alignment). Shared by the managed (leader) and leaderless paths.

    With `flushed` (per-resolution flushed-up-to times from KV), windows
    already covered by a previous leader's persisted flush are dropped.
    Returns (jobs, n_dropped).
    """
    jobs = []
    dropped = 0
    for lst in lists.lists():
        res = lst.resolution_ns
        target = (now_nanos - buffer_past_ns) // res * res
        already = flushed.get(res, 0) if flushed else 0
        for elem, start, vals in lst.collect(target):
            if start + res <= already:
                dropped += 1
                continue
            jobs.append((elem, start, vals, flush_fn, forward_fn))
    return jobs, dropped
