"""Top-level database (port of m3_tpu/storage/database.py; reference:
src/dbnode/storage/database.go `db` + mediator.go background lifecycle).

Owns namespaces, routes writes by shard hash (the hash kernel, once per
write_batch), appends to the commit log, and drives the tick -> seal ->
flush -> cleanup lifecycle. Background behavior is explicit (`tick()`,
`flush()`) so tests and services control timing; storage/mediator.py
wraps it in a ticker thread.

`device` (None: the CUDA card, raising without one) is threaded down to
every namespace and shard: routing, seals, sealed-block reads and the
blooms of flushed filesets run there. The commit log, the filesets and
bootstrap write and read the reference's formats byte for byte
(persist/commitlog.py, persist/fs.py, storage/bootstrap.py)."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..device import resolve
from ..persist.diskio import DiskWriteError
from ..utils import tracing
from ..utils.health import DiskHealth, Priority
from ..utils.instrument import ROOT
from ..utils.limits import Backpressure
from ..utils.retry import RetryOptions, Retrier
from .namespace import Namespace, NamespaceOptions
from .series import charge_read

_FLUSH_METRICS = ROOT.sub_scope("storage.flush")

def fold_tags(out: Dict[bytes, set], tags, filter_set, name_only: bool):
    """Fold one series' tags into a CompleteTags accumulator — the single
    definition of filter/name-only semantics shared by the index-backed
    aggregate path and the fetch-derived fallback in query.storage."""
    for k, v in (tags or {}).items():
        if filter_set is not None and k not in filter_set:
            continue
        vals = out.setdefault(k, set())
        if not name_only:
            vals.add(v)


class Database:
    def __init__(self, shard_set, commitlog=None,
                 clock: Callable[[], int] = None, retriever=None, *,
                 device=None):
        """shard_set: parallel.sharding.ShardSet; commitlog:
        persist.commitlog.CommitLog; retriever: storage.retriever.
        BlockRetriever for disk-backed reads; device: where routing, seals
        and reads run (None: the CUDA card)."""
        self.shard_set = shard_set
        self.device = resolve(device)
        self.commitlog = commitlog
        self.clock = clock or (lambda: time.time_ns())
        self.retriever = retriever
        self.namespaces: Dict[bytes, Namespace] = {}
        # Guards namespace map mutation; iterating code snapshots
        # values() under the GIL.
        self._ns_lock = threading.Lock()
        self._bootstrapped = False
        # Durable-write health: WAL/flush failures degrade the node to a
        # read-only posture (NORMAL/BULK writes shed with Backpressure,
        # CRITICAL and reads keep flowing); the first durable success
        # lifts it.
        self.disk_health = DiskHealth(trip_after=3)
        # Per-block flush retry: one quick re-attempt absorbs a transient
        # media error; a persistent one surfaces typed, marks the block
        # FAILED (still on the flush schedule) and degrades health.
        self._flush_retrier = Retrier(RetryOptions(
            max_attempts=2, initial_backoff_s=0.02, max_backoff_s=0.1,
            jitter=False))

    # ------------------------------------------------------------- namespaces

    def create_namespace(self, name: bytes, opts: NamespaceOptions = NamespaceOptions(),
                         index=None) -> Namespace:
        with self._ns_lock:
            if name in self.namespaces:
                raise ValueError(f"namespace {name!r} already exists")
            ns = Namespace(name, opts, self.shard_set.all_shard_ids(), index=index,
                           retriever=self.retriever, device=self.device)
            self.namespaces[name] = ns
            return ns

    def ensure_namespace(self, name: bytes,
                         opts: Optional[NamespaceOptions] = None) -> Namespace:
        """Create-if-absent with the standard index wiring — the single
        namespace-creation path shared by config startup, the coordinator
        admin API, and the KV registry watch."""
        existing = self.namespaces.get(name)
        if existing is not None:
            return existing
        opts = opts or NamespaceOptions()
        index = None
        if opts.index_enabled:
            from ..index.namespace_index import NamespaceIndex

            index = NamespaceIndex(clock=self.clock)
        try:
            return self.create_namespace(name, opts, index=index)
        except ValueError:
            return self.namespaces[name]  # lost a creation race: reuse

    def set_retriever(self, retriever):
        """Attach a disk retriever (serving-path cold reads) to every
        namespace, current and future."""
        self.retriever = retriever
        for ns in list(self.namespaces.values()):
            ns.set_retriever(retriever)

    def drop_namespace(self, name: bytes):
        """Remove a namespace (namespace_watch.go applying a registry
        removal): in-flight reads of the dropped object finish against its
        now-orphaned state; new operations get KeyError. The namespace is
        closed after removal — insert queues drain and its device-block-
        cache residency drops (in-flight reads re-decode; dead-generation
        puts are refused)."""
        with self._ns_lock:
            ns = self.namespaces.pop(name, None)
        if ns is not None:
            ns.close()

    def namespace(self, name: bytes) -> Namespace:
        ns = self.namespaces.get(name)
        if ns is None:
            raise KeyError(f"no such namespace {name!r}")
        return ns

    # ------------------------------------------------------------------ write

    def write(self, namespace: bytes, series_id: bytes, t_ns: int, value: float,
              tags: Optional[dict] = None, priority=None):
        """database.go:536 Write + :561 commit log append."""
        ns = self.namespace(namespace)
        self._check_writable(priority)
        shard_id = self.shard_set.lookup(series_id)
        now = self.clock()
        if priority is None:
            ns.write(shard_id, series_id, t_ns, value, now, tags)
        else:
            ns.shard_for(shard_id).write(series_id, t_ns, value, now, tags,
                                         priority=priority)
        if self.commitlog is not None and ns.opts.writes_to_commitlog:
            try:
                self.commitlog.write(namespace, series_id, t_ns, value, tags)
            except DiskWriteError:
                # WAL append/fsync failure is an ACK failure: the caller
                # sees the typed error, nothing is silently accepted.
                self.disk_health.failure()
                raise
            self.disk_health.success()

    def write_batch(self, namespace: bytes, ids: Sequence[bytes], ts, vals,
                    tags: Optional[Sequence[Optional[dict]]] = None,
                    priority=None):
        """database.go:624 WriteBatch: single shard-route (one launch of
        the hash kernel on the database's device) + columnar append.
        `priority` (utils.health.Priority) rides down to the shard insert
        queues' admission gates — BULK backfill sheds first when a
        queue's bounded depth fills."""
        ns = self.namespace(namespace)
        self._check_writable(priority)
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        now = self.clock()
        pri = Priority.NORMAL if priority is None else priority
        # child_span: a real span ONLY under an already-sampled request
        # (the rpc dispatch / executor span) — the bench-bare write path
        # pays one thread-local read (scripts/obs_overhead_guard.py).
        with tracing.child_span("storage.write_batch", points=len(ids)):
            self._write_batch_routed(namespace, ns, ids, ts, vals, tags, now,
                                     pri)

    def _write_batch_routed(self, namespace, ns, ids, ts, vals, tags, now,
                            pri):
        # The shard of every id from the hash kernel, brought to the host
        # once per batch for the per-shard column split.
        shard_ids = self.shard_set.lookup_batch(
            ids, device=self.device).cpu().numpy()
        # Route columns per shard through object arrays: one fancy-index
        # per shard instead of a Python listcomp over selected rows
        # (~4x on the per-batch routing cost).
        ids_arr = np.empty(len(ids), object)
        ids_arr[:] = ids
        tags_arr = None
        if tags:
            tags_arr = np.empty(len(ids), object)
            tags_arr[:] = tags
        log = (self.commitlog is not None and ns.opts.writes_to_commitlog)
        applied = np.zeros(len(ids), bool) if log else None
        try:
            for sid in np.unique(shard_ids):
                m = shard_ids == sid
                ns.shard_for(int(sid)).write_batch(
                    ids_arr[m].tolist(), ts[m], vals[m], now,
                    tags=tags_arr[m].tolist() if tags_arr is not None else None,
                    priority=pri,
                )
                if applied is not None:
                    applied |= m
        except BaseException:
            # A later shard's queue shed (Backpressure) or window check
            # aborted the batch mid-loop: earlier shards' writes are
            # already query-visible, so they MUST reach the commit log
            # before the error propagates — otherwise a restart replay
            # silently drops accepted datapoints.
            if applied is not None and applied.any():
                try:
                    self.commitlog.write_batch(
                        namespace, ids_arr[applied].tolist(), ts[applied],
                        vals[applied],
                        tags_arr[applied].tolist() if tags_arr is not None
                        else None)
                except DiskWriteError:
                    # The rescue append itself hit the disk fault: the
                    # typed WAL error supersedes the shed — callers must
                    # treat the whole batch as un-acked.
                    self.disk_health.failure()
                    raise
            raise
        if log:
            try:
                self.commitlog.write_batch(namespace, ids, ts, vals, tags)
            except DiskWriteError:
                self.disk_health.failure()
                raise
            self.disk_health.success()

    def _check_writable(self, priority) -> None:
        """Read-only posture under persistent disk faults: shed NORMAL
        and BULK writes with typed Backpressure (producers back off, the
        data is never half-accepted) while CRITICAL traffic keeps
        flowing. Reads are untouched. Recovery is automatic: flush
        retries keep probing the disk and the first durable success
        clears the posture."""
        if priority == Priority.CRITICAL:
            return
        if self.disk_health.read_only():
            raise Backpressure(
                "disk health: durable writes failing, node is read-only "
                "(CRITICAL traffic and reads still flow)")

    # ------------------------------------------------------------------- read

    def read(self, namespace: bytes, series_id: bytes, start_ns: int, end_ns: int):
        """database.go:739 ReadEncoded equivalent, returning decoded
        points. Charges the series/datapoint/bytes query limits
        (query_limits.go): a read that lands inside a query scope bills
        that query's child enforcer; a bare RPC read bills the global
        per-second windows."""
        ns = self.namespace(namespace)
        with tracing.child_span("storage.read") as sp:
            t, v = ns.read(self.shard_set.lookup(series_id), series_id,
                           start_ns, end_ns)
            sp.set_tag("points", len(t))
        charge_read(n_series=1, n_points=len(t), n_bytes=t.nbytes + v.nbytes)
        return t, v

    def query_ids(self, namespace: bytes, query, start_ns: int = 0, end_ns: int = 2**63 - 1,
                  limit: int = 0):
        """database.go:724 QueryIDs -> reverse index query. `limit`
        pushes the RPC's series cap down to the index (sorted-prefix
        semantics preserved: the index truncates after the sorted union).
        The materialized id count charges the series-fetched limit (the
        index already charged docs-matched per segment pre-gather)."""
        ns = self.namespace(namespace)
        if ns.index is None:
            raise RuntimeError(f"namespace {namespace!r} has no index")
        # The index.query child span lives in NamespaceIndex.query, so
        # direct index callers are traced identically to this path.
        ids = ns.index.query(query, start_ns, end_ns, limit=limit)
        charge_read(n_series=len(ids))
        return ids

    def aggregate_tags(self, namespace: bytes, query, start_ns: int, end_ns: int,
                       name_only: bool = False,
                       filter_names=()) -> "Dict[bytes, set]":
        """database.go AggregateQuery analog: tag name -> distinct values for
        series matching the index query, without touching datapoints. An
        AllQuery answers straight from the index's field/term dictionaries;
        anything else materializes matching IDs and scans registry tags.
        Shared by the node Aggregate RPC and the coordinator's embedded
        CompleteTags path."""
        from ..index import query as iq

        ns = self.namespace(namespace)
        ff = set(filter_names) if filter_names else None
        out: Dict[bytes, set] = {}
        if isinstance(query, iq.AllQuery) and ns.index is not None:
            for name in ns.index.fields(start_ns, end_ns):
                if ff is not None and name not in ff:
                    continue
                out[name] = (set() if name_only else
                             set(ns.index.aggregate_terms(name, start_ns, end_ns)))
            return out
        for sid in self.query_ids(namespace, query, start_ns, end_ns):
            shard = ns.shards.get(self.shard_set.lookup(sid))
            if shard is None:
                continue
            idx = shard.registry.get(sid)
            tags = shard.registry.tags_of(idx) if idx is not None else None
            fold_tags(out, tags, ff, name_only)
        return out

    # -------------------------------------------------------------- lifecycle

    def tick(self, now_ns: Optional[int] = None) -> dict:
        now = now_ns if now_ns is not None else self.clock()
        totals = {"sealed": 0, "expired": 0}
        for ns in list(self.namespaces.values()):
            r = ns.tick(now)
            for k in totals:
                totals[k] += r[k]
        return totals

    def flush(self, persist_manager, now_ns: Optional[int] = None) -> int:
        """Flush all sealed-but-unflushed blocks through a persist manager
        (storage/flush.go); returns number of filesets written (index
        segments included). Each fileset's bloom hashes its IDs on the
        block's device."""
        now = now_ns if now_ns is not None else self.clock()
        flushed = 0
        for ns in list(self.namespaces.values()):
            for shard in ns.shards.values():
                wrote = False
                for bs in shard.flushable(now):
                    blk = shard.blocks.get(bs)
                    if blk is None:
                        continue
                    try:
                        self._flush_retrier.attempt(
                            persist_manager.write_block, ns.name,
                            shard.shard_id, blk, shard.registry)
                    except DiskWriteError:
                        # Typed flush failure after the retry budget:
                        # the block stays FAILED (flushable() keeps it
                        # on the schedule), health degrades toward the
                        # read-only posture, and the sweep moves on —
                        # one bad block must not strand the rest.
                        shard.mark_flushed(bs, ok=False)
                        self.disk_health.failure()
                        _FLUSH_METRICS.counter("flush_failed").inc()
                        continue
                    shard.mark_flushed(bs)
                    self.disk_health.success()
                    flushed += 1
                    wrote = True
                if wrote and self.retriever is not None:
                    self.retriever.invalidate(ns.name, shard.shard_id)
            if ns.index is not None:
                # Persist cold index blocks next to the data filesets
                # (persist_manager.go:193-332 index segment persist).
                from ..index import persist as idx_persist

                try:
                    flushed += len(idx_persist.flush_index(
                        persist_manager.root, ns.name, ns.index, now,
                        ns.opts.retention_ns))
                except OSError:
                    # Index segments rebuild from data filesets at
                    # bootstrap: degrade health, count, keep the sweep.
                    self.disk_health.failure()
                    _FLUSH_METRICS.counter("index_flush_failed").inc()
        if self.commitlog is not None and flushed:
            self.commitlog.rotate()
        return flushed

    def evict_flushed(self) -> int:
        """Drop in-memory copies of durably-flushed blocks; reads fall
        through to the retriever. No-op without a retriever (evicting would
        lose the only copy until retention expiry)."""
        if self.retriever is None:
            return 0
        evicted = 0
        for ns in list(self.namespaces.values()):
            for shard in ns.shards.values():
                evicted += shard.evict_flushed()
        return evicted

    def close(self):
        """Shutdown: drain every shard's insert queue (queued writes are
        never stranded by teardown — shard_insert_queue.go Stop), then
        flush and close the commit log."""
        for ns in list(self.namespaces.values()):
            ns.close()
        if self.commitlog is not None:
            self.commitlog.close()

    def mark_bootstrapped(self):
        self._bootstrapped = True

    @property
    def bootstrapped(self) -> bool:
        return self._bootstrapped
