"""Top-level database (port of m3_tpu/storage/database.py; reference:
src/dbnode/storage/database.go `db` + mediator.go background lifecycle).

Owns namespaces, routes writes by shard hash (the hash kernel, once per
write_batch) and drives the tick -> seal -> cleanup lifecycle. Background
behavior is explicit (`tick()`) so tests and services control timing.

`device` (None: the CUDA card, raising without one) is threaded down to
every namespace and shard: routing, seals and sealed-block reads run
there. Not ported yet: the commit log (a Database takes commitlog=None
only and raises CommitLogUnsupported otherwise), the fileset flush, the
disk retriever and bootstrap."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..device import resolve
from ..utils import tracing
from ..utils.health import DiskHealth, Priority
from ..utils.limits import Backpressure
from .namespace import Namespace, NamespaceOptions
from .series import charge_read


class CommitLogUnsupported(NotImplementedError):
    """The port has no commit log yet: a Database takes commitlog=None."""


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
                 clock: Callable[[], int] = None, *, device=None):
        """shard_set: parallel.sharding.ShardSet; commitlog: must be None
        (CommitLogUnsupported otherwise); device: where routing, seals and
        reads run (None: the CUDA card)."""
        if commitlog is not None:
            raise CommitLogUnsupported(
                "m3_tpu_torch.storage.Database has no commit log yet; "
                "pass commitlog=None")
        self.shard_set = shard_set
        self.device = resolve(device)
        self.clock = clock or (lambda: time.time_ns())
        self.namespaces: Dict[bytes, Namespace] = {}
        # Guards namespace map mutation; iterating code snapshots
        # values() under the GIL.
        self._ns_lock = threading.Lock()
        # Durable-write health: a read-only posture sheds NORMAL/BULK
        # writes with Backpressure while CRITICAL traffic and reads keep
        # flowing (fed by the flush and the commit log once ported).
        self.disk_health = DiskHealth(trip_after=3)

    # ------------------------------------------------------------- namespaces

    def create_namespace(self, name: bytes, opts: NamespaceOptions = NamespaceOptions(),
                         index=None) -> Namespace:
        with self._ns_lock:
            if name in self.namespaces:
                raise ValueError(f"namespace {name!r} already exists")
            ns = Namespace(name, opts, self.shard_set.all_shard_ids(), index=index,
                           device=self.device)
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
        """database.go:536 Write."""
        ns = self.namespace(namespace)
        self._check_writable(priority)
        shard_id = self.shard_set.lookup(series_id)
        now = self.clock()
        if priority is None:
            ns.write(shard_id, series_id, t_ns, value, now, tags)
        else:
            ns.shard_for(shard_id).write(series_id, t_ns, value, now, tags,
                                         priority=priority)

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
        for sid in np.unique(shard_ids):
            m = shard_ids == sid
            ns.shard_for(int(sid)).write_batch(
                ids_arr[m].tolist(), ts[m], vals[m], now,
                tags=tags_arr[m].tolist() if tags_arr is not None else None,
                priority=pri,
            )

    def _check_writable(self, priority) -> None:
        """Read-only posture under persistent disk faults: shed NORMAL
        and BULK writes with typed Backpressure (producers back off, the
        data is never half-accepted) while CRITICAL traffic keeps
        flowing. Reads are untouched."""
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

    def close(self):
        """Shutdown: drain every shard's insert queue (queued writes are
        never stranded by teardown — shard_insert_queue.go Stop)."""
        for ns in list(self.namespaces.values()):
            ns.close()
