"""Namespace: retention/blocksize domain owning a shard set (port of
m3_tpu/storage/namespace.py; reference: src/dbnode/storage/namespace.go
dbNamespace and storage/namespace options). Its shards seal and read on
the namespace's `device`; a bound retriever serves their blocks that are
only on disk."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from ..device import resolve
from ..utils import xtime
from .shard import Shard, ShardOptions, ShardState


@dataclasses.dataclass(frozen=True)
class NamespaceOptions:
    """namespace metadata options (dbnode/storage/namespace/options.go)."""

    retention_ns: int = 2 * xtime.DAY
    block_size_ns: int = 2 * xtime.HOUR
    buffer_past_ns: int = 10 * xtime.MINUTE
    buffer_future_ns: int = 2 * xtime.MINUTE
    writes_to_commitlog: bool = True
    index_enabled: bool = True
    index_block_size_ns: int = 4 * xtime.HOUR
    snapshot_enabled: bool = True
    # shard_insert_queue.go knobs: async new-series visibility + the
    # bounded queue depth that sheds via Backpressure (see ShardOptions).
    write_new_series_async: bool = False
    insert_max_pending: int = 65536
    insert_interval_ns: int = 0

    def shard_options(self) -> ShardOptions:
        return ShardOptions(
            block_size_ns=self.block_size_ns,
            retention_ns=self.retention_ns,
            buffer_past_ns=self.buffer_past_ns,
            buffer_future_ns=self.buffer_future_ns,
            write_new_series_async=self.write_new_series_async,
            insert_max_pending=self.insert_max_pending,
            insert_interval_ns=self.insert_interval_ns,
        )


class Namespace:
    def __init__(self, name: bytes, opts: NamespaceOptions, shard_ids: Iterable[int],
                 index=None, retriever=None, device=None):
        self.name = name
        self.opts = opts
        self.index = index  # index.NamespaceIndex when indexing enabled
        self.retriever = retriever  # storage.retriever.BlockRetriever
        self.device = resolve(device)
        self.shards: Dict[int, Shard] = {}
        for sid in shard_ids:
            self.assign_shard(sid)

    def assign_shard(self, shard_id: int, state: ShardState = ShardState.AVAILABLE) -> Shard:
        """Add a shard on placement change (storage/cluster/database.go:133)."""
        if shard_id in self.shards:
            return self.shards[shard_id]
        sh = Shard(shard_id, self.opts.shard_options(),
                   on_new_series=self._on_new_series, state=state,
                   on_new_series_batch=self._on_new_series_batch,
                   namespace_name=self.name, device=self.device)
        if self.retriever is not None:
            sh.attach_retriever(self.retriever, self.name)
        self.shards[shard_id] = sh
        return sh

    def remove_shard(self, shard_id: int):
        self.shards.pop(shard_id, None)

    def set_retriever(self, retriever):
        """Bind a disk retriever to this namespace and all current shards."""
        self.retriever = retriever
        for sh in self.shards.values():
            sh.attach_retriever(retriever, self.name)

    def _on_new_series(self, series_id: bytes, tags: Optional[dict], idx: int):
        if self.index is not None and self.opts.index_enabled and tags is not None:
            self.index.insert(series_id, tags)

    def _on_new_series_batch(self, items):
        """One insert-queue drain -> one batched reverse-index insert
        (index_insert_queue.go parity); untagged series are skipped the
        same way the per-series hook skips them."""
        if self.index is None or not self.opts.index_enabled:
            return
        tagged = [(sid, tags) for sid, tags, _idx in items if tags is not None]
        if tagged:
            self.index.insert_many(tagged)

    def close(self):
        """Drain + stop every shard's insert queue; shard close also drops
        this namespace's device-block-cache residency (zero HBM pinned by
        a closed namespace)."""
        for sh in self.shards.values():
            sh.close()

    def shard_for(self, shard_id: int) -> Shard:
        sh = self.shards.get(shard_id)
        if sh is None:
            raise KeyError(f"shard {shard_id} not owned by namespace {self.name!r}")
        return sh

    def write(self, shard_id: int, series_id: bytes, t_ns: int, value: float,
              now_ns: int, tags: Optional[dict] = None):
        self.shard_for(shard_id).write(series_id, t_ns, value, now_ns, tags)

    def read(self, shard_id: int, series_id: bytes, start_ns: int, end_ns: int):
        return self.shard_for(shard_id).read(series_id, start_ns, end_ns)

    def tick(self, now_ns: int) -> dict:
        totals = {"sealed": 0, "expired": 0}
        for sh in self.shards.values():
            r = sh.tick(now_ns)
            for k in totals:
                totals[k] += r[k]
        if self.index is not None:
            self.index.tick(now_ns, self.opts.retention_ns)
        return totals
