"""Query storage over the port's storage node (port of LocalStorage from
m3_tpu/query/storage.py; reference: src/query/storage/types.go Storage and
storage/m3/storage.go, the dbnode adapter).

fetch_raw(matchers, start_ns, end_ns) -> {series_id: {tags, t, v}} raw
datapoints; the executor grids them per query. Tag index queries compile
from label matchers via model.matchers_to_index_query. The session and
fan-out storages of the reference are not ported yet."""

from __future__ import annotations

from typing import Dict, Sequence

from .model import Matcher, matchers_to_index_query


class LocalStorage:
    """Direct adapter over an in-process storage.Database (the coordinator
    embedded in a dbnode, storage/m3/storage.go Fetch -> ReadEncoded):
    an index query for the matching ids, then one shard read per series
    (sealed blocks through the device block cache, plus the buffer)."""

    def __init__(self, db, namespace: bytes):
        self._db = db
        self._namespace = namespace

    def fetch_raw(self, matchers: Sequence[Matcher], start_ns: int,
                  end_ns: int) -> Dict[bytes, dict]:
        q = matchers_to_index_query(matchers)
        ids = self._db.query_ids(self._namespace, q, start_ns, end_ns)
        out: Dict[bytes, dict] = {}
        ns = self._db.namespace(self._namespace)
        for sid in ids:
            shard_id = self._db.shard_set.lookup(sid)
            shard = ns.shards.get(shard_id)
            if shard is None:
                continue
            t, v = shard.read(sid, start_ns, end_ns)
            idx = shard.registry.get(sid)
            tags = shard.registry.tags_of(idx) if idx is not None else {}
            out[sid] = {"tags": tags or {}, "t": t, "v": v}
        return out

    def write(self, series_id: bytes, tags: Dict[bytes, bytes], t_ns: int,
              value: float):
        self._db.write(self._namespace, series_id, t_ns, value, tags=tags)

    def write_batch(self, series_ids: Sequence[bytes], tags: Sequence[dict],
                    ts, vals):
        """Columnar write: one shard-routed db.write_batch append instead
        of a per-sample write loop (the coordinator ingest batch path)."""
        self._db.write_batch(self._namespace, list(series_ids), ts, vals,
                             tags=list(tags))

    def complete_tags(self, matchers: Sequence[Matcher], start_ns: int,
                      end_ns: int, name_only: bool = False,
                      filter_names: Sequence[bytes] = ()) -> Dict[bytes, set]:
        """storage/types.go CompleteTags: tag name -> distinct values for
        series matching the matchers, from the index — no datapoints read.
        name_only leaves the value sets empty (CompleteNameOnly)."""
        return self._db.aggregate_tags(
            self._namespace, matchers_to_index_query(matchers), start_ns,
            end_ns, name_only=name_only, filter_names=filter_names)
