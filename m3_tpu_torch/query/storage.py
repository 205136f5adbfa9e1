"""Query storage interface + implementations (port of
m3_tpu/query/storage.py; reference: src/query/storage/types.go Storage,
storage/m3/storage.go the dbnode adapter, storage/fanout/storage.go the
multi-store fanout).

fetch_raw(matchers, start_ns, end_ns) -> {series_id: {tags, t, v}} raw
datapoints; the executor grids them per query. Tag index queries compile
from label matchers via model.matchers_to_index_query. LocalStorage reads
an in-process Database, SessionStorage the replicated cluster through a
client Session (whose fetched tiles decode on the session's device), and
FanoutStorage merges several stores by series id."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

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

    def accepts(self, ts) -> np.ndarray:
        """Mask of the timestamps the namespace's shards take now: the
        buffer_past/buffer_future window each shard's write checks.
        Port-only, for DownsamplerAndWriter.write_request."""
        opts = self._db.namespace(self._namespace).opts
        now = self._db.clock()
        ts = np.asarray(ts, np.int64)
        return (ts >= now - opts.buffer_past_ns) & \
            (ts <= now + opts.buffer_future_ns)

    def complete_tags(self, matchers: Sequence[Matcher], start_ns: int,
                      end_ns: int, name_only: bool = False,
                      filter_names: Sequence[bytes] = ()) -> Dict[bytes, set]:
        """storage/types.go CompleteTags: tag name -> distinct values for
        series matching the matchers, from the index — no datapoints read.
        name_only leaves the value sets empty (CompleteNameOnly)."""
        return self._db.aggregate_tags(
            self._namespace, matchers_to_index_query(matchers), start_ns,
            end_ns, name_only=name_only, filter_names=filter_names)


class SessionStorage:
    """Adapter over the replicating client session (storage/m3/storage.go
    Fetch -> session.FetchTagged, the coordinator's production path)."""

    def __init__(self, session, namespace: bytes):
        self._session = session
        self._namespace = namespace

    def fetch_raw(self, matchers: Sequence[Matcher], start_ns: int,
                  end_ns: int) -> Dict[bytes, dict]:
        q = matchers_to_index_query(matchers)
        return self._session.fetch_tagged(self._namespace, q, start_ns, end_ns)

    def write(self, series_id: bytes, tags: Dict[bytes, bytes], t_ns: int,
              value: float):
        self._session.write_tagged(self._namespace, series_id, tags, t_ns, value)

    def complete_tags(self, matchers: Sequence[Matcher], start_ns: int,
                      end_ns: int, name_only: bool = False,
                      filter_names: Sequence[bytes] = ()) -> Dict[bytes, set]:
        q = matchers_to_index_query(matchers)
        return self._session.aggregate(
            self._namespace, q, start_ns, end_ns, name_only=name_only,
            field_filter=filter_names)


class FanoutStorage:
    """Fan out fetches across stores and merge by series id
    (storage/fanout/storage.go; replica-level merge already happened in the
    client, so cross-store merge is simple union preferring more points)."""

    def __init__(self, stores: Sequence):
        self._stores = list(stores)

    def fetch_raw(self, matchers: Sequence[Matcher], start_ns: int,
                  end_ns: int) -> Dict[bytes, dict]:
        merged: Dict[bytes, dict] = {}
        for store in self._stores:
            for sid, entry in store.fetch_raw(matchers, start_ns, end_ns).items():
                cur = merged.get(sid)
                if cur is None:
                    merged[sid] = dict(entry)
                else:
                    t = np.concatenate([np.asarray(cur["t"]), np.asarray(entry["t"])])
                    v = np.concatenate([np.asarray(cur["v"]), np.asarray(entry["v"])])
                    order = np.argsort(t, kind="stable")
                    t, v = t[order], v[order]
                    keep = np.ones(t.size, dtype=bool)
                    keep[1:] = t[1:] != t[:-1]
                    cur["t"], cur["v"] = t[keep], v[keep]
                    if not cur["tags"] and entry["tags"]:
                        cur["tags"] = entry["tags"]
        return merged

    def write(self, series_id: bytes, tags, t_ns: int, value: float):
        for store in self._stores:
            store.write(series_id, tags, t_ns, value)

    def complete_tags(self, matchers: Sequence[Matcher], start_ns: int,
                      end_ns: int, name_only: bool = False,
                      filter_names: Sequence[bytes] = ()) -> Dict[bytes, set]:
        merged: Dict[bytes, set] = {}
        for store in self._stores:
            part = _store_complete_tags(store, matchers, start_ns, end_ns,
                                        name_only, filter_names)
            for name, vals in part.items():
                merged.setdefault(name, set()).update(vals)
        return merged


def _store_complete_tags(store, matchers, start_ns, end_ns, name_only,
                         filter_names) -> Dict[bytes, set]:
    """CompleteTags for any store: use the store's index-backed fast path
    when present, else derive from fetched series tags (the reference's
    remote storages similarly degrade to a series fetch)."""
    fn = getattr(store, "complete_tags", None)
    if fn is not None:
        return fn(matchers, start_ns, end_ns, name_only=name_only,
                  filter_names=filter_names)
    from ..storage.database import fold_tags

    ff = set(filter_names) if filter_names else None
    out: Dict[bytes, set] = {}
    for entry in store.fetch_raw(matchers, start_ns, end_ns).values():
        fold_tags(out, dict(entry["tags"]), ff, name_only)
    return out
