"""Versioned watchable KV store (host copy of m3_tpu/cluster/kv.py;
reference: src/cluster/kv — kv.Store interface types.go:123, etcd-backed
in production, in-memory fake for integration tests kv/mem).

The in-memory store is the single source of cluster metadata for
single-process multi-node setups (the reference's integration tests swap
etcd out the same way, integration/fake/cluster_services.go): the
placement, service advertisements and heartbeats, the aggregator's flush
times and its leader lease. A file-backed store offers cross-process
durability for service binaries. Both support CAS (check_and_set),
one-transaction batched sets, and watches with immediate-current-value
delivery."""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional


class Value:
    __slots__ = ("data", "version")

    def __init__(self, data: bytes, version: int):
        self.data = data
        self.version = version


class Watch:
    """A subscription to one key; get() returns the latest value, wait()
    blocks for a change past a known version."""

    def __init__(self, store: "MemStore", key: str):
        self._store = store
        self._key = key
        self._event = threading.Event()

    def get(self) -> Optional[Value]:
        return self._store.get(self._key)

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = self._event.wait(timeout)
        self._event.clear()
        return ok

    def _notify(self):
        self._event.set()


class MemStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[str, Value] = {}
        self._watches: Dict[str, List[Watch]] = {}
        self._callbacks: Dict[str, List[Callable[[str, Value], None]]] = {}

    def get(self, key: str) -> Optional[Value]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: str, data: bytes) -> int:
        """Unconditional set; returns the new version."""
        with self._lock:
            cur = self._data.get(key)
            version = (cur.version if cur else 0) + 1
            self._data[key] = Value(data, version)
            self._fire(key)
            return version

    def set_many(self, items) -> Dict[str, int]:
        """One transaction: every key lands under a single lock hold (one
        version bump each) and change notifications fire after the whole
        batch is applied. The aggregator's batched flush-times commit
        (flush.py FlushTimesManager.store_many) rides this so a leader
        flush round costs one store round trip, not one per shard."""
        with self._lock:
            out = {}
            for key, data in items.items():
                cur = self._data.get(key)
                version = (cur.version if cur else 0) + 1
                self._data[key] = Value(data, version)
                out[key] = version
            self._fire_many(list(items))
            return out

    def _fire_many(self, keys):
        for k in keys:
            self._fire(k)

    def set_if_not_exists(self, key: str, data: bytes) -> int:
        with self._lock:
            if key in self._data:
                raise KeyError(f"key {key!r} already exists")
            self._data[key] = Value(data, 1)
            self._fire(key)
            return 1

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        """CAS (kv/types.go CheckAndSet): expect_version 0 means not-exists."""
        with self._lock:
            cur = self._data.get(key)
            cur_version = cur.version if cur else 0
            if cur_version != expect_version:
                raise ValueError(f"version mismatch for {key!r}: have {cur_version}, want {expect_version}")
            version = cur_version + 1
            self._data[key] = Value(data, version)
            self._fire(key)
            return version

    def delete(self, key: str) -> Optional[Value]:
        with self._lock:
            v = self._data.pop(key, None)
            if v is not None:
                self._fire(key)
            return v

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def watch(self, key: str) -> Watch:
        w = Watch(self, key)
        with self._lock:
            self._watches.setdefault(key, []).append(w)
            if key in self._data:
                w._notify()
        return w

    def unwatch(self, key: str, w: Watch):
        """Deregister a watch (long-lived stores serving churning watchers —
        e.g. the KV service's per-connection streams — must not leak them)."""
        with self._lock:
            ws = self._watches.get(key)
            if ws is not None and w in ws:
                ws.remove(w)
                if not ws:
                    del self._watches[key]

    def on_change(self, key: str, fn: Callable[[str, Value], None]):
        """Callback-style watch; fires immediately if the key exists."""
        with self._lock:
            self._callbacks.setdefault(key, []).append(fn)
            cur = self._data.get(key)
        if cur is not None:
            fn(key, cur)

    def off_change(self, key: str, fn: Callable[[str, Value], None]):
        """Deregister a callback (see unwatch: long-lived stores must not
        accumulate dead subscribers)."""
        with self._lock:
            fns = self._callbacks.get(key)
            if fns is not None and fn in fns:
                fns.remove(fn)
                if not fns:
                    del self._callbacks[key]

    def _fire(self, key: str):
        for w in self._watches.get(key, []):
            w._notify()
        cur = self._data.get(key)
        if cur is not None:
            for fn in self._callbacks.get(key, []):
                fn(key, cur)


class FileStore(MemStore):
    """MemStore persisted to a JSON file: survives process restarts; watches
    remain in-process (cross-process watchers poll via reload())."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self.reload()

    def reload(self):
        if os.path.exists(self.path):
            with open(self.path) as f:
                raw = json.load(f)
            with self._lock:
                for k, (data_hex, version) in raw.items():
                    cur = self._data.get(k)
                    if cur is None or cur.version < version:
                        self._data[k] = Value(bytes.fromhex(data_hex), version)
                        self._fire(k)

    def _persist(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({k: (v.data.hex(), v.version) for k, v in self._data.items()}, f)
        os.replace(tmp, self.path)

    def _fire(self, key: str):
        super()._fire(key)
        self._persist()

    def _fire_many(self, keys):
        for k in keys:
            MemStore._fire(self, k)  # watches/callbacks only
        self._persist()             # one file write for the whole batch


def get_json(store, key: str):
    v = store.get(key)
    return (json.loads(v.data), v.version) if v is not None else (None, 0)


def set_json(store, key: str, obj) -> int:
    return store.set(key, json.dumps(obj).encode())
