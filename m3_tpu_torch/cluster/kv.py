"""Versioned KV store (reference: src/cluster/kv — kv.Store interface
types.go:123, etcd-backed in production, in-memory fake for integration
tests kv/mem).

The in-memory store holds the aggregator's persisted flush times and its
leader lease for single-process setups (the reference's integration tests
swap etcd out the same way, integration/fake/cluster_services.go), with
CAS (check_and_set) and one-transaction batched sets.

Host copy of the get/set/set_many/check_and_set surface of
m3_tpu/cluster/kv.py's MemStore; its watches, callbacks and FileStore
wait for the client slice."""

from __future__ import annotations

import json
import threading
from typing import Dict, Optional


class Value:
    __slots__ = ("data", "version")

    def __init__(self, data: bytes, version: int):
        self.data = data
        self.version = version


class MemStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[str, Value] = {}

    def get(self, key: str) -> Optional[Value]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: str, data: bytes) -> int:
        """Unconditional set; returns the new version."""
        with self._lock:
            cur = self._data.get(key)
            version = (cur.version if cur else 0) + 1
            self._data[key] = Value(data, version)
            return version

    def set_many(self, items) -> Dict[str, int]:
        """One transaction: every key lands under a single lock hold (one
        version bump each). The aggregator's batched flush-times commit
        (aggregator/flush.py FlushTimesManager.store_many) rides this so a
        leader flush round costs one store round trip, not one per
        shard."""
        with self._lock:
            out = {}
            for key, data in items.items():
                cur = self._data.get(key)
                version = (cur.version if cur else 0) + 1
                self._data[key] = Value(data, version)
                out[key] = version
            return out

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        """CAS (kv/types.go CheckAndSet): expect_version 0 means not-exists."""
        with self._lock:
            cur = self._data.get(key)
            cur_version = cur.version if cur else 0
            if cur_version != expect_version:
                raise ValueError(f"version mismatch for {key!r}: have {cur_version}, want {expect_version}")
            version = cur_version + 1
            self._data[key] = Value(data, version)
            return version


def get_json(store, key: str):
    v = store.get(key)
    return (json.loads(v.data), v.version) if v is not None else (None, 0)
