"""Composed cluster client: one handle into the cluster management system
(host copy of m3_tpu/cluster/client.py; reference: src/cluster/client/
client.go Client + the etcd-backed configservice client
src/cluster/etcd/client.go — Services(), KV(), Store(namespace)).

One KV service endpoint (a RemoteStore over cluster/kv_service.py) or an
injected store (in-process setups) yields every cluster facility with
consistent key namespacing: the versioned KV store, zone/env-scoped
sub-stores, service discovery + heartbeats, leader elections and
placement services. Host code with no device."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .placement import PlacementService
from .services import HeartbeatService, LeaderService, Services


class PrefixStore:
    """A namespaced view of a KV store (kv.OverrideOptions Namespace):
    every key is transparently prefixed, so tenants/zones can't collide.
    Implements the full MemStore surface over the parent store."""

    def __init__(self, parent, prefix: str):
        self._parent = parent
        self._prefix = prefix.rstrip("/") + "/"
        self._wrap_lock = threading.Lock()
        self._wrappers: Dict[tuple, Callable] = {}

    def _k(self, key: str) -> str:
        return self._prefix + key

    def get(self, key: str):
        return self._parent.get(self._k(key))

    def set(self, key: str, data: bytes) -> int:
        return self._parent.set(self._k(key), data)

    def set_if_not_exists(self, key: str, data: bytes) -> int:
        return self._parent.set_if_not_exists(self._k(key), data)

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        return self._parent.check_and_set(self._k(key), expect_version, data)

    def delete(self, key: str):
        return self._parent.delete(self._k(key))

    def keys(self, prefix: str = "") -> List[str]:
        n = len(self._prefix)
        return [k[n:] for k in self._parent.keys(self._prefix + prefix)]

    def watch(self, key: str):
        return self._parent.watch(self._k(key))

    def unwatch(self, key: str, w):
        unwatch = getattr(self._parent, "unwatch", None)
        if unwatch is not None:
            unwatch(self._k(key), w)

    def on_change(self, key: str, fn: Callable):
        # Callbacks must see the SCOPED key, not the internal prefixed one
        # (a callback re-reading through this store would double-prefix).
        def wrapper(full_key: str, value):
            fn(full_key[len(self._prefix):]
               if full_key.startswith(self._prefix) else full_key, value)

        with self._wrap_lock:
            self._wrappers[(key, fn)] = wrapper
        return self._parent.on_change(self._k(key), wrapper)

    def off_change(self, key: str, fn: Callable):
        with self._wrap_lock:
            wrapper = self._wrappers.pop((key, fn), None)
        off = getattr(self._parent, "off_change", None)
        if off is not None and wrapper is not None:
            off(self._k(key), wrapper)


class ClusterClient:
    """client.go Client: the composed entrypoint.

    Construct from a KV service endpoint (cross-process, the etcd-analog
    deployment) or from an existing store (embedded/in-process)."""

    def __init__(self, endpoint: str = "", store=None, zone: str = "",
                 env: str = ""):
        if (store is None) == (not endpoint):
            raise ValueError("exactly one of endpoint/store required")
        self._owns_store = store is None
        if store is None:
            from .kv_service import RemoteStore

            store = RemoteStore(endpoint)
        self._root = store
        scope = "/".join(p for p in (zone, env) if p)
        self._store = PrefixStore(store, scope) if scope else store
        self._services: Optional[Services] = None

    # ------------------------------------------------------------- factories

    def kv(self):
        """KV(): the distributed configuration store (zone/env scoped)."""
        return self._store

    def store(self, namespace: str):
        """Store(opts): a key-namespaced sub-store."""
        return PrefixStore(self._store, namespace)

    def services(self, heartbeat_ttl_ns: int = 10_000_000_000,
                 clock: Optional[Callable[[], int]] = None) -> Services:
        """Services(): discovery + heartbeats over this cluster's KV."""
        if self._services is None:
            self._services = Services(
                self._store,
                HeartbeatService(self._store, ttl_ns=heartbeat_ttl_ns,
                                 clock=clock))
        return self._services

    def placement_service(self, service_name: str = "m3db") -> PlacementService:
        """services.PlacementService for one service's placement."""
        return PlacementService(self._store, f"_placement/{service_name}")

    def leader_service(self, election_id: str, instance_id: str,
                       lease_ttl_ns: int = 10_000_000_000,
                       clock: Optional[Callable[[], int]] = None) -> LeaderService:
        return LeaderService(self._store, election_id, instance_id,
                             lease_ttl_ns=lease_ttl_ns, clock=clock)

    def close(self):
        """Closes the store only if this client constructed it — an
        injected store may be shared with other clients."""
        if not self._owns_store:
            return
        close = getattr(self._root, "close", None)
        if close is not None:
            close()
