"""KV-watched dynamic namespace registry (host copy of
m3_tpu/storage/namespace_watch.py; reference:
src/dbnode/storage/namespace_watch.go dbNamespaceWatch — the database
watches the namespace registry in the cluster KV and applies updates live;
src/dbnode/namespace/kvadmin for the admin side).

The registry key holds {"namespaces": {name: {retention_ns, block_size_ns,
index_enabled}}}. On watch delivery the database diffs its live namespaces
against the registry: new entries are created (with a reverse index when
enabled) and start serving immediately — no restart — and entries removed
from the registry are dropped. On start the watch seeds an absent registry
from the database's config-defined namespaces, making KV authoritative
from then on.

The watch has no device of its own: namespaces it creates live on the
database's device (Database.ensure_namespace), and it refuses to start
over a database placed on a card that is not there."""

from __future__ import annotations

import json
from typing import Optional

from ..cluster import kv as cluster_kv
from ..device import resolve
from .namespace import NamespaceOptions

REGISTRY_KEY = "_namespaces"


def _ns_entry(opts) -> dict:
    return {
        "retention_ns": opts.retention_ns,
        "block_size_ns": opts.block_size_ns,
        "index_enabled": opts.index_enabled,
    }


class NamespaceWatch:
    """Binds a Database to the KV namespace registry."""

    def __init__(self, db, store, key: str = REGISTRY_KEY):
        self.device = resolve(db.device)
        self.db = db
        self.store = store
        self.key = key
        self._started = False
        self._stopped = False
        # Registry versions below this floor are stale deliveries (a watch
        # event published before this node's own add/remove landed) and are
        # skipped — applying one would transiently drop a just-added
        # namespace and its buffered writes.
        self._floor_version = 0
        self.updates_applied = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "NamespaceWatch":
        """Seed an absent registry from the live namespaces, then watch."""
        if self._started:
            return self
        self._started = True
        # Merge config-defined namespaces INTO the registry (not only when
        # it is absent): a restart with a new config namespace must
        # register it, not have the watch silently drop it. Names already
        # registered keep their registry options (KV is authoritative).
        local = {ns.name.decode(): _ns_entry(ns.opts)
                 for ns in list(self.db.namespaces.values())}
        for _ in range(8):
            cur = self.store.get(self.key)
            reg = json.loads(cur.data) if cur else {}
            missing = {n: e for n, e in local.items() if n not in reg}
            if not missing:
                break
            reg.update(missing)
            try:
                self._floor_version = max(
                    self._floor_version,
                    self._publish(reg, cur.version if cur else 0))
                break
            except ValueError:
                continue
        self.store.on_change(self.key, self._on_update)
        return self

    def stop(self):
        """Detach from the registry: the callback is deregistered (no
        leak pinning this Database in a long-lived store) and any delivery
        already in flight no-ops."""
        self._stopped = True
        off = getattr(self.store, "off_change", None)
        if off is not None:
            off(self.key, self._on_update)

    # ---------------------------------------------------------------- admin

    def add(self, name: bytes, retention_ns: int,
            block_size_ns: Optional[int] = None,
            index_enabled: bool = True):
        """Publish to the registry FIRST, then create locally so the
        caller can use the namespace immediately (namespace/kvadmin Add).
        Publish-before-create closes the race where a concurrent registry
        update delivered between a local create and its publish would see
        the namespace as unregistered and drop it, losing buffered writes.
        An existing namespace with different options is a conflict, not a
        silent divergence between this node and its peers."""
        existing = self.db.namespaces.get(name)
        if existing is not None:
            # Idempotent re-add (quickstart database_create against a
            # config-defined namespace): adopt the live options, but a
            # different requested retention is a real conflict.
            if retention_ns != existing.opts.retention_ns:
                raise ValueError(
                    f"namespace {name!r} already exists with different "
                    f"retention")
            entry = _ns_entry(existing.opts)
        else:
            entry = {
                "retention_ns": retention_ns,
                "block_size_ns": (block_size_ns
                                  or NamespaceOptions().block_size_ns),
                "index_enabled": index_enabled,
            }
        for _ in range(8):  # CAS loop against concurrent admins
            cur = self.store.get(self.key)
            reg = json.loads(cur.data) if cur else {}
            prev = reg.get(name.decode())
            if prev is not None and prev != entry:
                raise ValueError(
                    f"namespace {name!r} registered with different options")
            if prev == entry:
                break
            reg[name.decode()] = entry
            try:
                self._floor_version = max(
                    self._floor_version,
                    self._publish(reg, cur.version if cur else 0))
                break
            except ValueError:
                continue
        else:
            raise RuntimeError("namespace registry CAS contention")
        self._create_local(name, entry["retention_ns"],
                           entry["block_size_ns"], entry["index_enabled"])

    def remove(self, name: bytes):
        for _ in range(8):
            cur = self.store.get(self.key)
            reg = json.loads(cur.data) if cur else {}
            if name.decode() not in reg:
                return
            del reg[name.decode()]
            try:
                self._floor_version = max(
                    self._floor_version,
                    self._publish(reg, cur.version if cur else 0))
                return
            except ValueError:
                continue
        raise RuntimeError("namespace registry CAS contention")

    def _publish(self, reg: dict, expect_version: int) -> int:
        return self.store.check_and_set(self.key, expect_version,
                                        json.dumps(reg).encode())

    # ---------------------------------------------------------------- watch

    def _on_update(self, _key: str, value: cluster_kv.Value):
        if self._stopped or value.version < self._floor_version:
            return
        try:
            reg = json.loads(value.data)
        except (ValueError, TypeError):
            return
        want = {name.encode(): entry for name, entry in reg.items()}
        for name, entry in want.items():
            ns = self.db.namespaces.get(name)
            if ns is None:
                self._create_local(
                    name, int(entry["retention_ns"]),
                    int(entry.get("block_size_ns") or 0) or None,
                    bool(entry.get("index_enabled", True)))
            elif int(entry["retention_ns"]) != ns.opts.retention_ns:
                # Runtime-settable option update applied live (the
                # reference's namespace watch applies registry option
                # changes the same way); block size / indexing are
                # immutable once data exists and are left untouched.
                import dataclasses as _dc

                ns.opts = _dc.replace(
                    ns.opts, retention_ns=int(entry["retention_ns"]))
                for sh in list(ns.shards.values()):
                    sh.opts = _dc.replace(
                        sh.opts, retention_ns=int(entry["retention_ns"]))
        for name in [n for n in list(self.db.namespaces) if n not in want]:
            self.db.drop_namespace(name)
        self.updates_applied += 1

    def _create_local(self, name: bytes, retention_ns: int,
                      block_size_ns: Optional[int], index_enabled: bool):
        kwargs = {"retention_ns": retention_ns, "index_enabled": index_enabled}
        if block_size_ns:
            kwargs["block_size_ns"] = block_size_ns
        self.db.ensure_namespace(name, NamespaceOptions(**kwargs))
