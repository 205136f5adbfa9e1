"""The port's KV-watched namespace registry and runtime options
(m3_tpu_torch.storage.{namespace_watch,runtime}) against the reference's,
on the CPU: a registry entry creates a namespace that serves at once
(with or without its index) and a removal drops it; the watch seeds and
merges the config-defined namespaces; retention updates apply live;
add/remove publish with check-and-set; a port watch and a reference watch
over one store publish the same registry bytes and follow each other's
edits, over a MemStore and over a KV service. Namespaces the watch
creates live on the database's device. The kvconfig keys fold into equal
RuntimeOptions in both packages. Servers are real localhost listeners,
closed in `finally`; every wait has a deadline."""

import json
import time

import pytest
import torch

from m3_tpu.cluster import kv as jkv
from m3_tpu.cluster.kv_service import KVServer as JKVServer
from m3_tpu.cluster.kv_service import RemoteStore as JRemoteStore
from m3_tpu.index.namespace_index import NamespaceIndex as JNamespaceIndex
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.storage import runtime as jruntime
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu.storage.namespace_watch import NamespaceWatch as JNamespaceWatch
from m3_tpu_torch.cluster import kv as cluster_kv
from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.storage import runtime
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.storage.namespace_watch import REGISTRY_KEY, NamespaceWatch

S = 1_000_000_000
T0 = 1_700_000_000 * S
HOUR = 3600 * S


def _await(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def make_db():
    db = Database(ShardSet(4), clock=lambda: T0, device="cpu")
    db.create_namespace(b"default", NamespaceOptions(),
                        index=NamespaceIndex(clock=lambda: T0))
    return db


def make_jdb():
    db = JDatabase(JShardSet(4), clock=lambda: T0)
    db.create_namespace(b"default", JNamespaceOptions(),
                        index=JNamespaceIndex(clock=lambda: T0))
    return db


class TestLocalRegistry:
    def test_seed_then_add_and_remove(self):
        db = make_db()
        store = cluster_kv.MemStore()
        NamespaceWatch(db, store).start()
        reg = json.loads(store.get(REGISTRY_KEY).data)
        assert set(reg) == {"default"}
        reg["metrics_1m"] = {"retention_ns": 40 * 24 * HOUR,
                             "block_size_ns": 4 * HOUR, "index_enabled": True}
        store.set(REGISTRY_KEY, json.dumps(reg).encode())
        assert b"metrics_1m" in db.namespaces
        ns = db.namespace(b"metrics_1m")
        assert ns.opts.retention_ns == 40 * 24 * HOUR
        assert ns.opts.block_size_ns == 4 * HOUR
        assert ns.index is not None
        db.write(b"metrics_1m", b"series", T0, 1.5, tags={b"a": b"b"})
        t, v = db.read(b"metrics_1m", b"series", 0, 2**62)
        assert v.tolist() == [1.5]
        del reg["metrics_1m"]
        store.set(REGISTRY_KEY, json.dumps(reg).encode())
        assert b"metrics_1m" not in db.namespaces
        assert b"default" in db.namespaces

    def test_add_helper_creates_and_publishes(self):
        db = make_db()
        store = cluster_kv.MemStore()
        watch = NamespaceWatch(db, store).start()
        watch.add(b"agg_10s", retention_ns=2 * 24 * HOUR, index_enabled=False)
        assert b"agg_10s" in db.namespaces
        assert db.namespace(b"agg_10s").index is None
        reg = json.loads(store.get(REGISTRY_KEY).data)
        assert reg["agg_10s"]["index_enabled"] is False
        watch.remove(b"agg_10s")
        assert b"agg_10s" not in db.namespaces

    def test_no_index_when_disabled(self):
        db = make_db()
        store = cluster_kv.MemStore()
        NamespaceWatch(db, store).start()
        reg = json.loads(store.get(REGISTRY_KEY).data)
        reg["raw"] = {"retention_ns": HOUR, "index_enabled": False}
        store.set(REGISTRY_KEY, json.dumps(reg).encode())
        assert db.namespace(b"raw").index is None

    def test_created_namespaces_live_on_the_db_device(self):
        db = make_db()
        watch = NamespaceWatch(db, cluster_kv.MemStore()).start()
        assert watch.device == db.device == torch.device("cpu")
        watch.add(b"agg_1m", retention_ns=40 * HOUR)
        assert db.namespace(b"agg_1m").device == db.device


class TestCrossProcess:
    def test_namespace_add_propagates_over_kv_service(self):
        """Two databases watching one KV process: an admin add on one node
        appears on the other via watch push, no restart."""
        srv = KVServer().start()
        stores = [RemoteStore(srv.endpoint) for _ in range(2)]
        try:
            db_a, db_b = make_db(), make_db()
            watch_a = NamespaceWatch(db_a, stores[0]).start()
            watch_b = NamespaceWatch(db_b, stores[1]).start()
            watch_a.add(b"new_ns", retention_ns=2 * HOUR)
            assert b"new_ns" in db_a.namespaces  # immediate locally
            assert _await(lambda: b"new_ns" in db_b.namespaces)
            db_b.write(b"new_ns", b"s", T0, 7.0)
            assert db_b.read(b"new_ns", b"s", 0, 2**62)[1].tolist() == [7.0]
            watch_b.remove(b"new_ns")
            assert _await(lambda: b"new_ns" not in db_a.namespaces)
        finally:
            for st in stores:
                st.close()
            srv.close()

    @pytest.mark.parametrize("server_cls", [KVServer, JKVServer],
                             ids=["port-server", "ref-server"])
    def test_port_and_reference_nodes_follow_each_other(self, server_cls):
        """A port node and a reference node over one KV service: each
        one's add reaches the other, with the same options."""
        srv = server_cls().start()
        st, jst = RemoteStore(srv.endpoint), JRemoteStore(srv.endpoint)
        try:
            db, jdb = make_db(), make_jdb()
            watch = NamespaceWatch(db, st).start()
            jwatch = JNamespaceWatch(jdb, jst).start()
            watch.add(b"agg_1m", retention_ns=40 * HOUR, block_size_ns=HOUR)
            assert _await(lambda: b"agg_1m" in jdb.namespaces)
            jwatch.add(b"agg_5m", retention_ns=40 * HOUR, index_enabled=False)
            assert _await(lambda: b"agg_5m" in db.namespaces)
            for name in (b"agg_1m", b"agg_5m"):
                a, b = db.namespace(name).opts, jdb.namespace(name).opts
                assert (a.retention_ns, a.block_size_ns, a.index_enabled) == \
                    (b.retention_ns, b.block_size_ns, b.index_enabled)
            assert db.namespace(b"agg_5m").index is None
            jwatch.remove(b"agg_1m")
            assert _await(lambda: b"agg_1m" not in db.namespaces)
        finally:
            st.close()
            jst.close()
            srv.close()


class TestRegistryEvolution:
    def test_config_namespace_merged_into_existing_registry(self):
        store = cluster_kv.MemStore()
        db1 = make_db()
        NamespaceWatch(db1, store).start()
        db2 = make_db()
        db2.create_namespace(b"from_config", NamespaceOptions(
            retention_ns=6 * HOUR))
        NamespaceWatch(db2, store).start()
        assert b"from_config" in db2.namespaces  # not dropped
        reg = json.loads(store.get(REGISTRY_KEY).data)
        assert "from_config" in reg  # registered for peers
        assert _await(lambda: b"from_config" in db1.namespaces)

    def test_retention_update_applies_live(self):
        db = make_db()
        store = cluster_kv.MemStore()
        NamespaceWatch(db, store).start()
        reg = json.loads(store.get(REGISTRY_KEY).data)
        reg["default"]["retention_ns"] = 99 * HOUR
        store.set(REGISTRY_KEY, json.dumps(reg).encode())
        ns = db.namespace(b"default")
        assert ns.opts.retention_ns == 99 * HOUR
        assert all(sh.opts.retention_ns == 99 * HOUR
                   for sh in ns.shards.values())

    def test_idempotent_readd_of_existing_namespace(self):
        db = make_db()
        store = cluster_kv.MemStore()
        watch = NamespaceWatch(db, store).start()
        opts = db.namespace(b"default").opts
        watch.add(b"default", retention_ns=opts.retention_ns)  # no raise
        with pytest.raises(ValueError):
            watch.add(b"default", retention_ns=opts.retention_ns + HOUR)

    def test_conflicting_registration_refused(self):
        db = make_db()
        store = cluster_kv.MemStore()
        watch = NamespaceWatch(db, store).start()
        watch.add(b"x", retention_ns=HOUR)
        db.drop_namespace(b"x")  # gone locally, still registered
        with pytest.raises(ValueError, match="different options"):
            watch.add(b"x", retention_ns=2 * HOUR)

    def test_stop_deregisters_callback(self):
        db = make_db()
        store = cluster_kv.MemStore()
        watch = NamespaceWatch(db, store).start()
        watch.stop()
        assert not store._callbacks.get(REGISTRY_KEY)
        reg = {"phantom": {"retention_ns": HOUR, "index_enabled": False}}
        store.set(REGISTRY_KEY, json.dumps(reg).encode())
        assert b"phantom" not in db.namespaces
        assert b"default" in db.namespaces

    def test_registry_bytes_equal_reference(self):
        """The same admin sequence publishes the same registry bytes and
        versions from both packages."""
        store, jstore = cluster_kv.MemStore(), jkv.MemStore()
        watch = NamespaceWatch(make_db(), store).start()
        jwatch = JNamespaceWatch(make_jdb(), jstore).start()
        for w in (watch, jwatch):
            w.add(b"agg_1m", retention_ns=40 * HOUR)
            w.add(b"agg_5m", retention_ns=40 * HOUR, block_size_ns=HOUR,
                  index_enabled=False)
            w.remove(b"agg_1m")
            w.add(b"default", retention_ns=w.db.namespace(
                b"default").opts.retention_ns)
        got, want = store.get(REGISTRY_KEY), jstore.get(REGISTRY_KEY)
        assert (got.data, got.version) == (want.data, want.version)
        assert watch.updates_applied == jwatch.updates_applied


def _options(opts):
    return {f: getattr(opts, f) for f in (
        "write_new_series_async", "write_new_series_limit_per_second",
        "tick_min_interval_ns", "bootstrap_consistency", "write_consistency",
        "read_consistency")}


class TestRuntimeOptions:
    def test_listeners_fire_on_set_and_update(self):
        mgr = runtime.RuntimeOptionsManager()
        seen = []
        mgr.register_listener(seen.append)
        assert seen == [runtime.RuntimeOptions()]
        mgr.update(write_consistency="all")
        mgr.set(runtime.RuntimeOptions(read_consistency="one"))
        assert [o.write_consistency for o in seen] == [
            "majority", "all", "majority"]
        assert mgr.get().read_consistency == "one"

    def test_kv_keys_fold_like_the_reference_over_a_kv_service(self):
        """Existing keys fold at wiring time, later sets fold through the
        watch push, malformed JSON is ignored; both packages' managers end
        equal."""
        srv = KVServer().start()
        admin = RemoteStore(srv.endpoint)
        st, jst = RemoteStore(srv.endpoint), JRemoteStore(srv.endpoint)
        try:
            admin.set("_kvconfig/" + runtime.WRITE_NEW_SERIES_ASYNC, b"false")
            mgr = runtime.watch_kv_runtime_options(
                st, runtime.RuntimeOptionsManager())
            jmgr = jruntime.watch_kv_runtime_options(
                jst, jruntime.RuntimeOptionsManager())
            assert mgr.get().write_new_series_async is False
            for name, val in (
                    (runtime.WRITE_NEW_SERIES_LIMIT_PER_SECOND, b"500"),
                    (runtime.CLIENT_WRITE_CONSISTENCY, b'"all"'),
                    (runtime.CLIENT_READ_CONSISTENCY, b"not json"),
                    (runtime.BOOTSTRAP_CONSISTENCY_LEVEL, b'"one"')):
                admin.set("_kvconfig/" + name, val)
            want = dict(_options(runtime.RuntimeOptions()),
                        write_new_series_async=False,
                        write_new_series_limit_per_second=500,
                        write_consistency="all", bootstrap_consistency="one")
            assert _await(lambda: _options(mgr.get()) == want)
            assert _await(lambda: _options(jmgr.get()) == want)
        finally:
            for s in (admin, st, jst):
                s.close()
            srv.close()
