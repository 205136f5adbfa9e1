"""Port of tests/test_concurrent_writes.py on m3_tpu_torch: the same cases
on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Intra-node write concurrency: per-shard locks replace the old global
write mutex (reference: shard.go:769 per-shard RWMutex + the nsIndex /
commit log internal locking). Writes to different shards must proceed in
parallel; concurrent writes to one shard must stay correct."""

import threading
import time

import numpy as np
import pytest

from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.index.query import TermQuery
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from test_torch_cpu_default import cpu_default  # noqa: F401

S = 1_000_000_000
T0 = 1_700_000_000 * S


def make_db(num_shards=8, clock=None):
    db = Database(ShardSet(num_shards), clock=clock or (lambda: T0))
    db.create_namespace(b"default", NamespaceOptions(),
                        index=NamespaceIndex(clock=clock or (lambda: T0)))
    return db


def ids_for_distinct_shards(db, count):
    """Series IDs hashing to `count` different shards."""
    picked = {}
    i = 0
    while len(picked) < count:
        sid = b"series-%d" % i
        shard = db.shard_set.lookup(sid)
        if shard not in picked:
            picked[shard] = sid
        i += 1
    return list(picked.values())


class TestCrossShardParallelism:
    def test_write_proceeds_while_other_shard_blocked(self):
        """Semantics of the per-shard lock, deterministically: hold one
        shard's write lock and prove a write to a DIFFERENT shard completes
        while it is held (impossible under the old global node mutex)."""
        db = make_db()
        ns = db.namespace(b"default")
        sid_a, sid_b = ids_for_distinct_shards(db, 2)
        shard_a = ns.shard_for(db.shard_set.lookup(sid_a))

        done = threading.Event()

        def write_other_shard():
            db.write(b"default", sid_b, T0, 1.0)
            done.set()

        with shard_a.write_lock:  # simulate a long write/seal on shard A
            t = threading.Thread(target=write_other_shard)
            t.start()
            assert done.wait(timeout=5.0), (
                "write to shard B blocked while shard A's lock was held — "
                "global serialization is back")
            t.join()
        # ... and the same-shard write serializes (completes after release).
        done2 = threading.Event()

        def write_same_shard():
            db.write(b"default", sid_a, T0, 2.0)
            done2.set()

        with shard_a.write_lock:
            t2 = threading.Thread(target=write_same_shard)
            t2.start()
            assert not done2.wait(timeout=0.2), (
                "same-shard write did not serialize with the shard lock")
        assert done2.wait(timeout=5.0)
        t2.join()

    def test_node_service_has_no_global_write_lock(self):
        from m3_tpu_torch.rpc.node_server import NodeService

        svc = NodeService(make_db())
        assert not hasattr(svc, "_write_lock")


class TestConcurrentWriteStress:
    def test_many_threads_many_shards(self):
        """8 threads x distinct series across shards, concurrent with ticks;
        every datapoint must land exactly once."""
        now = {"t": T0}
        db = make_db(num_shards=16, clock=lambda: now["t"])
        n_threads, n_series, n_points = 8, 4, 50
        errors = []

        def worker(tid):
            try:
                for s in range(n_series):
                    sid = b"w%d-s%d" % (tid, s)
                    for i in range(n_points):
                        # ms spacing keeps everything inside the buffer's
                        # acceptance window around the fixed clock
                        db.write(b"default", sid, T0 + i * 1_000_000,
                                 float(tid * 1000 + i),
                                 tags={b"w": b"%d" % tid})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        ticker_stop = threading.Event()

        def ticker():
            while not ticker_stop.is_set():
                for nsobj in db.namespaces.values():
                    nsobj.tick(now["t"])
                time.sleep(0.001)

        tick_thread = threading.Thread(target=ticker)
        tick_thread.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ticker_stop.set()
        tick_thread.join()
        assert not errors, errors

        for tid in range(n_threads):
            for s in range(n_series):
                sid = b"w%d-s%d" % (tid, s)
                t, v = db.read(b"default", sid, 0, 2**62)
                assert len(t) == n_points, (sid, len(t))
                assert np.array_equal(
                    np.sort(v),
                    tid * 1000 + np.arange(n_points, dtype=np.float64))
        # Reverse index saw every concurrent insert exactly once.
        idx = db.namespace(b"default").index
        for tid in range(n_threads):
            got = idx.query(TermQuery(b"w", b"%d" % tid))
            assert len(got) == n_series

    def test_batch_writes_concurrent(self):
        db = make_db(num_shards=16)
        n_threads, n_points = 6, 200
        errors = []

        def worker(tid):
            try:
                ids = [b"batch-%d-%d" % (tid, i % 10) for i in range(n_points)]
                ts = T0 + np.arange(n_points, dtype=np.int64) * 1_000_000
                vals = np.full(n_points, float(tid))
                db.write_batch(b"default", ids, ts, vals,
                               tags=[{b"t": b"%d" % tid}] * n_points)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for tid in range(n_threads):
            for i in range(10):
                t, v = db.read(b"default", b"batch-%d-%d" % (tid, i), 0, 2**62)
                assert len(t) == n_points // 10
                assert (v == float(tid)).all()
