"""Port of tests/test_concurrency_sweep.py on m3_tpu_torch: the same cases
on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Concurrency sweep over one database: write + tick + flush + cold read +
index query hammering the same namespace simultaneously for a few seconds
(the closest Python gets to running the suite under -race; reference:
src/dbnode/storage/shard_race_prop_test.go and TESTING.md's -race policy).

Invariants asserted DURING the storm (torn-read detection) and after it
(lost-point detection):
  * a read never returns a value that was not written for that series at
    that timestamp (no torn/garbage reads);
  * read timestamps are strictly increasing (no interleaving corruption);
  * after the storm, every surviving (series, ts) -> value pair is exactly
    the last value written (no lost writes), through whatever mix of warm
    buffers and flushed+evicted blocks the storm produced;
  * the reverse index serves every written series id throughout.
"""

import threading
import time

import numpy as np
import pytest

from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.index.query import TermQuery
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.persist.fs import PersistManager
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.utils import xtime
from test_torch_cpu_default import cpu_default  # noqa: F401

S = 1_000_000_000
T0 = 1_700_000_000 * S
SPEEDUP = 600  # virtual seconds per wall second: windows close mid-storm


def test_concurrent_write_tick_flush_read_query(tmp_path):
    wall0 = time.time()

    def clock():
        return T0 + int((time.time() - wall0) * SPEEDUP * S)

    opts = NamespaceOptions(
        block_size_ns=10 * xtime.MINUTE,
        buffer_past_ns=5 * xtime.MINUTE,
        buffer_future_ns=5 * xtime.MINUTE,
        writes_to_commitlog=False,
    )
    db = Database(ShardSet(8), clock=clock)
    db.create_namespace(b"default", opts, index=NamespaceIndex(clock=clock))
    db.mark_bootstrapped()
    pm = PersistManager(str(tmp_path))
    from m3_tpu_torch.storage.retriever import BlockRetriever

    db.set_retriever(BlockRetriever(pm))  # cold reads serve evicted blocks

    n_writers, series_per_writer = 3, 6
    stop = threading.Event()
    errors = []
    # expectations[sid][t] = every value written at t, in write order
    # (writers own disjoint series, so "last" is well defined per thread).
    # Mid-storm reads may see any prefix's latest; the post-storm check
    # demands exactly the final value.
    expectations = [dict() for _ in range(n_writers * series_per_writer)]
    # indexed[si] turns True only after a write for si has RETURNED, so a
    # querier that snapshots it before querying has a sound lower bound on
    # what the reverse index must contain.
    indexed = [False] * (n_writers * series_per_writer)
    all_sids = [b"sweep-%d" % i for i in range(n_writers * series_per_writer)]

    def guard(fn):
        def run():
            try:
                while not stop.is_set():
                    fn()
            except Exception as e:  # noqa: BLE001 - surface in main thread
                errors.append(e)
                stop.set()
        return run

    def writer(widx):
        seq = [0]
        mine = list(range(widx * series_per_writer,
                          (widx + 1) * series_per_writer))

        def write_once():
            for si in mine:
                # Quantize to whole virtual seconds: the codec's DoD ticks
                # are int32 per time unit, and raw-ns jitter would force
                # the NANOSECOND unit where scheduler gaps overflow it.
                t = clock() // S * S
                v = float(widx * 1_000_000 + seq[0])
                # Record BEFORE the write: a reader racing the write must
                # find the value already in the expectation map.
                expectations[si].setdefault(t, []).append(v)
                db.write(b"default", all_sids[si], t, v,
                         tags={b"__name__": b"sweep",
                               b"w": str(widx).encode()})
                indexed[si] = True
                seq[0] += 1
        return write_once

    def ticker():
        db.tick()
        time.sleep(0.01)

    def flusher():
        db.flush(pm)
        db.evict_flushed()
        time.sleep(0.05)

    def reader():
        si = np.random.randint(len(all_sids))
        t_now = clock()
        pts = db.read(b"default", all_sids[si], T0, t_now + S)
        ts, vals = pts if isinstance(pts, tuple) else (pts[0], pts[1])
        ts = np.asarray(ts)
        vals = np.asarray(vals)
        if ts.size > 1 and not (np.diff(ts) > 0).all():
            raise AssertionError(f"non-monotone read ts for {all_sids[si]}")
        exp = expectations[si]
        for t, v in zip(ts.tolist(), vals.tolist()):
            # Writer may have recorded t AFTER we read; only check points
            # the expectation map already holds. Any value ever written at
            # t is a valid racy read; anything else is torn/garbage.
            want = exp.get(t)
            if want is not None and v not in want:
                raise AssertionError(
                    f"torn read {all_sids[si]} t={t}: got {v} want {want}")

    def querier():
        flags = list(indexed)  # snapshot BEFORE the query (sound bound)
        res = db.query_ids(b"default", TermQuery(b"__name__", b"sweep"))
        got = set(res)
        # every series whose write completed before the query must serve
        for si, sid in enumerate(all_sids):
            if flags[si] and sid not in got:
                raise AssertionError(f"index lost {sid}")
        time.sleep(0.01)

    threads = [threading.Thread(target=guard(writer(w))) for w in range(n_writers)]
    threads += [threading.Thread(target=guard(fn))
                for fn in (ticker, flusher, reader, reader, querier)]
    for t in threads:
        t.start()
    time.sleep(3.0)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "sweep thread hung"
    if errors:
        raise errors[0]

    # Post-storm: no lost writes anywhere in the retention window, through
    # whatever warm/flushed/evicted state each block ended up in.
    t_end = clock() + S
    total_checked = 0
    for si, sid in enumerate(all_sids):
        exp = expectations[si]
        if not exp:
            continue
        ts, vals = db.read(b"default", sid, T0, t_end)
        got = dict(zip(np.asarray(ts).tolist(), np.asarray(vals).tolist()))
        for t, writes in exp.items():
            assert got.get(t) == writes[-1], (
                f"lost point {sid} t={t}: wrote {writes[-1]}, "
                f"read {got.get(t)}")
        total_checked += len(exp)
    assert total_checked > 1000, f"storm too small ({total_checked} points)"
