"""Port of tests/test_race_breadth.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Race-breadth storms over the concurrent planes the storage sweep
(test_concurrency_sweep.py) does not touch: the networked KV service, the
aggregator tier's add/flush pipeline, and the msg pub/sub delivery loop.
Together these approximate the reference's `-race`-across-the-suite policy
(/root/reference/TESTING.md) for the subsystems whose reference race
suites live in src/cluster/kv, src/aggregator (concurrent add + Consume),
and src/msg (at-least-once under handler failure).

Each storm hammers one subsystem from several threads for a bounded wall
time and asserts a CONSERVATION invariant that any lost update, double
apply, or torn state would break:

  * KV: final counter value == number of successful CAS increments across
    all wire clients; watch observers see monotonically non-decreasing
    versions ending at the final version.
  * Aggregator: sum of every flushed counter window == sum of every value
    successfully added (no lost adds, no double flushes), across
    concurrent writers, a ticker, and a concurrent flusher.
  * msg: every published payload is processed at least once despite a
    handler that fails the first delivery of a quarter of them, and the
    producer's unacked set drains to zero (ack path loses nothing).
"""

import threading
import time

from m3_tpu_torch.cluster.kv_service import KVServer, RemoteStore
from test_torch_cpu_default import cpu_default  # noqa: F401

S = 1_000_000_000


def _await(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


class TestKVCasStorm:
    def test_cas_increments_conserved_across_wire_clients(self):
        """N RemoteStore clients CAS-increment one shared counter key.
        Every successful CAS must be reflected exactly once in the final
        value (kv.go Store.CheckAndSet linearizability); a watcher on a
        separate connection must observe non-decreasing versions that
        reach the final version."""
        server = KVServer().start()
        n_clients, per_client = 4, 40
        successes = [0] * n_clients
        errors = []
        seen_versions = []
        watcher = RemoteStore(server.endpoint)
        watcher.on_change("ctr", lambda k, v: seen_versions.append(v.version))

        def worker(ci):
            store = RemoteStore(server.endpoint)
            try:
                for _ in range(per_client):
                    # CAS-retry loop: read, bump, expect our read version.
                    # Conflicts RAISE (KeyError for setnx-exists,
                    # ValueError for version mismatch — kv.go-style error
                    # returns); a loser retries with a fresh read.
                    while True:
                        try:
                            cur = store.get("ctr")
                            if cur is None:
                                store.set_if_not_exists("ctr", b"1")
                            else:
                                nxt = str(int(cur.data) + 1).encode()
                                store.check_and_set("ctr", cur.version, nxt)
                        except (KeyError, ValueError):
                            continue  # lost the race; re-read and retry
                        successes[ci] += 1
                        break
            except Exception as e:  # noqa: BLE001 - surface in main thread
                errors.append(e)
            finally:
                store.close()

        threads = [threading.Thread(target=worker, args=(ci,))
                   for ci in range(n_clients)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "CAS worker hung"
            assert not errors, errors[0]
            total = sum(successes)
            assert total == n_clients * per_client
            final = watcher.get("ctr")
            # Conservation: every successful CAS applied exactly once.
            assert int(final.data) == total
            assert final.version == total
            # Watch stream: versions never go backwards, and the final
            # version is eventually delivered.
            assert _await(lambda: seen_versions
                          and seen_versions[-1] == final.version)
            assert all(a <= b for a, b in
                       zip(seen_versions, seen_versions[1:]))
        finally:
            watcher.close()
            server.close()


class TestAggregatorAddFlushStorm:
    def test_counter_sums_conserved_under_concurrent_flush(self):
        """Concurrent writers add counters while a flusher closes windows
        and a ticker expires entries; the sum over all flushed windows
        must equal the sum of all successfully-added values — a lost add,
        a double-flushed bucket, or a flush racing a stage would each
        break the equality (reference: generic_elem.go Consume vs
        AddUnion under the elem lock)."""
        from m3_tpu_torch.aggregator import Aggregator, CaptureHandler
        from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                             StagedMetadata)
        from m3_tpu_torch.metrics.metric import MetricUnion
        from m3_tpu_torch.metrics.policy import StoragePolicy

        TEN_S = StoragePolicy.of("10s", "2d")
        meta = (StagedMetadata(0, False, Metadata(
            (PipelineMetadata(0, (TEN_S,)),))),)

        T0 = 1_700_000_000 * S
        SPEEDUP = 100  # virtual seconds per wall second
        wall0 = time.time()

        def clock():
            return T0 + int((time.time() - wall0) * SPEEDUP * S)

        cap = CaptureHandler()
        # buffer_past of two windows: an add stamped "now" can never land
        # in a window the concurrent flusher is already collecting.
        agg = Aggregator(num_shards=8, clock=clock, flush_handler=cap,
                         buffer_past_ns=20 * S)
        n_writers, series_per_writer = 3, 4
        added = [0] * n_writers  # per-writer accepted-value running sum
        stop = threading.Event()
        errors = []

        def guard(fn):
            def run():
                try:
                    while not stop.is_set():
                        fn()
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    stop.set()
            return run

        def writer(widx):
            mids = [b"storm.%d.%d" % (widx, i)
                    for i in range(series_per_writer)]
            seq = [1]

            def add_once():
                for mid in mids:
                    v = seq[0]
                    if agg.add_untimed(MetricUnion.counter(mid, v), meta):
                        added[widx] += v
                    seq[0] += 1
            return add_once

        def flusher():
            agg.flush()
            time.sleep(0.02)

        def ticker():
            agg.tick()
            time.sleep(0.05)

        threads = [threading.Thread(target=guard(writer(w)))
                   for w in range(n_writers)]
        threads += [threading.Thread(target=guard(fn))
                    for fn in (flusher, ticker)]
        for t in threads:
            t.start()
        time.sleep(2.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "aggregator storm thread hung"
        if errors:
            raise errors[0]
        # Drain: jump the virtual clock two hours forward (well past every
        # staged window plus buffer_past) and flush the remainder.
        wall0 -= 7200.0 / SPEEDUP
        agg.flush()
        flushed_total = sum(m.value for m in cap.metrics)
        assert flushed_total == sum(added), (
            f"conservation broken: flushed {flushed_total} != "
            f"added {sum(added)}")
        assert sum(added) > 0


class TestMsgDeliveryStorm:
    def test_at_least_once_with_flaky_handler_and_concurrent_publishers(self):
        """Four publisher threads share one Producer; the consumer's
        handler fails the FIRST delivery of every 4th payload (no ack →
        producer retry redelivers). Every payload must be processed at
        least once and the producer's unacked set must drain to zero
        (message_writer.go retry-until-ack under concurrent writes)."""
        from m3_tpu_torch.cluster.placement import Instance, initial_placement
        from m3_tpu_torch.msg import Consumer, ConsumerService, Producer, Topic

        processed = set()
        failed_once = set()
        lock = threading.Lock()

        def handler(shard, value):
            with lock:
                idx = int(value.split(b"-")[-1])
                if idx % 4 == 0 and value not in failed_once:
                    failed_once.add(value)
                    raise RuntimeError("injected first-delivery failure")
                processed.add(value)

        consumer = Consumer(handler).start()
        placement = initial_placement(
            [Instance(id="c0", endpoint=consumer.endpoint)], num_shards=4,
            replica_factor=1)
        topic = Topic("storm", 4, (ConsumerService("svc"),))
        prod = Producer(topic, {"svc": lambda: placement},
                        retry_delay_s=0.05)
        n_pub, per_pub = 4, 25
        errors = []

        def publisher(pi):
            try:
                for i in range(per_pub):
                    idx = pi * per_pub + i
                    prod.publish(idx % 4, b"storm-%d" % idx)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=publisher, args=(pi,))
                   for pi in range(n_pub)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive(), "publisher hung"
            assert not errors, errors[0]
            want = {b"storm-%d" % i for i in range(n_pub * per_pub)}
            assert _await(lambda: processed >= want, timeout=20.0), (
                f"undelivered: {sorted(want - processed)[:5]} "
                f"({len(want - processed)} missing)")
            assert _await(lambda: prod.unacked() == 0, timeout=20.0)
            assert _await(lambda: prod.buffered_bytes() == 0, timeout=20.0)
        finally:
            prod.close()
            consumer.close()
