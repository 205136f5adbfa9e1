"""Port of tests/test_concurrent_round4.py on m3_tpu_torch: the same cases
on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py). TestUploadCacheRaces is in
tests/test_torch_cuda.py: the port's upload cache runs on the card only
(`ops/temporal._cached_put`).

Threaded stress over this round's new concurrent surfaces (the -race
breadth analog, SURVEY §5): the temporal device-upload cache, the
dual-format aggregator ingest server, and the tags-only aggregate path
under concurrent writes."""

import concurrent.futures as cf
import socket
import threading
import time

import numpy as np

from test_torch_cpu_default import cpu_default  # noqa: F401

S = 1_000_000_000


class TestMixedFormatIngestStress:
    def test_many_connections_both_generations(self):
        """8 client threads, each interleaving binary frames and legacy
        JSON lines on its own connection; every accepted metric must be
        aggregated exactly once."""
        from m3_tpu_torch.aggregator import Aggregator, CaptureHandler
        from m3_tpu_torch.aggregator.migration import write_legacy
        from m3_tpu_torch.aggregator.server import RawTCPServer, union_to_wire
        from m3_tpu_torch.metrics.metadata import (Metadata, PipelineMetadata,
                                             StagedMetadata)
        from m3_tpu_torch.metrics.metric import MetricUnion
        from m3_tpu_torch.metrics.policy import StoragePolicy
        from m3_tpu_torch.rpc import wire
        from m3_tpu_torch.testing.cluster import SettableClock

        clock = SettableClock(100 * S)
        cap = CaptureHandler()
        agg = Aggregator(num_shards=16, clock=clock, flush_handler=cap)
        srv = RawTCPServer(agg).start()
        md = (StagedMetadata(0, False, Metadata(
            (PipelineMetadata(0, (StoragePolicy.of("10s", "2d"),)),))),)
        per_thread = 40
        n_threads = 8
        host, _, port = srv.endpoint.rpartition(":")

        def client(tid):
            sock = socket.create_connection((host, int(port)), timeout=10)
            mid = b"stress.counter"
            for i in range(per_thread):
                if i % 2 == 0:
                    wire.write_frame(sock, union_to_wire(
                        MetricUnion.counter(mid, 1), md))
                else:
                    write_legacy(sock, "counter", mid.decode(), 1,
                                 ["10s:2d"])
            sock.close()

        try:
            with cf.ThreadPoolExecutor(n_threads) as ex:
                list(ex.map(client, range(n_threads)))
            deadline = time.time() + 10
            want = per_thread * n_threads
            while srv.frames < want and time.time() < deadline:
                time.sleep(0.02)
            assert srv.frames == want and srv.errors == 0
            clock.advance(10 * S)
            agg.flush()
            out = cap.by_id(b"stress.counter")
            assert len(out) == 1 and out[0].value == float(want)
        finally:
            srv.close()


class TestAggregatePathUnderWrites:
    def test_complete_tags_during_concurrent_writes(self):
        """aggregate_tags served while writers add new series must never
        raise and must always return a subset-consistent snapshot."""
        from m3_tpu_torch.index.namespace_index import NamespaceIndex
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions
        from m3_tpu_torch.index import query as iq

        now = {"t": 1_600_000_000 * S}
        db = Database(ShardSet(8), clock=lambda: now["t"])
        db.create_namespace(b"default", NamespaceOptions(),
                            index=NamespaceIndex(clock=lambda: now["t"]))
        stop = threading.Event()
        errors = []

        def writer(tid):
            try:
                # Bounded: an unbounded loop grows the term dictionary
                # quadratically under the readers' full scans.
                for i in range(400):
                    if stop.is_set():
                        break
                    sid = b"m|%d|%d" % (tid, i)
                    db.write(b"default", sid, now["t"], 1.0,
                             tags={b"__name__": b"m",
                                   b"w": str(tid).encode(),
                                   b"i": str(i).encode()})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def reader(_):
            try:
                for _ in range(15):
                    fields = db.aggregate_tags(
                        b"default", iq.AllQuery(), 0, 2**62)
                    if fields:
                        assert b"__name__" in fields
                        assert fields[b"__name__"] == {b"m"}
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        try:
            with cf.ThreadPoolExecutor(4) as ex:
                list(ex.map(reader, range(4)))
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not errors, errors[:3]
