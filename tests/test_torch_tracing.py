"""Port of tests/test_tracing.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Tracing + profiling (reference: x/instrument tracing options +
net/http/pprof endpoints every service exposes)."""

import json
import threading
import time
import urllib.request

import pytest

from m3_tpu_torch.utils import tracing
from test_torch_cpu_default import cpu_default  # noqa: F401


class TestSpans:
    def test_span_tree_and_recent(self):
        tracer = tracing.Tracer()
        with tracer.span("root", op="test") as root:
            with tracer.span("child1"):
                pass
            with tracer.span("child2") as c2:
                c2.set_tag("rows", 7)
        traces = tracer.recent_traces()
        assert traces[-1]["name"] == "root"
        assert [c["name"] for c in traces[-1]["children"]] == ["child1", "child2"]
        assert traces[-1]["children"][1]["tags"]["rows"] == 7
        assert traces[-1]["duration_us"] >= 0

    def test_exception_tagged_and_stack_unwound(self):
        tracer = tracing.Tracer()
        with pytest.raises(RuntimeError):
            with tracer.span("boom"):
                raise RuntimeError("x")
        assert tracer.current() is None
        assert "error" in tracer.recent_traces()[-1]["tags"]

    def test_thread_local_isolation(self):
        tracer = tracing.Tracer()
        seen = {}

        def worker():
            with tracer.span("other-thread"):
                seen["cur"] = tracer.current().name

        with tracer.span("main-thread"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            assert tracer.current().name == "main-thread"
        assert seen["cur"] == "other-thread"


class TestProfiling:
    def test_thread_stacks_lists_threads(self):
        out = tracing.thread_stacks()
        assert "--- thread" in out
        assert "test_thread_stacks_lists_threads" in out

    def test_sampling_profiler_catches_hot_thread(self):
        stop = threading.Event()

        def hot_loop_for_profiler():
            x = 0
            while not stop.is_set():
                x += 1

        t = threading.Thread(target=hot_loop_for_profiler)
        t.start()
        try:
            prof = tracing.profile(seconds=0.3, hz=200)
        finally:
            stop.set()
            t.join()
        assert prof, "no samples collected"
        flat = json.dumps(prof)
        assert "hot_loop_for_profiler" in flat


class TestDebugEndpoints:
    def test_traces_profile_stacks_over_http(self):
        from m3_tpu_torch.cluster import kv as cluster_kv
        from m3_tpu_torch.coordinator import run_embedded
        from m3_tpu_torch.index.namespace_index import NamespaceIndex
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        T0 = 1_700_000_000 * 1_000_000_000
        db = Database(ShardSet(4), clock=lambda: T0)
        db.create_namespace(b"default", NamespaceOptions(),
                            index=NamespaceIndex(clock=lambda: T0))
        c = run_embedded(db, kv_store=cluster_kv.MemStore(), clock=lambda: T0)
        try:
            c.writer.write({b"__name__": b"traced"}, T0 - 30 * 10**9, 1.0)
            c.engine.execute_range("traced", T0 - 60 * 10**9, T0, 10 * 10**9)
            traces = json.load(urllib.request.urlopen(
                c.endpoint + "/debug/traces"))["traces"]
            assert any(t["name"] == "query.execute_range" for t in traces)
            q = [t for t in traces if t["name"] == "query.execute_range"][-1]
            assert any(ch["name"] == "query.fetch"
                       for ch in q.get("children", []))
            prof = json.load(urllib.request.urlopen(
                c.endpoint + "/debug/pprof/profile?seconds=0.2"))
            assert "profile" in prof
            stacks = urllib.request.urlopen(
                c.endpoint + "/debug/pprof/goroutine").read().decode()
            assert "--- thread" in stacks
        finally:
            c.close()
