"""Write benchmark harness against the coordinator HTTP surface (host copy
of m3_tpu/tools/write_bench.py; reference: src/query/benchmark — the
influxdb-comparisons-based write bench — and scripts/benchmarks/
benchmark-loadgen): drive m3nsch agents at the JSON write endpoint,
measure sustained writes/sec, optionally verify a read."""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Optional

from .. import nsch


def http_write_fn(endpoint: str):
    """Build an nsch write_fn posting one sample per call to
    /api/v1/json/write (batching variants ride the wire transport)."""

    def write(ns, sid, tags, t_ns, value):
        body = {
            "tags": {"__name__": sid.decode(errors="replace"),
                     **({k.decode(): v.decode() for k, v in tags.items()
                         if k != b"__name__"} if tags else {})},
            "timestamp": t_ns / 1e9,
            "value": value,
        }
        req = urllib.request.Request(
            f"{endpoint}/api/v1/json/write",
            data=json.dumps(body).encode(), method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()

    return write


def run_write_bench(endpoint: str, *, cardinality: int = 100,
                    n_agents: int = 4, duration_s: float = 5.0,
                    qps_per_agent: int = 100000,
                    clock=None) -> dict:
    """Returns {"writes", "errors", "writes_per_sec", "duration_s"}."""
    workload = nsch.Workload(
        metric_prefix=b"bench.metric", cardinality=cardinality,
        ingress_qps=qps_per_agent, datum=nsch.CounterDatum(rate=1.0))
    coord = nsch.NschCoordinator()
    coord.init(workload, [http_write_fn(endpoint) for _ in range(n_agents)],
               clock=clock)
    t0 = time.monotonic()
    coord.start()
    time.sleep(duration_s)
    coord.stop()
    dt = time.monotonic() - t0
    st = coord.status()
    return {
        "writes": st["total_written"],
        "errors": st["total_errors"],
        "writes_per_sec": st["total_written"] / dt,
        "duration_s": dt,
    }
