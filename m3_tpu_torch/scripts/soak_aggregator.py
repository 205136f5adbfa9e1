"""Aggregator-tier soak on the port (counterpart of
scripts/_soak_aggregator.py, `SOAK_TARGET=aggregator scripts/soak.sh`):
a `python -m m3_tpu_torch.services aggregator` child on the campaign's
device, fed timed counters over the raw TCP framed wire for SOAK_SECONDS
(default 30), alternating the two batch frames (per-entry "batch" and
columnar "tbatch"), asserting that

  * the durable flush log grows (windows keep closing and flushing under
    load);
  * every fully closed window of a sampled counter id flushed exactly the
    sum sent for it (no lost or double-applied value);
  * the child's RSS grew by less than SOAK_MAX_RSS_GROWTH_MB (default
    192) after the warm-up.

Usage:  SOAK_SECONDS=30 python -m m3_tpu_torch.scripts.soak_aggregator
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time

import numpy as np

from ..device import resolve
from ..metrics.metric import MetricType
from ..rpc import wire
from . import device_arg
from .soak import child_launches, child_rss_mb, spawn

S = 10**9
# One window resolution drives the writer's window math, the storage
# policy and the flush log's window-start recovery.
RESOLUTION_S = 10
RESOLUTION_NS = RESOLUTION_S * S
POLICY = f"{RESOLUTION_S}s:2d"
SAMPLED = b"soak.counter.0"
FLUSH_WAIT_S = 12.0  # after the last write: the last windows close, flush


def run(seconds: float, max_growth_mb: float, device=None,
        log=print) -> dict:
    dev = resolve(device)
    workdir = tempfile.mkdtemp(prefix="m3-agg-soak-")
    flush_log = os.path.join(workdir, "flush.log")
    config = {"instance_id": "soak-agg", "listen_address": "127.0.0.1:0",
              "num_shards": 8, "flush_interval": "1s",
              "flush_log": flush_log}
    warmup_s = min(5.0, seconds / 3)
    t0 = time.monotonic()
    op = spawn("aggregator", config, workdir, dev)
    spawn_s = time.monotonic() - t0
    try:
        host, _, port = op.endpoint.rpartition(":")
        sent = {}  # window start -> the sum sent for the sampled id
        sock = socket.create_connection((host, int(port)), timeout=10)
        t_end = time.time() + seconds
        warmed = False
        rss_start = 0.0
        writes = 0
        i = 0
        while time.time() < t_end:
            now = time.time_ns()
            win = now // RESOLUTION_NS * RESOLUTION_NS
            use_tbatch = (i // 50) % 2 == 0
            ids, values, entries = [], [], []
            for j in range(50):
                mid = b"soak.counter.%d" % (j % 20)
                v = float(i % 7 + 1)
                if use_tbatch:
                    ids.append(mid)
                    values.append(v)
                else:
                    entries.append({"t": "timed",
                                    "mtype": int(MetricType.COUNTER),
                                    "id": mid, "time": now, "value": v,
                                    "policy": POLICY})
                if mid == SAMPLED:
                    sent[win] = sent.get(win, 0.0) + v
                i += 1
            if use_tbatch:
                wire.write_frame(sock, {
                    "t": "tbatch", "mtype": int(MetricType.COUNTER),
                    "policy": POLICY, "agg_id": 0, "ids": ids,
                    "times": np.full(len(ids), now, np.int64),
                    "values": np.asarray(values, np.float64)})
                writes += len(ids)
            else:
                wire.write_frame(sock, {"t": "batch", "entries": entries})
                writes += len(entries)
            if not warmed and time.time() > t_end - seconds + warmup_s:
                rss_start = child_rss_mb(op.pid)
                warmed = True
            time.sleep(0.01)
        sock.close()
        time.sleep(FLUSH_WAIT_S)
        rss_end = child_rss_mb(op.pid)
        flushed = {}
        n_lines = 0
        with open(flush_log, "rb") as f:
            for line in f:
                mid, t, v, _pol = line.split(b"\t")
                n_lines += 1
                if mid == SAMPLED:
                    flushed[int(t) - RESOLUTION_NS] = float(v)
    finally:
        op.stop(grace_s=30)
        shutil.rmtree(workdir, ignore_errors=True)
    launches = child_launches(op)
    if n_lines == 0:
        raise AssertionError("agg soak: nothing flushed")
    checked = 0
    # Every fully closed window sent (the first and last straddle the
    # soak's edges) flushed exactly its sum.
    for w in sorted(sent)[1:-1]:
        if w not in flushed:
            raise AssertionError(f"agg soak: window {w} never flushed")
        if flushed[w] != sent[w]:
            raise AssertionError(f"agg soak: window {w} flushed "
                                 f"{flushed[w]}, sent {sent[w]}")
        checked += 1
    growth = rss_end - rss_start
    log(f"agg soak: {writes} datapoints sent, {n_lines} windows flushed, "
        f"{checked} sampled windows exact, rss {rss_start:.0f} -> "
        f"{rss_end:.0f} MB (+{growth:.0f}); the child's spawn "
        f"{spawn_s:.1f} s on {dev}")
    if checked == 0:
        raise AssertionError("agg soak: too short to close a full window")
    if growth >= max_growth_mb:
        raise AssertionError(f"agg soak: RSS grew {growth:.0f} MB >= "
                             f"{max_growth_mb:g} MB")
    return {"writes": writes, "flushed": n_lines, "checked": checked,
            "rss_start_mb": rss_start, "rss_end_mb": rss_end,
            "rss_growth_mb": growth, "spawn_s": spawn_s,
            "launches": launches, "device": str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(float(os.environ.get("SOAK_SECONDS", "30")),
              float(os.environ.get("SOAK_MAX_RSS_GROWTH_MB", "192")),
              args.device, log=lambda s: print(s, flush=True))
    print("AGG SOAK PASS")
    print(f"soak_aggregator kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
