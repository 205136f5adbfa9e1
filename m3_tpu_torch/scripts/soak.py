"""Sustained-load soak of one port dbnode with its embedded coordinator
(counterpart of scripts/soak.sh): a `python -m m3_tpu_torch.services
dbnode` child on the campaign's device under continuous HTTP writes (three
writers) and a rotating query mix (instant, range, rate, grouped sum and
the subquery `avg_over_time(soak_metric[2m:30s])`) for SOAK_SECONDS
(default 30) after a warm-up, asserting at the end that

  * every write succeeded and every query answered success;
  * the child's RSS grew by less than SOAK_MAX_RSS_GROWTH_MB (default
    256) between the warm-up's end and the last sample: no unbounded
    cache, span buffer or leaked socket or thread.

Beside RSS it prints the child's device memory at both samples: its
HBMBudget tenants' bytes (`hbm.bytes` of the child's /debug/vars) and,
on the card, the card's used memory (nvidia-smi); and the route the
subquery took (the coordinator's explain) and the child's kernel
launches, printed by the child as it stops.

Usage:  SOAK_SECONDS=30 python -m m3_tpu_torch.scripts.soak [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

from ..device import resolve
from ..em import Operator, ProcessSpec
from . import await_line, device_arg

QUERIES = [
    ("query", "soak_metric"),
    ("query", "scalar(sum(soak_metric))"),
    ("query_range", "rate(soak_metric[1m])"),
    ("query_range", "sum by (host) (soak_metric)"),
    ("query_range", "avg_over_time(soak_metric[2m:30s])"),
]
SPAWN_S = 180.0


def child_rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def card_used_mb():
    """The card's used memory (nvidia-smi), MiB; None off the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return float(out.strip().splitlines()[0])


def child_launches(op: Operator) -> dict:
    """The kernel launches a stopped child printed as it closed."""
    found = [ln for ln in op.output if " kernel launches {" in ln]
    if not found:
        raise AssertionError("the child printed no kernel launches line: "
                             + "".join(op.output[-20:]))
    return json.loads(found[-1].partition(" kernel launches ")[2])


def spawn(service: str, config: dict, workdir: str, dev) -> Operator:
    """A port services child on `dev`, started and listening."""
    op = Operator(workdir)
    op.setup(ProcessSpec(service, json.dumps(config), workdir,
                         device=None if dev.type == "cuda" else str(dev)))
    op.start(timeout_s=SPAWN_S)
    return op


def _get(url: str, timeout: float = 15):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _device_memory(ep: str, dev) -> dict:
    tenants = _get(ep + "/debug/vars")["metrics"].get("hbm.bytes")
    return {"hbm_tenants_mb": (tenants or 0) / 2**20,
            "card_used_mb": card_used_mb() if dev.type == "cuda" else None}


def run(seconds: float, max_growth_mb: float, device=None,
        log=print) -> dict:
    dev = resolve(device)
    root = tempfile.mkdtemp(prefix="m3-soak-")
    # Port 0 throughout: each listener takes the port the kernel gives it
    # and the child prints it (a port picked here and bound there could be
    # taken in between by any process on the host).
    config = {"host_id": "soak", "listen_address": "127.0.0.1:0",
              "data_dir": os.path.join(root, "data"),
              "coordinator": {"listen_address": "127.0.0.1:0"}}
    stop = threading.Event()
    stats = {"writes": 0, "write_errs": 0, "queries": 0, "query_errs": 0}
    errors = []
    lock = threading.Lock()

    def count(key, err=None):
        with lock:
            stats[key] += 1
            if err is not None and len(errors) < 5:
                errors.append(f"{key}: {type(err).__name__}: {err}")

    def writer(widx):
        i = 0
        while not stop.is_set():
            body = json.dumps({
                "tags": {"__name__": "soak_metric", "host": f"h{widx}",
                         "core": str(i % 8)},
                "timestamp": int(time.time()), "value": float(i)}).encode()
            req = urllib.request.Request(ep + "/api/v1/json/write",
                                         data=body, method="POST")
            req.add_header("Content-Type", "application/json")
            try:
                urllib.request.urlopen(req, timeout=10).read()
                count("writes")
            except Exception as e:  # noqa: BLE001 — counted, asserted
                count("write_errs", e)
            i += 1

    def querier():
        i = 0
        while not stop.is_set():
            kind, q = QUERIES[i % len(QUERIES)]
            now = int(time.time())
            if kind == "query":
                params = {"query": q, "time": now}
            else:
                params = {"query": q, "start": now - 120, "end": now,
                          "step": 10}
            try:
                out = _get(f"{ep}/api/v1/{kind}?"
                           + urllib.parse.urlencode(params))
                if out["status"] != "success":
                    raise AssertionError(out)
                count("queries")
            except Exception as e:  # noqa: BLE001 — counted, asserted
                count("query_errs", e)
            i += 1
            stop.wait(0.02)

    t0 = time.monotonic()
    op = spawn("dbnode", config, root, dev)
    spawn_s = time.monotonic() - t0
    try:
        ep = await_line(op, r"embedded coordinator on ",
                        "the coordinator").rsplit(" ", 1)[-1].strip()
        threads = [threading.Thread(target=writer, args=(w,), daemon=True)
                   for w in range(3)]
        threads.append(threading.Thread(target=querier, daemon=True))
        for th in threads:
            th.start()
        time.sleep(min(5.0, seconds / 3))  # warm-up: caches fill
        rss_start = child_rss_mb(op.pid)
        mem_start = _device_memory(ep, dev)
        time.sleep(seconds)
        stop.set()
        for th in threads:
            th.join(timeout=20)
        rss_end = child_rss_mb(op.pid)
        mem_end = _device_memory(ep, dev)
        now = int(time.time())
        route = _get(f"{ep}/api/v1/query_range?" + urllib.parse.urlencode(
            {"query": QUERIES[-1][1], "start": now - 120, "end": now,
             "step": 10, "explain": "true", "analyze": "true"}))
        executed = route.get("data", {}).get("explain", {}).get("executed",
                                                                {})
    finally:
        stop.set()
        op.stop(grace_s=30)
        shutil.rmtree(root, ignore_errors=True)
    launches = child_launches(op)
    growth = rss_end - rss_start
    out = dict(stats, rss_start_mb=rss_start, rss_end_mb=rss_end,
               rss_growth_mb=growth, device_memory_start=mem_start,
               device_memory_end=mem_end, spawn_s=spawn_s,
               subquery_route=executed.get("route"), launches=launches,
               device=str(dev), errors=errors)
    log(f"soak: {stats['writes']} writes ({stats['write_errs']} errs), "
        f"{stats['queries']} queries ({stats['query_errs']} errs) in "
        f"{seconds:g} s after the warm-up, rss {rss_start:.0f} -> "
        f"{rss_end:.0f} MB (+{growth:.0f}), device memory {mem_start} -> "
        f"{mem_end}; the subquery's route {executed.get('route')!r}; the "
        f"child's spawn {spawn_s:.1f} s on {dev}")
    if not (stats["writes"] > 0 and stats["queries"] > 0):
        raise AssertionError(f"soak: nothing served: {stats}")
    if stats["write_errs"] or stats["query_errs"]:
        raise AssertionError(f"soak: errors {stats}: {errors}")
    if growth >= max_growth_mb:
        raise AssertionError(f"soak: RSS grew {growth:.0f} MB >= "
                             f"{max_growth_mb:g} MB")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(float(os.environ.get("SOAK_SECONDS", "30")),
              float(os.environ.get("SOAK_MAX_RSS_GROWTH_MB", "256")),
              args.device, log=lambda s: print(s, flush=True))
    print("SOAK PASS")
    print(f"soak kernel launches {json.dumps(out['launches'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
