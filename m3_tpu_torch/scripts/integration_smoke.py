"""Multi-process end-to-end smoke of the port (counterpart of
scripts/integration_smoke.sh): a KV metadata service, two dbnodes, a
standalone coordinator, two aggregators and an HA aggregator pair, each a
`python -m m3_tpu_torch.services` child on the campaign's device, sharing
cluster state through the KV child. Each child starts as soon as what it
needs is up, beside the others that can: the aggregators and the HA
leader with the dbnodes, the HA follower with the coordinator (the shell
script starts the last four in later steps, one after another). Every
listener binds port 0 and the child prints the port it got. Its steps,
each printed with its verdict:

  1. kv            the KV metadata service;
  2. dbnodes       two dbnodes (16 shards, kv_endpoint);
  3. placement     the dbnode placement (RF 1) published to KV;
  4. coordinator   a standalone coordinator (and its carbon listener)
                   finds them through the placement; /health answers;
  5. scatter-gather 30 JSON writes over 6 hosts through the coordinator:
                   query_range reads all 6 series back across both
                   dbnodes, a sum(rate(...)), a subquery over an @-pinned
                   selector (one constant value a series), and an instant
                   scalar (resultType scalar, "84");
  6. agg placement the aggregators' placement in KV: agg-a takes all 8
                   shards, then agg-b is added and takes some through its
                   KV watch, without a restart;
  7. prometheus    a snappy protobuf remote write, read back by
                   query_range;
  8. carbon        three carbon lines, rendered back over Graphite;
  9. failover      the HA pair on one election (ha-a started first, so
                   it campaigned alone): both take the same 5
                   timed windows, the leader (whichever flushes first) is
                   SIGKILLed after its first flush, and the follower
                   flushes the rest: every window exactly once across the
                   two flush logs, no gap, both instances flushed.

A failing step raises AssertionError naming it. The kernel launches the
children printed as they stopped are summed (the SIGKILLed leader's die
with it).

Usage:  python -m m3_tpu_torch.scripts.integration_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

from ..cluster.kv_service import RemoteStore
from ..cluster.placement import Instance, PlacementService
from ..coordinator import promremote
from ..device import resolve
from ..metrics.metric import MetricType
from ..rpc import wire
from . import await_cond, await_line, device_arg
from .soak import child_launches, spawn

S = 10**9
WAIT_S = 120.0


def _http(url: str, body=None, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _listen(op, service: str) -> str:
    line = await_line(op, rf"m3_tpu_torch {service} listening on ",
                       f"{service}'s listen line")
    return line.rsplit(" ", 1)[-1].strip()


class Smoke:
    def __init__(self, dev, log):
        self.dev = dev
        self.log = log
        self.root = tempfile.mkdtemp(prefix="m3-integration-")
        self.ops = {}      # name -> Operator (running or stopped)
        self.killed = set()
        self.verdicts = []

    def start(self, *specs):
        """Start (name, service, config) children at once; each listening
        before this returns."""
        errs = []

        def one(name, service, config):
            try:
                wd = os.path.join(self.root, name)
                os.makedirs(wd, exist_ok=True)
                self.ops[name] = spawn(service, config, wd, self.dev)
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(f"{name}: {e!r}")

        threads = [threading.Thread(target=one, args=s) for s in specs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            raise AssertionError(f"spawn: {errs}")

    def step(self, n: int, name: str, fn):
        t0 = time.monotonic()
        detail = fn()
        secs = time.monotonic() - t0
        self.verdicts.append((n, name, "ok", secs))
        self.log(f"integration step {n} {name}: ok in {secs:.2f} s"
                 + (f" ({detail})" if detail else ""))

    def close(self) -> dict:
        """Stop every child still running; the kernel launches they
        printed as they stopped, summed, and the names of those that
        printed none under "missing"."""
        launches = {"missing": []}
        for name, op in self.ops.items():
            if name in self.killed:
                continue
            op.stop(grace_s=30)
            try:
                got = child_launches(op)
            except AssertionError:
                launches["missing"].append(name)
                continue
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        shutil.rmtree(self.root, ignore_errors=True)
        return launches

    # ---------------------------------------------------------------- steps

    def kv(self):
        self.start(("kv", "kv", {"listen_address": "127.0.0.1:0"}))
        self.kv_ep = _listen(self.ops["kv"], "kv")
        return f"kv {self.kv_ep}"

    def dbnodes(self):
        specs = [(f"dbnode{i}", "dbnode", {
            "host_id": f"dbnode-{i}", "listen_address": "127.0.0.1:0",
            "data_dir": os.path.join(self.root, f"data{i}"),
            "num_shards": 16, "kv_endpoint": self.kv_ep,
            "namespaces": [{"name": "default", "retention": "2h"}]})
            for i in (1, 2)]
        agg = [(f"agg{a}", "aggregator", {
            "instance_id": f"agg-{a}", "listen_address": "127.0.0.1:0",
            "num_shards": 8, "kv_endpoint": self.kv_ep,
            "placement_key": "_placement/agg",
            "election_id": f"agg-election-{a}", "flush_interval": "5s"})
            for a in ("a", "b")]
        # The aggregators of step 6 start with the dbnodes: they only
        # watch the KV placement key until step 6 publishes it. So does
        # step 9's HA leader, which campaigns alone until its follower
        # starts in step 4.
        self.start(*specs, *agg, self._ha("ha-a"))
        self.db_eps = [_listen(self.ops[f"dbnode{i}"], "dbnode")
                       for i in (1, 2)]
        return f"dbnodes on {self.db_eps}"

    def placement(self):
        st = RemoteStore(self.kv_ep)
        try:
            PlacementService(st, "_placement").init(
                [Instance("dbnode-1", self.db_eps[0]),
                 Instance("dbnode-2", self.db_eps[1])],
                num_shards=16, replica_factor=1)
        finally:
            st.close()

    def coordinator(self):
        # Step 9's HA follower starts here, the leader having campaigned
        # since step 2.
        self.start(("coord", "coordinator", {
            "namespace": "default", "kv_endpoint": self.kv_ep,
            "carbon_listen_address": "127.0.0.1:0"}), self._ha("ha-b"))
        op = self.ops["coord"]
        self.coord = _listen(op, "coordinator")
        self.carbon = _listen(op, "carbon")
        _http(self.coord + "/health")
        return f"coordinator {self.coord}, carbon {self.carbon}"

    def scatter_gather(self):
        self.now = now = int(time.time())
        for h in "abcdef":
            for i in range(5):
                _http(self.coord + "/api/v1/json/write", json.dumps({
                    "tags": {"__name__": "smoke_metric", "host": h},
                    "timestamp": now - 40 + i * 10,
                    "value": 10 + i}).encode())

        def q(path, **params):
            return _http(f"{self.coord}/api/v1/{path}?"
                         + urllib.parse.urlencode(params))

        out = q("query_range", query="smoke_metric", start=now - 60,
                end=now, step=10)
        series = out["data"]["result"]
        if out["status"] != "success" or len(series) != 6:
            raise AssertionError(f"scatter-gather: {out}")
        for s in series:
            vals = [float(v) for _, v in s["values"]]
            if vals[-1] != 14.0:
                raise AssertionError(f"scatter-gather: {s['metric']} {vals}")
        out = q("query_range", query="sum(rate(smoke_metric[30s]))",
                start=now - 30, end=now, step=10)
        if out["status"] != "success":
            raise AssertionError(f"scatter-gather: rate {out}")
        out = q("query_range",
                query=f"max_over_time(smoke_metric[30s:10s] @ {now})",
                start=now - 30, end=now, step=10)
        series = out["data"]["result"]
        if out["status"] != "success" or len(series) != 6:
            raise AssertionError(f"scatter-gather: subquery {out}")
        for s in series:
            vals = {float(v) for _, v in s["values"]}
            # @-pinned: one value at every step (the 10 s-aligned
            # evaluation times may cut the last sample: 13 or 14).
            if len(vals) != 1 or not vals <= {13.0, 14.0}:
                raise AssertionError(f"scatter-gather: subquery "
                                     f"{s['metric']} {vals}")
        out = q("query", query="scalar(sum(smoke_metric))", time=now)
        if out["data"]["resultType"] != "scalar" or \
                out["data"]["result"][1] != "84":
            raise AssertionError(f"scatter-gather: scalar {out}")
        return ("6 series across 2 dbnodes, rate, a subquery over an "
                "@-pinned selector, scalar 84")

    def agg_placement(self):
        agg_a = _listen(self.ops["agga"], "aggregator")
        agg_b = _listen(self.ops["aggb"], "aggregator")
        st = RemoteStore(self.kv_ep)
        try:
            svc = PlacementService(st, "_placement/agg")
            svc.init([Instance("agg-a", agg_a)], num_shards=8,
                     replica_factor=1)
            await_line(self.ops["agga"],
                        r"placement update: owned=\[0, 1, 2, 3, 4, 5, 6, 7\]",
                        "agg-a owning all 8 shards")
            svc.add_instance(Instance("agg-b", agg_b))
            line = await_line(self.ops["aggb"],
                               r"placement update: owned=\[[0-7]",
                               "agg-b picking up shards")
        finally:
            st.close()
        return f"agg-a owned all 8 shards; agg-b {line.strip()}"

    def prometheus(self):
        now = self.now
        body = promremote.snappy_compress(promremote.encode_write_request([
            ({b"__name__": b"prom_remote_metric", b"job": b"smoke"},
             [((now - 20 + i * 10) * 1000, 5.0 + i) for i in range(3)])]))
        out = _http(self.coord + "/api/v1/prom/remote/write", body,
                    {"Content-Encoding": "snappy",
                     "Content-Type": "application/x-protobuf"})
        if out["wrote"] != 3:
            raise AssertionError(f"prometheus: {out}")
        out = _http(f"{self.coord}/api/v1/query_range?query="
                    f"prom_remote_metric&start={now - 30}&end={now}&step=10")
        vals = [float(v) for _, v in out["data"]["result"][0]["values"]]
        if vals[-1] != 7.0:
            raise AssertionError(f"prometheus: {vals}")
        return "3 samples written, read back"

    def carbon_lines(self):
        now = self.now
        host, _, port = self.carbon.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=5) as s:
            for i in range(3):
                s.sendall(b"smoke.carbon.count %d %d\n"
                          % (100 + i, now - 20 + i * 10))
        got = {}

        def rendered():
            out = _http(f"{self.coord}/api/v1/graphite/render?target="
                        f"smoke.carbon.count&from={now - 30}&until={now}"
                        f"&step=10")
            got["out"] = out
            got["vals"] = [v for v, _ in out[0]["datapoints"]
                           if v is not None] if out else []
            # The lines ingest asynchronously: wait for all three.
            return len(got["vals"]) == 3

        await_cond(rendered, "three carbon points", timeout=30)
        if got["vals"][-1] != 102.0 or \
                got["out"][0]["target"] != "smoke.carbon.count":
            raise AssertionError(f"carbon: {got['out']}")
        return "3 lines rendered back"

    def _ha_log(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.flush.log")

    def _ha(self, name: str):
        """(name, service, config) of one of step 9's HA pair."""
        return (name, "aggregator", {
            "instance_id": name, "listen_address": "127.0.0.1:0",
            "num_shards": 8, "kv_endpoint": self.kv_ep,
            "election_id": "agg-ha", "election_ttl": "3s",
            "flush_interval": "1s", "flush_log": self._ha_log(name)})

    def failover(self):
        logs = {a: self._ha_log(a) for a in ("ha-a", "ha-b")}
        now = time.time_ns()
        first = now // (10 * S) * (10 * S) - 20 * S
        entries = [{"t": "timed", "mtype": int(MetricType.COUNTER),
                    "id": b"ha.count", "time": first + i * 10 * S + 5 * S,
                    "value": float(100 + i), "policy": "10s:2d"}
                   for i in range(5)]
        for name in ("ha-a", "ha-b"):
            host, _, port = _listen(self.ops[name],
                                    "aggregator").rpartition(":")
            with socket.create_connection((host, int(port)), timeout=5) as s:
                wire.write_frame(s, {"t": "batch", "entries": entries})

        def nonempty(name):
            return os.path.exists(logs[name]) and \
                os.path.getsize(logs[name]) > 0

        leader = []

        def flushed():
            leader[:] = [n for n in ("ha-a", "ha-b") if nonempty(n)]
            return bool(leader)

        await_cond(flushed, "the HA leader's first flush", timeout=60)
        leader = leader[0]
        # The flush loop writes its log line, then commits the flush
        # times to KV: a kill right on the line could land in between.
        time.sleep(1)
        with open(logs[leader], "rb") as f:
            before = len(f.read().splitlines())
        self.ops[leader]._proc.kill()
        self.ops[leader]._proc.wait(timeout=30)
        self.killed.add(leader)

        def lines():
            out = []
            for name, path in logs.items():
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        out += [(name, ln) for ln in f.read().splitlines()]
            return out

        await_cond(lambda: len(lines()) >= 5, "5 flushed windows", timeout=60)
        windows = {}
        for who, line in lines():
            mid, t, v, _pol = line.split(b"\t")
            if mid != b"ha.count":
                raise AssertionError(f"failover: {line!r}")
            windows.setdefault(int(t), []).append((who, float(v)))
        ends = sorted(windows)
        dupes = {t: w for t, w in windows.items() if len(w) > 1}
        if dupes:
            raise AssertionError(f"failover: double-flushed windows {dupes}")
        if ends != [ends[0] + i * 10 * S for i in range(len(ends))]:
            raise AssertionError(f"failover: lost windows "
                                 f"{[e // S for e in ends]}")
        if len(ends) != 5:
            raise AssertionError(f"failover: {len(ends)} windows, not 5")
        who = {w for t in windows for (w, _) in windows[t]}
        if who != {"ha-a", "ha-b"}:
            raise AssertionError(f"failover: not exercised, only {who}")
        vals = [windows[t][0][1] for t in ends]
        if vals != [100.0, 101.0, 102.0, 103.0, 104.0]:
            raise AssertionError(f"failover: values {vals}")
        by_a = sum(1 for t in ends if windows[t][0][0] == "ha-a")
        return (f"leader {leader} SIGKILLed after {before} window(s); 5 "
                f"windows flushed exactly once ({by_a} by ha-a, "
                f"{5 - by_a} by ha-b)")


STEPS = (("kv", Smoke.kv), ("dbnodes", Smoke.dbnodes),
         ("placement", Smoke.placement), ("coordinator", Smoke.coordinator),
         ("scatter-gather", Smoke.scatter_gather),
         ("agg placement", Smoke.agg_placement),
         ("prometheus", Smoke.prometheus), ("carbon", Smoke.carbon_lines),
         ("failover", Smoke.failover))


def run(device=None, log=print) -> dict:
    dev = resolve(device)
    t0 = time.monotonic()
    smoke = Smoke(dev, log)
    try:
        for n, (name, fn) in enumerate(STEPS, 1):
            smoke.step(n, name, lambda: fn(smoke))
    finally:
        launches = smoke.close()
    missing = launches.pop("missing")
    if missing:
        raise AssertionError(f"children printed no kernel launches as they "
                             f"stopped: {missing}")
    return {"steps": smoke.verdicts, "launches": launches, "device": str(dev),
            "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.device, log=lambda s: print(s, flush=True))
    print(f"SMOKE PASS: {len(out['steps'])} steps in {out['seconds']:.0f}s "
          f"on {out['device']}")
    print(f"integration_smoke kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
