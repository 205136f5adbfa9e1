"""The drills (port of m3_tpu/testing/scenario.py): SLO-under-churn, the
kill -9 restart, the disk-fault and the compute-fault churn drills, each a
seeded composition of the in-process cluster (testing/cluster.py), the
open-loop load generator (testing/loadgen.py) and the fault planes
(faultnet, faultfs, faultcomp), held to hard SLOs by its own `verify()`.

  ChurnScenario            an RF=3 cluster, every node behind a seeded
                           faultnet proxy, under seeded OPEN-LOOP load
                           (bulk/normal writes, reads, critical health
                           and replication probes) while a seeded churn
                           driver runs add/remove/replace and repair
                           CONCURRENTLY; then quiesce and assert zero lost
                           acked writes, zero shed CRITICAL, bounded p99
                           and queues, AVAILABLE placement and
                           replica-consistent checksums.
  KillRestartScenario      a REAL `python -m m3_tpu_torch.services dbnode`
                           child under load, SIGKILLed at a seeded moment,
                           restarted over the same data dir with a torn
                           WAL tail and a checkpoint-less fileset injected:
                           every acked write served, nothing fabricated,
                           the restart within its budget.
  DiskFaultScenario        one node's disk under seeded bit rot, then a
                           scrub with peer repair, then a full disk (the
                           read-only posture and its recovery).
  ComputeFaultChurnScenario ChurnScenario with seeded device faults on the
                           guarded dispatch seam.

Every drill runs on a device: `device` in its options (None: the CUDA
card, raising before any server, proxy or child process starts when there
is none). The kill drill's child gets `--device` when one is given.

Determinism: the load schedule, the fault schedules and the churn op
sequence are pure functions of `seed` (the reference draws the same ones);
wall-clock timing is not, which is why the assertions are SLO-shaped
(bounds and zero counts), not traces.

Why writes that land during churn still converge: peer streaming is
block-granular (sealed blocks move; mutable buffers do not), so a freshly
bootstrapped owner can lack buffer-resident points until the final seal
and repair sweep union them back; the convergence phase is exactly that
pipeline. Until then a point acked at MAJORITY may have two holders only,
so a shard's source (an add's donor, a removed node) hands its unsealed
points to the receiver as its bootstrap ends, as a graceful leave does:
otherwise a remove and a replace of those two holders would lose it. A
replaced node is down and hands off nothing.

The port never falls back (parallel/guard.py): where the reference's
compute-fault drill asserts that device faults vanish into fallback twins,
the port's asserts that each guarded dispatch under the plan ends as its
own seeded decisions say (`faultcomp.unexplained`) and that the serving
contract holds: no acked write lost, no critical probe shed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..client.session import Session, SessionOptions
from ..cluster.placement import Instance, ShardState, initial_placement
from ..cluster.topology import StaticTopology, required_reads
from ..device import resolve
from ..ops import kernel_launches
from ..parallel.guard import ComputeError
from ..persist import fs as pfs
from ..storage.bootstrap import BootstrapContext, BootstrapProcess
from ..storage.buffer import dedup_sorted
from ..storage.database import warm_up
from ..storage.repair import DatabaseRepairer, RepairOptions, ShardRepairer
from ..storage.retriever import BlockRetriever
from ..storage.scrub import DatabaseScrubber, ScrubOptions, ScrubStats
from ..utils import tracing, xtime
from ..utils.health import Priority
from ..utils.limits import Backpressure
from ..utils.retry import RetryOptions
from . import faultfs
from .cluster import ClusterHarness, ClusterNode
from .faultnet import FaultPlan
from .loadgen import LoadGen, LoadReport, LoadSchedule, Phase

__all__ = ["ChurnScenarioOptions", "ChurnScenario", "ScenarioResult",
           "OpStep", "ReadCall", "ReadTrace",
           "WriteLedger", "KillRestartOptions", "KillRestartScenario",
           "KillRestartResult", "DiskFaultScenarioOptions",
           "DiskFaultScenario", "DiskFaultResult",
           "ComputeFaultChurnOptions", "ComputeFaultChurnScenario",
           "drill_config"]

# The root of the checkout: the kill drill's child runs from here, so `-m`
# finds this package whatever the caller's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Outcome type names that mean "the server deliberately shed this"
# (Backpressure subclasses ResourceExhausted and rides the wire as the
# typed resource_exhausted frame).
SHED_OUTCOMES = frozenset({"ResourceExhausted", "Backpressure"})


class WriteLedger:
    """Thread-safe record of every ACKED write: the ground truth the
    post-scenario verification replays against quorum reads. Timestamps
    are allocated from one atomic sequence (microsecond steps), so every
    (series, timestamp) pair is unique and carries a unique value —
    verification is exact, no last-wins ambiguity."""

    def __init__(self, base_t_ns: int):
        self.base_t_ns = base_t_ns
        self._lock = threading.Lock()
        self._seq = 0
        self._acked: Dict[bytes, List[Tuple[int, float]]] = {}

    def next_write(self, sid: bytes) -> Tuple[int, float]:
        """Allocate (t_ns, value) for an attempt on `sid` (not yet
        acked)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return self.base_t_ns + seq * xtime.Unit.MICROSECOND.nanos, float(seq)

    def ack(self, sid: bytes, t_ns: int, value: float):
        with self._lock:
            self._acked.setdefault(sid, []).append((t_ns, value))

    def acked(self) -> Dict[bytes, List[Tuple[int, float]]]:
        with self._lock:
            return {sid: list(points) for sid, points in self._acked.items()}

    def total_acked(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._acked.values())


@dataclasses.dataclass(frozen=True)
class OpStep:
    """One timed step of a churn op (ChurnScenario.op_steps), on the
    monotonic clock."""

    op: str
    step: str
    start: float
    seconds: float


@dataclasses.dataclass
class ReadCall:
    """One replica call of a traced read, on the monotonic clock: the host
    pool's free slots at its start; the server's handler seconds (the span
    its reply carries; None when the reply carried none), and inside the
    handler the storage read's wall and thread-CPU seconds (the node's
    `rpc_fetch`, `_trace_fetch`)."""

    endpoint: str
    start: float
    end: float
    free_slots: int
    handler_s: Optional[float] = None
    read_s: Optional[float] = None
    read_cpu_s: Optional[float] = None


@dataclasses.dataclass
class ReadTrace:
    """One read of the churn window (ChurnScenario.read_traces), on the
    monotonic clock: when its fetch started and ended, its replica calls,
    and `required`, the read consistency's replica count."""

    start: float
    end: float
    required: int
    calls: List[ReadCall]
    outcome: str

    def waits(self) -> Dict[str, float]:
        """Where the read's seconds went: the fanout pool before the first
        replica call; in the quorum-completing call, the storage read's
        thread-CPU seconds, the rest of the storage read (its thread not
        running: the interpreter, a lock or the device), the rest of the
        handler (the gate, the limits scope, the reply's encode), and the
        rest of the call (the host pool, the socket, the chaos proxy, the
        handler thread's start); the wake-up after the quorum."""
        total = self.end - self.start
        done = sorted(self.calls, key=lambda c: c.end)
        if not done:
            return {"no replica call": total}
        crit = done[min(self.required, len(done)) - 1]
        first = min(c.start for c in self.calls)
        handler = crit.handler_s or 0.0
        read = min(crit.read_s or 0.0, handler)
        cpu = min(crit.read_cpu_s or 0.0, read)
        return {"fanout pool": max(0.0, first - self.start),
                "read cpu": cpu,
                "read not running": read - cpu,
                "handler rest": handler - read,
                "host pool, socket, proxy": max(
                    0.0, crit.end - crit.start - handler),
                "after quorum": max(0.0, self.end - crit.end)}


class _ReadTraceSession(Session):
    """The churn window's serving session: each replica call of a fetch
    records a ReadCall (the server's times ride the span its reply
    carries) under the fetch's span, kept beside the span and not in it
    (the process's recent-trace ring renders spans as JSON), for
    ChurnScenario.read_traces."""

    def __init__(self, *args, **kwargs):
        self.calls_by_span: Dict[int, List[ReadCall]] = {}
        self._calls_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def _traced_call(self, span, client, method: str, **kwargs):
        call = ReadCall(client.endpoint, time.monotonic(), 0.0,
                        client._sema._value)
        try:
            return super()._traced_call(span, client, method, **kwargs)
        finally:
            call.end = time.monotonic()
            if isinstance(span, tracing.Span):
                mine = [c for c in list(span.children)
                        if isinstance(c, dict) and c.get("tags", {}).get(
                            "endpoint") == client.endpoint]
                if mine:
                    t = mine[-1]["tags"]
                    call.handler_s = mine[-1]["duration_us"] / 1e6
                    call.read_s = t.get("read_s")
                    call.read_cpu_s = t.get("read_cpu_s")
                # A replica that answers after its read's quorum finds the
                # fetch's span finished, and its read already popped.
                with self._calls_lock:
                    if span.end_ns is None:
                        self.calls_by_span.setdefault(id(span),
                                                      []).append(call)

    def pop_calls(self, span) -> List[ReadCall]:
        """The replica calls of a finished fetch span."""
        with self._calls_lock:
            return self.calls_by_span.pop(id(span), [])


def _trace_fetch(node: ClusterNode) -> None:
    """Time the storage read of each `fetch` a node serves, wall and
    thread CPU, onto the request's server span (its reply carries both
    back to the _ReadTraceSession)."""
    svc = node.server.service
    real = svc.rpc_fetch

    def rpc_fetch(*args, **kwargs):
        w0, c0 = time.monotonic(), time.thread_time()
        try:
            return real(*args, **kwargs)
        finally:
            sp = tracing.TRACER.current()
            if sp is not None:
                sp.set_tag("read_s", time.monotonic() - w0)
                sp.set_tag("read_cpu_s", time.thread_time() - c0)

    svc.rpc_fetch = rpc_fetch


class _StepSession(Session):
    """The churn driver's session: its peer-streaming calls are timed as
    steps of the op in hand (`record(step)` is a context manager)."""

    def __init__(self, topology, opts, record, *, device=None):
        super().__init__(topology, opts, device=device)
        self._record = record

    def fetch_block_tiles_from_peers(self, *args, **kwargs):
        with self._record("peer stream"):
            return super().fetch_block_tiles_from_peers(*args, **kwargs)

    def fetch_block_metadata_tiles_from_peers(self, *args, **kwargs):
        with self._record("peer metadata"):
            return super().fetch_block_metadata_tiles_from_peers(
                *args, **kwargs)

    def fetch_block_tiles(self, *args, **kwargs):
        with self._record("peer tiles"):
            return super().fetch_block_tiles(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class ChurnScenarioOptions:
    seed: int = 7
    n_nodes: int = 4              # RF + 1 so remove-node stays replica-safe
    replica_factor: int = 3
    num_shards: int = 16
    n_series: int = 48            # write/read id pool
    # Open-loop offered load (requests/sec) and phase plan.
    base_rate: float = 60.0
    duration_s: float = 4.0
    time_scale: float = 1.0
    # Relative kind weights: bulk writes shed first under pressure,
    # critical is health + peer-metadata probes (never shed).
    write_weight: float = 5.0
    bulk_weight: float = 2.0
    read_weight: float = 4.0
    critical_weight: float = 2.0
    # Seeded chaos plan applied to every node's proxy during the run.
    fault_reset: float = 0.01
    fault_truncate: float = 0.01
    fault_delay: float = 0.03
    fault_delay_s: float = 0.03
    fault_duplicate: float = 0.01
    # Churn ops executed concurrently with the load, in seeded order.
    churn_ops: Tuple[str, ...] = ("add", "repair", "remove", "replace")
    churn_spacing_s: float = 0.35
    # SLO bounds asserted by verify().
    p99_write_s: float = 2.0
    p99_read_s: float = 2.0
    min_ok_rate: float = 0.5      # at least half the offered load served
    session_timeout_s: float = 5.0
    # In-flight bound slack for CRITICAL traffic, which the gate admits
    # past capacity by design (never shed): the asserted memory bound is
    # gate capacity + this allowance.
    gate_critical_allowance: int = 64
    # First launches of the kernels churn touches (the extension's load,
    # the card's lazy module loads) before the SLO'd window opens, so the
    # window's p99 measures serving, not start-up (a real deployment
    # warms its kernels the same way).
    warm_kernels: bool = True
    # Record where each read of the window waited (read_traces): the
    # serving session files each replica call and every node times its
    # storage reads. Off by default, so that the SLO'd window pays none
    # of it; chip_smoke.py --churn-witness turns it on.
    trace_reads: bool = False
    device: Optional[str] = None  # None: the CUDA card


@dataclasses.dataclass
class ScenarioResult:
    report: LoadReport
    ledger: WriteLedger
    churn_log: List[str]
    max_gate_depth: int
    gate_capacity: int
    max_queue_pending: int
    queue_capacity: int
    repair_stats: List[dict]
    verified_points: int = 0
    checksum_blocks_checked: int = 0

    def outcome_counts(self, kind: Optional[str] = None) -> Dict[str, int]:
        return self.report.outcomes(kind=kind)


class ChurnScenario:
    """One seeded SLO-under-churn run over an in-process cluster on
    `opts.device`."""

    NS = b"default"

    def __init__(self, opts: ChurnScenarioOptions = ChurnScenarioOptions()):
        self.opts = opts
        self.device = resolve(opts.device)
        self.plan = FaultPlan(
            seed=opts.seed,
            reset=opts.fault_reset, truncate=opts.fault_truncate,
            delay=opts.fault_delay, delay_s=opts.fault_delay_s,
            duplicate=opts.fault_duplicate)
        # Proxies are in place from the start (the placement advertises
        # their endpoints) but stay benign through setup — the chaos
        # plan arms when the SLO'd load window opens.
        self.cluster = ClusterHarness(
            n_nodes=opts.n_nodes, replica_factor=opts.replica_factor,
            num_shards=opts.num_shards, fault_plan=FaultPlan(),
            device=self.device)
        self.ids = [b"churn-%04d" % i for i in range(opts.n_series)]
        if opts.trace_reads:
            for node in self.cluster.nodes.values():
                _trace_fetch(node)
        self.ledger = WriteLedger(self.cluster.clock.now_ns)
        self.churn_log: List[str] = []
        self._churn_errors: List[str] = []
        self._rng = random.Random(f"churn-scenario/{opts.seed}")
        self._op_counter = 0
        self._stop = threading.Event()
        self._max_queue_pending = 0
        self._repair_stats: List[dict] = []
        # The launches of _warm_kernels, start-up work (_warm).
        self.warm_launches: Dict[str, int] = {}
        # Nodes removed from the placement, kept until the receivers of
        # their shards have taken their unsealed points (_hand_off).
        self._departed: Dict[str, ClusterNode] = {}
        # Serving session rides the chaos proxies; retries kept tight so
        # open-loop threads do not pile up behind long backoffs.
        # Each churn op's steps and, under `trace_reads`, each served
        # read's replica calls, on the monotonic clock: which reads an
        # op's step held, and where they waited (chip_smoke.py
        # --churn-witness prints both).
        self.op_steps: List[OpStep] = []
        self.read_traces: List[ReadTrace] = []
        # The op in hand, per thread: the churn thread's ops, then the
        # main thread's convergence repairs.
        self._op = threading.local()
        serving = _ReadTraceSession if opts.trace_reads else Session
        self.session = serving(
            self.cluster.topology,
            SessionOptions(timeout_s=opts.session_timeout_s,
                           retry=RetryOptions(max_attempts=2,
                                              initial_backoff_s=0.02),
                           # Open-loop fanout must not queue client-side
                           # behind chaos-slowed calls: size the pool for
                           # offered concurrency (rate x timeout x RF).
                           fanout_workers=128,
                           pool_size=16),
            device=self.device)
        # The churn driver gets its own session: bootstrap/repair streams
        # must not contend with the serving pool's sockets.
        self.admin_session = _StepSession(
            self.cluster.topology,
            SessionOptions(timeout_s=max(10.0, opts.session_timeout_s)),
            self._step, device=self.device)

    @contextlib.contextmanager
    def _step(self, step: str):
        """Time one step of the churn op in hand into `op_steps`."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.op_steps.append(OpStep(getattr(self._op, "name", ""), step,
                                        t0, time.monotonic() - t0))

    # ------------------------------------------------------------------ load

    def _schedule(self) -> LoadSchedule:
        o = self.opts
        return LoadSchedule(
            seed=o.seed, base_rate=o.base_rate,
            phases=(Phase("churn", o.duration_s, 1.0),),
            kinds=(("write", o.write_weight), ("write_bulk", o.bulk_weight),
                   ("read", o.read_weight), ("critical", o.critical_weight)))

    def _fire(self, kind: str):
        rng = random.Random()  # content only; schedule is already seeded
        sid = self.ids[rng.randrange(len(self.ids))]
        if kind in ("write", "write_bulk"):
            t_ns, value = self.ledger.next_write(sid)
            self.session.write(
                self.NS, sid, t_ns, value,
                priority="bulk" if kind == "write_bulk" else None)
            # Only reached on quorum ack — the ledger records EXACTLY the
            # writes the cluster owes the verifier.
            self.ledger.ack(sid, t_ns, value)
        elif kind == "read":
            if self.opts.trace_reads:
                self._traced_read(sid)
            else:
                self.session.fetch(self.NS, sid, 0,
                                   self.cluster.clock.now_ns + xtime.HOUR)
        else:  # critical: health + replication-plane metadata probe
            m = self.cluster.topology.get()
            hosts = list(m.hosts.values())
            h = hosts[rng.randrange(len(hosts))]
            client = self.session._client(h)
            if rng.random() < 0.5:
                client.call("health")
            else:
                client.call("fetch_blocks_metadata", ns=self.NS,
                            shard=rng.randrange(self.opts.num_shards),
                            start_ns=0,
                            end_ns=self.cluster.clock.now_ns + xtime.HOUR,
                            page_token=0)

    def _traced_read(self, sid: bytes) -> None:
        """One read of the window, its ReadTrace kept in `read_traces`."""
        m = self.cluster.topology.get()
        required = min(required_reads(
            self.session.opts.read_consistency, m.replica_factor),
            m.replica_factor)
        outcome = "ok"
        t0 = time.monotonic()
        with tracing.span("churn.read") as sp:
            try:
                self.session.fetch(self.NS, sid, 0,
                                   self.cluster.clock.now_ns + xtime.HOUR)
            except Exception as e:
                outcome = type(e).__name__
                raise
            finally:
                fetch = [c for c in getattr(sp, "children", ())
                         if getattr(c, "name", "") == "client.fetch"]
                calls = self.session.pop_calls(fetch[0]) if fetch else []
                self.read_traces.append(ReadTrace(
                    t0, time.monotonic(), required, calls, outcome))

    # ----------------------------------------------------------------- churn

    def _bootstrap_initializing(self, host_id: str):
        """Peer-bootstrap every INITIALIZING shard of one instance, then
        cut it over (MarkShardAvailable semantics) — the add/remove/
        replace data plane, through the chaos proxies."""
        p = self.cluster.placement_svc.get()
        inst = p.instances.get(host_id)
        if inst is None:
            return
        init_shards = [a.shard for a in inst.shards.values()
                       if a.state == ShardState.INITIALIZING]
        if not init_shards:
            return
        node = self.cluster.nodes[host_id]
        proc = BootstrapProcess(
            chain=("peers", "uninitialized_topology"),
            ctx=BootstrapContext(session=self.admin_session, host_id=host_id,
                                 placement=p, peer_deadline_s=30.0))
        with self._step("bootstrap"):
            proc.run(node.db, shard_ids=init_shards)
        with self._step("hand-off"):
            self._hand_off(node, [a for a in inst.shards.values()
                                  if a.state == ShardState.INITIALIZING])
        with self._step("mark available"):
            self.cluster.placement_svc.mark_instance_available(host_id)

    def _hand_off(self, node: ClusterNode, assignments) -> None:
        """Move each receiving shard's unsealed points from its source to
        `node`, as a graceful leave streams them. Peers stream sealed
        blocks only, so a point in the source's buffer would otherwise
        have one holder fewer until the final seal and repair: a MAJORITY
        ack held by a removed node and a replaced one would be gone. The
        source is the donor of an add or a node that left by `remove`; a
        replaced node is down and hands off nothing."""
        now = self.cluster.clock.now_ns
        for a in assignments:
            src = self.cluster.nodes.get(a.source_id) \
                or self._departed.get(a.source_id)
            if src is None or src is node:
                continue
            for name, ns in src.db.namespaces.items():
                ids, ts, vals = _unsealed_points(ns.shards[a.shard])
                if ids:
                    node.db.namespaces[name].shards[a.shard].write_batch(
                        ids, ts, vals, now)

    def _run_repair(self, host_id: str):
        node = self.cluster.nodes.get(host_id)
        if node is None:
            return
        rep = DatabaseRepairer(
            node.db, self.admin_session, host_id=host_id,
            opts=RepairOptions(throttle_s=0.002, seed=self.opts.seed,
                               deadline_s=30.0))
        stats = rep.run()
        for name, s in stats.items():
            self._repair_stats.append(
                {"host": host_id, "ns": name, **dataclasses.asdict(s)})

    def _churn_op(self, op: str):
        c = self.cluster
        self._op.name = op
        if op == "add":
            self._op_counter += 1
            self._op.name = f"add joiner{self._op_counter}"
            with self._step("new node"):
                node = c.add_node(f"joiner{self._op_counter}")
            if self.opts.trace_reads:
                _trace_fetch(node)
            self.churn_log.append(f"add {node.host_id}")
            self._bootstrap_initializing(node.host_id)
        elif op == "remove":
            # Only safe with > RF nodes; receivers of the leaver's shards
            # peer-bootstrap them before cutover.
            if len(c.nodes) <= self.opts.replica_factor:
                self.churn_log.append("remove skipped (at RF)")
                return
            victim = self._rng.choice(sorted(c.nodes))
            leaver = c.nodes[victim]
            self._op.name = f"remove {victim}"
            try:
                with self._step("placement"):
                    c.remove_node(victim)
            except ValueError as e:
                # Replica-safety refusal (pending moves unsettled): a
                # legitimate outcome under concurrent churn.
                self.churn_log.append(f"remove {victim} refused: {e}")
                return
            # Stopped: it takes no more writes, and its buffers are final.
            self._departed[victim] = leaver
            self.churn_log.append(f"remove {victim}")
            p = c.placement_svc.get()
            for host_id, inst in sorted(p.instances.items()):
                if any(a.state == ShardState.INITIALIZING
                       for a in inst.shards.values()):
                    self._bootstrap_initializing(host_id)
        elif op == "replace":
            victim = self._rng.choice(sorted(c.nodes))
            self._op.name = f"replace {victim}"
            with self._step("new node"):
                node = c.replace_node(victim)
            if self.opts.trace_reads:
                _trace_fetch(node)
            self.churn_log.append(f"replace {victim} -> {node.host_id}")
            self._bootstrap_initializing(node.host_id)
        elif op == "repair":
            host_id = self._rng.choice(sorted(c.nodes))
            self.churn_log.append(f"repair {host_id}")
            self._op.name = f"repair {host_id}"
            with self._step("repair"):
                self._run_repair(host_id)
        else:
            raise ValueError(f"unknown churn op {op!r}")

    def _churn_loop(self):
        for op in self.opts.churn_ops:
            if self._stop.is_set():
                return
            try:
                self._churn_op(op)
            except Exception as e:  # noqa: BLE001 — surfaced by verify()
                self._churn_errors.append(f"{op}: {type(e).__name__}: {e}")
            self._sample_queues()
            if self._stop.wait(self.opts.churn_spacing_s):
                return

    def _sample_queues(self):
        pending = 0
        for node in list(self.cluster.nodes.values()):
            for ns in node.db.namespaces.values():
                for sh in ns.shards.values():
                    pending = max(pending, sh.insert_queue.pending())
        self._max_queue_pending = max(self._max_queue_pending, pending)

    # ------------------------------------------------------------------- run

    def _warm_kernels(self):
        """The first launches of the kernels the churn ops hit (K1, K2,
        K3: storage.database.warm_up) BEFORE the SLO'd window opens: a
        first launch mid-run (the extension's load, the card's lazy
        module load) would queue every concurrent read behind it, so the
        measured p99 would be start-up, not serving."""
        self.warm_launches = _warm(self.device, self.cluster.ns_opts)

    def _seed_and_seal(self):
        """Pre-churn seed: every pool series gets sealed-block history so
        peer bootstrap has blocks to stream from the first churn op."""
        now = self.cluster.clock.now_ns
        ts = [now - (i + 1) * xtime.SECOND for i in range(4)]
        for j, sid in enumerate(self.ids):
            self.session.write_batch(
                self.NS, [sid] * len(ts), ts,
                np.arange(len(ts), dtype=np.float64) + 1000.0 * j)
        self.cluster.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
        self.cluster.tick_all()
        # Ledger timestamps start AFTER the seal: the mutable-buffer
        # acceptance window follows the (static-during-load) clock.
        self.ledger.base_t_ns = self.cluster.clock.now_ns

    def _window_open(self):
        self.cluster.set_fault_plan(self.plan)  # chaos on: SLO window opens

    def _window_close(self):
        self.cluster.set_fault_plan(FaultPlan())  # benign: chaos off

    def run(self) -> ScenarioResult:
        o = self.opts
        if o.warm_kernels:
            self._warm_kernels()
        self._seed_and_seal()
        self._window_open()
        churn = threading.Thread(target=self._churn_loop, name="churn-driver",
                                 daemon=True)
        churn.start()
        gen = LoadGen(self._schedule(), time_scale=o.time_scale)
        report = gen.run(self._fire, join_timeout_s=max(30.0, 10 * o.duration_s))
        # The op list is finite: let churn complete even when the load
        # window closed first (convergence is verified after BOTH end;
        # _stop stays an abort/close signal only).
        churn.join(timeout=120)

        # ---------------- convergence: quiesce -> seal -> repair -> verify
        self._window_close()
        self._op.name = "converge"
        self.cluster.clock.advance(4 * xtime.HOUR + 11 * xtime.MINUTE)
        self.cluster.tick_all()
        for host_id in sorted(self.cluster.nodes):
            self._run_repair(host_id)

        gate_depth = 0
        gate_cap = 0
        for node in self.cluster.nodes.values():
            g = node.server.service.gate
            gate_depth = max(gate_depth, g.max_depth())
            gate_cap = max(gate_cap, g.capacity)
        queue_cap = self.cluster.ns_opts.insert_max_pending
        return ScenarioResult(
            report=report, ledger=self.ledger, churn_log=self.churn_log,
            max_gate_depth=gate_depth, gate_capacity=gate_cap,
            max_queue_pending=self._max_queue_pending,
            queue_capacity=queue_cap, repair_stats=self._repair_stats)

    # ---------------------------------------------------------------- verify

    def _ok_floor(self) -> float:
        return self.opts.min_ok_rate

    def verify(self, result: ScenarioResult) -> ScenarioResult:
        """Assert every SLO; raises AssertionError naming the violated
        guarantee. Returns the result with verification counters filled."""
        o = self.opts
        rep = result.report

        assert not self._churn_errors, \
            f"churn driver errors: {self._churn_errors}"

        # 1. zero shed CRITICAL traffic.
        crit = rep.outcomes(kind="critical")
        shed = {k: n for k, n in crit.items() if k in SHED_OUTCOMES}
        assert not shed, f"CRITICAL traffic shed under churn: {shed}"

        # 2. bounded p99 for served traffic + a served-rate floor.
        p99_w = rep.quantile_latency(0.99, kind="write")
        p99_r = rep.quantile_latency(0.99, kind="read")
        assert p99_w <= o.p99_write_s, \
            f"write p99 {p99_w:.3f}s > bound {o.p99_write_s}s"
        assert p99_r <= o.p99_read_s, \
            f"read p99 {p99_r:.3f}s > bound {o.p99_read_s}s"
        total = len(rep.records)
        ok = len(rep.select(outcome="ok"))
        floor = self._ok_floor()
        assert total > 0 and ok / total >= floor, \
            f"served {ok}/{total} below floor {floor}"

        # 3. bounded in-flight work and queue depths. The gate enforces
        # capacity for NORMAL/BULK but admits CRITICAL unconditionally
        # (by design — shedding replication converts overload into
        # under-replication), so the memory bound is capacity plus a
        # critical-overshoot allowance.
        bound = result.gate_capacity + o.gate_critical_allowance
        assert result.max_gate_depth <= bound, \
            (f"RPC gate depth {result.max_gate_depth} exceeded capacity "
             f"{result.gate_capacity} + critical allowance "
             f"{o.gate_critical_allowance}")
        assert result.max_queue_pending <= result.queue_capacity, \
            (f"insert queue pending {result.max_queue_pending} exceeded "
             f"bound {result.queue_capacity}")

        # 4. clean placement convergence: every shard AVAILABLE.
        p = self.cluster.placement_svc.get()
        p.validate()
        unsettled = [
            (iid, a.shard, a.state.value)
            for iid, inst in p.instances.items()
            for a in inst.shards.values() if a.state != ShardState.AVAILABLE]
        assert not unsettled, f"placement not converged: {unsettled}"

        # 5. zero lost acked writes: every quorum-acked point readable.
        verified = 0
        now = self.cluster.clock.now_ns
        for sid, points in sorted(result.ledger.acked().items()):
            t, v = self.session.fetch(self.NS, sid, 0, now + 1)
            got = dict(zip(t.tolist(), v.tolist()))
            for t_ns, value in points:
                assert got.get(t_ns) == value, \
                    (f"ACKED write lost: {sid!r} t={t_ns} v={value} "
                     f"(fetched {len(got)} points)")
                verified += 1
        result.verified_points = verified

        # 6. replica-consistent convergence: per-row checksums agree
        # across every readable owner of every shard.
        result.checksum_blocks_checked = self._verify_checksums()
        return result

    def _verify_checksums(self) -> int:
        checked = 0
        for shard in range(self.opts.num_shards):
            meta = self.admin_session.fetch_blocks_metadata_from_peers(
                self.NS, shard, 0, self.cluster.clock.now_ns)
            # {(sid, bs): {host: checksum}}
            sums: Dict[Tuple[bytes, int], Dict[str, int]] = {}
            for host_id, series in meta.items():
                for sid, entry in series.items():
                    for b in entry["blocks"]:
                        sums.setdefault((sid, b["bs"]), {})[host_id] = \
                            b["checksum"]
            for (sid, bs), by_host in sums.items():
                assert len(by_host) == len(meta), \
                    (f"replica coverage hole after repair: shard {shard} "
                     f"sid {sid!r} bs {bs} held by {sorted(by_host)} of "
                     f"{sorted(meta)}")
                owners = set(by_host.values())
                assert len(owners) == 1, \
                    (f"replica checksum divergence after repair: shard "
                     f"{shard} sid {sid!r} bs {bs}: {by_host}")
                checked += 1
        return checked

    def close(self):
        self._stop.set()
        self.session.close()
        self.admin_session.close()
        self.cluster.close()


def _warm(device, opts) -> Dict[str, int]:
    """storage.database.warm_up, returning the kernel launches it made:
    start-up work, which a count of a path's launches leaves out."""
    before = kernel_launches()
    warm_up(device, opts)
    return {k: n - before[k] for k, n in kernel_launches().items()}


def _unsealed_points(shard) -> Tuple[List[bytes], np.ndarray, np.ndarray]:
    """Every point in `shard`'s mutable buffer: (ids, ts, vals)."""
    shard.insert_queue.drain()
    ids: List[bytes] = []
    ts, vals = [], []
    with shard.write_lock:
        for bucket in shard.buffer.buckets.values():
            sidx, t, v = dedup_sorted(*bucket.cols.view())
            ids.extend(shard.registry.id_of(int(i)) for i in sidx)
            ts.append(t)
            vals.append(v)
    if not ids:
        return ids, np.zeros(0, np.int64), np.zeros(0, np.float64)
    return ids, np.concatenate(ts), np.concatenate(vals)


# ---------------------------------------------------------------------------
# kill -9 disaster drill
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KillRestartOptions:
    """One seeded kill -9 drill: a REAL dbnode child process under
    seeded open-loop load, SIGKILLed mid-run, restarted over the same
    data dir, bootstrap replayed, zero-acked-loss verified.

    Variants:
      base       one kill/restart cycle; the snapshot-recovered block
                 and the replayed WAL tail merge at the first seal.
      migration  two namespaces share the one commit log; the load
                 migrates series mid-stream; replay must keep them
                 isolated per namespace.
      backfill   after the restart an out-of-order backfill wave lands
                 inside the recovered (still-writable) window — the
                 live buffer rides merge_same_start over the
                 snapshot-recovered sealed tile at the next seal —
                 then a SECOND kill/restart proves the merged block +
                 rotated WAL still serve every acked point."""

    seed: int = 7
    variant: str = "base"            # base | migration | backfill
    n_series: int = 48
    num_shards: int = 4
    block_size: str = "2s"
    buffer_past: str = "8s"
    buffer_future: str = "120s"
    tick_interval: str = "0.1s"
    base_rate: float = 150.0
    load_duration_s: float = 1.2
    # SIGKILL lands at a seeded fraction of the load window: early kills
    # die mid-commitlog-stream, late kills die with the mediator
    # mid-flush/snapshot (it runs every tick_interval).
    kill_window: Tuple[float, float] = (0.35, 0.8)
    restart_budget_s: float = 30.0
    # Deterministic fault injection on top of the random-phase kill: a
    # torn half-chunk appended to the WAL tail (what a power cut tears)
    # and an incomplete checkpoint-less fileset (what a mid-flush kill
    # leaves). Replay must drop both cleanly.
    inject_torn_tail: bool = True
    inject_torn_fileset: bool = True
    session_timeout_s: float = 3.0
    data_dir: Optional[str] = None
    # The child's device (`--device`) and the drill's own sessions' (None:
    # the CUDA card, and the child gets no `--device`).
    device: Optional[str] = None
    # Extra environment for every child, as (name, value) pairs: e.g.
    # M3_TPU_LOCKDEP=1 and M3_TPU_LOCKDEP_OUT to witness its locks.
    child_env: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass
class KillRestartResult:
    report: Optional[LoadReport]
    acked_points: int
    verified_points: int
    restart_walls_s: List[float]
    bootstrap_s: List[float]
    recovered_series: List[int]
    torn_tail_bytes: int = 0
    backfill_points: int = 0
    # Latency of the load's first write into the fresh child (the
    # earliest-due arrival): what a cold first write costs the drill.
    first_write_s: Optional[float] = None


def drill_config(data_dir: str, opts: "KillRestartOptions") -> dict:
    """The kill drill's dbnode config as a dict: the reference's
    `_write_config` document for the same options and data dir."""
    block_size, buffer_past = _window_strs(opts)
    ns = {"retention": "48h", "block_size": block_size,
          "buffer_past": buffer_past, "buffer_future": opts.buffer_future,
          "index_enabled": False}
    namespaces = [dict(ns, name="default")]
    if opts.variant == "migration":
        namespaces.append(dict(ns, name="migrated"))
    return {
        "data_dir": data_dir,
        "listen_address": "127.0.0.1:0",
        "num_shards": opts.num_shards,
        "commitlog_enabled": True,
        "commitlog_strategy": "write_wait",
        "bootstrap_enabled": True,
        "tick_interval": opts.tick_interval,
        "namespaces": namespaces,
    }


def _window_strs(o: "KillRestartOptions") -> Tuple[str, str]:
    """(block_size, buffer_past) for this variant. The backfill variant
    needs the recovered block start to stay inside the acceptance window
    across TWO child spawns plus the backfill wave (~6s nominal, more
    under load), so its defaults widen; explicit non-default options
    always win."""
    if o.variant == "backfill":
        cls = KillRestartOptions
        block = "3s" if o.block_size == cls.block_size else o.block_size
        past = "15s" if o.buffer_past == cls.buffer_past else o.buffer_past
        return block, past
    return o.block_size, o.buffer_past


_LAUNCHES_RE = re.compile(r"^m3_tpu_torch dbnode kernel launches (\{.*\})$")


class KillRestartScenario:
    """Crash-safety drill over a real `python -m m3_tpu_torch.services
    dbnode` child (WRITE_WAIT commit log, background mediator, bootstrap
    chain on startup): every quorum-acked write must be served after a
    SIGKILL and cold restart, the restart must be serving-ready within a
    bound, torn tail chunks and checkpoint-less filesets must be dropped
    cleanly, and nothing the node serves may be fabricated (every fetched
    point must be a write this drill attempted). The device is resolved
    before the data dir is made or a child spawned."""

    NS = b"default"
    NS_MIG = b"migrated"

    def __init__(self, opts: KillRestartOptions = KillRestartOptions()):
        self.opts = opts
        self.device = resolve(opts.device)
        self.dir = opts.data_dir or tempfile.mkdtemp(prefix="killdrill-")
        self._owns_dir = opts.data_dir is None
        self._rng = random.Random(f"kill-restart/{opts.seed}")
        self.ids = [b"kd-%04d" % i for i in range(opts.n_series)]
        self.ledger = WriteLedger(time.time_ns())
        # Every ALLOCATED write (acked or not): the fabrication check —
        # anything the node serves must appear here with this value.
        self._attempted: Dict[Tuple[bytes, bytes, int], float] = {}
        self._ns_of: Dict[bytes, bytes] = {}
        self._migrated = threading.Event()
        self._proc: Optional[subprocess.Popen] = None
        self._reader: Optional[threading.Thread] = None
        self._child_log: List[str] = []
        self.result = KillRestartResult(None, 0, 0, [], [], [])
        self._cfg_path = self._write_config()

    # ------------------------------------------------------------- lifecycle

    def _write_config(self) -> str:
        """The reference's config document, written as JSON (which
        services/config.py reads with or without PyYAML)."""
        path = os.path.join(self.dir, "dbnode.json")
        with open(path, "w") as f:
            json.dump(drill_config(self.dir, self.opts), f, indent=1)
        return path

    def argv(self) -> List[str]:
        """The child's command line: the port's dbnode service over the
        drill's config, with `--device` when the options name one."""
        argv = [sys.executable, "-m", "m3_tpu_torch.services", "dbnode",
                "-f", self._cfg_path]
        if self.opts.device is not None:
            argv += ["--device", self.opts.device]
        return argv

    def _spawn(self) -> Tuple[str, float]:
        """Start a dbnode child over the drill's data dir; returns
        (endpoint, wall seconds from exec to listening) and records the
        child-reported bootstrap time."""
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("JAX_")}
        env.update(dict(self.opts.child_env))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            self.argv(), cwd=_ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self._proc = proc
        # The reader runs on its own thread (and keeps draining for the
        # child's lifetime so it can't block on a full pipe): a child
        # that hangs BEFORE printing anything must still fail the drill
        # within the deadline, not block a blocking readline forever.
        ready = threading.Event()
        state: Dict[str, str] = {}

        def _read():
            for line in proc.stdout:
                self._child_log.append(line.rstrip())
                if line.startswith("dbnode serving-ready"):
                    fields = dict(kv.split("=") for kv in line.split()[2:])
                    self.result.bootstrap_s.append(float(fields["bootstrap_s"]))
                    self.result.recovered_series.append(int(fields["series"]))
                if "dbnode listening on" in line and "endpoint" not in state:
                    state["endpoint"] = line.rsplit(" ", 1)[-1].strip()
                    ready.set()
            ready.set()  # EOF: the child died before becoming ready

        self._reader = threading.Thread(target=_read, daemon=True)
        self._reader.start()
        ready.wait(timeout=max(60.0, self.opts.restart_budget_s))
        endpoint = state.get("endpoint")
        if endpoint is None:
            self._kill()
            raise RuntimeError(
                "dbnode child never became ready; log:\n" +
                "\n".join(self._child_log[-20:]))
        wall = time.perf_counter() - t0
        self.result.restart_walls_s.append(wall)
        return endpoint, wall

    def _session(self, endpoint: str,
                 timeout_s: Optional[float] = None) -> Session:
        placement = initial_placement(
            [Instance(id="node0", endpoint=endpoint)],
            self.opts.num_shards, 1)
        return Session(StaticTopology(placement), SessionOptions(
            timeout_s=timeout_s or self.opts.session_timeout_s,
            retry=RetryOptions(max_attempts=2, initial_backoff_s=0.02)),
            device=self.device)

    def _kill(self):
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)

    # ------------------------------------------------------------------ load

    def _write_one(self, session: Session, sid: bytes, ns: bytes,
                   t_ns: Optional[int] = None, value: Optional[float] = None):
        if t_ns is None:
            t_ns, value = self.ledger.next_write(sid)
        self._attempted[(ns, sid, t_ns)] = value
        self._ns_of[sid] = ns
        session.write(ns, sid, t_ns, value)
        # Only reached on ack: the ledger records EXACTLY what the node
        # owes the verifier after restart.
        self.ledger.ack(sid, t_ns, value)

    def _fire_factory(self, session: Session):
        def fire(kind: str):
            rng = random.Random()  # content only; schedule is seeded
            sid = self.ids[rng.randrange(len(self.ids))]
            ns = self.NS
            if self.opts.variant == "migration" and self._migrated.is_set():
                # Mid-stream namespace migration: the same series pool
                # continues under the new namespace, so one WAL file
                # interleaves both and replay must route per namespace.
                sid = b"mig-" + sid
                ns = self.NS_MIG
            self._write_one(session, sid, ns)
        return fire

    def _kill_at(self) -> float:
        """Seconds into the load window at which the SIGKILL lands: a
        seeded fraction of the window (the drill's first rng draw)."""
        o = self.opts
        lo, hi = o.kill_window
        return o.load_duration_s * (lo + (hi - lo) * self._rng.random())

    def _run_load_and_kill(self, session: Session):
        o = self.opts
        kill_at = self._kill_at()
        if o.variant == "migration":
            migrate_at = kill_at * 0.5
            threading.Timer(migrate_at, self._migrated.set).start()
        killer = threading.Timer(kill_at, self._kill)
        killer.daemon = True
        killer.start()
        gen = LoadGen(LoadSchedule(
            seed=o.seed, base_rate=o.base_rate,
            phases=(Phase("drill", o.load_duration_s, 1.0),),
            kinds=(("write", 1.0),)))
        self.result.report = gen.run(
            self._fire_factory(session),
            join_timeout_s=max(30.0, 10 * o.load_duration_s))
        if self.result.report.records:
            self.result.first_write_s = \
                self.result.report.records[0].latency_s
        killer.join(timeout=30)

    # ------------------------------------------------------ fault injection

    def _inject_faults(self) -> int:
        """Deterministic crash residue on top of whatever the SIGKILL
        left: a torn half-chunk on the WAL tail (header promises more
        bytes than exist) and a checkpoint-less snapshot fileset."""
        torn = 0
        cl_dir = os.path.join(self.dir, "commitlog")
        if self.opts.inject_torn_tail and os.path.isdir(cl_dir):
            files = sorted(f for f in os.listdir(cl_dir)
                           if f.startswith("commitlog-"))
            if files:
                junk = bytes(self._rng.getrandbits(8) for _ in range(24))
                with open(os.path.join(cl_dir, files[-1]), "ab") as f:
                    # Claims 512 payload bytes, delivers 24: exactly the
                    # shape a power cut mid-write leaves.
                    f.write(struct.pack("<II", 512, 0xDEAD) + junk)
                torn = 8 + len(junk)
        if self.opts.inject_torn_fileset:
            d = os.path.join(self.dir, "data", "default", "shard-00000",
                             "snapshot-999-0")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "data.bin"), "wb") as f:
                f.write(b"\x00" * 64)  # no checkpoint.json: incomplete
        self.result.torn_tail_bytes += torn
        return torn

    # ------------------------------------------------------------- backfill

    def _backfill(self, session: Session):
        """Out-of-order backfill into the recovered, still-writable
        window: timestamps interleave the pre-kill points (older than
        anything the ledger allocated since restart), written in
        seeded-shuffled order. They land in the mutable buffer BESIDE
        the snapshot-recovered sealed tile for the same block start, so
        the next seal rides merge_same_start."""
        from ..query.promql import parse_duration_ns

        o = self.opts
        n = max(8, o.n_series // 2)
        # Anchor between the pre-kill points (ledger timestamps are
        # whole microseconds; +500ns offsets at unique 2us steps
        # interleave without ever colliding), but never behind the
        # acceptance window — on a machine slow enough that the
        # restarts ate most of buffer_past, the wave shifts forward
        # instead of being rejected.
        _block, past = _window_strs(self.opts)
        floor = time.time_ns() - parse_duration_ns(past) + 2 * xtime.SECOND
        # Round the floor UP to the ledger's whole-microsecond grid so
        # the +500ns offsets below can never collide with a pre-kill
        # ledger timestamp even on the slow-machine path.
        micro = xtime.Unit.MICROSECOND.nanos
        floor = -(-floor // micro) * micro
        anchor = max(self.ledger.base_t_ns, floor)
        slots = []
        for i in range(n):
            sid = self.ids[self._rng.randrange(len(self.ids))]
            _t, value = self.ledger.next_write(sid)
            t_ns = anchor + i * 2 * xtime.Unit.MICROSECOND.nanos + 500
            slots.append((sid, t_ns, value))
        self._rng.shuffle(slots)  # out of order on the wire
        for sid, t_ns, value in slots:
            self._write_one(session, sid, self.NS, t_ns, value)
        self.result.backfill_points = len(slots)

    def _wait_for_seal_flush(self, timeout_s: float = 30.0) -> bool:
        """Wait until the mediator has sealed + flushed the drilled
        block (a flush fileset appears for namespace `default`): the
        moment the same-start merge of snapshot tile + live buffer has
        happened and become durable."""
        from ..persist.fs import fileset_complete

        root = os.path.join(self.dir, "data", "default")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.isdir(root):
                for shard_dir in os.listdir(root):
                    d = os.path.join(root, shard_dir)
                    # COMPLETE filesets only: the first kill can leave
                    # 'fileset-*.tmp' staging residue that must not
                    # count as the post-backfill flush.
                    if any(f.startswith("fileset-")
                           and not f.endswith(".tmp")
                           and fileset_complete(os.path.join(d, f))
                           for f in os.listdir(d)):
                        return True
            time.sleep(0.2)
        return False

    # ------------------------------------------------------------------- run

    def run(self) -> KillRestartResult:
        o = self.opts
        endpoint, _ = self._spawn()
        # The ledger's timestamps start at the load, not at construction:
        # a spawn longer than buffer_past (a child that imports torch and
        # opens a CUDA context takes 9-13 s on the card's host; buffer_past
        # is 8 s) would otherwise put every write outside the node's
        # acceptance window.
        self.ledger.base_t_ns = time.time_ns()
        session = self._session(endpoint)
        try:
            self._run_load_and_kill(session)
        finally:
            session.close()
        self._kill()  # idempotent: ensure death even if the timer misfired
        self._inject_faults()

        # Post-restart sessions verify and backfill: a generous timeout
        # rides out any residual first-use stall in a fresh child (the
        # load session above stays tight so killed-midair writes drain
        # fast instead of piling up).
        verify_timeout = max(15.0, o.session_timeout_s)
        endpoint, _ = self._spawn()
        session = self._session(endpoint, timeout_s=verify_timeout)
        try:
            if o.variant == "backfill":
                self._backfill(session)
                sealed = self._wait_for_seal_flush()
                assert sealed, "drilled block never sealed+flushed after " \
                    "backfill (mediator stuck?)"
                self._kill()
                self._inject_faults()
                endpoint, _ = self._spawn()
                session.close()
                session = self._session(endpoint, timeout_s=verify_timeout)
            self._verify_session = session
        except Exception:
            session.close()
            raise
        return self.result

    # ---------------------------------------------------------------- verify

    def verify(self, result: KillRestartResult) -> KillRestartResult:
        o = self.opts
        session = self._verify_session
        acked = self.ledger.acked()
        result.acked_points = sum(len(p) for p in acked.values())
        assert result.acked_points > 0, \
            "drill acked nothing — load never reached the node"
        end_ns = self.ledger.base_t_ns + 10 * xtime.MINUTE
        verified = 0
        for sid, points in sorted(acked.items()):
            ns = self._ns_of[sid]
            t, v = session.fetch(ns, sid, 0, end_ns)
            got = dict(zip(t.tolist(), v.tolist()))
            for t_ns, value in points:
                assert got.get(t_ns) == value, \
                    (f"ACKED write lost after kill -9 restart: ns={ns!r} "
                     f"{sid!r} t={t_ns} v={value} (fetched {len(got)} pts)")
                verified += 1
            # Fabrication check (torn tail / corrupt chunks must never
            # surface as data): every served point is one we attempted.
            for t_ns, value in got.items():
                want = self._attempted.get((ns, sid, int(t_ns)))
                assert want == value, \
                    (f"node served a point this drill never wrote: "
                     f"ns={ns!r} {sid!r} t={t_ns} v={value} (want {want})")
            if o.variant == "migration" and ns == self.NS_MIG:
                t2, _v2 = session.fetch(self.NS, sid, 0, end_ns)
                assert len(t2) == 0, \
                    f"migrated series {sid!r} leaked into {self.NS!r}"
        result.verified_points = verified
        for wall in result.restart_walls_s[1:]:
            assert wall <= o.restart_budget_s, \
                (f"restart-to-serving-ready {wall:.2f}s exceeded budget "
                 f"{o.restart_budget_s}s")
        for bs in result.bootstrap_s[1:]:
            assert bs <= o.restart_budget_s, \
                f"bootstrap {bs:.2f}s exceeded budget {o.restart_budget_s}s"
        assert result.recovered_series[1:], "no restart recorded"
        return result

    def stop_child(self, timeout_s: float = 30.0) -> Optional[dict]:
        """SIGTERM the live child, so it closes and writes its exit dumps
        (lockdep, racewatch), and wait for it. Returns the kernel launches
        it printed as it closed (None when it printed none: a SIGKILLed
        child's launches are never seen)."""
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=timeout_s)
        if self._reader is not None:
            self._reader.join(timeout=timeout_s)
        for line in reversed(self._child_log):
            m = _LAUNCHES_RE.match(line)
            if m:
                return json.loads(m.group(1))
        return None

    def close(self):
        try:
            self.stop_child(timeout_s=10.0)
        finally:
            s = getattr(self, "_verify_session", None)
            if s is not None:
                s.close()
            if self._owns_dir:
                shutil.rmtree(self.dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# disk-fault drill: bit rot, scrubbing, and full-disk degradation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiskFaultScenarioOptions:
    """One seeded disk-fault drill: an RF=3 cluster where ONE node's
    storage stack runs under a seeded `testing.faultfs` plan, in phases:

      corrupt   cold serving I/O on the victim flips bits / truncates
                reads while open-loop load runs; serve-time row-checksum
                verification must detect every rotten row, quarantine
                the fileset, and let replica coverage hide the damage.
      scrub     a DatabaseScrubber sweep (ShardRepairer attached) must
                re-fetch quarantined blocks from the healthy peers,
                un-quarantine them, and the rewrite flush must leave
                every victim fileset verify_rows()-clean.
      disk full every new write on the victim fails ENOSPC: flush
                failures trip DiskHealth into the read-only posture
                (NORMAL writes shed typed Backpressure, CRITICAL and
                reads keep flowing), and the first durable flush after
                the fault clears recovers the node automatically.

    Throughout: zero acked-write loss, zero fabrication (every served
    point is one the drill wrote), and bounded p99 under the corruption
    window. Faults, load, and scrub jitter are pure functions of `seed`;
    wall-clock timing is not, so the assertions are SLO-shaped."""

    seed: int = 7
    n_nodes: int = 3
    replica_factor: int = 3
    num_shards: int = 8
    n_series: int = 24
    victim: str = "node0"
    # Seeded read-corruption plan (corrupt phase) on the victim's disk.
    read_flip: float = 0.3
    read_short: float = 0.1
    # Seeded full-disk plan (disk-full phase): every new write ENOSPCs.
    write_enospc: float = 1.0
    # Open-loop offered load during the corruption window.
    base_rate: float = 40.0
    duration_s: float = 1.5
    read_sweeps: int = 3          # deterministic cold-read passes
    # SLO bounds asserted by verify().
    p99_write_s: float = 2.0
    p99_read_s: float = 2.0
    session_timeout_s: float = 5.0
    warm_kernels: bool = True
    device: Optional[str] = None  # None: the CUDA card


@dataclasses.dataclass
class DiskFaultResult:
    report: Optional[LoadReport]
    ledger: WriteLedger
    quarantined_after_faults: int = 0
    quarantined_after_scrub: int = 0
    scrub_stats: Optional[ScrubStats] = None
    health_tripped: bool = False
    normal_shed: bool = False
    critical_served: bool = False
    recovered: bool = False
    verified_points: int = 0
    filesets_verified: int = 0


class DiskFaultScenario:
    """One seeded disk-fault drill over an in-process RF=3 cluster on
    `opts.device`."""

    NS = b"default"

    def __init__(self,
                 opts: DiskFaultScenarioOptions = DiskFaultScenarioOptions()):
        self.opts = opts
        self.device = resolve(opts.device)
        self.cluster = ClusterHarness(
            n_nodes=opts.n_nodes, replica_factor=opts.replica_factor,
            num_shards=opts.num_shards, with_commitlog=True,
            device=self.device)
        # Disk-backed cold reads on every node: the victim's sealed
        # blocks are evicted after the seed flush, so its serving path
        # actually crosses the (faulted) persist tier.
        for node in self.cluster.nodes.values():
            node.db.set_retriever(BlockRetriever(node.persist,
                                                 device=self.device))
        self.victim = self.cluster.nodes[opts.victim]
        victim_scope = self.victim.data_dir + os.sep
        self.read_plan = faultfs.DiskFaultPlan(
            seed=opts.seed, read_flip=opts.read_flip,
            read_short=opts.read_short, path_filter=victim_scope)
        self.disk_full_plan = faultfs.DiskFaultPlan(
            seed=opts.seed, write_enospc=opts.write_enospc,
            path_filter=victim_scope)
        self.ids = [b"disk-%04d" % i for i in range(opts.n_series)]
        self.ledger = WriteLedger(self.cluster.clock.now_ns)
        # Every write the drill EVER issued, acked or not: the
        # fabrication check — anything any replica serves must be here.
        self._attempted: Dict[Tuple[bytes, int], float] = {}
        self.warm_launches: Dict[str, int] = {}
        self.session = Session(
            self.cluster.topology,
            SessionOptions(timeout_s=opts.session_timeout_s,
                           retry=RetryOptions(max_attempts=2,
                                              initial_backoff_s=0.02),
                           fanout_workers=64, pool_size=8),
            device=self.device)
        self.admin_session = Session(
            self.cluster.topology,
            SessionOptions(timeout_s=max(10.0, opts.session_timeout_s)),
            device=self.device)
        self.result = DiskFaultResult(report=None, ledger=self.ledger)

    # ---------------------------------------------------------------- phases

    def _warm_kernels(self):
        """See ChurnScenario._warm_kernels: a first launch mid-run would
        bill start-up into the corruption-window p99."""
        self.warm_launches = _warm(self.device, self.cluster.ns_opts)

    def _seed_and_flush(self):
        """Seed sealed history on every replica, flush it to disk
        everywhere, and evict the VICTIM's in-memory copies — its cold
        reads now cross the persist tier while the peers keep resident
        (authoritative) copies for repair to fetch from."""
        now = self.cluster.clock.now_ns
        ts = [now - (i + 1) * xtime.SECOND for i in range(4)]
        for j, sid in enumerate(self.ids):
            vals = np.arange(len(ts), dtype=np.float64) + 1000.0 * j
            for t_ns, v in zip(ts, vals):
                self._attempted[(sid, t_ns)] = float(v)
                self.ledger.ack(sid, t_ns, float(v))
            self.session.write_batch(self.NS, [sid] * len(ts), ts, vals)
        self.cluster.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
        self.cluster.tick_all()
        now = self.cluster.clock.now_ns
        for node in self.cluster.nodes.values():
            node.db.flush(node.persist, now)
        self.victim.db.evict_flushed()
        self.ledger.base_t_ns = now

    def _fire(self, kind: str):
        rng = random.Random()  # content only; schedule is already seeded
        sid = self.ids[rng.randrange(len(self.ids))]
        if kind == "write":
            t_ns, value = self.ledger.next_write(sid)
            self._attempted[(sid, t_ns)] = value
            self.session.write(self.NS, sid, t_ns, value)
            # Only reached on quorum ack.
            self.ledger.ack(sid, t_ns, value)
        else:
            self.session.fetch(self.NS, sid, 0,
                               self.cluster.clock.now_ns + xtime.HOUR)

    def _count_quarantined(self) -> int:
        return sum(
            len(self.victim.persist.list_quarantined(self.NS, shard))
            for shard in range(self.opts.num_shards))

    def _corruption_phase(self):
        """Seeded bit rot under live load: victim cold reads hit flipped
        bits / short reads; serve-time verification must quarantine the
        rot while replica coverage keeps every fetch correct."""
        o = self.opts
        faultfs.install(self.read_plan)
        try:
            gen = LoadGen(LoadSchedule(
                seed=o.seed, base_rate=o.base_rate,
                phases=(Phase("corrupt", o.duration_s, 1.0),),
                kinds=(("write", 2.0), ("read", 3.0))))
            self.result.report = gen.run(
                self._fire, join_timeout_s=max(30.0, 10 * o.duration_s))
            # Deterministic cold sweeps on top of the open-loop load:
            # every series' cold block is sought through the fault plan,
            # so detection does not depend on the load mix.
            end = self.cluster.clock.now_ns + xtime.HOUR
            for _ in range(o.read_sweeps):
                for sid in self.ids:
                    self.session.fetch(self.NS, sid, 0, end)
        finally:
            faultfs.uninstall()
        self.result.quarantined_after_faults = self._count_quarantined()

    def _scrub_phase(self):
        """Reconvergence: one scrubber sweep repairs the quarantined
        blocks from the healthy peers and un-quarantines them; the
        rewrite flush makes the victim's disk clean again."""
        # Age the seed block into scrub's cold territory (outside the
        # two-block mutable head) and seal the corruption-window writes.
        self.cluster.clock.advance(4 * xtime.HOUR + 7 * xtime.MINUTE)
        self.cluster.tick_all()
        now = self.cluster.clock.now_ns
        self.ledger.base_t_ns = now
        scrubber = DatabaseScrubber(
            self.victim.db, self.victim.persist,
            repairer=ShardRepairer(self.admin_session,
                                   host_id=self.opts.victim),
            opts=ScrubOptions(seed=self.opts.seed))
        stats = scrubber.run(now_ns=now)
        total = ScrubStats()
        for st in stats.values():
            total.add(st)
        self.result.scrub_stats = total
        # Repaired blocks cleared their flush state: rewrite them (plus
        # the just-sealed corruption-window block) while the disk heals.
        for node in self.cluster.nodes.values():
            node.db.flush(node.persist, now)
        self.result.quarantined_after_scrub = self._count_quarantined()

    def _degrade_phase(self):
        """Full disk on the victim: flush failures trip DiskHealth into
        read-only (NORMAL sheds typed Backpressure, CRITICAL and reads
        flow), and the first clean flush recovers it."""
        for sid in self.ids:
            t_ns, value = self.ledger.next_write(sid)
            self._attempted[(sid, t_ns)] = value
            self.session.write(self.NS, sid, t_ns, value)
            self.ledger.ack(sid, t_ns, value)
        self.cluster.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
        self.cluster.tick_all()
        self.ledger.base_t_ns = self.cluster.clock.now_ns
        db = self.victim.db
        faultfs.install(self.disk_full_plan)
        try:
            # Every sealed block's flush ENOSPCs (typed DiskFullError
            # through the retry budget): consecutive failures trip the
            # read-only posture.
            db.flush(self.victim.persist, self.cluster.clock.now_ns)
            self.result.health_tripped = db.disk_health.read_only()
            sid = self.ids[0]
            t_ns, value = self.ledger.next_write(sid)
            self._attempted[(sid, t_ns)] = value
            try:
                db.write(self.NS, sid, t_ns, value)
            except Backpressure:
                self.result.normal_shed = True  # typed shed, not an ack
            # CRITICAL traffic is never shed; reads keep flowing too.
            crit_sid = self.ids[1]
            t_ns, value = self.ledger.next_write(crit_sid)
            self._attempted[(crit_sid, t_ns)] = value
            db.write(self.NS, crit_sid, t_ns, value,
                     priority=Priority.CRITICAL)
            t, v = db.read(self.NS, crit_sid, t_ns, t_ns + 1)
            self.result.critical_served = (
                len(t) == 1 and float(v[0]) == value)
        finally:
            faultfs.uninstall()
        # Recovery is automatic: the next flush sweep's durable success
        # clears the posture and NORMAL writes flow again.
        db.flush(self.victim.persist, self.cluster.clock.now_ns)
        if not db.disk_health.read_only():
            sid = self.ids[2]
            t_ns, value = self.ledger.next_write(sid)
            self._attempted[(sid, t_ns)] = value
            db.write(self.NS, sid, t_ns, value)  # would raise if still RO
            self.result.recovered = True

    # ------------------------------------------------------------------- run

    def run(self) -> DiskFaultResult:
        if self.opts.warm_kernels:
            self._warm_kernels()
        self._seed_and_flush()
        self._corruption_phase()
        self._scrub_phase()
        self._degrade_phase()
        # Final convergence: seal + flush everything with the disk
        # healthy so verify() reads a settled cluster.
        self.cluster.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
        self.cluster.tick_all()
        now = self.cluster.clock.now_ns
        for node in self.cluster.nodes.values():
            node.db.flush(node.persist, now)
        return self.result

    # ---------------------------------------------------------------- verify

    def verify(self, result: DiskFaultResult) -> DiskFaultResult:
        """Assert every disk-fault SLO; raises AssertionError naming the
        violated guarantee."""
        o = self.opts

        # 1. detection: seeded bit rot was caught and quarantined.
        assert result.quarantined_after_faults >= 1, \
            "no fileset quarantined under seeded read corruption"

        # 2. reconvergence: the scrub sweep repaired from peers and
        # un-quarantined everything it found.
        st = result.scrub_stats
        assert st is not None and st.unquarantined >= 1, \
            f"scrub un-quarantined nothing: {st}"
        assert st.blocks_repaired >= 1, \
            f"scrub repaired no blocks from peers: {st}"
        assert st.filesets_scanned >= 1, \
            f"scrub cold scan covered no filesets: {st}"
        assert result.quarantined_after_scrub == 0, \
            (f"{result.quarantined_after_scrub} fileset(s) still "
             f"quarantined after scrub + repair")

        # 3. the victim's disk is verifiably clean end-state: every
        # fileset row-verifies (digest chain + per-row adlers + bloom).
        verified = 0
        for shard in range(o.num_shards):
            for _bs, path in self.victim.persist.list_filesets(
                    self.NS, shard):
                pfs.FilesetReader(path, device=self.device).verify_rows()
                verified += 1
        assert verified >= 1, "victim holds no filesets to verify"
        result.filesets_verified = verified

        # 4. graceful degradation: full disk tripped read-only, NORMAL
        # shed typed Backpressure, CRITICAL + reads flowed, and the
        # first clean flush recovered the node.
        assert result.health_tripped, \
            "ENOSPC flush failures never tripped DiskHealth read-only"
        assert result.normal_shed, \
            "read-only posture did not shed a NORMAL write"
        assert result.critical_served, \
            "CRITICAL write/read did not flow under read-only posture"
        assert result.recovered, \
            "node did not auto-recover after the disk healed"

        # 5. bounded p99 under the corruption window.
        rep = result.report
        p99_w = rep.quantile_latency(0.99, kind="write")
        p99_r = rep.quantile_latency(0.99, kind="read")
        assert p99_w <= o.p99_write_s, \
            f"write p99 {p99_w:.3f}s > bound {o.p99_write_s}s"
        assert p99_r <= o.p99_read_s, \
            f"read p99 {p99_r:.3f}s > bound {o.p99_read_s}s"

        # 6. zero lost acked writes, despite quarantine + read-only.
        now = self.cluster.clock.now_ns
        verified_points = 0
        fetched: Dict[bytes, Dict[int, float]] = {}
        for sid, points in sorted(result.ledger.acked().items()):
            t, v = self.session.fetch(self.NS, sid, 0, now + 1)
            got = dict(zip(t.tolist(), v.tolist()))
            fetched[sid] = got
            for t_ns, value in points:
                assert got.get(t_ns) == value, \
                    (f"ACKED write lost under disk faults: {sid!r} "
                     f"t={t_ns} v={value} (fetched {len(got)} points)")
                verified_points += 1
        result.verified_points = verified_points

        # 7. zero fabrication: corrupt bytes must never surface as data
        # — every served point is one this drill wrote.
        for sid, got in fetched.items():
            for t_ns, value in got.items():
                want = self._attempted.get((sid, int(t_ns)))
                assert want == value, \
                    (f"fabricated point served: {sid!r} t={t_ns} "
                     f"v={value} (want {want})")
        return result

    def close(self):
        faultfs.uninstall()  # idempotent: never leak a fault plan
        self.session.close()
        self.admin_session.close()
        self.cluster.close()


# ---------------------------------------------------------------------------
# compute-fault churn drill (the compute leg of the fault trilogy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComputeFaultChurnOptions(ChurnScenarioOptions):
    """ChurnScenario options plus a seeded compute-fault plan armed on the
    guarded dispatch seam for the SLO'd window: every guarded dispatch in
    the process (the hash kernel's routing, the block decode, the codec
    kernels; whatever the load and the churn drive) runs under seeded
    device chaos while the network chaos plan and placement churn run as
    usual."""

    # Per-dispatch fault rates (testing/faultcomp.ComputeFaultPlan).
    compute_dispatch_raise: float = 0.15
    compute_oom: float = 0.05
    compute_corrupt: float = 0.15
    compute_delay: float = 0.05
    compute_delay_s: float = 0.01
    compute_route_filter: str = ""    # all guarded routes


class ComputeFaultChurnScenario(ChurnScenario):
    """One seeded churn run with the compute-fault plane armed over the
    SLO'd window.

    The reference's drill asserts that device faults vanish into its
    fallback twins. The port has none: a faulted dispatch ends in a typed
    ComputeError, an open breaker or a quarantined key, and the request
    fails. So this drill holds the port to what it promises instead:
      * every guarded dispatch in the window ends as its own decisions
        say (`faultcomp.DispatchAudit`: answered when every decision
        answers, else the typed raise they imply);
      * no acked write is lost, no CRITICAL probe is shed, p99 and the
        queues stay bounded, placement converges and replicas agree
        (the ChurnScenario SLOs, checked after the window);
      * the decision log is the plan's pure schedule.
    The served-rate floor of ChurnScenario is not asserted: typed raises
    are this drill's expected outcomes.

    A churn step (a peer bootstrap, a repair) that a typed fault ends is
    deferred and re-run once the window closes, as an operator re-runs a
    failed bootstrap. Closing the window resets the guard (breakers and
    quarantine): what the drill's faults tripped must not hold the
    convergence checks."""

    def __init__(self, opts: ComputeFaultChurnOptions =
                 ComputeFaultChurnOptions()):
        super().__init__(opts)
        from . import faultcomp

        self.compute_plan = faultcomp.ComputeFaultPlan(
            seed=opts.seed,
            dispatch_raise=opts.compute_dispatch_raise,
            oom=opts.compute_oom,
            corrupt=opts.compute_corrupt,
            delay=opts.compute_delay,
            delay_s=opts.compute_delay_s,
            route_filter=opts.compute_route_filter)
        self.compute_seam = None
        self.audit = None
        self.deferred_log: List[str] = []
        self._deferred: List[Tuple[str, str]] = []

    def _window_open(self):
        from ..parallel import guard
        from . import faultcomp

        # Fresh breakers/quarantine: a previous drill's tripped routes
        # must not pre-degrade this one.
        guard.reset()
        self.compute_seam = faultcomp.install(self.compute_plan)
        self.audit = faultcomp.DispatchAudit(self.compute_seam).install()
        super()._window_open()

    def _window_close(self):
        from ..parallel import guard
        from . import faultcomp

        super()._window_close()
        self.audit.uninstall()
        faultcomp.uninstall()
        guard.reset()
        deferred, self._deferred = self._deferred, []
        for step, host_id in deferred:
            self.deferred_log.append(f"re-run {step} {host_id}")
            if step == "bootstrap":
                super()._bootstrap_initializing(host_id)
            else:
                super()._run_repair(host_id)

    def _bootstrap_initializing(self, host_id: str):
        try:
            super()._bootstrap_initializing(host_id)
        except ComputeError as e:
            self.deferred_log.append(
                f"bootstrap {host_id}: {type(e).__name__} on {e.route}")
            self._deferred.append(("bootstrap", host_id))

    def _run_repair(self, host_id: str):
        try:
            super()._run_repair(host_id)
        except ComputeError as e:
            self.deferred_log.append(
                f"repair {host_id}: {type(e).__name__} on {e.route}")
            self._deferred.append(("repair", host_id))

    def _ok_floor(self) -> float:
        return 0.0

    def verify(self, result: ScenarioResult) -> ScenarioResult:
        result = super().verify(result)
        seam = self.compute_seam
        assert seam is not None and seam.faults_injected > 0, \
            "compute chaos never fired — the drill proved nothing"
        bad = self.audit.unexplained()
        assert not bad, \
            f"guarded outcomes their decisions do not explain: {bad[:5]}"
        # Replayability: the recorded decision log IS the pure schedule.
        for route, decisions in seam.decisions.items():
            assert decisions == self.compute_plan.schedule(
                route, len(decisions)), \
                f"decision log diverged from the seeded schedule: {route}"
        return result

    def close(self):
        from . import faultcomp

        if self.audit is not None:
            self.audit.uninstall()
        faultcomp.uninstall()  # idempotent: never leak the fault seam
        super().close()
