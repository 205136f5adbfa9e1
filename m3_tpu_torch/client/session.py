"""Replicating smart client (port of m3_tpu/client/session.py;
reference: src/dbnode/client/session.go).

Session parity: topology-watching (session.go:536-543), per-host queues
with op batching (host_queue.go), connection pools
(connection_pool.go), write fanout to all shard replicas with quorum
wait (session.go:867 Write -> :903 writeAttempt, majority :609),
FetchTagged with consistency accumulation
(fetch_tagged_results_accumulator.go), and the AdminSession peer
metadata/block streaming used by bootstrap & repair
(FetchBootstrapBlocksFromPeers; docs/m3db/architecture/peer_streaming.md).

A Session decodes the sealed tiles of its fetches on its device (None:
the CUDA card, raising without one): one launch of the decode kernel a
tile. Routing stays the reference's host ShardSet.lookup per ID. A
replica whose kernel raised answers with an error frame, which counts as
a failed replica under the consistency rule (PEER_SKIP_ERRORS); the
client never re-runs the work on the CPU."""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait as futures_wait
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..cluster.topology import (
    ConsistencyLevel,
    ReadConsistencyLevel,
    required_acks,
    required_reads,
)
from ..device import resolve
from ..parallel.sharding import ShardSet
from ..rpc import wire
from ..utils import tracing
from ..utils.instrument import ROOT
from ..utils.limits import ResourceExhausted
from ..utils.retry import (
    Breaker,
    BreakerOpen,
    BreakerOptions,
    Deadline,
    DeadlineExceeded,
    HostHealth,
    Retrier,
    RetryOptions,
)
from .decode import ConflictStrategy, merge_replica_points


class ConsistencyError(Exception):
    """Not enough replica acks/responses to satisfy the consistency level."""


# The typed ways a peer RPC fails without implicating this process's own
# logic: transport death (ConnectionError covers WireTruncated and
# BreakerOpen), socket/connect errors, an expired budget, or a deliberate
# shed by a healthy-but-overloaded peer. Peer-streaming paths classify on
# exactly this set — anything else is a programming error and propagates.
PEER_SKIP_ERRORS = (ConnectionError, OSError, DeadlineExceeded,
                    ResourceExhausted)

# AdminSession peer-streaming instrumentation (bootstrap/repair observe
# peer failures through these instead of silent except/continue).
_PEER_METRICS = ROOT.sub_scope("session.peers")


# ------------------------------------------------------------------ transport


class Connection:
    """One framed TCP connection (connection_pool.go conn)."""

    def __init__(self, endpoint: str, connect_timeout: float = 10.0,
                 request_timeout: float = 10.0):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=connect_timeout)
        self.sock.settimeout(request_timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.request_timeout = request_timeout
        self._msg_id = 0

    def call(self, method: str, args: dict,
             deadline: Optional[Deadline] = None,
             priority: Optional[str] = None):
        self._msg_id += 1
        req = {"m": method, "id": self._msg_id, "a": args}
        if priority is not None:
            # Admission hint for the server's gate ("bulk" sheds first at
            # the high watermark); rides the frame, not the args.
            req["pri"] = priority
        # Trace context rides the frame beside "d"/"pri" — only when a
        # SAMPLED span is active on this thread, so unsampled traffic
        # costs one thread-local read and no wire bytes. The server's
        # finished span tree comes back under "sp" and is grafted below.
        cur_span = tracing.TRACER.current()
        if cur_span is not None:
            req[wire.TRACE_KEY] = cur_span.context().to_wire()
        if deadline is not None:
            deadline.check(method)
            req[wire.DEADLINE_KEY] = deadline.to_wire()
            # The read must give up when the BUDGET does, not at the
            # connection's default request timeout past it.
            self.sock.settimeout(deadline.min_timeout(self.request_timeout))
        else:
            self.sock.settimeout(self.request_timeout)
        wire.write_frame(self.sock, req)
        try:
            while True:
                resp = wire.read_dict_frame(self.sock)
                rid = resp.get("id", self._msg_id)
                if rid == self._msg_id:
                    break
                if rid > self._msg_id:
                    # A response from the future: the stream is not
                    # request/response-paired anymore — unusable.
                    self.close()
                    raise ConnectionError(
                        f"node reply desync: got id {rid}, "
                        f"expected {self._msg_id}")
                # rid < current: a STALE response — a duplicated request
                # frame (at-least-once delivery) made the server answer
                # an earlier exchange twice. Discard and keep reading;
                # matching on id restores pairing instead of handing the
                # caller another method's result. Re-arm the socket
                # timeout to the REMAINING budget each iteration: stale
                # frames dripping in just under the timeout must not
                # extend a deadlined call past its budget (the unread
                # real response leaves the stream desynced — drop it).
                if deadline is not None:
                    if deadline.expired:
                        self.close()
                        raise DeadlineExceeded(
                            f"{method}: deadline exceeded draining "
                            "stale responses")
                    self.sock.settimeout(
                        deadline.min_timeout(self.request_timeout))
        except socket.timeout:
            # The response may still land later: this stream is desynced
            # for any further request/response pairing — drop it.
            self.close()
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded(f"{method}: deadline exceeded "
                                       "waiting for reply")
            raise
        except ValueError as e:
            # malformed reply = desync: this connection is unusable; close
            # it and surface a CONNECTION error so quorum fanout treats
            # the node as failed instead of retrying on a broken stream.
            self.close()
            raise ConnectionError(f"node reply desync: {e}")
        if not resp.get("ok"):
            if resp.get("kind") == "deadline":
                raise DeadlineExceeded(resp.get("err", "deadline exceeded"))
            if resp.get("kind") == "resource_exhausted":
                # Server shed this request (query limit / admission gate).
                # ResourceExhausted is a RetryableError: the Retrier backs
                # off and re-attempts, because the overload clears on its
                # own — distinct from deadline, which stays non-retryable.
                raise ResourceExhausted(
                    resp.get("err", "server resource exhausted"))
            raise RemoteError(resp.get("err", "unknown remote error"))
        if cur_span is not None and cur_span.end_ns is None:
            # Graft the server-side tree under the calling span, tagged
            # with the endpoint it ran on — the cross-process hop becomes
            # one child in the caller's tree. A FINISHED span (quorum met
            # and returned while this replica straggled) never mutates:
            # it may already be published in the tracer's recent ring.
            sp = resp.get(wire.SPAN_KEY)
            if isinstance(sp, dict):
                sp.setdefault("tags", {})["endpoint"] = self.endpoint
                cur_span.attach(sp)
        return resp["r"]

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteError(Exception):
    """Server-side failure relayed to the caller (not a transport error)."""


class HostClient:
    """Connection pool for one host (client/connection_pool.go) fronted
    by a circuit breaker and a retrier: transport failures retry with
    backoff, repeated failures trip the breaker so a dead host is shed
    instead of hammered, and a half-open probe restores it."""

    def __init__(self, endpoint: str, pool_size: int = 4, timeout: float = 10.0,
                 connect_timeout: Optional[float] = None,
                 retry_opts: RetryOptions = RetryOptions(),
                 breaker: Optional[Breaker] = None,
                 on_outcome: Optional[Callable[[bool], None]] = None):
        self.endpoint = endpoint
        self.timeout = timeout
        self.connect_timeout = timeout if connect_timeout is None else connect_timeout
        self.breaker = breaker if breaker is not None else Breaker(name=endpoint)
        self._on_outcome = on_outcome  # e.g. HostHealth.count
        self.retrier = Retrier(retry_opts)
        self.pool_size = pool_size
        self._free: List[Connection] = []
        self._lock = threading.Lock()
        self._sema = threading.Semaphore(pool_size)

    def _fill(self) -> None:
        """Dial until the pool holds `pool_size` idle connections, as M3's
        connection pool fills itself when its session opens
        (client/connection_pool.go): a later call takes an open connection
        instead of dialing one under load. Stops at the first refusal,
        leaving the rest to be dialed when a call needs them."""
        for _ in range(self.pool_size):
            with self._lock:
                if len(self._free) >= self.pool_size:
                    break
            try:
                conn = Connection(self.endpoint, self.connect_timeout,
                                  self.timeout)
            except (OSError, ConnectionError):
                break
            with self._lock:
                if len(self._free) < self.pool_size:
                    self._free.append(conn)
                    continue
            conn.close()  # the calls in flight returned enough meanwhile
            break

    def _record(self, ok: bool):
        if ok:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        if self._on_outcome is not None:
            self._on_outcome(ok)

    def call(self, method: str, _deadline: Optional[Deadline] = None,
             _priority: Optional[str] = None, **args):
        return self.retrier.attempt(self._call_once, method, args,
                                    _deadline, _priority, deadline=_deadline)

    def _call_once(self, method: str, args: dict, deadline: Optional[Deadline],
                   priority: Optional[str] = None):
        if self.breaker.state == Breaker.OPEN:
            # fast shed: no pool-slot wait, no grant claimed
            raise BreakerOpen(f"host {self.endpoint} shed by open breaker")
        with self._sema:
            # Claim the breaker grant only once a pool slot is held: a
            # half-open probe stuck waiting behind a busy pool would
            # otherwise hold the ONLY probe slot while doing no probe
            # I/O, shedding every other caller for the whole wait.
            if not self.breaker.allow():
                raise BreakerOpen(f"host {self.endpoint} shed by open breaker")
            # Past allow(), EVERY exit must settle the grant exactly
            # once — an unsettled exit leaks the half-open probe slot
            # and wedges the breaker half-open forever (allow()'s
            # contract).
            recorded = [False]

            def record(ok: bool):
                if not recorded[0]:
                    recorded[0] = True
                    self._record(ok)

            try:
                return self._call_on_conn(method, args, deadline, record,
                                          priority)
            except DeadlineExceeded as e:
                if getattr(e, "pre_io", False) and not recorded[0]:
                    # budget died in CLIENT-side queueing (retry backoff,
                    # connect gate) before any bytes reached the host:
                    # release the grant without blaming the endpoint
                    recorded[0] = True
                    self.breaker.cancel()
                else:
                    record(False)
                raise
            except BaseException:
                record(False)  # safety net for paths the branches miss
                raise

    def _call_on_conn(self, method: str, args: dict,
                      deadline: Optional[Deadline], record,
                      priority: Optional[str] = None):
        """One attempt on a pooled connection (pool semaphore + breaker
        grant both held by _call_once)."""
        with self._lock:
            conn = self._free.pop() if self._free else None
        if conn is None:
            # the connect phase consumes deadline budget too: a
            # blackholed host (SYN drop) must not stall a 100ms-budget
            # call for the full connect timeout
            ct = self.connect_timeout
            if deadline is not None:
                deadline.check(method)
                ct = deadline.min_timeout(ct)
            try:
                conn = Connection(self.endpoint, ct, self.timeout)
            except (OSError, ConnectionError):
                record(False)
                raise
        try:
            result = conn.call(method, args, deadline, priority)
        except RemoteError:
            # The HOST is healthy — it parsed, ran, and answered; the
            # application errored. Keep the connection and the breaker
            # must not trip on it.
            with self._lock:
                self._free.append(conn)
            record(True)
            raise
        except ResourceExhausted:
            # Deliberate shed by a healthy host: the stream is synced and
            # poolable, and the breaker must not trip (tripping it would
            # turn a load-shedding node into a "dead" one and dogpile its
            # replicas). The retrier above backs off and re-attempts —
            # exactly the producer behavior shedding asks for.
            with self._lock:
                self._free.append(conn)
            record(True)
            raise
        except DeadlineExceeded as e:
            # conn.call already dropped a desynced stream (reply never
            # read); a server-relayed deadline frame leaves the stream
            # synced and poolable. The breaker records a failure when
            # the HOST burned the budget; a pre-I/O expiry (tagged by
            # Deadline.check — budget died before any bytes went out)
            # falls through for _call_once to cancel the grant.
            if conn.sock.fileno() != -1:
                with self._lock:
                    self._free.append(conn)
            if not getattr(e, "pre_io", False):
                record(False)
            raise
        except Exception:
            conn.close()
            record(False)
            raise
        with self._lock:
            self._free.append(conn)
        record(True)
        return result

    def health(self) -> bool:
        try:
            return bool(self.call("health")["ok"])
        except Exception:  # noqa: BLE001
            return False

    def close(self):
        with self._lock:
            for c in self._free:
                c.close()
            self._free.clear()


# ------------------------------------------------------------------- batching


class _Completion:
    """Quorum wait for one logical write (session writeState)."""

    __slots__ = ("required", "total", "acks", "errors", "errs", "_cond")

    def __init__(self, required: int, total: int):
        self.required = required
        self.total = total
        self.acks = 0
        self.errors = 0
        self.errs: List[str] = []
        self._cond = threading.Condition()

    def ack(self):
        with self._cond:
            self.acks += 1
            self._cond.notify_all()

    def error(self, err: str):
        with self._cond:
            self.errors += 1
            self.errs.append(err)
            self._cond.notify_all()

    def wait(self, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                if self.acks >= self.required:
                    return
                if self.acks + self.errors >= self.total:
                    raise ConsistencyError(
                        f"{self.acks}/{self.total} acks, need {self.required}: {self.errs}"
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConsistencyError(
                        f"timeout: {self.acks}/{self.total} acks, need {self.required}"
                    )
                self._cond.wait(remaining)


@dataclasses.dataclass
class _WriteOp:
    ns: bytes
    id: bytes
    t_ns: int
    value: float
    tags: Optional[dict]
    completion: _Completion
    # Wire admission hint ("bulk" backfill sheds first server-side); None
    # is NORMAL serving traffic.
    priority: Optional[str] = None


class HostQueue:
    """Per-host op queue: batches writes into write_batch RPCs
    (client/host_queue.go). Drains whatever is queued on each wake, so
    batching emerges under load without adding idle latency."""

    def __init__(self, client: HostClient, max_batch: int = 256):
        self.client = client
        self.max_batch = max_batch
        self._ops: List[_WriteOp] = []
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def enqueue(self, op: _WriteOp):
        with self._cond:
            if self._closed:
                raise ConnectionError("host queue closed")
            self._ops.append(op)
            self._cond.notify()

    def _run(self):
        while True:
            with self._cond:
                while not self._ops and not self._closed:
                    self._cond.wait()
                if self._closed and not self._ops:
                    return
                batch, self._ops = self._ops[: self.max_batch], self._ops[self.max_batch :]
            self._flush(batch)

    def _flush(self, batch: List[_WriteOp]):
        by_ns: Dict[Tuple[bytes, Optional[str]], List[_WriteOp]] = {}
        for op in batch:
            by_ns.setdefault((op.ns, op.priority), []).append(op)
        for (ns, pri), ops in by_ns.items():
            try:
                self.client.call(
                    "write_batch",
                    _priority=pri,
                    ns=ns,
                    ids=[o.id for o in ops],
                    ts=np.array([o.t_ns for o in ops], np.int64),
                    vals=np.array([o.value for o in ops], np.float64),
                    tags=[o.tags for o in ops],
                )
            except Exception as e:  # noqa: BLE001 — propagate via completion
                for o in ops:
                    o.completion.error(f"{self.client.endpoint}: {e}")
            else:
                for o in ops:
                    o.completion.ack()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=5)


# -------------------------------------------------------------------- session


@dataclasses.dataclass
class SessionOptions:
    write_consistency: ConsistencyLevel = ConsistencyLevel.MAJORITY
    read_consistency: ReadConsistencyLevel = ReadConsistencyLevel.UNSTRICT_MAJORITY
    conflict_strategy: ConflictStrategy = ConflictStrategy.LAST_PUSHED
    timeout_s: float = 30.0
    pool_size: int = 4
    max_batch: int = 256
    # resilience knobs (no more hard-coded connect timeout): per-host
    # transport retries, breaker trip/recovery, and connection timeouts.
    # None = inherit timeout_s, preserving the pre-xresil behavior where
    # the per-RPC socket timeout WAS the session timeout — a user setting
    # only timeout_s must not be silently capped by a tighter default.
    connect_timeout_s: Optional[float] = None
    request_timeout_s: Optional[float] = None
    retry: RetryOptions = RetryOptions(max_attempts=3, initial_backoff_s=0.05)
    breaker: BreakerOptions = BreakerOptions()
    # Read-fanout worker pool: open-loop traffic with slow/faulted
    # replicas queues here before any socket — size it for the offered
    # concurrency, not just the host count.
    fanout_workers: int = 16

    @property
    def effective_request_timeout_s(self) -> float:
        return self.timeout_s if self.request_timeout_s is None \
            else self.request_timeout_s

    @property
    def effective_connect_timeout_s(self) -> float:
        return self.effective_request_timeout_s if self.connect_timeout_s \
            is None else self.connect_timeout_s


class Session:
    """client.Session: Write/WriteTagged/Fetch/FetchTagged over a topology."""

    def __init__(self, topology, opts: SessionOptions = SessionOptions(),
                 device=None):
        """device: where fetched tiles decode (None: the CUDA card)."""
        self.device = resolve(device)
        self.topology = topology
        self.opts = opts
        self.health = HostHealth(opts.breaker)  # per-endpoint breakers/stats
        self._clients: Dict[str, HostClient] = {}
        self._queues: Dict[str, HostQueue] = {}
        self._lock = threading.RLock()  # _queue -> _client nest on this lock
        self._pool = ThreadPoolExecutor(max_workers=opts.fanout_workers)
        self._shard_set: Optional[ShardSet] = None
        if hasattr(topology, "subscribe"):
            topology.subscribe(lambda _m: None)  # keep map fresh
        self._open()

    def _open(self) -> None:
        """Start every fanout worker, then fill every host's connection
        pool on them (session.go Open fills its hosts' pools the same way,
        waiting at most its connect timeout): the session serves its first
        burst of concurrent calls without starting threads or dialing
        connections under it. A host that refuses keeps a lazy pool, as
        does a host that joins the topology later."""
        n = self.opts.fanout_workers
        # The executor starts a thread for each task submitted while none
        # is idle: tasks held at one barrier until all have started keep
        # every earlier worker busy, so each submit starts a new one.
        start = threading.Barrier(n)
        futures_wait([self._pool.submit(start.wait, 10.0) for _ in range(n)])
        m = self.topology.get()
        if m is not None:
            futures_wait([self._pool.submit(self._client(h)._fill)
                          for h in m.hosts.values()],
                         timeout=self.opts.effective_connect_timeout_s)

    # ---------------------------------------------------------------- routing

    def _map(self):
        m = self.topology.get()
        if m is None:
            raise ConnectionError("no topology available")
        return m

    def _shards(self) -> ShardSet:
        m = self._map()
        if self._shard_set is None or self._shard_set.num_shards != m.num_shards:
            self._shard_set = ShardSet(m.num_shards)
        return self._shard_set

    def _client(self, host) -> HostClient:
        with self._lock:
            c = self._clients.get(host.id)
            if c is None or c.endpoint != host.endpoint:
                if c is not None:
                    c.close()  # endpoint moved: release the old socket pool
                ep = host.endpoint
                c = HostClient(ep, self.opts.pool_size,
                               self.opts.effective_request_timeout_s,
                               connect_timeout=self.opts.effective_connect_timeout_s,
                               retry_opts=self.opts.retry,
                               breaker=self.health.breaker(ep),
                               on_outcome=lambda ok, _ep=ep:
                                   self.health.count(_ep, ok))
                self._clients[host.id] = c
            return c

    def _queue(self, host) -> HostQueue:
        with self._lock:
            q = self._queues.get(host.id)
            if q is None or q.client.endpoint != host.endpoint:
                if q is not None:
                    q.close()
                    q.client.close()
                q = HostQueue(self._client(host), self.opts.max_batch)
                self._queues[host.id] = q
            return q

    # ----------------------------------------------------------------- writes

    def write(self, ns: bytes, id: bytes, t_ns: int, value: float,
              tags: Optional[dict] = None, priority: Optional[str] = None):
        """session.go:867 Write: fan out to all shard replicas, wait quorum."""
        m = self._map()
        shard = self._shards().lookup(id)
        hosts = m.route_shard(shard)
        if not hosts:
            raise ConsistencyError(f"no hosts own shard {shard}")
        required = required_acks(self.opts.write_consistency, m.replica_factor)
        completion = _Completion(required=min(required, len(hosts)), total=len(hosts))
        op = _WriteOp(ns, id, t_ns, value, tags, completion, priority)
        for h in hosts:
            self._queue(h).enqueue(op)
        completion.wait(self.opts.timeout_s)

    def write_tagged(self, ns: bytes, id: bytes, tags: dict, t_ns: int, value: float):
        self.write(ns, id, t_ns, value, tags)

    def write_batch(self, ns: bytes, ids: Sequence[bytes], ts, vals,
                    tags: Optional[Sequence[Optional[dict]]] = None,
                    priority: Optional[str] = None):
        """Batched write: one quorum completion per datapoint, ops fanned
        through the same host queues (host queues re-batch per host)."""
        ts = np.asarray(ts, np.int64)
        vals = np.asarray(vals, np.float64)
        m = self._map()
        required = required_acks(self.opts.write_consistency, m.replica_factor)
        completions = []
        ss = self._shards()
        for i, sid in enumerate(ids):
            hosts = m.route_shard(ss.lookup(sid))
            if not hosts:
                raise ConsistencyError(f"no hosts own shard for {sid!r}")
            c = _Completion(required=min(required, len(hosts)), total=len(hosts))
            completions.append(c)
            op = _WriteOp(ns, sid, int(ts[i]), float(vals[i]),
                          tags[i] if tags else None, c, priority)
            for h in hosts:
                self._queue(h).enqueue(op)
        for c in completions:
            c.wait(self.opts.timeout_s)

    # ------------------------------------------------------------------ reads

    def _traced_call(self, span, client: HostClient, method: str, **kwargs):
        """HostClient call with `span` active on the worker thread: the
        fanout pool's threads don't inherit the submitting thread's
        span stack, so propagation into the wire frames (and the graft
        of server spans back onto `span`) needs the explicit handoff."""
        with tracing.TRACER.activate(span):
            return client.call(method, **kwargs)

    def fetch(self, ns: bytes, id: bytes, start_ns: int, end_ns: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch decoded + replica-merged datapoints for one series."""
        m = self._map()
        hosts = m.route_shard_readable(self._shards().lookup(id))
        required = min(required_reads(self.opts.read_consistency, m.replica_factor),
                       len(hosts)) or 1
        results, errs = [], []
        # One deadline bounds the whole quorum read and rides every RPC
        # frame: a faulted/slow replica returns DeadlineExceeded instead
        # of stalling past the caller's budget.
        dl = Deadline.after(self.opts.timeout_s)
        with tracing.span("client.fetch", replicas=len(hosts)) as csp:
            pending = {self._pool.submit(
                self._traced_call, csp, self._client(h), "fetch",
                _deadline=dl, ns=ns, id=id,
                start_ns=start_ns, end_ns=end_ns) for h in hosts}
            results, errs = self._await_quorum(pending, dl, required, results,
                                               errs)
        if len(results) < required:
            raise ConsistencyError(f"{len(results)}/{len(hosts)} reads, need {required}: {errs}")
        return merge_replica_points([r["t"] for r in results], [r["v"] for r in results],
                                    self.opts.conflict_strategy)

    def _await_quorum(self, pending, dl, required, results, errs):
        # Return as soon as the read consistency level is satisfied — a dead
        # replica must not stall a quorum-satisfiable read.
        while pending and len(results) < required:
            done, pending = futures_wait(
                pending, timeout=max(0.0, dl.remaining()),
                return_when=FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                try:
                    results.append(fut.result())
                except Exception as e:  # noqa: BLE001
                    errs.append(str(e))
        return results, errs

    def fetch_tagged(self, ns: bytes, query, start_ns: int, end_ns: int,
                     limit: int = 0) -> Dict[bytes, dict]:
        """session.go:1091 FetchTagged: fan out, accumulate per-shard
        consistency, decode + merge replicas. Returns id -> {tags, t, v}."""
        m = self._map()
        q = wire.query_to_wire(query)
        hosts = list(m.hosts.values())
        required = required_reads(self.opts.read_consistency, m.replica_factor)

        def coverage_met(ok_ids):
            # Per-shard accumulation (fetch_tagged_results_accumulator.go):
            # every owned shard needs >= required responders among its
            # READABLE owners — an initializing owner has no data and
            # must neither count toward nor be awaited for coverage.
            for shard in range(m.num_shards):
                owners = m.route_shard_readable(shard)
                if not owners:
                    continue
                got = sum(1 for h in owners if h.id in ok_ids)
                if got < min(required, len(owners)):
                    return False
            return True

        results, errs = [], []
        ok_ids = set()
        dl = Deadline.after(self.opts.timeout_s)
        with tracing.span("client.fetch_tagged", hosts=len(hosts)) as csp:
            pending = {self._pool.submit(
                self._traced_call, csp, self._client(h), "fetch_tagged",
                _deadline=dl, ns=ns,
                query=q, start_ns=start_ns, end_ns=end_ns,
                limit=limit): h for h in hosts}
            while pending and not coverage_met(ok_ids):
                done, _ = futures_wait(
                    set(pending), timeout=max(0.0, dl.remaining()),
                    return_when=FIRST_COMPLETED)
                if not done:
                    break
                for fut in done:
                    h = pending.pop(fut)
                    try:
                        results.append(fut.result())
                        ok_ids.add(h.id)
                    except Exception as e:  # noqa: BLE001
                        errs.append(f"{h.id}: {e}")
            csp.set_tag("responders", len(ok_ids))
        if not coverage_met(ok_ids):
            raise ConsistencyError(
                f"insufficient replica coverage ({len(ok_ids)} responders, "
                f"need {required} per shard): {errs}")
        merged: Dict[bytes, dict] = {}
        for r in results:
            for entry, (t, v) in zip(r["series"],
                                     self._columnar_points(r)):
                sid = entry["id"]
                cur = merged.get(sid)
                if cur is None:
                    merged[sid] = {"tags": entry["tags"], "t": t, "v": v}
                else:
                    if not cur["tags"] and entry["tags"]:
                        cur["tags"] = entry["tags"]
                    cur["t"], cur["v"] = merge_replica_points(
                        [cur["t"], t], [cur["v"], v], self.opts.conflict_strategy
                    )
        return merged

    def _columnar_points(self, r: dict) -> List[tuple]:
        """Per-series (t, v) from one host's COLUMNAR fetch_tagged frame:
        each sealed-block tile decodes in ONE batched kernel call on the
        session's device (decode.decode_tile — the wire twin of peer
        streaming's block tiles) and scatters row slices to its series;
        the buffer sidecar contributes offset-sliced views of the
        concatenated columns.
        Order per series is sealed blocks (ascending start) then the
        mutable buffer — the same precedence the per-series segment path
        had, so LAST_PUSHED conflict resolution is unchanged."""
        from .decode import decode_tile

        n = len(r["series"])
        parts_t: List[list] = [[] for _ in range(n)]
        parts_v: List[list] = [[] for _ in range(n)]
        for tile in sorted(r.get("tiles", ()), key=lambda d: d["bs"]):
            ts, vs = decode_tile(tile["words"], tile["npoints"],
                                 int(tile["window"]),
                                 int(tile["time_unit"]), device=self.device)
            npts = np.asarray(tile["npoints"]).tolist()
            for j, pos in enumerate(np.asarray(tile["rows"]).tolist()):
                k = npts[j]
                parts_t[pos].append(ts[j, :k])
                parts_v[pos].append(vs[j, :k])
        bufs = r.get("bufs")
        if bufs is not None:
            offs = np.asarray(bufs["offs"]).tolist()
            bt, bv = bufs["t"], bufs["v"]
            for j in range(n):
                if offs[j + 1] > offs[j]:
                    parts_t[j].append(bt[offs[j]:offs[j + 1]])
                    parts_v[j].append(bv[offs[j]:offs[j + 1]])
        strategy = self.opts.conflict_strategy
        return [merge_replica_points(parts_t[j], parts_v[j], strategy)
                for j in range(n)]

    def aggregate(self, ns: bytes, query, start_ns: int, end_ns: int,
                  name_only: bool = False, field_filter=(),
                  term_limit: int = 0) -> Dict[bytes, set]:
        """session.go Aggregate: fan out the tags-only aggregate RPC and
        union-merge per-host field dictionaries (no datapoints cross the
        wire). Requires at least one responsive host; results are
        best-effort-complete like query_ids."""
        m = self._map()
        q = wire.query_to_wire(query)
        merged: Dict[bytes, set] = {}
        ok = 0
        errs: List[str] = []
        for h in m.hosts.values():
            try:
                r = self._client(h).call(
                    "aggregate", ns=ns, query=q, start_ns=start_ns,
                    end_ns=end_ns, name_only=name_only,
                    field_filter=list(field_filter), term_limit=term_limit)
            except Exception as e:  # noqa: BLE001
                errs.append(f"{h.id}: {e}")
                continue
            ok += 1
            for f in r["fields"]:
                merged.setdefault(f["name"], set()).update(f["values"])
        if not ok:
            raise ConsistencyError(f"aggregate: no hosts responded: {errs}")
        if term_limit:
            merged = {k: set(sorted(v)[:term_limit]) for k, v in merged.items()}
        return merged

    def query_ids(self, ns: bytes, query, start_ns: int, end_ns: int) -> Dict[bytes, dict]:
        """ids + tags only (thrift Query / FetchTagged fetchData=false)."""
        m = self._map()
        out: Dict[bytes, dict] = {}
        for h in m.hosts.values():
            try:
                r = self._client(h).call("query", ns=ns, query=wire.query_to_wire(query),
                                         start_ns=start_ns, end_ns=end_ns)
            except Exception:  # noqa: BLE001
                continue
            for s in r["series"]:
                out.setdefault(s["id"], {"tags": s["tags"]})
        return out

    # ------------------------------------------------------------------ admin

    def fetch_blocks_metadata_from_peers(self, ns: bytes, shard: int, start_ns: int,
                                         end_ns: int, exclude_host: Optional[str] = None,
                                         deadline: Optional[Deadline] = None,
                                         errors: Optional[Dict[str, str]] = None):
        """AdminSession peer metadata streaming: paged metadata from every
        replica of a shard -> {host_id: {series_id: {tags, blocks}}}.

        A peer that fails in one of the typed transport ways (connection
        death, expired budget, deliberate shed) or relays a server-side
        error is SKIPPED — counted in the `session.peers` scope and
        reported into `errors` (host_id -> message) when the caller passes
        a dict — so bootstrap/repair see partial coverage instead of a
        silently smaller quorum. Anything untyped propagates."""
        m = self._map()
        out: Dict[str, Dict[bytes, dict]] = {}
        # Peer streaming reads block data: only readable owners hold any
        # (an initializing peer is itself still bootstrapping).
        for h in m.route_shard_readable(shard):
            if h.id == exclude_host:
                continue
            series: Dict[bytes, dict] = {}
            token = 0
            try:
                while token is not None:
                    r = self._client(h).call(
                        "fetch_blocks_metadata", _deadline=deadline, ns=ns,
                        shard=shard, start_ns=start_ns, end_ns=end_ns,
                        page_token=token)
                    for s in r["series"]:
                        series[s["id"]] = {"tags": s["tags"],
                                           "blocks": s["blocks"]}
                    token = r["next_page_token"]
            except PEER_SKIP_ERRORS + (RemoteError,) as e:
                _PEER_METRICS.counter("metadata_peer_errors").inc()
                if errors is not None:
                    errors[h.id] = f"{type(e).__name__}: {e}"
                continue
            out[h.id] = series
        return out

    def fetch_block_metadata_tiles_from_peers(
            self, ns: bytes, shard: int, start_ns: int, end_ns: int,
            exclude_host: Optional[str] = None,
            deadline: Optional[Deadline] = None,
            errors: Optional[Dict[str, str]] = None) -> Dict[str, dict]:
        """Columnar peer metadata streaming: per responding host,
        {"ids": [...], "tags": [...], "blocks": [{"bs", "pos", "sums"}]}
        with pages concatenated (block `pos` re-based onto the combined
        ids list). Same typed skip/count semantics as the per-series
        form."""
        m = self._map()
        out: Dict[str, dict] = {}
        for h in m.route_shard_readable(shard):
            if h.id == exclude_host:
                continue
            ids: List[bytes] = []
            tags: List[dict] = []
            blocks: List[dict] = []
            token = 0
            try:
                while token is not None:
                    r = self._client(h).call(
                        "fetch_block_metadata_tiles", _deadline=deadline,
                        ns=ns, shard=shard, start_ns=start_ns,
                        end_ns=end_ns, page_token=token)
                    offset = len(ids)
                    ids.extend(r["ids"])
                    tags.extend(r["tags"])
                    for b in r["blocks"]:
                        pos = np.asarray(b["pos"], np.int64)
                        blocks.append({"bs": int(b["bs"]),
                                       "pos": pos + offset,
                                       "sums": np.asarray(b["sums"],
                                                          np.int64)})
                    token = r["next_page_token"]
            except PEER_SKIP_ERRORS + (RemoteError,) as e:
                _PEER_METRICS.counter("metadata_peer_errors").inc()
                if errors is not None:
                    errors[h.id] = f"{type(e).__name__}: {e}"
                continue
            out[h.id] = {"ids": ids, "tags": tags, "blocks": blocks}
        return out

    @staticmethod
    def plan_block_majority(meta: Dict[str, dict]):
        """Vectorized checksum-majority planning over COLUMNAR peer
        metadata: group every (series, block, checksum) observation,
        vote per (series, block), and return, per block start, the
        winning checksum + the lowest-ranked host actually holding it
        for every series — plus the per-checksum ranked host lists a
        consumer needs to build failover chains.

        Returns (tags_by_sid, sids, hosts_list, per_bs) where per_bs maps
        block_start -> {"gids": int64[], "sums": int64[] (majority
        checksum per gid), "primary": int64[] (host rank holding it),
        "by_sum": {checksum: [host_id ranked]}} and `sids[g]` resolves a
        gid back to its series id."""
        tags_by_sid: Dict[bytes, dict] = {}
        gmap: Dict[bytes, int] = {}
        sids: List[bytes] = []
        hosts_list = list(meta)
        per_bs_rows: Dict[int, List[Tuple[int, np.ndarray, np.ndarray]]] = {}
        for rank, (host_id, m) in enumerate(meta.items()):
            ids = m["ids"]
            for sid, tg in zip(ids, m["tags"]):
                if tg and not tags_by_sid.get(sid):
                    tags_by_sid[sid] = tg
            garr = np.empty(len(ids), np.int64)
            for j, sid in enumerate(ids):
                g = gmap.get(sid)
                if g is None:
                    g = gmap[sid] = len(sids)
                    sids.append(sid)
                garr[j] = g
            for b in m["blocks"]:
                per_bs_rows.setdefault(int(b["bs"]), []).append(
                    (rank, garr[np.asarray(b["pos"], np.int64)],
                     np.asarray(b["sums"], np.int64)))
        per_bs: Dict[int, dict] = {}
        for bs, entries in per_bs_rows.items():
            g_all = np.concatenate([g for _r, g, _s in entries])
            c_all = np.concatenate([s for _r, _g, s in entries])
            r_all = np.concatenate([np.full(len(g), r, np.int64)
                                    for r, g, _s in entries])
            order = np.lexsort((r_all, c_all, g_all))
            g, c, r = g_all[order], c_all[order], r_all[order]
            # (gid, checksum) runs: count = votes, first host = the
            # lowest-ranked holder of that copy.
            new = np.empty(len(g), bool)
            new[0] = True
            np.logical_or(g[1:] != g[:-1], c[1:] != c[:-1], out=new[1:])
            starts = np.flatnonzero(new)
            run_g = g[starts]
            run_c = c[starts]
            run_r0 = r[starts]
            run_n = np.diff(np.append(starts, len(g)))
            # Winner per gid: the run sorting LAST under (gid, count,
            # checksum) — max votes, deterministic checksum tie-break.
            sel = np.lexsort((run_c, run_n, run_g))
            gs = run_g[sel]
            last = np.empty(len(sel), bool)
            if len(sel):
                np.not_equal(gs[1:], gs[:-1], out=last[:-1])
                last[-1] = True
            win = sel[last]
            # Ranked host list per checksum (any row with that checksum
            # in this block) for failover chains.
            pairs = np.unique(np.stack([c_all, r_all], 1), axis=0)
            by_sum: Dict[int, List[str]] = {}
            for cc, rr in pairs:
                by_sum.setdefault(int(cc), []).append(hosts_list[int(rr)])
            per_bs[bs] = {"gids": run_g[win], "sums": run_c[win],
                          "primary": run_r0[win], "by_sum": by_sum,
                          # EVERY (gid, checksum) observation (not just
                          # the winner): repair merges all distinct peer
                          # copies so divergence converges in one sweep
                          # per node instead of pairwise over many.
                          "run_g": run_g, "run_c": run_c,
                          "run_r0": run_r0}
        return tags_by_sid, sids, hosts_list, per_bs

    @staticmethod
    def holder_chain_builder(p: dict, hosts_list: List[str],
                             cross_checksum_tail: bool):
        """Memoized failover-chain factory over one plan_block_majority
        block entry: chain(checksum, first_holder_rank) -> ranked host
        list ([first holder] + every other host with the SAME checksum,
        then — when `cross_checksum_tail` — every remaining holder of
        any copy: any copy beats no copy once the whole same-sum set is
        dead). Chains are SHARED per (checksum, rank) combo and the
        cross-checksum tail is built once per block: per-series list
        construction is quadratic when checksums are per-row distinct.
        The single definition both the bootstrap and repair planners
        rank holders with."""
        by_sum = p["by_sum"]
        all_hosts = [h for h in hosts_list
                     if any(h in hl for hl in by_sum.values())] \
            if cross_checksum_tail and len(by_sum) > 1 else []
        combos: Dict[Tuple[int, int], List[str]] = {}

        def chain(cc: int, rr: int) -> List[str]:
            key = (cc, rr)
            lst = combos.get(key)
            if lst is None:
                first = hosts_list[rr]
                lst = [first] + [h for h in by_sum[cc] if h != first]
                if all_hosts:
                    lst += [h for h in all_hosts if h not in lst]
                combos[key] = lst
            return lst

        return chain

    def fetch_block_tiles(self, ns: bytes, shard: int,
                     holders: Dict[Tuple[bytes, int], List[str]],
                     deadline: Optional[Deadline] = None,
                     errors: Optional[Dict[str, str]] = None):
        """Stream columnar block tiles for a holder plan, one wave per
        holder rank: rank-0 requests batch per host; anything a host
        failed to serve (typed transport error, shed, or a row that
        vanished server-side) re-plans onto each key's next holder. Only
        keys every holder failed come back in `failed`."""
        m = self._map()
        hosts = {h.id: h for h in m.hosts.values()}
        tiles: Dict[int, List[dict]] = {}
        remaining = dict.fromkeys(holders)
        max_rank = max((len(v) for v in holders.values()), default=0)
        for rank in range(max_rank):
            if not remaining:
                break
            wave: Dict[str, Dict[int, List[bytes]]] = {}
            for (sid, bs) in remaining:
                hlist = holders[(sid, bs)]
                if rank < len(hlist) and hlist[rank] in hosts:
                    wave.setdefault(hlist[rank], {}).setdefault(
                        bs, []).append(sid)
            for host_id, by_bs in wave.items():
                reqs = [{"bs": bs, "ids": sids} for bs, sids in by_bs.items()]
                try:
                    r = self._client(hosts[host_id]).call(
                        "fetch_block_tiles", _deadline=deadline, ns=ns,
                        shard=shard, blocks=reqs)
                except PEER_SKIP_ERRORS + (RemoteError,) as e:
                    # This host's whole wave re-plans onto the next
                    # holders (keys stay in `remaining`).
                    _PEER_METRICS.counter("block_fetch_peer_errors").inc()
                    if errors is not None:
                        errors[host_id] = f"{type(e).__name__}: {e}"
                    continue
                for tile in r["blocks"]:
                    ids = tile["ids"]
                    if not len(ids):
                        continue
                    tiles.setdefault(int(tile["bs"]), []).append(tile)
                    for sid in ids:
                        remaining.pop((sid, int(tile["bs"])), None)
        failed = sorted(remaining)
        if failed:
            _PEER_METRICS.counter("blocks_unfetchable").inc(len(failed))
        return tiles, failed

    def fetch_block_tiles_from_peers(self, ns: bytes, shard: int, start_ns: int,
                                     end_ns: int,
                                     exclude_host: Optional[str] = None,
                                     deadline: Optional[Deadline] = None,
                                     errors: Optional[Dict[str, str]] = None,
                                     meta_errors: Optional[Dict[str, str]]
                                     = None):
        """Columnar peer bootstrap streaming: diff peer metadata, plan by
        checksum majority, stream whole-block tiles ([rows, max_words]
        word matrices + per-row nbits/npoints columns — one ndarray per
        (host, block) instead of one dict per series).

        Returns (tiles, tags_by_sid, failed):
          tiles        {block_start: [tile dict]}
          tags_by_sid  {series_id: tags} from the metadata phase
          failed       [(series_id, block_start)] every holder failed —
                       the partial-coverage surface bootstrap subtracts
                       from its claim.

        `meta_errors` collects METADATA-phase peer failures separately
        from block-fetch failures (`errors`): a peer skipped during
        metadata may have held blocks nobody else has, so its loss means
        the plan itself — not just some fetches — is incomplete, and
        callers claiming coverage must treat it as such."""
        meta = self.fetch_block_metadata_tiles_from_peers(
            ns, shard, start_ns, end_ns, exclude_host, deadline,
            meta_errors if meta_errors is not None else errors)
        tags_by_sid, sids, hosts_list, per_bs = self.plan_block_majority(meta)
        holders: Dict[Tuple[bytes, int], List[str]] = {}
        for bs, p in per_bs.items():
            chain = self.holder_chain_builder(p, hosts_list,
                                              cross_checksum_tail=True)
            for gi, cc, rr in zip(p["gids"].tolist(), p["sums"].tolist(),
                                  p["primary"].tolist()):
                holders[(sids[gi], bs)] = chain(cc, rr)
        tiles, failed = self.fetch_block_tiles(ns, shard, holders, deadline,
                                               errors)
        return tiles, tags_by_sid, failed

    def fetch_bootstrap_blocks_from_peers(self, ns: bytes, shard: int, start_ns: int,
                                          end_ns: int, exclude_host: Optional[str] = None,
                                          deadline: Optional[Deadline] = None
                                          ) -> Dict[bytes, dict]:
        """Per-series view of peer bootstrap streaming (the session
        FetchBootstrapBlocksFromPeers shape, kept for callers that want
        row dicts): same tile fetch + holder fallback underneath.

        Returns {series_id: {"tags": .., "blocks": [wire block dicts]}}."""
        tiles, tags_by_sid, _failed = self.fetch_block_tiles_from_peers(
            ns, shard, start_ns, end_ns, exclude_host, deadline)
        out: Dict[bytes, dict] = {}
        for bs, tlist in sorted(tiles.items()):
            for tile in tlist:
                words = np.asarray(tile["words"])
                nbits = np.asarray(tile["nbits"])
                npoints = np.asarray(tile["npoints"])
                for i, sid in enumerate(tile["ids"]):
                    e = out.setdefault(
                        sid, {"tags": tags_by_sid.get(sid) or {}, "blocks": []})
                    e["blocks"].append({
                        "bs": bs, "words": words[i], "nbits": int(nbits[i]),
                        "npoints": int(npoints[i]),
                        "window": int(tile["window"]),
                        "time_unit": int(tile["time_unit"]),
                    })
        return out

    def fetch_block_tiles_from_host(self, host_id: str, ns: bytes, shard: int,
                                    blocks: List[dict],
                                    deadline: Optional[Deadline] = None) -> dict:
        """Columnar tiles from one specific replica (repair streams from
        the host holding the majority checksum); blocks =
        [{"bs": block_start, "ids": [series_id]}]."""
        m = self._map()
        host = m.hosts.get(host_id)
        if host is None:
            raise ConnectionError(f"unknown host {host_id}")
        return self._client(host).call("fetch_block_tiles", _deadline=deadline,
                                       ns=ns, shard=shard, blocks=blocks)

    def fetch_blocks_from_host(self, host_id: str, ns: bytes, shard: int,
                               requests: List[dict]) -> dict:
        """Raw encoded blocks from one specific replica (per-series
        request shape; the batched repair path uses
        fetch_block_tiles_from_host)."""
        m = self._map()
        host = m.hosts.get(host_id)
        if host is None:
            raise ConnectionError(f"unknown host {host_id}")
        return self._client(host).call("fetch_blocks", ns=ns, shard=shard,
                                       requests=requests)

    def truncate(self, ns: bytes) -> int:
        m = self._map()
        total = 0
        for h in m.hosts.values():
            total += self._client(h).call("truncate", ns=ns)
        return total

    def close(self):
        with self._lock:
            for q in self._queues.values():
                q.close()
            for c in self._clients.values():
                c.close()
            self._queues.clear()
            self._clients.clear()
        self._pool.shutdown(wait=False)
