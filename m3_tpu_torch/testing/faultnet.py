"""Seeded fault-injecting transport for the framed wire (host copy of
m3_tpu/testing/faultnet.py) — the chaos layer the cluster harness can put
in front of every node.

A FaultProxy sits between any framed-wire client and server (node RPC,
KV service, msg producer/consumer, remote query storage — they all speak
<u32 length><body> frames) and injects faults at FRAME granularity, so
an injected fault is always a well-defined protocol event:

  refuse     the connection is torn down at accept (RST) before any
             bytes flow — a refused/immediately-dead endpoint.
  reset      a frame is forwarded PARTIALLY, then the connection is
             reset (SO_LINGER 0 -> RST): peer sees ECONNRESET mid-frame.
  truncate   a frame is forwarded partially, then closed cleanly: peer
             sees EOF mid-frame (wire.WireTruncated).
  delay      the frame is held for `delay_s` before forwarding — slow
             network / stalled server.
  duplicate  the frame is forwarded twice — duplicate delivery, the
             at-least-once redelivery hazard.

Determinism: every decision comes from a private random.Random stream
keyed by (plan.seed, connection index, direction, frame index) — thread
scheduling, port numbers and wall time never touch it, so one seed IS
one fault schedule. The proxy records each decision in `decisions`
keyed by (connection, direction) for schedule assertions.
"""

from __future__ import annotations

import dataclasses
import random
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["FaultPlan", "FaultProxy", "NO_FAULT"]

NO_FAULT = "ok"
_U32 = struct.Struct("<I")

# direction tags: client->upstream and upstream->client
C2S, S2C = "c2s", "s2c"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-event fault probabilities. A single uniform draw per event is
    tested against cumulative thresholds in a FIXED order (reset,
    truncate, delay, duplicate), so the schedule for a seed is stable
    even when probabilities change only in magnitude."""

    seed: int = 0
    refuse: float = 0.0      # per CONNECTION, decided at accept
    reset: float = 0.0       # per frame
    truncate: float = 0.0    # per frame
    delay: float = 0.0       # per frame
    duplicate: float = 0.0   # per frame
    delay_s: float = 0.05
    # Which directions frame faults apply to; refusal is direction-less.
    directions: Tuple[str, ...] = (C2S, S2C)

    def _rng(self, conn: int, direction: str) -> random.Random:
        return random.Random(f"{self.seed}/{conn}/{direction}")

    def connection_refused(self, conn: int) -> bool:
        return random.Random(f"{self.seed}/{conn}/accept").random() < self.refuse

    def decide(self, rng: random.Random, direction: str) -> str:
        r = rng.random()  # exactly ONE draw per frame keeps schedules aligned
        if direction not in self.directions:
            return NO_FAULT
        edge = self.reset
        if r < edge:
            return "reset"
        edge += self.truncate
        if r < edge:
            return "truncate"
        edge += self.delay
        if r < edge:
            return "delay"
        edge += self.duplicate
        if r < edge:
            return "duplicate"
        return NO_FAULT

    def schedule(self, conn: int, direction: str, n: int) -> List[str]:
        """First n frame decisions for one (connection, direction) stream
        — the pure function tests assert determinism against."""
        rng = self._rng(conn, direction)
        return [self.decide(rng, direction) for _ in range(n)]


class FaultProxy:
    """Frame-aware fault-injecting TCP proxy in front of one upstream
    endpoint. Start it, point any framed-wire client at `.endpoint`, and
    the plan's faults happen to real traffic."""

    def __init__(self, upstream: str, plan: FaultPlan = FaultPlan(),
                 host: str = "127.0.0.1", port: int = 0):
        self.upstream = upstream
        self.plan = plan
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._closed = False
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_counter = 0
        self._lock = threading.Lock()
        # (conn index, direction) -> [fault decisions in frame order]
        self.decisions: Dict[Tuple[int, str], List[str]] = {}
        self.faults_injected = 0
        self.connections_refused = 0

    # ------------------------------------------------------------- lifecycle

    @property
    def endpoint(self) -> str:
        h, p = self._listener.getsockname()
        return f"{h}:{p}"

    def start(self) -> "FaultProxy":
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def close(self):
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass

    # ---------------------------------------------------------------- accept

    def _accept_loop(self):
        while not self._closed:
            try:
                client, _addr = self._listener.accept()
            except OSError:
                return
            with self._lock:
                conn_idx = self._conn_counter
                self._conn_counter += 1
            if self.plan.connection_refused(conn_idx):
                with self._lock:
                    self.connections_refused += 1
                    self.faults_injected += 1
                _rst_close(client)
                continue
            threading.Thread(target=self._serve, args=(client, conn_idx),
                             daemon=True).start()

    def _serve(self, client: socket.socket, conn_idx: int):
        try:
            host, _, port = self.upstream.rpartition(":")
            upstream = socket.create_connection((host, int(port)), timeout=10)
        except OSError:
            _rst_close(client)
            return
        # Short socket timeouts + a shared dead flag instead of blocking
        # reads: a fault on one direction must tear down BOTH pump
        # threads promptly. (A plain close() while the sibling thread sits
        # in recv() on the same fd defers the kernel-side FIN/RST until
        # that recv returns — the peer would never see the fault.)
        dead = threading.Event()
        for s in (client, upstream):
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            s.settimeout(0.1)
        for src, dst, direction in ((client, upstream, C2S),
                                    (upstream, client, S2C)):
            threading.Thread(target=self._pump,
                             args=(src, dst, conn_idx, direction, dead),
                             daemon=True).start()

    # ----------------------------------------------------------------- pump

    def _pump(self, src: socket.socket, dst: socket.socket,
              conn_idx: int, direction: str, dead: threading.Event):
        rng = self.plan._rng(conn_idx, direction)
        with self._lock:
            log = self.decisions.setdefault((conn_idx, direction), [])
        try:
            while not self._closed and not dead.is_set():
                header = _read_exact(src, 4, dead)
                if header is None:
                    break  # clean close between frames (or conn torn down)
                (n,) = _U32.unpack(header)
                body = _read_exact(src, n, dead)
                if body is None:
                    break  # upstream died mid-frame: relay the break below
                fault = self.plan.decide(rng, direction)
                log.append(fault)
                if fault != NO_FAULT:
                    with self._lock:
                        self.faults_injected += 1
                if fault == "delay":
                    time.sleep(self.plan.delay_s)
                    _send_all(dst, header + body)
                elif fault == "duplicate":
                    _send_all(dst, header + body)
                    _send_all(dst, header + body)
                elif fault == "truncate":
                    # half the frame, then clean FIN: the peer's next read
                    # sees EOF mid-frame -> wire.WireTruncated
                    _send_all(dst, header + body[: n // 2])
                    dead.set()
                    _shutdown_quiet(dst)
                    break
                elif fault == "reset":
                    _send_all(dst, header + body[: n // 2])
                    dead.set()
                    # SO_LINGER 0: once the sibling pump's recv times out
                    # and releases the fd, the kernel emits RST — the peer
                    # sees ECONNRESET mid-frame, not a clean EOF.
                    _rst_close(dst)
                    _shutdown_quiet(src)
                    return
                else:
                    _send_all(dst, header + body)
        except OSError:
            pass
        finally:
            dead.set()
            for s in (src, dst):
                _shutdown_quiet(s)
                _close_quiet(s)


def _read_exact(sock: socket.socket, n: int,
                dead: threading.Event) -> Optional[bytes]:
    """n bytes or None on EOF/teardown (clean close OR mid-read — the pump
    relays the close either way; fault semantics come from the injector
    side). Periodic timeouts poll the dead flag so a fault on the other
    direction unblocks this one."""
    parts = []
    while n:
        try:
            chunk = sock.recv(min(n, 1 << 20))
        except socket.timeout:
            if dead.is_set():
                return None
            continue
        except OSError:
            return None
        if not chunk:
            return None
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def _send_all(sock: socket.socket, data: bytes):
    """sendall that tolerates the 0.1s poll timeout on slow drains."""
    view = memoryview(data)
    while view:
        try:
            sent = sock.send(view)
        except socket.timeout:
            continue
        view = view[sent:]


def _rst_close(sock: socket.socket):
    """Close with RST (SO_LINGER 0) so the peer sees ECONNRESET, not FIN."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    _close_quiet(sock)


def _shutdown_quiet(sock: socket.socket):
    """shutdown(2) is not deferred by a sibling thread's blocked recv the
    way close(2) is: the FIN goes out NOW and blocked reads wake with EOF."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass


def _close_quiet(sock: socket.socket):
    try:
        sock.close()
    except OSError:
        pass
