"""Producer: ref-counted buffered publish with at-least-once delivery
(host copy of m3_tpu/msg/producer.py, no device; reference:
src/msg/producer/{producer,buffer}.go and producer/writer/ —
message_writer.go retry-until-ack, consumer_service_writer.go per-service
fan-out, shard_writer.go shard->instance routing).

A published message is ref-counted across the topic's consumer services;
each service's message writer keeps it queued until that service acks it,
retrying over the connection with backoff. The buffer enforces a max-bytes
cap by dropping the oldest unacked messages (buffer.go dropOldest), which
bounds memory during consumer outages at the cost of redelivery loss —
the same tradeoff the reference makes.

One difference from the reference: the producer identity stamped on every
frame is drawn from a generator the caller may pass (`identity_rng`), not
from the process-global `random`; by default each producer draws from a
generator of its own, seeded from the OS, so two producers never share an
identity, while a test can fix one.
"""

from __future__ import annotations

import random as _random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..cluster.placement import Placement, ShardState
from ..rpc import wire
from ..utils import tracing
from ..utils.limits import Backpressure
from ..utils.retry import Breaker, BreakerOptions, Retrier, RetryOptions
from .topic import ConsumptionType, Topic


class _Message:
    __slots__ = ("id", "shard", "value", "refs", "size", "trace")

    def __init__(self, mid: int, shard: int, value: bytes, refs: int,
                 trace: Optional[dict] = None):
        self.id = mid
        self.shard = shard
        self.value = value
        self.refs = refs
        self.size = len(value)
        # Wire span context captured at PUBLISH time (None when the
        # publisher was unsampled): redeliveries re-send the original
        # context, so the consumer's span joins the producing trace no
        # matter which retry pass delivered it.
        self.trace = trace


class _Tracked:
    """Per-WRITER send state for one message. The _Message itself is
    shared across every consumer service's writer (ref-counted), so
    redelivery state must live here: writer A's successful send must not
    push writer B's first delivery down B's backoff schedule."""

    __slots__ = ("msg", "due_at", "attempts")

    def __init__(self, msg: _Message):
        self.msg = msg
        self.due_at = 0    # monotonic ns when the next resend is due
        self.attempts = 0  # this writer's frame writes; drives its backoff


def _writer_breaker_opts(retry_delay_s: float) -> BreakerOptions:
    """Breaker tuned to the writer's retry cadence: trips after a burst
    of connect/send failures, probes again after a few retry ticks."""
    return BreakerOptions(window=8, failure_ratio=0.5, min_samples=4,
                          cooldown_s=max(0.25, 2.0 * retry_delay_s))


class MessageWriter:
    """Per-connection write loop with ack tracking (writer/message_writer.go):
    messages stay queued until acked; the retry pass resends each message
    on its OWN exponential-backoff schedule (attempt n redelivers after
    backoff(n), not a flat cutoff), and a breaker stops the pass from
    hammering a dead consumer endpoint with reconnects."""

    def __init__(self, connect: Callable[[], "wire.socket.socket"],
                 retry_delay_s: float = 0.2,
                 retry_opts: Optional[RetryOptions] = None,
                 breaker_opts: Optional[BreakerOptions] = None,
                 src: Optional[int] = None,
                 max_unacked: int = 65536):
        self._connect = connect
        self._retry_delay_s = retry_delay_s
        # Hard cap on the unacked/redelivery map: an unreachable consumer
        # must not grow this without bound (the byte cap upstream bounds
        # bytes; this bounds ENTRIES, which survive drop-oldest races and
        # dominate memory for small payloads). At the cap, write()
        # surfaces typed Backpressure so publish() callers back off.
        self._max_unacked = max(1, max_unacked)
        self._src = src  # producer identity riding each frame (dedup key)
        # backoff_for() only — the scheduled scan IS the retry loop, so
        # the Retrier here is the schedule, not the driver.
        self._backoff = Retrier(retry_opts if retry_opts is not None
                                else RetryOptions(
                                    initial_backoff_s=retry_delay_s,
                                    backoff_factor=2.0,
                                    max_backoff_s=32.0 * retry_delay_s))
        self._breaker = Breaker(breaker_opts if breaker_opts is not None
                                else _writer_breaker_opts(retry_delay_s))
        self._lock = threading.Lock()
        # Serializes every socket write + connect/drop: publish() and the
        # producer's background retry pass both call _send on this writer,
        # and two interleaved sendall byte streams would desync the frame
        # protocol at the consumer (and a connect race would leak a socket
        # plus its ack-reader thread).
        self._io_lock = threading.Lock()
        self._queue: Dict[int, _Tracked] = {}
        self._sock = None
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        self._on_ack: Optional[Callable[[_Message], None]] = None
        self.acked = 0
        self.retried = 0

    def write(self, msg: _Message):
        with self._lock:
            if msg.id not in self._queue and \
                    len(self._queue) >= self._max_unacked:
                raise Backpressure(
                    f"message writer unacked queue full "
                    f"({len(self._queue)}/{self._max_unacked}): "
                    "consumer unreachable or slow — back off")
            # dict.setdefault (not .get) also keeps m3lint's queue-get
            # heuristic from reading this dict named _queue as a Queue
            t = self._queue.setdefault(msg.id, _Tracked(msg))
        self._send(t)

    def _ensure_conn(self) -> bool:
        if self._closed:
            return False  # a late retry pass must not reconnect after close
        if self._sock is not None:
            return True
        # Breaker gate on RECONNECT only (an established connection keeps
        # sending): once the endpoint has eaten its failure budget, retry
        # passes stop paying for refused connects until the cooldown probe.
        if not self._breaker.allow():
            return False
        try:
            self._sock = self._connect()
        except Exception:  # noqa: BLE001 — user-supplied connect callable
            # ANY connect failure must record the outcome: allow() may
            # have granted the single half-open probe slot, and an
            # unrecorded exit would wedge the breaker half-open.
            self._sock = None
            self._breaker.record_failure()
            return False
        self._breaker.record_success()
        self._reader = threading.Thread(target=self._read_acks, daemon=True)
        self._reader.start()
        return True

    def _send(self, t: _Tracked) -> bool:
        msg = t.msg
        with self._io_lock:
            if not self._ensure_conn():
                return False
            try:
                # DELIBERATE I/O under _io_lock: the lock's entire job is
                # serializing frame writes on the shared connection so two
                # writers can't interleave a frame; queue state uses the
                # separate _lock, which is never held here.
                frame = {
                    "t": "msg", "shard": msg.shard, "id": msg.id,
                    "sent_at": time.monotonic_ns(), "value": msg.value,
                }
                if msg.trace is not None:
                    frame[wire.TRACE_KEY] = msg.trace
                if self._src is not None:
                    # producer identity: consumers key duplicate-delivery
                    # dedup on (src, id) so a RESTARTED producer reusing
                    # ids 0..N can never collide into a silent drop
                    frame["src"] = self._src
                wire.write_frame(self._sock, frame)  # m3lint: disable=lock-held-blocking-call
                t.attempts += 1
                # The due time is rolled ONCE per send (jitter included):
                # the scan below is then one integer compare per message,
                # and a re-rolled jitter can't fire a resend early.
                t.due_at = time.monotonic_ns() + int(
                    self._backoff.backoff_for(t.attempts) * 1e9)
                return True
            except OSError:
                self._breaker.record_failure()
                self._drop_conn_locked()
                return False

    def _drop_conn(self):
        with self._io_lock:
            self._drop_conn_locked()

    def _drop_conn_locked(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _read_acks(self):
        sock = self._sock
        try:
            while not self._closed and sock is self._sock:
                frame = wire.read_dict_frame(sock)
                if frame.get("t") != "ack":
                    continue
                ids = frame.get("ids") or ()
                with self._lock:
                    acked = [self._queue.pop(i) for i in ids
                             if i in self._queue]
                for t in acked:
                    self.acked += 1
                    if self._on_ack is not None:
                        self._on_ack(t.msg)
        except (ConnectionError, OSError, ValueError):
            # the typed transport set: reset/truncation, socket errors,
            # malformed ack frame (desync) — all mean this stream is done.
            # Anything ELSE is a real bug in ack handling and should
            # surface loudly, not be eaten as a fake connection reset.
            pass
        finally:
            # A dead ack reader MUST take the connection with it: leaving
            # _sock set would let writes keep landing on a desynced stream
            # whose acks are never read — with the background retry loop
            # that becomes an infinite resend of every queued message.
            # (Under the io lock so it can't close a freshly reconnected
            # socket it compares against mid-swap.)
            with self._io_lock:
                if sock is self._sock:
                    self._drop_conn_locked()

    def retry_unacked(self):
        """One retry pass (message_writer.go scanMessageQueue). A message
        is due when its per-message backoff has elapsed: attempt n waits
        backoff(n) after the n-th send (due_at, stamped at send time), so
        a hot-looping pump cannot flat-resend the whole queue every tick
        and the scan stays one integer compare per queued message."""
        now = time.monotonic_ns()
        with self._lock:
            stale = [t for t in self._queue.values() if now >= t.due_at]
        for t in stale:
            self.retried += 1
            if not self._send(t):
                break

    @property
    def breaker(self) -> Breaker:
        return self._breaker

    def unacked(self) -> int:
        with self._lock:
            return len(self._queue)

    def unacked_messages(self) -> List[_Message]:
        with self._lock:
            return [t.msg for t in self._queue.values()]

    def forget(self, mid: int) -> Optional[_Message]:
        with self._lock:
            t = self._queue.pop(mid, None)
            return t.msg if t is not None else None

    def close(self):
        self._closed = True
        self._drop_conn()


class ConsumerServiceWriter:
    """Routes each shard to the consumer-service instance owning it per the
    service's placement (writer/consumer_service_writer.go), one MessageWriter
    per instance endpoint."""

    def __init__(self, service_id: str,
                 placement_getter: Callable[[], Optional[Placement]],
                 connect: Callable[[str], "wire.socket.socket"],
                 retry_delay_s: float = 0.2,
                 retry_opts: Optional[RetryOptions] = None,
                 breaker_opts: Optional[BreakerOptions] = None,
                 src: Optional[int] = None,
                 max_unacked: int = 65536):
        self.service_id = service_id
        self._placement = placement_getter
        self._connect = connect
        self._retry_delay_s = retry_delay_s
        self._retry_opts = retry_opts
        self._breaker_opts = breaker_opts
        self._src = src
        self._max_unacked = max(1, max_unacked)
        self._writers: Dict[str, MessageWriter] = {}
        self._on_ack: Optional[Callable[[_Message], None]] = None
        # Messages with no routable instance yet (placement missing or shard
        # unowned): re-routed on every retry pass so at-least-once holds
        # across placement gaps (consumer_service_writer.go re-resolves the
        # placement on update).
        self._unrouted: Dict[int, _Message] = {}
        self._lock = threading.Lock()

    def _writer_for(self, endpoint: str) -> MessageWriter:
        w = self._writers.get(endpoint)
        if w is None:
            w = MessageWriter(lambda: self._connect(endpoint),
                              self._retry_delay_s,
                              retry_opts=self._retry_opts,
                              breaker_opts=self._breaker_opts,
                              src=self._src,
                              max_unacked=self._max_unacked)
            w._on_ack = self._on_ack
            self._writers[endpoint] = w
        return w

    def write(self, msg: _Message) -> bool:
        if self._route(msg):
            return True
        with self._lock:
            # The unrouted holding pen is bounded like the writer queues:
            # a long placement gap must surface as backpressure, not as
            # an unbounded map of every message published meanwhile.
            if msg.id not in self._unrouted and \
                    len(self._unrouted) >= self._max_unacked:
                raise Backpressure(
                    f"{self.service_id}: unrouted buffer full "
                    f"({len(self._unrouted)}/{self._max_unacked}): "
                    "no routable placement — back off")
            self._unrouted[msg.id] = msg
        return False

    def _route(self, msg: _Message) -> bool:
        p = self._placement()
        if p is None:
            return False
        shard = msg.shard % p.num_shards
        for inst in p.replicas_for(shard, states=(ShardState.INITIALIZING,
                                                  ShardState.AVAILABLE)):
            self._writer_for(inst.endpoint).write(msg)
            return True  # shared consumption: one instance per shard
        return False

    def retry_unacked(self):
        with self._lock:
            pending = list(self._unrouted.values())
        for msg in pending:
            if self._route(msg):
                with self._lock:
                    self._unrouted.pop(msg.id, None)
        for w in self._writers.values():
            w.retry_unacked()

    def unacked(self) -> int:
        with self._lock:
            unrouted = len(self._unrouted)
        return unrouted + sum(w.unacked() for w in self._writers.values())

    def forget(self, mid: int):
        with self._lock:
            self._unrouted.pop(mid, None)
        for w in self._writers.values():
            w.forget(mid)

    def close(self):
        for w in self._writers.values():
            w.close()


class Producer:
    """Topic-level publish API (producer/producer.go): ref-counts each message
    across consumer services, enforces the buffer cap with drop-oldest."""

    def __init__(self, topic: Topic,
                 service_placements: Dict[str, Callable[[], Optional[Placement]]],
                 connect: Callable[[str], "wire.socket.socket"] = None,
                 max_buffer_bytes: int = 64 * 1024 * 1024,
                 retry_delay_s: float = 0.2,
                 retry_opts: Optional[RetryOptions] = None,
                 breaker_opts: Optional[BreakerOptions] = None,
                 high_watermark: float = 0.8,
                 max_unacked: int = 65536,
                 identity_rng: Optional[_random.Random] = None):
        self.topic = topic
        self._retry_delay_s = retry_delay_s
        self._next_id = 0
        self._max_buffer_bytes = max_buffer_bytes
        # Backpressure BEFORE loss: past the high watermark publish()
        # raises the typed Backpressure so producers back off while the
        # retry pass drains; drop-oldest above remains the hard cap for
        # what's already buffered (the reference's tradeoff), but a
        # well-behaved publisher never reaches it. A watermark > 1.0
        # disables the backpressure gate, restoring the reference's pure
        # drop-oldest semantics for callers that prefer loss to refusal.
        self._hwm_bytes = int(max_buffer_bytes * high_watermark)
        self._max_unacked = max_unacked
        self._buffered_bytes = 0
        self._lock = threading.Lock()
        # id -> message, insertion-ordered (dicts preserve order) so
        # drop-oldest pops the front and acks remove in O(1).
        self._order: Dict[int, _Message] = {}
        connect = connect or _default_connect
        # Random producer identity (63-bit): rides every frame so the
        # consumer's duplicate-delivery dedup can never confuse THIS
        # producer's id space with a restarted/parallel producer's.
        rng = identity_rng if identity_rng is not None else _random.Random()
        self._src = rng.getrandbits(63)
        self._service_writers = [
            ConsumerServiceWriter(cs.service_id, service_placements[cs.service_id],
                                  connect, retry_delay_s,
                                  retry_opts=retry_opts,
                                  breaker_opts=breaker_opts,
                                  src=self._src,
                                  max_unacked=max_unacked)
            for cs in topic.consumer_services
        ]
        for w in self._service_writers:
            w._on_ack = self._message_acked
        self.dropped_oldest = 0
        self.backpressure_rejections = 0
        # The reference's message writer scans its queue on a schedule
        # (writer/message_writer.go scanMessageQueue loop) — without this
        # thread, at-least-once only held if the CALLER remembered to pump
        # retry_unacked(), and no service did: an unacked message (handler
        # failure, dropped ack) was never redelivered. Found by driving a
        # failing consumer handler live.
        self._closed = False
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="producer-retry", daemon=True)
        self._retry_thread.start()

    def publish(self, shard: int, value: bytes) -> int:
        """Publish one message to every consumer service; returns message
        id. Raises the typed Backpressure past the buffer's high
        watermark (or a writer's unacked-entry cap): the producer is
        outrunning its consumers and the caller must back off — retrying
        hot would only push the buffer into drop-oldest data loss."""
        with self._lock:
            if self._buffered_bytes + len(value) > self._hwm_bytes:
                self.backpressure_rejections += 1
                raise Backpressure(
                    f"producer buffer past high watermark "
                    f"({self._buffered_bytes + len(value)}/{self._hwm_bytes} "
                    f"bytes buffered): consumers behind — back off")
            mid = self._next_id
            self._next_id += 1
            cur = tracing.TRACER.current()
            msg = _Message(mid, shard, value, refs=len(self._service_writers),
                           trace=(cur.context().to_wire()
                                  if cur is not None else None))
            self._order[mid] = msg
            self._buffered_bytes += msg.size
        try:
            for w in self._service_writers:
                w.write(msg)
        except Backpressure:
            # A writer-level cap fired mid-fanout: unwind this message
            # everywhere (partial enqueue must not be retried-until-acked
            # on some services while the caller thinks it failed).
            with self._lock:
                if self._order.pop(mid, None) is not None:
                    self._buffered_bytes -= msg.size
                self.backpressure_rejections += 1
            for w in self._service_writers:
                w.forget(mid)
            raise
        # Enforce after the writes: if this (or any) message is evicted by
        # drop-oldest, _enforce_buffer forgets it from every writer queue as
        # well, so an over-cap message is not retried-until-acked and the
        # memory bound holds.
        self._enforce_buffer()
        # The writes above run outside the lock, so a concurrent publisher's
        # _enforce_buffer may have evicted-and-forgotten this id before the
        # writes landed; if so, forget the now-untracked copies.
        with self._lock:
            evicted = mid not in self._order
        if evicted:
            for w in self._service_writers:
                w.forget(mid)
        return mid

    def _message_acked(self, msg: _Message):
        with self._lock:
            msg.refs -= 1
            if msg.refs <= 0 and self._order.pop(msg.id, None) is not None:
                self._buffered_bytes -= msg.size

    def _enforce_buffer(self):
        """Drop oldest until under the cap (producer/buffer.go dropOldest)."""
        victims = []
        with self._lock:
            while self._buffered_bytes > self._max_buffer_bytes and self._order:
                mid, victim = next(iter(self._order.items()))
                del self._order[mid]
                self._buffered_bytes -= victim.size
                self.dropped_oldest += 1
                victims.append(mid)
        for mid in victims:
            for w in self._service_writers:
                w.forget(mid)

    def _retry_loop(self):
        while not self._closed:
            # DELIBERATE fixed cadence: this is the SCAN SCHEDULER, not
            # the retry policy — each message's due time comes from its
            # own exponential backoff schedule in retry_unacked, and the
            # writers' breakers gate reconnects. (message_writer.go's
            # scanMessageQueue ticks the same way.)
            time.sleep(self._retry_delay_s)  # m3lint: disable=raw-sleep-retry
            if self._closed:
                return
            try:
                self.retry_unacked()
            except Exception:  # noqa: BLE001 - the scan must outlive flaps
                pass

    def retry_unacked(self):
        for w in self._service_writers:
            w.retry_unacked()

    def unacked(self) -> int:
        return sum(w.unacked() for w in self._service_writers)

    def buffered_bytes(self) -> int:
        with self._lock:
            return self._buffered_bytes

    def close(self):
        self._closed = True
        for w in self._service_writers:
            w.close()
        if self._retry_thread.is_alive():
            self._retry_thread.join(timeout=2 * self._retry_delay_s + 1)


def _default_connect(endpoint: str):
    import socket as _socket

    host, _, port = endpoint.rpartition(":")
    s = _socket.create_connection((host, int(port)), timeout=5.0)
    s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    return s
