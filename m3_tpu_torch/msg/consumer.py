"""Consumer: TCP listener for framed messages with explicit acks (host
copy of m3_tpu/msg/consumer.py, no device; reference:
src/msg/consumer/{consumer,handlers}.go — proto-framed Message/Ack exchange,
the handler acks after processing so redelivery stops).

Wire messages ride the shared framed codec (m3_tpu_torch.rpc.wire):
  {"t": "msg", "shard": i64, "id": i64, "sent_at": i64, "value": bytes,
   "src": i64?}                     ("src" = producer identity, optional)
  {"t": "ack", "ids": [i64, ...]}   (consumer -> producer, batched)
"""

from __future__ import annotations

import socket
import socketserver
import traceback
import threading
from collections import deque
from typing import Callable, List, Optional

from ..rpc import wire
from ..utils import tracing


class Consumer:
    """Listens for producer connections; calls handler(shard, value) for each
    message and acks it (consumer/handlers.go messageHandler)."""

    def __init__(self, handler: Callable[[int, bytes], None],
                 host: str = "127.0.0.1", port: int = 0,
                 ack_batch: int = 1, dedup_window: int = 4096,
                 max_inflight: int = 1024):
        self._handler = handler
        self._ack_batch = ack_batch
        # High watermark on concurrent handler invocations across ALL
        # producer connections: past it, connection loops stop READING
        # (the natural TCP backpressure — the producer's send blocks or
        # its unacked queue fills, surfacing Backpressure at publish()),
        # so a slow handler bounds in-flight memory instead of letting
        # every connection pile work behind it.
        self._max_inflight = max(1, max_inflight)
        # Recently ACKED message ids (bounded FIFO shared across producer
        # connections): a duplicated wire delivery — faultnet duplicate
        # injection, or a producer retry racing an in-flight ack — is
        # re-ACKED without re-invoking the handler, so redelivery cannot
        # double-count in the aggregator. Ids whose handler FAILED were
        # never recorded here, so genuine at-least-once redelivery still
        # reprocesses them. The IN-FLIGHT set closes the race where a
        # redelivery (new connection) arrives while the first handler
        # invocation is still running: the copy is dropped UNACKED — if
        # the running handler succeeds its own ack covers the id, if it
        # fails the producer redelivers later, so at-least-once holds.
        # Keys are (producer src, message id): src is the random identity
        # each producer stamps on its frames, so a RESTARTED producer
        # reusing ids 0..N can never collide into a silent drop; frames
        # without src fall back to a per-connection token (dedup then
        # covers same-connection wire duplicates only).
        self._dedup_lock = threading.Lock()
        # Signals in-flight slots freeing up (wraps the dedup lock, so
        # waiters atomically re-check the inflight set it guards).
        self._inflight_free = threading.Condition(self._dedup_lock)
        self._acked_ids = set()
        self._acked_fifo: "deque" = deque(maxlen=max(1, dedup_window))
        self._inflight_ids = set()
        self._conn_counter = [0]
        self.duplicates_dropped = 0
        outer = self

        # begin -> "acked" (re-ack, skip handler) | "inflight" (drop,
        # no ack) | "new" (claimed: run the handler, then settle).
        # Admission is INSIDE the same critical section as the claim:
        # when the in-flight set is at the watermark, this connection
        # waits HERE — it stops consuming frames, which is the natural
        # TCP backpressure the framed protocol has — and the check and
        # the claim can't race another connection past the bound.
        def _begin(key) -> str:
            with outer._inflight_free:
                while True:
                    if key in outer._acked_ids:
                        outer.duplicates_dropped += 1
                        return "acked"
                    if key in outer._inflight_ids:
                        outer.duplicates_dropped += 1
                        return "inflight"
                    if len(outer._inflight_ids) < outer._max_inflight:
                        outer._inflight_ids.add(key)
                        return "new"
                    outer._inflight_free.wait(timeout=0.05)

        def _settle(key, ok: bool):
            with outer._dedup_lock:
                outer._inflight_ids.discard(key)
                outer._inflight_free.notify_all()
                if not ok:
                    return
                if len(outer._acked_fifo) == outer._acked_fifo.maxlen:
                    outer._acked_ids.discard(outer._acked_fifo[0])
                outer._acked_fifo.append(key)
                outer._acked_ids.add(key)

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                import select

                sock = self.request
                pending_acks: List[int] = []
                with outer._dedup_lock:
                    outer._conn_counter[0] += 1
                    conn_token = ("conn", outer._conn_counter[0])

                def flush():
                    nonlocal pending_acks
                    if pending_acks:
                        wire.write_frame(sock, {"t": "ack", "ids": pending_acks})
                        pending_acks = []

                try:
                    while True:
                        # Idle wait WITHOUT consuming bytes (framing-safe):
                        # a lull flushes partial ack batches so < ack_batch
                        # outstanding messages never sit unacked forever.
                        ready, _, _ = select.select([sock], [], [], 0.05)
                        if not ready:
                            flush()
                            continue
                        frame = wire.read_dict_frame(sock)
                        if frame.get("t") != "msg":
                            continue
                        shard = frame.get("shard")
                        value = frame.get("value")
                        mid = frame.get("id")
                        if shard is None or value is None or mid is None:
                            return  # protocol error, not an app error: drop
                        src = frame.get("src")
                        key = (src if src is not None else conn_token, mid)
                        state = _begin(key)
                        if state == "inflight":
                            # another connection's handler is mid-run for
                            # this id: drop this copy UNACKED (its peer's
                            # outcome decides; redelivery covers failure)
                            continue
                        if state == "acked":
                            # duplicate delivery of a processed message:
                            # re-ack (the producer may have lost the first
                            # ack) but DO NOT re-run the handler.
                            pending_acks.append(mid)
                            if len(pending_acks) >= outer._ack_batch:
                                flush()
                            continue
                        # Producer trace context (if the publish was
                        # sampled): the handler runs under a remote-
                        # parented span sharing the publishing trace id —
                        # fire-and-forget delivery has no response frame
                        # to graft through, so the consumer-side tree is
                        # joined by trace id (/debug/traces?trace_id=).
                        tctx = wire.trace_from_frame(frame)
                        try:
                            with tracing.TRACER.span_from(
                                    tctx, "msg.consume", shard=shard):
                                outer._handler(shard, value)
                        except Exception:  # noqa: BLE001 - app error, not desync
                            # Handler failure is the APPLICATION's error:
                            # log it, skip the ack, keep consuming — the
                            # producer's retry-until-ack redelivers
                            # (at-least-once), and the connection (whose
                            # framing is intact) stays up.
                            _settle(key, ok=False)
                            traceback.print_exc()
                            continue
                        except BaseException:
                            # dying thread: release the in-flight claim or
                            # the id's redeliveries are dropped forever
                            _settle(key, ok=False)
                            raise
                        _settle(key, ok=True)
                        pending_acks.append(mid)
                        if len(pending_acks) >= outer._ack_batch:
                            flush()
                except (ConnectionError, OSError, ValueError):
                    # ValueError = malformed frame: stream desync, drop conn
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
