"""Networked versioned-KV service with watch push: the cluster metadata
plane as a process (host copy of m3_tpu/cluster/kv_service.py; reference:
src/cluster/kv/etcd/store.go — etcd v3 backs kv/placement/election/
heartbeat in production; src/cluster/etcd/watchmanager/watch_manager.go
for the watch stream). Host code with no device: the server and its
clients move bytes, and the wire codec refuses tensors.

One KVServer process (backed by a MemStore, or FileStore for durability)
serves every dbnode/coordinator/aggregator in the cluster; each connects a
RemoteStore speaking the framed binary wire (m3_tpu_torch.rpc.wire).
RemoteStore implements the exact MemStore surface (get/set/set_if_not_exists/
check_and_set/delete/keys/watch/on_change), so placement, namespaces,
elections, flush times, runtime options and rule matchers work unchanged
across processes.

Protocol: request/response dicts on a pooled connection —
  {"op": "get"|"set"|"setnx"|"cas"|"delete"|"keys", ...} -> {"ok", ...}
— plus a dedicated streaming connection per watched key:
  {"op": "watch", "key", "from_version"} -> stream of
  {"key", "data", "version"} frames, pushed on every change (and once
  immediately if the current version is newer than from_version; deletes
  push {"version": 0, "data": None}).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Callable, Dict, List, Optional

from ..rpc import wire
from ..utils import tracing
from ..utils.retry import Deadline, DeadlineExceeded, Retrier, RetryOptions
from . import kv as cluster_kv


class KVServer:
    """Serves a MemStore/FileStore over the framed wire."""

    def __init__(self, store: Optional[cluster_kv.MemStore] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store if store is not None else cluster_kv.MemStore()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = wire.read_dict_frame(self.request)
                        if req.get("op") == "watch":
                            outer._serve_watch(self.request, req)
                            return  # connection is now a push stream
                        # Per-request deadline: an expired budget answers
                        # with a typed error instead of doing the work the
                        # caller already stopped waiting for.
                        deadline = wire.deadline_from_frame(req)
                        if deadline is not None and deadline.expired:
                            wire.write_frame(self.request, {
                                "ok": False, "kind": "deadline",
                                "err": f"kv {req.get('op')}: deadline exceeded"})
                            continue
                        # Propagated span context: kv ops under a sampled
                        # caller join its trace; the finished span rides
                        # the response for the client-side graft.
                        sp = tracing.TRACER.span_from(
                            wire.trace_from_frame(req),
                            f"kv.{req.get('op')}")
                        with sp:
                            resp = outer._handle(req)
                        if sp.sampled and resp.get("ok"):
                            resp[wire.SPAN_KEY] = sp.to_dict()
                        wire.write_frame(self.request, resp)
                except (ConnectionError, OSError, EOFError, ValueError):
                    # ValueError = malformed frame: stream desync, drop conn
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        key = req.get("key", "")
        store = self.store
        try:
            if op == "get":
                v = store.get(key)
                return {"ok": True, "data": v.data if v else None,
                        "version": v.version if v else 0}
            if op == "set":
                return {"ok": True, "version": store.set(key, req["data"])}
            if op == "setnx":
                return {"ok": True,
                        "version": store.set_if_not_exists(key, req["data"])}
            if op == "cas":
                return {"ok": True, "version": store.check_and_set(
                    key, req["expect"], req["data"])}
            if op == "delete":
                v = store.delete(key)
                return {"ok": True, "existed": v is not None,
                        "data": v.data if v else None,
                        "version": v.version if v else 0}
            if op == "keys":
                return {"ok": True, "keys": store.keys(req.get("prefix", ""))}
            return {"ok": False, "err": f"unknown op {op!r}", "kind": "proto"}
        except KeyError as e:
            return {"ok": False, "err": str(e), "kind": "exists"}
        except ValueError as e:
            return {"ok": False, "err": str(e), "kind": "cas"}

    def _serve_watch(self, sock, req: dict):
        """Push every change of one key until the client disconnects."""
        key = req["key"]
        last_sent = int(req.get("from_version", 0))
        w = self.store.watch(key)
        try:
            while True:
                v = self.store.get(key)
                version = v.version if v else 0
                if version != last_sent and (v is not None or last_sent != 0):
                    try:
                        wire.write_frame(sock, {
                            "key": key, "data": v.data if v else None,
                            "version": version})
                    except (ConnectionError, OSError):
                        return
                    last_sent = version
                if not w.wait(timeout=30.0):
                    # Idle heartbeat keeps half-open connections detectable.
                    try:
                        wire.write_frame(sock, {"key": key, "heartbeat": True})
                    except (ConnectionError, OSError):
                        return
        finally:
            self.store.unwatch(key, w)

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def start(self) -> "KVServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class RemoteStore:
    """Client to a KVServer; drop-in for MemStore across processes."""

    def __init__(self, endpoint: str, timeout: float = 10.0,
                 retry_opts: Optional[RetryOptions] = None):
        self._endpoint = endpoint
        self._timeout = timeout
        # READ retries only: get/keys are side-effect free, so the retrier
        # may re-send them across reconnects with backoff. Mutations stay
        # strictly at-most-once (see _request).
        self._read_retrier = Retrier(retry_opts if retry_opts is not None
                                     else RetryOptions(max_attempts=3,
                                                       initial_backoff_s=0.05))
        self._lock = threading.Lock()     # guards the request connection
        self._sock: Optional[socket.socket] = None
        self._watch_lock = threading.Lock()
        self._watch_threads: Dict[str, threading.Thread] = {}
        self._watches: Dict[str, List[cluster_kv.Watch]] = {}
        self._callbacks: Dict[str, List[Callable]] = {}
        self._last_seen: Dict[str, cluster_kv.Value] = {}
        self._closed = False

    # -- request/response --------------------------------------------------

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        host, _, port = self._endpoint.rpartition(":")
        s = socket.create_connection(
            (host, int(port)),
            timeout=self._timeout if timeout is None else timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _request(self, req: dict, deadline: Optional[Deadline] = None) -> dict:
        read_only = req.get("op") in ("get", "keys")
        if read_only:
            # Reads ride the retrier: reconnect + backoff per attempt,
            # bounded by max_attempts and the optional deadline.
            resp = self._read_retrier.attempt(self._exchange, req, deadline,
                                              deadline=deadline)
        else:
            # A failed mutation is never re-sent: whether the failure hit
            # a stale pooled socket or ate the reply mid-request is
            # indistinguishable without request IDs, and in the latter
            # case the server already applied it — a blind re-send
            # double-applies a set or fails a CAS that in fact won.
            # Surface the error; the caller re-reads state to recover
            # (at-most-once, as with etcd client errors).
            resp = self._exchange(req, deadline)
        if resp.get("ok"):
            return resp
        if resp.get("kind") == "deadline":
            raise DeadlineExceeded(resp.get("err", "kv deadline exceeded"))
        if resp.get("kind") == "exists":
            raise KeyError(resp.get("err", "exists"))
        if resp.get("kind") == "cas":
            raise ValueError(resp.get("err", "version mismatch"))
        raise RuntimeError(resp.get("err", "kv protocol error"))

    def _exchange(self, req: dict, deadline: Optional[Deadline] = None) -> dict:
        """One serialized request/response exchange on the pooled socket."""
        with self._lock:
            try:
                if deadline is not None:
                    deadline.check(f"kv {req.get('op')}")
                if self._sock is None:
                    # reconnect inside the same serialized exchange (see
                    # I/O note below); the CONNECT phase is capped by the
                    # remaining budget too, not just the reads
                    self._sock = self._connect(  # m3lint: disable=lock-held-blocking-call
                        None if deadline is None
                        else deadline.min_timeout(self._timeout))
                if deadline is not None:
                    req = dict(req)
                    req[wire.DEADLINE_KEY] = deadline.to_wire()
                    self._sock.settimeout(deadline.min_timeout(self._timeout))
                cur_span = tracing.TRACER.current()
                if cur_span is not None:
                    req = dict(req)
                    req[wire.TRACE_KEY] = cur_span.context().to_wire()
                # DELIBERATE I/O under _lock: this lock exists to
                # serialize whole request/response exchanges on the
                # single pooled socket — interleaved frames from two
                # threads would desync the stream. Latency is bounded
                # by the connect/read timeout set in _connect.
                wire.write_frame(self._sock, req)  # m3lint: disable=lock-held-blocking-call
                try:
                    resp = wire.read_dict_frame(self._sock)  # m3lint: disable=lock-held-blocking-call
                    if cur_span is not None:
                        sp = resp.pop(wire.SPAN_KEY, None)
                        if isinstance(sp, dict):
                            sp.setdefault("tags", {})["endpoint"] = \
                                self._endpoint
                            cur_span.attach(sp)
                    return resp
                except ValueError as e:
                    # malformed reply = stream desync: the pooled
                    # socket is unusable; surface as a CONNECTION
                    # error so it can never collide with the
                    # CAS-mismatch ValueError contract in _request.
                    raise ConnectionError(f"kv reply desync: {e}")
            except (ConnectionError, OSError, EOFError):
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                raise
            finally:
                if deadline is not None and self._sock is not None:
                    self._sock.settimeout(self._timeout)

    # -- MemStore surface --------------------------------------------------

    def get(self, key: str,
            deadline: Optional[Deadline] = None) -> Optional[cluster_kv.Value]:
        r = self._request({"op": "get", "key": key}, deadline)
        if r["version"] == 0 and r["data"] is None:
            return None
        return cluster_kv.Value(r["data"], r["version"])

    def set(self, key: str, data: bytes) -> int:
        return self._request({"op": "set", "key": key, "data": data})["version"]

    def set_if_not_exists(self, key: str, data: bytes) -> int:
        return self._request({"op": "setnx", "key": key, "data": data})["version"]

    def check_and_set(self, key: str, expect_version: int, data: bytes) -> int:
        return self._request({"op": "cas", "key": key,
                              "expect": expect_version, "data": data})["version"]

    def delete(self, key: str) -> Optional[cluster_kv.Value]:
        r = self._request({"op": "delete", "key": key})
        if not r["existed"]:
            return None
        return cluster_kv.Value(r["data"], r["version"])

    def keys(self, prefix: str = "",
             deadline: Optional[Deadline] = None) -> List[str]:
        return self._request({"op": "keys", "prefix": prefix}, deadline)["keys"]

    # -- watches -----------------------------------------------------------

    def watch(self, key: str) -> cluster_kv.Watch:
        # kv.Watch only calls store.get(), so it works against this store.
        w = cluster_kv.Watch(self, key)
        with self._watch_lock:
            self._watches.setdefault(key, []).append(w)
            self._ensure_watch_thread(key)
        if self.get(key) is not None:
            w._notify()
        return w

    def on_change(self, key: str, fn: Callable[[str, cluster_kv.Value], None]):
        """Callback watch; like MemStore, fires once with the current value
        if the key exists. The initial fire is coalesced with the watch
        stream: a brand-new stream pushes the current value itself, so the
        local fire only happens when the stream already delivered one
        (otherwise a registration racing the initial push would invoke the
        callback twice, concurrently, with the same value)."""
        with self._watch_lock:
            self._callbacks.setdefault(key, []).append(fn)
            started = key not in self._watch_threads
            self._ensure_watch_thread(key)
            cached = None if started else self._last_seen.get(key)
        if cached is not None:
            fn(key, cached)

    def off_change(self, key: str, fn: Callable):
        """Deregister a callback (MemStore.off_change parity)."""
        with self._watch_lock:
            fns = self._callbacks.get(key)
            if fns is not None and fn in fns:
                fns.remove(fn)
                if not fns:
                    del self._callbacks[key]

    def _ensure_watch_thread(self, key: str):
        if key in self._watch_threads:
            return
        t = threading.Thread(target=self._watch_loop, args=(key,), daemon=True)
        self._watch_threads[key] = t
        t.start()

    def _watch_loop(self, key: str):
        """Dedicated push-stream connection; reconnects with the last seen
        version so missed intermediate versions collapse into one event
        (same coalescing etcd watches exhibit under reconnect)."""
        last = 0
        # Reconnect backoff schedule (was a flat 0.2s): consecutive
        # failures back off exponentially, any successful frame resets.
        backoff = Retrier(RetryOptions(initial_backoff_s=0.1,
                                       backoff_factor=2.0, max_backoff_s=2.0))
        failures = 0
        while not self._closed:
            try:
                s = self._connect()
                # Outlive the server's 30s idle heartbeat: a silent stream
                # for >2 beats means the connection is dead.
                s.settimeout(65.0)
                wire.write_frame(s, {"op": "watch", "key": key,
                                     "from_version": last})
                while not self._closed:
                    ev = wire.read_dict_frame(s)
                    failures = 0  # live stream: reset the reconnect backoff
                    if ev.get("heartbeat"):
                        continue
                    last = ev["version"]
                    value = (cluster_kv.Value(ev["data"], last)
                             if ev["data"] is not None else None)
                    with self._watch_lock:
                        # Cache + snapshot under one lock hold so on_change's
                        # registered-then-cached check can't interleave into
                        # a double initial fire. Deletes clear the cache: a
                        # later registration must not see a dead value.
                        if value is not None:
                            self._last_seen[key] = value
                        else:
                            self._last_seen.pop(key, None)
                        watches = list(self._watches.get(key, []))
                        callbacks = list(self._callbacks.get(key, []))
                    for w in watches:
                        w._notify()
                    if value is not None:
                        for fn in callbacks:
                            # A raising callback (even a network error from
                            # work it does, like a placement re-read) must
                            # neither kill this thread — ending delivery for
                            # every watcher of the key — nor roll the stream
                            # back: `last` already advanced, and the server
                            # would never re-push this version.
                            try:
                                fn(key, value)
                            except Exception:  # noqa: BLE001
                                pass
            except (ConnectionError, OSError, EOFError, ValueError):
                # ValueError = malformed/desynced push frame: the stream
                # is unusable, but the WATCH must not die — reconnect
                # from the last seen version like any broken connection
                # (a dead watch thread would silently end placement/
                # runtime-option delivery for every watcher of the key).
                if self._closed:
                    return
                failures += 1
                threading.Event().wait(backoff.backoff_for(failures))

    def close(self):
        self._closed = True
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
