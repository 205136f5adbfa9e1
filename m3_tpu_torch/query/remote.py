"""Coordinator-to-coordinator federation: remote query storage over the
framed wire (port of m3_tpu/query/remote.py; reference:
src/query/tsdb/remote/{client,server}.go + the rpcpb protobuf service — a
coordinator exposes its storage so sibling coordinators can fan out
fetches across clusters/regions).

The reference speaks gRPC; this build rides the same framed binary codec
as the node RPC (rpc/wire.py), so fetched columns stay numpy end to end
and a port server answers a reference client byte for byte. The transport
holds no device: the storage behind the server (a LocalStorage or a
SessionStorage) and the Engine over the client hold theirs."""

from __future__ import annotations

import socketserver
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ..rpc import wire
from ..utils.retry import (
    Breaker,
    BreakerOpen,
    Deadline,
    DeadlineExceeded,
    Retrier,
    RetryOptions,
    default_is_retryable,
)
from .model import Matcher, MatchType


def _matchers_to_wire(matchers: Sequence[Matcher]) -> list:
    return [{"t": int(m.type), "n": m.name, "v": m.value} for m in matchers]


def _matchers_from_wire(obj: list):
    return tuple(Matcher(MatchType(d["t"]), d["n"], d["v"]) for d in obj)


class RemoteStorageServer:
    """Serves fetch_raw over TCP (tsdb/remote/server.go)."""

    def __init__(self, storage, host: str = "127.0.0.1", port: int = 0):
        self.storage = storage
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = wire.read_dict_frame(self.request)
                        try:
                            # Per-request deadline: a federated fetch whose
                            # caller stopped waiting must not run to
                            # completion against local storage.
                            deadline = wire.deadline_from_frame(req)
                            if deadline is not None:
                                deadline.check(str(req.get("method")))
                            resp = outer._dispatch(req)
                        except DeadlineExceeded as e:
                            resp = {"err": str(e), "kind": "deadline"}
                        except Exception as e:  # noqa: BLE001
                            resp = {"err": str(e)}
                        wire.write_frame(self.request, resp)
                except (ConnectionError, OSError, ValueError):
                    # ValueError = malformed frame: stream desync, drop conn
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)

    def _dispatch(self, req: dict) -> dict:
        if req["method"] == "fetch_raw":
            series = self.storage.fetch_raw(
                _matchers_from_wire(req["matchers"]), req["start"], req["end"])
            # Columnar result frame: ids/tags sidecar + ONE pair of
            # concatenated (t, v) columns with an offsets vector —
            # instead of one dict of arrays per series. The ragged
            # per-series runs survive as offset slices; the client
            # rebuilds zero-copy views.
            ids, tags, ts, vs = [], [], [], []
            for sid, entry in series.items():
                ids.append(sid)
                tags.append(entry["tags"])
                ts.append(np.asarray(entry["t"], np.int64))
                vs.append(np.asarray(entry["v"], np.float64))
            offs = np.zeros(len(ids) + 1, np.int64)
            if ids:
                offs[1:] = np.cumsum([t.size for t in ts])
            return {"ids": ids, "tags": tags, "offs": offs,
                    "t": (np.concatenate(ts) if ids
                          else np.zeros(0, np.int64)),
                    "v": (np.concatenate(vs) if ids
                          else np.zeros(0, np.float64))}
        if req["method"] == "write":
            self.storage.write(req["id"], req["tags"], req["time"], req["value"])
            return {"ok": True}
        raise ValueError(f"unknown method {req['method']!r}")

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def start(self) -> "RemoteStorageServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class RemoteStorage:
    """Client side: a query-storage implementation backed by a remote
    coordinator (tsdb/remote/client.go); drop it into FanoutStorage next
    to local stores for cross-cluster reads."""

    def __init__(self, endpoint: str, timeout_s: float = 10.0,
                 retry_opts: Optional[RetryOptions] = None,
                 breaker: Optional[Breaker] = None):
        self._endpoint = endpoint
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._sock = None
        # Desync (ValueError) IS retryable here — unlike mid-stream
        # protocol users — because _exchange drops the connection first,
        # so the re-attempt runs on a fresh stream; this storage's writes
        # are idempotent, so re-sending a maybe-applied request is safe.
        self._retrier = Retrier(
            retry_opts if retry_opts is not None
            else RetryOptions(max_attempts=2, initial_backoff_s=0.05),
            is_retryable=lambda e: (isinstance(e, ValueError)
                                    or default_is_retryable(e)))
        self._breaker = breaker if breaker is not None else Breaker(
            name=endpoint)

    def _call(self, req: dict, deadline: Optional[Deadline] = None) -> dict:
        resp = self._retrier.attempt(self._exchange, req, deadline,
                                     deadline=deadline)
        if "err" in resp:
            if resp.get("kind") == "deadline":
                raise DeadlineExceeded(resp["err"])
            raise RuntimeError(f"remote storage error: {resp['err']}")
        return resp

    def _exchange(self, req: dict, deadline: Optional[Deadline]) -> dict:
        """One serialized request/response exchange; transport errors are
        surfaced typed so the retrier classifies them (a malformed reply
        stays a ValueError — desync, NOT retryable on this stream, but the
        connection is dropped so the next attempt starts clean)."""
        if not self._breaker.allow():
            raise BreakerOpen(f"remote storage {self._endpoint} shed")
        # From here EVERY exit must settle the allow() grant, or a granted
        # half-open probe slot leaks and the breaker wedges half-open.
        try:
            resp = self._exchange_locked(req, deadline)
        except DeadlineExceeded:
            # Always pre-I/O here (the budget died waiting on the LOCAL
            # serialized-exchange lock — endpoint-side expiry surfaces as
            # a socket timeout/OSError instead): release the grant but
            # don't blame a host we never reached.
            self._breaker.cancel()
            raise
        except BaseException:
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return resp

    def _exchange_locked(self, req: dict, deadline: Optional[Deadline]) -> dict:
        with self._lock:
            try:
                if deadline is not None:
                    deadline.check("remote storage")
                # connect phase capped by the remaining budget as well
                sock = self._ensure_conn(
                    None if deadline is None
                    else deadline.min_timeout(self._timeout_s))
                if deadline is not None:
                    req = dict(req)
                    req[wire.DEADLINE_KEY] = deadline.to_wire()
                    sock.settimeout(deadline.min_timeout(self._timeout_s))
                else:
                    sock.settimeout(self._timeout_s)
                wire.write_frame(sock, req)  # m3lint: disable=lock-held-blocking-call
                return wire.read_dict_frame(sock)  # m3lint: disable=lock-held-blocking-call
            except (OSError, ValueError, ConnectionError):
                # OSError covers socket.timeout; either way the stream may
                # carry a late reply — unusable for the next exchange.
                self._drop_conn()
                raise

    def fetch_raw(self, matchers: Sequence[Matcher], start_ns: int,
                  end_ns: int, deadline: Optional[Deadline] = None
                  ) -> Dict[bytes, dict]:
        resp = self._call({"method": "fetch_raw",
                           "matchers": _matchers_to_wire(matchers),
                           "start": start_ns, "end": end_ns}, deadline)
        offs, t, v = resp["offs"], resp["t"], resp["v"]
        # Offset-sliced VIEWS of the two wire columns — no per-series
        # array copies on the federation read path.
        return {
            sid: {"tags": tags, "t": t[offs[i]:offs[i + 1]],
                  "v": v[offs[i]:offs[i + 1]]}
            for i, (sid, tags) in enumerate(zip(resp["ids"], resp["tags"]))
        }

    def write(self, series_id: bytes, tags, t_ns: int, value: float,
              deadline: Optional[Deadline] = None):
        """Datapoint writes are idempotent (replica merge dedups on
        timestamp), so the retrier may safely re-send one that failed
        mid-exchange — unlike the KV store's mutations."""
        self._call({"method": "write", "id": series_id, "tags": dict(tags),
                    "time": t_ns, "value": value}, deadline)

    def _ensure_conn(self, connect_timeout: Optional[float] = None):
        if self._sock is None:
            import socket as _socket

            host, _, port = self._endpoint.rpartition(":")
            self._sock = _socket.create_connection(
                (host, int(port)),
                timeout=self._timeout_s if connect_timeout is None
                else connect_timeout)
            self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        return self._sock

    def _drop_conn(self):
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        self._drop_conn()
