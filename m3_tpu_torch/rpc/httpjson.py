"""HTTP/JSON mirror of the node RPC (host copy of m3_tpu/rpc/httpjson.py;
reference:
src/dbnode/network/server/httpjson — every thrift method exposed as POST
/<method> with a JSON body, used for debugging and simple integrations;
server.go:555 wires it next to the tchannel listener), plus the dbnode
/debug surface: GET /debug/vars (instrument snapshot), /debug/traces
(span trees + slow-query log), /debug/pprof/profile (shared capped
background sampler) and /debug/pprof/threads|goroutine (all-threads
stack dump) — the same endpoints every reference service exposes
(dbnode/server/server.go:575 debug listener).

Numpy columns serialize as lists; bytes as latin-1-safe strings. The
server has no device of its own: every RPC runs on the service's (the
database's) device, and it refuses to start over a service placed on a
card that is not there."""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from ..device import resolve
from ..utils import tracing
from ..utils.instrument import ROOT
from ..utils.limits import ResourceExhausted
from .node_server import NodeService


def _to_json(v: Any):
    if isinstance(v, dict):
        return {_key(k): _to_json(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_json(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return {"b64": base64.b64encode(v).decode()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _key(k):
    return k.decode(errors="replace") if isinstance(k, bytes) else k


def _from_json(v: Any):
    if isinstance(v, dict):
        if set(v) == {"b64"}:
            return base64.b64decode(v["b64"])
        return {k: _from_json(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_json(x) for x in v]
    return v


class HTTPJSONServer:
    def __init__(self, service: NodeService, host: str = "127.0.0.1",
                 port: int = 0):
        self.device = resolve(service.device)
        svc = service

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                method = self.path.strip("/")
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b"{}"
                try:
                    args = _from_json(json.loads(body or b"{}"))
                    # JSON callers pass strings where the wire uses bytes.
                    args = {k: (v.encode() if isinstance(v, str) and
                                k in ("ns", "id") else v)
                            for k, v in args.items()}
                    result = svc.dispatch(method, args)
                    out = {"ok": True, "r": _to_json(result)}
                    code = 200
                except ResourceExhausted as e:
                    # typed shed: 429 so HTTP producers back off (the
                    # JSON mirror of the wire's resource_exhausted frame)
                    out, code = {"ok": False, "err": str(e),
                                 "kind": "resource_exhausted"}, 429
                except Exception as e:  # noqa: BLE001
                    out, code = {"ok": False, "err": str(e)}, 400
                data = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                """dbnode /debug surface (everything else is POST rpc)."""
                parsed = urllib.parse.urlsplit(self.path)
                params = urllib.parse.parse_qs(parsed.query)
                path = parsed.path
                ctype = "application/json"
                code = 200
                try:
                    if path == "/debug/vars":
                        from ..parallel import guard

                        out = json.dumps(
                            {"metrics": ROOT.snapshot(),
                             "compute": guard.debug_snapshot()}).encode()
                    elif path == "/debug/traces":
                        tid = params.get("trace_id", [None])[0]
                        out = json.dumps(tracing.debug_traces_payload(
                            int(tid) if tid else None)).encode()
                    elif path == "/debug/pprof/profile":
                        out = json.dumps(tracing.debug_profile_payload(
                            float(params.get("seconds", ["1"])[0]))).encode()
                    elif path in ("/debug/pprof/threads",
                                  "/debug/pprof/goroutine"):
                        ctype = "text/plain; charset=utf-8"
                        out = tracing.thread_stacks().encode()
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                except Exception as e:  # noqa: BLE001 — bad params
                    # (seconds=abc, trace_id=xyz) must answer a typed
                    # 400 like do_POST, not drop the connection with a
                    # handler traceback.
                    ctype = "application/json"
                    out = json.dumps({"ok": False, "err": str(e)}).encode()
                    code = 400
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

        self._server = ThreadingHTTPServer((host, port), Handler)

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"http://{h}:{p}"

    def start(self) -> "HTTPJSONServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
