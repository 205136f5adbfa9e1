"""Coordinator HTTP API (reference: src/query/api/v1/httpd/handler.go:146-282
route table — prom query/query_range, labels, series, json write, remote
write, namespace/placement/database/topic admin, health).

The reference's prom remote write is snappy-compressed protobuf; this build
accepts (a) JSON bodies on the json/write and prom-style endpoints and
(b) snappy-compressed protobuf on the Prometheus remote write and read
routes.

Port of m3_tpu/coordinator/http_api.py. A typed ComputeError from the
card (parallel/guard.py; the reference falls back inside its guard, so
none reaches its handlers) answers 503 with its type name in the error
body, where any other exception answers 400. A remote-write body goes
through DownsamplerAndWriter.write_request, not sample by sample: one
gate unit for the request and columnar batches below it, leaving the
stored and aggregated rows the reference's per-sample loop leaves, a
bad sample's prefix included."""

from __future__ import annotations

import json
import math
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..parallel.guard import ComputeError
from ..query import METRIC_NAME, Engine
from ..query import render as qrender
from ..query.block import Block
from ..query.model import Matcher, MatchType
from ..query import promql
from ..query.promql import parse_duration_ns
from ..utils.limits import ResourceExhausted
from .ingest import DownsamplerAndWriter

S = 1_000_000_000


class HTTPApi:
    """Route table + handlers; serve() spins a ThreadingHTTPServer."""

    def __init__(self, engine: Engine, writer: Optional[DownsamplerAndWriter] = None,
                 admin=None):
        self.engine = engine
        self.writer = writer
        self.admin = admin  # AdminAPI (namespace/placement/database/topic)
        self.routes: List[Tuple[str, str, Callable]] = [
            ("GET", r"/health", self.health),
            ("GET", r"/api/v1/query_range", self.query_range),
            ("POST", r"/api/v1/query_range", self.query_range),
            ("GET", r"/api/v1/query", self.query_instant),
            ("POST", r"/api/v1/query", self.query_instant),
            ("GET", r"/api/v1/labels", self.labels),
            ("GET", r"/api/v1/label/(?P<name>[^/]+)/values", self.label_values),
            ("GET", r"/api/v1/series", self.series),
            ("GET", r"/api/v1/search", self.complete_tags),
            ("POST", r"/api/v1/search", self.complete_tags),
            ("GET", r"/api/v1/openapi", self.openapi),
            ("GET", r"/api/v1/status/buildinfo", self.buildinfo),
            ("GET", r"/api/v1/metadata", self.metric_metadata),
            ("POST", r"/api/v1/json/write", self.json_write),
            ("POST", r"/api/v1/prom/remote/write", self.prom_remote_write),
            ("POST", r"/api/v1/prom/remote/read", self.prom_remote_read),
            ("GET", r"/api/v1/graphite/render", self.graphite_render),
            ("POST", r"/api/v1/graphite/render", self.graphite_render),
            ("GET", r"/api/v1/graphite/find", self.graphite_find),
            ("GET", r"/routes", self.list_routes),
            ("GET", r"/debug/vars", self.debug_vars),
            ("GET", r"/debug/explain", self.debug_explain),
            ("GET", r"/debug/traces", self.debug_traces),
            ("GET", r"/debug/pprof/profile", self.debug_profile),
            ("GET", r"/debug/pprof/goroutine", self.debug_stacks),
            ("GET", r"/debug/pprof/threads", self.debug_stacks),
        ]
        if admin is not None:
            self.routes += [
                ("GET", r"/api/v1/namespace", admin.get_namespaces),
                ("POST", r"/api/v1/namespace", admin.add_namespace),
                ("GET", r"/api/v1/services/m3db/placement", admin.get_placement),
                ("POST", r"/api/v1/services/m3db/placement/init", admin.init_placement),
                ("POST", r"/api/v1/services/m3db/placement", admin.add_instance),
                ("POST", r"/api/v1/database/create", admin.database_create),
                ("GET", r"/api/v1/topic", admin.get_topic),
                ("POST", r"/api/v1/topic/init", admin.init_topic),
            ]
        self._compiled = [(m, re.compile(p + "$"), fn) for m, p, fn in self.routes]
        self._server: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------ handlers

    def health(self, req) -> dict:
        """Health now carries the degradation state machine's verdict
        (utils.health: ok -> degraded -> shedding over gate depth and
        limit-enforcer saturation): load balancers keep routing to a
        degraded coordinator but should drain a shedding one, and
        operators see WHICH source is saturated."""
        from ..utils.health import SHEDDING, TRACKER

        snap = TRACKER.snapshot()
        return {"ok": snap["state"] != SHEDDING, "uptime": "ok",
                "state": snap["state"],
                "saturation": snap["saturation"],
                "sources": snap["sources"]}

    def buildinfo(self, req) -> dict:
        """Prometheus-compat /api/v1/status/buildinfo (beyond the
        reference's router, which predates it): Grafana probes this to
        pick API features, so serving it makes datasource setup
        frictionless. Reports the prom API generation this surface
        tracks plus the real backing build."""
        return {"status": "success",
                "data": {"version": "2.37.0",
                         "application": "m3_tpu-coordinator",
                         "features": {}}}

    def metric_metadata(self, req) -> dict:
        """Prometheus-compat /api/v1/metadata. Metric HELP/TYPE/UNIT
        metadata is not persisted by the storage tier (same position as
        the reference coordinator) — an empty map is the documented
        valid response for unknown metadata and keeps Grafana's
        metadata probes happy."""
        return {"status": "success", "data": {}}

    def list_routes(self, req) -> dict:
        return {"routes": [f"{m} {p}" for m, p, _ in self.routes]}

    def debug_vars(self, req) -> dict:
        """Process metrics snapshot (the reference exposes pprof + tally;
        dbnode/server/server.go:575 debug listener), plus the query
        engine's live device-vs-host placement cost model."""
        from ..parallel import guard
        from ..utils.instrument import ROOT

        return {"metrics": ROOT.snapshot(),
                "query_placement": self.engine.placement_snapshot(),
                "compute": guard.debug_snapshot()}

    def debug_traces(self, req) -> dict:
        """Recent finished span trees (opentracing-analog) + the
        slow-query ring (?trace_id=N filters the trees to one trace)."""
        from ..utils import tracing

        tid = req.param("trace_id", None)
        return tracing.debug_traces_payload(int(tid) if tid else None)

    def debug_profile(self, req) -> dict:
        """Statistical CPU profile: /debug/pprof/profile?seconds=N.
        Sampling runs on ONE shared background thread with a hard cap
        (M3_TPU_PROFILE_MAX_S): a profile request cannot stall a serving
        thread past the cap, and concurrent requests share the window."""
        from ..utils import tracing

        return tracing.debug_profile_payload(float(req.param("seconds", "1")))

    def debug_stacks(self, req):
        """All-threads stack dump (goroutine-dump analog, debug=2 form;
        also served as /debug/pprof/threads)."""
        from ..utils import tracing

        return RawResponse("text/plain; charset=utf-8",
                           tracing.thread_stacks().encode())

    def debug_explain(self, req) -> dict:
        """Query EXPLAIN/ANALYZE (`?query=...&start=&end=&step=`): the
        static plan tree — per node: kind, sharding annotation, compiled
        vs interpreter route, typed fallback reason (query/explain.py).
        `&analyze=true` additionally EXECUTES the query under an ANALYZE
        context and returns per-stage wall times (bind, device program
        per shape bucket, result materialization), cache events, and the
        route the execution actually took."""
        from ..query import explain as qexplain
        from ..query.executor import QueryParams

        q = req.param("query")
        now = time.time()
        start = _parse_time(req.param("start", str(now - 3600)))
        end = _parse_time(req.param("end", str(now)))
        step = _parse_step(req.param("step", "30"))
        try:
            ast = promql.parse(q)
        except promql.ParseError as e:
            raise HTTPError(400, f"bad query: {e}")
        params = QueryParams(start, end, step)
        out = qexplain.explain(ast, params, self.engine.lookback_ns,
                               query=q)
        if _flag(req, "analyze"):
            with qexplain.analyzing() as actx:
                block = self.engine.execute_range(q, start, end, step,
                                                  ast=ast)
                np.asarray(block.values)  # materialize under the context
            out["analyze"] = actx.to_dict()
            out["executed"] = self.engine.last_route()
        return out

    def _explain_beside_data(self, q, ast, start, end, step, actx) -> dict:
        """The `?explain=true` payload riding beside query results
        (Prometheus-stats style): the static plan tree plus the route
        the execution ACTUALLY took (below-floor shows up here even
        though the static tree says compilable)."""
        from ..query import explain as qexplain
        from ..query.executor import QueryParams

        out = qexplain.explain(ast, QueryParams(start, end, step),
                               self.engine.lookback_ns, query=q)
        out["executed"] = self.engine.last_route()
        if actx is not None:
            out["analyze"] = actx.to_dict()
        return out

    def query_range(self, req):
        q = req.param("query")
        start = _parse_time(req.param("start"))
        end = _parse_time(req.param("end"))
        step = _parse_step(req.param("step"))
        if not _flag(req, "explain"):
            # Columnar result frame: response bytes render straight from
            # the value matrix — no per-series dicts on the path
            # (query/render.py; byte-identical to render_result_ref).
            block = self.engine.execute_range(q, start, end, step)
            return RawResponse("application/json",
                               qrender.prom_matrix_bytes(block))
        ast = promql.parse(q)
        actx = None
        if _flag(req, "analyze"):
            from ..query import explain as qexplain

            with qexplain.analyzing() as actx:
                block = self.engine.execute_range(q, start, end, step,
                                                  ast=ast)
                np.asarray(block.values)
        else:
            block = self.engine.execute_range(q, start, end, step, ast=ast)
        out = _prom_matrix(block)
        out["data"]["explain"] = self._explain_beside_data(
            q, ast, start, end, step, actx)
        return out

    def query_instant(self, req):
        q = req.param("query")
        t = _parse_time(req.param("time", str(time.time())))
        # ONE parse serves both the type check and the evaluation.
        ast = promql.parse(q)
        explain_flag = _flag(req, "explain")
        actx = None

        def run(columnar: bool):
            block = self.engine.execute_instant(q, t, ast=ast)
            if promql.is_scalar_node(ast):
                # prom instant queries of scalar-typed expressions return
                # resultType "scalar" (range queries still matrix-ize
                # them)
                v = block.values[0][-1] if block.n_series else float("nan")
                return {"status": "success",
                        "data": {"resultType": "scalar",
                                 "result": [block.meta.times()[-1] / S,
                                            _prom_sample_value(v)]}}
            if columnar:
                # Columnar result frame (query/render.py) — the explain
                # payload rides beside the data only on the dict path.
                return RawResponse("application/json",
                                   qrender.prom_vector_bytes(block))
            return _prom_vector(block)

        if not explain_flag:
            return run(True)
        if _flag(req, "analyze"):
            from ..query import explain as qexplain

            # Serialization happens inside the context so the result
            # materialization stage records (same as query_range).
            with qexplain.analyzing() as actx:
                out = run(False)
        else:
            out = run(False)
        if isinstance(out, dict) and "data" in out:
            out["data"]["explain"] = self._explain_beside_data(
                q, ast, t, t, 1_000_000_000, actx)
        return out

    def _fetch_for_match(self, req):
        matchers = []
        for expr in req.params_all("match[]") or ([req.param("query")] if
                                                  req.param("query", None) else []):
            matchers.append(_parse_series_matchers(expr))
        start = _parse_time(req.param("start", "0"))
        end = _parse_time(req.param("end", str(time.time())))
        out = {}
        for mset in matchers or [()]:
            out.update(self.engine.storage.fetch_raw(mset, start, end))
        return out

    def _complete_tags_query(self, req, matcher_sets, name_only, filter_names):
        """Run CompleteTags through the storage's index-backed path when it
        has one (no datapoints shipped), degrading to a raw fetch otherwise.
        Repeated match[] selectors are separate queries whose results union
        (the Prometheus API contract), so each set runs independently."""
        from ..query.storage import _store_complete_tags

        start = _parse_time(req.param("start", "0"))
        end = _parse_time(req.param("end", str(time.time())))
        merged: Dict[bytes, set] = {}
        for matchers in matcher_sets or [()]:
            part = _store_complete_tags(self.engine.storage, matchers, start,
                                        end, name_only, filter_names)
            for n, vals in part.items():
                merged.setdefault(n, set()).update(vals)
        return merged

    def _match_sets(self, req):
        """One matcher tuple per match[] param (empty list = match all)."""
        return [_parse_series_matchers(expr)
                for expr in req.params_all("match[]")]

    def labels(self, req) -> dict:
        fields = self._complete_tags_query(req, self._match_sets(req), True, ())
        return {"status": "success",
                "data": sorted(n.decode() for n in fields)}

    def label_values(self, req) -> dict:
        """prometheus/remote/tag_values.go — CompleteTags filtered to one
        tag name. With no match[] selectors the AllQuery + filter_names path
        answers straight from the index's term dictionary."""
        name = req.path_params["name"].encode()
        fields = self._complete_tags_query(req, self._match_sets(req), False,
                                           (name,))
        return {"status": "success",
                "data": sorted(v.decode() for v in fields.get(name, ()))}

    def complete_tags(self, req) -> dict:
        """prometheus/native/complete_tags.go — GET /api/v1/search tag
        completion: ?query=<selector>, ?result=default|tagNamesOnly,
        ?filterNameTags=<name> (repeatable). Default response is
        {"hits": N, "tags": [{"key", "values"}]}, names-only is a list."""
        matchers = _parse_series_matchers(req.param("query", "")) if \
            req.param("query", None) else ()
        mode = req.param("result", "default")
        if mode not in ("default", "tagNamesOnly"):
            raise HTTPError(400, f"invalid result parameter {mode!r}")
        name_only = mode == "tagNamesOnly"
        filter_names = tuple(f.encode() for f in req.params_all("filterNameTags"))
        fields = self._complete_tags_query(req, [matchers], name_only,
                                           filter_names)
        if name_only:
            return {"status": "success",
                    "data": sorted(n.decode() for n in fields)}
        return {"hits": len(fields),
                "tags": [{"key": n.decode(),
                          "values": sorted(v.decode() for v in fields[n])}
                         for n in sorted(fields)]}

    def openapi(self, req) -> dict:
        """api/v1/httpd OpenAPI doc route: a generated spec of the live
        route table (the reference serves bundled swagger assets; here the
        spec is derived from the registered routes so it can't go stale)."""
        paths: Dict[str, dict] = {}
        for method, pattern, fn in self.routes:
            path = re.sub(r"\(\?P<(\w+)>[^)]*\)", r"{\1}", pattern)
            doc = (fn.__doc__ or "").strip().splitlines()
            entry = paths.setdefault(path, {})
            entry[method.lower()] = {
                "summary": doc[0] if doc else fn.__name__,
                "operationId": fn.__name__,
            }
        return {"openapi": "3.0.0",
                "info": {"title": "m3_tpu coordinator", "version": "1.0"},
                "paths": paths}

    def series(self, req) -> dict:
        out = []
        for entry in self._fetch_for_match(req).values():
            out.append({k.decode(): v.decode()
                        for k, v in sorted(dict(entry["tags"]).items())})
        return {"status": "success", "data": out}

    def json_write(self, req) -> dict:
        """api/v1/handler/json/write.go: {"tags": {...}, "timestamp": ...,
        "value": ...} or a list of same (also accepts prom-style
        {"timeseries": [{"labels": [...], "samples": [...]}]})."""
        if self.writer is None:
            raise HTTPError(501, "no write backend configured")
        body = json.loads(req.body or b"{}")
        wrote = 0
        if isinstance(body, dict) and "timeseries" in body:
            for ts in body["timeseries"]:
                tags = {l["name"].encode(): l["value"].encode()
                        for l in ts.get("labels", [])}
                for s in ts.get("samples", []):
                    self.writer.write(tags, int(s["timestamp"] * S) if
                                      s["timestamp"] < 1e12 else int(s["timestamp"] * 1e6),
                                      float(s["value"]))
                    wrote += 1
        else:
            docs = body if isinstance(body, list) else [body]
            for doc in docs:
                tags = {k.encode(): str(v).encode()
                        for k, v in doc.get("tags", {}).items()}
                t = doc.get("timestamp")
                t_ns = int(t * S) if isinstance(t, (int, float)) else _parse_time(t)
                self.writer.write(tags, t_ns, float(doc["value"]))
                wrote += 1
        return {"status": "success", "wrote": wrote}

    def prom_remote_write(self, req):
        """api/v1/handler/prometheus/remote/write.go:46 — snappy-compressed
        protobuf prompb.WriteRequest, the wire format a real Prometheus
        remote_write sends. Sample timestamps are milliseconds."""
        from . import promremote

        if self.writer is None:
            raise HTTPError(501, "no write backend configured")
        try:
            raw = promremote.snappy_decompress(req.body)
            series = promremote.decode_write_request(raw)
        except (promremote.SnappyError, promremote.ProtoError) as e:
            raise HTTPError(400, f"bad remote write body: {e}")
        # The body as one request (one gate unit, columnar batches
        # below it: the downsampler's batch match and a shard-routed
        # storage write, the hash kernel on the card); the reference
        # writes sample by sample, with the same stored rows.
        wrote = self.writer.write_request(
            [(tags, t_ms * 1_000_000, value)
             for tags, samples in series for t_ms, value in samples])
        return {"status": "success", "wrote": wrote}

    def prom_remote_read(self, req):
        """remote/read.go — snappy+proto prompb.ReadRequest in,
        prompb.ReadResponse out (raw bytes, snappy-compressed)."""
        from . import promremote

        try:
            raw = promremote.snappy_decompress(req.body)
            queries = promremote.decode_read_request(raw)
        except (promremote.SnappyError, promremote.ProtoError) as e:
            raise HTTPError(400, f"bad remote read body: {e}")
        results = []
        for q in queries:
            series = self.engine.storage.fetch_raw(
                q["matchers"], q["start_ms"] * 1_000_000,
                q["end_ms"] * 1_000_000 + 1)
            out = []
            for sid in sorted(series):
                entry = series[sid]
                samples = [(int(t) // 1_000_000, float(v))
                           for t, v in zip(entry["t"], entry["v"])]
                out.append((dict(entry["tags"]), samples))
            results.append(out)
        body = promremote.snappy_compress(
            promremote.encode_read_response(results))
        return RawResponse("application/x-protobuf", body,
                           headers={"Content-Encoding": "snappy"})

    def graphite_render(self, req) -> list:
        """api/v1/handler/graphite/render.go: graphite-web compatible
        /render — list of {target, datapoints: [[v, t], ...]}."""
        from ..query.graphite import GraphiteEngine, series_name

        start = _parse_time(req.param("from", str(time.time() - 3600)))
        end = _parse_time(req.param("until", str(time.time())))
        step = _parse_step(req.param("step", "10"))
        eng = GraphiteEngine(self.engine.storage, step_ns=step,
                             device=self.engine.device)
        out = []
        # JUSTIFIED suppression: graphite-web's /render contract IS a
        # list of per-target dicts with [value, time] pairs — there is
        # no columnar wire shape to render into, and the graphite compat
        # path serves low-volume dashboards (the Prometheus read API is
        # the hot result plane, columnar via query/render.py).
        for target in req.params_all("target"):  # m3lint: disable=per-series-result-dict
            block = eng.render(target, start, end, step)
            times = block.meta.times() / S
            for tags, row in zip(block.series_tags, block.values):
                out.append({
                    "target": series_name(tags).decode(),
                    "datapoints": [
                        [None if not math.isfinite(v) else float(v), int(t)]
                        for v, t in zip(row, times)],
                })
        return out

    def graphite_find(self, req) -> list:
        """api/v1/handler/graphite/find.go: path browse — one level of
        children under the query glob."""
        from ..query.graphite import path_to_matchers

        query = req.param("query")
        start = _parse_time(req.param("from", "0"))
        end = _parse_time(req.param("until", str(time.time())))
        depth = len(query.split("."))
        matchers = list(path_to_matchers(query))[:-1]  # drop depth cap: allow children
        found = {}
        for entry in self.engine.storage.fetch_raw(tuple(matchers), start, end).values():
            from ..metrics.carbon import tags_to_path

            parts = tags_to_path(dict(entry["tags"])).split(b".")
            if len(parts) < depth:
                continue
            name = parts[depth - 1].decode()
            is_leaf = len(parts) == depth
            cur = found.get(name)
            found[name] = {"leaf": (cur or {}).get("leaf", False) or is_leaf,
                           "hasChildren": (cur or {}).get("hasChildren", False)
                           or not is_leaf}
        return [{"id": ".".join(query.split(".")[:-1] + [n]) if "." in query else n,
                 "text": n, "leaf": int(v["leaf"]),
                 "expandable": int(v["hasChildren"]), "allowChildren": int(v["hasChildren"])}
                for n, v in sorted(found.items())]

    # ------------------------------------------------------------ serving

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> "HTTPApi":
        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _dispatch(self):
                parsed = urllib.parse.urlsplit(self.path)
                params = urllib.parse.parse_qs(parsed.query)
                body = b""
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    body = self.rfile.read(length)
                    ctype = self.headers.get("Content-Type", "")
                    if "form" in ctype:
                        params.update(urllib.parse.parse_qs(body.decode()))
                req = Request(self.command, parsed.path, params, body,
                              headers=dict(self.headers))
                for method, pattern, fn in api._compiled:
                    m = pattern.match(parsed.path)
                    if m and method == self.command:
                        req.path_params = m.groupdict()
                        # External trace ingress: an "X-M3-Trace:
                        # <trace_id>:<span_id>" header joins this request
                        # to the caller's trace (the HTTP twin of the
                        # wire frames' "tr" field). No header, no span —
                        # plain requests pay one dict get.
                        from ..utils import tracing as _tracing

                        tspan = _tracing.TRACER.span_from(
                            _trace_header_ctx(self.headers.get("X-M3-Trace")),
                            f"http.{self.command} {parsed.path}")
                        try:
                            with tspan:
                                out = fn(req)
                            code = 200
                        except HTTPError as e:
                            out, code = {"status": "error", "error": e.msg}, e.code
                        except ComputeError as e:
                            # A typed device fault the guard raised
                            # (the card's compiled plan, a kernel): the
                            # query is fine, the server is not — 503,
                            # with the fault's type for the caller.
                            out, code = {"status": "error",
                                         "errorType": type(e).__name__,
                                         "error": str(e)}, 503
                        except ResourceExhausted as e:
                            # Shed by a query limit or the ingest admission
                            # gate: 429 with Retry-After so well-behaved
                            # producers back off instead of retrying hot.
                            out, code = {"status": "error",
                                         "errorType": "resource_exhausted",
                                         "error": str(e)}, 429
                        except Exception as e:  # noqa: BLE001
                            out, code = {"status": "error", "error": str(e)}, 400
                        if isinstance(out, RawResponse):
                            ctype, data = out.content_type, out.data
                            extra = out.headers
                        else:
                            ctype, data = "application/json", json.dumps(out).encode()
                            # shed responses tell producers WHEN to retry
                            extra = {"Retry-After": "1"} if code == 429 else {}
                        self.send_response(code)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length", str(len(data)))
                        for k, v in extra.items():
                            self.send_header(k, v)
                        self.end_headers()
                        self.wfile.write(data)
                        return
                self.send_response(404)
                self.end_headers()

            do_GET = do_POST = do_DELETE = do_PUT = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"http://{h}:{p}"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


class RawResponse:
    """Non-JSON handler result: raw bytes with an explicit content type
    (the remote-read protobuf response path)."""

    def __init__(self, content_type: str, data: bytes, headers=None):
        self.content_type = content_type
        self.data = data
        self.headers = headers or {}


class Request:
    def __init__(self, method: str, path: str, params: Dict[str, list],
                 body: bytes, headers: Optional[Dict[str, str]] = None):
        self.method = method
        self.path = path
        self.params = params
        self.body = body
        self.headers = headers or {}
        self.path_params: Dict[str, str] = {}

    def param(self, name: str, default: Optional[str] = "__required__"):
        vals = self.params.get(name)
        if not vals:
            if default == "__required__":
                raise HTTPError(400, f"missing parameter {name!r}")
            return default
        return vals[0]

    def params_all(self, name: str) -> List[str]:
        return self.params.get(name, [])

    def json(self):
        return json.loads(self.body or b"{}")


class HTTPError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code
        self.msg = msg


# ---------------------------------------------------------------- helpers

def _flag(req, name: str) -> bool:
    return req.param(name, "").lower() in ("true", "1")


def _trace_header_ctx(header: Optional[str]):
    """SpanContext from an "X-M3-Trace: <trace_id>:<span_id>" header, or
    None — malformed values are absent, never fatal (the HTTP twin of
    wire.trace_from_frame)."""
    if not header:
        return None
    from ..utils.tracing import SpanContext

    parts = header.split(":")
    if len(parts) != 2:
        return None
    try:
        return SpanContext(int(parts[0]), int(parts[1]))
    except ValueError:
        return None


def _parse_time(s) -> int:
    """Unix seconds (float) or RFC3339 -> nanos."""
    if isinstance(s, (int, float)):
        return int(float(s) * S)
    try:
        return int(float(s) * S)
    except ValueError:
        pass
    import datetime as dt

    t = dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    return int(t.timestamp() * S)


def _parse_step(s: str) -> int:
    try:
        return int(float(s) * S)
    except ValueError:
        return parse_duration_ns(s)


_MATCHER_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!~|!=|=)\s*"((?:\\.|[^"\\])*)"')


def _parse_series_matchers(expr: str) -> Tuple[Matcher, ...]:
    """Parse a series-match expression like name{a="b"} or {a="b"}."""
    expr = expr.strip()
    out: List[Matcher] = []
    name_part, brace, rest = expr.partition("{")
    name_part = name_part.strip()
    if name_part:
        out.append(Matcher(MatchType.EQUAL, METRIC_NAME, name_part.encode()))
    if brace:
        body = rest.rsplit("}", 1)[0]
        for m in _MATCHER_RE.finditer(body):
            name, op, value = m.groups()
            mt = {"=": MatchType.EQUAL, "!=": MatchType.NOT_EQUAL,
                  "=~": MatchType.REGEXP, "!~": MatchType.NOT_REGEXP}[op]
            out.append(Matcher(mt, name.encode(), value.encode()))
    return tuple(out)


# The per-series renderers moved to query/render.py: the `_ref` forms
# are retained verbatim there as the byte-identity oracle for the
# columnar frames; the explain-beside-data paths still serve them (the
# payload mutates the dict before serialization).
_prom_sample_value = qrender.prom_sample_value
_metric_labels = qrender._metric_labels
_prom_matrix = qrender.prom_matrix_ref
_prom_vector = qrender.prom_vector_ref
