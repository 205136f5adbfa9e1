"""Aggregator network ingestion server (host copy of
m3_tpu/aggregator/server.py; reference:
src/aggregator/server/rawtcp/server.go:122 — raw TCP connections carrying
unaggregated metrics with their staged metadatas). Each connection reads
through the dual-format migration reader (aggregator/migration.py):
the framed binary codec below is the current generation, and legacy
JSON-line clients keep working during migration.

Wire frames:
  {"t": "untimed", "mtype": i64, "id": bytes, "value": f64|i64|list,
   "metadatas": [...]}
  {"t": "timed", "mtype": i64, "id": bytes, "time": i64, "value": f64,
   "policy": str, "agg_id": i64}
  {"t": "forwarded", "mtype": i64, "id": bytes, "time": i64, "value": f64,
   "agg_id": i64, "policy": str, "pipeline": [...], "source_id": bytes,
   "num_times": i64}   (partial aggregates between pipeline stages,
   reference: src/aggregator/server/rawtcp handling of forwarded metric
   unions + forwarded_writer.go)
A batch frame {"t": "batch", "entries": [...]} carries many at once.

A COLUMNAR timed batch amortizes the per-entry codec and parse cost —
the dominant share of the per-connection ingest ceiling once dispatch
itself is memoized (policy parse + shard hash). One frame carries one
(mtype, policy, agg_id) group:
  {"t": "tbatch", "mtype": i64, "policy": str, "agg_id": i64,
   "ids": [bytes, ...], "times": ndarray i64, "values": ndarray f64}
The codec writes the two numeric columns as raw ndarray buffers (no
per-element marshalling) and the six key strings once per frame instead
of once per datapoint; the server parses policy/type once and loops
add_timed. This is the wire shape of the reference's protobuf
WriteTimedBatch (src/aggregator/client/client.go WriteTimed batching).

The servers have no device of their own: what they ingest reaches the
aggregator, whose flush runs on its device, and they refuse to start over
an aggregator placed on a card that is not there. The transports are host
code with no device; frames carry numpy columns, never tensors.
"""

from __future__ import annotations

import socketserver
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..device import resolve
from ..metrics.metadata import (ForwardMetadata, Metadata, PipelineMetadata,
                                StagedMetadata)
from ..metrics.matcher import pipeline_from_json, pipeline_to_json
from ..metrics.metric import MetricType, MetricUnion
from ..metrics.policy import StoragePolicy
from ..rpc import wire
from ..utils.health import AdmissionGate, Priority
from ..utils.limits import Backpressure, tenant_of
from .aggregator import Aggregator


def _frame_tenant(e: dict) -> Optional[bytes]:
    """Tenant for admission fair-share: the explicit frame hint `tn`
    when present, else the metric id prefix of the frame's (first) id
    (utils/limits.tenant_of). Forwarded frames are CRITICAL and bypass
    tenant shedding anyway; extraction still tags their depth."""
    tn = e.get("tn")
    if tn is not None:
        return tn if isinstance(tn, bytes) else str(tn).encode()
    mid = e.get("id")
    if mid is None:
        ids = e.get("ids")
        mid = ids[0] if isinstance(ids, (list, tuple)) and ids else None
    if isinstance(mid, (bytes, bytearray, memoryview)):
        return tenant_of(bytes(mid))
    return None


def metadatas_to_wire(metadatas: Sequence[StagedMetadata]) -> list:
    return [
        {
            "cutover": sm.cutover_nanos,
            "tombstoned": sm.tombstoned,
            "pipelines": [
                {
                    "agg_id": pm.aggregation_id,
                    "policies": [str(p) for p in pm.storage_policies],
                    "pipeline": pipeline_to_json(pm.pipeline),
                    "drop": pm.drop_policy,
                }
                for pm in sm.metadata.pipelines
            ],
        }
        for sm in metadatas
    ]


def metadatas_from_wire(obj: list) -> tuple:
    return tuple(
        StagedMetadata(
            d["cutover"], d["tombstoned"],
            Metadata(tuple(
                PipelineMetadata(
                    p["agg_id"],
                    tuple(StoragePolicy.parse(s) for s in p["policies"]),
                    pipeline_from_json(p["pipeline"]),
                    p["drop"],
                )
                for p in d["pipelines"]
            )),
        )
        for d in obj
    )


def union_to_wire(mu: MetricUnion, metadatas: Sequence[StagedMetadata]) -> dict:
    if mu.type == MetricType.TIMER:
        value = list(mu.batch_timer_val)
    elif mu.type == MetricType.COUNTER:
        value = mu.counter_val
    else:
        value = mu.gauge_val
    return {"t": "untimed", "mtype": int(mu.type), "id": mu.id,
            "value": value, "metadatas": metadatas_to_wire(metadatas)}


def forwarded_to_wire(metric_type: MetricType, metric_id: bytes,
                      t_nanos: int, value: float, meta: ForwardMetadata) -> dict:
    return {
        "t": "forwarded", "mtype": int(metric_type), "id": metric_id,
        "time": t_nanos, "value": float(value),
        "agg_id": meta.aggregation_id, "policy": str(meta.storage_policy),
        "pipeline": pipeline_to_json(meta.pipeline),
        "source_id": meta.source_id, "num_times": meta.num_forwarded_times,
    }


def forwarded_batch_to_wire(metric_type: MetricType, rows) -> dict:
    """One flush round's rollup forwards for one (destination, meta
    group) as a COLUMNAR `fbatch` frame (the tbatch shape for the
    forwarded plane): numeric columns ride as raw ndarray buffers, the
    shared meta fields once per frame instead of once per datapoint.
    Rows are (new_id, t_nanos, value, meta, source_id) with identical
    meta group fields (ForwardedWriter.forward_batch groups them)."""
    meta = rows[0][3]
    return {
        "t": "fbatch", "mtype": int(metric_type),
        "agg_id": meta.aggregation_id,
        "policy": str(meta.storage_policy),
        "pipeline": pipeline_to_json(meta.pipeline),
        "num_times": meta.num_forwarded_times,
        "ids": [r[0] for r in rows],
        "source_ids": [r[4] for r in rows],
        "times": np.asarray([r[1] for r in rows], np.int64),
        "values": np.asarray([r[2] for r in rows], np.float64),
    }


def dispatch_forwarded_batch(agg: Aggregator, e: dict):
    """Columnar forwarded batch: meta parsed once, numeric columns
    converted in one C pass, then the tight add_forwarded loop. Validates
    everything that could raise BEFORE the first add (the tbatch
    all-or-nothing contract: a rejected frame never leaves a partially
    aggregated prefix for the sender's retry to double-count)."""
    ids = e["ids"]
    srcs = e["source_ids"]
    times = e["times"]
    values = e["values"]
    if not (len(ids) == len(srcs) == len(times) == len(values)):
        raise ValueError(
            f"fbatch column length mismatch: {len(ids)} ids, "
            f"{len(srcs)} source_ids, {len(times)} times, "
            f"{len(values)} values")
    if not all(isinstance(m, (bytes, bytearray, memoryview))
               for m in ids) or not all(
                   isinstance(m, (bytes, bytearray, memoryview))
                   for m in srcs):
        raise ValueError("fbatch ids/source_ids must all be bytes")
    ids = [m if type(m) is bytes else bytes(m) for m in ids]
    srcs = [m if type(m) is bytes else bytes(m) for m in srcs]
    mt = MetricType(e["mtype"])
    agg_id = e["agg_id"]
    pol = StoragePolicy.parse(e["policy"])
    pipe = pipeline_from_json(e["pipeline"])
    num_times = e["num_times"]
    times = np.asarray(times)
    values = np.asarray(values)
    if times.dtype.kind not in "iuf" or values.dtype.kind not in "iuf":
        raise ValueError("fbatch times/values must be numeric columns")
    if times.ndim != 1 or values.ndim != 1:
        raise ValueError("fbatch times/values must be one-dimensional")
    add = agg.add_forwarded
    for mid, src, t, v in zip(ids, srcs, times.tolist(), values.tolist()):
        add(mt, mid, t, v, ForwardMetadata(
            aggregation_id=agg_id, storage_policy=pol, pipeline=pipe,
            source_id=src, num_forwarded_times=num_times))


def forwarded_from_wire(frame: dict):
    meta = ForwardMetadata(
        aggregation_id=frame["agg_id"],
        storage_policy=StoragePolicy.parse(frame["policy"]),
        pipeline=pipeline_from_json(frame["pipeline"]),
        source_id=frame["source_id"],
        num_forwarded_times=frame["num_times"],
    )
    return (MetricType(frame["mtype"]), frame["id"], frame["time"],
            frame["value"], meta)


def union_from_wire(frame: dict):
    mt = MetricType(frame["mtype"])
    mid = frame["id"]
    value = frame["value"]
    if mt == MetricType.TIMER:
        mu = MetricUnion.batch_timer(mid, [float(v) for v in value])
    elif mt == MetricType.COUNTER:
        mu = MetricUnion.counter(mid, int(value))
    else:
        mu = MetricUnion.gauge(mid, float(value))
    return mu, metadatas_from_wire(frame["metadatas"])


class RawTCPServer:
    """Accepts connections from aggregator clients; every frame feeds the
    local Aggregator (rawtcp/server.go handleConnection).

    Ingest admission: in-flight records are bounded by an AdmissionGate.
    The raw-TCP protocol is fire-and-forget (no per-record ack channel),
    so shed records are DROPPED and counted (`shed`) — collectors see
    loss in the counters, while producers speaking the acked msg path
    get real backpressure at the consumer. `forwarded` frames (partial
    aggregates between pipeline stages — already-accepted work whose
    loss corrupts downstream rollups) are CRITICAL and never shed; a
    frame may self-mark `"pri": "bulk"` (backfill replay) to shed
    first at the high watermark."""

    def __init__(self, aggregator: Aggregator, host: str = "127.0.0.1",
                 port: int = 0, gate: Optional[AdmissionGate] = None):
        self.device = resolve(aggregator.device)
        self.aggregator = aggregator
        self.gate = gate if gate is not None else AdmissionGate(
            capacity=8192, name="aggregator.rawtcp")
        self.frames = 0
        self.errors = 0
        self.shed = 0
        # Counters are bumped from per-connection handler threads; a plain
        # += is a non-atomic load/add/store that loses increments.
        self._stats_lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # Per-message dual-format reader: current framed codec and
                # the legacy JSON-line protocol share one port during client
                # migration (encoding/migration/unaggregated_iterator.go).
                from .migration import MigrationReader, RecoverableRecordError

                reader = MigrationReader(self.request)
                try:
                    while True:
                        try:
                            entries = reader.read_entries()
                        except RecoverableRecordError:
                            # one bad legacy record, stream still aligned
                            with outer._stats_lock:
                                outer.errors += 1
                            continue
                        except ValueError:
                            # binary framing is unrecoverable mid-stream
                            with outer._stats_lock:
                                outer.errors += 1
                            break
                        # frames counts successfully ingested RECORDS (a
                        # columnar tbatch carries one per id); a failed
                        # dispatch contributes errors, not phantom frames.
                        n_rec = sum(outer._handle(e) for e in entries)
                        with outer._stats_lock:
                            outer.frames += n_rec
                except (ConnectionError, OSError):
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)

    def _handle(self, e: dict) -> int:
        """Dispatch one entry; returns the record count it ingested
        (len(ids) for a columnar tbatch, else 1), 0 on failure. Both
        counters are in RECORDS: a failed tbatch charges its id count to
        `errors` (tbatch dispatch validates before the first add, so a
        failure means the whole frame was rejected — nothing partial)."""
        def _records() -> int:
            if e.get("t") not in ("tbatch", "fbatch"):
                return 1
            ids = e.get("ids")
            return len(ids) if isinstance(ids, (list, tuple)) else 1

        n = _records()
        pri = (Priority.CRITICAL if e.get("t") in ("forwarded", "fbatch")
               else Priority.BULK if e.get("pri") == "bulk"
               else Priority.NORMAL)
        try:
            with self.gate.held(n, priority=pri, tenant=_frame_tenant(e)):
                dispatch_entry(self.aggregator, e)
        except Backpressure:
            # fire-and-forget transport: shed = counted drop (the msg
            # path's consumer converts the same condition into a skipped
            # ack, i.e. real producer backpressure)
            with self._stats_lock:
                self.shed += n
            return 0
        except Exception:  # noqa: BLE001 - bad frame must not kill the conn
            with self._stats_lock:
                self.errors += n
            return 0
        return n

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def start(self) -> "RawTCPServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def dispatch_entry(agg: Aggregator, e: dict):
    """Route one current-schema entry into the aggregator — the shared
    sink behind both transports (rawtcp frames and HTTP ingest)."""
    if e["t"] == "untimed":
        mu, metadatas = union_from_wire(e)
        agg.add_untimed(mu, metadatas)
    elif e["t"] == "timed":
        agg.add_timed(
            MetricType(e["mtype"]), e["id"], e["time"], e["value"],
            StoragePolicy.parse(e["policy"]), e.get("agg_id", 0))
    elif e["t"] == "tbatch":
        dispatch_timed_batch(agg, e)
    elif e["t"] == "fbatch":
        dispatch_forwarded_batch(agg, e)
    elif e["t"] == "forwarded":
        mt, mid, t_nanos, value, meta = forwarded_from_wire(e)
        agg.add_forwarded(mt, mid, t_nanos, value, meta)
    else:
        raise ValueError(f"unknown entry type {e.get('t')!r}")


def dispatch_timed_batch(agg: Aggregator, e: dict):
    """Columnar timed batch: type/policy parsed once, numeric columns
    converted in one C pass (tolist), then the tight add_timed loop. A
    length mismatch between the columns is a malformed frame (ValueError
    -> the caller's per-entry error accounting)."""
    ids = e["ids"]
    times = e["times"]
    values = e["values"]
    if not (len(ids) == len(times) == len(values)):
        raise ValueError(
            f"tbatch column length mismatch: {len(ids)} ids, "
            f"{len(times)} times, {len(values)} values")
    # Validate EVERYTHING that could raise before the first add: the
    # frame must ingest all-or-nothing, or a mid-loop failure would leave
    # a prefix aggregated while the stats report the whole frame failed
    # (and a sender retry would double-count that prefix).
    if not all(isinstance(m, (bytes, bytearray, memoryview)) for m in ids):
        raise ValueError("tbatch ids must all be bytes")
    # Normalize ids to bytes AFTER the isinstance gate: add_timed ->
    # shard_for memoizes on the id, and a bytearray/memoryview that
    # passed validation would raise (unhashable) on the Nth add.
    ids = [m if type(m) is bytes else bytes(m) for m in ids]
    mt = MetricType(e["mtype"])
    pol = StoragePolicy.parse(e["policy"])
    agg_id = e.get("agg_id", 0)
    # One C-pass conversion doubling as element validation: a list with a
    # non-numeric mid-array element coerces to a non-numeric dtype and is
    # rejected HERE, never mid-loop (np.asarray also raises ValueError on
    # ragged input).
    times = np.asarray(times)
    values = np.asarray(values)
    if times.dtype.kind not in "iuf" or values.dtype.kind not in "iuf":
        raise ValueError("tbatch times/values must be numeric columns")
    if times.ndim != 1 or values.ndim != 1:
        raise ValueError("tbatch times/values must be one-dimensional")
    times = times.tolist()
    values = values.tolist()
    add = agg.add_timed
    for mid, t, v in zip(ids, times, values):
        add(mt, mid, t, v, pol, agg_id)


class HTTPAdminServer:
    """Aggregator HTTP sidecar (src/aggregator/server/http/handlers.go):
    GET /health, GET /status (runtime flush/election status), and
    POST /resign to step down from flush leadership before maintenance —
    plus an HTTP INGEST variant: POST /ingest accepts newline-delimited
    legacy-schema JSON records (the migration reader's entry model,
    migration.legacy_to_entry), so collectors behind an HTTP-only network
    path can write without speaking the framed binary codec."""

    def __init__(self, aggregator: Aggregator, host: str = "127.0.0.1",
                 port: int = 0):
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.device = resolve(aggregator.device)
        agg = aggregator

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, obj: dict):
                body = _json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, {"state": "OK"})
                elif self.path == "/status":
                    election = getattr(agg, "_election", None)
                    flush = {
                        "electionState": (election.state.name.lower()
                                          if election else "leader"),
                        "canLead": (election.is_leader()
                                    if election else True),
                    }
                    self._reply(200, {"status": {
                        "flushStatus": flush,
                        "numEntries": agg.num_entries(),
                        "forwardedReceived": agg.forwarded_received,
                    }})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/resign":
                    election = getattr(agg, "_election", None)
                    if election is None:
                        self._reply(400, {"error": "not running an election"})
                        return
                    try:
                        election.resign()
                        self._reply(200, {"state": "OK"})
                    except Exception as e:  # noqa: BLE001
                        self._reply(500, {"error": str(e)})
                elif self.path == "/ingest":
                    from .migration import legacy_to_entry

                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length)
                    accepted, errors = 0, []
                    for i, line in enumerate(body.splitlines()):
                        if not line.strip():
                            continue
                        try:
                            dispatch_entry(
                                agg, legacy_to_entry(_json.loads(line)))
                            accepted += 1
                        except Exception as e:  # noqa: BLE001
                            errors.append(f"record {i}: {e}")
                    code = 200 if not errors else 400
                    self._reply(code, {"accepted": accepted,
                                       "errors": errors[:16]})
                else:
                    self._reply(404, {"error": "not found"})

        self._server = ThreadingHTTPServer((host, port), _Handler)

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"http://{h}:{p}"

    def start(self) -> "HTTPAdminServer":
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()


class _BatchingTransport:
    """Shared client-side batching scaffolding: __call__ encodes one metric
    and appends; a full batch (or flush()) sends via the subclass's
    _send_batch. Encoding failures return False like delivery failures —
    the AggregatorClient transport contract is bool, never an exception."""

    def __init__(self, batch_size: int = 64):
        self._lock = threading.Lock()
        self._batch: List = []
        self._batch_size = batch_size

    def _encode(self, mu: MetricUnion, metadatas: Sequence[StagedMetadata]):
        raise NotImplementedError

    def _send_batch(self, batch: List) -> bool:
        raise NotImplementedError

    def __call__(self, mu: MetricUnion, metadatas: Sequence[StagedMetadata]) -> bool:
        try:
            entry = self._encode(mu, metadatas)
        except Exception:  # noqa: BLE001 - count as a dropped write
            return False
        with self._lock:
            self._batch.append(entry)
            if len(self._batch) < self._batch_size:
                return True
            batch, self._batch = self._batch, []
        return self._send_batch(batch)

    def flush(self) -> bool:
        with self._lock:
            batch, self._batch = self._batch, []
        return self._send_batch(batch) if batch else True


class HTTPTransport(_BatchingTransport):
    """Client-side HTTP ingest to one aggregator admin endpoint, usable as
    an AggregatorClient transport anywhere only HTTP traverses the network
    path. Serializes each metric as a legacy-schema record (the migration
    entry model) and POSTs newline-delimited batches to /ingest; staged
    metadatas flatten to their storage policies, which is exactly the
    information the legacy schema carries. Ids must be UTF-8 (the legacy
    JSON schema is text); non-decodable ids count as dropped writes."""

    def __init__(self, endpoint: str, batch_size: int = 64, timeout_s: float = 5.0):
        super().__init__(batch_size)
        self._url = endpoint.rstrip("/") + "/ingest"
        self._timeout_s = timeout_s

    def _encode(self, mu: MetricUnion, metadatas: Sequence[StagedMetadata]) -> bytes:
        import json as _json

        from .migration import _LEGACY_TYPES

        # inverse of the migration reader's type table, so /ingest always
        # accepts this transport's output
        type_names = {v: k for k, v in _LEGACY_TYPES.items()}
        policies = [str(p) for sm in metadatas
                    for pm in sm.metadata.pipelines
                    for p in pm.storage_policies]
        value = (list(mu.batch_timer_val) if mu.type == MetricType.TIMER
                 else mu.counter_val if mu.type == MetricType.COUNTER
                 else mu.gauge_val)
        return _json.dumps({"type": type_names[mu.type],
                            "id": mu.id.decode(),
                            "value": value, "policies": policies}).encode()

    def _send_batch(self, batch: List[bytes]) -> bool:
        import json as _json
        import urllib.request

        req = urllib.request.Request(
            self._url, data=b"\n".join(batch) + b"\n", method="POST",
            headers={"Content-Type": "application/x-ndjson"})
        try:
            with urllib.request.urlopen(req, timeout=self._timeout_s) as r:
                return _json.loads(r.read()).get("accepted", 0) == len(batch)
        except OSError:
            return False


class TCPTransport(_BatchingTransport):
    """Client-side connection to one aggregator instance, usable as an
    AggregatorClient transport (aggregator/client queue.go: buffered
    connection with reconnect)."""

    def __init__(self, endpoint: str, batch_size: int = 64):
        super().__init__(batch_size)
        self._endpoint = endpoint
        self._sock = None

    def _encode(self, mu: MetricUnion, metadatas: Sequence[StagedMetadata]) -> dict:
        return union_to_wire(mu, metadatas)

    def send_timed_batch(self, metric_type: MetricType, policy,
                         ids: Sequence[bytes], times, values,
                         agg_id: int = 0) -> bool:
        """Ship one (type, policy) group of timed datapoints as a single
        columnar tbatch frame — the codec writes the numeric columns as
        raw buffers and the keys once, so the per-datapoint wire cost is
        ~the raw bytes. This is the client half of the reference's timed
        batching (client.go WriteTimed + queue buffering)."""
        import numpy as _np

        return self._send_frame({
            "t": "tbatch", "mtype": int(metric_type), "policy": str(policy),
            "agg_id": agg_id, "ids": list(ids),
            "times": _np.asarray(times, _np.int64),
            "values": _np.asarray(values, _np.float64),
        })

    def send_forwarded_batch(self, metric_type: MetricType, rows) -> bool:
        """Deliver one flush round's rollup partials for one meta group
        as ONE columnar fbatch frame (forwarded_batch_to_wire) — the
        batched twin of send_forwarded, one frame per destination per
        round instead of one per datapoint. Rows are
        (new_id, t_nanos, value, meta, source_id)."""
        if not rows:
            return True
        with self._lock:
            batch, self._batch = self._batch, []
        if batch and not self._send_batch(batch):
            # The piggybacked client-buffer flush failed: re-buffer those
            # entries for the next send instead of folding their fate
            # into THIS frame's result — ForwardedWriter counts forward
            # drops from our return value, and a delivered fbatch must
            # not be reported dropped because unrelated buffered metrics
            # hit a dead connection.
            with self._lock:
                self._batch = batch + self._batch
        return self._send_frame(forwarded_batch_to_wire(metric_type, rows))

    def send_forwarded(self, metric_type: MetricType, metric_id: bytes,
                       t_nanos: int, value: float,
                       meta: ForwardMetadata) -> bool:
        """Deliver a partial aggregate to the next pipeline stage's owner.

        Sent immediately (not batched): forwards happen at flush boundaries,
        and the downstream stage's flush deadline is already ticking
        (forwarded_writer.go Flush)."""
        with self._lock:
            batch, self._batch = self._batch, []
        batch.append(forwarded_to_wire(metric_type, metric_id, t_nanos,
                                       value, meta))
        return self._send_batch(batch)

    def _send_batch(self, batch: List[dict]) -> bool:
        return self._send_frame({"t": "batch", "entries": batch})

    def _send_frame(self, frame: dict) -> bool:
        """Write one frame with one reconnect attempt — the shared send
        loop behind batch and tbatch shipping."""
        for _ in range(2):
            try:
                sock = self._ensure_conn()
                wire.write_frame(sock, frame)
                return True
            except OSError:
                self._drop_conn()
        return False

    def _ensure_conn(self):
        if self._sock is None:
            import socket as _socket

            host, _, port = self._endpoint.rpartition(":")
            self._sock = _socket.create_connection((host, int(port)), timeout=5.0)
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
        """Drop the connection and discard buffered entries — callers are
        placement updates retiring a stale peer, where flushing would send
        metrics to an instance that no longer owns them. Flush explicitly
        first for a graceful shutdown."""
        with self._lock:
            self._batch = []
        self._drop_conn()
