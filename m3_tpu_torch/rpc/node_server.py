"""Node RPC service + TCP server (port of m3_tpu/rpc/node_server.py;
reference: src/dbnode/network/server/tchannelthrift/node/service.go).

Method parity with the thrift `Node` service: Write (:743),
WriteBatchRaw (:827), WriteTaggedBatchRaw (:900), Fetch (:323),
FetchTagged (:396), FetchBlocksRaw (:535), FetchBlocksMetadataRawV2
(:608), Query (:255), Truncate (:993), Health (:210). FetchTagged /
FetchBlocks return *encoded* block segments (packed u32 TSZ codewords)
plus raw mutable-buffer columns — decompression happens in the client
with the batched decode kernel, as the reference decodes client-side
(docs/m3db/architecture/engine.md:167).

The service runs on its database's device (None: the CUDA card, raising
without one): the hash kernel routes every write batch, the pack kernel
seals the blocks a tick closes, and the decode kernel serves reads. The
handler threads of the ThreadingTCPServer launch them concurrently. Only
numpy arrays go into the response frames (SealedBlock words, nbits and
npoints are host arrays): a tensor never reaches the wire. A kernel that
raises on the card comes back to the caller as a typed error frame; the
service never re-runs the work on the CPU."""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve
from ..storage.database import Database
from ..storage.series import charge_read
from ..utils import limits as xlimits
from ..utils import tracing
from ..utils.health import AdmissionGate, Priority
from ..utils.limits import ResourceExhausted
from ..utils.retry import Deadline, DeadlineExceeded
from . import wire


class RPCError(Exception):
    """Server-side error carried back over the wire."""


# Priority classification for admission control: the traffic whose loss
# turns an overload into an outage is CRITICAL and is never shed —
# health/admin probes (operators must see INTO an overloaded node) and
# replication/bootstrap streams (shedding them converts one overloaded
# replica into an under-replicated shard). Everything else is NORMAL
# serving traffic unless the request frame marks itself "bulk"
# (backfill), which sheds first at the high watermark.
_CRITICAL_METHODS = frozenset({
    "health", "namespaces", "truncate",
    "fetch_blocks", "fetch_blocks_metadata", "fetch_block_tiles",
    "fetch_block_metadata_tiles",
})


def method_priority(method: str, hint: Optional[str] = None) -> Priority:
    if method in _CRITICAL_METHODS:
        return Priority.CRITICAL
    if hint == "bulk":
        return Priority.BULK
    return Priority.NORMAL


class NodeService:
    """Dispatchable method table over a storage.Database, fronted by a
    bounded admission gate: in-flight requests past the high watermark
    shed bulk backfill, past capacity shed normal serving traffic too —
    with typed Backpressure so producers back off — while health/admin
    and replication always get through."""

    def __init__(self, db: Database, gate: Optional[AdmissionGate] = None,
                 limits: Optional[xlimits.QueryLimits] = None, *,
                 device=None):
        """device: where the service's kernels run (None: the CUDA card,
        raising without one); it must be the database's."""
        self.device = resolve(device)
        if db.device != self.device:
            raise ValueError(f"the database runs on {db.device}, the "
                             f"service on {self.device}")
        self.db = db
        # monotonic, not wall clock: uptime is an ELAPSED measurement and
        # must not jump with NTP steps (m3lint wall-clock-latency).
        self.start_ns = time.monotonic_ns()
        # Default gate is generous (threaded server, sub-ms dispatches:
        # 1024 in flight means the node is drowning) but FINITE — overload
        # protection must be on by default, not a config opt-in.
        self.gate = gate if gate is not None else AdmissionGate(
            capacity=1024, name="rpc.node")
        self._limits = limits
        # Per-request deadline, thread-local because the ThreadingTCPServer
        # dispatches each connection on its own thread: rpc_* methods read
        # it to bail out of long loops once the caller's budget is gone.
        self._local = threading.local()

    # --------------------------------------------------------------- dispatch

    def dispatch(self, method: str, args: dict,
                 deadline: Optional[Deadline] = None,
                 priority_hint: Optional[str] = None,
                 trace_ctx=None):
        result, _sp = self.dispatch_traced(method, args, deadline,
                                           priority_hint, trace_ctx)
        return result

    def dispatch_traced(self, method: str, args: dict,
                        deadline: Optional[Deadline] = None,
                        priority_hint: Optional[str] = None,
                        trace_ctx=None):
        """dispatch + span plumbing: returns (result, finished span dict
        or None). A request frame carrying the "tr" context gets a
        remote-parented span around its whole dispatch — QueryScope exit
        annotates it with the request's cost tallies — and the finished
        tree rides the response frame back for the caller to graft
        (tracing module docstring). Untraced requests pay one NOOP test."""
        fn = getattr(self, "rpc_" + method, None)
        if fn is None:
            raise RPCError(f"unknown method {method!r}")
        # Check BEFORE the work: a request whose budget is already spent
        # in queueing/transit must not run an expensive fetch whose result
        # the caller stopped waiting for.
        if deadline is not None:
            deadline.check(method)
        ql = self._limits if self._limits is not None else xlimits.get_global()
        # Admission THEN limits scope: a shed request must cost nothing
        # beyond the gate check. The scope's child enforcers chain every
        # storage/index charge below this request to the global budgets
        # and release them all on the way out — 1k rejected queries leak
        # zero budget (asserted by scripts/overload_smoke.py).
        priority = method_priority(method, priority_hint)
        sp = tracing.TRACER.span_from(trace_ctx, "rpc." + method)
        # A shed BEFORE the scope runs (gate full) must log empty costs,
        # not the previous request's on this reused serving thread.
        xlimits.reset_last_totals()
        t0 = time.perf_counter_ns()
        try:
            with sp:
                with self.gate.held(priority=priority):
                    with ql.scope(f"rpc.{method}"):
                        self._local.deadline = deadline
                        # Down-stack admission (shard insert queues) sheds
                        # by the same priority the gate admitted at — BULK
                        # backfill that squeezed past the gate still sheds
                        # first at a full queue, and CRITICAL replication
                        # never sheds.
                        self._local.priority = priority
                        try:
                            result = fn(**args)
                        finally:
                            self._local.deadline = None
                            self._local.priority = None
        except ResourceExhausted:
            tracing.SLOW_QUERIES.maybe(
                "rpc", method, time.perf_counter_ns() - t0,
                costs=xlimits.last_scope_totals(), reason="limit-shed",
                trace_id=sp.trace_id or None)
            raise
        except DeadlineExceeded:
            tracing.SLOW_QUERIES.maybe(
                "rpc", method, time.perf_counter_ns() - t0,
                costs=xlimits.last_scope_totals(), reason="deadline",
                trace_id=sp.trace_id or None)
            raise
        dur = time.perf_counter_ns() - t0
        tracing.SLOW_QUERIES.maybe(
            "rpc", method, dur,
            # Sampled: lazy subtree rollup (cache events live on storage
            # child spans); unsampled: the scope's charge totals.
            costs=((lambda: tracing.collect_costs(sp)) if sp.sampled
                   else xlimits.last_scope_totals()),
            trace_id=sp.trace_id or None)
        return result, (sp.to_dict() if sp.sampled else None)

    def _check_deadline(self, what: str):
        dl = getattr(self._local, "deadline", None)
        if dl is not None:
            dl.check(what)

    def _request_priority(self) -> Priority:
        pri = getattr(self._local, "priority", None)
        return Priority.NORMAL if pri is None else pri

    # ----------------------------------------------------------------- health

    def rpc_health(self):
        return {
            "ok": True,
            "bootstrapped": self.db.bootstrapped,
            "uptime_ns": time.monotonic_ns() - self.start_ns,
        }

    # ----------------------------------------------------------------- writes

    def rpc_write(self, ns: bytes, id: bytes, t_ns: int, value: float,
                  tags: Optional[dict] = None):
        """Concurrency is per shard, not global: the storage layer holds a
        per-shard write lock (storage/shard.py write_lock, the reference's
        shard.go:769 per-shard RWMutex), the reverse index and commit log
        serialize internally, so writes to different shards proceed in
        parallel across server threads."""
        self.db.write(ns, id, t_ns, value, tags,
                      priority=self._request_priority())
        return True

    def rpc_write_batch(self, ns: bytes, ids: list, ts: np.ndarray, vals: np.ndarray,
                        tags: Optional[list] = None):
        self.db.write_batch(ns, ids, ts, vals, tags,
                            priority=self._request_priority())
        return len(ids)

    # ------------------------------------------------------------------ reads

    def rpc_fetch(self, ns: bytes, id: bytes, start_ns: int, end_ns: int):
        t, v = self.db.read(ns, id, start_ns, end_ns)
        return {"t": t, "v": v}

    def rpc_fetch_tagged(self, ns: bytes, query: dict, start_ns: int, end_ns: int,
                         fetch_data: bool = True, limit: int = 0):
        """FetchTagged with a COLUMNAR result frame: per-series entries
        carry only identity (id + tags — host label algebra); the data
        plane rides beside them as ONE buffer sidecar (concatenated
        mutable-buffer columns + an offsets vector) and one TILE per
        (shard, sealed block) — the requested rows fancy-indexed out of
        the block's word matrix in one numpy op, the same tile shape
        peer streaming moves (rpc_fetch_block_tiles) and the client's
        batched device decode consumes (client/decode.decode_tile).
        Pre-change this loop built one dict of segments per series —
        per-row python materialization on the hot read fan-in."""
        q = wire.query_from_wire(query)
        nsobj = self.db.namespace(ns)
        ids = self.db.query_ids(ns, q, start_ns, end_ns, limit=limit)
        out = []
        by_shard: Dict[int, List[Tuple[int, int]]] = {}  # -> (idx, pos)
        for sid in ids:
            # Mid-loop budget check: fetch_tagged is the expensive fan-in;
            # a dead caller's request must stop here, not run the whole
            # result set to completion.
            self._check_deadline("fetch_tagged")
            shard_id = self.db.shard_set.lookup(sid)
            shard = nsobj.shards.get(shard_id)
            if shard is None:
                continue
            idx = shard.registry.get(sid)
            if idx is None:
                # Indexed on another replica's time range but not written
                # here: identity-only row, no buffer/tile contribution.
                out.append({"id": sid, "tags": {}})
                continue
            # identity cost (id + tag pairs) charges bytes-read before the
            # segment payloads do — a tags-only fetch is still metered
            charge_read(n_bytes=shard.registry.entry_bytes(idx))
            if fetch_data:
                by_shard.setdefault(shard_id, []).append((idx, len(out)))
            out.append({"id": sid, "tags": shard.registry.tags_of(idx) or {}})
        n = len(out)
        buf_t = [np.zeros(0, np.int64)] * n
        buf_v = [np.zeros(0, np.float64)] * n
        tiles: List[dict] = []
        for shard_id in sorted(by_shard):
            shard = nsobj.shards[shard_id]
            members = by_shard[shard_id]
            # Buffer reads take the shard write lock in bounded CHUNKS —
            # a dashboard-sized member set must not stall every
            # concurrent write for one uninterrupted sweep (the
            # per-series path re-acquired per row; chunking keeps that
            # bound without paying the lock once per series). The block
            # snapshot MERGES under every chunk's acquisition: a tick
            # sealing the buffer between chunks moves later chunks'
            # points into a block the first snapshot predates — the
            # union sees it (earlier chunks may then appear in both
            # their buffer read and the new block's tile; duplicate
            # timestamps carry identical values and the client's
            # replica merge dedups them, same as a replica overlap).
            # Each chunk charges its buffer bytes BEFORE the next
            # materializes (query_limits.go bytes-read: reject an
            # oversized fetch mid fan-in).
            blocks: Dict[int, object] = {}
            chunk = 256
            for c0 in range(0, len(members), chunk):
                self._check_deadline("fetch_tagged")
                part = members[c0:c0 + chunk]
                with shard.write_lock:  # snapshot racing tick's expiry/seal
                    blocks.update(shard.blocks)
                    for idx, pos in part:
                        buf_t[pos], buf_v[pos] = shard.buffer.read(
                            idx, start_ns, end_ns)
                charge_read(n_bytes=sum(
                    buf_t[pos].nbytes + buf_v[pos].nbytes
                    for _, pos in part))
            for bs in sorted(blocks):
                blk = blocks[bs]
                if bs + shard.opts.block_size_ns <= start_ns or bs >= end_ns:
                    continue
                rows, poss = [], []
                for idx, pos in members:
                    row = blk.row_of(idx)
                    if row is not None:
                        rows.append(row)
                        poss.append(pos)
                if not rows:
                    continue
                self._check_deadline("fetch_tagged")
                # Charge BEFORE the tile materializes (query_limits.go
                # bytes-read): an oversized result must be rejected mid
                # fan-in, not after every tile copy has been allocated —
                # the same incremental guard the per-series path had.
                all_words = np.asarray(blk.words)
                rows_a = np.asarray(rows, np.int64)
                charge_read(
                    n_bytes=len(rows) * all_words.shape[-1]
                    * all_words.itemsize)
                tiles.append({
                    "bs": bs,
                    "rows": np.asarray(poss, np.int32),
                    "words": all_words[rows_a],
                    "nbits": np.asarray(blk.nbits)[rows_a].astype(np.int32),
                    "npoints": np.asarray(blk.npoints)[rows_a].astype(
                        np.int32),
                    "window": int(blk.window),
                    "time_unit": int(blk.time_unit),
                })
        offs = np.zeros(n + 1, np.int64)
        if n:
            offs[1:] = np.cumsum([t.size for t in buf_t])
        bufs = {
            "offs": offs,
            "t": (np.concatenate(buf_t) if n else np.zeros(0, np.int64)),
            "v": (np.concatenate(buf_v) if n else np.zeros(0, np.float64)),
        }
        return {"series": out, "bufs": bufs, "tiles": tiles,
                "exhaustive": True}

    def rpc_query(self, ns: bytes, query: dict, start_ns: int, end_ns: int):
        """service.go:255 Query: ids + tags only (no data)."""
        r = self.rpc_fetch_tagged(ns, query, start_ns, end_ns, fetch_data=False)
        return {"series": [{"id": s["id"], "tags": s["tags"]} for s in r["series"]]}

    def rpc_aggregate(self, ns: bytes, query: dict, start_ns: int, end_ns: int,
                      name_only: bool = False, field_filter: list = (),
                      term_limit: int = 0):
        """AggregateRaw analog (service.go:474 Aggregate / AggregateRaw):
        distinct tag names (and optionally values) for series matching the
        query, computed server-side from the reverse index — no datapoints
        shipped. An AllQuery short-circuits to the index's field/term
        dictionaries instead of materializing postings."""
        fields = self.db.aggregate_tags(
            ns, wire.query_from_wire(query), start_ns, end_ns,
            name_only=name_only, filter_names=field_filter)
        out = []
        for name in sorted(fields):
            vals = sorted(fields[name])
            if term_limit:
                vals = vals[:term_limit]
            out.append({"name": name, "values": vals})
        return {"fields": out, "name_only": bool(name_only)}

    # -------------------------------------------- block/metadata peer streaming

    def rpc_fetch_blocks_metadata(self, ns: bytes, shard: int, start_ns: int,
                                  end_ns: int, page_token: int = 0,
                                  limit: int = 1024):
        """FetchBlocksMetadataRawV2: paged per-series sealed block metadata."""
        nsobj = self.db.namespace(ns)
        sh = nsobj.shards.get(shard)
        if sh is None:
            return {"series": [], "next_page_token": None}
        all_ids = sh.registry.all_ids()
        out = []
        i = page_token
        with sh.write_lock:  # snapshot racing tick's expiry/seal
            shard_blocks = dict(sh.blocks)
        while i < len(all_ids) and len(out) < limit:
            sid = all_ids[i]
            idx = sh.registry.get(sid)
            blocks = []
            for bs in sorted(shard_blocks):
                blk = shard_blocks[bs]
                if bs + sh.opts.block_size_ns <= start_ns or bs >= end_ns:
                    continue
                row = blk.row_of(idx)
                if row is None:
                    continue
                blocks.append({
                    "bs": bs,
                    "nbits": int(blk.nbits[row]),
                    "npoints": int(blk.npoints[row]),
                    "checksum": int(blk.row_checksums()[row]),
                })
            out.append({"id": sid, "tags": sh.registry.tags_of(idx) or {},
                        "blocks": blocks})
            i += 1
        next_token = i if i < len(all_ids) else None
        return {"series": out, "next_page_token": next_token}

    def rpc_fetch_blocks(self, ns: bytes, shard: int, requests: list):
        """FetchBlocksRaw: encoded rows for [(id, [block_starts])] requests."""
        nsobj = self.db.namespace(ns)
        sh = nsobj.shards.get(shard)
        out = []
        if sh is not None:
            with sh.write_lock:  # snapshot racing tick's expiry/seal
                shard_blocks = dict(sh.blocks)
        for req in requests:
            sid = req["id"]
            entry = {"id": sid, "blocks": []}
            if sh is not None:
                idx = sh.registry.get(sid)
                if idx is not None:
                    for bs in req["block_starts"]:
                        blk = shard_blocks.get(bs)
                        if blk is None:
                            continue
                        row = blk.row_of(idx)
                        if row is None:
                            continue
                        entry["blocks"].append({
                            "bs": bs,
                            "words": np.asarray(blk.words[row]),
                            "nbits": int(blk.nbits[row]),
                            "npoints": int(blk.npoints[row]),
                            "window": int(blk.window),
                            "time_unit": int(blk.time_unit),
                        })
            out.append(entry)
        return {"series": out}

    def rpc_fetch_block_metadata_tiles(self, ns: bytes, shard: int,
                                       start_ns: int, end_ns: int,
                                       page_token: int = 0,
                                       limit: int = 8192):
        """Columnar FetchBlocksMetadataRawV2: one page covers a
        contiguous registry-index window [page_token, page_token+limit)
        and returns the page's ids/tags plus, per sealed block, the
        positions (into the page's ids) and row checksums as ARRAYS —
        no per-series dicts on the wire. Registry indices are assigned
        densely in insertion order and block series_indices are sorted,
        so each block's page rows are one searchsorted slice."""
        nsobj = self.db.namespace(ns)
        sh = nsobj.shards.get(shard)
        if sh is None:
            return {"ids": [], "tags": [], "blocks": [],
                    "next_page_token": None}
        all_ids = sh.registry.all_ids()
        i0 = int(page_token)
        i1 = min(len(all_ids), i0 + int(limit))
        ids = all_ids[i0:i1]
        tags = [sh.registry.tags_of(i0 + j) or {} for j in range(len(ids))]
        with sh.write_lock:  # snapshot racing tick's expiry/seal
            shard_blocks = dict(sh.blocks)
        blocks = []
        total_bytes = sum(len(s) for s in ids)
        for bs in sorted(shard_blocks):
            self._check_deadline("fetch_block_metadata_tiles")
            blk = shard_blocks[bs]
            if bs + sh.opts.block_size_ns <= start_ns or bs >= end_ns:
                continue
            si = blk.series_indices
            lo = int(np.searchsorted(si, i0))
            hi = int(np.searchsorted(si, i1))
            if lo == hi:
                continue
            # Memoized per-block row checksums: repeated metadata pages
            # (every repair sweep, every bootstrap) reuse one pass.
            sums = blk.row_checksums()[lo:hi]
            total_bytes += sums.nbytes
            blocks.append({
                "bs": bs,
                "pos": np.ascontiguousarray(si[lo:hi] - i0, np.int32),
                "sums": sums,
            })
        charge_read(n_bytes=int(total_bytes))
        next_token = i1 if i1 < len(all_ids) else None
        return {"ids": ids, "tags": tags, "blocks": blocks,
                "next_page_token": next_token}

    def rpc_fetch_block_tiles(self, ns: bytes, shard: int, blocks: list):
        """Columnar FetchBlocksRaw: for [{"bs", "ids": [...]}] requests,
        return per-block TILES — one [rows, max_words] word matrix plus
        nbits/npoints columns and the row-aligned id list — instead of
        one dict per series. The whole tile is three fancy-indexes into
        the sealed block's arrays, and the client applies it as one
        batched registry insert + one block install (the peer-streaming
        data plane's unit of work; ids absent locally or rows the block
        doesn't hold are simply absent from the response ids)."""
        nsobj = self.db.namespace(ns)
        sh = nsobj.shards.get(shard)
        out = []
        if sh is None:
            return {"blocks": out}
        with sh.write_lock:  # snapshot racing tick's expiry/seal
            shard_blocks = dict(sh.blocks)
        for req in blocks:
            self._check_deadline("fetch_block_tiles")
            bs = int(req["bs"])
            blk = shard_blocks.get(bs)
            if blk is None:
                continue
            ids = req["ids"]
            idxs = sh.registry.lookup_batch(ids)
            known = idxs >= 0
            # Row resolve for every known id in one vectorized search
            # (series_indices is sorted).
            cand = np.searchsorted(blk.series_indices, idxs[known])
            cand = np.minimum(cand, len(blk.series_indices) - 1)
            present = blk.series_indices[cand] == idxs[known]
            rows = cand[present]
            if not len(rows):
                continue
            kpos = np.flatnonzero(known)[present]
            words = np.ascontiguousarray(blk.words[rows])
            charge_read(n_bytes=int(words.nbytes))
            out.append({
                "bs": bs,
                "ids": [ids[int(i)] for i in kpos],
                "words": words,
                "nbits": np.ascontiguousarray(blk.nbits[rows]),
                "npoints": np.ascontiguousarray(blk.npoints[rows]),
                "window": int(blk.window),
                "time_unit": int(blk.time_unit),
            })
        return {"blocks": out}

    # ------------------------------------------------------------------ admin

    def rpc_truncate(self, ns: bytes):
        nsobj = self.db.namespace(ns)
        n = sum(sh.num_series() for sh in nsobj.shards.values())
        shard_ids = list(nsobj.shards)
        for sid in shard_ids:
            nsobj.remove_shard(sid)
            nsobj.assign_shard(sid)
        return n

    def rpc_namespaces(self):
        out = []
        for name, nsobj in list(self.db.namespaces.items()):
            out.append({
                "name": name,
                "retention_ns": nsobj.opts.retention_ns,
                "block_size_ns": nsobj.opts.block_size_ns,
                "index_enabled": nsobj.opts.index_enabled,
                "num_shards": len(nsobj.shards),
            })
        return out


class NodeServer:
    """Threaded TCP listener dispatching wire frames to a NodeService
    (tchannelthrift NewServer + ListenAndServe equivalent)."""

    def __init__(self, service: NodeService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        svc = self.service

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        req = wire.read_dict_frame(sock)
                        msg_id = req.get("id", 0)
                        # Optional deadline budget (ns remaining at send
                        # time) rides the request frame as "d"; re-anchored
                        # on this host's monotonic clock.
                        deadline = wire.deadline_from_frame(req)
                        try:
                            pri = req.get("pri")
                            result, sp = svc.dispatch_traced(
                                req["m"], req.get("a", {}),
                                deadline=deadline,
                                priority_hint=pri if
                                isinstance(pri, str) else None,
                                trace_ctx=wire.trace_from_frame(req))
                            resp = {"id": msg_id, "ok": True, "r": result}
                            if sp is not None:
                                # Finished server-side span tree for the
                                # caller to graft (one cross-process tree
                                # per request).
                                resp[wire.SPAN_KEY] = sp
                            wire.write_frame(sock, resp)
                        except DeadlineExceeded as e:
                            # Typed error frame: the caller distinguishes
                            # "server killed it for MY deadline" (stop
                            # waiting, don't retry) from app errors.
                            wire.write_frame(sock, {"id": msg_id, "ok": False,
                                                    "kind": "deadline",
                                                    "err": str(e)})
                        except ResourceExhausted as e:
                            # Typed shed frame: a query limit or the
                            # admission gate rejected this request. The
                            # client classifies it retryable-with-backoff
                            # (the condition clears as windows expire and
                            # in-flight work drains) — the opposite of
                            # "deadline", which never retries.
                            wire.write_frame(sock, {
                                "id": msg_id, "ok": False,
                                "kind": "resource_exhausted", "err": str(e)})
                        # DELIBERATE broad except: the dispatch contract is
                        # to relay ANY server-side application error to the
                        # caller as a typed error frame — the wire write in
                        # the try is the success path, and its own failures
                        # hit the outer typed handler when the error frame
                        # write below also fails.
                        except Exception as e:  # noqa: BLE001  # m3lint: disable=broad-except-wire-io
                            wire.write_frame(
                                sock, {"id": msg_id, "ok": False, "err": f"{type(e).__name__}: {e}"}
                            )
                except (ConnectionError, OSError, ValueError):
                    # ValueError = malformed/truncated frame (wire.decode
                    # normalizes every corrupt-buffer case to it): the
                    # stream is desynchronized, so drop the connection —
                    # don't let the handler thread die with a traceback.
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
