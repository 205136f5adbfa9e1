"""Query executor: evaluates a PromQL AST over blocks (reference:
src/query/executor/{engine,state}.go + functions/* — the push-based
per-step iterator DAG is re-expressed as whole-block batched ops; every
transform consumes and produces a dense [series x steps] Block).
Counterpart of m3_tpu/query/executor.py's interpreter route.

The sliding-window math runs in m3_tpu_torch.ops.temporal and the
cross-series aggregation in m3_tpu_torch.ops.series_agg, on the engine's
device (the CUDA card unless the caller passes device="cpu"). Grids and
results stay host numpy f64; each kernel's result crosses to the host
once per query.

Matrix selectors grid at gcd(step, range) so sub-step samples inside a
window survive consolidation (the reference's block consolidation has the
same step-alignment semantics, src/query/ts/values.go).

The default route is the reference's: a query whose plan lowers
(query/plan.py), binds and has at least plan.PLAN_MIN_CELLS grid cells
runs as ONE compiled program on the engine's device
(parallel/compile.py: a CUDA graph on the card); every other query takes
the per-node interpreter below, recording the typed
`plan.FallbackReason` (`last_route()`, the slow-query ring, the
`telemetry.plan_fallback` counters, EXPLAIN). `execute_range_ref` is the
interpreter alone: the oracle the compiled route is held against.

An engine given a QueryPlacement (query/placement.py) makes where the
interpreter's range functions and large grouped aggregations run a
measured choice: an engine on the card may then place an evaluation on
the host, where the same functions run with device="cpu". Without one,
the default, everything runs on the engine's device. The compiled route
ignores placement, as the reference's does.

With several devices attached (device.attach, or more than one card), the
default engine's `mesh` is a 1-D "shard" mesh over them: a dashboard
aggregation op(rate|increase|delta(selector[R])) evaluates over the mesh
(parallel/query.py, counted as `query.sharded_agg`), and a compiled plan
whose every node can shard (`plan.mesh_ok`) runs its selectors' rows
split over the mesh with collective fan-in (parallel/compile.py)."""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..device import attached, on_attach, resolve
from ..ops import series_agg, temporal
from . import corpus as qcorpus
from . import explain as qexplain
from . import plan as qplan
from . import promql
from ..utils import limits as xlimits
from ..utils.retry import DeadlineExceeded
from ..utils.tracing import SLOW_QUERIES, span
from .block import Block, BlockMeta, LazyBlock, consolidate_series
from .model import MatchType, METRIC_NAME, Tags
from .promql import (
    Aggregation,
    BinaryOp,
    Call,
    Node,
    NumberLiteral,
    StringLiteral,
    Subquery,
    Unary,
    VectorSelector,
)

DEFAULT_LOOKBACK_NS = 5 * 60 * 1_000_000_000
# Floor for the default subquery resolution (`[1h:]` with no explicit res):
# the stand-in for prometheus' default evaluation interval, so an instant
# query (step 1s) doesn't evaluate the inner expression per second of range.
DEFAULT_SUBQUERY_RES_NS = 15 * 1_000_000_000

Scalar = np.ndarray  # [steps] float
Value = Union[Block, np.ndarray, float]

class QueryError(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def _default_query_mesh():
    """One 1-D "shard" mesh over every attached device, or None with one
    device. Cached after first use (serving processes build engines per
    coordinator but share the device list) until an attach()."""
    from ..parallel import mesh as pmesh

    devs = attached()
    if len(devs) <= 1:
        return None
    return pmesh.make(devs, (len(devs),), ("shard",))


on_attach(_default_query_mesh.cache_clear)


@dataclasses.dataclass
class QueryParams:
    start_ns: int
    end_ns: int      # inclusive of the last step <= end
    step_ns: int

    @property
    def steps(self) -> int:
        return (self.end_ns - self.start_ns) // self.step_ns + 1

    def meta(self) -> BlockMeta:
        return BlockMeta(self.start_ns, self.step_ns, self.steps)


class _GridCache:
    """Consolidated-grid cache for repeated selector evaluations.

    A dashboard burst evaluates the same selector over the same immutable
    sealed blocks every few seconds; re-consolidating a 10k-series fetch
    onto the grid costs ~50ms per query (measured, consolidate_series on
    a [10k x 447] grid) — pure waste when the data hasn't changed. The
    reference leans on block/iterator caching for the same reason
    (src/dbnode/storage/block/wired_list.go:77 WiredList).

    Validity is OBJECT IDENTITY, not content: an entry stores strong
    references to the fetched per-series entry dicts, and a lookup hits
    only when the storage layer handed back the *same entry objects* (an
    `is` check per series, ~1ms for 10k series). Unchanged-identity
    arrays cannot have changed content anywhere in the query layer (fetch
    results are treated as immutable throughout), so a hit is provably
    equivalent to recomputation. Storages that rebuild entry dicts per
    fetch simply never hit — correct, just slower. The strong refs pin
    the fetched arrays while cached; the byte budget bounds that.
    """

    # A storage that rebuilds entry dicts per fetch can never hit; after
    # this many consecutive identity misses with zero hits ever, puts are
    # sampled 1-in-_PROBE_EVERY instead of pinning every fetch's arrays.
    _MISS_DISABLE = 32
    _PROBE_EVERY = 64

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        import collections
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        self._bytes = 0
        self._max_bytes = max_bytes
        self._hits = 0
        self._misses = 0
        self._puts = 0

    def get(self, key: tuple, series: dict):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._misses += 1
                return None
            stored_series, tags_list, values, _cost = hit
            ok = len(stored_series) == len(series) and all(
                stored_series.get(sid) is entry
                for sid, entry in series.items())
            if not ok:
                # The stored entry can never hit again (identity moved on)
                # — evict now so a rebuilding storage doesn't accumulate
                # dead pinned arrays across selectors.
                self._entries.pop(key, None)
                self._bytes -= _cost
                self._misses += 1
                return None
            self._hits += 1
            self._entries.move_to_end(key)
            return tags_list, values

    def put(self, key: tuple, series: dict, tags_list, values) -> None:
        cost = values.nbytes + sum(
            e["t"].nbytes + e["v"].nbytes for e in series.values()
            if hasattr(e.get("t"), "nbytes") and hasattr(e.get("v"), "nbytes"))
        if cost > self._max_bytes:
            return
        with self._lock:
            self._puts += 1
            if (self._hits == 0 and self._misses >= self._MISS_DISABLE
                    and self._puts % self._PROBE_EVERY):
                # Rebuilding-storage regime: keep probing occasionally so a
                # storage that starts returning stable entries is noticed.
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[3]
            self._entries[key] = (dict(series), tags_list, values, cost)
            self._bytes += cost
            while self._bytes > self._max_bytes and len(self._entries) > 1:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted[3]



class Engine:
    """executor/engine.go: compile -> plan -> execute. Storage is anything
    with fetch_raw(matchers, start_ns, end_ns) -> {id: {tags, t, v}}.

    device: where the kernels run; None (the default) is the CUDA card and
    raises without one, "cpu" runs the plain PyTorch versions. Resolved
    once, here.

    placement: None (the default) runs every evaluation on `device`; a
    QueryPlacement for the same device opts in to its measured
    card-or-host cost model (query/placement.py). An engine on the CPU
    has nothing to place.

    mesh: "auto" (the default) shards dashboard-shaped aggregations and
    mesh_ok plans over every attached device (the in-mesh expression of
    the reference's coordinator fanout,
    src/query/storage/fanout/storage.go); None keeps every evaluation on
    `device`; or an explicit parallel.mesh.Mesh with a "shard" axis. With
    one device, or attached devices of another type than `device`'s,
    "auto" resolves to None."""

    def __init__(self, storage, lookback_ns: int = DEFAULT_LOOKBACK_NS,
                 cost_enforcer=None, per_query_cost_limit=None,
                 query_limits=None, device=None, placement=None,
                 mesh="auto"):
        self.storage = storage
        self.device = resolve(device)
        # "auto" resolves on the first query that can shard, so an attach()
        # around the engine's first use decides it.
        self._mesh = mesh
        if placement is not None and placement.device != self.device:
            raise ValueError(f"placement is for {placement.device}, the "
                             f"engine runs on {self.device}")
        self._placement = placement
        # Overload-protection registry (utils.limits). None = resolve the
        # process-global registry at query time, so a deployment that
        # configures limits after engine construction still gets them.
        # Each query runs inside a QueryScope: per-query child enforcers
        # chained to the global concurrent budgets, installed thread-local
        # so the storage/index charge sites below this query bill it.
        self.query_limits = query_limits
        self.lookback_ns = lookback_ns
        # Per-process datapoint budget (x/cost/enforcer.go). Each query
        # charges a scoped child enforcer whose total is released when the
        # query finishes, so the global budget tracks only in-flight work.
        self.cost_enforcer = cost_enforcer
        self.per_query_cost_limit = per_query_cost_limit
        # Per-QUERY scoped enforcer: thread-local, because one Engine
        # serves concurrent queries and a shared slot would charge one
        # query's datapoints to another.
        self._local = threading.local()
        self._grid_cache = _GridCache()

    @property
    def mesh(self):
        if isinstance(self._mesh, str):  # "auto"
            from ..parallel import mesh as pmesh

            return pmesh.for_device(_default_query_mesh(), self.device)
        return self._mesh

    @mesh.setter
    def mesh(self, value):
        self._mesh = value

    def placement_snapshot(self) -> Optional[dict]:
        """The live card-or-host cost model: measured link bandwidth and
        RTT, per-path rate EWMAs, and the decisions made by side; None
        for an engine without a placement."""
        return None if self._placement is None else self._placement.snapshot()

    def _place(self, cells: int, result_bytes: int):
        """None (the engine's device) or the host device. With a
        placement, one counted decision, recorded for this query's route
        record."""
        from ..utils.instrument import ROOT

        if self._placement is None:
            return None
        placed = self._placement.choose(cells, result_bytes)
        side = "host" if placed is not None else "device"
        ROOT.counter(f"query.placement.{side}").inc()
        sides = getattr(self._local, "placements", None)
        if sides is not None:
            sides.add(side)
        return placed

    def _observe(self, placed, cells: int, nbytes: int,
                 seconds: float) -> None:
        """Fold an evaluation's observed time into the placement's model
        (nothing without a placement)."""
        if self._placement is not None:
            self._placement.observe(placed, cells, nbytes, seconds)

    def _route(self) -> dict:
        """This thread's last query's route record (`last_route()`) with
        the query's placements: "device", "host", "mixed", or None when
        nothing was placed."""
        sides = getattr(self._local, "placements", None) or set()
        placement = (None if not sides else "mixed" if len(sides) > 1
                     else next(iter(sides)))
        return dict(self.last_route() or {}, placement=placement)

    def execute_range(self, query: str, start_ns: int, end_ns: int,
                      step_ns: int, ast: Optional[Node] = None,
                      use_plan: bool = True) -> Block:
        from ..utils.instrument import ROOT

        ROOT.counter("query.executed").inc()
        timer = ROOT.timer("query.latency_s")
        sp = span("query.execute_range", query=query)
        # A failure before this query's scope runs must not inherit the
        # previous query's totals on this reused serving thread — same
        # for the route record (slow-ring + corpus attribution).
        xlimits.reset_last_totals()
        self._local.placements = set()
        self._local.route_info = None
        t0 = time.perf_counter_ns()
        # Slow-query accounting: typed sheds record regardless of
        # duration; completed queries record past the threshold, with
        # cost attribution from the span (QueryScope exit annotates it)
        # or, unsampled, the thread-local last-scope totals. Every entry
        # carries the route + typed fallback reason, so a slow
        # interpreted query tells the operator WHY it missed the
        # compiled path.
        try:
            with timer, sp:
                result = self._execute_range(query, start_ns, end_ns,
                                             step_ns, ast=ast,
                                             use_plan=use_plan)
        except xlimits.ResourceExhausted:
            SLOW_QUERIES.maybe("query", query, time.perf_counter_ns() - t0,
                               costs=xlimits.last_scope_totals(),
                               reason="limit-shed", route=self._route(),
                               trace_id=sp.trace_id or None)
            raise
        except DeadlineExceeded:
            SLOW_QUERIES.maybe("query", query, time.perf_counter_ns() - t0,
                               costs=xlimits.last_scope_totals(),
                               reason="deadline", route=self._route(),
                               trace_id=sp.trace_id or None)
            raise
        from ..utils import tracing

        SLOW_QUERIES.maybe("query", query, time.perf_counter_ns() - t0,
                           # Lazy SUBTREE rollup: cache events accrue on
                           # child spans, and only entries that actually
                           # record pay the walk.
                           costs=((lambda: tracing.collect_costs(sp))
                                  if sp.sampled
                                  else xlimits.last_scope_totals()),
                           route=self._route(), trace_id=sp.trace_id or None)
        # Opt-in corpus sampler (query/corpus.py): one module-global read
        # when no recorder is configured. Sampled queries materialize the
        # lazy result inside the hook, so recorded latency includes the
        # d2h transfer (symmetric with the eager interpreter route).
        qcorpus.maybe_record(query, self.last_route(), result, t0, step_ns)
        return result

    def _execute_range(self, query: str, start_ns: int, end_ns: int,
                       step_ns: int, ast: Optional[Node] = None,
                       use_plan: bool = True) -> Block:
        # A caller that parsed already hands the node in via `ast`; the
        # query STRING still tags the spans.
        if ast is None:
            with span("query.parse"):
                ast = promql.parse(query)
        params = QueryParams(start_ns, end_ns, step_ns)
        # @ start()/end() resolve against the OUTERMOST query range even
        # inside subqueries (prom promql/parser/ast.go StartOrEnd).
        self._local.outer_params = params
        ql = self.query_limits if self.query_limits is not None \
            else xlimits.get_global()
        with ql.scope("query"):
            if self.cost_enforcer is not None:
                child = self.cost_enforcer.child(self.per_query_cost_limit)
                self._local.enforcer = child
                try:
                    val = self._eval_root(ast, params, use_plan)
                finally:
                    self._local.enforcer = None
                    child.release(child.current())
            else:
                val = self._eval_root(ast, params, use_plan)
            return _to_block(val, params)

    def execute_instant(self, query: str, t_ns: int,
                        ast: Optional[Node] = None) -> Block:
        return self.execute_range(query, t_ns, t_ns, 1_000_000_000, ast=ast)

    def execute_range_ref(self, query: str, start_ns: int, end_ns: int,
                          step_ns: int, ast: Optional[Node] = None) -> Block:
        """The retained per-node interpreter — the oracle the compiled
        whole-plan route (query/plan.py -> parallel/compile.py) is held
        against. Identical to execute_range with the plan route turned
        off: every node evaluates through the _eval tree-walk below."""
        return self.execute_range(query, start_ns, end_ns, step_ns, ast=ast,
                                  use_plan=False)

    # -- evaluation --------------------------------------------------------

    def _eval_root(self, node: Node, params: QueryParams,
                   use_plan: bool) -> Value:
        """Root dispatch: run the WHOLE physical plan as one program when
        every node lowers (query/plan.py), falling back to the
        interpreter otherwise — so a query outside the compiled surface
        behaves exactly as before. The route (and the fallback reason) is
        tagged onto the query span."""
        if use_plan:
            # Selector overlay for the plan attempt: bind() fetches every
            # selector through the normal charged paths; if the plan then
            # falls back (below floor, backend gap), the interpreter
            # re-evaluation below reuses those exact blocks instead of
            # re-fetching (and re-charging) the storage layer.
            self._local.sel_overlay = {}
            try:
                out = self._try_plan(node, params)
                if out is not None:
                    return out
                return self._eval_interp(node, params)
            finally:
                self._local.sel_overlay = None
        # Plan route off (execute_range_ref): recorded for the slow-ring
        # and corpus surfaces, no span tag (only real plan ATTEMPTS tag
        # their route).
        self._local.route_info = {
            "route": "interpreter",
            "fallback_reason": qplan.FallbackReason.DISABLED.value,
            "fallback_detail": "plan route disabled",
        }
        return self._eval_interp(node, params)

    def _eval_interp(self, node: Node, params: QueryParams) -> Value:
        """Interpreter evaluation, staged under ANALYZE when a context
        is active (one thread-local read otherwise)."""
        actx = qexplain.current()
        if actx is None:
            return self._eval(node, params)
        with actx.stage("interpreter_eval"):
            return self._eval(node, params)

    def _try_plan(self, node: Node, params: QueryParams) -> Optional[Value]:
        from ..parallel import compile as pcompile
        from ..parallel import telemetry
        from ..utils.instrument import ROOT

        plan, err, slot_values = qplan.lower_and_collect(
            node, params, self.lookback_ns)
        if plan is None:
            telemetry.plan_fallback(err.reason.value,
                                    qplan.fallback_scope(err.reason.value))
            self._set_route("interpreter", err.reason.value, str(err))
            return None
        # bind() fetches + grids every selector through the SAME cached
        # selector paths the interpreter uses and runs the host tag
        # algebra; QueryError (matching violations) carries the
        # interpreter's exact semantics and propagates. Under ANALYZE
        # the bind (fetch + host tag algebra) is its own stage.
        actx = qexplain.current()
        if actx is None:
            bound = qplan.bind(plan, self, params, slot_values)
        else:
            with actx.stage("bind"):
                bound = qplan.bind(plan, self, params, slot_values)
        if bound.total_cells < qplan.PLAN_MIN_CELLS:
            # Tiny queries keep the interpreter's exact-f64 finishes; the
            # grids just fetched ride the selector overlay, so the
            # fallback evaluation below re-reads them for free.
            ROOT.counter("query.plan.below_floor").inc()
            telemetry.plan_fallback(qplan.FallbackReason.BELOW_FLOOR.value,
                                    "runtime")
            self._set_route("interpreter",
                            qplan.FallbackReason.BELOW_FLOOR.value,
                            f"{bound.total_cells} cells < "
                            f"{qplan.PLAN_MIN_CELLS} floor")
            return None
        mesh = self.mesh
        try:
            values, tags, fetch = pcompile.execute(bound, self.device, mesh)
        except pcompile.PlanFallback as e:
            ROOT.counter("query.plan.fallback").inc()
            telemetry.plan_fallback(e.reason.value,
                                    qplan.fallback_scope(e.reason.value))
            self._set_route("interpreter", e.reason.value, str(e))
            return None
        ROOT.counter("query.plan.executed").inc()
        self._set_route("compiled", "", "")
        sharded = pcompile.mesh_route(bound.plan, mesh)
        if sharded is not None:
            # What the executable really ran: its slices and its kind.
            self._local.route_info["mesh"] = sharded
        if fetch is None:
            return values          # [steps] scalar; _to_block wraps it
        return LazyBlock(params.meta(), tags, fetch)

    def _set_route(self, route: str, reason: str, detail: str) -> None:
        """Record the route decision: span tags (route "plan" for the
        compiled path) + the thread-local route record `last_route()`
        reads (the slow ring and the corpus sampler)."""
        from ..utils import tracing

        self._local.route_info = {
            "route": route,
            "fallback_reason": reason or None,
            "fallback_detail": detail or None,
        }
        cur = getattr(tracing.TRACER._local, "current", None)
        if cur is not None:
            cur.set_tag("route", "plan" if route == "compiled" else route)
            if reason:
                cur.set_tag("plan_fallback", reason)

    def last_route(self) -> Optional[dict]:
        """The route record of this THREAD's most recent query: route
        ("compiled"/"interpreter"), typed fallback_reason (a
        `plan.FallbackReason` value) and a human detail, plus `mesh`
        (pcompile.mesh_route: slices and executable kind) when a compiled
        plan ran over the mesh — None when no query ran on this thread
        yet."""
        return getattr(self._local, "route_info", None)

    def _eval(self, node: Node, params: QueryParams) -> Value:
        if isinstance(node, NumberLiteral):
            return float(node.value)
        if isinstance(node, StringLiteral):
            return node.value
        if isinstance(node, VectorSelector):
            if node.range_ns:
                raise QueryError("matrix selector used outside a function")
            return self._eval_instant_selector(node, params)
        if isinstance(node, Subquery):
            raise QueryError("subquery result used outside a range function")
        if isinstance(node, Unary):
            val = self._eval(node.expr, params)
            return _map_values(val, lambda v: -v)
        if isinstance(node, Call):
            return self._eval_call(node, params)
        if isinstance(node, Aggregation):
            return self._eval_aggregation(node, params)
        if isinstance(node, BinaryOp):
            return self._eval_binary(node, params)
        raise QueryError(f"unsupported node {type(node).__name__}")

    # -- selectors ---------------------------------------------------------

    def _fetch(self, sel: VectorSelector, start_ns: int, end_ns: int):
        with span("query.fetch", metric=sel.name.decode(errors="replace")
                  if sel.name else "") as sp:
            series = self.storage.fetch_raw(
                promql.selector_matchers(sel), start_ns, end_ns)
            sp.set_tag("series", len(series))
        points = sum(len(e["t"]) for e in series.values())
        # Per-query datapoint budget: bills the QueryScope's child
        # enforcer installed by _execute_range (utils.limits), so one
        # runaway selector exhausts its own budget, not the process's.
        xlimits.charge("datapoints_decoded", points)
        enforcer = getattr(self._local, "enforcer", None)
        if enforcer is not None:
            enforcer.add(points)
        return series

    def _resolve_at(self, at) -> int:
        """Absolute eval timestamp for an @-modifier. start()/end() come
        from the outermost query range, not any inner subquery grid."""
        if isinstance(at, str):
            outer: QueryParams = self._local.outer_params
            if at == "start":
                return outer.start_ns
            return outer.start_ns + (outer.steps - 1) * outer.step_ns
        return int(at)

    def _pin_at(self, node, sel, params: QueryParams) -> Block:
        """Evaluate `node` (with range/instant selector `sel` carrying an
        @-modifier) at the pinned timestamp, then tile the single-step
        result across the query's steps — an @-pinned expression is
        constant over the output grid (prom promql/engine.go)."""
        t = self._resolve_at(sel.at_ns)
        pinned = QueryParams(t, t, params.step_ns)
        sel2 = dataclasses.replace(sel, at_ns=None)
        if node is sel:
            out = self._eval(sel2, pinned)
        else:
            node2 = dataclasses.replace(node, args=tuple(
                sel2 if a is sel else a for a in node.args))
            out = self._eval_range_func(node2, pinned)
        blk = _to_block(out, pinned)
        return Block(params.meta(), blk.series_tags,
                     np.repeat(np.asarray(blk.values), params.steps, axis=1))

    def _sel_overlay_get(self, role: str, sel: VectorSelector,
                         params: QueryParams):
        """One-query selector memo (plan bind -> interpreter fallback):
        returns (key, hit). Populated only while a plan attempt is live;
        interpreter-only queries (execute_range_ref) never see it."""
        overlay = getattr(self._local, "sel_overlay", None)
        if overlay is None:
            return None, None
        key = (role, sel, params.start_ns, params.end_ns, params.step_ns)
        return key, overlay.get(key)

    def _eval_instant_selector(self, sel: VectorSelector,
                               params: QueryParams) -> Block:
        if sel.at_ns is not None:
            return self._pin_at(sel, sel, params)
        key, hit = self._sel_overlay_get("instant", sel, params)
        if hit is not None:
            return hit
        off = sel.offset_ns
        meta = params.meta()
        series = self._fetch(sel, params.start_ns - self.lookback_ns - off,
                             params.end_ns - off + 1)
        shifted = BlockMeta(meta.start_ns - off, meta.step_ns, meta.steps)
        tags_list, values = self._consolidate_cached(
            sel, series, shifted, self.lookback_ns)
        out = Block(meta, tags_list, values)
        if key is not None:
            self._local.sel_overlay[key] = out
        return out

    def _eval_range_selector(self, sel: VectorSelector, params: QueryParams
                             ) -> Tuple[Block, int, int]:
        """Fetch + grid a matrix selector: returns (extended block at the
        window grid, W cells per window, stride to subsample back to the
        query step)."""
        key, hit = self._sel_overlay_get("range", sel, params)
        if hit is not None:
            return hit
        off = sel.offset_ns
        wgrid = math.gcd(params.step_ns, sel.range_ns)
        W = sel.range_ns // wgrid
        stride = params.step_ns // wgrid
        meta = params.meta()
        # Extended grid: (W-1) cells of history before the first output step.
        ext_start = meta.start_ns - (W - 1) * wgrid - off
        ext_steps = (W - 1) + (meta.steps - 1) * stride + 1
        ext_meta = BlockMeta(ext_start, wgrid, ext_steps)
        series = self._fetch(sel, ext_start - wgrid, meta.end_ns - off + 1)
        # Range selectors see raw samples (no lookback): a cell holds the
        # latest sample within its grid cell only.
        tags_list, values = self._consolidate_cached(
            sel, series, ext_meta, wgrid)
        out = (Block(ext_meta, tags_list, values), W, stride)
        if key is not None:
            self._local.sel_overlay[key] = out
        return out

    def _consolidate_cached(self, sel: VectorSelector, series: dict,
                            meta: BlockMeta, lookback_ns: int):
        """consolidate_series behind the identity-verified grid cache: a
        repeat evaluation of the same selector over the same (immutable)
        fetched entries reuses the consolidated grid object."""
        from ..utils.instrument import ROOT

        from ..utils import tracing

        key = (promql.selector_matchers(sel),
               meta.start_ns, meta.step_ns, meta.steps, lookback_ns)
        actx = qexplain.current()
        hit = self._grid_cache.get(key, series)
        if hit is not None:
            ROOT.counter("query.grid_cache.hit").inc()
            tracing.count_cost("grid_cache_hit")
            if actx is not None:
                actx.event("grid_cache_hit")
            return hit
        ROOT.counter("query.grid_cache.miss").inc()
        tracing.count_cost("grid_cache_miss")
        if actx is not None:
            actx.event("grid_cache_miss")
        tags_list, values = consolidate_series(series, meta, lookback_ns)
        self._grid_cache.put(key, series, tags_list, values)
        return tags_list, values

    def _eval_subquery_grid(self, sub: Subquery, params: QueryParams
                            ) -> Tuple[Block, int, int]:
        """Evaluate `expr[range:res]`: run the inner expression as ONE
        instant-style evaluation over a fine grid of resolution-aligned
        timestamps covering every outer step's trailing window, then hand
        the [series x fine-steps] block to the same W/stride reduce-window
        machinery matrix selectors use (prometheus promql/engine.go
        evalSubquery; each window sees the inner values at the res-aligned
        times in (T-range, T]).

        Default resolution (`[1h:]`) is the query step floored at 15s —
        this engine's stand-in for prometheus' default evaluation interval
        (an unfloored default would make an instant query, step 1s,
        evaluate the inner expression 3601 times per hour of range). Eval
        timestamps are absolute multiples of res (prometheus aligns
        subquery steps independently of the query time). When res divides
        the query step and covers the range at least once, the res grid
        feeds the kernels directly; otherwise the windows are gathered
        into a packed [steps x Wmax] layout (W=stride=Wmax) — sample
        membership per window stays exactly (T-range, T] either way, and
        when res divides the range the packed windows carry no padding
        lanes, so the rate family's position-based extrapolation sees the
        true window span (a non-dividing res leaves one NaN lane whose
        res-sized skew is documented in DIVERGENCES.md)."""
        res = sub.step_ns or max(params.step_ns, DEFAULT_SUBQUERY_RES_NS)
        off = sub.offset_ns
        x0 = params.start_ns - off
        # Window for output T: res-multiples k*res with
        # (T-off-range)//res < k <= (T-off)//res.
        k_min = (x0 - sub.range_ns) // res + 1
        # Last OUTPUT step, not params.end_ns: end is only "last step <=
        # end" and may overshoot the step grid by a fraction of a step.
        k_max = (x0 + (params.steps - 1) * params.step_ns) // res
        # k_max < k_min: no window contains any res-aligned timestamp
        # (single-step query with range < res off-phase). Evaluate one
        # token timestamp so the series set is known; every lane masks
        # invalid below and the result is all-NaN, like prometheus'
        # empty matrix.
        k_max = max(k_max, k_min)
        inner = QueryParams(k_min * res, k_max * res, res)
        val = self._eval(sub.expr, inner)
        block = _to_block(val, inner)
        if params.step_ns % res == 0 and sub.range_ns >= res:
            # Shared grid: every output step's window is a contiguous run
            # ending at a constant offset + i*stride (constant width — the
            # phase x mod res is the same for every step).
            W = x0 // res - (x0 - sub.range_ns) // res
            stride = params.step_ns // res
        else:
            # Packed gather: per-step window ends drift across the res
            # grid (or the range is shorter than one res cell), so windows
            # go side by side. res | range => every window holds exactly
            # range/res samples and no padding lane exists.
            Wmax = max(sub.range_ns // res + (1 if sub.range_ns % res else 0),
                       1)
            steps = params.steps
            x = x0 + np.arange(steps, dtype=np.int64) * params.step_ns
            k_end = x // res
            k_start = (x - sub.range_ns) // res + 1
            cols = (k_end[:, None] - (Wmax - 1) + np.arange(Wmax)[None, :]
                    - k_min)                                # [steps, Wmax]
            valid = cols >= (k_start - k_min)[:, None]
            vals = block.values
            packed = np.where(valid[None, :, :],
                              vals[:, np.clip(cols, 0, vals.shape[1] - 1)],
                              np.nan).reshape(vals.shape[0], steps * Wmax)
            block = Block(BlockMeta(inner.start_ns, res, steps * Wmax),
                          block.series_tags, packed)
            W = stride = Wmax
        assert block.meta.steps == (W - 1) + (params.steps - 1) * stride + 1, (
            block.meta.steps, W, stride, params.steps)
        return block, W, stride

    # -- functions ---------------------------------------------------------

    _RANGE_FUNCS = {
        "rate", "increase", "delta", "irate", "idelta", "deriv",
        "predict_linear", "holt_winters", "changes", "resets",
        "sum_over_time", "avg_over_time", "min_over_time", "max_over_time",
        "count_over_time", "last_over_time", "stddev_over_time",
        "stdvar_over_time", "present_over_time", "quantile_over_time",
        "absent_over_time",
    }

    def _eval_call(self, node: Call, params: QueryParams) -> Value:
        if node.func in self._RANGE_FUNCS:
            return self._eval_range_func(node, params)
        return self._eval_instant_func(node, params)

    def _eval_range_func(self, node: Call, params: QueryParams) -> Block:
        range_args = [a for a in node.args
                      if isinstance(a, (VectorSelector, Subquery))]
        if not range_args or not (isinstance(range_args[-1], Subquery)
                                  or range_args[-1].range_ns):
            raise QueryError(f"{node.func} expects a range vector")
        sel = range_args[-1]
        if sel.at_ns is not None:
            return self._pin_at(node, sel, params)
        if isinstance(sel, Subquery):
            ext, W, stride = self._eval_subquery_grid(sel, params)
        else:
            ext, W, stride = self._eval_range_selector(sel, params)
        # With a placement, where the functions run is a measured decision
        # (placement.py): a full result plane may be cheaper to compute on
        # the host than to ship off the card.
        cells = int(ext.values.size)
        result_bytes = ext.n_series * params.meta().steps * 4
        placed = self._place(cells, result_bytes)
        return self._dispatch_range_func(
            node, sel, params, ext, W, stride, placed=placed, cells=cells,
            result_bytes=result_bytes, t_dispatch=time.perf_counter())

    def _dispatch_range_func(self, node, sel, params, ext, W, stride, *,
                             placed, cells, result_bytes, t_dispatch):
        from ..parallel import telemetry

        # Every kernel consolidates to the query's output step grid on the
        # device (stride), so nothing wider than [series, steps] comes
        # back; the rate family and *_over_time return fetch closures
        # (LazyBlock) that copy the result when it is first read.
        grid = ext.values
        step_ns = ext.meta.step_ns
        dev = placed if placed is not None else self.device
        f = node.func
        fetch = None
        if f == "rate":
            fetch = temporal.rate_async(grid, W, step_ns, sel.range_ns, stride,
                                        device=dev)
        elif f == "increase":
            fetch = temporal.increase_async(
                grid, W, step_ns, sel.range_ns, stride, device=dev)
        elif f == "delta":
            fetch = temporal.delta_async(
                grid, W, step_ns, sel.range_ns, stride, device=dev)
        elif f == "irate":
            out = temporal.irate(grid, W, step_ns, stride, device=dev)
        elif f == "idelta":
            out = temporal.idelta(grid, W, step_ns, stride, device=dev)
        elif f == "deriv":
            out = temporal.deriv(grid, W, step_ns, stride, device=dev)
        elif f == "predict_linear":
            out = temporal.predict_linear(
                grid, W, step_ns, _const_param(node.args[1]), stride,
                device=dev)
        elif f == "holt_winters":
            out = temporal.holt_winters(
                grid, W, _const_param(node.args[1]), _const_param(node.args[2]),
                stride, device=dev)
        elif f == "changes":
            out = temporal.changes(grid, W, stride, device=dev)
        elif f == "resets":
            out = temporal.resets(grid, W, stride, device=dev)
        elif f == "quantile_over_time":
            out = temporal.quantile_over_time(
                grid, W, _const_param(node.args[0]), stride, device=dev)
        elif f == "absent_over_time":
            # 1 at steps where NO series has a sample in the window
            # (functions.go funcAbsentOverTime), labelled from the
            # selector's equality matchers like absent().
            if ext.n_series:
                cnt = temporal.over_time(grid, W, "count", stride, device=dev)
                present = np.nan_to_num(cnt).sum(axis=0) > 0
            else:
                present = np.zeros(params.meta().steps, dtype=bool)
            out = np.where(present, np.nan, 1.0)[None, :]
            return Block(params.meta(), [_absent_tags(sel)], out)
        else:
            kind = f[: -len("_over_time")]
            fetch = temporal.over_time_async(grid, W, kind, stride,
                                             finish="auto", device=dev)
        drop_name = f not in ("last_over_time",)
        tags = [_strip_name(t) if drop_name else t for t in ext.series_tags]
        if fetch is not None:
            inner = fetch
            # Observed cost = the dispatch segment + the materialization
            # segment; the wall time between them (other work interleaved
            # before the LazyBlock is read) is not this evaluation's.
            dispatch_s = time.perf_counter() - t_dispatch

            def observed_fetch():
                t0 = time.perf_counter()
                result = inner()
                self._observe(placed, cells, result_bytes,
                              dispatch_s + time.perf_counter() - t0)
                telemetry.count_d2h(result_bytes)
                return result

            return LazyBlock(params.meta(), tags, observed_fetch)
        self._observe(placed, cells, result_bytes,
                      time.perf_counter() - t_dispatch)
        telemetry.count_d2h(result_bytes)
        return Block(params.meta(), tags, out)

    def _eval_instant_func(self, node: Call, params: QueryParams) -> Value:
        f = node.func
        if f == "time":
            return params.meta().times() / 1e9
        if f == "pi":
            return float(np.pi)
        if f in _DATE_FUNCS:
            # promql date functions: no argument means "now" per step
            # (functions.go dateWrapper); with a vector, per-sample values.
            if node.args:
                block = self._eval(node.args[0], params)
                if not isinstance(block, Block):
                    raise QueryError(f"{f} expects an instant vector")
                vals = _date_part(f, block.values)
                return block.with_values(
                    vals, [_strip_name(t) for t in block.series_tags])
            # dateWrapper emits a one-series vector with empty labels, so
            # `x and on() (hour() < 6)` vector-matches like in Prometheus.
            times = params.meta().times() / 1e9
            return Block(params.meta(), [Tags.of({})],
                         _date_part(f, times)[None, :])
        if f == "scalar":
            block = self._eval(node.args[0], params)
            if not isinstance(block, Block):
                raise QueryError("scalar() expects a vector")
            if block.n_series == 1:
                return block.values[0].astype(np.float64)
            return np.full(params.steps, np.nan)
        if f == "vector":
            val = self._eval(node.args[0], params)
            arr = _broadcast_scalar(val, params)
            return Block(params.meta(), [Tags.of({})], arr[None, :])
        if f == "absent":
            block = self._eval(node.args[0], params)
            present = np.isfinite(block.values).any(axis=0) if block.n_series else (
                np.zeros(params.steps, dtype=bool))
            vals = np.where(present, np.nan, 1.0)[None, :]
            tags = _absent_tags(node.args[0])
            return Block(params.meta(), [tags], vals)
        if f in ("label_replace", "label_join"):
            return self._eval_label_func(node, params)
        if f == "histogram_quantile":
            q = _const_param(node.args[0])
            block = self._eval(node.args[1], params)
            return _histogram_quantile(q, block)
        if f in ("sort", "sort_desc"):
            block = self._eval(node.args[0], params)
            key = np.where(np.isfinite(block.values), block.values, -np.inf).mean(axis=1)
            order = np.argsort(-key if f == "sort_desc" else key, kind="stable")
            return Block(block.meta, [block.series_tags[i] for i in order],
                         block.values[order])
        if f == "timestamp":
            block = self._eval(node.args[0], params)
            times = block.meta.times() / 1e9
            vals = np.where(np.isfinite(block.values), times[None, :], np.nan)
            return block.with_values(vals, [_strip_name(t) for t in block.series_tags])
        fn = _MATH_FUNCS.get(f)
        if fn is None:
            raise QueryError(f"unknown function {f}")
        args = [self._eval(a, params) for a in node.args]
        if not args:
            raise QueryError(f"{f} expects arguments")
        head = args[0]
        extra = [(_broadcast_scalar(a, params) if not isinstance(a, Block) else a)
                 for a in args[1:]]
        if isinstance(head, Block):
            vals = fn(head.values, *[e if isinstance(e, np.ndarray) else e
                                     for e in extra])
            return head.with_values(vals, [_strip_name(t) for t in head.series_tags])
        return fn(_broadcast_scalar(head, params), *extra)

    def _eval_label_func(self, node: Call, params: QueryParams) -> Block:
        import re as _re

        block = self._eval(node.args[0], params)
        if node.func == "label_replace":
            dst, repl, src, regex = (_string_param(a) for a in node.args[1:5])
            pattern = _re.compile(regex)
            tags = []
            for t in block.series_tags:
                val = (t.get(src.encode()) or b"").decode()
                m = pattern.fullmatch(val)
                if m:
                    new = m.expand(_go_template_to_py(repl))
                    t = t.with_tag(dst.encode(), new.encode())
                tags.append(t)
            return block.with_values(block.values, tags)
        # label_join(v, dst, sep, src...)
        dst = _string_param(node.args[1]).encode()
        sep = _string_param(node.args[2]).encode()
        srcs = [_string_param(a).encode() for a in node.args[3:]]
        tags = [
            t.with_tag(dst, sep.join(t.get(s) or b"" for s in srcs))
            for t in block.series_tags
        ]
        return block.with_values(block.values, tags)

    # -- aggregation -------------------------------------------------------

    def _eval_sharded_agg(self, node: Aggregation,
                          params: QueryParams) -> Optional[Block]:
        """The mesh route for dashboard-shaped aggregations: a GLOBAL
        op(rate|increase|delta(selector[R])) evaluates over the mesh, each
        entry running the rate math on its series and one collective over
        the "shard" axis giving the [steps] answer (parallel/query.py; the
        reference fans the same shape out across dbnodes and merges at the
        coordinator, src/query/storage/fanout/storage.go). None when the
        shape does not match or no mesh is attached: the host reduce
        below runs. Device sums are f32."""
        mesh = self.mesh
        if mesh is None or node.grouping or node.without:
            return None
        from ..parallel import query as pq

        if node.op not in pq.AGG_OPS or not isinstance(node.expr, Call):
            return None
        func = node.expr.func
        if func not in pq.RANGE_FUNCS:
            return None
        sel_args = [a for a in node.expr.args
                    if isinstance(a, VectorSelector)]
        if (not sel_args or not sel_args[-1].range_ns
                or sel_args[-1].at_ns is not None):
            return None
        sel = sel_args[-1]
        ext, W, stride = self._eval_range_selector(sel, params)
        if ext.n_series == 0:
            return Block(params.meta(), [], np.zeros((0, params.steps)))
        out = pq.agg_rate(ext.values, mesh, op=node.op, func=func, W=W,
                          step_ns=ext.meta.step_ns, range_ns=sel.range_ns,
                          stride=stride)
        from ..utils.instrument import ROOT

        ROOT.counter("query.sharded_agg").inc()
        return Block(params.meta(), [Tags.of({})], out[None, :])

    def _eval_aggregation(self, node: Aggregation, params: QueryParams) -> Block:
        sharded = self._eval_sharded_agg(node, params)
        if sharded is not None:
            return sharded
        block = self._eval(node.expr, params)
        if not isinstance(block, Block):
            raise QueryError(f"{node.op} expects an instant vector")
        group_ids, group_tags = _group_series(
            block.series_tags, node.grouping, node.without)
        G = len(group_tags)
        vals = block.values
        op = node.op
        if op in ("sum", "avg", "min", "max", "count", "stddev", "stdvar",
                  "group"):
            # f64 host reduce keeps counter-sum exactness; the f32 device
            # segment reduce (series_agg.grouped_reduce) takes large
            # fan-in, where 24-bit mantissas suffice.
            kind = "count" if op == "group" else op
            if vals.shape[0] < 4096:
                out = series_agg.grouped_reduce_f64(vals, group_ids, G, kind)
            else:
                # Placed like a range function: the transfer term is the
                # f32 input's H2D plus the grouped result's D2H, and the
                # same value feeds observe(), so the model nets out what
                # choose() charged.
                cells = int(vals.size)
                xfer_bytes = cells * 4 + G * vals.shape[1] * 8
                placed = self._place(cells, xfer_bytes)
                t0 = time.perf_counter()
                out = series_agg.grouped_reduce(
                    vals, group_ids, G, kind,
                    device=placed if placed is not None else self.device)
                self._observe(placed, cells, xfer_bytes,
                              time.perf_counter() - t0)
            if op == "group":
                # promql group(): 1 per group with any present series.
                out = np.where(out > 0, 1.0, np.nan)
            return Block(block.meta, group_tags, out)
        if op == "quantile":
            q = _const_param(node.param)
            out = series_agg.grouped_quantile(vals, group_ids, G, q)
            return Block(block.meta, group_tags, out)
        if op in ("topk", "bottomk"):
            k = int(_const_param(node.param))
            keep = series_agg.topk_mask(vals, group_ids, G, k, op == "topk")
            out = np.where(keep, vals, np.nan)
            rows = ~np.all(np.isnan(out), axis=1)
            return Block(block.meta,
                         [t for t, r in zip(block.series_tags, rows) if r],
                         out[rows])
        if op == "count_values":
            label = _string_param(node.param).encode()
            counts = series_agg.count_values(vals, group_ids, G)
            tags, rows = [], []
            for (g, v), cnt in sorted(counts.items()):
                tags.append(group_tags[g].with_tag(label, _format_value(v)))
                rows.append(np.where(cnt > 0, cnt, np.nan))
            values = np.stack(rows) if rows else np.zeros((0, block.meta.steps))
            return Block(block.meta, tags, values)
        raise QueryError(f"unsupported aggregation {op}")

    # -- binary ops --------------------------------------------------------

    def _eval_binary(self, node: BinaryOp, params: QueryParams) -> Value:
        lhs = self._eval(node.lhs, params)
        rhs = self._eval(node.rhs, params)
        if node.op in promql.SET_OPS:
            return _set_op(node.op, lhs, rhs, node.matching)
        l_vec, r_vec = isinstance(lhs, Block), isinstance(rhs, Block)
        fn = _BIN_FUNCS[node.op]
        comparison = node.op in promql.COMPARISON_OPS
        if not l_vec and not r_vec:
            lv = _broadcast_scalar(lhs, params)
            rv = _broadcast_scalar(rhs, params)
            out = fn(lv, rv)
            if comparison and not node.bool_mode:
                # scalar comparisons without bool filter to the lhs value
                return np.where(out > 0, lv, np.nan)
            return out.astype(np.float64)
        if l_vec and r_vec:
            return _vector_vector(node, lhs, rhs, fn, comparison)
        # vector <op> scalar (either side)
        block = lhs if l_vec else rhs
        scalar = _broadcast_scalar(rhs if l_vec else lhs, params)
        a = block.values if l_vec else scalar[None, :]
        b = scalar[None, :] if l_vec else block.values
        with np.errstate(divide="ignore", invalid="ignore"):
            out = fn(a, b)
        if comparison:
            if node.bool_mode:
                vals = np.where(np.isfinite(block.values), out.astype(np.float64), np.nan)
                return block.with_values(vals, [_strip_name(t) for t in block.series_tags])
            return block.with_values(np.where(out > 0, block.values, np.nan))
        return block.with_values(out, [_strip_name(t) for t in block.series_tags])


# ---------------------------------------------------------------- helpers

_MATH_FUNCS: Dict[str, Callable] = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
    "sqrt": lambda v: _guard(np.sqrt, v), "ln": lambda v: _guard(np.log, v),
    "log2": lambda v: _guard(np.log2, v), "log10": lambda v: _guard(np.log10, v),
    "sgn": np.sign,
    "round": lambda v, to=None: (np.round(v) if to is None
                                 else np.round(v / to) * to),
    "clamp": lambda v, lo, hi: np.clip(v, lo, hi),
    "clamp_min": lambda v, lo: np.maximum(v, lo),
    "clamp_max": lambda v, hi: np.minimum(v, hi),
    # trigonometry (promql functions.go funcSin..funcAtanh; domain errors
    # yield NaN like Go's math package)
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": lambda v: _guard(np.arcsin, v),
    "acos": lambda v: _guard(np.arccos, v),
    "atan": np.arctan,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "asinh": np.arcsinh,
    "acosh": lambda v: _guard(np.arccosh, v),
    "atanh": lambda v: _guard(np.arctanh, v),
    "deg": np.degrees, "rad": np.radians,
}


def _date_part(kind: str, sec: np.ndarray) -> np.ndarray:
    """One calendar component of unix-seconds values (UTC), NaN-preserving
    — promql functions.go funcDaysInMonth..funcYear. Computes only the
    requested component (a vector query pays one decomposition, not 8)."""
    finite = np.isfinite(sec)
    s = np.where(finite, sec, 0.0).astype(np.int64)
    if kind == "minute":
        v = (s // 60) % 60
    elif kind == "hour":
        v = (s // 3600) % 24
    elif kind == "day_of_week":
        # unix epoch was a Thursday; promql uses 0=Sunday
        v = (s // 86400 + 4) % 7
    else:
        dt = s.astype("datetime64[s]")
        if kind == "year":
            v = dt.astype("datetime64[Y]").astype(np.int64) + 1970
        elif kind == "month":
            v = dt.astype("datetime64[M]").astype(np.int64) % 12 + 1
        elif kind == "day_of_month":
            v = (dt.astype("datetime64[D]")
                 - dt.astype("datetime64[M]").astype("datetime64[D]")
                 ).astype(np.int64) + 1
        elif kind == "day_of_year":
            v = (dt.astype("datetime64[D]")
                 - dt.astype("datetime64[Y]").astype("datetime64[D]")
                 ).astype(np.int64) + 1
        elif kind == "days_in_month":
            months = dt.astype("datetime64[M]")
            v = ((months + np.timedelta64(1, "M")).astype("datetime64[D]")
                 - months.astype("datetime64[D]")).astype(np.int64)
        else:
            raise QueryError(f"unknown date function {kind}")
    return np.where(finite, v.astype(np.float64), np.nan)


_DATE_FUNCS = ("minute", "hour", "day_of_week", "day_of_month",
               "day_of_year", "days_in_month", "month", "year")

_BIN_FUNCS: Dict[str, Callable] = {
    "+": np.add, "-": np.subtract, "*": np.multiply,
    # fmod = Go math.Mod truncated-toward-zero semantics (promql '%'),
    # unlike np.mod's floored modulo.
    "/": np.divide, "%": np.fmod, "^": np.power,
    "==": lambda a, b: (a == b).astype(np.float64),
    "!=": lambda a, b: (a != b).astype(np.float64),
    "<": lambda a, b: (a < b).astype(np.float64),
    ">": lambda a, b: (a > b).astype(np.float64),
    "<=": lambda a, b: (a <= b).astype(np.float64),
    ">=": lambda a, b: (a >= b).astype(np.float64),
}


def _guard(fn, v):
    with np.errstate(invalid="ignore", divide="ignore"):
        return fn(v)


def _map_values(val: Value, fn) -> Value:
    if isinstance(val, Block):
        return val.with_values(fn(val.values))
    if isinstance(val, np.ndarray):
        return fn(val)
    return fn(val)


def _broadcast_scalar(val: Value, params: QueryParams) -> np.ndarray:
    if isinstance(val, Block):
        raise QueryError("expected scalar, got vector")
    if isinstance(val, np.ndarray):
        return val
    return np.full(params.steps, float(val))


def _to_block(val: Value, params: QueryParams) -> Block:
    if isinstance(val, Block):
        return val
    arr = _broadcast_scalar(val, params)
    return Block(params.meta(), [Tags.of({})], arr[None, :])


def _strip_name(t: Tags) -> Tags:
    return t.without([METRIC_NAME])


def _group_series(tags: List[Tags], grouping: Tuple[bytes, ...],
                  without: bool) -> Tuple[np.ndarray, List[Tags]]:
    """Group rows by kept labels (functions/aggregation/function.go
    collectSeries): by(...) keeps listed labels; without(...) drops them
    (and the metric name); no modifier = one global group."""
    ids = np.zeros(len(tags), dtype=np.int64)
    group_tags: List[Tags] = []
    seen: Dict[bytes, int] = {}
    for i, t in enumerate(tags):
        if without:
            gt = t.without(list(grouping) + [METRIC_NAME])
        elif grouping:
            gt = t.keep(grouping)
        else:
            gt = Tags.of({})
        key = gt.id()
        g = seen.get(key)
        if g is None:
            g = seen[key] = len(group_tags)
            group_tags.append(gt)
        ids[i] = g
    return ids, group_tags


def _match_key(t: Tags, matching) -> bytes:
    if matching is not None and matching.on:
        return t.keep(matching.labels).id()
    drop = list(matching.labels) if matching is not None else []
    return t.without(drop + [METRIC_NAME]).id()


def _vector_vector(node: BinaryOp, lhs: Block, rhs: Block, fn,
                   comparison: bool) -> Block:
    matching = node.matching
    many_side_left = matching.group_left if matching else False
    many_side_right = matching.group_right if matching else False
    one_to_one = not (many_side_left or many_side_right)
    # Map the "one" side by matching key.
    if many_side_right:
        many, one, swap = rhs, lhs, True
    else:
        many, one, swap = lhs, rhs, False
    one_map: Dict[bytes, int] = {}
    for j, t in enumerate(one.series_tags):
        key = _match_key(t, matching)
        if key in one_map:
            raise QueryError(
                "many-to-many vector matching: duplicate series on the "
                f"'one' side for key {key!r}")
        one_map[key] = j
    tags_out: List[Tags] = []
    rows: List[np.ndarray] = []
    seen_result: Dict[bytes, int] = {}
    for i, t in enumerate(many.series_tags):
        j = one_map.get(_match_key(t, matching))
        if j is None:
            continue
        a = many.values[i]
        b = one.values[j]
        with np.errstate(divide="ignore", invalid="ignore"):
            out = fn(b, a) if swap else fn(a, b)
        both = np.isfinite(many.values[i]) & np.isfinite(one.values[j])
        result_tags = _result_tags(t, one.series_tags[j], matching, comparison,
                                   node.bool_mode)
        if comparison and not node.bool_mode:
            out = np.where(out > 0, a, np.nan)
        else:
            out = np.where(both, out, np.nan)
        key = result_tags.id()
        if one_to_one and key in seen_result:
            raise QueryError("multiple matches for the same result labels")
        seen_result[key] = i
        tags_out.append(result_tags)
        rows.append(out)
    values = np.stack(rows) if rows else np.zeros((0, lhs.meta.steps))
    return Block(lhs.meta, tags_out, values)


def _result_tags(many_tags: Tags, one_tags: Tags, matching, comparison: bool,
                 bool_mode: bool) -> Tags:
    if comparison and not bool_mode:
        return many_tags
    t = many_tags.without([METRIC_NAME])
    if matching is not None and matching.include:
        for lbl in matching.include:
            v = one_tags.get(lbl)
            if v is not None:
                t = t.with_tag(lbl, v)
            else:
                t = t.without([lbl])
    return t


def _set_op(op: str, lhs: Value, rhs: Value, matching) -> Block:
    if not isinstance(lhs, Block) or not isinstance(rhs, Block):
        raise QueryError(f"{op} requires vector operands")
    rhs_keys = {_match_key(t, matching): j for j, t in enumerate(rhs.series_tags)}
    tags_out, rows = [], []
    if op in ("and", "unless"):
        for i, t in enumerate(lhs.series_tags):
            j = rhs_keys.get(_match_key(t, matching))
            if op == "and":
                if j is None:
                    continue
                keep = np.isfinite(rhs.values[j])
            else:
                keep = (np.zeros(lhs.meta.steps, bool) if j is None else
                        np.isfinite(rhs.values[j]))
                keep = ~keep if j is not None else np.ones(lhs.meta.steps, bool)
            vals = np.where(keep, lhs.values[i], np.nan)
            if np.isfinite(vals).any() or op == "and":
                tags_out.append(t)
                rows.append(vals)
    else:  # or
        lhs_keys = set()
        for i, t in enumerate(lhs.series_tags):
            lhs_keys.add(_match_key(t, matching))
            tags_out.append(t)
            rows.append(lhs.values[i])
        for j, t in enumerate(rhs.series_tags):
            if _match_key(t, matching) not in lhs_keys:
                tags_out.append(t)
                rows.append(rhs.values[j])
    values = np.stack(rows) if rows else np.zeros((0, lhs.meta.steps))
    return Block(lhs.meta, tags_out, values)


def _histogram_quantile(q: float, block: Block) -> Block:
    """promql histogram_quantile over classic le-bucket series
    (functions/linear/histogram_quantile.go)."""
    groups: Dict[bytes, List[Tuple[float, int]]] = {}
    group_tags: Dict[bytes, Tags] = {}
    for i, t in enumerate(block.series_tags):
        le = t.get(b"le")
        if le is None:
            continue
        gt = t.without([b"le", METRIC_NAME])
        key = gt.id()
        group_tags[key] = gt
        groups.setdefault(key, []).append((float(le), i))
    tags_out, rows = [], []
    for key, buckets in sorted(groups.items()):
        buckets.sort()
        ubs = np.array([b[0] for b in buckets])
        idxs = [b[1] for b in buckets]
        if len(buckets) < 2 or not np.isinf(ubs[-1]):
            # upstream requires a +Inf bucket AND at least two buckets:
            # without them the total/interpolation is unknowable and the
            # result is NaN (promql functions.go bucketQuantile), not a
            # guess that treats the largest finite bucket as the total
            # or collapses a lone +Inf bucket to 0.
            tags_out.append(group_tags[key])
            rows.append(np.full(block.meta.steps, np.nan))
            continue
        counts = block.values[idxs]  # cumulative counts [B, T]
        total = counts[-1]
        out = np.full(block.meta.steps, np.nan)
        with np.errstate(invalid="ignore", divide="ignore"):
            rank = q * total
            # First bucket whose cumulative count >= rank.
            ge = counts >= rank[None, :]
            first = np.argmax(ge, axis=0)
            any_ge = ge.any(axis=0)
            b_idx = np.clip(first, 0, len(buckets) - 1)
            ub = ubs[b_idx]
            lb = np.where(b_idx > 0, ubs[np.maximum(b_idx - 1, 0)], 0.0)
            cnt_ub = counts[b_idx, np.arange(counts.shape[1])]
            cnt_lb = np.where(b_idx > 0,
                              counts[np.maximum(b_idx - 1, 0),
                                     np.arange(counts.shape[1])], 0.0)
            frac = np.where(cnt_ub > cnt_lb, (rank - cnt_lb) / (cnt_ub - cnt_lb), 0)
            interp = lb + (ub - lb) * frac
            # +Inf bucket selected -> return the lower bound (prom behavior).
            interp = np.where(np.isinf(ub), lb, interp)
            out = np.where((total > 0) & any_ge, interp, np.nan)
        tags_out.append(group_tags[key])
        rows.append(out)
    values = np.stack(rows) if rows else np.zeros((0, block.meta.steps))
    return Block(block.meta, tags_out, values)


def _const_param(node: Optional[Node]) -> float:
    if isinstance(node, NumberLiteral):
        return float(node.value)
    if isinstance(node, Unary) and isinstance(node.expr, NumberLiteral):
        return -node.expr.value
    raise QueryError("expected a constant parameter")


def _string_param(node: Node) -> str:
    if isinstance(node, StringLiteral):
        return node.value
    raise QueryError("expected a string parameter")


def _absent_tags(node: Node) -> Tags:
    if isinstance(node, Subquery):
        return _absent_tags(node.expr)
    if isinstance(node, VectorSelector):
        d = {}
        if node.name:
            d[METRIC_NAME] = node.name
        for m in node.matchers:
            if m.type == MatchType.EQUAL:
                d[m.name] = m.value
        d.pop(METRIC_NAME, None)
        return Tags.of(d)
    return Tags.of({})


def _format_value(v: float) -> bytes:
    if v == int(v):
        return str(int(v)).encode()
    return repr(v).encode()


def _go_template_to_py(repl: str) -> str:
    """Convert prom's $1/${name} capture refs to python re.expand refs."""
    return re_sub_dollar(repl)


def re_sub_dollar(repl: str) -> str:
    import re as _re

    return _re.sub(r"\$(\d+|\{\w+\})", lambda m: "\\" + m.group(1).strip("{}"), repl)
