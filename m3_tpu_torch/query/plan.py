"""Query plan IR: the logical->physical plan a PromQL AST lowers to
before whole-plan compilation (port of m3_tpu/query/plan.py, host only;
reference: src/query/parser builds a logical DAG that executor/engine.go
walks per block; here the DAG is lowered ONCE into a typed physical plan
whose operator chain runs as ONE program — parallel/compile.py, a CUDA
graph on the card).

A plan is a frozen tree of physical nodes (Fetch / RangeFunc /
SubqueryFunc / RankAgg / InstantFunc / Aggregate / Binary / ScalarConst),
each edge annotated with its value kind ("series" = a [S, T] block,
"scalar" = a 0-d value broadcast over steps) and its sharding ("shard" =
rows partitioned over a mesh's shard axis, "replicated" = identical on
every device). The annotations are the reference's: a plan whose every
series edge stays row-partitioned (`mesh_ok`) runs over the mesh's shard
axis as one program with collective fan-in (parallel/compile.py), the
others on one device; EXPLAIN shows them. A plan containing any non-lowerable node doesn't compile at
all and the executor falls back to the retained interpreter
(`Engine.execute_range_ref`, the oracle).

Host/tag algebra stays OUT of the plan: `bind()` runs the label work
(grouping, vector matching, result tags) on the host once per query and
produces index arrays the compiled program consumes as inputs — the
device program touches values only.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import promql
from .model import Tags, METRIC_NAME
from .promql import (
    Aggregation,
    BinaryOp,
    Call,
    Node as AstNode,
    NumberLiteral,
    Subquery,
    Unary,
    VectorSelector,
)

# Dispatch floor: a query fetching fewer grid cells than this stays on the
# interpreter — tiny queries gain nothing from a compiled program and the
# interpreter's exact-f64 finishes are the reference semantics for them.
# The reference's default, fixed here (the port reads no environment
# knob; tests monkeypatch it).
PLAN_MIN_CELLS = 4096

SERIES = "series"
SCALAR = "scalar"

SHARDED = "shard"
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class Edge:
    """Type + sharding annotation of a node's output edge."""

    kind: str        # SERIES | SCALAR
    sharding: str    # SHARDED | REPLICATED


@dataclasses.dataclass(frozen=True)
class PlanNode:
    pass


@dataclasses.dataclass(frozen=True)
class Fetch(PlanNode):
    """A gridded selector: the consolidated [S, ext_T] grid at the window
    grid (range role) or the step grid with lookback (instant role).
    `sel` carries the source selector for binding; the compile key strips
    it (the traced program depends only on the physical fields). `ctx`
    distinguishes otherwise-equal selectors gridded in DIFFERENT time
    contexts (each subquery's inner grid gets a fresh ctx id), so
    binding/staging never conflates an outer step-grid fetch with the
    same selector on a subquery's resolution grid."""

    sel: VectorSelector
    role: str                 # "range" | "instant"
    W: int                    # cells per window (1 for instant)
    stride: int               # window-grid cells per output step
    wgrid_ns: int             # grid cell width
    ctx: int = 0              # subquery grid context (0 = outer query)

    @property
    def edge(self) -> Edge:
        return Edge(SERIES, SHARDED)


@dataclasses.dataclass(frozen=True)
class RangeFunc(PlanNode):
    """A temporal kernel over a range-gridded Fetch (ops/temporal math)."""

    func: str
    arg: Fetch
    step_ns: int
    range_ns: int
    params: Tuple[float, ...] = ()

    @property
    def edge(self) -> Edge:
        # absent_over_time collapses every row into one presence row —
        # a cross-shard reduce whose output is whole on every device.
        if self.func == "absent_over_time":
            return Edge(SERIES, REPLICATED)
        return Edge(SERIES, SHARDED)


@dataclasses.dataclass(frozen=True)
class SubqueryFunc(PlanNode):
    """A range function over `expr[range:res]`: the inner plan evaluates
    on its own resolution grid (a nested range grid over the same
    shard x time mesh), then the outer func re-windows that plane with
    the SAME W/stride machinery matrix selectors use. `packed=False`
    (res divides the query step) reads contiguous strided windows
    straight off the inner plane; `packed=True` gathers each output
    step's drifting window through a bind-time column-index map (the
    compiled twin of the interpreter's packed layout). Window extraction
    is a pure per-row COLUMN operation, so the mesh sharding of the
    inner plan is preserved."""

    func: str
    arg: PlanNode
    W: int                    # window cells (packed: == stride)
    stride: int
    packed: bool
    res_ns: int               # inner resolution (the kernels' step)
    range_ns: int
    offset_ns: int = 0        # bind-only (stripped from the compile key)
    inner_steps: int = 0      # inner grid length (geometry; stripped)
    params: Tuple[float, ...] = ()

    @property
    def edge(self) -> Edge:
        return Edge(SERIES, self.arg.edge.sharding)


@dataclasses.dataclass(frozen=True)
class RankAgg(PlanNode):
    """Order-statistic aggregation (topk / bottomk / quantile): bind()
    packs each group's rows contiguously (perm index arrays), the device
    sort-selects along the packed axis (ops/series_agg packed_* math —
    the aggregator's quantile_rank_select shape generalized), and the k / q
    parameter rides as a runtime slot so one executable serves every
    threshold. Needs cross-row gathers, so plans containing one compile
    single-device (same rule as vector-vector matching)."""

    op: str                   # "topk" | "bottomk" | "quantile"
    arg: PlanNode
    param: "ScalarConst"
    grouping: Tuple[bytes, ...] = ()
    without: bool = False

    @property
    def edge(self) -> Edge:
        return Edge(SERIES, REPLICATED)


@dataclasses.dataclass(frozen=True)
class InstantFunc(PlanNode):
    """Elementwise math over a series plane (the _MATH_FUNCS subset with
    torch equivalents); scalar params ride as slots."""

    func: str
    arg: PlanNode
    params: Tuple["ScalarConst", ...] = ()

    @property
    def edge(self) -> Edge:
        return self.arg.edge


@dataclasses.dataclass(frozen=True)
class Aggregate(PlanNode):
    """Cross-series aggregation; grouping structure is bind-time host
    work, the reduce is a compensated device sum with collective fan-in.
    exact=True marks the counter-sum path (aggregate directly over a raw
    Fetch): residual/baseline decomposition + two-sum compensated
    reduction preserve the interpreter's f64 host-reduce semantics."""

    op: str
    arg: PlanNode
    grouping: Tuple[bytes, ...] = ()
    without: bool = False
    exact: bool = False

    @property
    def edge(self) -> Edge:
        return Edge(SERIES, REPLICATED)


@dataclasses.dataclass(frozen=True)
class Binary(PlanNode):
    op: str
    lhs: PlanNode
    rhs: PlanNode
    bool_mode: bool = False
    # vector-vector only: bind() computes row alignment; the compiled
    # program gathers by the bound index arrays. `swap` (the many side
    # is the RHS, i.e. group_right) is static program structure and
    # survives compile-key stripping; the matching labels are bind-only.
    matching: Optional[promql.VectorMatching] = None
    swap: bool = False

    @property
    def edge(self) -> Edge:
        le, re_ = self.lhs.edge, self.rhs.edge
        if le.kind == SCALAR and re_.kind == SCALAR:
            return Edge(SCALAR, REPLICATED)
        if le.kind == SERIES and re_.kind == SERIES:
            # vv matching needs cross-row gathers -> not mesh-shardable
            return Edge(SERIES, REPLICATED)
        vec = le if le.kind == SERIES else re_
        return vec


@dataclasses.dataclass(frozen=True)
class ScalarConst(PlanNode):
    """A runtime scalar slot: the VALUE is not part of the plan (so the
    plan cache reuses one executable across thresholds); bind() records
    slot values in plan order."""

    slot: int

    @property
    def edge(self) -> Edge:
        return Edge(SCALAR, REPLICATED)


@dataclasses.dataclass(frozen=True)
class Plan:
    root: PlanNode
    steps: int
    n_slots: int
    fetches: Tuple[Fetch, ...]
    # True when every series edge stays row-partitioned (no cross-row
    # gathers), i.e. the plan can run as ONE shard_map program with
    # collective fan-in.
    mesh_ok: bool


class FallbackReason(enum.Enum):
    """The catalogued reasons a query misses the compiled whole-plan
    route. Every `NotCompilable` raise site names one (enforced by
    tests/test_explain.py's raise-site scan — free-form strings cannot
    creep back in), the executor counts each fallback reason-tagged in
    instrument scope `telemetry.plan_fallback` (visible in /debug/vars,
    the self-scrape pipeline and the slow-query ring), and EXPLAIN
    (`query/explain.py`) annotates the failing plan node with it. The
    values are a CLOSED set: they ride as telemetry tag values, where an
    unbounded value (a raw query string) would explode the metric
    registry."""

    # Retired in round 16 (now lowered): "subquery" (the SubqueryFunc
    # nested range grid) and "group-matching" (one-to-many vv index
    # maps). The members are GONE, not parked: the raise-site scan in
    # tests/test_explain.py proves nothing still names them.
    MATRIX_SELECTOR = "matrix-selector"        # bare m[5m] outside a func
    AT_MODIFIER = "at-modifier"                # @-pinned selector
    SELECTOR_SHAPE = "selector-shape"          # range func w/o matrix arg
    UNSUPPORTED_NODE = "unsupported-node"      # AST node kind not lowered
    UNSUPPORTED_FUNC = "unsupported-func"      # absent/label_replace/...
    UNSUPPORTED_AGG = "unsupported-agg"        # count_values/non-root topk
    AGG_OVER_SCALAR = "agg-over-scalar"        # sum(2) — type error shape
    SET_OP = "set-op"                          # and / or / unless
    F64_ARITH = "f64-arith"                    # % / ^ need f64 granularity
    ABS_COMPARISON = "abs-comparison"          # compare on 1e9+ f32 plane
    NON_CONSTANT_PARAM = "non-constant-param"  # clamp(m, x) etc.
    SCALAR_ONLY = "scalar-only"                # no selector in the plan
    BELOW_FLOOR = "below-floor"                # total cells < PLAN_MIN_CELLS
    BACKEND_GAP = "backend-gap"                # compile-time PlanFallback
    DISABLED = "disabled"                      # plan route off (_ref)
    # The reference's guarded-dispatch fallback; this port raises a typed
    # ComputeError instead (parallel/guard), so no route records it.
    DEVICE_FAULT = "device-fault"


# Reasons that are RUNTIME routing decisions (data size, kill switches,
# backend gaps), not plan-structure facts: telemetry tags each fallback
# with this split so a coverage replay's STRUCTURAL re-lowering can never
# disagree with recorded routes on small-series corpora — a below-floor
# miss is not a lowering gap (corpus.coverage reads both).
RUNTIME_REASONS = frozenset({
    "below-floor", "backend-gap", "disabled", "device-fault",
})


def fallback_scope(reason_value: str) -> str:
    """telemetry.plan_fallback's scope tag for one FallbackReason value:
    "runtime" (data-dependent / operational) vs "structural" (the query
    shape is outside the compiled surface)."""
    return "runtime" if reason_value in RUNTIME_REASONS else "structural"


class NotCompilable(Exception):
    """Raised during lowering when a node falls outside the compiled
    surface; the executor falls back to the per-node interpreter.

    Carries a typed `reason` (FallbackReason — the bounded taxonomy the
    telemetry/EXPLAIN surfaces consume), a free-form `detail` for humans,
    and the AST `node` that raised (EXPLAIN pins the reason onto it)."""

    def __init__(self, reason: FallbackReason, detail: str = "",
                 node=None):
        self.reason = reason
        self.detail = detail
        self.node = node
        super().__init__(f"{reason.value}: {detail}" if detail
                         else reason.value)


# Range functions with fully-traceable device bodies (ops/temporal math).
# Round 16 closed the last gaps: irate/idelta compute their last-two-
# sample differences in residual space on device (temporal.instant_math
# — the staged resid decomposition keeps counter-magnitude diffs exact,
# where the old host path gathered f64 values by device indices, a host
# sync mid-plan), quantile_over_time interpolates in residual space
# (shift-equivariant, temporal.quantile_ot_math), and absent_over_time
# is a window-count + cross-row presence reduce.
RANGE_FUNCS = frozenset({
    "rate", "increase", "delta", "deriv", "changes", "resets",
    "predict_linear", "holt_winters", "irate", "idelta",
    "sum_over_time", "avg_over_time", "min_over_time", "max_over_time",
    "count_over_time", "last_over_time", "stddev_over_time",
    "stdvar_over_time", "present_over_time", "quantile_over_time",
    "absent_over_time",
})

# Elementwise math with exact torch twins (NaN-propagating like the host
# versions). round/clamp* take scalar params as slots.
MATH_FUNCS = frozenset({
    "abs", "ceil", "floor", "exp", "sqrt", "ln", "log2", "log10", "sgn",
    "round", "clamp", "clamp_min", "clamp_max",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "deg", "rad",
})

AGG_OPS = frozenset({"sum", "avg", "min", "max", "count", "group",
                     "stddev", "stdvar"})

# Order-statistic aggregations: the RankAgg packed sort-select path.
RANK_AGGS = frozenset({"topk", "bottomk", "quantile"})

# Outer funcs lowerable over a subquery. absent_over_time's cross-row
# presence reduce is Fetch-shaped (selector tags, empty-fetch rows) and
# stays on the interpreter over subqueries.
SUBQUERY_FUNCS = RANGE_FUNCS - {"absent_over_time"}

# Subquery funcs whose math DIFFERENCES or REGRESSES the plane: over a
# composite (non-selector) inner expression the prep runs in-trace at
# f32, which at absolute counter magnitudes (1e9+, ulp 64) turns
# consecutive-sample diffs into rounding noise — those stay on the
# interpreter (same f64-granularity reason %/^ do). Direct selector
# inners stage their preps on the host in exact f64 and lower fully.
_SUBQ_DIFF_FUNCS = frozenset({
    "rate", "increase", "delta", "irate", "idelta", "deriv",
    "predict_linear", "holt_winters", "stddev_over_time",
    "stdvar_over_time",
})

# %/^ stay on the interpreter: fmod/pow need f64 granularity at counter
# magnitudes (2^m % 7 on an f32 plane is pure rounding noise), and the
# compiled value planes are f32 by design.
ARITH_OPS = frozenset({"+", "-", "*", "/"})


# Range functions whose output is in the units of the raw samples
# (reconstructed absolute magnitudes: window stats over values, or a
# regression/forecast with the baseline added back) — as opposed to
# difference/count space (rate, delta, changes, ...), which is small
# regardless of counter magnitude.
_ABS_RANGE_FUNCS = frozenset({
    "sum_over_time", "avg_over_time", "min_over_time", "max_over_time",
    "last_over_time", "predict_linear", "holt_winters",
    "quantile_over_time",
})


def _abs_space(node: PlanNode) -> bool:
    """True when the node's value plane carries raw-sample magnitudes
    (1e9+ for counters), where f32 granularity is coarser than the
    interpreter's f64 — a comparison there can flip sample PRESENCE, a
    discrete divergence no FP tolerance covers."""
    if isinstance(node, Fetch):
        return True
    if isinstance(node, RangeFunc):
        return node.func in _ABS_RANGE_FUNCS
    if isinstance(node, SubqueryFunc):
        return node.func in _ABS_RANGE_FUNCS
    if isinstance(node, RankAgg):
        # topk/bottomk/quantile select VALUES of the argument plane.
        return _abs_space(node.arg)
    if isinstance(node, InstantFunc):
        # timestamp() emits unix seconds (~1.7e9): absolute magnitudes
        # regardless of its argument's space.
        if node.func == "timestamp":
            return True
        return _abs_space(node.arg)
    if isinstance(node, Aggregate):
        # stddev/stdvar spread across series of different baselines can
        # itself reach baseline magnitude — treat as absolute space.
        return node.op in ("sum", "avg", "min", "max", "stddev",
                           "stdvar") and _abs_space(node.arg)
    if isinstance(node, Binary):
        return _abs_space(node.lhs) or _abs_space(node.rhs)
    return False


class _Lowerer:
    def __init__(self, params, lookback_ns: int):
        self.params = params
        self.lookback_ns = lookback_ns
        self.slots: List[AstNode] = []
        self._depth = 0       # AST nesting below the root (1 = root node)
        self._ctx = 0         # current subquery grid context (0 = outer)
        self._next_ctx = 0

    def _slot(self, node: AstNode) -> ScalarConst:
        self.slots.append(node)
        return ScalarConst(len(self.slots) - 1)

    def lower(self, node: AstNode) -> PlanNode:
        self._depth += 1
        try:
            return self._lower(node)
        finally:
            self._depth -= 1

    def _lower(self, node: AstNode) -> PlanNode:
        p = self.params
        if isinstance(node, NumberLiteral):
            return self._slot(node)
        if isinstance(node, Unary):
            inner = self.lower(node.expr)
            return InstantFunc("neg", inner)
        if isinstance(node, VectorSelector):
            if node.at_ns is not None:
                raise NotCompilable(FallbackReason.AT_MODIFIER,
                                    "@-pinned selector", node)
            if node.range_ns:
                raise NotCompilable(FallbackReason.MATRIX_SELECTOR,
                                    "bare matrix selector", node)
            return Fetch(node, "instant", 1, 1, p.step_ns, self._ctx)
        if isinstance(node, Call):
            return self._lower_call(node)
        if isinstance(node, Aggregation):
            return self._lower_aggregation(node)
        if isinstance(node, BinaryOp):
            return self._lower_binary(node)
        raise NotCompilable(FallbackReason.UNSUPPORTED_NODE,
                            type(node).__name__, node)

    def _func_params(self, f: str, node: Call) -> Tuple[float, ...]:
        if f == "predict_linear":
            return (self._const(node.args[1]),)
        if f == "holt_winters":
            return (self._const(node.args[1]), self._const(node.args[2]))
        if f == "quantile_over_time":
            return (self._const(node.args[0]),)
        return ()

    def _lower_call(self, node: Call) -> PlanNode:
        f = node.func
        if f in RANGE_FUNCS:
            sels = [a for a in node.args
                    if isinstance(a, (VectorSelector, Subquery))]
            if sels and isinstance(sels[-1], Subquery):
                return self._lower_subquery(f, node, sels[-1])
            if not sels:
                raise NotCompilable(FallbackReason.SELECTOR_SHAPE,
                                    f"{f} without a matrix selector", node)
            sel = sels[-1]
            if sel.at_ns is not None:
                raise NotCompilable(FallbackReason.AT_MODIFIER,
                                    f"{f} over @-pinned selector", node)
            if not sel.range_ns:
                raise NotCompilable(FallbackReason.SELECTOR_SHAPE,
                                    f"{f} over an instant selector", node)
            p = self.params
            wgrid = math.gcd(p.step_ns, sel.range_ns)
            W = sel.range_ns // wgrid
            stride = p.step_ns // wgrid
            fetch = Fetch(sel, "range", W, stride, wgrid, self._ctx)
            return RangeFunc(f, fetch, wgrid, sel.range_ns,
                             self._func_params(f, node))
        if f == "timestamp":
            if not node.args:
                raise NotCompilable(FallbackReason.SELECTOR_SHAPE,
                                    "timestamp with no args", node)
            arg = self.lower(node.args[0])
            if arg.edge.kind != SERIES:
                raise NotCompilable(FallbackReason.SELECTOR_SHAPE,
                                    "timestamp over a scalar operand", node)
            return InstantFunc("timestamp", arg)
        if f in MATH_FUNCS:
            if not node.args:
                raise NotCompilable(FallbackReason.SELECTOR_SHAPE,
                                    f"{f} with no args", node)
            arg = self.lower(node.args[0])
            for a in node.args[1:]:
                self._const(a)  # only constant params compile
            extra = tuple(self._slot(a) for a in node.args[1:])
            return InstantFunc(f, arg, extra)
        raise NotCompilable(FallbackReason.UNSUPPORTED_FUNC,
                            f"function {f}", node)

    def _lower_subquery(self, f: str, node: Call, sub: Subquery) -> PlanNode:
        """`f(expr[range:res])`: lower the inner expression on its own
        resolution grid (a fresh Fetch ctx), then wrap it in a
        SubqueryFunc carrying the SAME W/stride window geometry the
        interpreter's _eval_subquery_grid derives — shared-grid when res
        divides the query step, packed-gather otherwise."""
        from .executor import DEFAULT_SUBQUERY_RES_NS, QueryParams

        if f not in SUBQUERY_FUNCS:
            raise NotCompilable(FallbackReason.UNSUPPORTED_FUNC,
                                f"{f} over subquery", node)
        if sub.at_ns is not None:
            raise NotCompilable(FallbackReason.AT_MODIFIER,
                                f"{f} over @-pinned subquery", node)
        p = self.params
        res = sub.step_ns or max(p.step_ns, DEFAULT_SUBQUERY_RES_NS)
        k_min, k_max = subquery_grid(sub.range_ns, res, sub.offset_ns, p)
        inner_params = QueryParams(k_min * res, k_max * res, res)
        x0 = p.start_ns - sub.offset_ns
        if p.step_ns % res == 0 and sub.range_ns >= res:
            W = x0 // res - (x0 - sub.range_ns) // res
            stride = p.step_ns // res
            packed = False
        else:
            W = stride = max(sub.range_ns // res
                             + (1 if sub.range_ns % res else 0), 1)
            packed = True
        self._next_ctx += 1
        outer_params, outer_ctx = self.params, self._ctx
        self.params, self._ctx = inner_params, self._next_ctx
        try:
            arg = self.lower(sub.expr)
        finally:
            self.params, self._ctx = outer_params, outer_ctx
        abs_arg = _abs_space(arg)
        if not isinstance(arg, Fetch) and f in _SUBQ_DIFF_FUNCS and abs_arg:
            # Composite inner at counter magnitudes: the in-trace f32
            # prep would turn consecutive-sample diffs into rounding
            # noise (selector inners stage exact-f64 preps instead).
            raise NotCompilable(
                FallbackReason.F64_ARITH,
                f"{f} differences an absolute-magnitude subquery plane "
                "(f64 granularity)", node)
        if packed and f in ("rate", "increase") and abs_arg:
            # The interpreter's packed layout places each window's first
            # lane after a LATER cell of the previous window, so its
            # counter-reset rule fires with the full absolute value
            # (1e9+) as the adjustment — which then cancels only in the
            # oracle's own f32 accumulation noise. That cancellation is
            # not reproducible faithfully from the exact inner-grid
            # preps, so counter rates over packed-grid subqueries of
            # absolute-magnitude planes stay on the interpreter (delta
            # and the window-local funcs are unaffected).
            raise NotCompilable(
                FallbackReason.F64_ARITH,
                f"{f} over a packed-grid subquery of an "
                "absolute-magnitude plane (f64 granularity)", node)
        return SubqueryFunc(f, arg, W, stride, packed, res, sub.range_ns,
                            sub.offset_ns, k_max - k_min + 1,
                            self._func_params(f, node))

    def _lower_aggregation(self, node: Aggregation) -> PlanNode:
        if node.op in RANK_AGGS:
            return self._lower_rank_agg(node)
        if node.op not in AGG_OPS:
            raise NotCompilable(FallbackReason.UNSUPPORTED_AGG,
                                f"aggregation {node.op}", node)
        arg = self.lower(node.expr)
        if arg.edge.kind != SERIES:
            raise NotCompilable(FallbackReason.AGG_OVER_SCALAR,
                                f"{node.op} over a scalar operand", node)
        exact = isinstance(arg, Fetch) and node.op in ("sum", "avg")
        return Aggregate(node.op, arg, node.grouping, node.without, exact)

    def _lower_rank_agg(self, node: Aggregation) -> PlanNode:
        if node.op in ("topk", "bottomk") and self._depth > 1:
            # topk's output SERIES SET is data-dependent (rows in the k
            # best at any step survive, the rest are dropped): only the
            # root can host-filter rows after materialization; an inner
            # topk would feed phantom all-NaN rows to its consumer.
            raise NotCompilable(FallbackReason.UNSUPPORTED_AGG,
                                f"non-root {node.op}", node)
        if node.param is None:
            raise NotCompilable(FallbackReason.NON_CONSTANT_PARAM,
                                f"{node.op} without a parameter", node)
        p_val = self._const(node.param)  # only constant k/q compile
        if node.op == "quantile" and not 0.0 <= p_val <= 1.0:
            # The interpreter (np.nanquantile) RAISES for q outside
            # [0, 1]; the device sort-select would clip and extrapolate
            # — keep the error behavior by staying interpreted.
            raise NotCompilable(FallbackReason.UNSUPPORTED_AGG,
                                f"quantile parameter {p_val} outside "
                                "[0, 1]", node)
        arg = self.lower(node.expr)
        if arg.edge.kind != SERIES:
            raise NotCompilable(FallbackReason.AGG_OVER_SCALAR,
                                f"{node.op} over a scalar operand", node)
        return RankAgg(node.op, arg, self._slot(node.param),
                       node.grouping, node.without)

    def _lower_binary(self, node: BinaryOp) -> PlanNode:
        if node.op in promql.SET_OPS:
            raise NotCompilable(FallbackReason.SET_OP,
                                f"set op {node.op}", node)
        if node.op not in ARITH_OPS and node.op not in promql.COMPARISON_OPS:
            raise NotCompilable(FallbackReason.F64_ARITH,
                                f"f64-sensitive arithmetic {node.op}", node)
        lhs = self.lower(node.lhs)
        rhs = self.lower(node.rhs)
        if node.op in promql.COMPARISON_OPS and (
                _abs_space(lhs) or _abs_space(rhs)):
            # A comparison FILTERS: flipping one side across the
            # threshold changes which samples EXIST, not a value within
            # tolerance. Absolute selector planes carry raw counter
            # magnitudes (1e9+: f32 ulp 64) where the interpreter's f64
            # compare and an f32 device compare disagree discretely —
            # same f64-granularity reason %/^ stay on the interpreter.
            # Difference-space planes (rate/delta) are f32 in BOTH
            # routes, so those comparisons stay compiled.
            raise NotCompilable(
                FallbackReason.ABS_COMPARISON,
                "comparison over an absolute-magnitude plane (f64 "
                "granularity)", node)
        # group_left/group_right lowers like one-to-one matching: bind()
        # emits one-to-many index maps and the compiled gather replays
        # them — the label-copy columns are bind-time tag algebra.
        swap = bool(node.matching and node.matching.group_right)
        return Binary(node.op, lhs, rhs, node.bool_mode, node.matching,
                      swap)

    @staticmethod
    def _const(node: AstNode) -> float:
        if isinstance(node, NumberLiteral):
            return float(node.value)
        if isinstance(node, Unary) and isinstance(node.expr, NumberLiteral):
            return -node.expr.value
        raise NotCompilable(FallbackReason.NON_CONSTANT_PARAM,
                            "non-constant parameter", node)


def _walk_fetches(node: PlanNode, out: List[Fetch]):
    if isinstance(node, Fetch):
        if node not in out:
            out.append(node)
        return
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            _walk_fetches(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, PlanNode):
                    _walk_fetches(item, out)


def _mesh_ok(node: PlanNode) -> bool:
    """True when no node needs cross-row gathers: vector-vector binaries
    re-align rows by bind-time index maps, and rank aggregations sort
    across their whole group — both need rows a row-partitioned device
    doesn't hold, so those plans compile single-device instead.
    (SubqueryFunc's window extraction is a pure COLUMN operation and
    preserves mesh sharding.)"""
    if isinstance(node, RankAgg):
        return False
    if isinstance(node, Binary):
        if (node.lhs.edge.kind == SERIES and node.rhs.edge.kind == SERIES):
            return False
        return _mesh_ok(node.lhs) and _mesh_ok(node.rhs)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode) and not _mesh_ok(v):
            return False
    return True


# ------------------------------------------------------------------ binding


@dataclasses.dataclass
class BoundFetch:
    fetch: Fetch
    grid: np.ndarray          # [S, ext_T] f64 consolidated grid
    tags: List[Tags]
    W: int
    stride: int
    step_ns: int


@dataclasses.dataclass
class Bound:
    """Host-side query binding: grids, tag algebra, index maps and scalar
    slot values — everything the compiled program consumes as inputs plus
    everything the host needs to assemble the result Block."""

    plan: Plan
    params: object
    fetches: Dict[Fetch, BoundFetch]
    slots: np.ndarray                       # [n_slots] f64 slot values
    node_tags: Dict[int, List[Tags]]        # id(plan node) -> output tags
    aux: Dict[int, dict]                    # id(plan node) -> bind aux data
    total_cells: int
    out_tags: List[Tags]
    out_kind: str                            # SERIES | SCALAR


# Bind-time tag-algebra memo: the host label work (name stripping,
# grouping, vector-match alignment) is a pure function of (plan
# structure, the per-fetch tag LISTS) — and the grid cache hands back the
# SAME list object on every repeat evaluation of an unchanged selector.
# A dashboard burst re-running one query shape pays the O(series) tag
# algebra once, not per refresh (measured 35-60ms/query at 10k series —
# larger than the compiled dispatch it was feeding). Entries pin their
# source lists (strong refs), so an id() can never be recycled while its
# entry lives; the `is` checks make a stale hit structurally impossible.
_BIND_MEMO: "collections.OrderedDict[tuple, tuple]" = (
    collections.OrderedDict())
_BIND_MEMO_LOCK = threading.Lock()
_BIND_MEMO_MAX = 256


def _preorder(node: PlanNode, out: List[PlanNode]) -> List[PlanNode]:
    out.append(node)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            _preorder(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, PlanNode):
                    _preorder(item, out)
    return out


def subquery_grid(range_ns: int, res: int, offset_ns: int, outer_params
                  ) -> Tuple[int, int]:
    """(k_min, k_max) of the res-aligned inner evaluation grid for a
    subquery under `outer_params` — the ONE derivation shared by the
    lowerer (window geometry), bind (inner QueryParams) and the packed
    column maps, mirroring the interpreter's _eval_subquery_grid."""
    x0 = outer_params.start_ns - offset_ns
    k_min = (x0 - range_ns) // res + 1
    k_max = max((x0 + (outer_params.steps - 1) * outer_params.step_ns)
                // res, k_min)
    return k_min, k_max


def subquery_inner_params(node: SubqueryFunc, outer_params):
    """The inner resolution-grid QueryParams for one SubqueryFunc under
    `outer_params` — recomputed from the node's geometry fields so
    binding needs no side-channel from the lowerer."""
    from .executor import QueryParams

    k_min, k_max = subquery_grid(node.range_ns, node.res_ns,
                                 node.offset_ns, outer_params)
    return QueryParams(k_min * node.res_ns, k_max * node.res_ns,
                       node.res_ns)


def node_params_map(root: PlanNode, params) -> Dict[int, object]:
    """id(plan node) -> the QueryParams of its time-grid context: the
    outer query's for everything outside subqueries, the inner
    resolution grid inside each SubqueryFunc (nested subqueries
    compose)."""
    out: Dict[int, object] = {}

    def walk(node: PlanNode, p):
        out[id(node)] = p
        child_p = (subquery_inner_params(node, p)
                   if isinstance(node, SubqueryFunc) else p)
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, PlanNode):
                walk(v, child_p)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, PlanNode):
                        walk(item, child_p)

    walk(root, params)
    return out


def _packed_cols(node: SubqueryFunc, outer_params) -> np.ndarray:
    """Bind-time column-index map for a packed subquery window: for each
    output step, the W inner-grid columns of its trailing (T-range, T]
    window, -1 where the lane is outside the window (the interpreter's
    packed-gather geometry, flattened to [steps * W])."""
    res, W = node.res_ns, node.W
    x0 = outer_params.start_ns - node.offset_ns
    k_min, _ = subquery_grid(node.range_ns, res, node.offset_ns,
                             outer_params)
    steps = outer_params.steps
    x = x0 + np.arange(steps, dtype=np.int64) * outer_params.step_ns
    k_end = x // res
    k_start = (x - node.range_ns) // res + 1
    cols = (k_end[:, None] - (W - 1) + np.arange(W)[None, :] - k_min)
    valid = cols >= (k_start - k_min)[:, None]
    return np.where(valid, cols, -1).astype(np.int32).reshape(steps * W)


def bind(plan: Plan, engine, params,
         slot_values: Sequence[float] = ()) -> Bound:
    """Fetch + grid every selector through the engine's cached selector
    paths (grid cache, datapoint charging — identical to the interpreter)
    and run the host tag algebra for every node. Raises QueryError with
    the interpreter's exact semantics for matching violations."""
    from . import executor as ex

    # Per-node time-grid context: fetches under a subquery grid at the
    # inner resolution (the fetch's ctx field keeps them distinct from
    # equal selectors on the outer grid).
    params_of = node_params_map(plan.root, params)

    fetches: Dict[Fetch, BoundFetch] = {}
    total = 0
    for f in plan.fetches:
        fp = params_of[id(f)]
        if f.role == "range":
            blk, W, stride = engine._eval_range_selector(f.sel, fp)
            bf = BoundFetch(f, np.asarray(blk.values, dtype=np.float64),
                            blk.series_tags, W, stride,
                            blk.meta.step_ns)
        else:
            blk = engine._eval_instant_selector(f.sel, fp)
            bf = BoundFetch(f, np.asarray(blk.values, dtype=np.float64),
                            blk.series_tags, 1, 1, blk.meta.step_ns)
        fetches[f] = bf
        total += bf.grid.size

    slots = np.zeros(plan.n_slots, dtype=np.float64)
    for i, v in enumerate(slot_values):
        slots[i] = v

    src_lists = tuple(fetches[f].tags for f in plan.fetches)
    memo_key = (plan.root, tuple(map(id, src_lists)))
    with _BIND_MEMO_LOCK:
        ent = _BIND_MEMO.get(memo_key)
        if ent is not None and all(
                a is b for a, b in zip(ent[0], src_lists)):
            _BIND_MEMO.move_to_end(memo_key)
            _, tags_seq, aux_seq, out_kind = ent
        else:
            ent = None
    if ent is not None:
        nodes = _preorder(plan.root, [])
        node_tags = {id(n): t for n, t in zip(nodes, tags_seq)}
        aux = {id(n): a for n, a in zip(nodes, aux_seq) if a is not None}
        _merge_param_aux(plan, params_of, aux)
        return Bound(plan, params, fetches, slots, node_tags, aux, total,
                     node_tags[id(plan.root)], out_kind)

    node_tags: Dict[int, List[Tags]] = {}
    aux: Dict[int, dict] = {}

    def tags_of(node: PlanNode) -> List[Tags]:
        key = id(node)
        if key in node_tags:
            return node_tags[key]
        if isinstance(node, Fetch):
            out = fetches[node].tags
        elif isinstance(node, RangeFunc):
            base = tags_of(node.arg)
            if node.func == "absent_over_time":
                # One presence row labelled from the selector's equality
                # matchers (functions.go funcAbsentOverTime).
                out = [ex._absent_tags(node.arg.sel)]
            elif node.func == "last_over_time":
                out = list(base)
            else:
                out = [ex._strip_name(t) for t in base]
        elif isinstance(node, SubqueryFunc):
            base = tags_of(node.arg)
            if node.func == "last_over_time":
                out = list(base)
            else:
                out = [ex._strip_name(t) for t in base]
        elif isinstance(node, RankAgg):
            base = tags_of(node.arg)
            gids, gtags = ex._group_series(base, node.grouping,
                                           node.without)
            smax = (int(np.bincount(
                gids, minlength=max(len(gtags), 1)).max())
                if len(base) else 0)
            aux[id(node)] = {"group_ids": gids.astype(np.int32),
                             "n_groups": len(gtags), "smax": smax}
            # quantile collapses to group rows; topk/bottomk keep the
            # argument's rows (the data-dependent subset is filtered on
            # the host after materialization — root-only by lowering).
            out = gtags if node.op == "quantile" else list(base)
        elif isinstance(node, InstantFunc):
            base = tags_of(node.arg)
            if node.func == "neg":
                out = list(base)
            else:
                out = [ex._strip_name(t) for t in base]
        elif isinstance(node, Aggregate):
            base = tags_of(node.arg)
            gids, gtags = ex._group_series(base, node.grouping, node.without)
            aux[id(node)] = {"group_ids": gids.astype(np.int32),
                             "n_groups": len(gtags)}
            out = gtags
        elif isinstance(node, Binary):
            out = _bind_binary(node, tags_of, aux)
        elif isinstance(node, ScalarConst):
            out = []
        else:  # pragma: no cover
            raise ex.QueryError(f"unbound plan node {type(node).__name__}")
        node_tags[key] = out
        return out

    def _bind_binary(node: Binary, tags_of, aux) -> List[Tags]:
        le, re_ = node.lhs.edge, node.rhs.edge
        comparison = node.op in promql.COMPARISON_OPS
        if le.kind == SCALAR and re_.kind == SCALAR:
            tags_of(node.lhs), tags_of(node.rhs)
            return []
        if le.kind == SERIES and re_.kind == SERIES:
            ltags, rtags = tags_of(node.lhs), tags_of(node.rhs)
            matching = node.matching
            many_side_right = bool(matching and matching.group_right)
            if many_side_right:
                many_tags, one_tags, swap = rtags, ltags, True
            else:
                many_tags, one_tags, swap = ltags, rtags, False
            one_map: Dict[bytes, int] = {}
            for j, t in enumerate(one_tags):
                k = ex._match_key(t, matching)
                if k in one_map:
                    raise ex.QueryError(
                        "many-to-many vector matching: duplicate series on "
                        f"the 'one' side for key {k!r}")
                one_map[k] = j
            many_idx: List[int] = []
            one_idx: List[int] = []
            out_tags: List[Tags] = []
            seen: Dict[bytes, int] = {}
            # Duplicate result labels only raise for one-to-one matching
            # (the interpreter's _vector_vector rule): group_left/right
            # legitimately map many rows onto one match key.
            one_to_one = not (matching and (matching.group_left
                                            or matching.group_right))
            for i, t in enumerate(many_tags):
                j = one_map.get(ex._match_key(t, matching))
                if j is None:
                    continue
                rt = ex._result_tags(t, one_tags[j], matching, comparison,
                                     node.bool_mode)
                k = rt.id()
                if one_to_one and k in seen:
                    raise ex.QueryError(
                        "multiple matches for the same result labels")
                seen[k] = i
                many_idx.append(i)
                one_idx.append(j)
                out_tags.append(rt)
            aux[id(node)] = {
                "many_idx": np.asarray(many_idx, dtype=np.int32),
                "one_idx": np.asarray(one_idx, dtype=np.int32),
                "swap": swap,
            }
            return out_tags
        # vector <op> scalar (either side)
        vec = node.lhs if le.kind == SERIES else node.rhs
        tags_of(node.lhs), tags_of(node.rhs)
        base = node_tags[id(vec)]
        if comparison and not node.bool_mode:
            return list(base)
        return [ex._strip_name(t) for t in base]

    out_tags = tags_of(plan.root)
    nodes = _preorder(plan.root, [])
    # .get: InstantFunc's ScalarConst params are preorder nodes the tag
    # walk never visits (they carry no series) — store them as empty.
    tags_seq = tuple(node_tags.get(id(n), []) for n in nodes)
    aux_seq = tuple(aux.get(id(n)) for n in nodes)
    with _BIND_MEMO_LOCK:
        _BIND_MEMO[memo_key] = (src_lists, tags_seq, aux_seq,
                                plan.root.edge.kind)
        while len(_BIND_MEMO) > _BIND_MEMO_MAX:
            _BIND_MEMO.popitem(last=False)
    _merge_param_aux(plan, params_of, aux)
    return Bound(plan, params, fetches, slots, node_tags, aux, total,
                 out_tags, plan.root.edge.kind)


def _merge_param_aux(plan: Plan, params_of: Dict[int, object],
                     aux: Dict[int, dict]) -> None:
    """Params-DEPENDENT aux entries, recomputed on every bind (never
    memoized — the bind memo is keyed on plan structure + tag lists, and
    a sliding dashboard window changes these while hitting it): packed
    subquery column maps and timestamp() step-time vectors."""
    for n in _preorder(plan.root, []):
        if isinstance(n, SubqueryFunc) and n.packed:
            aux.setdefault(id(n), {})["cols"] = _packed_cols(
                n, params_of[id(n)])
        elif isinstance(n, InstantFunc) and n.func == "timestamp":
            p = params_of[id(n)]
            aux.setdefault(id(n), {})["times"] = (
                p.meta().times() / 1e9)


def lower_and_collect(ast: AstNode, params, lookback_ns: int
                      ) -> Tuple[Optional[Plan], Optional[NotCompilable],
                                 List[float]]:
    """AST -> physical plan (or (None, NotCompilable, []) when any node
    falls outside the compiled surface — the error carries the typed
    FallbackReason plus the AST node that raised) plus the scalar slot
    VALUES (in slot order) for binding."""
    lw = _Lowerer(params, lookback_ns)
    try:
        root = lw.lower(ast)
    except NotCompilable as e:
        return None, e, []
    fetches: List[Fetch] = []
    _walk_fetches(root, fetches)
    if not fetches:
        return None, NotCompilable(FallbackReason.SCALAR_ONLY,
                                   "scalar-only expression", ast), []
    values = []
    for node in lw.slots:
        if isinstance(node, NumberLiteral):
            values.append(float(node.value))
        elif isinstance(node, Unary) and isinstance(node.expr, NumberLiteral):
            values.append(-node.expr.value)
        else:  # unreachable: _slot only records constants
            return None, NotCompilable(FallbackReason.NON_CONSTANT_PARAM,
                                       "non-constant slot", node), []
    root = _demote_exact(root, is_root=True)
    fetches = []
    _walk_fetches(root, fetches)
    plan = Plan(root, params.steps, len(lw.slots), tuple(fetches),
                _mesh_ok(root))
    return plan, None, values


def _demote_exact(node: PlanNode, is_root: bool) -> PlanNode:
    """The exact counter-sum path finishes on the HOST (f64 baseline
    mass), so only the ROOT aggregate may carry it; inner aggregates
    collapse on device in f32 (documented divergence, same tolerance as
    the pre-existing sharded-agg fast path)."""
    if isinstance(node, Aggregate):
        arg = _demote_exact(node.arg, False)
        return Aggregate(node.op, arg, node.grouping, node.without,
                         node.exact and is_root)
    if isinstance(node, RangeFunc) or isinstance(node, Fetch) \
            or isinstance(node, ScalarConst):
        return node
    if isinstance(node, SubqueryFunc):
        return dataclasses.replace(node,
                                   arg=_demote_exact(node.arg, False))
    if isinstance(node, RankAgg):
        return dataclasses.replace(node,
                                   arg=_demote_exact(node.arg, False))
    if isinstance(node, InstantFunc):
        return InstantFunc(node.func, _demote_exact(node.arg, False),
                           node.params)
    if isinstance(node, Binary):
        return Binary(node.op, _demote_exact(node.lhs, False),
                      _demote_exact(node.rhs, False), node.bool_mode,
                      node.matching, node.swap)
    return node


# -------------------------------------------------------------- compile key


def strip(node: PlanNode, fetch_index: Dict[Fetch, int]) -> PlanNode:
    """The compile-key projection of a plan node: selectors (label
    matchers, offsets) do not change the traced program, so Fetch nodes
    keep only their physical geometry plus a positional identity (so two
    DIFFERENT selectors with the same geometry stay distinct inputs while
    one executable still serves every metric with the plan shape);
    grouping labels and matching labels are bind-only and drop out."""
    if isinstance(node, Fetch):
        idx = fetch_index[node]
        return Fetch(VectorSelector(b"%d" % idx), node.role, node.W,
                     node.stride, node.wgrid_ns)
    if isinstance(node, RangeFunc):
        return RangeFunc(node.func, strip(node.arg, fetch_index),
                         node.step_ns, node.range_ns, node.params)
    if isinstance(node, SubqueryFunc):
        # offset/inner length are bind-time data: the traced program
        # depends only on the window geometry (inner widths ride the
        # Geometry bucket, packed column maps are aux inputs).
        return SubqueryFunc(node.func, strip(node.arg, fetch_index),
                            node.W, node.stride, node.packed, node.res_ns,
                            node.range_ns, 0, 0, node.params)
    if isinstance(node, RankAgg):
        return RankAgg(node.op, strip(node.arg, fetch_index), node.param,
                       (), node.without)
    if isinstance(node, InstantFunc):
        return InstantFunc(node.func, strip(node.arg, fetch_index),
                           node.params)
    if isinstance(node, Aggregate):
        return Aggregate(node.op, strip(node.arg, fetch_index), (),
                         node.without, node.exact)
    if isinstance(node, Binary):
        return Binary(node.op, strip(node.lhs, fetch_index),
                      strip(node.rhs, fetch_index), node.bool_mode, None,
                      node.swap)
    return node


def next_bucket(n: int) -> int:
    """Quarter-octave shape bucket: the smallest of {1, 1.25, 1.5, 1.75}
    * 2^k >= n. Pure pow2 buckets waste up to 2x compute on the padded
    lanes (10000 rows -> 16384); the quarter-octave grid caps the waste
    at 14% for four executables per octave — the right trade for the
    plan cache, whose entries are whole fused programs serving many
    queries each."""
    if n <= 3:
        return max(1, n)
    p = 1 << (int(n - 1).bit_length())      # pow2 >= n
    half = p >> 1
    for frac in (5, 6, 7):                   # 1.25, 1.5, 1.75 * (p/2)
        cand = (half * frac) >> 2
        if cand >= n:
            return cand
    return p
