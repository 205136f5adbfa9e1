"""Whole-plan compilation: one program per PromQL physical plan, on one
device or over the "shard" axis of a device mesh (port of
m3_tpu/parallel/compile.py).

The interpreter (query/executor.py, retained as the oracle
`Engine.execute_range_ref`) dispatches each temporal op per block with
host round trips between operators and a host-side aggregation fan-in.
Here the plan IR (query/plan.py) lowers into ONE function of torch ops,
`body(fetch_flat, aux_flat, slots)`: operator chains run back to back on
the device, and the only device->host transfer is the final result.

On the card an executable is a CUDA graph. A plan-cache miss runs the
body once eagerly on a side stream (the warm-up, which also builds the
kernels' extension), then captures it with `torch.cuda.graph` into static
input and output tensors. A hit copies the staged inputs, the aux index
arrays and the scalar slots into the static inputs and replays the graph:
one launch from the host for the whole plan. The replay's outputs are
cloned out of the graph's pool at once, so a LazyBlock still unread when
the next query of the same shape replays keeps its own answer. On the CPU
the executable is the body itself, run eagerly with the plain versions of
the kernels. The cache, its counters and the fallback taxonomy are the
same on both devices.

The window kernel (K4, ops/window_kernels.py) runs inside the graph for
every *_over_time but quantile and absent: its wrapper counts a launch
where it runs, so the warm-up counts, the capture (which records but does
not launch) is taken back out, and each replay adds the launches the
graph holds. An executable keeps both counts (`k4_launches`, `replays`).

Executables are cached per (plan structure, quarter-octave shape bucket,
device) — `telemetry.plan_cache` counts hits/misses/build wall — with
row/time padding chosen so one executable serves every query with the
same plan shape: rows pad with NaN (masked everywhere), the time axis
pads past the real output and the host slices it back. Selector label
matchers are stripped from the key (one executable serves every metric
with the same plan shape); scalar literals ride as runtime slots (one
executable serves every threshold). A graph keeps its private memory pool
for as long as it lives, so each executable charges its pool (the growth
of `torch.cuda.memory_reserved()` across the capture) and its static
inputs to the shared `utils/hbm` budget under the tenant `plan`, whose
evict-one drops the least recently used executable and its graph; the
cache also holds at most PLAN_CACHE_MAX executables.

Counter-sum exactness (the interpreter's f64 host-reduce contract): an
aggregate sum/avg DIRECTLY over a raw selector decomposes each series as
baseline + residual (ops/temporal.center). The device accumulates only
the small f32 residuals, while the baseline mass — where plain f32
accumulation of 1e9-magnitude counters loses the f64 host-reduce
semantics — is accounted on the host in exact f64 (group baseline totals
minus per-missing-cell corrections).

Float segment sums are a pairwise tree over the group-sorted rows, not
`index_add_`: the card's atomic adds would make a sum's last bits depend
on the order the atomics land, so a replay could differ from the eager
body and one query from its repeat. Counts (exact small integers) and
min/max keep the scatter forms.

The lowering rules (`_lower_*`) run inside the capture: they must never
sync a device value to the host (`.item()`, `int(t)`, `nonzero`, boolean
mask indexing, `torch.unique`, `.cpu()`, one-argument `torch.where`) —
on the card the capture refuses it. The host preps (`center`,
`rate_inputs`, the pads) stay in `_stage_fetch`, outside the program.

Over a mesh (`execute(bound, device, mesh)` with a plan whose every node
can shard, `plan.mesh_ok`): every selector's rows split over the mesh's
"shard" axis (rows pad to shard count x a per-slice bucket), and the body
runs each SHARDED edge once per slice — such an edge carries a list of
per-slice tensors, each on its slice's device — while a REPLICATED edge
carries one tensor on the mesh's first device. A fan-in node (an
aggregate over a sharded child, absent_over_time) reduces its per-slice
partials with the mesh's collectives (parallel/mesh: moved to the first
device and combined in slice order, so a replay equals its eager body) —
psum for sums and counts, the stddev/stdvar mean before its
squared-deviation stage, pmin/pmax for the extremes — and replicates the
result. A sharded series root's slices concatenate in row order. When
every entry is one card (`attach([cuda:0] * k)`) the whole k-slice body
is one CUDA graph, as on one device; over distinct cards the executable
runs eagerly (`mesh_route()` names which).

The whole program dispatches through `parallel/guard.dispatch` under the
route `plan`, keyed by its shape bucket: a device fault raises a typed
ComputeError and quarantines the bucket, which then raises at once until
`guard.QUARANTINE_TTL_S` (the reference falls back to the interpreter
instead). A plan that cannot be built (`PlanFallback`) still takes the
interpreter: a routing choice, not a fault.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import guard
from . import mesh as pmesh
from . import telemetry
from ..ops import series_agg, temporal, window_kernels
from ..query import explain as qexplain
from ..query import plan as qplan
from ..query import promql
from ..query.plan import (
    Aggregate, Binary, Fetch, InstantFunc, Plan, PlanNode, RangeFunc,
    RankAgg, ScalarConst, SubqueryFunc, SERIES, SCALAR, _preorder,
)
from ..utils import numwatch
from ..utils.hbm import tensor_nbytes

F32 = torch.float32
_NAN = float("nan")

# The plan cache's bound: the reference's default (M3_TPU_PLAN_CACHE),
# fixed here (the port reads no environment knob).
PLAN_CACHE_MAX = 128


class PlanFallback(Exception):
    """The bound plan can't execute compiled (shape pathology, missing
    backend feature); the executor falls back to the interpreter.
    Carries a typed `FallbackReason` (default BACKEND_GAP) so the
    telemetry/EXPLAIN taxonomy covers build-time bail-outs too."""

    def __init__(self, detail: str = "",
                 reason: "qplan.FallbackReason" = None):
        self.reason = reason or qplan.FallbackReason.BACKEND_GAP
        self.detail = detail
        super().__init__(f"{self.reason.value}: {detail}" if detail
                         else self.reason.value)


# --------------------------------------------------------------- geometry


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static shape signature of one executable: quarter-octave row/time
    buckets per fetch, group buckets per aggregate, row buckets per
    vector-vector binary, inner-grid widths per subquery, and
    (group, group-size) buckets per rank aggregation — each entry
    aligned to its node kind's plan-preorder occurrence order."""

    t_pad: int                       # padded output steps
    s_pads: Tuple[int, ...]          # per plan.fetches entry
    f_exts: Tuple[int, ...]          # staged grid width per fetches entry
    g_pads: Tuple[int, ...]          # per Aggregate node, preorder
    r_pads: Tuple[int, ...]          # per vv Binary node, preorder
    sub_pads: Tuple[int, ...]        # per SubqueryFunc node, preorder
    rank_pads: Tuple[Tuple[int, int], ...]  # per RankAgg: (g_pad, smax_pad)
    n_shard: int = 1                 # 1 = single-device


# The aux-array ordering contract between bind(), _aux_layout(),
# geometry_for() and execute() hangs on ONE preorder walk: plan.py's.
def _is_vv(node: PlanNode) -> bool:
    return (isinstance(node, Binary) and node.lhs.edge.kind == SERIES
            and node.rhs.edge.kind == SERIES)


def _row_bucket(s: int, n_shard: int) -> int:
    """Rows padded to n_shard * bucket(rows per slice): the shard axis
    divides evenly and one executable serves a bucket of sizes."""
    per_dev = max(1, -(-s // n_shard))
    return n_shard * qplan.next_bucket(per_dev)


def _widths(root: PlanNode, t_pad: int,
            sub_pads: Optional[Tuple[int, ...]] = None
            ) -> Tuple[Dict[int, int], Tuple[int, ...]]:
    """Per-node padded TIME width: t_pad outside subqueries; inside a
    SubqueryFunc, the inner resolution grid's padded width — long enough
    that contiguous strided windows cover every padded output step
    (shared mode), or the bucketed inner-grid length (packed mode, where
    the bind-time column map does the indexing). With `sub_pads` given
    (at build time, on the stripped plan whose inner_steps is zeroed) the
    recorded Geometry widths are consumed instead of recomputed."""
    width_of: Dict[int, int] = {}
    pads_out: List[int] = []
    it = iter(sub_pads) if sub_pads is not None else None

    def walk(n: PlanNode, w: int):
        width_of[id(n)] = w
        if isinstance(n, SubqueryFunc):
            if it is not None:
                w_in = next(it)
            elif n.packed:
                w_in = qplan.next_bucket(max(n.inner_steps, 1))
            else:
                w_in = (w - 1) * n.stride + n.W
            pads_out.append(w_in)
            walk(n.arg, w_in)
            return
        for fld in dataclasses.fields(n):
            v = getattr(n, fld.name)
            if isinstance(v, PlanNode):
                walk(v, w)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, PlanNode):
                        walk(item, w)

    walk(root, t_pad)
    return width_of, tuple(pads_out)


def _fetch_exts(root: PlanNode, width_of: Dict[int, int],
                fetches: Tuple[Fetch, ...]) -> Tuple[int, ...]:
    """Staged grid width per fetches entry: the max extended-grid length
    any occurrence of that (equality-keyed) fetch needs in its time
    context — consumers slice down to their own need."""
    need: Dict[Fetch, int] = {}
    for n in _preorder(root, []):
        if isinstance(n, Fetch):
            ext = _ext_len(n, width_of[id(n)])
            need[n] = max(need.get(n, 0), ext)
    return tuple(need[f] for f in fetches)


def geometry_for(bound: "qplan.Bound", n_shard: int = 1) -> Geometry:
    plan = bound.plan
    t_pad = qplan.next_bucket(plan.steps)
    # One executable serves a quarter-octave bucket of row counts.
    s_pads = tuple(_row_bucket(bound.fetches[f].grid.shape[0], n_shard)
                   for f in plan.fetches)
    width_of, sub_pads = _widths(plan.root, t_pad)
    f_exts = _fetch_exts(plan.root, width_of, plan.fetches)
    nodes: List[PlanNode] = []
    _preorder(plan.root, nodes)
    g_pads = tuple(qplan.next_bucket(max(1, bound.aux[id(n)]["n_groups"]))
                   for n in nodes if isinstance(n, Aggregate))
    r_pads = tuple(qplan.next_bucket(max(1, len(bound.aux[id(n)]["many_idx"])))
                   for n in nodes if _is_vv(n))
    rank_pads = tuple(
        (qplan.next_bucket(max(1, bound.aux[id(n)]["n_groups"])),
         qplan.next_bucket(max(1, bound.aux[id(n)]["smax"])))
        for n in nodes if isinstance(n, RankAgg))
    return Geometry(t_pad, s_pads, f_exts, g_pads, r_pads, sub_pads,
                    rank_pads, n_shard)


# ---------------------------------------------------------- input staging

# Which prepared arrays a fetch contributes, per consumer need, and how
# many arrays each kind flattens to.
#   ratec: (adj, finite, grid32)   rate/increase (ops/temporal.rate_inputs)
#   rated: (adj, finite)           delta
#   resid: (resid, base32)         *_over_time / regression / exact sums
#   value: (value32,)              elementwise / binary / min-max-count
#   value2: (hi, lo)               exact double-f32 split (topk ranking)
_KIND_ARITY = {"ratec": 3, "rated": 2, "resid": 2, "value": 1, "value2": 2}
_RATE_COUNTER = frozenset({"rate", "increase"})


def _consumer_kinds(consumer: Optional[PlanNode]) -> Tuple[str, ...]:
    """Which staged-input kinds one consumer reads off a direct Fetch."""
    if isinstance(consumer, (RangeFunc, SubqueryFunc)):
        f = consumer.func
        if f in ("rate", "increase", "delta"):
            return ("ratec",) if f in _RATE_COUNTER else ("rated",)
        if f in ("irate", "idelta"):
            # residual-space diffs + the absolute plane for the counter
            # reset branch (temporal.instant_math)
            return ("resid", "value")
        return ("resid",)
    if isinstance(consumer, Aggregate) and consumer.exact:
        return ("resid",)
    if isinstance(consumer, RankAgg) and consumer.op != "quantile":
        # topk/bottomk MEMBERSHIP is discrete: rank on the exact
        # double-f32 split so sub-ulp counter differences don't scramble
        # the surviving series set (series_agg.packed_topk_keep_math).
        return ("value2",)
    return ("value",)


def fetch_kinds(root: PlanNode) -> Dict[Fetch, Tuple[str, ...]]:
    """Deterministic (sorted) set of staged-input kinds per fetch,
    keyed by Fetch equality (equal selectors share staged inputs)."""
    kinds: Dict[Fetch, set] = {}

    def walk(node: PlanNode, consumer: Optional[PlanNode]):
        if isinstance(node, Fetch):
            kinds.setdefault(node, set()).update(_consumer_kinds(consumer))
            return
        for fld in dataclasses.fields(node):
            v = getattr(node, fld.name)
            if isinstance(v, PlanNode):
                walk(v, node)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, PlanNode):
                        walk(item, node)

    walk(root, None)
    return {f: tuple(sorted(ks)) for f, ks in kinds.items()}


def _ext_len(f: Fetch, width: int) -> int:
    """Padded extended-grid length for a fetch in a `width`-wide time
    context: long enough that the strided window output covers every
    padded column. Every output step j < real steps reads window cells
    [j*stride, j*stride + W) — real cells only, so end-padding is
    exact."""
    if f.role == "instant":
        return width
    return (width - 1) * f.stride + f.W


def _pad_grid(grid: np.ndarray, s_pad: int, ext_pad: int) -> np.ndarray:
    S, T = grid.shape
    if S == s_pad and T == ext_pad:
        return grid
    out = np.full((s_pad, ext_pad), np.nan, dtype=grid.dtype)
    out[:S, :T] = grid
    return out


def stage_value_plane(grid: np.ndarray, s_pad: int, ext_pad: int
                      ) -> np.ndarray:
    """Padded f32 staging for a `value`-kind fetch plane in ONE pass:
    the padded plane allocated at f32 and the grid downcast-copied into
    it (NaN padding survives, and copyto's unsafe cast is exactly
    astype's round-to-nearest)."""
    S, T = grid.shape
    out = np.full((s_pad, ext_pad), np.nan, np.float32)
    np.copyto(out[:S, :T], grid, casting="unsafe")
    return out


def _stage_fetch(bf: "qplan.BoundFetch", kinds: Tuple[str, ...],
                 s_pad: int, ext_pad: int, dev: torch.device,
                 mesh: Optional[pmesh.Mesh] = None):
    """Prepared, padded input tensors for one fetch on `dev`, behind
    ops/temporal's derived-input cache, so a repeat query (the grid cache
    returning the same consolidated grid object) reuses the staged device
    tensors without a host prep or an upload. Over a mesh every array's
    rows split over the "shard" axis: the tuple then holds each array's
    slices in slice order, each on its slice's device."""
    kind_tag = f"plan:{','.join(kinds)}:{s_pad}x{ext_pad}"
    if mesh is not None:
        kind_tag += f":{mesh.shape['shard']}@{hash(mesh)}"

    def build(g):
        # The padded f64 intermediate is only needed by the non-"value"
        # kinds; a plain value fetch stages through the one-pass f32 path.
        gp = (_pad_grid(g, s_pad, ext_pad)
              if any(kind != "value" for kind in kinds) else None)
        arrs: List[np.ndarray] = []
        for kind in kinds:
            if kind in ("ratec", "rated"):
                adj, finite, grid32 = temporal.rate_inputs(
                    gp, kind == "ratec")
                arrs += [adj, finite]
                if kind == "ratec":
                    arrs.append(grid32)
            elif kind == "resid":
                resid, base = temporal.center(gp)
                # base32 feeds only the device plane (predict_linear /
                # holt_winters / *_over_time add it back); the exact f64
                # baseline mass of a counter sum is re-derived on the host
                # by _exact_base_contrib from the same grid, so nothing
                # the f32 copy drops ever reaches a counter sum.
                arrs += [resid, base.astype(np.float32)]  # m3lint: disable=f64-downcast-on-exact-path
            elif kind == "value2":
                # Exact double-f32 split of the f64 grid: hi + lo
                # round-trips the value to ~2e-4 absolute, and the lo
                # plane is what makes compiled topk ranking faithful to
                # the interpreter's f64 sort at counter magnitudes.
                hi = gp.astype(np.float32)
                lo = (gp - hi.astype(np.float64)).astype(np.float32)
                arrs += [hi, lo]
            else:  # "value"
                arrs.append(stage_value_plane(g, s_pad, ext_pad))
        if mesh is not None:
            # The derived cache charges the slices, as it does one
            # device's tensors.
            placed = tuple(part for a in arrs for part in pmesh.split_rows(
                torch.from_numpy(np.ascontiguousarray(a)), mesh, "shard",
                charge=False))
        else:
            placed = tuple(temporal._put(a, dev) for a in arrs)
        return placed, sum(tensor_nbytes(t) for t in placed)

    return temporal._derived(bf.grid, kind_tag, build, dev)


# --------------------------------------------------------- lowering rules
#
# Each _lower_* rule emits the torch ops of one plan node. On the card
# they run inside a CUDA-graph capture: touching the host (.item(),
# .cpu(), nonzero, boolean-mask indexing) would break it.

def _sgn(v):
    # torch.sign maps NaN to 0 and -0.0 to +0.0; jnp.sign keeps both.
    return torch.where((v == 0) | torch.isnan(v), v, torch.sign(v))


_MATH = {
    "abs": torch.abs, "ceil": torch.ceil, "floor": torch.floor,
    "exp": torch.exp, "sqrt": torch.sqrt, "ln": torch.log,
    "log2": torch.log2, "log10": torch.log10, "sgn": _sgn,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "deg": torch.rad2deg, "rad": torch.deg2rad,
    "neg": lambda v: -v,
}

_BIN = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "==": lambda a, b: (a == b).to(F32),
    "!=": lambda a, b: (a != b).to(F32),
    "<": lambda a, b: (a < b).to(F32),
    ">": lambda a, b: (a > b).to(F32),
    "<=": lambda a, b: (a <= b).to(F32),
    ">=": lambda a, b: (a >= b).to(F32),
}


class _Ctx:
    """Emission context: staged inputs per fetch, bind-time index tensors
    per node path, scalar slots, per-node time widths. Over a mesh the
    top context holds one context per slice (`slices`, each with its own
    inputs on its device) and emits SHARDED edges through them."""

    def __init__(self, plan: Plan, geom: Geometry, fetch_ins, aux_ins,
                 slots, slices: Optional[List["_Ctx"]] = None):
        self.plan = plan
        self.slices = slices
        self.geom = geom
        self.fetch_ins = fetch_ins          # {Fetch: {kind: (tensors...)}}
        self.aux_ins = aux_ins              # {path: (tensors...)}
        self.slots = slots
        self.cache: Dict[int, object] = {}
        nodes: List[PlanNode] = []
        _preorder(plan.root, nodes)
        self.path_of = {id(n): i for i, n in enumerate(nodes)}
        self.g_pad_of = dict(zip(
            (id(n) for n in nodes if isinstance(n, Aggregate)),
            geom.g_pads))
        self.rank_pads_of = dict(zip(
            (id(n) for n in nodes if isinstance(n, RankAgg)),
            geom.rank_pads))
        self.width_of, _ = _widths(plan.root, geom.t_pad, geom.sub_pads)
        self.root_agg: Optional[tuple] = None   # (s, cnt) for sum/avg root


def _lower_fetch(ctx: _Ctx, node: Fetch):
    """A bare selector consumed as values: the absolute f32 plane,
    sliced to this occurrence's padded grid width."""
    (value,) = ctx.fetch_ins[node]["value"]
    return value[:, :ctx.width_of[id(node)]]


def _range_body(ctx: _Ctx, f: str, ins: Dict[str, tuple], *, W: int,
                stride: int, step_s: float, range_s: float,
                params: Tuple[float, ...]):
    """The shared windowed-kernel ladder: one range function over
    prepared inputs (`ins` maps kind -> tensors already sliced/gathered
    to the window layout). Serves both RangeFunc (host-staged selector
    inputs) and SubqueryFunc (inner-plane inputs, possibly packed)."""
    if f in ("rate", "increase", "delta"):
        adj, finite = ins["diff"][0], ins["diff"][1]
        grid32 = ins["diff"][2] if f in _RATE_COUNTER else None
        return temporal.rate_math(
            adj, finite, grid32, W=W, step_s=step_s, range_s=range_s,
            is_counter=f in _RATE_COUNTER, is_rate=f == "rate",
            stride=stride)
    if f in ("irate", "idelta"):
        resid, grid32 = ins["instant"]
        return temporal.instant_math(
            resid, grid32, W=W, step_s=step_s, is_rate=f == "irate",
            stride=stride)
    resid, base32 = ins["resid"]
    if f == "quantile_over_time":
        return temporal.quantile_ot_math(resid, base32, W=W,
                                         q=float(params[0]), stride=stride)
    if f.endswith("_over_time"):
        # The window kernel (K4) on the card.
        return temporal.over_time_math(
            resid, base32, W=W, kind=f[:-len("_over_time")], stride=stride)
    if f in ("changes", "resets"):
        return temporal.changes_resets_math(
            resid, W=W, count_resets=f == "resets", stride=stride)
    if f == "deriv":
        return temporal.regression_math(
            resid, W=W, step_s=step_s, predict_offset_s=0.0,
            is_deriv=True, stride=stride)
    if f == "predict_linear":
        return temporal.regression_math(
            resid, W=W, step_s=step_s, predict_offset_s=float(params[0]),
            is_deriv=False, stride=stride) + base32[:, None]
    # holt_winters (lowering admits nothing else)
    return temporal.holt_winters_math(
        resid, W=W, sf=float(params[0]), tf=float(params[1]),
        stride=stride) + base32[:, None]


def _lower_rangefunc(ctx: _Ctx, node: RangeFunc):
    f = node.func
    fetch = node.arg
    W, stride = fetch.W, fetch.stride
    w_out = ctx.width_of[id(node)]
    ext = (w_out - 1) * stride + W
    if f == "absent_over_time":
        # Window presence counts, then ONE cross-row (and cross-slice)
        # reduce: 1 where NO series has a sample in the window.
        def present(c):
            resid, _base32 = c.fetch_ins[fetch]["resid"]
            cnt = temporal._wsum(torch.isfinite(resid[:, :ext]), W, stride)
            return cnt.sum(0, keepdim=True)

        if ctx.slices is None:
            total = present(ctx)
        else:
            total = pmesh.reduce_list([present(c) for c in ctx.slices],
                                      "sum")
        return torch.where(total > 0, _NAN, 1.0)

    staged = ctx.fetch_ins[fetch]
    ins: Dict[str, tuple] = {}
    if f in ("rate", "increase", "delta"):
        kind = "ratec" if f in _RATE_COUNTER else "rated"
        ins["diff"] = tuple(a[:, :ext] for a in staged[kind])
    elif f in ("irate", "idelta"):
        resid, _base32 = staged["resid"]
        (value,) = staged["value"]
        ins["instant"] = (resid[:, :ext], value[:, :ext])
    else:
        resid, base32 = staged["resid"]
        ins["resid"] = (resid[:, :ext], base32)
    out = _range_body(ctx, f, ins, W=W, stride=stride,
                      step_s=node.step_ns / 1e9,
                      range_s=node.range_ns / 1e9, params=node.params)
    return out[:, :w_out]


def _sub_gather(arr, cols, fill):
    """Packed-window gather: [S, T_in] columns by the bind-time index
    map; lanes with col -1 (outside the window) take `fill`."""
    valid = (cols >= 0)[None, :]
    return torch.where(valid, arr[:, cols.clamp(min=0)], fill)


def _lower_subqueryfunc(ctx: _Ctx, node: SubqueryFunc):
    """f(expr[r:s]): window the inner plane. Direct selector inners read
    their host-staged exact-f64 preps (the same kinds RangeFunc uses, on
    the inner resolution grid); composite inners prep on the device at
    the plane's f32 (temporal.center_math / rate_inputs_math — the
    lowering only admits difference-space planes there). Packed mode
    first gathers each output step's drifting window through the
    bind-time column map; shared mode reads contiguous strided windows."""
    f = node.func
    w_out = ctx.width_of[id(node)]
    inner_w = ctx.width_of[id(node.arg)]
    direct = isinstance(node.arg, Fetch)
    if node.packed:
        (cols,) = ctx.aux_ins[ctx.path_of[id(node)]]
        W = stride = node.W
    else:
        cols = None
        W, stride = node.W, node.stride

    def windowed(a, fill):
        a = a[:, :inner_w]
        return a if cols is None else _sub_gather(a, cols, fill)

    ins: Dict[str, tuple] = {}
    if f in ("rate", "increase", "delta"):
        counter = f in _RATE_COUNTER
        if direct:
            kind = "ratec" if counter else "rated"
            arrs = ctx.fetch_ins[node.arg][kind]
            adj, finite = arrs[0], arrs[1]
            grid32 = arrs[2] if counter else None
        else:
            plane = _emit(ctx, node.arg)
            adj, finite, z = temporal.rate_inputs_math(plane, counter)
            grid32 = z if counter else None
        ins["diff"] = (windowed(adj, 0.0), windowed(finite, False)) + (
            (windowed(grid32, 0.0),) if counter else ())
    elif f in ("irate", "idelta"):
        if direct:
            resid, _b = ctx.fetch_ins[node.arg]["resid"]
            (value,) = ctx.fetch_ins[node.arg]["value"]
        else:
            plane = _emit(ctx, node.arg)
            resid, _base = temporal.center_math(plane)
            value = plane
        ins["instant"] = (windowed(resid, _NAN), windowed(value, _NAN))
    else:
        if direct:
            resid, base32 = ctx.fetch_ins[node.arg]["resid"]
        else:
            plane = _emit(ctx, node.arg)
            resid, base32 = temporal.center_math(plane)
        ins["resid"] = (windowed(resid, _NAN), base32)
    out = _range_body(ctx, f, ins, W=W, stride=stride,
                      step_s=node.res_ns / 1e9,
                      range_s=node.range_ns / 1e9, params=node.params)
    return out[:, :w_out]


def _lower_rankagg(ctx: _Ctx, node: RankAgg):
    """topk/bottomk/quantile: gather rows into the bind-time group
    packing, sort-select along the packed axis (ops/series_agg), k / q
    riding as a runtime slot. topk/bottomk return the argument plane
    masked to the per-step winners (the data-dependent surviving row SET
    is filtered on the host at the root finish)."""
    perm, inv = ctx.aux_ins[ctx.path_of[id(node)]]
    g_pad, smax_pad = ctx.rank_pads_of[id(node)]
    kq = ctx.slots[node.param.slot]
    if node.op == "quantile":
        v = _emit(ctx, node.arg)
        packed = series_agg.packed_gather_math(v, perm, g_pad, smax_pad)
        return series_agg.packed_quantile_math(packed, kq)
    if isinstance(node.arg, Fetch):
        # Raw selector plane: the host-staged exact double-f32 split —
        # sub-ulp counter differences must still rank like f64.
        hi, lo = ctx.fetch_ins[node.arg]["value2"]
        w = ctx.width_of[id(node.arg)]
        v, vlo = hi[:, :w], lo[:, :w]
    else:
        v = _emit(ctx, node.arg)
        vlo = torch.zeros_like(v)
    packed_hi = series_agg.packed_gather_math(v, perm, g_pad, smax_pad)
    packed_lo = series_agg.packed_gather_math(vlo, perm, g_pad, smax_pad)
    # int(k) truncation parity with the interpreter's _const_param.
    keep = series_agg.packed_topk_keep_math(packed_hi, packed_lo,
                                            torch.floor(kq),
                                            node.op == "topk")
    flat = keep.reshape(g_pad * smax_pad, keep.shape[-1])
    valid_row = (inv >= 0)[:, None]
    keep_rows = valid_row & flat[inv.clamp(min=0)]
    return torch.where(keep_rows, v, _NAN)


def _lower_instantfunc(ctx: _Ctx, node: InstantFunc):
    v = _emit(ctx, node.arg)
    if node.func == "timestamp":
        # Step times ride as a bind-time aux vector (f32, as in the
        # reference: unix seconds round to ~128s granularity on the f32
        # value plane, far inside the oracle tolerance at 1.7e9).
        (times,) = ctx.aux_ins[ctx.path_of[id(node)]]
        return torch.where(torch.isfinite(v), times[None, :], _NAN)
    fn = _MATH.get(node.func)
    if fn is not None:
        return fn(v)
    params = [ctx.slots[p.slot] for p in node.params]
    if node.func == "round":
        # Branches on the STATIC slot arity (plan structure).
        if not params:
            return torch.round(v)
        return torch.round(v / params[0]) * params[0]
    if node.func == "clamp":
        return torch.minimum(torch.maximum(v, params[0]), params[1])
    if node.func == "clamp_min":
        return torch.maximum(v, params[0])
    if node.func == "clamp_max":
        return torch.minimum(v, params[0])
    raise PlanFallback(f"instant func {node.func}")  # pragma: no cover


def _segment_sum_sorted(z, layout, levels: int):
    """Deterministic float segment sum: the rows gathered group by group
    (bind-time order, `-1` for padding rows), then a pairwise tree within
    each group — at level k, a row at an even multiple of 2^k from its
    group's start adds the row 2^k after it when that row is in the same
    group — and each group's start row read out. [G_pad, T]."""
    order, rel, seglen, starts = layout
    x = torch.where((order >= 0)[:, None], z[order.clamp(min=0)], 0.0)
    rows = x.shape[0]
    for k in range(levels):
        h = 1 << k
        if h >= rows:
            break
        take = ((rel % (2 * h)) == 0) & (rel + h < seglen)
        later = torch.cat([x[h:], x.new_zeros((h, x.shape[1]))])
        x = torch.where(take[:, None], x + later, x)
    return torch.where((starts >= 0)[:, None], x[starts.clamp(min=0)], 0.0)


class _AggPart:
    """One slice's (or, on one device, the whole) input of an aggregate:
    its values, their presence mask, the group ids and the group-sorted
    layout of the deterministic sum."""

    def __init__(self, ctx: _Ctx, node: Aggregate, v):
        self.gids, *self.layout = ctx.aux_ins[ctx.path_of[id(node)]]
        self.v = v
        self.mask = torch.isfinite(v)
        self.levels = max(0, (v.shape[0] - 1).bit_length())

    def ssum(self, x):
        return _segment_sum_sorted(x, self.layout, self.levels)


def _lower_aggregate(ctx: _Ctx, node: Aggregate):
    """Cross-series reduce with collective fan-in: over a mesh with a
    sharded child, every slice reduces its own rows and the partials
    combine in slice order (psum / pmin / pmax). Returns the collapsed
    f32 [G_pad, t_pad] plane; a sum/avg ROOT additionally records its
    (residual-sum, count) components so the host can finish in exact
    f64."""
    g_pad = ctx.g_pad_of[id(node)]
    fan_in = ctx.slices is not None and node.arg.edge.sharding == qplan.SHARDED
    cs = ctx.slices if fan_in else [ctx]
    if node.exact:
        vs = [c.fetch_ins[node.arg]["resid"][0][:, :ctx.width_of[id(node)]]
              for c in cs]
    else:
        vs = _emit(ctx, node.arg)
        vs = vs if fan_in else [vs]
    parts = [_AggPart(c, node, v) for c, v in zip(cs, vs)]

    def fold(xs, how="sum"):
        return xs[0] if len(xs) == 1 else pmesh.reduce_list(xs, how)

    cnt = fold([series_agg._segment_sum(p.mask.to(F32), p.gids, g_pad)
                for p in parts])
    op = node.op
    if op in ("stddev", "stdvar"):
        # Population moments (promql stddev/stdvar): mean first, then the
        # squared-deviation reduce, each stage fanning in before the next
        # reads it.
        s = fold([p.ssum(torch.where(p.mask, p.v, 0.0)) for p in parts])
        mu = s / cnt.clamp(min=1)

        def sq_dev(p):
            # a slice's group means moved to its own device inside the plan
            # body; freed when the body returns
            d = torch.where(p.mask, p.v - mu.to(p.v.device)[p.gids], 0.0)  # m3lint: disable=unbudgeted-device-put
            return p.ssum(d * d)

        var = fold([sq_dev(p) for p in parts]) / cnt.clamp(min=1)
        out = torch.sqrt(var) if op == "stddev" else var
        return torch.where(cnt > 0, out, _NAN)
    if op in ("sum", "avg"):
        s = fold([p.ssum(torch.where(p.mask, p.v, 0.0)) for p in parts])
        if node is ctx.plan.root:
            ctx.root_agg = (s, cnt)
        out = s / cnt.clamp(min=1) if op == "avg" else s
        return torch.where(cnt > 0, out, _NAN)
    if op == "count":
        return torch.where(cnt > 0, cnt, _NAN)
    if op == "group":
        return torch.where(cnt > 0, 1.0, _NAN)
    # min / max (lowering admits nothing else), XLA's signed-zero order.
    fill = float("inf") if op == "min" else float("-inf")
    m = fold([series_agg._segment_extreme(torch.where(p.mask, p.v, fill),
                                          p.gids, g_pad, largest=op == "max")
              for p in parts], op)
    return torch.where(cnt > 0, m, _NAN)


def _lower_binary(ctx: _Ctx, node: Binary):
    le, re_ = node.lhs.edge, node.rhs.edge
    comparison = node.op in promql.COMPARISON_OPS
    fn = _BIN[node.op]
    if le.kind == SCALAR and re_.kind == SCALAR:
        lv = _emit(ctx, node.lhs)
        rv = _emit(ctx, node.rhs)
        out = fn(lv, rv)
        if comparison and not node.bool_mode:
            return torch.where(out > 0, lv, _NAN)
        return out
    if le.kind == SERIES and re_.kind == SERIES:
        many_idx, one_idx = ctx.aux_ins[ctx.path_of[id(node)]]
        lhs_v = _emit(ctx, node.lhs)
        rhs_v = _emit(ctx, node.rhs)
        many_v = rhs_v if node.swap else lhs_v
        one_v = lhs_v if node.swap else rhs_v
        # Index rows past the real match count pad with -1: a 0-padded
        # gather would replay row 0's FINITE values into the padding lanes,
        # and a downstream aggregate would fold that garbage into group 0.
        valid = (many_idx >= 0)[:, None]
        a = many_v[many_idx.clamp(min=0)]
        b = one_v[one_idx.clamp(min=0)]
        out = fn(b, a) if node.swap else fn(a, b)
        if comparison and not node.bool_mode:
            return torch.where(valid & (out > 0), a, _NAN)
        both = torch.isfinite(a) & torch.isfinite(b)
        return torch.where(valid & both, out, _NAN)
    # vector <op> scalar (either side)
    vec_left = le.kind == SERIES
    vec = _emit(ctx, node.lhs if vec_left else node.rhs)
    sc = _emit(ctx, node.rhs if vec_left else node.lhs)
    out = fn(vec, sc) if vec_left else fn(sc, vec)
    if comparison:
        if node.bool_mode:
            return torch.where(torch.isfinite(vec), out, _NAN)
        return torch.where(out > 0, vec, _NAN)
    return out


def _emit(ctx: _Ctx, node: PlanNode):
    key = id(node)
    # The memo is keyed on PLAN NODE identity (static DAG structure).
    if key in ctx.cache:
        return ctx.cache[key]
    if ctx.slices is not None and node.edge.kind == SERIES and \
            node.edge.sharding == qplan.SHARDED:
        # A sharded edge: one value per slice, each emitted in its slice.
        val = [_emit(c, node) for c in ctx.slices]
    elif isinstance(node, Fetch):
        val = _lower_fetch(ctx, node)
    elif isinstance(node, RangeFunc):
        val = _lower_rangefunc(ctx, node)
    elif isinstance(node, SubqueryFunc):
        val = _lower_subqueryfunc(ctx, node)
    elif isinstance(node, RankAgg):
        val = _lower_rankagg(ctx, node)
    elif isinstance(node, InstantFunc):
        val = _lower_instantfunc(ctx, node)
    elif isinstance(node, Aggregate):
        val = _lower_aggregate(ctx, node)
    elif isinstance(node, Binary):
        val = _lower_binary(ctx, node)
    elif isinstance(node, ScalarConst):
        val = ctx.slots[node.slot]
    else:  # pragma: no cover
        raise PlanFallback(type(node).__name__)
    ctx.cache[key] = val
    return val


# -------------------------------------------------------------- compiler


def _split_agg(n: PlanNode, n_shard: int) -> bool:
    """An aggregate whose aux arrays are per slice: over a mesh, with a
    sharded child (its rows split over the slices)."""
    return (n_shard > 1 and isinstance(n, Aggregate)
            and n.arg.edge.sharding == qplan.SHARDED)


def _aux_layout(root: PlanNode,
                n_shard: int = 1) -> List[Tuple[int, int, bool]]:
    """(preorder path, arity, per-slice) per aux-consuming node:
    aggregates take a group-id array plus the group-sorted layout of the
    deterministic sum (row order, rank in group, group size, group
    start), one set per slice when their child is sharded over a mesh;
    vector-vector binaries two index arrays; rank aggregations a perm +
    inverse-perm pair; packed subqueries one column map; timestamp() one
    step-time vector (replicated to every slice). The stager and the
    body's unflattener both follow this order."""
    nodes: List[PlanNode] = []
    _preorder(root, nodes)
    out = []
    for i, n in enumerate(nodes):
        if isinstance(n, Aggregate):
            out.append((i, 5, _split_agg(n, n_shard)))
        elif _is_vv(n):
            out.append((i, 2, False))
        elif isinstance(n, RankAgg):
            out.append((i, 2, False))
        elif isinstance(n, SubqueryFunc) and n.packed:
            out.append((i, 1, False))
        elif isinstance(n, InstantFunc) and n.func == "timestamp":
            out.append((i, 1, False))
    return out


def _build_body(stripped: PlanNode, geom: Geometry, kinds_sig: tuple,
                devices: Optional[List[torch.device]] = None):
    """The torch-op function of ONE plan structure: keyed on the
    matcher-stripped plan and the geometry bucket, it serves every query
    (any metric, any threshold, any series count within the bucket) with
    this plan shape. `devices`: the slices' devices over a mesh (each
    staged array then comes as that many slices), None on one device."""
    fetches = tuple(f for f, _ in kinds_sig)
    kinds_by_fetch = dict(kinds_sig)
    plan = Plan(stripped, 0, 0, fetches, devices is not None)
    k = 1 if devices is None else len(devices)
    layout = _aux_layout(stripped, k)
    root_is_sum = (isinstance(stripped, Aggregate)
                   and stripped.op in ("sum", "avg"))

    def body(fetch_flat, aux_flat, slots):
        # fetch_flat: per fetch, per kind, per array, its k slices.
        fetch_ins = [{} for _ in range(k)]
        i = 0
        for f in fetches:
            per = [{} for _ in range(k)]
            for kind in kinds_by_fetch[f]:
                n = _KIND_ARITY[kind]
                for s in range(k):
                    per[s][kind] = tuple(fetch_flat[i + j * k + s]
                                         for j in range(n))
                i += n * k
            for s in range(k):
                fetch_ins[s][f] = per[s]
        aux_ins = [{} for _ in range(k)]
        top_aux = {}
        pos = 0
        for path, arity, split in layout:
            if split:
                for s in range(k):
                    aux_ins[s][path] = tuple(aux_flat[pos:pos + arity])
                    pos += arity
                continue
            top_aux[path] = tuple(aux_flat[pos:pos + arity])
            pos += arity
            for s in range(k):
                aux_ins[s][path] = top_aux[path]
        if devices is None:
            ctx = _Ctx(plan, geom, fetch_ins[0], aux_ins[0], slots)
        else:
            slices = [_Ctx(plan, geom, fetch_ins[s],
                           {p: tuple(a.to(d) for a in arrs)
                            for p, arrs in aux_ins[s].items()},
                           slots.to(d))
                      for s, d in enumerate(devices)]
            ctx = _Ctx(plan, geom, None, top_aux, slots, slices=slices)
        root_val = _emit(ctx, plan.root)
        if isinstance(root_val, list):
            # A sharded series root: the slices' rows in order.
            root_val = pmesh.concat_rows(root_val)
        elif isinstance(stripped, Fetch):
            # A bare selector's plane is a view of a (static) input.
            root_val = root_val.clone()
        extras = ctx.root_agg if root_is_sum else ()
        return root_val, (extras if extras is not None else ())

    return body


def _tree(fn, out):
    """`fn` over every tensor of a (root, extras) output."""
    root, extras = out
    return fn(root), tuple(fn(t) for t in extras)


def _leaves(out):
    root, extras = out
    return (root,) + tuple(extras)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == F32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


class Executable:
    """One plan structure's program on one device. On the CPU it calls
    the body. On `cuda` its first call runs the body once eagerly on a
    side stream (the warm-up), captures it into a CUDA graph over static
    inputs and replays it; later calls copy their inputs in and replay.
    Outputs are cloned out of the graph's pool after each replay.

    k4_launches: window-kernel launches the graph holds (one replay);
    replays: graph replays so far; pool_bytes: the growth of
    memory_reserved across the capture (the graph's private pool);
    input_bytes: its static inputs; warmup_bytes: the growth across the
    warm-up, which returns to the shared caching allocator and is not
    charged; charged: what the `plan` tenant counts; build_s: the wall of
    the first call."""

    def __init__(self, body, device: torch.device, graphed: bool = True):
        self.body = body
        self.device = device
        # A CUDA graph only on one card; over distinct cards, eager.
        self.graphed = graphed and device.type == "cuda"
        self.lock = threading.Lock()
        self.graph = None
        self._static = None
        self._out = None
        self.k4_launches = 0
        self.replays = 0
        self.pool_bytes = 0
        self.input_bytes = 0
        self.warmup_bytes = 0
        self.charged = 0
        self.build_s = 0.0

    def __call__(self, fetch_flat, aux_flat, slots):
        if not self.graphed:
            dev = self.device
            return self.body(list(fetch_flat),
                             # the eager route's aux inputs, freed when the
                             # body returns
                             [torch.from_numpy(a).to(dev) for a in aux_flat],  # m3lint: disable=unbudgeted-device-put
                             torch.from_numpy(slots).to(dev))  # m3lint: disable=unbudgeted-device-put
        with self.lock:
            if self.graph is None:
                t0 = time.perf_counter()
                self._capture(fetch_flat, aux_flat, slots)
                self.build_s = time.perf_counter() - t0
            self._load(fetch_flat, aux_flat, slots)
            self.graph.replay()
            self.replays += 1
            window_kernels.window_stat.launches += self.k4_launches
            return _tree(torch.clone, self._out)

    def _load(self, fetch_flat, aux_flat, slots):
        s_fetch, s_aux, s_slots = self._static
        srcs = list(fetch_flat) + [torch.from_numpy(a) for a in aux_flat]
        dsts = list(s_fetch) + list(s_aux)
        srcs.append(torch.from_numpy(slots))
        dsts.append(s_slots)
        for dst, src in zip(dsts, srcs):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise RuntimeError(
                    f"plan executable input {tuple(src.shape)} {src.dtype} "
                    f"does not fit its static {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def _capture(self, fetch_flat, aux_flat, slots):
        dev = self.device
        s_fetch = [t.clone() for t in fetch_flat]
        # the capture's static inputs: input_bytes charges them to the plan
        # tenant of the shared budget
        s_aux = [torch.from_numpy(a).to(dev) for a in aux_flat]  # m3lint: disable=unbudgeted-device-put
        s_slots = torch.from_numpy(slots).to(dev)  # m3lint: disable=unbudgeted-device-put
        self._static = (s_fetch, s_aux, s_slots)
        self.input_bytes = sum(tensor_nbytes(t)
                               for t in s_fetch + s_aux + [s_slots])
        torch.cuda.synchronize(dev)
        r0 = torch.cuda.memory_reserved(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # The warm-up: real launches (the window kernel's wrapper
            # counts them); the kernels' extension is built here at the
            # latest, before the capture.
            self.body(s_fetch, s_aux, s_slots)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        r1 = torch.cuda.memory_reserved(dev)
        # torch.cuda.graph empties the allocator's cache as it begins;
        # doing it here first keeps that release out of the pool's growth.
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved(dev)
        k0 = window_kernels.window_stat.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.body(s_fetch, s_aux, s_slots)
        torch.cuda.synchronize(dev)
        # The capture records the kernels; the replays launch them.
        self.k4_launches = window_kernels.window_stat.launches - k0
        window_kernels.window_stat.launches -= self.k4_launches
        self.warmup_bytes = r1 - r0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - base
        self.charged = self.pool_bytes + self.input_bytes
        self.graph, self._out = graph, out

    def replay_matches_eager(self) -> bool:
        """On `cuda`: the body run eagerly on the static inputs the last
        replay read against one more replay, bit for bit. Neither run
        counts as a launch of the main path or as a replay."""
        with self.lock:
            s_fetch, s_aux, s_slots = self._static
            launches = window_kernels.window_stat.launches
            eager = self.body(s_fetch, s_aux, s_slots)
            self.graph.replay()
            replayed = _tree(torch.clone, self._out)
            torch.cuda.synchronize(self.device)
            window_kernels.window_stat.launches = launches
            return all(_bits_equal(a, b) for a, b in
                       zip(_leaves(eager), _leaves(replayed)))

    def release(self) -> int:
        """Drop the graph, its pool and the static tensors; returns the
        bytes the executable had charged."""
        with self.lock:
            if self.graph is not None:
                self.graph.reset()
            self.graph = self._static = self._out = None
            freed, self.charged = self.charged, 0
            return freed


_EXEC_LOCK = threading.Lock()
_EXECUTABLES: "collections.OrderedDict[tuple, Executable]" = (
    collections.OrderedDict())


def _plan_usage() -> int:
    with _EXEC_LOCK:
        return sum(e.charged for e in _EXECUTABLES.values())


def _evict_one_plan() -> int:
    """The `plan` tenant's evict-one: the least recently used executable
    and its graph (never the last one, as the other tenants keep one)."""
    with _EXEC_LOCK:
        if len(_EXECUTABLES) <= 1:
            return 0
        _, exe = _EXECUTABLES.popitem(last=False)
    return exe.release()


@functools.lru_cache(maxsize=1)
def _hbm_budget():
    from ..utils import hbm

    budget = hbm.shared_budget()
    budget.register("plan", _plan_usage, _evict_one_plan)
    return budget


def _plan_executable(stripped: PlanNode, geom: Geometry, kinds_sig: tuple,
                     dev: torch.device, mesh: Optional[pmesh.Mesh] = None
                     ) -> Tuple[Executable, bool]:
    """(executable, missed): the cached executable of a plan structure,
    geometry bucket and device (or mesh), or a new one."""
    key = (stripped, geom, kinds_sig, str(dev), mesh)
    with _EXEC_LOCK:
        exe = _EXECUTABLES.get(key)
        if exe is not None:
            _EXECUTABLES.move_to_end(key)
            return exe, False
    devices = None if mesh is None else _slice_devices(mesh)
    exe = Executable(_build_body(stripped, geom, kinds_sig, devices), dev,
                     graphed=mesh is None or mesh.one_device())
    evicted = []
    with _EXEC_LOCK:
        other = _EXECUTABLES.get(key)
        if other is not None:
            return other, False
        _EXECUTABLES[key] = exe
        while len(_EXECUTABLES) > PLAN_CACHE_MAX:
            evicted.append(_EXECUTABLES.popitem(last=False)[1])
    for old in evicted:
        old.release()
    return exe, True


def _drop_executable(key: tuple) -> None:
    """The guard's evictor for a faulted shape bucket."""
    with _EXEC_LOCK:
        exe = _EXECUTABLES.pop(key, None)
    if exe is not None:
        exe.release()


def executables() -> List[Tuple[str, Executable]]:
    """(shape bucket label, executable) of every cached executable, least
    recently used first."""
    with _EXEC_LOCK:
        items = list(_EXECUTABLES.items())
    return [(f"{_bucket_sig(k[1])}:{k[3]}", e) for k, e in items]


def clear() -> None:
    """Drop every cached executable."""
    with _EXEC_LOCK:
        items = list(_EXECUTABLES.values())
        _EXECUTABLES.clear()
    for exe in items:
        exe.release()


# -------------------------------------------------------------- execution


def _bucket_sig(geom: Geometry) -> str:
    """Compact shape-bucket label for ANALYZE device stages: padded rows
    per fetch x padded steps (@ the shard count over a mesh) — a closed
    set (quarter-octave buckets), safe as a stage-name suffix."""
    rows = "+".join(str(s) for s in geom.s_pads) or "0"
    shards = f"@{geom.n_shard}" if geom.n_shard > 1 else ""
    return f"s{rows}xt{geom.t_pad}{shards}"


@functools.lru_cache(maxsize=256)
def _compile_sig(root: PlanNode, fetches: Tuple[Fetch, ...]):
    """Matcher-stripped compile key + per-fetch staged-input kinds for a
    plan structure — pure of (root, fetches), memoized so a repeated
    query shape doesn't rebuild the projection every dispatch."""
    fetch_index = {f: i for i, f in enumerate(fetches)}
    kinds = fetch_kinds(root)
    stripped = qplan.strip(root, fetch_index)
    kinds_sig = tuple((qplan.strip(f, fetch_index), kinds[f])
                      for f in fetches)
    return stripped, kinds_sig, kinds


def _segment_layout(gids: np.ndarray, n_groups: int, s_pad: int,
                    g_pad: int) -> List[np.ndarray]:
    """An aggregate's aux arrays: the group id per padded row (padding
    rows 0, their values are NaN-masked), then the group-sorted layout
    of _segment_sum_sorted — row order (stable: original order within a
    group, -1 past the real rows), each sorted row's rank in its group,
    its group's size, and each group's first sorted row (-1 when
    empty)."""
    S = len(gids)
    g = np.zeros(s_pad, np.int64)
    g[:S] = gids
    order = np.full(s_pad, -1, np.int64)
    rel = np.zeros(s_pad, np.int64)
    seglen = np.zeros(s_pad, np.int64)
    starts = np.full(g_pad, -1, np.int64)
    if S:
        o = np.argsort(gids, kind="stable")
        sg = np.asarray(gids, np.int64)[o]
        counts = np.bincount(sg, minlength=max(n_groups, 1))
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        order[:S] = o
        rel[:S] = np.arange(S) - first[sg]
        seglen[:S] = counts[sg]
        starts[:len(counts)] = np.where(counts > 0, first, -1)
    return [g, order, rel, seglen, starts]


def _aux_arrays(bound: "qplan.Bound", geom: Geometry,
                nodes: List[PlanNode]) -> List[np.ndarray]:
    """Bind-time host label algebra -> the padded index arrays, in
    _aux_layout's order (an aggregate over a sharded child: one set per
    slice, over the slice's rows)."""
    plan = bound.plan
    pad_rows = _padded_rows_map(bound, geom, nodes)
    width_of, _ = _widths(plan.root, geom.t_pad, geom.sub_pads)
    out: List[np.ndarray] = []
    agg_i = vv_i = rank_i = 0
    for n in nodes:
        if isinstance(n, Aggregate):
            a = bound.aux[id(n)]
            gids, n_groups = a["group_ids"], int(a["n_groups"])
            g_pad = geom.g_pads[agg_i]
            agg_i += 1
            if not _split_agg(n, geom.n_shard):
                out += _segment_layout(gids, n_groups, pad_rows[id(n.arg)],
                                       g_pad)
                continue
            rows = pad_rows[id(n.arg)] // geom.n_shard
            for sl in range(geom.n_shard):
                out += _segment_layout(gids[sl * rows:(sl + 1) * rows],
                                       n_groups, rows, g_pad)
        elif _is_vv(n):
            a = bound.aux[id(n)]
            r_pad = geom.r_pads[vv_i]
            vv_i += 1
            mi = np.full(r_pad, -1, dtype=np.int64)
            oi = np.full(r_pad, -1, dtype=np.int64)
            mi[:len(a["many_idx"])] = a["many_idx"]
            oi[:len(a["one_idx"])] = a["one_idx"]
            out += [mi, oi]
        elif isinstance(n, RankAgg):
            a = bound.aux[id(n)]
            g_pad, smax_pad = geom.rank_pads[rank_i]
            rank_i += 1
            gids = a["group_ids"].astype(np.int64)
            perm = np.full(g_pad * smax_pad, -1, dtype=np.int64)
            inv = np.full(pad_rows[id(n.arg)], -1, dtype=np.int64)
            if len(gids):
                # Stable order packs each group's rows in their original
                # row order (the interpreter's flatnonzero tie-break).
                order = np.argsort(gids, kind="stable")
                sorted_g = gids[order]
                starts = np.searchsorted(
                    sorted_g, np.arange(max(a["n_groups"], 1)))
                slots_in_g = np.arange(len(gids)) - starts[sorted_g]
                packed_idx = sorted_g * smax_pad + slots_in_g
                perm[packed_idx] = order
                inv[order] = packed_idx
            out += [perm, inv]
        elif isinstance(n, SubqueryFunc) and n.packed:
            a = bound.aux[id(n)]
            cols = np.full(width_of[id(n)] * n.W, -1, dtype=np.int64)
            cols[:len(a["cols"])] = a["cols"]
            out.append(cols)
        elif isinstance(n, InstantFunc) and n.func == "timestamp":
            a = bound.aux[id(n)]
            times = np.zeros(width_of[id(n)], dtype=np.float32)
            times[:len(a["times"])] = a["times"]
            out.append(times)
    return out


def _to_host_async(*tensors: torch.Tensor):
    """Start device->host copies of `tensors` without blocking; returns a
    function that waits for them and gives the numpy arrays. On the CPU
    there is nothing to copy."""
    if not tensors or tensors[0].device.type != "cuda":
        return lambda: [t.numpy() for t in tensors]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return [h.numpy() for h in hosts]

    return wait


def _slice_devices(mesh: pmesh.Mesh) -> List[torch.device]:
    """The devices of the mesh's "shard" axis (0 along any other)."""
    axis = mesh.axis_names.index("shard")
    coords = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.shape["shard"]):
        coords[axis] = i
        out.append(mesh.device_at(coords))
    return out


def mesh_route(plan: "qplan.Plan", mesh: Optional[pmesh.Mesh]
               ) -> Optional[dict]:
    """How `execute` runs `plan` over `mesh`: None on one device (no
    mesh, a plan that is not mesh_ok, or a shard axis of 1), else the
    slice count and the executable's kind — "graph" (one CUDA graph over
    every slice of one card), "eager" (distinct cards) or "cpu"."""
    if mesh is None or not plan.mesh_ok or mesh.shape.get("shard", 1) <= 1:
        return None
    first = mesh.first
    kind = ("cpu" if first.type != "cuda"
            else "graph" if mesh.one_device() else "eager")
    return {"shards": mesh.shape["shard"], "executable": kind}


def execute(bound: "qplan.Bound", device: torch.device,
            mesh: Optional[pmesh.Mesh] = None):
    """Run one bound plan compiled on `device`, or over `mesh`'s "shard"
    axis when the plan is mesh_ok (mesh_route): stage inputs, fetch (or
    build) the plan executable, dispatch ONE program through the guard,
    host-finish. Returns (values, tags, fetch_fn): scalar roots
    materialize `values` [steps] f64 directly; series roots return
    fetch_fn, a closure materializing the [rows, steps] plane (LazyBlock)
    from a device->host copy started here."""
    plan = bound.plan
    route = mesh_route(plan, mesh)
    use_mesh = mesh if route is not None else None
    dev = torch.device(device) if use_mesh is None else use_mesh.first
    geom = geometry_for(bound, 1 if route is None else route["shards"])
    stripped, kinds_sig, kinds = _compile_sig(plan.root, plan.fetches)

    # --- staged fetch inputs (device-resident via the derived cache)
    fetch_flat: List[torch.Tensor] = []
    for fi, f in enumerate(plan.fetches):
        fetch_flat.extend(_stage_fetch(bound.fetches[f], kinds[f],
                                       geom.s_pads[fi], geom.f_exts[fi],
                                       dev, use_mesh))
    nodes: List[PlanNode] = []
    _preorder(plan.root, nodes)
    aux_flat = _aux_arrays(bound, geom, nodes)
    slots = np.asarray(bound.slots, dtype=np.float32)
    if slots.size == 0:
        slots = np.zeros(1, dtype=np.float32)

    # The shape bucket keys the compute-fault quarantine: a faulted
    # bucket raises at once (before its executable is rebuilt) until the
    # guard's TTL, and its cache entry is dropped.
    bucket = (_bucket_sig(geom), hash((stripped, kinds_sig)))
    key = (stripped, geom, kinds_sig, str(dev), use_mesh)
    actx = qexplain.current()
    state = {"missed": False, "dt": 0.0}

    def primary():
        exe, missed = _plan_executable(stripped, geom, kinds_sig, dev,
                                       use_mesh)
        state["missed"] = missed
        if missed:
            telemetry.plan_cache_miss()
            fn = telemetry.BuildTimed(exe, "plan")
        else:
            telemetry.plan_cache_hit()
            fn = exe
        if use_mesh is not None:
            telemetry.mesh_dispatch("plan", cells=int(bound.total_cells))
        # ANALYZE (or a miss): synchronize, so the stage records the true
        # program wall; off, the cost is one thread-local read and the
        # launches stay asynchronous.
        sync = missed or actx is not None
        t0 = time.perf_counter() if sync else 0.0
        out = fn(fetch_flat, aux_flat, slots)
        if sync:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            state["dt"] = time.perf_counter() - t0
        if missed and dev.type == "cuda":
            _hbm_budget().reclaim()
        return out

    root_val, extras = guard.dispatch(
        "plan", primary, key=bucket,
        evict=functools.partial(_drop_executable, key))
    if state["missed"]:
        telemetry.plan_compile_recorded(state["dt"])
    if actx is not None:
        # A cache miss's first invocation builds the executable (the
        # warm-up and the capture) with the execution — name the stage so
        # a one-time build can't be misread as steady-state program wall.
        name = f"device_program[{_bucket_sig(geom)}]"
        if state["missed"]:
            name += "+compile"
            actx.event("plan_cache_miss")
        actx.add(name, state["dt"])

    # --- host finish
    steps = plan.steps
    root = plan.root
    if numwatch.installed():
        # Numerics witness (M3_TPU_NUMERICS=1, smoke tiers only):
        # observe the PADDED program output before the host slices it —
        # live lanes are the bound result rows x real steps, and every
        # padding ROW past them must still be NaN.
        numwatch.observe_result(
            "plan", root_val,
            live_rows=(None if root.edge.kind == SCALAR
                       else len(bound.out_tags)),
            live_cols=steps)
    if root.edge.kind == SCALAR:
        return np.full(steps, float(root_val)), bound.out_tags, None

    n_rows = len(bound.out_tags)
    result_bytes = n_rows * steps * (
        8 if isinstance(root, Aggregate) and root.op in ("sum", "avg")
        else 4)

    if isinstance(root, RankAgg) and root.op in ("topk", "bottomk"):
        # Eager host finish: the surviving SERIES SET is data-dependent
        # (rows in the k best at any step), so the tags can only be
        # fixed after materialization — the interpreter's all-NaN row
        # drop, applied to the masked plane.
        t0f = time.perf_counter() if actx is not None else 0.0
        vals = root_val[:n_rows, :steps].cpu().numpy()
        telemetry.count_d2h(result_bytes)
        keep = ~np.all(np.isnan(vals), axis=1)
        tags = [t for t, k in zip(bound.out_tags, keep) if k]
        vals = np.ascontiguousarray(vals[keep])
        if actx is not None:
            actx.add("result_materialize", time.perf_counter() - t0f)
            actx.event("d2h_bytes", result_bytes)
        return None, tags, (lambda: vals)

    if isinstance(root, Aggregate) and root.op in ("sum", "avg"):
        s_dev, cnt_dev = extras
        # The asynchronous D2H starts on the planes fetch() reads (a
        # sum/avg root finishes from its (s, cnt) components, not the
        # collapsed root plane).
        wait = _to_host_async(s_dev[:n_rows, :steps], cnt_dev[:n_rows, :steps])

        def fetch():
            t0 = time.perf_counter() if actx is not None else 0.0
            s32, cnt32 = wait()
            s = s32.astype(np.float64)
            cnt = cnt32.astype(np.float64)
            telemetry.count_d2h(result_bytes)
            if root.exact:
                s = s + _exact_base_contrib(bound, root, n_rows, steps)
            out = s / np.maximum(cnt, 1) if root.op == "avg" else s
            result = np.where(cnt > 0, out, np.nan)
            if actx is not None:
                actx.add("result_materialize", time.perf_counter() - t0)
                actx.event("d2h_bytes", result_bytes)
            return result

        return None, bound.out_tags, fetch

    wait = _to_host_async(root_val[:n_rows, :steps])

    def fetch():
        t0 = time.perf_counter() if actx is not None else 0.0
        telemetry.count_d2h(result_bytes)
        # f32, like the per-op interpreter path's result planes: the
        # padded [rows_pad, t_pad] plane is sliced, not up-converted.
        (result,) = wait()
        if actx is not None:
            actx.add("result_materialize", time.perf_counter() - t0)
            actx.event("d2h_bytes", result_bytes)
        return result

    return None, bound.out_tags, fetch


def _padded_rows_map(bound: "qplan.Bound", geom: Geometry,
                     nodes: List[PlanNode]) -> Dict[int, int]:
    """Padded row count of every series-valued node's output plane (the
    length its consumer's per-row index inputs must be padded to)."""
    plan = bound.plan
    g_iter = iter(geom.g_pads)
    r_iter = iter(geom.r_pads)
    rank_iter = iter(geom.rank_pads)
    g_of: Dict[int, int] = {}
    r_of: Dict[int, int] = {}
    rank_of: Dict[int, Tuple[int, int]] = {}
    for n in nodes:
        if isinstance(n, Aggregate):
            g_of[id(n)] = next(g_iter)
        elif _is_vv(n):
            r_of[id(n)] = next(r_iter)
        elif isinstance(n, RankAgg):
            rank_of[id(n)] = next(rank_iter)

    out: Dict[int, int] = {}

    def rows(n: PlanNode) -> int:
        key = id(n)
        if key in out:
            return out[key]
        if isinstance(n, Fetch):
            r = geom.s_pads[plan.fetches.index(n)]
        elif isinstance(n, RangeFunc):
            r = 1 if n.func == "absent_over_time" else rows(n.arg)
        elif isinstance(n, (SubqueryFunc, InstantFunc)):
            r = rows(n.arg)
        elif isinstance(n, Aggregate):
            r = g_of[key]
        elif isinstance(n, RankAgg):
            # quantile collapses to group rows; topk keeps arg rows.
            r = rank_of[key][0] if n.op == "quantile" else rows(n.arg)
        elif isinstance(n, Binary):
            if _is_vv(n):
                r = r_of[key]
            elif n.lhs.edge.kind == SERIES:
                r = rows(n.lhs)
            else:
                r = rows(n.rhs)
        else:
            r = 0
        out[key] = r
        return r

    for n in nodes:
        rows(n)
    return out


def _exact_base_contrib(bound: "qplan.Bound", root: Aggregate,
                        n_rows: int, steps: int) -> np.ndarray:
    """Exact-f64 baseline mass for a counter sum: per-group baseline
    totals minus the baselines of MISSING cells (host, f64 — the part
    where f32 device accumulation of 1e9-magnitude counters would lose
    the host-reduce semantics). The common fully-dense case costs one
    isfinite pass; only rows with gaps pay the correction."""
    fetch = root.arg
    bf = bound.fetches[fetch]
    grid = bf.grid[:, :steps]
    finite = np.isfinite(grid)
    _, base = temporal.center(bf.grid)
    gids = bound.aux[id(root)]["group_ids"].astype(np.int64)
    g = int(bound.aux[id(root)]["n_groups"])
    base_g = np.zeros(g, dtype=np.float64)
    np.add.at(base_g, gids, base)
    out = np.repeat(base_g[:n_rows, None], steps, axis=1)
    missing_rows = np.nonzero(~finite.all(axis=1))[0]
    if missing_rows.size:
        corr = np.zeros((g, steps), dtype=np.float64)
        sub = np.where(finite[missing_rows], 0.0,
                       base[missing_rows][:, None])
        np.add.at(corr, gids[missing_rows], sub)
        out = out - corr[:n_rows]
    return out
