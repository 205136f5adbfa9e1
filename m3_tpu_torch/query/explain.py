"""Query EXPLAIN/ANALYZE: per-node plan introspection for the compiled
whole-plan route (port of m3_tpu/query/explain.py, host only; reference:
the Prometheus HTTP API returns per-query `stats` beside the data, and
m3query attributes per-query cost — this goes one layer deeper and
explains WHY a query did or didn't take the compiled path, per plan
node).

EXPLAIN (`explain()`) is STATIC — it lowers the query and renders a
structured tree without touching storage:

  * a compilable query renders its physical plan IR (query/plan.py):
    per node the kind, a human detail, the edge type (series/scalar),
    the sharding annotation (shard/replicated) and route "compiled";
  * a non-compilable query renders the AST with every node routed
    "interpreter" and the node that raised `NotCompilable` annotated
    with the typed `FallbackReason` + detail — the operator sees
    exactly which subexpression blocks the compiled path.

Because EXPLAIN never fetches, the data-dependent below-floor decision
(`PLAN_MIN_CELLS`) can't be resolved statically; the payload carries the
floor so the caller can compare, and `Engine.last_route()` reports the
route the execution ACTUALLY took (with `mesh`, the slice count and the
executable's kind, when a mesh_ok plan ran over the mesh).

ANALYZE is an instrumented execution mode: `with analyzing() as a:`
installs a thread-local context the query path feeds stage wall times
(host tag-algebra bind, the device program per shape bucket, the result
materialization) and cache events (grid-cache hit/miss per fetch, d2h
bytes) into. Zero cost when disabled: every hook is one `current()` call
returning None."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional

from . import plan as qplan
from . import promql
from .plan import (
    Aggregate, Binary, Fetch, InstantFunc, NotCompilable, PlanNode,
    RangeFunc, RankAgg, ScalarConst, SubqueryFunc,
)

ROUTE_COMPILED = "compiled"
ROUTE_INTERPRETER = "interpreter"


# ----------------------------------------------------------------- EXPLAIN


def explain(ast: promql.Node, params, lookback_ns: int,
            query: Optional[str] = None) -> dict:
    """Static plan introspection for one parsed query: route, typed
    fallback reason, and the per-node tree (see module docstring). Pure
    of (ast, params, lookback) — no storage access, no execution."""
    plan, err, _ = qplan.lower_and_collect(ast, params, lookback_ns)
    out = {
        "steps": params.steps,
        "step_ns": params.step_ns,
        "plan_min_cells": qplan.PLAN_MIN_CELLS,
    }
    if query is not None:
        out["query"] = query
    if plan is not None:
        out["route"] = ROUTE_COMPILED
        out["fallback_reason"] = None
        out["mesh_ok"] = plan.mesh_ok
        out["fetches"] = len(plan.fetches)
        out["root"] = _plan_tree(plan.root)
    else:
        out["route"] = ROUTE_INTERPRETER
        out["fallback_reason"] = err.reason.value
        out["fallback_detail"] = str(err)
        out["root"] = _ast_tree(ast, err)
    return out


def walk(tree: dict) -> Iterator[dict]:
    """Every node dict of an explain tree, preorder (tests/smoke use
    this to assert per-node routes)."""
    yield tree
    for child in tree.get("children", ()):
        yield from walk(child)


def _plan_tree(node: PlanNode) -> dict:
    d = {
        "node": type(node).__name__,
        "detail": _plan_detail(node),
        "kind": node.edge.kind,
        "sharding": node.edge.sharding,
        "route": ROUTE_COMPILED,
    }
    children = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, PlanNode):
            children.append(_plan_tree(v))
        elif isinstance(v, tuple):
            children.extend(_plan_tree(x) for x in v
                            if isinstance(x, PlanNode))
    if children:
        d["children"] = children
    return d


def _plan_detail(node: PlanNode) -> str:
    if isinstance(node, Fetch):
        name = node.sel.name.decode(errors="replace") if node.sel.name \
            else "{...}"
        return f"{name} role={node.role} W={node.W} stride={node.stride}"
    if isinstance(node, RangeFunc):
        return node.func
    if isinstance(node, SubqueryFunc):
        mode = "packed" if node.packed else "shared"
        return (f"{node.func} subquery[{node.range_ns / 1e9:g}s"
                f":{node.res_ns / 1e9:g}s] W={node.W} "
                f"stride={node.stride} {mode}")
    if isinstance(node, RankAgg):
        mode = "without" if node.without else "by"
        grp = ",".join(g.decode(errors="replace") for g in node.grouping)
        return f"{node.op} {mode}({grp})" if node.grouping else node.op
    if isinstance(node, InstantFunc):
        return node.func
    if isinstance(node, Aggregate):
        mode = "without" if node.without else "by"
        grp = ",".join(g.decode(errors="replace") for g in node.grouping)
        out = f"{node.op} {mode}({grp})" if node.grouping else node.op
        return out + (" exact" if node.exact else "")
    if isinstance(node, Binary):
        return node.op
    if isinstance(node, ScalarConst):
        return f"slot{node.slot}"
    return type(node).__name__  # pragma: no cover


def _ast_tree(node: promql.Node, err: NotCompilable) -> dict:
    d = {
        "node": type(node).__name__,
        "detail": _ast_detail(node),
        "route": ROUTE_INTERPRETER,
    }
    if err.node is node:
        # The exact node whose lowering raised: the typed reason pins
        # here, everything else just reports the interpreter route.
        d["reason"] = err.reason.value
        d["reason_detail"] = err.detail
    children = []
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, promql.VectorMatching):
            continue  # matching metadata, not an operand
        if isinstance(v, promql.Node):
            children.append(_ast_tree(v, err))
        elif isinstance(v, tuple):
            children.extend(_ast_tree(x, err) for x in v
                            if isinstance(x, promql.Node))
    if children:
        d["children"] = children
    return d


def _ast_detail(node: promql.Node) -> str:
    if isinstance(node, promql.VectorSelector):
        name = node.name.decode(errors="replace") if node.name else "{...}"
        return f"{name}[{node.range_ns / 1e9:g}s]" if node.range_ns else name
    if isinstance(node, promql.Subquery):
        return (f"subquery[{node.range_ns / 1e9:g}s"
                f":{node.step_ns / 1e9:g}s]" if node.step_ns
                else f"subquery[{node.range_ns / 1e9:g}s:]")
    if isinstance(node, promql.Call):
        return node.func
    if isinstance(node, promql.Aggregation):
        mode = "without" if node.without else "by"
        grp = ",".join(g.decode(errors="replace") for g in node.grouping)
        return f"{node.op} {mode}({grp})" if node.grouping else node.op
    if isinstance(node, promql.BinaryOp):
        return node.op
    if isinstance(node, promql.Unary):
        return node.op
    if isinstance(node, promql.NumberLiteral):
        return f"{node.value:g}"
    if isinstance(node, promql.StringLiteral):
        return "<string>"
    return type(node).__name__


# ----------------------------------------------------------------- ANALYZE


class Analyze:
    """One query's (or request's) stage/event accumulator. Stages are
    wall seconds keyed by stage name (device stages carry their shape
    bucket in the name, so one ANALYZE run shows per-bucket program
    wall; a plan-cache miss's first invocation builds the executable —
    on the card a warm-up run and a CUDA-graph capture — with execution,
    so that stage is suffixed `+compile` and a `plan_cache_miss` event
    records — a one-time build must not read as steady-state program
    wall); events are counts/bytes (grid-cache
    hits/misses, d2h bytes)."""

    __slots__ = ("stages", "events")

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.events: Dict[str, float] = {}

    def add(self, stage: str, seconds: float):
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def event(self, name: str, n: float = 1):
        self.events[name] = self.events.get(name, 0) + n

    def to_dict(self) -> dict:
        return {
            "stages_ms": {k: round(v * 1000, 3)
                          for k, v in sorted(self.stages.items())},
            "events": {k: v for k, v in sorted(self.events.items())},
        }


_TLS = threading.local()


def current() -> Optional[Analyze]:
    """The thread's active ANALYZE context, or None (the hot-path check:
    one thread-local read, same shape as tracing's NOOP test)."""
    return getattr(_TLS, "analyze", None)


@contextlib.contextmanager
def analyzing():
    """Install a fresh ANALYZE context for this thread; restores the
    previous one on exit (nesting yields the inner context)."""
    prev = getattr(_TLS, "analyze", None)
    ctx = Analyze()
    _TLS.analyze = ctx
    try:
        yield ctx
    finally:
        _TLS.analyze = prev
