"""Observability-discipline rules.

Rules:
  wall-clock-latency   an elapsed-time measurement computed from
                       `time.time()` / `time.time_ns()` deltas inside the
                       serving layers (storage / rpc / client / query /
                       msg). Wall clocks step under NTP correction and
                       jump across suspend, so a latency/uptime/backoff
                       measured as `time.time() - t0` can go NEGATIVE or
                       gain hours — every elapsed measurement must use
                       `time.perf_counter()` / `perf_counter_ns()` (or
                       `monotonic`/`monotonic_ns`). Wall-clock READS are
                       fine (data timestamps, default query ranges): the
                       rule flags only SUBTRACTIONS where one side is a
                       wall-clock call or a name/attribute assigned from
                       one — i.e. an elapsed computation.

  unbounded-telemetry-tag
                       an unbounded value riding into the instrument
                       registry as a metric identity — a `sub_scope()`
                       tag value or counter/gauge/histogram/timer NAME
                       derived from a raw query string or similar
                       user-controlled text. Every distinct tag value
                       mints a NEW registry entry forever (Scope keys
                       are never evicted) and a new self-scraped series,
                       so tagging by query text converts one dashboard's
                       traffic into unbounded registry growth + series
                       cardinality. Tag values must come from CLOSED
                       sets (the `plan.FallbackReason` enum values, kind
                       strings, builder names). The rule flags scope
                       calls whose argument interpolates an identifier
                       from the unbounded vocabulary (query/expr/
                       selector/pattern/...), passes such an identifier
                       bare, or binds a tag KEYWORD named like one to a
                       non-literal value.

  host-sync-in-plan    a host synchronization inside the whole-plan
                       compiler's lowering surface (parallel/compile.py's
                       `_lower_*` / `_emit` rules, the captured `body`
                       they build, and the SubqueryFunc/RankAgg helpers
                       `_range_body` / `_sub_gather`): `np.asarray`,
                       `.item()`, `.cpu()`, `.numpy()`, `.tolist()`,
                       `torch.nonzero`/`torch.argwhere`, `bool(t)` and a
                       Python `if`/`while` on a tensor a torch op made.
                       The lowering rules run inside the CUDA-graph
                       capture on the card: a host sync there is an error
                       under capture, and a value it reads is baked into
                       every replay (eagerly on the CPU it passes, so no
                       CPU test sees it). Host finishes belong in
                       `execute()` AFTER the replay returns, never inside
                       a lowering rule. The reference's JAX shapes
                       (`jax.device_get`) stay flagged.

The wall-clock pre-fix seeded positive was rpc/node_server.py's uptime
(`time.time_ns() - self.start_ns` with `self.start_ns = time.time_ns()`),
fixed to monotonic_ns in the same pass. Tree is at 0 findings.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .core import Finding, Module, Rule, qualname

_WALL_CALLS = {"time.time", "time.time_ns"}


def _is_wall_call(node: ast.AST, bare_time_names: Set[str]) -> bool:
    """`time.time()` / `time.time_ns()` (or a bare `time()`/`time_ns()`
    imported from the time module)."""
    if not isinstance(node, ast.Call):
        return False
    q = qualname(node.func)
    if q in _WALL_CALLS:
        return True
    return q in bare_time_names


class WallClockLatencyRule(Rule):
    """wall-clock-latency: elapsed time measured on the wall clock."""

    id = "wall-clock-latency"
    severity = "error"
    dirs = ("storage", "rpc", "client", "query", "msg", "parallel", "testing")

    @staticmethod
    def _bare_time_names(mod: Module) -> Set[str]:
        """Names bound by `from time import time [as t]` / `time_ns`."""
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in ("time", "time_ns"):
                        out.add(a.asname or a.name)
        return out

    @staticmethod
    def _wall_assigned(mod: Module, bare: Set[str]) -> Set[str]:
        """Names and `self.attr` qualnames assigned from a wall-clock
        call anywhere in the module — `t0 = time.time()` in one method
        subtracted in another is still an elapsed measurement."""
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            value: Optional[ast.AST] = None
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, list(node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                value = node.value
                targets = [node.target]
            if value is None or not _is_wall_call(value, bare):
                continue
            for tgt in targets:
                q = qualname(tgt)
                if q:
                    out.add(q)
        return out

    def check(self, mod: Module) -> Iterator[Finding]:
        bare = self._bare_time_names(mod)
        assigned = self._wall_assigned(mod, bare)

        def is_wall(node: ast.AST) -> bool:
            if _is_wall_call(node, bare):
                return True
            q = qualname(node)
            return q is not None and q in assigned

        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            left_wall = is_wall(node.left)
            right_wall = is_wall(node.right)
            # An elapsed computation subtracts two wall readings (call or
            # stored reading on either side). A single wall operand minus
            # a constant/duration is range arithmetic, not a measurement.
            if not (left_wall and right_wall):
                continue
            yield self.finding(
                mod, node,
                "elapsed time measured with time.time()/time_ns() deltas — "
                "wall clocks step under NTP and suspend; use "
                "time.perf_counter()/perf_counter_ns() (or monotonic) for "
                "latency/uptime/backoff measurements")


_SYNC_CALLS = {"np.asarray", "numpy.asarray", "jax.device_get",
               "torch.nonzero", "torch.argwhere"}
_SYNC_TENSOR_METHODS = ("item", "cpu", "numpy", "tolist")
_SYNC_BARE = {"asarray": ("numpy", "np"), "device_get": ("jax",)}


class HostSyncInPlanRule(Rule):
    """host-sync-in-plan: a traced-value host sync inside a whole-plan
    lowering rule."""

    id = "host-sync-in-plan"
    severity = "error"
    dirs = ("parallel",)

    # Named lowering helpers beyond the `_lower_*` prefix: `_emit` and
    # the captured `body`, plus the SubqueryFunc/RankAgg helpers —
    # `_range_body` (the shared windowed-kernel ladder every
    # RangeFunc/SubqueryFunc lowering routes through) and `_sub_gather`
    # (the packed-window gather) — all of which run inside the capture.
    _LOWER_NAMES = ("_emit", "body", "_range_body", "_sub_gather")

    @classmethod
    def _is_lowering_fn(cls, node: ast.AST) -> bool:
        return (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (node.name.startswith("_lower")
                     or node.name in cls._LOWER_NAMES))

    @staticmethod
    def _bare_sync_names(mod: Module) -> Set[str]:
        """Names bound by `from numpy import asarray` / `from jax import
        device_get` (with aliases)."""
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    mods = _SYNC_BARE.get(a.name)
                    if mods and node.module in mods:
                        out.add(a.asname or a.name)
        return out

    def check(self, mod: Module) -> Iterator[Finding]:
        # The lowering surface exists only in the plan compiler module;
        # execute()'s post-program host finish is the legitimate sync
        # point and must not trip the rule.
        if not mod.scope_parts or mod.scope_parts[-1] != "compile.py":
            return
        bare = self._bare_sync_names(mod)
        seen: Set[int] = set()
        for fn in ast.walk(mod.tree):
            if not self._is_lowering_fn(fn):
                continue
            for node in ast.walk(fn):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                seen.add(id(node))
                q = qualname(node.func)
                method = (node.func.attr
                          if isinstance(node.func, ast.Attribute)
                          and node.func.attr in _SYNC_TENSOR_METHODS
                          and not node.args else None)
                is_bool = q == "bool" and len(node.args) == 1 and \
                    not isinstance(node.args[0], ast.Constant)
                if not (q in _SYNC_CALLS or q in bare or method
                        or is_bool):
                    continue
                what = f"`.{method}()`" if method else (
                    "`bool(...)`" if is_bool else f"`{q}`")
                yield self.finding(
                    mod, node,
                    f"{what} inside lowering rule `{fn.name}` syncs a "
                    "traced value to the host mid-plan — this is the "
                    "per-op dispatch round trip the whole-plan compiler "
                    "removes; keep lowering rules pure jnp/lax and do "
                    "host finishes in execute() after the compiled "
                    "program returns")
            yield from self._tensor_branches(mod, fn)

    def _tensor_branches(self, mod: Module, fn) -> Iterator[Finding]:
        """A Python `if`/`while` on a tensor a torch op made inside the
        lowering rule (`bool(t)` under the hood)."""
        from .device_rules import _TaintVisitor

        v = _TaintVisitor(mod, fn, set(), {})
        v.run()
        for rule_id, node, _msg in v.violations:
            if rule_id != "capture-traced-branch":
                continue
            yield self.finding(
                mod, node,
                f"Python branch on a tensor inside lowering rule "
                f"`{fn.name}` syncs its value to the host mid-plan — "
                "bool(tensor) is an error under the CUDA-graph capture "
                "and bakes one query's value into every replay; use "
                "torch.where, or decide on plan structure")


# Identifiers whose value domain is user-controlled text (a PromQL
# query, a selector, a regexp pattern): interpolated into a metric name
# or passed as a tag value they mint unbounded registry entries.
_UNBOUNDED_IDENTS = frozenset({
    "query", "q", "qs", "expr", "expression", "promql", "selector", "sel",
    "sql", "pattern", "target", "query_str", "query_string", "raw_query",
})

# Scope-call method names that mint registry identities.
_SCOPE_METHODS = frozenset({"counter", "gauge", "histogram", "timer"})


class UnboundedTelemetryTagRule(Rule):
    """unbounded-telemetry-tag: a raw query string (or similar unbounded
    value) used as a scope tag value or metric name."""

    id = "unbounded-telemetry-tag"
    severity = "error"
    dirs = None  # the instrument registry is process-wide; gate everywhere

    @staticmethod
    def _unbounded_ident(expr: ast.AST) -> Optional[str]:
        """The first unbounded-vocabulary identifier appearing anywhere
        inside `expr` (f-string pieces, concatenations, str()/format()
        arguments, attribute chains), or None."""
        for node in ast.walk(expr):
            name = None
            if isinstance(node, ast.Name):
                name = node.id
            elif isinstance(node, ast.Attribute):
                name = node.attr
            if name and name.lower() in _UNBOUNDED_IDENTS:
                return name
        return None

    def _check_value(self, mod: Module, call: ast.Call, expr: ast.AST,
                     what: str) -> Iterator[Finding]:
        ident = self._unbounded_ident(expr)
        if ident is None:
            return
        yield self.finding(
            mod, call,
            f"{what} derives from `{ident}` — an unbounded value minting "
            "a new instrument-registry entry (and self-scraped series) "
            "per distinct value; tag values and metric names must come "
            "from closed sets (e.g. the plan.FallbackReason enum values)")

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            method = node.func.attr
            if method == "sub_scope":
                # positional name pieces + keyword TAG values
                for arg in node.args:
                    yield from self._check_value(
                        mod, node, arg, "sub_scope() name")
                for kw in node.keywords:
                    if kw.arg is None:
                        continue
                    if kw.arg.lower() in _UNBOUNDED_IDENTS and \
                            not isinstance(kw.value, ast.Constant):
                        yield self.finding(
                            mod, node,
                            f"sub_scope() tag `{kw.arg}=` binds a "
                            "non-literal value under an unbounded-domain "
                            "key — a raw query/selector as a tag value "
                            "mints one registry entry per distinct query")
                        continue
                    yield from self._check_value(
                        mod, node, kw.value, f"sub_scope() tag `{kw.arg}`")
            elif method in _SCOPE_METHODS and node.args:
                yield from self._check_value(
                    mod, node, node.args[0], f"{method}() metric name")


RULES: List[Rule] = [WallClockLatencyRule(), HostSyncInPlanRule(),
                     UnboundedTelemetryTagRule()]
