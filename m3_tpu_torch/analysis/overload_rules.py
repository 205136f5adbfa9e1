"""Overload-discipline rules: buffering structures on the data path must
be bounded, because an unbounded queue converts overload into an OOM
instead of backpressure (the failure class the admission-control layer
exists to prevent — every in-memory buffer needs a cap plus a watermark
that surfaces as typed Backpressure).

Rules:
  unbounded-queue   a stdlib `queue.Queue()` / `collections.deque()`
                    constructed WITHOUT a bound (no maxsize/maxlen, or a
                    literal unbounded value like 0/None/-1) inside the
                    storage/msg/coordinator/aggregator/rpc modules — the
                    layers that buffer other components' traffic.
                    `queue.SimpleQueue` has no bound at all and always
                    flags. Bound the structure (and surface watermark
                    pressure via utils.limits.Backpressure), or carry a
                    justified suppression for deliberately unbounded
                    control-plane queues.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from .core import Finding, Module, Rule, qualname

# (callable name, bounding keyword, index of the bounding positional arg)
_QUEUE_CTORS = {
    "Queue": ("maxsize", 0),
    "LifoQueue": ("maxsize", 0),
    "PriorityQueue": ("maxsize", 0),
    "deque": ("maxlen", 1),
}
_NEVER_BOUNDED = {"SimpleQueue"}
# Parent modules whose attribute access counts (queue.Queue, collections.deque)
_PARENTS = {"queue", "collections"}


def _is_unbounded_literal(node: ast.AST) -> bool:
    """A bound argument that is literally no bound: None, 0, or negative
    (stdlib Queue semantics: maxsize <= 0 means infinite)."""
    if isinstance(node, ast.Constant):
        return node.value is None or (isinstance(node.value, (int, float))
                                      and node.value <= 0)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) and \
            isinstance(node.operand, ast.Constant):
        return True  # -N literal: negative == unbounded for Queue
    return False


class UnboundedQueueRule(Rule):
    """unbounded-queue: stdlib Queue()/deque() without a bound in the
    buffering layers."""

    id = "unbounded-queue"
    severity = "error"
    dirs = ("storage", "msg", "coordinator", "aggregator", "rpc")

    def _ctor_name(self, call: ast.Call) -> Optional[str]:
        q = qualname(call.func)
        if q is None:
            return None
        parts = q.split(".")
        name = parts[-1]
        if name not in _QUEUE_CTORS and name not in _NEVER_BOUNDED:
            return None
        # bare name: honored only when its stdlib module is imported
        # (a local helper also called `deque` must not trip the rule);
        # dotted: the parent must be the stdlib module itself.
        if len(parts) == 1:
            if not (_PARENTS & self._stdlib_imports):
                return None
        elif parts[-2] not in _PARENTS:
            return None
        return name

    def check(self, mod: Module) -> Iterator[Finding]:
        self._stdlib_imports = _PARENTS & mod.imports
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._ctor_name(node)
            if name is None:
                continue
            if name in _NEVER_BOUNDED:
                yield self.finding(
                    mod, node,
                    f"{name} has no capacity bound at all: an unreachable "
                    "consumer grows it until OOM — use a bounded Queue "
                    "with a watermark surfacing utils.limits.Backpressure")
                continue
            kw_name, pos_idx = _QUEUE_CTORS[name]
            bound: Optional[ast.AST] = None
            for kw in node.keywords:
                if kw.arg == kw_name:
                    bound = kw.value
            if bound is None and len(node.args) > pos_idx:
                bound = node.args[pos_idx]
            if bound is None or _is_unbounded_literal(bound):
                yield self.finding(
                    mod, node,
                    f"unbounded {name}() on a buffering layer: overload "
                    "becomes OOM instead of backpressure — pass "
                    f"{kw_name}= (and shed past a watermark with "
                    "utils.limits.Backpressure / utils.health."
                    "AdmissionGate), or justify-suppress a deliberately "
                    "unbounded control-plane queue")


RULES: List[Rule] = [UnboundedQueueRule()]
