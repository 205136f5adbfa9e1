"""Result-plane rendering discipline: query results are a data plane.

The hazard class (ROADMAP item 4, closed by the columnar result-frame
rebuild): serving-path renderers quietly regress into per-SERIES host
materialization — one Python dict per series, one list per sample —
between a fully compiled query and the HTTP socket, because the
renderer "just works" at test sizes. At dashboard result sizes (10k
series x hundreds of steps) that loop IS the response latency: bench
r16 measured the pre-change coordinator renderer at 1.07 responses/sec
with ~1.9s per fat-matrix response, nearly all of it per-series dict +
per-sample format calls downstream of a 5-6.8x compiled query.

Rules:
  per-series-result-dict   a loop (or comprehension) inside a
                           result-path function — name matching
                           render/matrix/vector/result on the
                           coordinator/query/rpc serving tree — that
                           materializes one dict per iteration
                           (`out.append({...})`, a dict-valued
                           comprehension element, or a per-iteration
                           `dict(...)` call fed to an append). Render
                           from the columns instead
                           (query/render.py). Functions whose name
                           contains `_ref` are exempt — they are the
                           retained per-series ORACLES the columnar
                           frames are byte-checked against
                           (render_result_ref), never on the serving
                           path.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional

from .core import Finding, Module, Rule, qualname

# Serving-tree scope: the coordinator HTTP layer, the query engine's
# result surfaces, and the node RPC data plane.
_DIRS = ("coordinator", "query", "rpc")

_NAME_RE = re.compile(r"render|matrix|vector|result", re.IGNORECASE)

_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.GeneratorExp)


class PerSeriesResultDictRule(Rule):
    """per-series-result-dict: per-row dict materialization on query
    result paths."""

    id = "per-series-result-dict"
    severity = "error"
    dirs = _DIRS

    def applies(self, mod: Module) -> bool:
        parts = mod.scope_parts
        return bool(parts) and parts[0] in _DIRS

    @staticmethod
    def _result_fn(mod: Module, node: ast.AST) -> Optional[str]:
        """Enclosing result-path function name, or None (also None when
        any enclosing function is a `_ref` oracle)."""
        cur: Optional[ast.AST] = node
        found = None
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if "_ref" in cur.name:
                    return None
                if found is None and _NAME_RE.search(cur.name):
                    found = cur.name
            cur = mod.parent(cur)
        return found

    @staticmethod
    def _loop_dict(loop: ast.AST) -> Optional[ast.AST]:
        """The per-iteration dict materialization inside `loop`, or
        None: an append/yield of a dict display (or dict(...) call), or
        a comprehension whose element is one."""
        def is_dict(n: ast.AST) -> bool:
            return isinstance(n, ast.Dict) or (
                isinstance(n, ast.Call) and qualname(n.func) == "dict")

        if isinstance(loop, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return loop.elt if is_dict(loop.elt) else None
        for stmt in ast.walk(loop):
            if isinstance(stmt, ast.Call) and \
                    isinstance(stmt.func, ast.Attribute) and \
                    stmt.func.attr == "append" and stmt.args and \
                    is_dict(stmt.args[0]):
                return stmt
            if isinstance(stmt, (ast.Yield, ast.YieldFrom)) and \
                    getattr(stmt, "value", None) is not None and \
                    is_dict(stmt.value):
                return stmt
        return None

    def check(self, mod: Module) -> Iterator[Finding]:
        seen = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, _LOOPS):
                continue
            fn = self._result_fn(mod, loop)
            if fn is None:
                continue
            hit = self._loop_dict(loop)
            if hit is None or id(hit) in seen:
                continue
            seen.add(id(hit))
            yield self.finding(
                mod, loop,
                f"per-series dict materialization in result path "
                f"{fn}(): one Python dict per row between the value "
                f"matrix and the wire is the response-latency floor at "
                f"dashboard sizes — render from the columns "
                f"(query/render.py) and keep per-series loops only in "
                f"retained `_ref` oracles")


RULES: List[Rule] = [PerSeriesResultDictRule()]
