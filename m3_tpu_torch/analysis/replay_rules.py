"""Recovery-path batching discipline: cold restart is a data plane.

The hazard class (ROADMAP item 1, closed by the columnar recovery
rebuild): the durability spine's read-back paths — commitlog replay,
snapshot install, fileset bootstrap — quietly regress into per-entry
host loops (`get_or_create` per row, `buffer.write_batch(np.full(...))`
per series) because they only run at restart, where nobody benches
them. At production series counts that is the difference between a
bounded restart and minutes of downtime after kill -9.

Rules:
  per-entry-replay   a loop (or comprehension) on the bootstrap/replay
                     modules that resolves the registry one row at a
                     time (`.get_or_create(` inside the loop body) or
                     appends one series at a time
                     (`.write_batch(np.full(...), ...)`). Batch
                     entrypoints (`get_or_create_batch*`,
                     `lookup_batch`) never match. Functions whose name
                     ends in `_ref` are exempt — they are the retained
                     per-entry ORACLES the batched paths are
                     bit-checked against, never on the recovery path.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from .core import Finding, Module, Rule, qualname

# Modules that ARE the recovery data plane: the scope is deliberately
# narrow (per-row loops elsewhere are other rules' business — e.g.
# hot-loop-under-lock covers the write path).
_REPLAY_FILES = {
    ("storage", "bootstrap.py"),
    ("persist", "commitlog.py"),
    ("persist", "fs.py"),
}

_FULL_FILLERS = {"np.full", "numpy.full"}
_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)


class PerEntryReplayRule(Rule):
    """per-entry-replay: per-row registry/buffer loops on recovery paths."""

    id = "per-entry-replay"
    severity = "error"
    dirs = ("storage", "persist")

    def applies(self, mod: Module) -> bool:
        parts = mod.scope_parts
        return len(parts) >= 2 and (parts[-2], parts[-1]) in _REPLAY_FILES

    @staticmethod
    def _in_ref_oracle(mod: Module, node: ast.AST) -> bool:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and cur.name.endswith("_ref"):
                return True
            cur = mod.parent(cur)
        return False

    @staticmethod
    def _loop_bodies(loop: ast.AST) -> List[ast.AST]:
        """The per-iteration statements/expressions of a loop node."""
        if isinstance(loop, (ast.For, ast.While)):
            return list(loop.body)
        if isinstance(loop, ast.DictComp):
            return [loop.key, loop.value]
        return [loop.elt]  # ListComp / SetComp / GeneratorExp

    def _per_row_call(self, node: ast.AST) -> Optional[str]:
        """Why this call is a per-row recovery mutation, or None."""
        if not isinstance(node, ast.Call):
            return None
        q = qualname(node.func)
        if q is None:
            return None
        tail = q.split(".")[-1]
        if tail == "get_or_create":
            return ("registry .get_or_create per row — resolve the whole "
                    "id column once via get_or_create_batch")
        if tail == "write_batch":
            for arg in node.args:
                if isinstance(arg, ast.Call) and \
                        qualname(arg.func) in _FULL_FILLERS:
                    return ("buffer .write_batch(np.full(...)) per series "
                            "— flatten the tile and append each shard's "
                            "columns once")
        return None

    def check(self, mod: Module) -> Iterator[Finding]:
        flagged = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, _LOOPS):
                continue
            if self._in_ref_oracle(mod, loop):
                continue
            reasons = []
            for part in self._loop_bodies(loop):
                for node in ast.walk(part):
                    reason = self._per_row_call(node)
                    if reason and node not in flagged:
                        flagged.add(node)
                        reasons.append(reason)
            for reason in reasons:
                yield self.finding(
                    mod, loop,
                    f"per-entry loop on a recovery path: {reason}; the "
                    f"restart-to-serving-ready time pays this once per "
                    f"row (retained `_ref` oracles are exempt by name)")


RULES: List[Rule] = [PerEntryReplayRule()]
