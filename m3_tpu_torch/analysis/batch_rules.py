"""Exception-safety of all-or-nothing batch loops.

The hazard class (aggregator dispatch_timed_batch): a
function validates its input columns up front — promising callers that
a rejected frame ingests NOTHING — then zips the columns through a loop
of per-element side effects. Any element the validator didn't cover
raises mid-loop and leaves a partially-applied prefix behind, which the
caller's error accounting (and a sender retry) double-counts.

The rule triggers only where the contract is visible in the code: a
pre-loop `all(isinstance(...) for ...)` validation over at least one of
the zipped columns. Then it demands the validation actually be
complete:

  batch-partial-ingest   (a) a validator admits bytearray/memoryview
                         but the loop consumes the raw elements (the
                         lru_cache/TypeError class — normalize to bytes
                         after the check); (b) a zipped column reaches
                         the side-effect loop with neither an element
                         validation nor a raising coercion
                         (np.asarray(col) + dtype check, [T(x) for x]).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from .core import Finding, Module, Rule, qualname

_MUTABLE_BUFFERS = {"bytearray", "memoryview"}
_COERCERS = {"bytes", "int", "float", "str", "tuple"}
_ARRAY_COERCERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                   "asarray", "array"}


def _isinstance_types(call: ast.Call) -> Set[str]:
    """Type names from isinstance(x, T) / isinstance(x, (T1, T2))."""
    if len(call.args) != 2:
        return set()
    t = call.args[1]
    names: Set[str] = set()
    for node in [t] if not isinstance(t, ast.Tuple) else t.elts:
        q = qualname(node)
        if q:
            names.add(q.split(".")[-1])
    return names


class _ColumnFacts:
    """Per-name evidence collected between function entry and the loop."""

    def __init__(self):
        self.validated_types: Set[str] = set()
        self.normalized = False   # re-bound through an element conversion
        self.coerced_array = False  # re-bound through np.asarray/np.array
        self.asarray_bare = False  # asarray WITHOUT a dtype: coerces a bad
        #                            column to strings/objects silently
        self.dtype_checked = False  # a raising `if col.dtype...` guard


def _zip_loops(fn: ast.FunctionDef) -> List[Tuple[ast.For, List[str]]]:
    """(loop, zipped column names) for side-effecting zip loops."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.For):
            continue
        it = node.iter
        if not (isinstance(it, ast.Call) and qualname(it.func) == "zip"):
            continue
        names = [a.id for a in it.args if isinstance(a, ast.Name)]
        if len(names) < 2:
            continue
        has_call = any(isinstance(n, ast.Call) for b in node.body
                       for n in ast.walk(b))
        if has_call:
            out.append((node, names))
    return out


def _collect_facts(fn: ast.FunctionDef, before_line: int,
                   names: Set[str]) -> Dict[str, _ColumnFacts]:
    facts = {n: _ColumnFacts() for n in names}
    for node in ast.walk(fn):
        line = getattr(node, "lineno", None)
        if line is None or line >= before_line:
            continue
        # all(isinstance(v, T) for v in col)
        if (isinstance(node, ast.Call) and qualname(node.func) == "all"
                and node.args
                and isinstance(node.args[0], ast.GeneratorExp)):
            gen = node.args[0]
            inner = gen.elt
            if (isinstance(inner, ast.Call)
                    and qualname(inner.func) == "isinstance"):
                for comp in gen.generators:
                    src = comp.iter
                    if isinstance(src, ast.Name) and src.id in facts:
                        facts[src.id].validated_types |= \
                            _isinstance_types(inner)
        # col = [T(v) for v in col]   /   col = np.asarray(col, ...)
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if not (isinstance(target, ast.Name)
                        and target.id in facts):
                    continue
                f = facts[target.id]
                v = node.value
                if isinstance(v, ast.ListComp):
                    elt = v.elt
                    # plain conversion or conditional conversion
                    # (`bytes(m) if ... else m`)
                    if isinstance(elt, ast.IfExp):
                        cands = [elt.body, elt.orelse]
                    else:
                        cands = [elt]
                    if any(isinstance(c, ast.Call)
                           and qualname(c.func) in _COERCERS
                           for c in cands):
                        f.normalized = True
                elif isinstance(v, ast.Call):
                    q = qualname(v.func) or ""
                    if q in _ARRAY_COERCERS:
                        _note_asarray(f, v)
                    elif isinstance(v.func, ast.Attribute) and \
                            v.func.attr == "tolist":
                        # x.tolist() converts an ndarray — treat the
                        # result as coerced only if x was already coerced
                        inner = v.func.value
                        if (isinstance(inner, ast.Call)
                                and (qualname(inner.func) or "")
                                in _ARRAY_COERCERS):
                            _note_asarray(f, inner)
        # if col.dtype... : raise — the check that makes a BARE asarray
        # rebind actually reject a silently-stringified mixed column
        if isinstance(node, ast.If) and any(
                isinstance(n, ast.Raise) for n in ast.walk(node)):
            for t in ast.walk(node.test):
                if (isinstance(t, ast.Attribute) and t.attr == "dtype"
                        and isinstance(t.value, ast.Name)
                        and t.value.id in facts):
                    facts[t.value.id].dtype_checked = True
    for f in facts.values():
        if f.asarray_bare and f.dtype_checked:
            f.coerced_array = True
            f.normalized = True
    return facts


def _note_asarray(f: _ColumnFacts, call: ast.Call):
    """An np.asarray/np.array rebind coerces-and-raises only with an
    explicit dtype; a bare asarray silently coerces mixed input to a
    string/object array and needs a separate dtype check to count."""
    has_dtype = (len(call.args) >= 2
                 or any(kw.arg == "dtype" for kw in call.keywords))
    if has_dtype:
        f.coerced_array = True
        f.normalized = True
    else:
        f.asarray_bare = True


class BatchPartialIngestRule(Rule):
    """batch-partial-ingest: all-or-nothing batch loops whose pre-loop
    validation leaves a column able to raise mid-loop."""

    id = "batch-partial-ingest"
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        for fn in [n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.FunctionDef)]:
            yield from self._check_fn(mod, fn)

    def _check_fn(self, mod: Module, fn: ast.FunctionDef) -> Iterator[Finding]:
        for loop, names in _zip_loops(fn):
            facts = _collect_facts(fn, loop.lineno, set(names))
            # the contract gate: at least one zipped column carries an
            # explicit element validation before the loop
            if not any(f.validated_types for f in facts.values()):
                continue
            # the function must actually promise rejection (raise) up front
            raises = [n for n in ast.walk(fn) if isinstance(n, ast.Raise)
                      and getattr(n, "lineno", loop.lineno) < loop.lineno]
            if not raises:
                continue
            for name in names:
                f = facts[name]
                admits = f.validated_types & _MUTABLE_BUFFERS
                if admits and not f.normalized:
                    yield self.finding(
                        mod, loop,
                        f"all-or-nothing batch loop consumes column "
                        f"{name!r} whose validator admits "
                        f"{'|'.join(sorted(admits))} without normalizing "
                        "to bytes — downstream hashing/caching raises "
                        "mid-loop, leaving a partial prefix applied "
                        f"(normalize after the isinstance check)")
                elif not f.validated_types and not f.normalized:
                    yield self.finding(
                        mod, loop,
                        f"all-or-nothing batch loop consumes column "
                        f"{name!r} with no element validation or raising "
                        "coercion before the loop — a bad element raises "
                        "mid-loop, leaving a partial prefix applied "
                        "(np.asarray + dtype check, or validate elements "
                        "up front)")


RULES: List[Rule] = [BatchPartialIngestRule()]
