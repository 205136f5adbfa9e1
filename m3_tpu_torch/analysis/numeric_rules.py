"""Numerics-plane static analysis: dtype dataflow + padding-sentinel
taint over the array code in ops/, parallel/ and query/plan.py — the
static half of the PR-12 pattern (static pass + opt-in runtime witness,
here utils/numwatch.py) applied to the exact numeric contracts the
kernels enforce by convention: host-exact f64 counter sums, residual-
space f32 kernels, the double-f32 `value2` ranking split, NaN row
padding and -1 index sentinels that must never leak into aggregates.

Rules (per-function forward abstract interpretation, two passes so
loop-carried assignments converge; functions named `*_ref` are the
retained interpreter ORACLES and are exempt by name):

  f64-downcast-on-exact-path
      An expression KNOWN to live on the f64 plane (np default
      constructors, `.astype(np.float64)`, the `temporal.center`
      baseline, f64-dtyped asarray) downcast to f32 with no residual
      companion. Difference-space values (`a - b`) are downcast-safe by
      the repo's contract (residuals are small), and a source that also
      feeds a subtraction (the `hi = g.astype(f32); lo = g - hi` exact
      double-f32 split) is a sanctioned split — everything else silently
      drops the exactness the f64 plane carries (the counter-sum
      contract of query/executor.py / parallel/compile.py).

  f64-reduce-of-f32
      A reduction upcast to f64 AFTER the value already lives on an f32
      plane (`x32.astype(np.float64).sum()`, `np.sum(x32,
      dtype=np.float64)`). Upcasting past accumulation input recovers
      nothing: the exact contract requires residual prep
      (temporal.center) BEFORE the device reduce; residual-provenance
      values are exempt.

  abs-f32-comparison
      A comparison on a LOSSY f32 plane (one downcast from known f64).
      At counter magnitudes (1e9+) f32 granularity is ~64: a threshold
      comparison there flips sample presence — the exact bug class the
      interpreter-fallback policy (plan.py `_abs_space`) exists to
      dodge. Compare on the f64 plane or rank on the double-f32 split.

  pad-lane-aggregate
      A NaN-padded array (np/jnp.full with NaN, `_pad_grid`) reaching
      `sum`/`mean`/`max`/`min`/segment ops/`psum`/`reduce_window`
      without an intervening mask/`where` or a pad-neutral op
      (`nansum`...). Padding lanes folding into an aggregate is the
      historical psum-leak shape the padding contracts
      (`jnp.where(mask, v, 0.0)` before every segment reduce) guard.

  unmasked-sentinel-gather
      A -1-padded index array (np/jnp.full with -1, `np.where(c, idx,
      -1)`) reaching a gather (`arr[idx]`, `take`, `take_along_axis`),
      a segment reduce's ids, or `np.add.at` without an intervening
      clamp (`jnp.maximum(idx, 0)` / `clip`) or mask: an unclamped -1
      wraps to the LAST row (numpy) or drops silently (jax), replaying
      garbage into live lanes — the vv-gather leak shape
      parallel/compile.py's `valid`-mask contract guards.

The runtime witness acceptance set (`accepted_witness`) is derived
statically from the SAME modules: a witness site may report NaN in live
output lanes only when its modules provably treat NaN as the missing-
value domain (an `isfinite`/`isnan` mask or a `where(..., nan)`
constructor), and inf only when its op table emits an unguarded divide.
Padding-lane findings ("pad-finite"/"pad-nonzero") are NEVER accepted —
that is the contract analysis/witness.py (numerics) enforces under the plan
and agg smokes.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .core import Finding, Module, Rule, qualname

# ------------------------------------------------------------ dtype tokens

_F64_TOKENS = {"np.float64", "numpy.float64", "jnp.float64",
               "jax.numpy.float64", "np.double", "numpy.double", "float64"}
_F32_TOKENS = {"np.float32", "numpy.float32", "jnp.float32",
               "jax.numpy.float32", "float32"}
_INT_TOKENS = {"np.int32", "np.int64", "numpy.int32", "numpy.int64",
               "jnp.int32", "jnp.int64", "np.uint32", "np.uint64",
               "int32", "int64", "uint32", "uint64", "np.intp", "int"}
_NP_ROOTS = {"np", "numpy"}
_JNP_ROOTS = {"jnp"}

# Known numerics-plane helper signatures: the dtype contract of the
# residual-split machinery (docstring-pinned in ops/temporal.py). Values
# are tuples of (dtype, provenance) per returned element; "arg0" means
# the call preserves its first argument's plane.
_KNOWN_SIGS: Dict[str, object] = {
    "center": (("f32", frozenset({"resid"})), ("f64", frozenset())),
    "center_math": (("f32", frozenset({"resid"})), ("f32", frozenset())),
    "rate_inputs": (("f32", frozenset({"resid"})), ("bool", frozenset()),
                    ("lossy32", frozenset())),
    "rate_inputs_math": (("f32", frozenset({"resid"})),
                         ("bool", frozenset()), ("f32", frozenset())),
    "_pad_grid": "arg0",
}

_PRESERVE_CALLS = {
    "maximum", "minimum", "clip", "abs", "absolute", "sqrt", "exp", "log",
    "floor", "ceil", "round", "negative", "transpose", "reshape",
    "ascontiguousarray", "squeeze", "ravel", "broadcast_to", "repeat",
    "tile", "flip", "sort", "cumsum",
}

_BOOL_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
               "logical_not", "any", "all"}

_REDUCE_ATTRS = {"sum", "mean", "max", "min", "prod", "dot", "matmul",
                 "segment_sum", "segment_max", "segment_min",
                 "segment_prod", "psum", "pmin", "pmax", "reduce_window",
                 "_wsum", "average"}

_NAN_NEUTRAL = {"nansum", "nanmean", "nanmax", "nanmin", "nanquantile",
                "nan_to_num", "nanstd", "nanvar"}


def _module_dtype_aliases(mod: Module) -> Dict[str, str]:
    """Module-level dtype alias bindings (`_F32 = jnp.float32`)."""
    out: Dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            q = qualname(node.value)
            if q in _F64_TOKENS:
                out[node.targets[0].id] = "f64"
            elif q in _F32_TOKENS:
                out[node.targets[0].id] = "f32"
            elif q in _INT_TOKENS:
                out[node.targets[0].id] = "int"
    return out


def _dtype_token(node: Optional[ast.AST],
                 aliases: Dict[str, str]) -> Optional[str]:
    """Resolve a dtype expression to 'f64'/'f32'/'int', else None."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        v = node.value
        if v in ("float64", "double"):
            return "f64"
        if v == "float32":
            return "f32"
        if v.startswith(("int", "uint")):
            return "int"
        return None
    q = qualname(node)
    if q is None:
        return None
    if q in _F64_TOKENS:
        return "f64"
    if q in _F32_TOKENS:
        return "f32"
    if q in _INT_TOKENS:
        return "int"
    return aliases.get(q)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_nan_const(node: ast.AST) -> bool:
    q = qualname(node)
    if q in ("np.nan", "numpy.nan", "jnp.nan", "math.nan", "np.NaN",
             "numpy.NaN"):
        return True
    if isinstance(node, ast.Call) and qualname(node.func) == "float" and \
            node.args and isinstance(node.args[0], ast.Constant) and \
            str(node.args[0].value).lower() == "nan":
        return True
    return False


def _is_neg1_const(node: ast.AST) -> bool:
    return (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and node.operand.value == 1)


def _sub_operand_names(fn: ast.AST) -> Set[str]:
    """Names appearing as operands of a subtraction anywhere in `fn` —
    the residual-capture evidence the downcast allowance keys on."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                for n in ast.walk(side):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
    return out


def _iter_own_functions(mod: Module) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if "_ref" in node.name:
                continue  # retained interpreter oracles, exempt by name
            yield node


class _NumericScope(Rule):
    """Shared applies(): the numerics plane is ops/, parallel/, and the
    plan IR (query/plan.py) — not the host label algebra elsewhere in
    query/."""

    def applies(self, mod: Module) -> bool:
        sp = mod.scope_parts
        if not sp:
            return False
        if sp[0] in ("ops", "parallel"):
            return True
        return sp == ("query", "plan.py")


# =====================================================  dtype dataflow rule


_UNKNOWN = ("unknown", frozenset())


def _promote(a: Tuple[str, FrozenSet[str]],
             b: Tuple[str, FrozenSet[str]]) -> Tuple[str, FrozenSet[str]]:
    """Binary-op promotion on the lattice. Python scalars are 'weak'
    (value-based casting: they adopt the array operand's plane) and
    'unknown' is absorbing — the pass only ever reasons about planes it
    can PROVE."""
    da, db = a[0], b[0]
    prov = a[1] | b[1]
    if "unknown" in (da, db):
        return ("unknown", prov)
    if da == "weak":
        return (db, prov)
    if db == "weak":
        return (da, prov)
    for d in ("f64", "lossy32", "f32", "int", "bool"):
        if d in (da, db):
            return (d, prov)
    return ("unknown", frozenset())


class _DtypeInterp:
    """One function's forward dtype pass: env maps names to
    (plane, provenance) where plane is one of f64/f32/lossy32/int/bool/
    weak/unknown and provenance tags carry 'resid' (residual-space) and
    'up32' (f64 that was upcast FROM f32 after accumulation input)."""

    def __init__(self, mod: Module, fn: ast.AST, aliases: Dict[str, str]):
        self.mod = mod
        self.fn = fn
        self.aliases = aliases
        self.env: Dict[str, Tuple[str, FrozenSet[str]]] = {}
        self.sub_names = _sub_operand_names(fn)
        self.violations: List[Tuple[str, ast.AST, str]] = []

    # -- expression dtype -------------------------------------------------

    def dt(self, node: ast.AST) -> Tuple[str, FrozenSet[str]]:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, _UNKNOWN)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return ("bool", frozenset())
            if isinstance(node.value, (int, float)):
                return ("weak", frozenset())
            return _UNKNOWN
        if isinstance(node, ast.UnaryOp):
            return self.dt(node.operand)
        if isinstance(node, ast.BinOp):
            out = _promote(self.dt(node.left), self.dt(node.right))
            if isinstance(node.op, ast.Sub):
                # difference-space: residual by construction
                return (out[0], out[1] | {"resid"})
            return out
        if isinstance(node, ast.Compare):
            return ("bool", frozenset())
        if isinstance(node, ast.Subscript):
            return self.dt(node.value)
        if isinstance(node, ast.IfExp):
            return _promote(self.dt(node.body), self.dt(node.orelse))
        if isinstance(node, ast.Call):
            return self._call_dt(node)
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "real"):
                return self.dt(node.value)
            return _UNKNOWN
        return _UNKNOWN

    def _astype_result(self, call: ast.Call, src: ast.AST,
                       tok: Optional[str]) -> Tuple[str, FrozenSet[str]]:
        """Shared result/violation logic for every cast spelling:
        `.astype(t)`, `np.float32(x)`, `asarray(x, dtype=t)`."""
        sdt, sprov = self.dt(src)
        if tok == "f32":
            if sdt == "f64":
                if "resid" in sprov:
                    # residual-space values are small: downcast-safe
                    return ("f32", frozenset({"resid"}))
                if not self._downcast_allowed(src):
                    self.violations.append((
                        "f64-downcast-on-exact-path", call,
                        "f64 plane silently downcast to f32 — the exact "
                        "contract (host-f64 counter sums, residual-space "
                        "kernels) is dropped here; split residuals first "
                        "(temporal.center) or keep the f64 plane "
                        "(double-f32 `value2` split for ranking)"))
                return ("lossy32", frozenset())
            return ("f32", sprov & {"resid"})
        if tok == "f64":
            prov: Set[str] = set(sprov & {"resid"})
            if sdt in ("f32", "lossy32"):
                prov.add("up32")
            return ("f64", frozenset(prov))
        if tok == "int":
            return ("int", frozenset())
        return _UNKNOWN

    def _downcast_allowed(self, src: ast.AST) -> bool:
        """An f64->f32 downcast is sanctioned when it is not SILENT:
        the f64 source also feeds a subtraction in this function (the
        residual/double-f32 split captures what the downcast drops), or
        the f64 name stays live beside the f32 copy (read anywhere
        outside this cast — the `(resid, base, base32)` shape, where the
        exact plane rides along and the host finish consumes it)."""
        if isinstance(src, ast.BinOp) and isinstance(src.op, ast.Sub):
            return True
        src_names: Set[str] = set()
        in_src = 0
        for n in ast.walk(src):
            if isinstance(n, ast.Name):
                src_names.add(n.id)
                in_src += 1
        if src_names & self.sub_names:
            return True
        total = 0
        for n in ast.walk(self.fn):
            if isinstance(n, ast.Name) and n.id in src_names and \
                    isinstance(n.ctx, ast.Load):
                total += 1
        return total > in_src

    def _call_dt(self, call: ast.Call) -> Tuple[str, FrozenSet[str]]:
        q = qualname(call.func)
        # method casts: x.astype(t)
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "astype" and call.args:
            tok = _dtype_token(call.args[0], self.aliases)
            return self._astype_result(call, call.func.value, tok)
        # method reductions on ANY receiver form (x.sum(), chained
        # x.astype(f64).sum()); the np.sum(...) dotted spelling is
        # handled below with its dtype kwarg
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr in ("sum", "mean", "prod") and \
                (q is None or
                 q.split(".")[0] not in (*_NP_ROOTS, *_JNP_ROOTS, "jax")):
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            self._check_reduce(call, call.func.value, tok)
            if tok:
                return (tok, frozenset())
            return self.dt(call.func.value)
        if q is None:
            return _UNKNOWN
        head, _, last = q.rpartition(".")
        root = q.split(".")[0]
        np_like = root in _NP_ROOTS
        jnp_like = root in _JNP_ROOTS or root == "jax"
        # dtype-constructor casts: np.float32(x)
        if q in _F32_TOKENS and call.args:
            return self._astype_result(call, call.args[0], "f32")
        if q in _F64_TOKENS and call.args:
            return self._astype_result(call, call.args[0], "f64")
        if q in _INT_TOKENS and call.args:
            return ("int", frozenset())
        if not (np_like or jnp_like) or not head:
            # known residual-machinery helpers (bare or dotted)
            sig = _KNOWN_SIGS.get(last if head else q)
            if sig == "arg0" and call.args:
                return self.dt(call.args[0])
            if isinstance(sig, tuple):
                return sig[0]
            return _UNKNOWN
        sig = _KNOWN_SIGS.get(last)
        if sig == "arg0" and call.args:
            return self.dt(call.args[0])
        if isinstance(sig, tuple):
            return sig[0]
        if last in _BOOL_CALLS:
            return ("bool", frozenset())
        if last in ("asarray", "array", "ascontiguousarray"):
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            if tok and call.args:
                return self._astype_result(call, call.args[0], tok)
            return self.dt(call.args[0]) if call.args else _UNKNOWN
        if last in ("zeros", "ones", "empty"):
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            if tok:
                return (tok, frozenset())
            if _kw(call, "dtype") is not None:
                return _UNKNOWN
            return ("f64" if np_like else "f32", frozenset())
        if last == "full":
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            if tok:
                return (tok, frozenset())
            if _kw(call, "dtype") is not None or len(call.args) < 2:
                return _UNKNOWN
            fill = call.args[1]
            if len(call.args) > 2:  # positional dtype
                tok = _dtype_token(call.args[2], self.aliases)
                if tok:
                    return (tok, frozenset())
                return _UNKNOWN
            if _is_nan_const(fill) or (isinstance(fill, ast.Constant)
                                       and isinstance(fill.value, float)):
                return ("f64" if np_like else "f32", frozenset())
            if _is_neg1_const(fill) or (isinstance(fill, ast.Constant)
                                        and isinstance(fill.value, int)):
                return ("int", frozenset())
            return _UNKNOWN
        if last in ("zeros_like", "ones_like", "full_like", "empty_like"):
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            if tok:
                return (tok, frozenset())
            return self.dt(call.args[0]) if call.args else _UNKNOWN
        if last == "arange":
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            if tok:
                return (tok, frozenset())
            if any(isinstance(a, ast.Constant) and
                   isinstance(a.value, float) for a in call.args):
                return ("f64" if np_like else "f32", frozenset())
            return ("int", frozenset())
        if last == "where" and len(call.args) == 3:
            return _promote(self.dt(call.args[1]), self.dt(call.args[2]))
        if last in ("concatenate", "stack", "vstack", "hstack"):
            if call.args and isinstance(call.args[0], (ast.List, ast.Tuple)):
                out = _UNKNOWN
                first = True
                for el in call.args[0].elts:
                    out = self.dt(el) if first else _promote(out,
                                                             self.dt(el))
                    first = False
                return out
            return _UNKNOWN
        if last in _PRESERVE_CALLS and call.args:
            return self.dt(call.args[0])
        if last in ("sum", "mean", "prod"):
            tok = _dtype_token(_kw(call, "dtype"), self.aliases)
            self._check_reduce(call,
                               call.args[0] if call.args else None, tok)
            if tok:
                return (tok, frozenset())
            return self.dt(call.args[0]) if call.args else _UNKNOWN
        return _UNKNOWN

    # -- the f64-reduce check ---------------------------------------------

    def _check_reduce(self, call: ast.Call, src: Optional[ast.AST],
                      tok: Optional[str]):
        """np.sum(x, dtype=f64) / x64.sum() where x64 was upcast from an
        accumulated f32 plane: the f64 exactness cannot be recovered
        after the fact."""
        if src is None:
            return
        sdt, sprov = self.dt(src)
        lossy_src = (tok == "f64" and sdt in ("f32", "lossy32")
                     and "resid" not in sprov)
        upcast_src = (tok is None and sdt == "f64" and "up32" in sprov)
        if lossy_src or upcast_src:
            self.violations.append((
                "f64-reduce-of-f32", call,
                "f64 reduction fed from an f32 plane — upcasting after "
                "the value lived in f32 recovers nothing; prep residuals "
                "(temporal.center) before the device accumulation and "
                "finish the f64 baseline on the host"))

    # -- statements -------------------------------------------------------

    def run(self):
        for _ in range(2):
            self.violations.clear()
            for stmt in self.fn.body:
                self._stmt(stmt)

    def _assign(self, target: ast.AST, val: Tuple[str, FrozenSet[str]]):
        if isinstance(target, ast.Name):
            self.env[target.id] = val

    def _assign_call_tuple(self, target: ast.AST, call: ast.Call) -> bool:
        """`resid, base = center(g)` — known tuple signatures unpack."""
        if not isinstance(target, (ast.Tuple, ast.List)):
            return False
        q = qualname(call.func)
        if q is None:
            return False
        sig = _KNOWN_SIGS.get(q.rpartition(".")[2])
        if not isinstance(sig, tuple) or len(sig) != len(target.elts):
            return False
        for el, v in zip(target.elts, sig):
            self._assign(el, v)
        return True

    def _stmt(self, stmt: ast.AST):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs analyze on their own
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is None:
                return
            self._expr(value)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(value, ast.Call) and \
                        self._assign_call_tuple(t, value):
                    continue
                if isinstance(t, (ast.Tuple, ast.List)) and \
                        isinstance(value, (ast.Tuple, ast.List)) and \
                        len(t.elts) == len(value.elts):
                    for te, ve in zip(t.elts, value.elts):
                        self._assign(te, self.dt(ve))
                    continue
                self._assign(t, self.dt(value))
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test)
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter)
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.With):
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in [*stmt.body, *stmt.orelse, *stmt.finalbody]:
                self._stmt(s)
            for h in stmt.handlers:
                for s in h.body:
                    self._stmt(s)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _expr(self, node: ast.AST):
        # evaluate every call (cast/reduce checks fire inside dt) and
        # every comparison (the lossy-f32 check)
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self.dt(n)
            elif isinstance(n, ast.Compare) and any(
                    isinstance(op, (ast.Lt, ast.Gt, ast.LtE, ast.GtE))
                    for op in n.ops):
                sides = [n.left, *n.comparators]
                if any(self.dt(s)[0] == "lossy32" for s in sides):
                    self.violations.append((
                        "abs-f32-comparison", n,
                        "ordering comparison on a lossy f32 downcast of "
                        "an f64 plane — f32 granularity at counter "
                        "magnitudes (ulp 64 at 1e9) flips sample "
                        "presence; compare on the f64 plane "
                        "(interpreter policy, plan.py _abs_space) or "
                        "rank on the exact double-f32 split"))


class DtypeDataflowRule(_NumericScope):
    """f64-downcast-on-exact-path / f64-reduce-of-f32 /
    abs-f32-comparison: forward dtype-lattice dataflow over every
    function of the numerics plane."""

    id = "numeric-dtype"  # umbrella; findings carry their specific ids
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        aliases = _module_dtype_aliases(mod)
        emitted: Set[Tuple[str, int, str]] = set()
        for fn in _iter_own_functions(mod):
            interp = _DtypeInterp(mod, fn, aliases)
            interp.run()
            for rule_id, node, msg in interp.violations:
                line = getattr(node, "lineno", fn.lineno)
                key = (rule_id, line, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield Finding(rule_id, mod.relpath, line, msg, self.severity)


# ==================================================== sentinel taint rule


_GATHER_CALLS = {"take", "take_along_axis"}
_CLAMP_CALLS = {"maximum", "clip"}
_SEGMENT_CALLS = {"segment_sum", "segment_max", "segment_min",
                  "segment_prod"}


class _SentinelInterp:
    """Forward sentinel-taint pass: env maps names to taint subsets of
    {'nan', 'neg1'}. `where`/mask ops cleanse, clamps drop 'neg1',
    nan-neutral reductions pass; tainted values reaching an aggregate or
    a gather index are findings."""

    def __init__(self, mod: Module, fn: ast.AST):
        self.mod = mod
        self.fn = fn
        self.env: Dict[str, Set[str]] = {}
        self.violations: List[Tuple[str, ast.AST, str]] = []

    def taint(self, node: ast.AST) -> Set[str]:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, set())
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, ast.Compare):
            return set()  # masks are clean
        if isinstance(node, ast.Subscript):
            return self.taint(node.value)
        if isinstance(node, ast.IfExp):
            return self.taint(node.body) | self.taint(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            out: Set[str] = set()
            for el in node.elts:
                out |= self.taint(el)
            return out
        if isinstance(node, ast.Call):
            return self._call_taint(node)
        if isinstance(node, ast.Attribute):
            if node.attr == "T":
                return self.taint(node.value)
            return set()
        return set()

    def _call_taint(self, call: ast.Call) -> Set[str]:
        q = qualname(call.func)
        last = q.rpartition(".")[2] if q else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        if last in ("full", "full_like"):
            fill_pos = 1  # (shape, fill) and (like, fill) alike
            if len(call.args) > fill_pos:
                fill = call.args[fill_pos]
                if _is_nan_const(fill):
                    return {"nan"}
                if _is_neg1_const(fill):
                    return {"neg1"}
            return set()
        if last == "where" and len(call.args) == 3:
            # where() is the sanctioned mask: arms are cleansed — UNLESS
            # an arm is the -1 sentinel itself (sentinel construction,
            # plan.py _packed_cols).
            if any(_is_neg1_const(a) for a in call.args[1:]):
                return {"neg1"}
            return set()
        if last in _BOOL_CALLS or last in _NAN_NEUTRAL:
            return set()
        if last in _CLAMP_CALLS and call.args:
            # maximum(idx, 0) / clip(idx, 0, hi): the -1 sentinel can no
            # longer reach a gather; NaN still propagates through max.
            return self.taint(call.args[0]) - {"neg1"}
        if last == "_pad_grid" or last.endswith("pad_grid"):
            return {"nan"}
        if last in ("concatenate", "stack", "vstack", "hstack") and \
                call.args:
            return self.taint(call.args[0])
        if last == "astype" and isinstance(call.func, ast.Attribute):
            return self.taint(call.func.value)
        if last in ("reshape", "ravel", "transpose", "squeeze", "copy",
                    "broadcast_to", "repeat", "tile"):
            src = (call.func.value if isinstance(call.func, ast.Attribute)
                   else (call.args[0] if call.args else None))
            return self.taint(src) if src is not None else set()
        return set()

    # -- sinks ------------------------------------------------------------

    def _check_call_sinks(self, call: ast.Call):
        q = qualname(call.func)
        last = q.rpartition(".")[2] if q else (
            call.func.attr if isinstance(call.func, ast.Attribute) else "")
        if last in _NAN_NEUTRAL:
            return
        # aggregates: dotted np/jnp/lax forms and .sum()-style methods
        if last in _REDUCE_ATTRS:
            srcs: List[ast.AST] = list(call.args)
            if isinstance(call.func, ast.Attribute) and q is None:
                srcs.append(call.func.value)
            elif isinstance(call.func, ast.Attribute) and q and \
                    q.split(".")[0] not in (*_NP_ROOTS, *_JNP_ROOTS,
                                            "jax", "lax"):
                srcs.append(call.func.value)  # x.sum() on a local name
            data_srcs = srcs if last not in _SEGMENT_CALLS else srcs[:1]
            for src in data_srcs:
                if "nan" in self.taint(src):
                    self.violations.append((
                        "pad-lane-aggregate", call,
                        f"NaN-padded array reaches `{last}` without an "
                        "intervening mask/`where` — padding lanes fold "
                        "into the aggregate (the psum padding-leak "
                        "shape); mask first (`jnp.where(mask, v, 0.0)`, "
                        "the padding contract) or use a nan-neutral op"))
                    break
            if last in _SEGMENT_CALLS and len(call.args) > 1:
                if "neg1" in self.taint(call.args[1]):
                    self.violations.append((
                        "unmasked-sentinel-gather", call,
                        f"-1-padded ids reach `{last}` unclamped — "
                        "sentinel rows silently drop (jax) or wrap "
                        "(numpy); clamp (`jnp.maximum(ids, 0)`) and "
                        "mask the padded lanes"))
        if last in _GATHER_CALLS:
            idx = None
            if isinstance(call.func, ast.Attribute) and q is None:
                idx = call.args[0] if call.args else None
            elif len(call.args) > 1:
                idx = call.args[1]
            elif call.args:
                idx = call.args[0]
            if idx is not None and "neg1" in self.taint(idx):
                self.violations.append((
                    "unmasked-sentinel-gather", call,
                    f"-1-padded index array reaches `{last}` unclamped — "
                    "the sentinel gathers the LAST row's live values "
                    "into padding lanes; clamp (`jnp.maximum(idx, 0)`) "
                    "and mask with the validity lanes "
                    "(parallel/compile.py `valid` contract)"))
        if last == "at" and q and q.endswith(".add.at") and \
                len(call.args) > 1 and "neg1" in self.taint(call.args[1]):
            self.violations.append((
                "unmasked-sentinel-gather", call,
                "-1-padded index array reaches `np.add.at` — index -1 "
                "WRAPS to the last row on the host, folding padding "
                "into a live lane; filter or clamp the sentinel first"))

    def _check_subscript_sink(self, node: ast.Subscript):
        if not isinstance(node.ctx, ast.Load):
            return
        sl = node.slice
        idx_exprs = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for e in idx_exprs:
            if isinstance(e, ast.Slice):
                continue
            if "neg1" in self.taint(e):
                self.violations.append((
                    "unmasked-sentinel-gather", node,
                    "gather indexed by a -1-padded array without a "
                    "clamp — the -1 sentinel wraps to the LAST row, "
                    "replaying its live values into padding lanes (the "
                    "vv-gather leak); use "
                    "`arr[jnp.maximum(idx, 0)]` + a `valid` mask"))
                return

    # -- statements -------------------------------------------------------

    def run(self):
        for _ in range(2):
            self.violations.clear()
            for stmt in self.fn.body:
                self._stmt(stmt)

    def _assign(self, target: ast.AST, taint: Set[str]):
        if isinstance(target, ast.Name):
            if taint:
                self.env[target.id] = set(taint)
            else:
                self.env.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign(el, taint)

    def _stmt(self, stmt: ast.AST):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is None:
                return
            self._expr(value)
            taint = self.taint(value)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(t, ast.Subscript):
                    self._expr(t.value)
                    continue  # slice stores keep the target's taint
                self._assign(t, taint)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test)
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter)
            self._assign(stmt.target, self.taint(stmt.iter))
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.With):
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for s in [*stmt.body, *stmt.orelse, *stmt.finalbody]:
                self._stmt(s)
            for h in stmt.handlers:
                for s in h.body:
                    self._stmt(s)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _expr(self, node: ast.AST):
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self._check_call_sinks(n)
            elif isinstance(n, ast.Subscript):
                self._check_subscript_sink(n)


class SentinelTaintRule(_NumericScope):
    """pad-lane-aggregate / unmasked-sentinel-gather: NaN row padding
    and -1 index sentinels must meet a mask/`where`/clamp before any
    aggregate or gather consumes them."""

    id = "sentinel-taint"  # umbrella; findings carry their specific ids
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        emitted: Set[Tuple[str, int, str]] = set()
        for fn in _iter_own_functions(mod):
            interp = _SentinelInterp(mod, fn)
            interp.run()
            for rule_id, node, msg in interp.violations:
                line = getattr(node, "lineno", fn.lineno)
                key = (rule_id, line, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield Finding(rule_id, mod.relpath, line, msg, self.severity)


# ================================================  witness acceptance set


# Runtime witness sites (utils/numwatch.py observation points) -> the
# modules whose static shapes decide which witness kinds are ACCEPTED
# there. analysis/witness.py (numerics) asserts witnessed ⊆ accepted.
WITNESS_SITES: Dict[str, Tuple[str, ...]] = {
    "plan": ("parallel/compile.py", "ops/temporal.py", "ops/series_agg.py"),
    "agg_flush": ("parallel/agg_flush.py", "ops/aggregation.py"),
}


def _module_nan_aware(tree: ast.AST) -> bool:
    """The module provably treats NaN as its missing-value domain: an
    isnan/isfinite mask, or a where(...) whose arm is the NaN
    constant."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            q = qualname(node.func) or ""
            last = q.rpartition(".")[2]
            if last in ("isnan", "isfinite"):
                return True
            if last == "where" and any(_is_nan_const(a) for a in node.args):
                return True
    return False


def _module_has_divide(tree: ast.AST) -> bool:
    """The module's op table emits an unguarded divide (inf is a
    reachable, PromQL-legal output value: `x / 0` is +Inf): numpy's and
    jnp's `divide`/`true_divide`, torch's `div`."""
    for node in ast.walk(tree):
        q = qualname(node)
        if q and q.rpartition(".")[2] in ("divide", "true_divide", "div"):
            return True
    return False


def accepted_witness(root: str = "m3_tpu_torch") -> Set[Tuple[str, str]]:
    """(site, kind) pairs the static pass accepts from the runtime
    witness. Derived from the AST of each site's modules — never from a
    hand-maintained list: NaN in live lanes is accepted only where the
    missing-value domain is provably NaN, inf only where the lowered op
    table divides. The padding kinds ('pad-finite', 'pad-nonzero') are
    never accepted — those are the row-padding contracts."""
    base = pathlib.Path(root)
    out: Set[Tuple[str, str]] = set()
    for site, rels in WITNESS_SITES.items():
        for rel in rels:
            p = base / rel
            if not p.is_file():
                continue
            try:
                tree = ast.parse(p.read_text(encoding="utf-8"))
            except (OSError, SyntaxError):
                continue
            if _module_nan_aware(tree):
                out.add((site, "nan-live"))
            if _module_has_divide(tree):
                out.add((site, "inf-live"))
    return out


RULES: List[Rule] = [DtypeDataflowRule(), SentinelTaintRule()]
