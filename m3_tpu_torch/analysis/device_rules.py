"""Device-dispatch hazards of the PyTorch port: the counterpart of
m3_tpu/analysis/jax_rules.py, keyed on `torch` imports where that one is
keyed on `jax`. One torch rule stands for each JAX rule:

  capture-purity       (jax-purity) functions reached from a
                       `torch.cuda.graph` capture. A capture records
                       kernels; host work inside it runs once, at capture
                       time. Findings carry their specific ids:
    capture-traced-branch  a Python `if`/`while`/conditional expression
                       on a device tensor: `bool(t)` syncs the host (an
                       error under capture) and bakes the capture-time
                       value into every replay. `x is None`, membership
                       tests, metadata reads (.shape/.ndim/.dtype/
                       .device/.is_cuda, .size()/.dim()/.numel()) and
                       len()/isinstance() do not count.
    capture-host-sync  `.item()`/`.tolist()`/`.cpu()`/`.numpy()`,
                       float()/int()/bool() or host numpy on a device
                       tensor, and any `torch.nonzero`/`torch.argwhere`/
                       `torch.cuda.synchronize` call, inside a captured
                       body.
                       Whole-program, like the reference's
                       CrossModuleTaintRule: roots are the calls inside
                       `with torch.cuda.graph(...)` (a `self.<attr>` body
                       resolves through the constructor call that stored
                       it, down to the nested def its factory returns);
                       taint flows into same-module helpers and, over the
                       ProgramIndex, into imported ones, with exactly the
                       parameters that carry device tensors.
  nonstatic-capture-cache  (jax-nonstatic-jit-cache) an lru_cache'd
                       builder returning a captured graph or a loaded
                       extension op, keyed on an unhashable-annotated
                       parameter or a mutable default.
  item-in-loop         (jax-item-in-loop) `.item()` or
                       `torch.cuda.synchronize()` inside a Python loop:
                       one device sync per element. (warning)
  mesh-spec            (mesh-spec) parallel/mesh.shard_map specs and
                       collectives: mesh-axis-unbound (a psum/pmin/pmax/
                       all_gather over an axis no mesh or spec of the
                       module declares), shard-spec-arity (in_specs arity
                       against the wrapped local def), and
                       unannotated-out-sharding (parallel/compile.py only:
                       a sharded out spec not conditioned on the plan
                       IR's edge annotation).
  unguarded-kernel-dispatch  (unguarded-pallas-dispatch) a module that
                       calls into the compiled extension names its card
                       oracle (`_CARD_ORACLE`, a test file that exists),
                       the chip_smoke.py phase that holds its kernels
                       (`_CHIP_SMOKE_PHASE`, text found in chip_smoke.py),
                       and a plain twin `<wrapper>_plain` for every
                       wrapper that launches; a call of a kernel wrapper
                       from another module runs under
                       `guard.dispatch`/`guard.guarded_builder`; and an
                       `except` that calls a plain twin around a kernel
                       call is a fallback, which the port does not have.
  unclassified-device-dispatch  (unclassified-device-dispatch) a bare or
                       broad `except` (RuntimeError included: torch
                       raises CUDA faults as one) around an extension
                       call, a graph replay or a host-to-device put must
                       classify into the ComputeError taxonomy
                       (parallel/guard.py) or re-raise.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .callgraph import ProgramRule
from .core import (Finding, Module, Rule, annotation_names, func_params,
                   index_functions, is_cache_decorator, qualname)

_NUMPY_ALIASES = {"np", "numpy"}
# tensor metadata: reading these never syncs and never depends on values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_sparse", "itemsize", "nbytes"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "is_contiguous",
                   "element_size", "stride", "get_device", "data_ptr",
                   "is_floating_point", "storage_offset"}
_STATIC_CALLS = {"len", "isinstance", "type", "id", "hasattr", "callable",
                 "getattr"}
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.nonzero", "torch.argwhere", "torch.cuda.synchronize"}
# torch.* calls that return no tensor (devices, dtypes, modules, guards)
_TORCH_NON_TENSOR = {"device", "Size", "finfo", "iinfo", "is_tensor",
                     "is_floating_point", "get_default_dtype", "dtype",
                     "Generator", "no_grad", "inference_mode", "utils",
                     "jit", "backends", "manual_seed", "set_grad_enabled",
                     "promote_types", "result_type", "can_cast", "cuda",
                     "Stream", "Event", "compile", "library", "ops"}
_UNHASHABLE_ANNOT = {"list", "List", "dict", "Dict", "set", "Set",
                     "ndarray", "Tensor", "torch.Tensor", "Sequence",
                     "MutableSequence", "bytearray"}
_CONTAINERS = (ast.List, ast.ListComp, ast.Tuple, ast.Dict, ast.DictComp,
               ast.Set, ast.SetComp)
_GRAPH_CTX = ("torch.cuda.graph", "cuda.graph")
_GRAPH_BUILD = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
                "torch.cuda.make_graphed_callables",
                "make_graphed_callables")
_EXT_LOAD = ("torch.utils.cpp_extension.load", "cpp_extension.load",
             "torch.utils.cpp_extension.load_inline",
             "cpp_extension.load_inline", "load", "load_inline")


def _torch_tensor_call(q: Optional[str]) -> bool:
    """A `torch.<fn>(...)` call that returns a tensor."""
    if not q or not q.startswith("torch."):
        return False
    return q.split(".")[1] not in _TORCH_NON_TENSOR


def _index_all_functions(mod: Module) -> Dict[str, List[ast.FunctionDef]]:
    """EVERY function def per bare name, in source order (distinct nested
    defs of one name must not collapse onto one)."""
    out: Dict[str, List[ast.FunctionDef]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    for defs in out.values():
        defs.sort(key=lambda f: f.lineno)
    return out


def _resolve(name: str, use_line: int,
             by_name: Dict[str, List[ast.FunctionDef]],
             ) -> Optional[ast.FunctionDef]:
    """The def a name at `use_line` refers to: the nearest PRECEDING def
    with that name, falling back to the first def."""
    defs = by_name.get(name)
    if not defs:
        return None
    best = None
    for fn in defs:
        if fn.lineno <= use_line:
            best = fn
        else:
            break
    return best or defs[0]


# ----------------------------------------------------------- capture purity


class _TaintVisitor:
    """One pass over a function reached from a capture: tracks names
    holding device tensors, records purity violations, and collects the
    calls that hand tensors on (same-module and imported)."""

    def __init__(self, mod: Module, fn: ast.FunctionDef, tainted: Set[str],
                 local_funcs: Dict[str, ast.FunctionDef]):
        self.mod = mod
        self.fn = fn
        self.tainted = set(tainted)
        # names bound to a list/tuple/dict/set display or comprehension
        self.containers: Set[str] = set()
        self.local_funcs = local_funcs
        self.violations: List[Tuple[str, ast.AST, str]] = []
        self.calls_out: List[Tuple[str, Set[str]]] = []
        self.ext_calls: List[Tuple[str, List[bool], Dict[str, bool],
                                   int]] = []

    def expr_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in node.ops):
            return False  # a host bool: identity or membership
        if isinstance(node, ast.Call):
            q = qualname(node.func)
            if q in _STATIC_CALLS:
                return False
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _STATIC_METHODS:
                return False
            if _torch_tensor_call(q):
                return True
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        return any(self.expr_tainted(c) for c in ast.iter_child_nodes(node))

    def _test_tainted(self, test: ast.AST) -> bool:
        if isinstance(test, ast.Name) and test.id in self.containers:
            return False  # a list/tuple/dict's truthiness is its length
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in test.ops):
            return False
        if isinstance(test, ast.BoolOp):
            return any(self._test_tainted(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._test_tainted(test.operand)
        return self.expr_tainted(test)

    def run(self):
        # two passes: loop-carried assignments taint their earlier uses
        for _ in range(2):
            self.violations.clear()
            self.calls_out.clear()
            self.ext_calls.clear()
            for stmt in self.fn.body:
                self._stmt(stmt)

    def _assign_target(self, target: ast.AST, taint: bool):
        if isinstance(target, ast.Name):
            if taint:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign_target(el, taint)
        elif isinstance(target, ast.Subscript) and taint:
            # a tensor stored into a container taints the container
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name):
                self.tainted.add(base.id)

    def _stmt(self, stmt: ast.AST):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are reached through their own calls
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self._expr(value)
                taint = self.expr_tainted(value)
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        if isinstance(value, _CONTAINERS):
                            self.containers.add(t.id)
                        else:
                            self.containers.discard(t.id)
                    if isinstance(stmt, ast.AugAssign):
                        if taint and isinstance(t, ast.Name):
                            self.tainted.add(t.id)
                    else:
                        self._assign_target(t, taint)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            if self._test_tainted(stmt.test):
                kind = "while" if isinstance(stmt, ast.While) else "if"
                self.violations.append((
                    "capture-traced-branch", stmt,
                    f"Python `{kind}` on a device tensor inside "
                    f"{self.fn.name!r}, reached from a CUDA-graph capture "
                    "— bool(tensor) syncs the host mid-capture and bakes "
                    "the capture-time value into every replay; use "
                    "torch.where, or branch on host metadata"))
            self._expr(stmt.test)
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter)
            self._assign_target(stmt.target, self.expr_tainted(stmt.iter))
            for s in [*stmt.body, *stmt.orelse]:
                self._stmt(s)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr)
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
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._expr(stmt.value)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _expr(self, node: ast.AST):
        for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
            self._call(call)
        for ifexp in [n for n in ast.walk(node) if isinstance(n, ast.IfExp)]:
            if self._test_tainted(ifexp.test):
                self.violations.append((
                    "capture-traced-branch", ifexp,
                    "conditional expression on a device tensor inside "
                    f"{self.fn.name!r}, reached from a CUDA-graph capture "
                    "— use torch.where"))

    def _call(self, call: ast.Call):
        q = qualname(call.func)
        args_tainted = [self.expr_tainted(a) for a in call.args]
        kw_tainted = {kw.arg: self.expr_tainted(kw.value)
                      for kw in call.keywords if kw.arg}
        any_tainted = any(args_tainted) or any(kw_tainted.values())
        where = (f"inside {self.fn.name!r}, reached from a CUDA-graph "
                 "capture")
        if q in _SYNC_CALLS:
            self.violations.append((
                "capture-host-sync", call,
                f"{q}() {where} — a host sync, which a capture cannot "
                "record (the replay never repeats it); keep the body "
                "free of syncs and finish on the host after the replay"))
        elif q and any_tainted:
            root = q.split(".")[0]
            if root in _NUMPY_ALIASES and "." in q:
                self.violations.append((
                    "capture-host-sync", call,
                    f"{q}() on a device tensor {where} — host numpy "
                    "copies the tensor to the host mid-capture; use torch "
                    "ops"))
            elif q in _SYNC_BUILTINS:
                self.violations.append((
                    "capture-host-sync", call,
                    f"{q}() on a device tensor {where} — a host sync that "
                    "bakes the capture-time value into every replay"))
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _SYNC_METHODS
                and self.expr_tainted(call.func.value)):
            self.violations.append((
                "capture-host-sync", call,
                f".{call.func.attr}() on a device tensor {where} — a "
                "device-to-host copy the capture cannot record"))
        if not (q and any_tainted):
            return
        if "." not in q and q in self.local_funcs:
            callee = self.local_funcs[q]
            names = [a.arg for a in func_params(callee)]
            hit: Set[str] = set()
            for i, t in enumerate(args_tainted):
                if t and i < len(names):
                    hit.add(names[i])
            for k, t in kw_tainted.items():
                if t and k in names:
                    hit.add(k)
            if hit:
                self.calls_out.append((q, hit))
        elif q.split(".")[0] not in (*_NUMPY_ALIASES, "torch"):
            self.ext_calls.append((q, args_tainted, kw_tainted,
                                   call.lineno))


def _is_graph_ctx(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and qualname(e.func) in _GRAPH_CTX


def _returned_defs(fn: ast.AST) -> List[ast.FunctionDef]:
    """The nested defs a builder returns by name (`return body`)."""
    nested = {n.name: n for n in ast.walk(fn)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n is not fn}
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Name) \
                and node.value.id in nested:
            out.append(nested[node.value.id])
    return out


class CapturePurityRule(ProgramRule):
    """capture-traced-branch / capture-host-sync over every function
    reached from a `torch.cuda.graph` capture, across modules."""

    id = "capture-purity"  # umbrella; findings carry their specific ids
    severity = "error"

    _MAX_HOPS = 4  # cross-module hops a device tensor is followed through

    def _roots(self, program) -> List[Tuple[str, ast.AST, str]]:
        """(module dotted, fn node, provenance) for every function called
        inside a `with torch.cuda.graph(...)` block."""
        out: List[Tuple[str, ast.AST, str]] = []
        for dotted, mod in sorted(program.modules.items()):
            if "torch" not in mod.imports:
                continue
            by_name = _index_all_functions(mod)
            for w in ast.walk(mod.tree):
                if not (isinstance(w, ast.With)
                        and any(_is_graph_ctx(i) for i in w.items)):
                    continue
                prov = f"captured at {mod.relpath}:{w.lineno}"
                for stmt in w.body:
                    for call in ast.walk(stmt):
                        if isinstance(call, ast.Call):
                            for fn_dotted, fn in self._callee(
                                    program, dotted, mod, call, by_name):
                                out.append((fn_dotted, fn, prov))
        return out

    def _callee(self, program, dotted, mod, call, by_name):
        q = qualname(call.func)
        if q is None:
            return []
        if "." not in q:
            fn = _resolve(q, call.lineno, by_name)
            if fn is not None:
                return [(dotted, fn)]
            r = program.resolve(dotted, q)
            if r and r[0] == "func":
                fi = program.functions[r[1]]
                return [(fi.module, fi.node)]
            return []
        if q.startswith("self.") and q.count(".") == 1:
            return self._self_attr_bodies(program, dotted, mod, call,
                                          q[5:])
        r = program.resolve(dotted, q)
        if r and r[0] == "func":
            fi = program.functions[r[1]]
            return [(fi.module, fi.node)]
        return []

    def _self_attr_bodies(self, program, dotted, mod, call, attr):
        """`self.<attr>(...)` inside a capture: the method, or the
        callable the constructor stored there, followed to every
        construction site's argument (a builder's returned nested def or
        a function)."""
        cls_node = mod.parents.get(mod.enclosing_function(call))
        if not isinstance(cls_node, ast.ClassDef):
            return []
        cq = f"{dotted}.{cls_node.name}"
        info = program.classes.get(cq)
        if info is None:
            return []
        if attr in info.methods:
            fi = info.methods[attr]
            return [(fi.module, fi.node)]
        init = info.methods.get("__init__")
        if init is None:
            return []
        params = [a.arg for a in func_params(init.node)][1:]
        slot = None
        for node in ast.walk(init.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    qualname(node.targets[0]) == f"self.{attr}" and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in params:
                slot = node.value.id
        if slot is None:
            return []
        pos = params.index(slot)
        out = []
        for site_dotted, site_mod in program.modules.items():
            for node in ast.walk(site_mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                cn = qualname(node.func)
                if cn is None:
                    continue
                r = program.resolve(site_dotted, cn)
                if not (r and r[0] == "class" and r[1] == cq):
                    continue
                arg = node.args[pos] if pos < len(node.args) else next(
                    (kw.value for kw in node.keywords if kw.arg == slot),
                    None)
                if isinstance(arg, ast.Call):
                    arg = arg.func
                    an = qualname(arg)
                    fr = program.resolve(site_dotted, an) if an else None
                    if fr and fr[0] == "func":
                        fi = program.functions[fr[1]]
                        out += [(fi.module, d) for d in
                                _returned_defs(fi.node)]
                elif isinstance(arg, ast.Name):
                    fr = program.resolve(site_dotted, arg.id)
                    if fr and fr[0] == "func":
                        fi = program.functions[fr[1]]
                        out.append((fi.module, fi.node))
        return out

    def check_program(self, program) -> Iterator[Finding]:
        emitted: Set[Tuple[str, str, int, str]] = set()
        seen: Dict[int, Set[str]] = {}
        work: List[Tuple[str, ast.AST, Set[str], str, int]] = []
        for dotted, fn, prov in self._roots(program):
            params = {a.arg for a in func_params(fn)} - {"self", "cls"}
            work.append((dotted, fn, params, prov, 0))
        while work:
            dotted, fn, tainted, prov, hops = work.pop()
            mod = program.modules[dotted]
            prev = seen.get(id(fn))
            if prev is not None and tainted <= prev:
                continue
            seen[id(fn)] = (prev or set()) | tainted
            funcs = index_functions(mod)
            v = _TaintVisitor(mod, fn, seen[id(fn)], funcs)
            v.run()
            for rule_id, node, msg in v.violations:
                line = getattr(node, "lineno", fn.lineno)
                key = (rule_id, mod.relpath, line, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield Finding(rule_id, mod.relpath, line,
                              f"{msg} [{prov}]", self.severity)
            for callee, hit in v.calls_out:
                if funcs[callee] is not fn:
                    work.append((dotted, funcs[callee], hit, prov, hops))
            if hops >= self._MAX_HOPS:
                continue
            for q, args_t, kw_t, _line in v.ext_calls:
                nxt = self._resolve_ext(program, dotted, q, args_t, kw_t)
                if nxt is not None:
                    callee_dotted, callee_fn, hit = nxt
                    work.append((callee_dotted, callee_fn, hit, prov,
                                 hops + 1))

    @staticmethod
    def _resolve_ext(program, dotted, q, args_t, kw_t):
        r = program.resolve(dotted, q)
        if not r or r[0] != "func":
            return None
        fi = program.functions[r[1]]
        if fi.module not in program.modules:
            return None
        names = [a.arg for a in func_params(fi.node)]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        hit: Set[str] = set()
        for i, t in enumerate(args_t):
            if t and i < len(names):
                hit.add(names[i])
        for k, t in kw_t.items():
            if t and k in names:
                hit.add(k)
        if not hit:
            return None
        return fi.module, fi.node, hit


# ------------------------------------------------------- per-module rules


def _ext_loaders(mod: Module) -> Set[str]:
    """Names that load the compiled extension: local functions calling
    torch.utils.cpp_extension.load(_inline), and names imported from a
    `*kernels` module that define them there (`from .codec_kernels
    import build`)."""
    out: Set[str] = set()
    cpp = any(isinstance(n, ast.ImportFrom) and n.module and
              n.module.endswith("cpp_extension") for n in ast.walk(mod.tree))
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                q = qualname(n.func)
                if q in _EXT_LOAD and (cpp or "." in q):
                    out.add(fn.name)
                    break
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.rpartition(".")[2].endswith("kernels"):
            out |= {a.asname or a.name for a in node.names
                    if a.name == "build"}
    return out


def ext_call_sites(mod: Module) -> List[ast.Call]:
    """Calls into the compiled extension: `build().op(...)` (a loader
    call's attribute) or `ext.op(...)` through a name bound from one."""
    loaders = _ext_loaders(mod)
    if not loaders:
        return []
    handles: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and qualname(node.value.func) in loaders:
            handles |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        base = node.func.value
        if isinstance(base, ast.Call) and qualname(base.func) in loaders:
            out.append(node)
        elif isinstance(base, ast.Name) and base.id in handles:
            out.append(node)
    return out


def _is_device_put(call: ast.Call) -> bool:
    """A move onto a device: `.cuda()`, `.to(<device>)` (a device-named
    value, a torch.device(...), a "cuda" string, or device=), and
    torch.tensor/as_tensor(..., device=) of anything but a constant
    table."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda" and \
            qualname(f) not in ("torch.cuda",):
        return not (isinstance(f.value, ast.Name) and f.value.id == "torch")
    if isinstance(f, ast.Attribute) and f.attr == "to":
        if any(kw.arg == "device" for kw in call.keywords):
            return True
        if call.args:
            return _device_like(call.args[0])
        return False
    q = qualname(f)
    if q in ("torch.tensor", "torch.as_tensor", "torch.asarray"):
        if call.args and _literal_table(call.args[0]):
            return False  # a constant table, not block data
        return any(kw.arg == "device" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in call.keywords)
    return False


def _literal_table(arg: ast.AST) -> bool:
    """A literal (or a list/tuple of literals) or a module constant named
    in capitals (`_POW10`): a few bytes of code constants."""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.UnaryOp):
        return _literal_table(arg.operand)
    if isinstance(arg, (ast.List, ast.Tuple)):
        return all(_literal_table(e) for e in arg.elts)
    return isinstance(arg, ast.Name) and arg.id.lstrip("_").isupper()


def _device_like(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, str) and arg.value.startswith("cuda")
    if isinstance(arg, ast.Call):
        return qualname(arg.func) in ("torch.device", "device")
    q = qualname(arg)
    if q is None:
        return False
    last = q.rpartition(".")[2].lower()
    return "dev" in last or last in ("head", "target", "dst", "where")


class NonStaticCaptureCacheRule(Rule):
    """nonstatic-capture-cache: lru_cache'd builder returning a captured
    graph or an extension op, keyed on an unhashable parameter."""

    id = "nonstatic-capture-cache"
    severity = "error"
    requires_import = "torch"

    def check(self, mod: Module) -> Iterator[Finding]:
        loaders = _ext_loaders(mod)
        for fn in index_functions(mod).values():
            if not any(is_cache_decorator(d) for d in fn.decorator_list):
                continue
            if not any(isinstance(n, ast.Call) and (
                    qualname(n.func) in _GRAPH_BUILD
                    or qualname(n.func) in _GRAPH_CTX
                    or qualname(n.func) in loaders)
                    for n in ast.walk(fn)):
                continue
            for arg in func_params(fn):
                bad = annotation_names(arg.annotation) & _UNHASHABLE_ANNOT
                if bad:
                    yield self.finding(
                        mod, fn,
                        f"capture/extension builder {fn.name!r} is "
                        f"lru_cache'd but parameter {arg.arg!r} is "
                        f"annotated {'|'.join(sorted(bad))} — unhashable "
                        "cache key (TypeError) or object-identity keying "
                        "of a captured graph; take hashable scalars/"
                        "tuples instead")
            for d in [*fn.args.defaults, *fn.args.kw_defaults]:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    yield self.finding(
                        mod, d,
                        f"capture/extension builder {fn.name!r} is "
                        "lru_cache'd with a mutable default — shared "
                        "across every cache entry")


class ItemInLoopRule(Rule):
    """item-in-loop: per-element device syncs in Python loops."""

    id = "item-in-loop"
    severity = "warning"
    requires_import = "torch"

    def check(self, mod: Module) -> Iterator[Finding]:
        seen: Set[int] = set()
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if id(node) in seen or not isinstance(node, ast.Call):
                    continue
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "item" and not node.args:
                    what = ".item()"
                elif qualname(node.func) == "torch.cuda.synchronize":
                    what = "torch.cuda.synchronize()"
                else:
                    continue
                seen.add(id(node))
                yield self.finding(
                    mod, node,
                    f"{what} inside a Python loop — one device sync per "
                    "element; batch the transfer (one .cpu()/.tolist() or "
                    "one synchronize) outside the loop")


class MeshSpecRule(Rule):
    """mesh-axis-unbound / shard-spec-arity / unannotated-out-sharding:
    spec consistency for parallel/mesh.shard_map programs and the
    psum/pmin/pmax/all_gather collectives."""

    id = "mesh-spec"  # umbrella; findings carry their specific ids
    severity = "error"
    dirs = ("parallel", "ops")
    requires_import = "torch"

    _SHARD_MAP_NAMES = ("shard_map", "pmesh.shard_map", "mesh.shard_map")
    _COLLECTIVES = ("psum", "pmin", "pmax", "all_gather")
    _MESH_NAMES = {"Mesh": 1, "pmesh.Mesh": 1, "mesh.Mesh": 1,
                   "make": 2, "pmesh.make": 2, "mesh.make": 2}

    @staticmethod
    def _strings(node: Optional[ast.AST]) -> Set[str]:
        if node is None:
            return set()
        return {a.value for a in ast.walk(node)
                if isinstance(a, ast.Constant) and isinstance(a.value, str)}

    @staticmethod
    def _spec_args(call: ast.Call) -> Tuple[Optional[ast.AST],
                                            Optional[ast.AST]]:
        ins = call.args[2] if len(call.args) > 2 else None
        outs = call.args[3] if len(call.args) > 3 else None
        for kw in call.keywords:
            if kw.arg == "in_specs":
                ins = kw.value
            elif kw.arg == "out_specs":
                outs = kw.value
        return ins, outs

    def _axis_vocabulary(self, mod: Module) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            q = qualname(node.func)
            if q in self._MESH_NAMES:
                i = self._MESH_NAMES[q]
                out |= self._strings(node.args[i] if len(node.args) > i
                                     else None)
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        out |= self._strings(kw.value)
            elif q in self._SHARD_MAP_NAMES:
                for spec in self._spec_args(node):
                    out |= self._strings(spec)
        return out

    @staticmethod
    def _local_bindings(fn: ast.AST) -> Dict[str, ast.AST]:
        """name -> value for names assigned exactly once in `fn`."""
        out: Dict[str, ast.AST] = {}
        dup: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name in out:
                    dup.add(name)
                out[name] = node.value
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                dup.add(node.target.id)
        for name in dup:
            out.pop(name, None)
        return out

    @staticmethod
    def _deref(node: ast.AST, bindings: Dict[str, ast.AST],
               depth: int = 2) -> ast.AST:
        while depth > 0 and isinstance(node, ast.Name) and \
                node.id in bindings:
            node = bindings[node.id]
            depth -= 1
        return node

    def check(self, mod: Module) -> Iterator[Finding]:
        vocab = self._axis_vocabulary(mod)
        by_name = _index_all_functions(mod)
        in_compile = bool(mod.scope_parts) and \
            mod.scope_parts[-1] == "compile.py"
        if vocab:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                q = qualname(node.func) or ""
                name = q.rpartition(".")[2]
                if name not in self._COLLECTIVES:
                    continue
                axis = node.args[2] if len(node.args) > 2 else None
                for kw in node.keywords:
                    if kw.arg == "axes":
                        axis = kw.value
                if not (isinstance(axis, ast.Constant) and
                        isinstance(axis.value, str)):
                    continue
                if axis.value not in vocab:
                    yield Finding(
                        "mesh-axis-unbound", mod.relpath, node.lineno,
                        f"`{name}` over axis {axis.value!r} which is bound "
                        "by NO mesh or shard_map spec in this module "
                        f"(declared axes: {sorted(vocab)}) — the group "
                        "lookup raises on the mesh route only; name an "
                        "axis the bound mesh carries", self.severity)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and qualname(node.func) in self._SHARD_MAP_NAMES
                    and node.args):
                continue
            enclosing = mod.enclosing_function(node)
            bindings = self._local_bindings(enclosing) if enclosing else {}
            ins, outs = self._spec_args(node)
            ins = self._deref(ins, bindings) if ins is not None else None
            outs = self._deref(outs, bindings) if outs is not None else None
            target = node.args[0]
            fn_def = (_resolve(target.id, node.lineno, by_name)
                      if isinstance(target, ast.Name) else None)
            if fn_def is not None and isinstance(ins, (ast.Tuple, ast.List)) \
                    and fn_def.args.vararg is None:
                n_params = len(fn_def.args.posonlyargs) + \
                    len(fn_def.args.args)
                n_defaults = len(fn_def.args.defaults)
                n_specs = len(ins.elts)
                if n_specs > n_params or n_specs < n_params - n_defaults:
                    yield Finding(
                        "shard-spec-arity", mod.relpath, node.lineno,
                        f"in_specs carries {n_specs} spec(s) but "
                        f"{fn_def.name!r} takes {n_params} positional "
                        "argument(s) — shard_map hands each slice the "
                        "wrong arguments on the mesh route", self.severity)
            if in_compile and outs is not None:
                elems = (list(outs.elts) if isinstance(outs, (ast.Tuple,
                                                              ast.List))
                         else [outs])
                for el in elems:
                    resolved = self._deref(el, bindings)
                    if not self._strings(resolved):
                        continue  # replicated: nothing to annotate
                    if any(isinstance(c, ast.IfExp) and any(
                            isinstance(n, ast.Attribute) and
                            n.attr == "sharding" for n in ast.walk(c.test))
                            for c in (el, resolved)):
                        continue
                    yield Finding(
                        "unannotated-out-sharding", mod.relpath,
                        getattr(el, "lineno", node.lineno),
                        "sharded out_specs entry is not derived from the "
                        "plan IR's edge annotation — bind it as `(\"shard\","
                        " ...) if <edge>.sharding == SHARDED else ()` so "
                        "the program's out-sharding mirrors the edge the "
                        "plan recorded", self.severity)


class UnguardedKernelDispatchRule(Rule):
    """unguarded-kernel-dispatch: the compiled extension's seams — the
    card oracle, the chip_smoke phase and the plain twins declared; its
    wrappers called under the guard; no fallback to a plain twin."""

    id = "unguarded-kernel-dispatch"
    severity = "error"
    requires_import = "torch"

    _GUARDS = {"dispatch", "guard.dispatch", "pguard.dispatch"}
    _GUARD_DECOS = {"guard.guarded_builder", "guarded_builder",
                    "pguard.guarded_builder"}

    @staticmethod
    def _decl(mod: Module, name: str) -> Optional[str]:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == name and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                return node.value.value
        return None

    @staticmethod
    def _repo_root(mod: Module) -> str:
        """Path prefix before the package dir (cwd fallback — the
        analyzer runs from the repo root)."""
        norm = mod.path.replace(os.sep, "/")
        idx = norm.rfind("/m3_tpu_torch/")
        return mod.path[:idx] if idx > 0 else "."

    @staticmethod
    def _kernel_modules(mod: Module) -> Set[str]:
        """Local aliases of imported `*_kernels` modules."""
        out: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name.endswith("_kernels"):
                        out.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.rpartition(".")[2].endswith("_kernels"):
                        out.add(a.asname or a.name)
        return out

    def _guarded(self, mod: Module, node: ast.AST) -> bool:
        """Inside a callable handed to guard.dispatch, or a
        guarded_builder (or a def nested in one)."""
        cur = mod.parents.get(node)
        child = node
        while cur is not None:
            if isinstance(cur, ast.Call) and \
                    qualname(cur.func) in self._GUARDS and child in cur.args:
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any((qualname(d.func if isinstance(d, ast.Call)
                                      else d) in self._GUARD_DECOS)
                            for d in cur.decorator_list):
                return True
            child, cur = cur, mod.parents.get(cur)
        return False

    def check(self, mod: Module) -> Iterator[Finding]:
        sites = ext_call_sites(mod)
        if sites:
            yield from self._kernel_module(mod, sites)
        wrappers = self._wrapper_calls(mod)
        for call in wrappers:
            if not self._guarded(mod, call):
                yield self.finding(
                    mod, call,
                    f"kernel wrapper {qualname(call.func)}() called outside "
                    "its guarded route — dispatch it through "
                    "parallel.guard.dispatch (or a guard.guarded_builder) so "
                    "its faults are typed, counted and charged to the "
                    "route's breaker")
        yield from self._fallbacks(mod, sites)

    def _kernel_module(self, mod: Module, sites) -> Iterator[Finding]:
        oracle = self._decl(mod, "_CARD_ORACLE")
        root = self._repo_root(mod)
        if oracle is None:
            yield self.finding(
                mod, sites[0],
                "module calls into the compiled extension but declares no "
                "_CARD_ORACLE = \"<test path>\" naming the tests that hold "
                "its kernels against their plain twins on the card")
        elif not os.path.exists(os.path.join(root, oracle)):
            yield self.finding(
                mod, sites[0],
                f"_CARD_ORACLE points at {oracle!r}, which does not exist "
                "— the card oracle moved or was never written")
        phase = self._decl(mod, "_CHIP_SMOKE_PHASE")
        smoke = os.path.join(root, "chip_smoke.py")
        if phase is None:
            yield self.finding(
                mod, sites[0],
                "module calls into the compiled extension but declares no "
                "_CHIP_SMOKE_PHASE = \"<phase>\" naming the chip_smoke.py "
                "phase that holds its kernels on every card run")
        else:
            try:
                with open(smoke, encoding="utf-8") as fh:
                    found = phase in fh.read()
            except OSError:
                found = False
            if not found:
                yield self.finding(
                    mod, sites[0],
                    f"_CHIP_SMOKE_PHASE {phase!r} is not in chip_smoke.py "
                    "— the phase that holds these kernels on the card "
                    "moved or was dropped")
        defs = {n.name for n in mod.tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        done: Set[str] = set()
        for call in sites:
            fn = mod.enclosing_function(call)
            if fn is None or fn.name in done:
                continue
            done.add(fn.name)
            if f"{fn.name}_plain" not in defs:
                yield self.finding(
                    mod, call,
                    f"{fn.name!r} launches an extension kernel but the "
                    f"module defines no plain twin {fn.name}_plain() — "
                    "the CPU path and the card oracle need the plain "
                    "PyTorch version beside every kernel")

    def _wrapper_calls(self, mod: Module) -> List[ast.Call]:
        """Calls of a kernel wrapper from outside its kernels module:
        `<x>_kernels.<name>(...)`, not its plain twin, its build or its
        checks."""
        aliases = self._kernel_modules(mod)
        out = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases):
                continue
            name = node.func.attr
            if name.endswith("_plain") or name.startswith("_") or \
                    name in ("build",) or name.isupper():
                continue
            out.append(node)
        return out

    def _fallbacks(self, mod: Module, sites) -> Iterator[Finding]:
        site_ids = {id(s) for s in sites}
        for t in ast.walk(mod.tree):
            if not isinstance(t, ast.Try):
                continue
            body_calls = [n for s in t.body for n in ast.walk(s)
                          if isinstance(n, ast.Call)]
            names = {(qualname(c.func) or "").rpartition(".")[2]
                     for c in body_calls}
            kernelish = any(id(c) in site_ids or
                            qualname(c.func) in self._GUARDS
                            for c in body_calls)
            for h in t.handlers:
                for n in ast.walk(h):
                    if not isinstance(n, ast.Call):
                        continue
                    twin = (qualname(n.func) or "").rpartition(".")[2]
                    if not twin.endswith("_plain"):
                        continue
                    if kernelish or twin[:-len("_plain")] in names:
                        yield self.finding(
                            mod, n,
                            f"except handler falls back to the plain twin "
                            f"{twin}() around a kernel call — the port has "
                            "no fallback: a fault on the card raises a typed "
                            "ComputeError through parallel.guard")


class UnclassifiedDeviceDispatchRule(Rule):
    """unclassified-device-dispatch: a bare or broad `except` (bare,
    `Exception`, `BaseException`, or `RuntimeError`, the class torch
    raises CUDA faults and OOMs as) around an extension call, a
    CUDA-graph replay or a host-to-device put must CLASSIFY the failure into the compute-fault taxonomy
    (`parallel.guard.classify` / the ComputeError subclasses) or
    re-raise — swallowing a CUDA error untyped bypasses the breaker,
    the quarantine and the telemetry that name the degraded route."""

    id = "unclassified-device-dispatch"
    severity = "error"
    requires_import = "torch"
    dirs = ("ops", "parallel", "storage", "query")

    _BROAD = {"Exception", "BaseException", "RuntimeError"}
    _TAXONOMY = {"classify", "ComputeError", "CompileError", "DeviceOOM",
                 "KernelFault", "DispatchTimeout"}

    @classmethod
    def _is_broad(cls, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
        return any((qualname(n) or "").rsplit(".", 1)[-1] in cls._BROAD
                   for n in names)

    def _is_compliant(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Name) and node.id in self._TAXONOMY:
                return True
            if isinstance(node, ast.Attribute) and \
                    node.attr in self._TAXONOMY:
                return True
        return False

    def check(self, mod: Module) -> Iterator[Finding]:
        tries = [n for n in ast.walk(mod.tree) if isinstance(n, ast.Try)]
        if not tries:
            return
        sites = {id(s) for s in ext_call_sites(mod)}
        for t in tries:
            bad = [h for h in t.handlers
                   if self._is_broad(h) and not self._is_compliant(h)]
            if not bad:
                continue
            site = None
            for stmt in t.body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    if id(node) in sites or _is_device_put(node) or (
                            isinstance(node.func, ast.Attribute)
                            and node.func.attr == "replay"):
                        site = node
                        break
                if site is not None:
                    break
            if site is None:
                continue
            for h in bad:
                yield self.finding(
                    mod, h,
                    "broad except around a device dispatch (extension "
                    f"call, graph replay or device put at line "
                    f"{site.lineno}) neither classifies into the "
                    "ComputeError taxonomy nor re-raises — route it "
                    "through parallel.guard.classify (or dispatch via "
                    "guard.dispatch) so device faults reach the breaker/"
                    "quarantine/telemetry plane")


RULES: List[Rule] = [NonStaticCaptureCacheRule(), ItemInLoopRule(),
                     MeshSpecRule(), UnguardedKernelDispatchRule(),
                     UnclassifiedDeviceDispatchRule()]
