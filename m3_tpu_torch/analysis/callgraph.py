"""Whole-program index for m3lint: cross-module name resolution, class
and receiver typing, a program-wide call graph, and the global lock
graph built on top of them.

A per-module rule sees ONE parsed
`Module`, so any contract whose two halves live in different files —
the one permitted tenant-lock -> budget-lock order (storage/ vs
utils/hbm.py), a jitted kernel calling a helper in another module with
a traced argument — was invisible. `ProgramIndex` is the missing layer:
it parses nothing itself (it consumes the same `Module` objects the
runner already builds) and derives

  * per-module BINDINGS: what each local name means — `import x.y as z`,
    `from ..utils import hbm`, `from .health import AdmissionGate` —
    resolved against the actual module set (relative imports included),
  * a CLASS table: methods, base classes, and `self.attr` receiver
    types inferred from `__init__`-style assignments (`self.gate =
    AdmissionGate(...)`) and annotations,
  * a FUNCTION table keyed by dotted qualname
    (`m3_tpu_torch.utils.cost.Enforcer.release`) with return-type annotations
    so `shared_budget().reclaim()` resolves through the return type,
  * a CALL GRAPH: for every function, the resolved callees —
    `self.m()`, `self.attr.m()` through receiver typing, `alias.f()`
    through bindings, bare `f()` through local defs then imports,
  * the GLOBAL LOCK GRAPH: lock identities are `Class.attr` (or
    `modbase.name` for module-level locks) — the SAME identity the
    runtime lockdep witness (utils/lockdep.py) derives from allocation
    sites, so the witnessed acquisition-order graph and this static
    graph are directly comparable. Edges are (held -> acquired), both
    directly nested `with` blocks and call-mediated through the
    program-wide transitive acquire closure.

`CrossModuleLockOrderRule` (a ProgramRule, run once over the whole
index) reports ABBA inversions whose two sides live in DIFFERENT files
— the per-module `lock-order-inversion` keeps same-file pairs — plus
cross-module self-deadlocks (a non-reentrant lock re-acquired through a
call chain that leaves the file).

Everything here is pure derivation from ASTs: no imports are executed.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import PACKAGE, Finding, Module, qualname

__all__ = [
    "ProgramIndex", "ProgramRule", "ClassInfo", "FunctionInfo",
    "CrossModuleLockOrderRule",
]

_LOCK_CTORS = {
    "threading.Lock": "lock", "threading.RLock": "rlock",
    "threading.Condition": "cond", "Lock": "lock", "RLock": "rlock",
    "Condition": "cond",
}


class ProgramRule:
    """A rule over the WHOLE program, run once per `run_paths` walk
    (never per module, never in a --jobs worker). Subclasses set `id` /
    `severity` and implement `check_program(program)`; findings are
    suppression-filtered against the module they are attributed to."""

    id: str = ""
    severity: str = "error"

    def check_program(self, program: "ProgramIndex"
                      ) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class FunctionInfo:
    qualname: str                 # m3_tpu_torch.utils.cost.Enforcer.release
    module: str                   # dotted module name
    cls: Optional[str]            # bare class name, None for functions
    name: str
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    returns: Optional[str] = None  # resolved return-type class qualname


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    module: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, FunctionInfo] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    lock_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    # `self.x = threading.Condition(self._y)` shares _y's identity: the
    # runtime witness acquires THROUGH the wrapped lock, so the static
    # graph must name the condition by the lock it wraps
    lock_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    bases: List[str] = dataclasses.field(default_factory=list)


def module_dotted(mod: Module) -> str:
    """Dotted module name: 'm3_tpu_torch.' + scope parts for in-package
    files ('m3_tpu_torch/storage/shard.py' -> 'm3_tpu_torch.storage.shard'),
    bare path-derived name otherwise (synthetic test modules)."""
    parts = list(mod.parts)
    anchor = None
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            anchor = i
            break
    if anchor is not None:
        parts = parts[anchor:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "mod"


class ProgramIndex:
    """The whole-program model. Build once per analyzer run from every
    successfully parsed Module; modules parse independently, so one bad
    file degrades the index instead of killing it."""

    def __init__(self, modules: Sequence[Module]):
        self.modules: Dict[str, Module] = {}
        self.by_relpath: Dict[str, Module] = {}
        # local name -> ("module", dotted) | ("symbol", dotted qualname)
        self.bindings: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.classes: Dict[str, ClassInfo] = {}      # by dotted qualname
        self.functions: Dict[str, FunctionInfo] = {}  # by dotted qualname
        # module-level singleton types: 'm3_tpu_torch.utils.instrument.ROOT'
        # -> class qualname (so `ROOT.sub_scope(...)` resolves through
        # the imported symbol to Scope.sub_scope)
        self.global_types: Dict[str, str] = {}
        self._class_by_bare: Dict[str, List[ClassInfo]] = {}
        for mod in modules:
            name = module_dotted(mod)
            self.modules[name] = mod
            self.by_relpath[mod.relpath] = mod
        for name, mod in self.modules.items():
            self._scan_bindings(name, mod)
        for name, mod in self.modules.items():
            self._scan_defs(name, mod)
        # return types resolve only after EVERY class exists (a method
        # may be annotated with a class defined below it, or elsewhere)
        for fi in self.functions.values():
            fi.returns = self._return_type(fi.module, fi.node)
        for name, mod in self.modules.items():
            self._scan_globals(name, mod)
        for info in self.classes.values():
            self._scan_attr_types(info)
        self._lock_graph: Optional[Dict[Tuple[str, str],
                                        Tuple[str, int, str]]] = None
        self._lock_facts: Optional[Dict[str, Dict]] = None

    @classmethod
    def from_sources(cls, sources: Dict[str, str]) -> "ProgramIndex":
        """Synthetic index for tests: {relpath: source}."""
        return cls([Module.from_source(src, relpath)
                    for relpath, src in sources.items()])

    # ----------------------------------------------------------- name binding

    def _scan_bindings(self, dotted: str, mod: Module):
        binds: Dict[str, Tuple[str, str]] = {}
        pkg = dotted.rsplit(".", 1)[0] if "." in dotted else ""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    target = a.name if a.asname else a.name.split(".")[0]
                    binds[local] = ("module", target)
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(pkg, node)
                if base is None:
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    target = f"{base}.{a.name}" if base else a.name
                    # `from pkg import mod` binds a module when one
                    # exists in the index; a symbol otherwise
                    kind = "module" if target in self.modules else "symbol"
                    binds[local] = (kind, target)
        self.bindings[dotted] = binds

    @staticmethod
    def _resolve_from(pkg: str, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module or ""
        parts = pkg.split(".") if pkg else []
        up = node.level - 1
        if up > len(parts):
            return None
        base = parts[:len(parts) - up] if up else parts
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)

    # ------------------------------------------------------------ definitions

    def _scan_defs(self, dotted: str, mod: Module):
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                info = ClassInfo(f"{dotted}.{node.name}", dotted,
                                 node.name, node)
                for b in node.bases:
                    q = qualname(b)
                    if q:
                        r = self.resolve(dotted, q)
                        info.bases.append(r[1] if r else q)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fi = FunctionInfo(
                            f"{info.qualname}.{sub.name}", dotted,
                            node.name, sub.name, sub)
                        info.methods[sub.name] = fi
                        self.functions[fi.qualname] = fi
                self.classes[info.qualname] = info
                self._class_by_bare.setdefault(node.name, []).append(info)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = FunctionInfo(f"{dotted}.{node.name}", dotted, None,
                                  node.name, node)
                self.functions[fi.qualname] = fi

    def _scan_globals(self, dotted: str, mod: Module):
        """Module-level singleton types (`ROOT = Scope()`,
        `TRACKER = HealthTracker()`): runs after every module's defs so
        cross-module constructors resolve."""
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            ctor = qualname(node.value.func)
            if ctor is None:
                continue
            r = self.resolve(dotted, ctor)
            typ = None
            if r and r[0] == "class":
                typ = r[1]
            elif r and r[0] == "func":
                typ = self.functions[r[1]].returns
            if typ:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.global_types[f"{dotted}.{t.id}"] = typ

    def _return_type(self, dotted: str, fn: ast.AST) -> Optional[str]:
        ann = getattr(fn, "returns", None)
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        q = qualname(ann) if ann is not None else None
        if q is None:
            return None
        r = self.resolve(dotted, q)
        if r and r[0] == "class":
            return r[1]
        return None

    def _scan_attr_types(self, info: ClassInfo):
        """self.attr receiver types from assignments anywhere in the
        class (the `__init__` convention plus lazy-init methods):
        `self.x = ClassName(...)` with a resolvable class, annotated
        `self.x: ClassName`, and lock constructors."""
        dotted = info.module
        for m in info.methods.values():
            for node in ast.walk(m.node):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = list(node.targets), node.value
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                    value = node.value
                    tq = qualname(node.annotation) \
                        if node.annotation is not None else None
                    if tq:
                        r = self.resolve(dotted, tq)
                        for t in targets:
                            key = qualname(t)
                            if key and key.startswith("self.") and r \
                                    and r[0] == "class":
                                info.attr_types[key[5:]] = r[1]
                for t in targets:
                    key = qualname(t)
                    if not key or not key.startswith("self."):
                        continue
                    attr = key[5:]
                    if "." in attr or value is None:
                        continue
                    if isinstance(value, ast.Call):
                        ctor = qualname(value.func)
                        if ctor in _LOCK_CTORS:
                            wrapped = qualname(value.args[0]) \
                                if value.args else None
                            if _LOCK_CTORS[ctor] == "cond" and wrapped \
                                    and wrapped.startswith("self."):
                                # Condition over an existing lock: the
                                # acquisition identity IS that lock's
                                info.lock_aliases[attr] = wrapped[5:]
                            else:
                                info.lock_attrs[attr] = _LOCK_CTORS[ctor]
                            continue
                    typ = self.expr_type(m, value, self._param_env(m),
                                         info)
                    if typ:
                        info.attr_types.setdefault(attr, typ)

    # -------------------------------------------------------------- resolution

    def resolve(self, dotted: str, name: str
                ) -> Optional[Tuple[str, str]]:
        """Resolve a dotted name used inside module `dotted` to
        ("class"|"func"|"module", qualified target), or None."""
        parts = name.split(".")
        binds = self.bindings.get(dotted, {})
        # locally defined first
        for cand in (f"{dotted}.{name}",):
            if cand in self.classes:
                return ("class", cand)
            if cand in self.functions:
                return ("func", cand)
        head = parts[0]
        if head in binds:
            kind, target = binds[head]
            full = ".".join([target] + parts[1:])
            if kind == "module" and len(parts) > 1:
                return self._resolve_abs(full)
            if kind == "symbol":
                if len(parts) == 1:
                    return self._resolve_abs(target) or ("symbol", target)
                return self._resolve_abs(full)
            if kind == "module":
                return ("module", target)
        return self._resolve_abs(name)

    def _resolve_abs(self, full: str) -> Optional[Tuple[str, str]]:
        if full in self.classes:
            return ("class", full)
        if full in self.functions:
            return ("func", full)
        if full in self.modules:
            return ("module", full)
        # Class.method / module.Class.method tails
        head, _, tail = full.rpartition(".")
        if head in self.classes and tail in self.classes[head].methods:
            return ("func", self.classes[head].methods[tail].qualname)
        return None

    def class_of(self, class_qualname: str) -> Optional[ClassInfo]:
        return self.classes.get(class_qualname)

    def method_on(self, class_qualname: str, name: str
                  ) -> Optional[FunctionInfo]:
        """Method lookup walking the resolved base-class chain."""
        seen: Set[str] = set()
        stack = [class_qualname]
        while stack:
            cq = stack.pop()
            if cq in seen:
                continue
            seen.add(cq)
            info = self.classes.get(cq)
            if info is None:
                continue
            if name in info.methods:
                return info.methods[name]
            stack.extend(info.bases)
        return None

    # -------------------------------------------------- expression typing

    def _local_env(self, fn: FunctionInfo) -> Dict[str, str]:
        """name -> class qualname for parameters (annotations) and
        single-assignment locals (`x = Ctor()` / `x = f()` with a typed
        return / `x = self.attr`)."""
        env = self._param_env(fn)
        cls = self.classes.get(f"{fn.module}.{fn.cls}") if fn.cls else None
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            typ = self.expr_type(fn, node.value, env, cls)
            if typ:
                env[t.id] = typ
        return env

    def _param_env(self, fn: FunctionInfo) -> Dict[str, str]:
        """name -> class qualname from parameter annotations only."""
        dotted = fn.module
        env: Dict[str, str] = {}
        args = fn.node.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            if a.annotation is None:
                continue
            ann = a.annotation
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                try:
                    ann = ast.parse(ann.value, mode="eval").body
                except SyntaxError:
                    continue
            q = qualname(ann)
            if q is None and isinstance(ann, (ast.Subscript, ast.BinOp)):
                # Optional[X] / Union[...] / X | None: first class-ish
                # name, including string forward references
                for sub in ast.walk(ann):
                    sq = qualname(sub)
                    if sq is None and isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        sq = sub.value
                    if sq and sq not in ("Optional", "typing.Optional",
                                         "Union", "typing.Union", "None",
                                         "typing"):
                        q = sq
                        break
            if q is None:
                continue
            r = self.resolve(dotted, q)
            if r and r[0] == "class":
                env[a.arg] = r[1]
        return env

    def expr_type(self, fn: FunctionInfo, expr: ast.AST,
                  env: Dict[str, str],
                  cls: Optional[ClassInfo]) -> Optional[str]:
        q = qualname(expr)
        if q is not None:
            if q == "self" and cls is not None:
                return cls.qualname
            if q in env:
                return env[q]
            if q.startswith("self.") and cls is not None:
                return cls.attr_types.get(q[5:])
            # an imported module-level singleton (`ROOT`, `TRACKER`)
            r = self.resolve(fn.module, q)
            if r and r[0] in ("symbol", "module"):
                return self.global_types.get(r[1])
            return self.global_types.get(f"{fn.module}.{q}")
        if isinstance(expr, (ast.BoolOp, ast.IfExp)):
            # `_root or self` / `a if c else b`: first typeable arm
            arms = expr.values if isinstance(expr, ast.BoolOp) \
                else [expr.body, expr.orelse]
            for arm in arms:
                t = self.expr_type(fn, arm, env, cls)
                if t:
                    return t
            return None
        if isinstance(expr, ast.Call):
            cq = qualname(expr.func)
            if cq is not None:
                r = self.resolve(fn.module, cq)
                if r and r[0] == "class":
                    return r[1]
                if r and r[0] == "func":
                    return self.functions[r[1]].returns
            if isinstance(expr.func, ast.Attribute):
                # method call on a typed value: use its return type
                rt = self.expr_type(fn, expr.func.value, env, cls)
                if rt:
                    m = self.method_on(rt, expr.func.attr)
                    if m:
                        return m.returns
        return None

    # ---------------------------------------------------------- call graph

    def resolve_call(self, fn: FunctionInfo, call: ast.Call,
                     env: Optional[Dict[str, str]] = None
                     ) -> Optional[FunctionInfo]:
        """The FunctionInfo a call inside `fn` lands on, or None."""
        if env is None:
            env = self._local_env(fn)
        cls = self.classes.get(f"{fn.module}.{fn.cls}") if fn.cls else None
        f = call.func
        q = qualname(f)
        if q is not None:
            if q.startswith("self.") and "." not in q[5:] and cls:
                return self.method_on(cls.qualname, q[5:])
            r = self.resolve(fn.module, q)
            if r and r[0] == "func":
                return self.functions[r[1]]
            if r and r[0] == "class":
                return self.method_on(r[1], "__init__")
        if isinstance(f, ast.Attribute):
            rt = self.expr_type(fn, f.value, env, cls)
            if rt:
                return self.method_on(rt, f.attr)
        return None

    # ----------------------------------------------------------- lock graph

    def lock_id(self, fn: FunctionInfo, expr: ast.AST,
                env: Dict[str, str]) -> Optional[Tuple[str, str]]:
        """(lock identity, kind) for a with-context expression, using
        the SAME naming scheme as the runtime witness: `Class.attr` for
        instance locks, `modbase.name` for module-level locks. None for
        untypeable lock expressions (they stay per-module concerns)."""
        q = qualname(expr)
        if q is None:
            return None
        cls = self.classes.get(f"{fn.module}.{fn.cls}") if fn.cls else None
        if q.startswith("self.") and "." not in q[5:] and cls is not None:
            attr = q[5:]
            # walk bases for inherited lock attrs, resolving condition
            # aliases (self._cond = Condition(self._mu) acquires _mu)
            for _hop in range(4):  # alias chains are short; bound them
                stack, seen = [cls.qualname], set()
                while stack:
                    cq = stack.pop()
                    if cq in seen:
                        continue
                    seen.add(cq)
                    info = self.classes.get(cq)
                    if info is None:
                        continue
                    if attr in info.lock_attrs:
                        return (f"{info.name}.{attr}",
                                info.lock_attrs[attr])
                    if attr in info.lock_aliases:
                        attr = info.lock_aliases[attr]
                        stack = None
                        break
                    stack.extend(info.bases)
                if stack is not None:
                    return None
            return None
        if "." not in q:
            # module-level lock assigned from a lock ctor
            mod = self.modules.get(fn.module)
            if mod is not None:
                for node in mod.tree.body:
                    if isinstance(node, ast.Assign) and \
                            isinstance(node.value, ast.Call):
                        ctor = qualname(node.value.func)
                        if ctor in _LOCK_CTORS and any(
                                isinstance(t, ast.Name) and t.id == q
                                for t in node.targets):
                            base = fn.module.rsplit(".", 1)[-1]
                            return (f"{base}.{q}", _LOCK_CTORS[ctor])
            return None
        # obj.attr where obj is typed
        head, _, attr = q.rpartition(".")
        rt = None
        if head in env:
            rt = env[head]
        elif head.startswith("self.") and cls is not None:
            rt = cls.attr_types.get(head[5:])
        if rt is not None:
            info = self.classes.get(rt)
            if info is not None and attr in info.lock_attrs:
                return (f"{info.name}.{attr}", info.lock_attrs[attr])
        return None

    def lock_facts(self) -> Dict[str, Dict]:
        """Per function qualname: {'acquires': {lockid: line},
        'edges': [(held, acquired, line)], 'calls_under':
        [(held, callee qualname, line)], 'calls': {callee qualnames},
        'kinds': {lockid: kind}} — the program-wide analog of
        lock_rules._MethodFacts. Memoized: it is the most expensive
        whole-program pass (one typing environment per function) and
        lock_edges + lock_kinds both consume it."""
        if self._lock_facts is not None:
            return self._lock_facts
        facts: Dict[str, Dict] = {}
        for fq, fn in self.functions.items():
            env = self._local_env(fn)
            fact = {"acquires": {}, "edges": [], "calls_under": [],
                    "calls": set(), "kinds": {}}

            def note_call(call: ast.Call, held: List[Tuple[str, str]],
                          fn=fn, env=env, fact=fact):
                callee = self.resolve_call(fn, call, env)
                if callee is None:
                    return
                fact["calls"].add(callee.qualname)
                for h, hk in reversed(held):
                    if hk != "cond":
                        fact["calls_under"].append(
                            (h, callee.qualname, call.lineno))
                        break

            def walk(stmts, held: List[Tuple[str, str]],
                     fn=fn, env=env, fact=fact, note_call=note_call):
                for stmt in stmts:
                    if isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef)):
                        continue
                    if isinstance(stmt, ast.With):
                        newly: List[Tuple[str, str]] = []
                        for item in stmt.items:
                            for n in ast.walk(item.context_expr):
                                if isinstance(n, ast.Call):
                                    note_call(n, held)
                            lk = self.lock_id(fn, item.context_expr, env)
                            if lk is None:
                                continue
                            lid, kind = lk
                            fact["kinds"][lid] = kind
                            fact["acquires"].setdefault(lid, stmt.lineno)
                            # earlier items of the SAME `with a, b:` are
                            # already held when b acquires — the witness
                            # records that edge, so the model must too
                            for h, _hk in [*held, *newly]:
                                fact["edges"].append((h, lid, stmt.lineno))
                            newly.append((lid, kind))
                        walk(stmt.body, held + newly)
                        continue
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            for n in ast.walk(child):
                                if isinstance(n, ast.Call):
                                    note_call(n, held)
                    for attr in ("body", "orelse", "finalbody"):
                        sub = getattr(stmt, attr, None)
                        if sub:
                            walk(sub, held)
                    for h in getattr(stmt, "handlers", []) or []:
                        walk(h.body, held)

            walk(fn.node.body, [])
            facts[fq] = fact
        self._lock_facts = facts
        return facts

    def lock_edges(self) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
        """The global (held -> acquired) edge set: {(a, b): (relpath,
        line, via)} where `via` is '' for a directly nested pair or the
        callee qualname the edge is mediated through. Cached — built
        once per index."""
        if self._lock_graph is not None:
            return self._lock_graph
        facts = self.lock_facts()
        # transitive acquire closure over the program call graph
        closure: Dict[str, Set[str]] = {
            fq: set(f["acquires"]) for fq, f in facts.items()}
        changed = True
        while changed:
            changed = False
            for fq, f in facts.items():
                for callee in f["calls"]:
                    more = closure.get(callee)
                    if more and not more <= closure[fq]:
                        closure[fq] |= more
                        changed = True
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        for fq, f in facts.items():
            relpath = self.modules[self.functions[fq].module].relpath \
                if self.functions[fq].module in self.modules else fq
            for a, b, line in f["edges"]:
                edges.setdefault((a, b), (relpath, line, ""))
            for held, callee, line in f["calls_under"]:
                for b in closure.get(callee, ()):
                    edges.setdefault((held, b), (relpath, line, callee))
        self._lock_graph = edges
        return edges

    def lock_kinds(self) -> Dict[str, str]:
        kinds: Dict[str, str] = {}
        for f in self.lock_facts().values():
            kinds.update(f["kinds"])
        return kinds


class CrossModuleLockOrderRule(ProgramRule):
    """lock-order-inversion (cross-module): ABBA pairs and call-mediated
    self-deadlocks on the GLOBAL lock graph whose two sides live in
    different files. Same-file pairs stay with the per-module
    lock-discipline rule (its name heuristics are deliberately wider);
    this rule only fires where no single-module view could see the
    inversion — the tenant-lock -> budget-lock contract split
    across storage/ and utils/hbm.py is the motivating shape."""

    id = "lock-order-inversion"
    severity = "error"

    def check_program(self, program: ProgramIndex) -> Iterator[Finding]:
        edges = program.lock_edges()
        kinds = program.lock_kinds()
        reported: Set[Tuple[str, str]] = set()
        for (a, b), (path, line, via) in sorted(
                edges.items(), key=lambda kv: (kv[1][0], kv[1][1])):
            if a == b:
                # self re-acquisition through a cross-file call chain
                if via and kinds.get(a, "lock") == "lock":
                    callee = program.functions.get(via)
                    callee_path = (program.modules[callee.module].relpath
                                   if callee and callee.module
                                   in program.modules else "")
                    if callee_path and callee_path != path:
                        yield Finding(
                            self.id, path, line,
                            f"non-reentrant lock {a!r} re-acquired through "
                            f"cross-module call to {via} ({callee_path}) "
                            "on a path that already holds it "
                            "(self-deadlock); use an RLock or move the "
                            "call outside the critical section",
                            self.severity)
                continue
            rev = edges.get((b, a))
            if rev is None or (b, a) in reported:
                continue
            if rev[0] == path:
                continue  # same-file pair: per-module rule territory
            reported.add((a, b))
            yield Finding(
                self.id, path, line,
                f"cross-module lock order inversion: {a!r} -> {b!r} here "
                f"but {b!r} -> {a!r} at {rev[0]}:{rev[1]}; two threads "
                "taking opposite orders deadlock — pick one order and "
                "document it where both locks are defined",
                self.severity)
