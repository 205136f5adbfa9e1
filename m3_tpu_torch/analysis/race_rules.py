"""Concurrency-plane race analysis (the static half of the `go test
-race` parity story; the runtime half is utils/racewatch.py).

The reference M3 ships ~494k lines of Go under the race detector; this
tree's shared-state discipline is otherwise enforced only in code review,
which has hand-caught the same bug class three times (the registry
publish-before-append ordering, the sticky `_degraded` flag, the
block-cache single-flight). This module encodes that review checklist
as a whole-program rule family over the `ProgramIndex`:

  1. THREAD-SPAWN DISCOVERY: every `threading.Thread(target=...)`,
     executor `.submit(fn)` fanout, and `weakref.finalize(obj, cb)`
     callback is a spawn site; the spawned entry's transitive call
     closure (over the program call graph) is the THREAD SIDE of the
     program.
  2. SHARED-ATTR COMPUTATION: a class whose method runs on the thread
     side has instances crossing thread boundaries; a `self.attr` of
     such a class accessed (outside `__init__`) from BOTH the thread
     side and the main side is SHARED state.
  3. LOCK-PROTECTION INFERENCE: each access site carries the set of
     locks held there (the same `Class.attr` / `modbase.name`
     identities as the global lock graph and the lockdep witness); the
     protecting lock of an attr is the intersection of the held sets
     over its guarded accesses.

Four rules are derived from that model:

  unguarded-shared-write   a write to a shared attr at a site holding
                           no lock (while the protection model says one
                           exists — or no access is ever guarded).
  inconsistent-guard       the guarded accesses of one attr share NO
                           common lock (lock A here, lock B there: both
                           sites believe they are protected; neither
                           excludes the other).
  unsafe-publication       (a) an instance handed to a thread it spawns
                           in `__init__` (or escaping through a
                           queue/registry handoff) BEFORE `__init__`
                           finishes assigning the attrs the consumer
                           reads; (b) an index into a shared mapping
                           published BEFORE the list it points into is
                           appended (`self._index[k] = len(self._ids)`
                           ... `self._ids.append(...)`) — the exact
                           pre-fix registry ordering. The ledger
                           never exempts this rule: lock-free protocols
                           are granted for single-op accesses, and the
                           publication ORDER is the machine-checked
                           half of their invariant.
  racy-check-then-act      a read-test-write of a shared attr (`if
                           self._x is None: self._x = ...`,
                           `if k not in self._m: self._m[k] = v`) with
                           no lock spanning the test and the act.

THE LEDGER (analysis/lockfree_ledger.txt): deliberate lock-free
protocols — GIL-atomic single-op dict/list accesses with a documented
ordering or stickiness invariant — are declared there, one
`Class.attr` per line with a one-line invariant, and reviewed like
suppressions. Declared attrs are exempt from the guard rules (1, 2, 4)
but stay instrumented by the runtime witness (utils/racewatch.py), so
the declaration is verified dynamically rather than trusted silently.

Known model limits (by design, witness-covered at runtime): only
`self.attr` accesses are modeled (cross-object `elem._x` reads from a
sibling class are not), nested closures are skipped, and a method
reachable from BOTH sides counts as thread-side only — so a race
wholly inside one method (two pool threads in the same entry) is left
to racewatch.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .core import Finding, qualname
from .callgraph import (ClassInfo, FunctionInfo, ProgramIndex, ProgramRule)

__all__ = [
    "SharedStateRaceRule", "load_ledger", "ledger_path",
    "protection_model", "RULE_IDS",
]

RULE_IDS = ("unguarded-shared-write", "inconsistent-guard",
            "unsafe-publication", "racy-check-then-act")

# container-mutating method calls on a self.attr count as writes
_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "clear", "update", "setdefault", "appendleft", "popleft",
})

# attrs assigned from internally-synchronized ctors are never shared
# STATE in the racy sense: their thread-safety is the callee's contract
# (stdlib queues/events lock internally; deques document GIL-atomic
# append/pop; thread handles are join-synchronized).
_SYNC_CTOR_TAILS = frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event",
    "Semaphore", "BoundedSemaphore", "Barrier", "deque", "local",
    "Thread", "ThreadPoolExecutor",
})

# __init__ handoff receivers that publish `self` to another thread's
# reach (queue puts, registry appends, executor submits)
_HANDOFF_METHODS = frozenset({
    "put", "put_nowait", "append", "add", "register", "submit",
})


# ----------------------------------------------------------------- ledger


def ledger_path() -> pathlib.Path:
    return pathlib.Path(__file__).parent / "lockfree_ledger.txt"


def load_ledger(path: Optional[pathlib.Path] = None) -> Dict[str, str]:
    """{`Class.attr`: one-line invariant} from the reviewed lock-free
    ledger. Lines are `Class.attr  # invariant`; blank lines and full
    comment lines are skipped. Missing file = empty ledger."""
    p = path if path is not None else ledger_path()
    entries: Dict[str, str] = {}
    try:
        text = p.read_text(encoding="utf-8")
    except OSError:
        return entries
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        ident, _, reason = line.partition("#")
        ident = ident.strip()
        if ident:
            entries[ident] = reason.strip()
    return entries


# ------------------------------------------------------------ access model


@dataclasses.dataclass
class _Access:
    fn: str                    # function qualname
    method: str                # bare method name
    line: int
    write: bool
    locks: FrozenSet[str]      # lock identities held at the access


def _abs_name(program: ProgramIndex, module: str, q: str) -> str:
    """Binding-resolved absolute dotted name for `q` as used inside
    `module` ('Thread' -> 'threading.Thread' under `from threading
    import Thread`)."""
    parts = q.split(".")
    b = program.bindings.get(module, {}).get(parts[0])
    if b is not None:
        return ".".join([b[1], *parts[1:]])
    return q


def _callable_info(program: ProgramIndex, fn: FunctionInfo,
                   env: Dict[str, str],
                   node: ast.AST) -> Optional[FunctionInfo]:
    """Resolve a callable REFERENCE (a thread target, a submit arg) to
    its FunctionInfo: `self.m`, `obj.m` through receiver typing, a bare
    or imported function name."""
    q = qualname(node)
    if q is None:
        return None
    cls = program.classes.get(f"{fn.module}.{fn.cls}") if fn.cls else None
    if q.startswith("self.") and "." not in q[5:] and cls is not None:
        return program.method_on(cls.qualname, q[5:])
    r = program.resolve(fn.module, q)
    if r and r[0] == "func":
        return program.functions[r[1]]
    if isinstance(node, ast.Attribute):
        rt = program.expr_type(fn, node.value, env, cls)
        if rt:
            return program.method_on(rt, node.attr)
    return None


def _spawn_entries(program: ProgramIndex) -> Set[str]:
    """Qualnames of every function handed to another thread: Thread
    targets, executor submits, weakref.finalize callbacks."""
    entries: Set[str] = set()
    for fq, fn in program.functions.items():
        env: Optional[Dict[str, str]] = None
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            q = qualname(node.func)
            target: Optional[ast.AST] = None
            if q is not None:
                absq = _abs_name(program, fn.module, q)
                if absq == "threading.Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                    if target is None and len(node.args) >= 2:
                        target = node.args[1]
                elif absq == "weakref.finalize" and len(node.args) >= 2:
                    target = node.args[1]
            if target is None and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "submit" and node.args:
                target = node.args[0]
            if target is None:
                continue
            if env is None:
                env = program._local_env(fn)
            callee = _callable_info(program, fn, env, target)
            if callee is not None:
                entries.add(callee.qualname)
    return entries


def _caller_held(program: ProgramIndex, entries: Set[str]
                 ) -> Dict[str, FrozenSet[str]]:
    """Locks PROVABLY held on entry to each function: the intersection
    of the full held-sets over every resolved call site, closed over the
    call graph (a few rounds bound recursion). This is the `_locked`
    helper convention — `_drop_conn_locked` is only ever called under
    `_io_lock`, so its body analyzes as if the lock were lexical.
    Call sites inside `__init__` are excluded (pre-publication,
    single-threaded); thread-spawn entries are credited nothing (they
    start on a fresh stack)."""
    sites: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for fq, fn in program.functions.items():
        if fn.name == "__init__":
            continue
        env = program._local_env(fn)

        def note(call: ast.Call, held, fq=fq, fn=fn, env=env):
            callee = program.resolve_call(fn, call, env)
            if callee is not None:
                sites.setdefault(callee.qualname, []).append(
                    (fq, frozenset(h for h, _k in held)))

        def walk(stmts, held, fn=fn, env=env, note=note):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                if isinstance(stmt, ast.With):
                    newly: List[Tuple[str, str]] = []
                    for item in stmt.items:
                        for n in ast.walk(item.context_expr):
                            if isinstance(n, ast.Call):
                                note(n, held)
                        lk = program.lock_id(fn, item.context_expr, env)
                        if lk is not None:
                            newly.append(lk)
                    walk(stmt.body, held + newly)
                    continue
                for child in ast.iter_child_nodes(stmt):
                    if isinstance(child, ast.expr):
                        for n in ast.walk(child):
                            if isinstance(n, ast.Call):
                                note(n, held)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        walk(sub, held)
                for h in getattr(stmt, "handlers", []) or []:
                    walk(h.body, held)

        walk(fn.node.body, [])
    # monotone-from-empty fixpoint: each round only adds locks held at
    # EVERY site one hop further out; 3 rounds cover the helper chains
    # this tree actually has (recursion conservatively earns nothing)
    cred: Dict[str, FrozenSet[str]] = {}
    for _round in range(3):
        nxt: Dict[str, FrozenSet[str]] = {}
        for callee, calls in sites.items():
            if callee in entries:
                continue
            eff = [held | cred.get(caller, frozenset())
                   for caller, held in calls]
            common = frozenset.intersection(*eff)
            if common:
                nxt[callee] = common
        if nxt == cred:
            break
        cred = nxt
    return cred


def _thread_side(program: ProgramIndex, entries: Set[str]) -> Set[str]:
    """Transitive call closure of the spawn entries over the program
    call graph — every function that can run off the spawning thread."""
    facts = program.lock_facts()
    side: Set[str] = set()
    stack = list(entries)
    while stack:
        fq = stack.pop()
        if fq in side:
            continue
        side.add(fq)
        f = facts.get(fq)
        if f:
            stack.extend(f["calls"])
    return side


def _closure_of(program: ProgramIndex, entry: str) -> Set[str]:
    return _thread_side(program, {entry})


def _sync_attrs(info: ClassInfo) -> Set[str]:
    """Attrs assigned from internally-synchronized ctors anywhere in
    the class (by ctor name tail — stdlib types are not in the index)."""
    out: Set[str] = set()
    for m in info.methods.values():
        for node in ast.walk(m.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            ctor = qualname(node.value.func)
            if ctor is None or ctor.split(".")[-1] not in _SYNC_CTOR_TAILS:
                continue
            for t in node.targets:
                tq = qualname(t)
                if tq and tq.startswith("self.") and "." not in tq[5:]:
                    out.add(tq[5:])
    return out


class _MethodScan:
    """One method's race-relevant facts: per-attr accesses with held
    locks, check-then-act sites, publication events, alias map."""

    def __init__(self, program: ProgramIndex, info: ClassInfo,
                 fn: FunctionInfo, skip_attrs: Set[str],
                 base_held: FrozenSet[str] = frozenset()):
        self.program = program
        self.info = info
        self.fn = fn
        self.skip = skip_attrs
        self.base = base_held  # caller-proven locks (_caller_held)
        self.env = program._local_env(fn)
        self.accesses: List[Tuple[str, _Access]] = []  # (attr, access)
        self.check_then_act: List[Tuple[str, int, Set[int]]] = []
        # ordered publication events, per kind
        self.sub_stores: List[Tuple[int, str, Optional[str]]] = []
        self.appends: List[Tuple[int, str]] = []
        self.aliases: Dict[str, str] = {}     # local name -> attr
        self.len_of: Dict[str, str] = {}      # local name -> attr (len())
        self._walk(fn.node.body, [])

    # -- attr resolution ---------------------------------------------------

    def _attr_of(self, node: ast.AST) -> Optional[str]:
        """The self-attr an expression designates: `self.x` or a local
        alias `b` bound from `b = self.x`."""
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id)
        return None

    def _eligible(self, attr: Optional[str]) -> Optional[str]:
        if attr is None or attr in self.skip:
            return None
        if attr in self.info.lock_attrs or attr in self.info.lock_aliases:
            return None
        if attr in self.info.methods:
            return None
        return attr

    def _len_attr(self, expr: ast.AST) -> Optional[str]:
        """The attr B when `expr` is `len(self.B)` (alias-resolved) or a
        name bound from one earlier in the method."""
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
                and expr.func.id == "len" and len(expr.args) == 1:
            return self._eligible(self._attr_of(expr.args[0]))
        if isinstance(expr, ast.Name):
            return self.len_of.get(expr.id)
        return None

    # -- statement walk ----------------------------------------------------

    def _record(self, attr: Optional[str], line: int, write: bool,
                held: List[Tuple[str, str]]):
        attr = self._eligible(attr)
        if attr is None:
            return
        self.accesses.append((attr, _Access(
            self.fn.qualname, self.fn.name, line, write,
            frozenset(h for h, _k in held) | self.base)))

    def _scan_expr(self, expr: ast.AST, held: List[Tuple[str, str]],
                   skip_nodes: Set[int]):
        for node in ast.walk(expr):
            if id(node) in skip_nodes:
                continue
            attr = self._attr_of(node)
            if attr is None:
                continue
            if isinstance(node, ast.Name):
                # only alias LOADS count (stores rebind the local)
                if not isinstance(node.ctx, ast.Load):
                    continue
            parent = self._parent(node)
            # self.m() / self.attr.append(): classify, don't double-read
            if isinstance(parent, ast.Call) and parent.func is node:
                if attr in self.info.methods:
                    continue
                self._record(attr, node.lineno, False, held)
                continue
            if isinstance(parent, ast.Attribute) and parent.value is node:
                gp = self._parent(parent)
                if isinstance(gp, ast.Call) and gp.func is parent \
                        and parent.attr in _MUTATORS:
                    self._record(attr, node.lineno, True, held)
                    if self._eligible(attr) and parent.attr in (
                            "append", "extend"):
                        self.appends.append((node.lineno, attr))
                    continue
                self._record(attr, node.lineno, False, held)
                continue
            self._record(attr, node.lineno,
                         not isinstance(getattr(node, "ctx", ast.Load()),
                                        ast.Load), held)

    def _parent(self, node: ast.AST) -> Optional[ast.AST]:
        mod = self.program.modules.get(self.fn.module)
        return mod.parents.get(node) if mod is not None else None

    def _scan_assign(self, stmt: ast.AST, held: List[Tuple[str, str]]):
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        if isinstance(stmt, ast.Assign):
            targets, value = list(stmt.targets), stmt.value
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets, value = [stmt.target], stmt.value
        # unpack tuple/list targets into their elements
        flat: List[ast.AST] = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                flat.extend(t.elts)
            else:
                flat.append(t)
        for t in flat:
            attr = self._attr_of(t)
            if attr is not None:
                # plain `self.x = v` / `x = v` rebinding an alias
                if isinstance(t, ast.Name):
                    if isinstance(stmt, ast.AugAssign):
                        self._record(attr, t.lineno, True, held)
                    else:
                        self.aliases.pop(t.id, None)  # rebound local
                else:
                    self._record(attr, t.lineno, True, held)
                    if not isinstance(stmt, ast.AugAssign):
                        # rebinding self.attr DETACHES the old object:
                        # locals aliased to it (the swap-under-lock
                        # `groups = self._pending; self._pending = []`
                        # drain pattern) now hold private state, not
                        # the shared attr
                        self.aliases = {k: v for k, v in
                                        self.aliases.items() if v != attr}
                        self.len_of = {k: v for k, v in
                                       self.len_of.items() if v != attr}
                continue
            if isinstance(t, ast.Subscript):
                sattr = self._eligible(self._attr_of(t.value))
                if sattr is not None:
                    self._record(sattr, t.lineno, True, held)
                    if value is not None and not isinstance(
                            stmt, ast.AugAssign):
                        self.sub_stores.append(
                            (t.lineno, sattr, self._len_attr(value)))
        # alias / len() bookkeeping for single-name targets
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) and value is not None:
            name = stmt.targets[0].id
            src = self._eligible(self._attr_of(value))
            if src is not None and isinstance(value, ast.Attribute):
                self.aliases[name] = src
            lb = self._len_attr(value)
            if lb is not None:
                self.len_of[name] = lb

    def _writes_in(self, stmts) -> Tuple[Set[str], Set[int]]:
        """(attrs written, write line numbers) anywhere under `stmts` —
        the check-then-act body scan."""
        attrs: Set[str] = set()
        lines: Set[int] = set()
        for stmt in stmts:
            for node in ast.walk(stmt):
                a: Optional[str] = None
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    tgts = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in tgts:
                        a = self._eligible(self._attr_of(t))
                        if a is None and isinstance(t, ast.Subscript):
                            a = self._eligible(self._attr_of(t.value))
                        if a is not None:
                            attrs.add(a)
                            lines.add(t.lineno)
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _MUTATORS:
                    a = self._eligible(self._attr_of(node.func.value))
                    if a is not None:
                        attrs.add(a)
                        lines.add(node.lineno)
        return attrs, lines

    def _reads_in_expr(self, expr: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(expr):
            a = self._eligible(self._attr_of(node))
            if a is not None:
                out.add(a)
        return out

    def _walk(self, stmts, held: List[Tuple[str, str]]):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested closures: out of model (see docstring)
            if isinstance(stmt, ast.With):
                newly: List[Tuple[str, str]] = []
                for item in stmt.items:
                    lk = self.program.lock_id(self.fn, item.context_expr,
                                              self.env)
                    if lk is not None:
                        newly.append(lk)
                    else:
                        self._scan_expr(item.context_expr, held, set())
                self._walk(stmt.body, held + newly)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._scan_assign(stmt, held)
                if getattr(stmt, "value", None) is not None:
                    self._scan_expr(stmt.value, held, set())
                # subscript/index parts of targets still READ
                for t in (stmt.targets if isinstance(stmt, ast.Assign)
                          else [stmt.target]):
                    if isinstance(t, ast.Subscript):
                        self._scan_expr(t.slice, held, set())
                continue
            if isinstance(stmt, ast.If) and not held and not self.base \
                    and self.fn.name != "__init__":
                reads = self._reads_in_expr(stmt.test)
                writes, wlines = self._writes_in(stmt.body)
                overlap = reads & writes
                for attr in sorted(overlap):
                    self.check_then_act.append((attr, stmt.lineno, wlines))
            # header expressions of this statement (test/iter/args...)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(child, held, set())
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    self._walk(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk(h.body, held)


# --------------------------------------------------------- the rule family


class SharedStateRaceRule(ProgramRule):
    """Concurrency-plane race family (whole-program): thread-spawn
    discovery + shared-attr lock-protection inference, flagging
    unguarded-shared-write / inconsistent-guard / unsafe-publication /
    racy-check-then-act; deliberate lock-free protocols pass by
    declaration in analysis/lockfree_ledger.txt, never by silence."""

    id = "shared-state-race"
    severity = "error"

    def __init__(self, ledger: Optional[Dict[str, str]] = None):
        self._ledger = ledger

    # -- helpers -----------------------------------------------------------

    def _relpath(self, program: ProgramIndex, module: str) -> str:
        mod = program.modules.get(module)
        return mod.relpath if mod is not None else module

    def check_program(self, program: ProgramIndex) -> Iterator[Finding]:
        ledger = self._ledger if self._ledger is not None else load_ledger()
        entries = _spawn_entries(program)
        thread_side = _thread_side(program, entries)
        credit = _caller_held(program, entries)

        scans: Dict[str, Dict[str, _MethodScan]] = {}
        for cq, info in program.classes.items():
            if not any(m.qualname in thread_side
                       for m in info.methods.values()):
                continue
            skip = _sync_attrs(info)
            scans[cq] = {
                name: _MethodScan(program, info, m, skip,
                                  credit.get(m.qualname, frozenset()))
                for name, m in info.methods.items()}

        yield from self._guard_rules(program, scans, thread_side, ledger)
        yield from self._publication(program, scans, thread_side)

    # -- rules 1, 2, 4: the guard model ------------------------------------

    def _guard_rules(self, program, scans, thread_side, ledger
                     ) -> Iterator[Finding]:
        for cq in sorted(scans):
            info = program.classes[cq]
            relpath = self._relpath(program, info.module)
            by_attr: Dict[str, List[_Access]] = {}
            cta: Dict[str, List[Tuple[int, Set[int]]]] = {}
            for name, scan in scans[cq].items():
                if name == "__init__":
                    continue
                for attr, acc in scan.accesses:
                    by_attr.setdefault(attr, []).append(acc)
                for attr, line, wlines in scan.check_then_act:
                    cta.setdefault(attr, []).append((line, wlines))
            for attr in sorted(by_attr):
                accs = by_attr[attr]
                sides = {("thread" if a.fn in thread_side else "main")
                         for a in accs}
                if len(sides) < 2:
                    continue
                ident = f"{info.name}.{attr}"
                if ident in ledger:
                    continue  # declared lock-free; racewatch verifies it
                cta_write_lines: Set[int] = set()
                for line, wlines in cta.get(attr, ()):
                    cta_write_lines |= wlines
                    yield Finding(
                        "racy-check-then-act", relpath, line,
                        f"read-test-write of shared {ident!r} with no lock "
                        "spanning the test and the act: a concurrent writer "
                        "can interleave between them; hold the protecting "
                        "lock across both, or declare the protocol in "
                        "analysis/lockfree_ledger.txt", self.severity)
                guarded = [a for a in accs if a.locks]
                writes = [a for a in accs if a.write and not a.locks
                          and a.line not in cta_write_lines]
                if guarded:
                    common = frozenset.intersection(
                        *[a.locks for a in guarded])
                    if not common and len(guarded) > 1:
                        first = guarded[0]
                        other = next((a for a in guarded[1:]
                                      if not (a.locks & first.locks)),
                                     guarded[-1])
                        yield Finding(
                            "inconsistent-guard", relpath, other.line,
                            f"shared {ident!r} is guarded by "
                            f"{sorted(first.locks)} at "
                            f"{first.method}():{first.line} but by "
                            f"{sorted(other.locks)} here — no common lock "
                            "protects it; pick ONE lock for every access",
                            self.severity)
                        continue  # the guard model is broken; stop here
                    lockname = sorted(common)[0] if common \
                        else sorted(guarded[0].locks)[0]
                    for a in sorted(writes, key=lambda a: a.line):
                        yield Finding(
                            "unguarded-shared-write", relpath, a.line,
                            f"write to shared {ident!r} without holding "
                            f"{lockname!r} (held at "
                            f"{len(guarded)} other access site(s)); a "
                            "cross-thread access here races the guarded "
                            "sites — take the lock, or declare the "
                            "lock-free protocol in "
                            "analysis/lockfree_ledger.txt", self.severity)
                elif writes:
                    a = min(writes, key=lambda a: a.line)
                    yield Finding(
                        "unguarded-shared-write", relpath, a.line,
                        f"shared {ident!r} is written lock-free on both "
                        "thread sides (no access ever holds a lock); "
                        "guard it, or declare the GIL-atomic protocol "
                        "with its invariant in "
                        "analysis/lockfree_ledger.txt", self.severity)

    # -- rule 3: publication safety ----------------------------------------

    def _publication(self, program, scans, thread_side) -> Iterator[Finding]:
        # (b) publish-before-append inside any method of a shared class
        for cq in sorted(scans):
            info = program.classes[cq]
            relpath = self._relpath(program, info.module)
            for name, scan in sorted(scans[cq].items()):
                if name == "__init__":
                    continue
                for line, mattr, battr in scan.sub_stores:
                    if battr is None:
                        continue
                    if any(al > line and ab == battr
                           for al, ab in scan.appends):
                        yield Finding(
                            "unsafe-publication", relpath, line,
                            f"index into shared {info.name}.{mattr!r} "
                            f"published BEFORE {info.name}.{battr!r} is "
                            "appended: a lock-free reader resolving "
                            f"through {mattr!r} reads past the end of "
                            f"{battr!r}; append first, publish last "
                            "(the registry append-before-publish "
                            "invariant)", self.severity)
        # (a) mid-__init__ escape: thread spawn / handoff before the
        # attrs the consumer reads are assigned
        for cq, info in sorted(program.classes.items()):
            init = info.methods.get("__init__")
            if init is None:
                continue
            yield from self._init_publication(program, info, init,
                                              thread_side)

    def _init_publication(self, program, info: ClassInfo,
                          init: FunctionInfo, thread_side
                          ) -> Iterator[Finding]:
        relpath = self._relpath(program, info.module)
        assigns: List[Tuple[int, str]] = []
        thread_vars: Dict[str, str] = {}  # var/self.attr -> target method
        pubs: List[Tuple[int, Optional[str]]] = []  # (line, target method)

        def thread_target(call: ast.Call) -> Optional[str]:
            q = qualname(call.func)
            if q is None or _abs_name(program, init.module, q) != \
                    "threading.Thread":
                return None
            target = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and len(call.args) >= 2:
                target = call.args[1]
            tq = qualname(target) if target is not None else None
            if tq and tq.startswith("self.") and "." not in tq[5:]:
                return tq[5:]
            return None

        for node in ast.walk(init.node):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    tq = qualname(t)
                    if tq and tq.startswith("self.") and "." not in tq[5:]:
                        assigns.append((t.lineno, tq[5:]))
                        if isinstance(node.value, ast.Call):
                            m = thread_target(node.value)
                            if m is not None:
                                thread_vars[tq] = m
                    elif isinstance(t, ast.Name) and \
                            isinstance(node.value, ast.Call):
                        m = thread_target(node.value)
                        if m is not None:
                            thread_vars[t.id] = m
            elif isinstance(node, ast.AnnAssign):
                tq = qualname(node.target)
                if tq and tq.startswith("self.") and "." not in tq[5:]:
                    assigns.append((node.target.lineno, tq[5:]))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if node.func.attr == "start":
                    base = qualname(node.func.value)
                    if base in thread_vars:
                        pubs.append((node.lineno, thread_vars[base]))
                    elif isinstance(node.func.value, ast.Call):
                        m = thread_target(node.func.value)
                        if m is not None:
                            pubs.append((node.lineno, m))
                elif node.func.attr == "submit" and node.args:
                    tq = qualname(node.args[0])
                    if tq and tq.startswith("self.") and \
                            "." not in tq[5:]:
                        pubs.append((node.lineno, tq[5:]))
                elif node.func.attr in _HANDOFF_METHODS:
                    recv = qualname(node.func.value)
                    if recv and (recv == "self"
                                 or recv.startswith("self.")):
                        continue  # self-owned container: not an escape
                    if any(isinstance(a, ast.Name) and a.id == "self"
                           for a in node.args):
                        pubs.append((node.lineno, None))

        for line, target in sorted(pubs):
            later = {a for al, a in assigns if al > line}
            if not later:
                continue
            if target is not None:
                m = info.methods.get(target)
                if m is None:
                    continue
                closure = _closure_of(program, m.qualname)
                reads: Set[str] = set()
                for name, mi in info.methods.items():
                    if mi.qualname in closure:
                        scan = _MethodScan(program, info, mi,
                                           _sync_attrs(info))
                        reads |= {attr for attr, _a in scan.accesses}
                hazard = sorted(later & reads)
                if not hazard:
                    continue
                yield Finding(
                    "unsafe-publication", relpath, line,
                    f"{info.name}.__init__ starts a thread on "
                    f"self.{target} before assigning "
                    f"{', '.join(repr(a) for a in hazard)} — the spawned "
                    "consumer can read a half-constructed instance; "
                    "finish __init__ first (spawn from start(), the "
                    "insert-queue shape)", self.severity)
            else:
                yield Finding(
                    "unsafe-publication", relpath, line,
                    f"{info.name}.__init__ hands `self` to another "
                    "component before assigning "
                    f"{', '.join(repr(a) for a in sorted(later))} — the "
                    "instance escapes half-constructed; publish after "
                    "the last attribute assignment", self.severity)


# ------------------------------------------------- witness protection model


def protection_model(root: str = "m3_tpu_torch") -> Dict[str, List[str]]:
    """{`Class.attr`: sorted protecting-lock identities} for every
    shared attr the static pass can see, derived from the tree's ASTs —
    the acceptance surface analysis/witness.py (race) compares witnessed
    access pairs against (beside the lock-free ledger)."""
    from .core import iter_modules

    program = ProgramIndex(list(iter_modules([root])))
    entries = _spawn_entries(program)
    thread_side = _thread_side(program, entries)
    credit = _caller_held(program, entries)
    model: Dict[str, List[str]] = {}
    for cq, info in program.classes.items():
        if not any(m.qualname in thread_side for m in info.methods.values()):
            continue
        skip = _sync_attrs(info)
        by_attr: Dict[str, List[_Access]] = {}
        for name, m in info.methods.items():
            if name == "__init__":
                continue
            scan = _MethodScan(program, info, m, skip,
                               credit.get(m.qualname, frozenset()))
            for attr, acc in scan.accesses:
                by_attr.setdefault(attr, []).append(acc)
        for attr, accs in by_attr.items():
            guarded = [a.locks for a in accs if a.locks]
            if not guarded:
                continue
            common = frozenset.intersection(*guarded)
            if common:
                model[f"{info.name}.{attr}"] = sorted(common)
    return model
