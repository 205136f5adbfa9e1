"""Lock discipline across the concurrent tiers (storage/, cluster/,
msg/, aggregator/) — the Python analog of what the reference leans on
Go's race detector for.

Per module, the rules build a lock model:

  * lock objects: attributes/names assigned threading.Lock / RLock /
    Condition (plus a `*_lock`/`*_cond` name heuristic for locks that
    arrive via parameters), and queue.Queue attributes.
  * per method: which locks it acquires (`with self._x:`), what it
    acquires WHILE holding one (directly nested `with`, or via a self
    method call whose transitive closure acquires locks), and which
    blocking operations run under a held lock.

Rules:
  lock-order-inversion   two code paths in one module acquire the same
                         pair of locks in opposite orders (ABBA), or a
                         non-reentrant Lock is re-acquired on a path
                         that already holds it (self-deadlock).
  lock-held-blocking-call  socket/sleep/subprocess/queue-get style
                         blocking operations while holding a lock —
                         every other thread needing that lock stalls on
                         peer I/O. `with cond:` bodies are exempt
                         (Condition.wait IS the blocking-under-lock
                         pattern, it releases while waiting).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, Rule, index_functions, qualname

_LOCK_CTORS = {
    "threading.Lock": "lock", "threading.RLock": "rlock",
    "threading.Condition": "cond", "Lock": "lock", "RLock": "rlock",
    "Condition": "cond",
}
_QUEUE_CTORS = {"queue.Queue", "Queue", "queue.SimpleQueue", "SimpleQueue",
                "queue.LifoQueue", "queue.PriorityQueue"}

# blocking by qualified call name
_BLOCKING_CALLS = {
    "time.sleep", "socket.create_connection", "select.select",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "urllib.request.urlopen",
    # repo-specific: framed socket I/O helpers (m3_tpu.rpc.wire)
    "wire.read_frame", "wire.write_frame", "wire.read_dict_frame",
}
# blocking by method name on any receiver (socket objects)
_BLOCKING_METHODS = {"recv", "recv_into", "accept", "makefile", "sendall"}
# blocking only on queue-typed receivers
_QUEUE_BLOCKING_METHODS = {"get", "put", "join"}


def _attr_key(node: ast.AST) -> Optional[str]:
    """Identity of a lock expression: 'self._lock' / 'outer._stats_lock'
    / bare name. None for anything that isn't a plain chain."""
    return qualname(node)


class _LockModel:
    def __init__(self, mod: Module):
        self.mod = mod
        # lock identity (attr name) -> kind ('lock'|'rlock'|'cond')
        self.kinds: Dict[str, str] = {}
        self.queues: Set[str] = set()
        self._scan_ctors()

    def _scan_ctors(self):
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
                value = node.value
            else:
                continue
            if not isinstance(value, ast.Call):
                continue
            ctor = qualname(value.func)
            for target in targets:
                key = _attr_key(target)
                if key is None:
                    continue
                name = key.split(".")[-1]
                if ctor in _LOCK_CTORS:
                    self.kinds[name] = _LOCK_CTORS[ctor]
                elif ctor in _QUEUE_CTORS:
                    self.queues.add(name)

    def lock_kind(self, expr: ast.AST) -> Optional[str]:
        """Kind if `expr` is a with-context we should treat as a lock."""
        key = _attr_key(expr)
        if key is None:
            return None
        name = key.split(".")[-1]
        if name in self.kinds:
            return self.kinds[name]
        low = name.lower()
        if low.endswith("lock") or low == "lock":
            return "lock"
        if low.endswith("cond") or low.endswith("condition"):
            return "cond"
        return None

    def is_queue(self, expr: ast.AST) -> bool:
        key = _attr_key(expr)
        if key is None:
            return False
        name = key.split(".")[-1]
        return name in self.queues or "queue" in name.lower()


def _self_call_name(call: ast.Call) -> Optional[str]:
    """'m' for self.m(...) / cls.m(...), else None."""
    f = call.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")):
        return f.attr
    return None


def _blocking_reason(model: _LockModel, call: ast.Call) -> Optional[str]:
    q = qualname(call.func)
    if q:
        if q in _BLOCKING_CALLS:
            return f"{q}()"
        tail = ".".join(q.split(".")[-2:])
        if tail in _BLOCKING_CALLS:
            return f"{tail}()"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _BLOCKING_METHODS:
            return f".{attr}()"
        if attr == "wait":
            # Condition.wait on a DIFFERENT lock's condition object; bare
            # event.wait too — blocking either way
            return ".wait()"
        if (attr in _QUEUE_BLOCKING_METHODS
                and model.is_queue(call.func.value)):
            return f"queue .{attr}()"
    return None


class _MethodFacts:
    """What one function acquires and does: direct lock set, (held ->
    acquired) edges, (held -> self-call) deferred edges, (held ->
    blocking op) sites, and bare self-calls outside any lock (for the
    transitive acquire closure)."""

    def __init__(self, fn: ast.FunctionDef, model: _LockModel):
        self.fn = fn
        self.model = model
        self.acquires: Dict[str, int] = {}
        self.edges: List[Tuple[str, str, int]] = []
        self.calls_under: List[Tuple[str, str, int]] = []
        self.blocking_under: List[Tuple[str, str, int]] = []
        self.plain_calls: Set[str] = set()
        self._walk(fn.body, held=[])

    def _walk(self, stmts: Sequence[ast.stmt], held: List[Tuple[str, str]]):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes analyzed separately
            if isinstance(stmt, ast.With):
                newly: List[Tuple[str, str]] = []
                for item in stmt.items:
                    for node in ast.walk(item.context_expr):
                        if isinstance(node, ast.Call):
                            self._note_call(node, held)
                    kind = self.model.lock_kind(item.context_expr)
                    if kind is None:
                        continue
                    key = _attr_key(item.context_expr)
                    name = key.split(".")[-1]
                    self.acquires.setdefault(name, stmt.lineno)
                    # `with a, b:` acquires sequentially: earlier items
                    # of this statement are held when later ones acquire
                    for h, _hk in [*held, *newly]:
                        self.edges.append((h, name, stmt.lineno))
                    newly.append((name, kind))
                self._walk(stmt.body, held + newly)
                continue
            # this statement's OWN expressions (nested statement lists are
            # recursed below with their correct held set)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    for node in ast.walk(child):
                        if isinstance(node, ast.Call):
                            self._note_call(node, held)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub:
                    self._walk(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk(h.body, held)

    def _note_call(self, call: ast.Call, held: List[Tuple[str, str]]):
        m = _self_call_name(call)
        if m is not None:
            if held:
                # attribute to the innermost non-condition held lock
                for h, hk in reversed(held):
                    if hk != "cond":
                        self.calls_under.append((h, m, call.lineno))
                        break
            self.plain_calls.add(m)
        if not held:
            return
        # condition bodies are the sanctioned blocking-under-lock shape
        if all(hk == "cond" for _h, hk in held):
            return
        reason = _blocking_reason(self.model, call)
        if reason is not None:
            for h, hk in reversed(held):
                if hk != "cond":
                    self.blocking_under.append((h, reason, call.lineno))
                    break


def _transitive_acquires(facts: Dict[str, _MethodFacts]) -> Dict[str, Set[str]]:
    """method -> every lock its call closure can acquire."""
    out: Dict[str, Set[str]] = {
        name: set(f.acquires) for name, f in facts.items()}
    changed = True
    while changed:
        changed = False
        for name, f in facts.items():
            for callee in f.plain_calls:
                more = out.get(callee)
                if more and not more <= out[name]:
                    out[name] |= more
                    changed = True
    return out


def _transitive_blocking(facts: Dict[str, _MethodFacts],
                         ) -> Dict[str, List[Tuple[str, int]]]:
    """method -> blocking ops reachable through its call closure (one
    level deep is enough for this codebase's helper style; deeper chains
    converge through the closure loop)."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for name, f in facts.items():
        seen: Set[str] = set()
        ops: List[Tuple[str, int]] = []

        def visit(n: str, depth: int):
            if n in seen or depth > 4 or n not in facts:
                return
            seen.add(n)
            fx = facts[n]
            for node in ast.walk(fx.fn):
                if isinstance(node, ast.Call):
                    r = _blocking_reason(fx.model, node)
                    if r is not None:
                        ops.append((r, node.lineno))
            for callee in fx.plain_calls:
                visit(callee, depth + 1)

        # include the method's OWN blocking ops: a caller holding a lock
        # across `self.m()` blocks on everything m does, lock or not
        visit(name, 0)
        out[name] = ops
    return out


class LockDisciplineRule(Rule):
    """lock-order-inversion + lock-held-blocking-call over one module's
    lock graph."""

    id = "lock-discipline"  # umbrella; findings carry specific ids
    severity = "error"
    # parallel/ and query/: the plan compiler's compile-cache locks and
    # the remote-storage exchange lock are the locks the multi-device
    # mesh work contends
    dirs = ("storage", "cluster", "msg", "aggregator", "persist",
            "parallel", "query")

    def check(self, mod: Module) -> Iterator[Finding]:
        model = _LockModel(mod)
        # bare-name method index (methods don't collide meaningfully
        # within the modules this rule scopes to)
        methods = index_functions(mod)
        facts = {name: _MethodFacts(fn, model)
                 for name, fn in methods.items()}
        closure = _transitive_acquires(facts)

        # direct + call-mediated (held -> acquired) edges
        edges: Dict[Tuple[str, str], int] = {}
        for name, f in facts.items():
            for a, b, line in f.edges:
                edges.setdefault((a, b), line)
            for held, callee, line in f.calls_under:
                for b in closure.get(callee, ()):
                    edges.setdefault((held, b), line)

        reported: Set[Tuple[str, str]] = set()
        for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
            if a == b:
                if model.kinds.get(a, "lock") == "lock":
                    yield Finding(
                        "lock-order-inversion", mod.relpath, line,
                        f"non-reentrant lock {a!r} re-acquired on a path "
                        "that already holds it (self-deadlock); use an "
                        "RLock or split the locked helper",
                        self.severity)
                continue
            if (b, a) in edges and (b, a) not in reported:
                reported.add((a, b))
                yield Finding(
                    "lock-order-inversion", mod.relpath, line,
                    f"lock order inversion: {a!r} -> {b!r} here but "
                    f"{b!r} -> {a!r} at line {edges[(b, a)]}; two threads "
                    "taking opposite orders deadlock — pick one order",
                    self.severity)

        # blocking ops while holding a lock (direct + one call level)
        emitted: Set[Tuple[int, str]] = set()
        for name, f in facts.items():
            for held, reason, line in f.blocking_under:
                if (line, reason) not in emitted:
                    emitted.add((line, reason))
                    yield Finding(
                        "lock-held-blocking-call", mod.relpath, line,
                        f"blocking {reason} while holding {held!r} — "
                        "every thread contending on that lock stalls "
                        "behind this I/O; move it outside the critical "
                        "section or snapshot state first",
                        self.severity)
        blocking_closure = _transitive_blocking(facts)
        for name, f in facts.items():
            for held, callee, line in f.calls_under:
                for reason, bline in blocking_closure.get(callee, ())[:1]:
                    if (line, reason) in emitted:
                        continue
                    emitted.add((line, reason))
                    yield Finding(
                        "lock-held-blocking-call", mod.relpath, line,
                        f"call to {callee!r} while holding {held!r} "
                        f"reaches blocking {reason} (line {bline}); move "
                        "the call outside the critical section",
                        self.severity)


# Per-item mutation calls that mark a hot loop: one dict/registry/index
# mutation per iteration while every other writer waits on the lock.
# Batch entrypoints (insert_batch, insert_many, get_or_create_batch*) do
# NOT match — exact names only — because one batched call per lock hold
# is precisely the fix.
_HOT_MUTATION_METHODS = frozenset({"get_or_create", "setdefault", "insert"})


class HotLoopUnderLockRule(Rule):
    """hot-loop-under-lock: a per-item Python loop performing dict-style
    mutations (`get_or_create(...)`, `.setdefault(...)`, `.insert(...)`)
    inside a `with <lock>` block in the storage/index/aggregator write
    paths. Every iteration pays a Python-level mutation while every
    other writer of that lock waits — the shape the insert-queue rebuild
    removed from Shard.write_batch (shard_insert_queue.go batches these
    into ONE apply per drain). Fix by resolving/batching outside the
    lock and applying through a bulk entrypoint (insert_batch /
    insert_many / get_or_create_batch_tagged), or justify-suppress a
    cold-path loop."""

    id = "hot-loop-under-lock"
    severity = "warning"
    dirs = ("storage", "index", "aggregator", "parallel", "testing")

    def check(self, mod: Module) -> Iterator[Finding]:
        model = _LockModel(mod)
        seen: Set[int] = set()  # a loop nested in two locked withs reports once
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            lock_name = None
            for item in node.items:
                kind = model.lock_kind(item.context_expr)
                if kind in ("lock", "rlock"):
                    key = _attr_key(item.context_expr)
                    lock_name = key.split(".")[-1]
                    break
            if lock_name is None:
                continue
            for loop in self._loops_in(node.body):
                call = self._first_mutation(loop)
                if call is not None and call.lineno not in seen:
                    seen.add(call.lineno)
                    yield Finding(
                        self.id, mod.relpath, call.lineno,
                        f"per-item .{call.func.attr}() loop while holding "
                        f"{lock_name!r} — every writer contending on that "
                        "lock waits out N Python-level mutations; batch "
                        "outside the lock and apply through a bulk "
                        "entrypoint (insert_batch / insert_many / "
                        "get_or_create_batch_tagged), or justify-suppress "
                        "a cold path",
                        self.severity)

    def _loops_in(self, stmts) -> Iterator[ast.AST]:
        """Loop statements anywhere under `stmts`, NOT descending into
        nested function/class scopes (they run on their own call stack,
        not under this with-block's hold)."""
        stack = list(stmts)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, (ast.For, ast.While)):
                yield node
                continue  # _first_mutation scans the whole loop body
            stack.extend(ast.iter_child_nodes(node))

    def _first_mutation(self, loop: ast.AST) -> Optional[ast.Call]:
        for sub in ast.walk(loop):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _HOT_MUTATION_METHODS:
                return sub
        return None


# Function names that mark the aggregator's flush/emission paths and the
# coordinator's downsample write path, and callback names whose
# per-iteration invocation marks the per-datapoint emit shape:
# `flush_fn` / `forward_fn` style sink parameters, plus the aggregator's
# per-metric `add_untimed` entry point (the shape the compiled streaming
# rules engine replaced with grouped add_untimed_batch feeds).
_FLUSH_FN_NAME = re.compile(r"flush|emit|consume|reduce|write")
_CALLBACK_NAME = re.compile(r"^(\w*_fn|add_untimed)$")


class FlushCallbackLoopRule(Rule):
    """per-datapoint-callback-in-flush: a Python loop on an aggregator
    flush/emit/consume path — or the coordinator's downsample write
    path — invoking a per-datapoint callback (`*_fn(...)` sinks, or the
    aggregator's per-metric `add_untimed`) once per iteration. Every
    flushed window / ingest batch then pays a Python call frame per
    datapoint while the whole tier waits — the shape the columnar flush
    rebuild removed from Elem.emit / reduce_and_emit and the compiled
    rules engine removed from Downsampler.write (one handle_columnar /
    add_untimed_batch call per group instead of a callback per
    datapoint). Fix by emitting through the columnar batch interfaces
    (emit_batch -> handle_columnar / forward_batch / add_untimed_batch),
    or justify-suppress a deliberate compat shim. Functions suffixed
    `_ref` are exempt: retained oracles (reduce_and_emit_ref, write_ref)
    preserve the pre-change shape by design."""

    id = "per-datapoint-callback-in-flush"
    severity = "warning"
    dirs = ("aggregator", "coordinator")

    def check(self, mod: Module) -> Iterator[Finding]:
        seen: Set[int] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name.endswith("_ref"):
                continue
            if not _FLUSH_FN_NAME.search(node.name):
                continue
            for loop in self._loops_in(node.body):
                call = self._callback_call(loop)
                if call is not None and loop.lineno not in seen:
                    seen.add(loop.lineno)
                    name = (call.func.id if isinstance(call.func, ast.Name)
                            else call.func.attr)
                    yield Finding(
                        self.id, mod.relpath, loop.lineno,
                        f"per-datapoint {name}(...) callback inside a loop "
                        f"in {node.name!r} — every flushed window pays a "
                        "Python call frame; emit through the columnar "
                        "batch path (emit_batch -> handle_columnar / "
                        "forward_batch), or justify-suppress a compat "
                        "shim (retained *_ref oracles are exempt)",
                        self.severity)

    def _loops_in(self, stmts) -> Iterator[ast.AST]:
        """Loop statements anywhere under `stmts`, NOT descending into
        nested function/class scopes."""
        stack = list(stmts)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, (ast.For, ast.While)):
                yield node
                continue  # _callback_call scans the whole loop body
            stack.extend(ast.iter_child_nodes(node))

    def _callback_call(self, loop: ast.AST) -> Optional[ast.Call]:
        for sub in ast.walk(loop):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            name = (f.id if isinstance(f, ast.Name)
                    else f.attr if isinstance(f, ast.Attribute) else None)
            if name is not None and _CALLBACK_NAME.match(name):
                return sub
        return None


RULES: List[Rule] = [LockDisciplineRule(), HotLoopUnderLockRule(),
                     FlushCallbackLoopRule()]
