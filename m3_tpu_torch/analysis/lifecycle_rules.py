"""Resource-lifecycle dataflow: paired acquire/release operations must
balance on EVERY path through a function — the normal ones and the
exceptional ones — or legally hand the obligation off.

Every invariant this family checks was established in prose by an
earlier PR and (until now) enforced only by hand-written regression
tests:

  * `AdmissionGate.admit` must pair with `release` (utils/health.py —
    "every successful admit MUST be paired with release"),
  * a `Breaker.allow()` grant must settle exactly once via
    `record_success` / `record_failure` / `cancel` (utils/retry.py —
    "an unreleased slot wedges the breaker half-open forever"),
  * an `Enforcer.add` charge must be `release`d or the budget leaks
    from the global parent for the process lifetime (utils/cost.py),
  * an HBM budget `charge` must pair with `release` for the buffer's
    lifetime (utils/hbm.py),
  * a manually-entered span must be finished on every path — the
    straggler-replica fanout path that returned early on quorum and
    left the replica span open is the seeded positive.

The checker is PATH-SENSITIVE over the function body: an acquire is
balanced when (a) it is the context expression of a `with` (or the
gate's `held()` form), (b) a `try/finally` releases it, (c) every
normal path reaches a matching release AND the held region's risky
calls are covered by broad handlers that settle before exiting, or
(d) the obligation legally ESCAPES — the handle is returned, stored
into `self`, or passed to another callable (a transfer). Releases may
be indirect through a local helper up to two call levels deep (the
`record(ok)` closure idiom in client/session.py). A receiver stored on
`self` whose release lives in a DIFFERENT method of the same class is
a cross-method protocol (insert-queue admits on `insert`, releases on
drain) and is exempt per site.

Two further rules reconstruct the exact bug shapes fixed in PRs 4/6:

  release-none-parent-leak   a `release(cost=None)` that forwards the
      RAW maybe-None amount to `self.parent.release`, or guards the
      parent credit on truthiness of the raw parameter — the historical
      Enforcer.release(None) shape: every completed query permanently
      leaked its charge from the global budget.
  finalizer-under-lock       a `weakref.finalize` callback that
      acquires a lock (directly or one call level deep). Finalizers
      run at ANY bytecode boundary — including while the same thread
      holds that lock — so they must stay lock-free (the
      HBMBudget transient-release fix).

The modules that DEFINE the paired primitives (utils/retry.py,
utils/health.py, utils/cost.py, utils/limits.py, utils/hbm.py,
utils/tracing.py, utils/lockdep.py) are exempt: their internals are
the machinery itself, reviewed with the primitive.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import Finding, Module, Rule, qualname
from .lock_rules import _LockModel

__all__ = ["LifecycleRule", "ReleaseNoneParentLeakRule",
           "FinalizerUnderLockRule", "RULES"]


@dataclasses.dataclass(frozen=True)
class _Pair:
    key: str                      # short family name for messages
    acquire: frozenset            # acquire method names
    release: frozenset            # settle method names
    types: frozenset              # receiver class/ctor names
    hints: Tuple[str, ...]        # receiver-name substrings
    why: str                      # consequence clause for the message


_PAIRS: Tuple[_Pair, ...] = (
    _Pair("gate-admit", frozenset({"admit"}), frozenset({"release"}),
          frozenset({"AdmissionGate"}), ("gate",),
          "an unreleased admit pins gate depth forever and the gate "
          "sheds at a phantom watermark"),
    _Pair("breaker-allow", frozenset({"allow"}),
          frozenset({"record_success", "record_failure", "cancel"}),
          frozenset({"Breaker"}), ("breaker",),
          "an unsettled allow() grant leaks the half-open probe slot "
          "and wedges the breaker half-open forever"),
    _Pair("enforcer-charge", frozenset({"add", "charge"}),
          frozenset({"release"}),
          frozenset({"Enforcer"}), ("enforcer",),
          "an unreleased charge leaks from the global parent budget "
          "for the process lifetime (the release(None) leak class)"),
    _Pair("budget-charge", frozenset({"charge"}), frozenset({"release"}),
          frozenset({"HBMBudget"}), ("budget",),
          "an unreleased charge pins phantom HBM bytes against the "
          "process-wide budget"),
)

_SPAN_CREATORS = frozenset({"span", "child_span", "span_from"})
_SPAN_RECEIVERS = ("tracer", "tracing")

# Modules defining the primitives: their internals ARE the machinery.
_EXEMPT = {
    ("utils", "retry.py"), ("utils", "health.py"), ("utils", "cost.py"),
    ("utils", "limits.py"), ("utils", "hbm.py"), ("utils", "tracing.py"),
    ("utils", "lockdep.py"),
}

_BROAD = {"Exception", "BaseException"}

# analysis states for one tracked obligation
_BEFORE, _HELD, _DONE = 0, 1, 2


def _last(key: str) -> str:
    return key.rsplit(".", 1)[-1]


def _index_defs(mod: Module) -> Dict[str, ast.AST]:
    """Every function def per bare name (outermost wins) — local-helper
    resolution for indirect settles."""
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _receiver_types(mod: Module) -> Dict[str, str]:
    """'self.attr'/local-name -> pair-relevant type name, from ctor
    calls and annotations anywhere in the module. Bare names only need
    to match the ctor's LAST component (`health.AdmissionGate(...)`)."""
    wanted = set()
    for p in _PAIRS:
        wanted |= p.types
    out: Dict[str, str] = {}
    for node in ast.walk(mod.tree):
        targets: List[ast.AST] = []
        value: Optional[ast.AST] = None
        ann: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets, value = list(node.targets), node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value, ann = [node.target], node.value, node.annotation
        else:
            continue
        typ = None
        if isinstance(value, ast.Call):
            ctor = qualname(value.func)
            if ctor and _last(ctor) in wanted:
                typ = _last(ctor)
        if typ is None and ann is not None:
            aq = qualname(ann)
            if aq and _last(aq) in wanted:
                typ = _last(aq)
        if typ is None:
            continue
        for t in targets:
            key = qualname(t)
            if key:
                out[key] = typ
    return out


def _settles_map(mod: Module) -> Dict[str, Set[Tuple[str, str]]]:
    """function bare name -> {(release method, receiver last component)}
    reachable within two local call levels — resolves the
    `record(ok) -> self._record(ok) -> self.breaker.record_success()`
    indirection."""
    defs = _index_defs(mod)
    release_names = set().union(*(p.release for p in _PAIRS))
    direct: Dict[str, Set[Tuple[str, str]]] = {}
    calls: Dict[str, Set[str]] = {}
    for name, fn in defs.items():
        got: Set[Tuple[str, str]] = set()
        out: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                recv = qualname(f.value)
                if f.attr in release_names and recv is not None:
                    got.add((f.attr, _last(recv)))
                if recv in ("self", "cls"):
                    out.add(f.attr)
            elif isinstance(f, ast.Name):
                out.add(f.id)
        direct[name] = got
        calls[name] = out
    # two propagation passes = two call levels deep
    for _ in range(2):
        for name in defs:
            for callee in calls[name]:
                if callee in direct and callee != name:
                    direct[name] |= direct[callee]
    return direct


@dataclasses.dataclass
class _Problem:
    kind: str      # 'path' | 'exception'
    detail: str


class _Site:
    """One tracked obligation: a paired-op acquire or a span handle."""

    def __init__(self, call: ast.Call, receiver: str, pair: Optional[_Pair],
                 handle: Optional[str] = None):
        self.call = call
        self.receiver = receiver      # qualname at the acquire
        self.pair = pair              # None for span sites
        self.handle = handle          # bound name for span handles
        self.line = call.lineno

    @property
    def recv_last(self) -> str:
        return _last(self.receiver)

    def is_release(self, call: ast.Call,
                   settles: Dict[str, Set[Tuple[str, str]]]) -> bool:
        f = call.func
        if self.pair is None:
            # span: handle.__exit__ / handle.finish
            return (isinstance(f, ast.Attribute)
                    and f.attr in ("__exit__", "finish")
                    and qualname(f.value) == self.handle)
        if isinstance(f, ast.Attribute):
            recv = qualname(f.value)
            if f.attr in self.pair.release and recv is not None and \
                    (recv == self.receiver or _last(recv) == self.recv_last):
                return True
            if recv in ("self", "cls"):
                got = settles.get(f.attr, ())
                return any(m in self.pair.release and r == self.recv_last
                           for m, r in got)
            return False
        if isinstance(f, ast.Name):
            got = settles.get(f.id, ())
            return any(m in self.pair.release and r == self.recv_last
                       for m, r in got)
        return False

    def escape_name(self) -> str:
        """The name whose escape transfers the obligation."""
        return self.handle if self.handle is not None else self.receiver


class _Balance:
    """Path-sensitive walk of one function for one obligation site."""

    def __init__(self, fn: ast.AST, site: _Site,
                 settles: Dict[str, Set[Tuple[str, str]]]):
        self.fn = fn
        self.site = site
        self.settles = settles
        self.problems: List[_Problem] = []
        # stack of enclosing try protections while walking
        self._protect: List[Tuple[bool, bool]] = []  # (finally_rel, handler)

    # ------------------------------------------------------------ helpers

    def _contains(self, node: ast.AST, target: ast.AST) -> bool:
        return any(n is target for n in ast.walk(node))

    def _releases_in(self, node: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and self.site.is_release(n, self.settles)
                   for n in ast.walk(node))

    def _escapes(self, expr: ast.AST) -> bool:
        """Does `expr` hand the obligation off? The handle/receiver
        returned as a whole value (or inside a returned container), or
        passed as a call argument — including passing a local SETTLE
        CLOSURE (a function whose body settles this receiver, the
        `record(ok)` callback handoff in client/session.py)."""
        want = self.site.escape_name()
        if want is None:
            return False
        if qualname(expr) == want:
            return True
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                for a in [*n.args, *[k.value for k in n.keywords]]:
                    if qualname(a) == want:
                        return True
                    if isinstance(a, ast.Name) and self.site.pair is not None:
                        got = self.settles.get(a.id)
                        if got and any(
                                m in self.site.pair.release
                                and r == self.site.recv_last
                                for m, r in got):
                            return True
            elif isinstance(n, (ast.Tuple, ast.List, ast.Set)):
                if any(qualname(e) == want for e in n.elts):
                    return True
        return False

    def _risky(self, stmt: ast.AST) -> bool:
        """Can this statement raise mid-flight? Any call that is not the
        acquire and not a matching release counts."""
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call) and n is not self.site.call \
                    and not self.site.is_release(n, self.settles):
                return True
        return isinstance(stmt, ast.Raise)

    def _protected(self) -> bool:
        return any(fin or hnd for fin, hnd in self._protect)

    def _problem(self, kind: str, detail: str):
        if not any(p.kind == kind for p in self.problems):
            self.problems.append(_Problem(kind, detail))

    # --------------------------------------------------------------- walk

    def run(self) -> List[_Problem]:
        states = self.walk(self.fn.body, {_BEFORE})
        if _HELD in states:
            self._problem("path", "still held when the function falls "
                                  "off the end")
        return self.problems

    def _join(self, *state_sets: Set[int]) -> Set[int]:
        out: Set[int] = set()
        for s in state_sets:
            out |= s
        return out

    def walk(self, stmts: Sequence[ast.stmt], states: Set[int]) -> Set[int]:
        for stmt in stmts:
            if not states:
                return states  # unreachable
            states = self._stmt(stmt, states)
        return states

    def _exit_check(self, stmt: ast.AST, states: Set[int], what: str):
        if _HELD not in states:
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None and self._escapes(stmt.value):
                return
            # an enclosing finally-release runs on return too (a
            # handler does not — it only covers the raise paths)
            if any(fin for fin, _hnd in self._protect):
                return
        if isinstance(stmt, ast.Raise) and self._protected():
            return
        self._problem("path", f"{what} on a path that still holds the "
                              f"obligation (line {stmt.lineno})")

    def _stmt(self, stmt: ast.AST, states: Set[int]) -> Set[int]:
        site = self.site
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return states

        # risky statements while the obligation may be held
        if _HELD in states and self._risky(stmt) \
                and not isinstance(stmt, (ast.Try, ast.With, ast.If,
                                          ast.For, ast.While,
                                          ast.Return, ast.Raise)) \
                and not self._protected():
            if not (self._releases_in(stmt) or self._escapes_stmt(stmt)):
                self._problem(
                    "exception",
                    f"call at line {stmt.lineno} can raise while the "
                    "obligation is held and nothing releases it on that "
                    "path (wrap in try/finally or settle in a broad "
                    "handler)")

        if isinstance(stmt, (ast.Return, ast.Raise)):
            if _HELD in states:
                self._exit_check(stmt, states, type(stmt).__name__.lower())
            return set()
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return states  # approximate: falls to after-loop

        if isinstance(stmt, ast.With):
            newly_held = False
            for item in stmt.items:
                if self._contains(item.context_expr, site.call):
                    # acquire used AS a context manager: fully balanced
                    states = (states - {_BEFORE}) | {_DONE}
                    return self.walk(stmt.body, states)
                if site.handle is not None and \
                        qualname(item.context_expr) == site.handle:
                    newly_held = True
            body_states = self.walk(
                stmt.body, states | ({_HELD} if newly_held else set()))
            if newly_held:
                # `with handle:` guarantees __exit__ on every path out
                body_states = (body_states - {_HELD}) | {_DONE}
            return body_states

        if isinstance(stmt, ast.Try):
            fin_rel = any(self._releases_in(s) for s in stmt.finalbody)
            handlers_settle = bool(stmt.handlers) and all(
                any(self._releases_in(s) for s in h.body) or
                not self._handler_matters(h)
                for h in stmt.handlers) and self._covers_broad(stmt.handlers)
            self._protect.append((fin_rel, handlers_settle))
            body_states = self.walk(stmt.body, states)
            held_possible = _HELD in body_states or (
                _HELD in states) or self._contains_acquire(stmt.body)
            handler_states: Set[int] = set()
            for h in stmt.handlers:
                entry = set(states)
                if held_possible:
                    entry = entry | {_HELD}
                hs = self.walk(h.body, entry)
                handler_states |= hs
            self._protect.pop()
            out = self._join(body_states, handler_states)
            out = self.walk(stmt.orelse, out) if stmt.orelse else out
            if stmt.finalbody:
                out = self.walk(stmt.finalbody, out)
                if fin_rel:
                    out = (out - {_HELD}) | {_DONE}
            return out

        if isinstance(stmt, ast.If):
            if self._contains(stmt.test, site.call):
                return self._acquire_in_if(stmt, states)
            then = self.walk(stmt.body, set(states))
            els = self.walk(stmt.orelse, set(states))
            return self._join(then, els)

        if isinstance(stmt, (ast.For, ast.While)):
            body = self.walk(list(stmt.body), set(states))
            out = self._join(states, body,
                             self.walk(list(stmt.orelse), set(states))
                             if stmt.orelse else set())
            return out

        # ----- simple statements ------------------------------------
        return self._simple(stmt, states)

    def _contains_acquire(self, stmts: Sequence[ast.stmt]) -> bool:
        return any(self._contains(s, self.site.call) for s in stmts)

    def _handler_matters(self, h: ast.ExceptHandler) -> bool:
        """Handlers that immediately re-raise without other statements
        neither settle nor leak — they forward the exception outward."""
        return not (len(h.body) == 1 and isinstance(h.body[0], ast.Raise)
                    and h.body[0].exc is None)

    def _covers_broad(self, handlers) -> bool:
        for h in handlers:
            t = h.type
            if t is None:
                return True
            names = [qualname(e) for e in t.elts] \
                if isinstance(t, ast.Tuple) else [qualname(t)]
            if any(n is not None and _last(n) in _BROAD for n in names):
                return True
        return False

    def _acquire_in_if(self, stmt: ast.If, states: Set[int]) -> Set[int]:
        """`if not X.allow(): <shed>` (held AFTER the If when the body
        exits) and `if X.allow(): <granted body>` (held WITHIN)."""
        negated = isinstance(stmt.test, ast.UnaryOp) and \
            isinstance(stmt.test.op, ast.Not)
        if negated:
            body_states = self.walk(stmt.body, set(states))
            granted = (states - {_BEFORE}) | {_HELD}
            if stmt.orelse:
                # `if not X.allow(): shed else: <granted work>` — the
                # grant lives in the ELSE branch, settle and all
                els = self.walk(stmt.orelse, set(granted))
                return self._join(body_states, els)
            after = granted
            if body_states:
                # shed branch falls through: both armed and unarmed
                after |= body_states
            return after
        then = self.walk(stmt.body, (states - {_BEFORE}) | {_HELD})
        els = self.walk(stmt.orelse, set(states))
        return self._join(then, els)

    def _escapes_stmt(self, stmt: ast.AST) -> bool:
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr) and self._escapes(child):
                return True
        return False

    def _simple(self, stmt: ast.AST, states: Set[int]) -> Set[int]:
        site = self.site
        out = set(states)
        if self._contains(stmt, site.call):
            out = (out - {_BEFORE}) | {_HELD}
            if site.handle is not None:
                # span creation only CREATES; __enter__ arms it —
                # handled below when the enter call is this statement
                out = (out - {_HELD}) | {_BEFORE}
        # span __enter__ arms the obligation
        if site.handle is not None:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr == "__enter__" and \
                        qualname(n.func.value) == site.handle:
                    out = (out - {_BEFORE}) | {_HELD}
        if _HELD in out:
            if self._releases_in(stmt) or (
                    self._escapes_stmt(stmt)
                    and not self._contains(stmt, site.call)):
                out = (out - {_HELD}) | {_DONE}
        return out


class LifecycleRule(Rule):
    """resource-lifecycle umbrella: lifecycle-leak /
    lifecycle-exception-leak / span-unfinished findings over the paired
    acquire/release table and manually-entered spans."""

    id = "resource-lifecycle"
    severity = "error"

    def applies(self, mod: Module) -> bool:
        return tuple(mod.scope_parts[-2:]) not in _EXEMPT

    # ------------------------------------------------------- site discovery

    @staticmethod
    def _walk_scope(fn: ast.AST):
        """Nodes of fn's OWN scope — nested function/class subtrees are
        pruned (they run on their own call stack; their sites are
        discovered when their own def is visited)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _pair_sites(self, fn: ast.AST, types: Dict[str, str]
                    ) -> List[_Site]:
        sites: List[_Site] = []
        for node in self._walk_scope(fn):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Attribute):
                continue
            recv = qualname(node.func.value)
            if recv is None:
                continue
            for pair in _PAIRS:
                if node.func.attr not in pair.acquire:
                    continue
                typed = types.get(recv) in pair.types
                hinted = any(h in _last(recv).lower() for h in pair.hints)
                if (typed or hinted) and not self._scope_owned(fn, recv):
                    sites.append(_Site(node, recv, pair))
                    break
        return sites

    @staticmethod
    def _scope_owned(fn: ast.AST, recv: str) -> bool:
        """A receiver pulled from THREAD-LOCAL scope state
        (`getattr(self._local, "enforcer", None)`, `current_scope()`)
        is owned by whoever installed the scope — the installer's
        finally releases the whole charge (the QueryScope protocol).
        The charge site merely bills it; the obligation never lived in
        this function."""
        head = recv.split(".", 1)[0]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == head
                       for t in node.targets):
                continue
            for n in ast.walk(node.value):
                if isinstance(n, ast.Attribute) and "_local" in n.attr:
                    return True
                q = qualname(n)
                if q is not None and ("_local" in q
                                      or _last(q) == "current_scope"):
                    return True
        return False

    def _span_sites(self, fn: ast.AST) -> List[_Site]:
        """Span handles: `h = TRACER.span(...)` followed by a manual
        h.__enter__() somewhere in the same function."""
        sites: List[_Site] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)):
                continue
            call = node.value
            if call.func.attr not in _SPAN_CREATORS:
                continue
            recv = qualname(call.func.value) or ""
            if not any(h in recv.lower() for h in _SPAN_RECEIVERS):
                continue
            handle = node.targets[0].id
            entered = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "__enter__"
                and qualname(n.func.value) == handle
                for n in ast.walk(fn))
            if entered:
                sites.append(_Site(call, recv, None, handle=handle))
        return sites

    # -------------------------------------------------------------- checking

    def check(self, mod: Module) -> Iterator[Finding]:
        types = _receiver_types(mod)
        settles = _settles_map(mod)
        for fn in [n for n in ast.walk(mod.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            if fn.name.endswith("_ref"):
                continue
            for site in self._pair_sites(fn, types):
                if self._with_form(fn, site):
                    continue
                if self._cross_method_protocol(mod, fn, site, settles):
                    continue
                yield from self._report(mod, fn, site, settles)
            for site in self._span_sites(fn):
                yield from self._report(mod, fn, site, settles, span=True)

    def _with_form(self, fn: ast.AST, site: _Site) -> bool:
        """Acquire used as a `with` context expression."""
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    if any(n is site.call
                           for n in ast.walk(item.context_expr)):
                        return True
        return False

    def _cross_method_protocol(self, mod: Module, fn: ast.AST, site: _Site,
                               settles) -> bool:
        """`self.X.acquire` whose matching release lives in ANOTHER
        method of the same module — the insert-queue admit-on-insert /
        release-on-drain protocol. The obligation is owned by the
        object's lifecycle, not this function's."""
        if not site.receiver.startswith("self."):
            return False
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) or node is fn:
                continue
            if self._nested_in(mod, node, fn):
                continue  # fn's own closures are not "another method"
            for n in ast.walk(node):
                if isinstance(n, ast.Call) and \
                        site.is_release(n, settles):
                    return True
        return False

    @staticmethod
    def _nested_in(mod: Module, node: ast.AST, fn: ast.AST) -> bool:
        cur = mod.parent(node)
        while cur is not None:
            if cur is fn:
                return True
            cur = mod.parent(cur)
        return False

    def _report(self, mod: Module, fn: ast.AST, site: _Site, settles,
                span: bool = False) -> Iterator[Finding]:
        problems = _Balance(fn, site, settles).run()
        for p in problems:
            if span:
                yield Finding(
                    "span-unfinished", mod.relpath, site.line,
                    f"span handle {site.handle!r} in {fn.name!r} is "
                    f"entered manually but not finished on every path: "
                    f"{p.detail} — an unfinished span never lands in "
                    "/debug/traces and its parent's tree is torn (the "
                    "straggler-replica shape); use `with` or a "
                    "try/finally __exit__", self.severity)
                return
            what = f"{site.receiver}.{site.call.func.attr}()"
            if p.kind == "exception":
                yield Finding(
                    "lifecycle-exception-leak", mod.relpath, site.line,
                    f"{site.pair.key}: {what} in {fn.name!r} is not "
                    f"exception-safe: {p.detail}; {site.pair.why}",
                    self.severity)
            else:
                yield Finding(
                    "lifecycle-leak", mod.relpath, site.line,
                    f"{site.pair.key}: {what} in {fn.name!r} has no "
                    f"matching {'/'.join(sorted(site.pair.release))} — "
                    f"{p.detail}; {site.pair.why}", self.severity)
            return


class ReleaseNoneParentLeakRule(Rule):
    """release-none-parent-leak: the historical Enforcer.release(None)
    shape — a parent/child paired-op forwarder whose parent credit uses
    (or is guarded on) the RAW maybe-None amount instead of the amount
    actually released locally."""

    id = "release-none-parent-leak"
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        for cls in [n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) or \
                        fn.name != "release":
                    continue
                param = self._none_default_param(fn)
                if param is None:
                    continue
                yield from self._check_forwards(mod, fn, param)

    @staticmethod
    def _none_default_param(fn) -> Optional[str]:
        args = [a.arg for a in fn.args.args if a.arg not in ("self", "cls")]
        defaults = fn.args.defaults
        if not args or not defaults:
            return None
        # map trailing defaults to trailing args
        for arg, d in zip(args[-len(defaults):], defaults):
            if isinstance(d, ast.Constant) and d.value is None:
                return arg
        return None

    def _check_forwards(self, mod: Module, fn, param: str
                        ) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "release"):
                continue
            recv = qualname(node.func.value)
            if recv is None or _last(recv) != "parent":
                continue
            if any(isinstance(a, ast.Name) and a.id == param
                   for a in node.args):
                yield Finding(
                    self.id, mod.relpath, node.lineno,
                    f"parent credit forwards the raw maybe-None "
                    f"{param!r}: release({param}=None) must credit the "
                    "amount actually released locally, captured BEFORE "
                    "the local decrement — forwarding None releases the "
                    "parent's whole charge (or nothing under a "
                    "truthiness guard)", self.severity)
                continue
            guard = self._truthiness_guard(mod, node, param)
            if guard is not None:
                yield Finding(
                    self.id, mod.relpath, node.lineno,
                    f"parent credit guarded on truthiness of the raw "
                    f"maybe-None {param!r} (line {guard}): the full-"
                    f"release {param}=None path never credits the "
                    "parent — every completed caller permanently leaks "
                    "its charge from the global budget (the historical "
                    "Enforcer.release(None) leak)", self.severity)

    @staticmethod
    def _truthiness_guard(mod: Module, call: ast.Call, param: str
                          ) -> Optional[int]:
        """Line of an enclosing If whose test uses bare `param`
        truthiness (not under `is None` comparison)."""
        cur = mod.parent(call)
        while cur is not None:
            if isinstance(cur, ast.If):
                for n in ast.walk(cur.test):
                    if isinstance(n, ast.Name) and n.id == param:
                        p = mod.parent(n)
                        if isinstance(p, ast.Compare) and all(
                                isinstance(op, (ast.Is, ast.IsNot))
                                for op in p.ops):
                            continue
                        return cur.lineno
            cur = mod.parent(cur)
        return None


class FinalizerUnderLockRule(Rule):
    """finalizer-under-lock: a `weakref.finalize` callback that acquires
    a lock, directly or one local call level deep. The cyclic GC may run
    finalizers at ANY bytecode boundary — including while the thread
    already holds that lock — so a locking finalizer is a latent
    self-deadlock (the HBMBudget shape: append to a GIL-atomic
    list, drain under the lock elsewhere)."""

    id = "finalizer-under-lock"
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        model = _LockModel(mod)
        defs = _index_defs(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and len(node.args) >= 2):
                continue
            q = qualname(node.func)
            if q not in ("weakref.finalize", "finalize"):
                continue
            cb = node.args[1]
            cb_name = None
            cbq = qualname(cb)
            if cbq is not None:
                cb_name = _last(cbq)
            if cb_name is None or cb_name not in defs:
                continue
            lock_line = self._locks_in(defs[cb_name], model, defs, depth=0)
            if lock_line is not None:
                yield Finding(
                    self.id, mod.relpath, node.lineno,
                    f"weakref.finalize callback {cb_name!r} acquires a "
                    f"lock (line {lock_line}): finalizers run at any "
                    "bytecode boundary, including while this thread "
                    "already holds that lock — keep finalizers lock-free "
                    "(append to a GIL-atomic list and drain it under the "
                    "lock elsewhere, the HBMBudget transient pattern)",
                    self.severity)

    def _locks_in(self, fn, model: _LockModel, defs, depth: int
                  ) -> Optional[int]:
        if depth > 1:
            return None
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    if model.lock_kind(item.context_expr) is not None:
                        return node.lineno
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                if node.func.attr == "acquire":
                    recv = qualname(node.func.value)
                    if recv is not None and \
                            model.lock_kind(node.func.value) is not None:
                        return node.lineno
                if node.func.value is not None and \
                        qualname(node.func.value) in ("self", "cls") and \
                        node.func.attr in defs:
                    got = self._locks_in(defs[node.func.attr], model,
                                         defs, depth + 1)
                    if got is not None:
                        return got
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in defs:
                got = self._locks_in(defs[node.func.id], model, defs,
                                     depth + 1)
                if got is not None:
                    return got
        return None


RULES: List[Rule] = [LifecycleRule(), ReleaseNoneParentLeakRule(),
                     FinalizerUnderLockRule()]
