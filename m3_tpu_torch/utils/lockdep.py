"""Runtime lock-order witness (port of m3_tpu/utils/lockdep.py; the
Python analog of the kernel's lockdep, standing in for the Go race
detector the reference leans on).

Opt-in via ``M3_TPU_LOCKDEP=1``: `install()` (called by
``m3_tpu_torch/__init__`` when the variable is set) replaces
``threading.Lock`` / ``RLock`` / ``Condition`` with factories that wrap
locks ALLOCATED FROM m3_tpu_torch CODE in a witness proxy. A file counts
as the port's when one of its path components is ``m3_tpu_torch``; every
other caller (the standard library, torch, concurrent.futures, and the
JAX package where a process holds both) gets the real primitive
untouched, so only the port's locks are observed.

Each witnessed lock is named by its ALLOCATION SITE with the reference's
scheme: ``Class.attr`` for ``self.attr = threading.Lock()`` in a method
(Class is the class that DEFINES the method), ``modbase.name`` for
module-level locks. The same class therefore gets the same name in both
packages, and the two packages' graphs compare directly.

What is recorded, per process:

  * the ACQUISITION-ORDER graph: on acquiring lock B while holding A
    (innermost held, different object), the edge A -> B with its first
    observed site and a count. Reentrant re-acquisition of the same
    OBJECT records nothing.
  * HELD-WHILE-BLOCKING: when the acquire actually contended (the
    non-blocking probe failed and the thread parked), the edge is
    additionally flagged ``blocked``; `on_block` records it BEFORE the
    thread parks, so a real deadlock still leaves its edge.
  * CYCLES, detected ONLINE: adding edge A -> B runs a reachability
    check B ~> A over the witnessed graph; a hit records the full
    cycle path at witness time (same-NAME edges between different
    objects, such as parent/child Enforcer chains, are hierarchy edges
    and are exempt, matching lockdep's nesting classes).

On process exit (or `dump_now()`), the graph is written as JSON into
``M3_TPU_LOCKDEP_OUT`` (a directory; one file per pid). The port's
checks read the dumps directly and hold them to zero cycles.

Conditions: a no-arg ``threading.Condition()`` from the port's code gets
a witnessed RLock underneath (named from the Condition's site);
``Condition(existing_lock)`` keeps the caller's (possibly witnessed)
lock, so waits release and re-acquire through the proxy and the held
stack stays balanced across ``cond.wait()``.
"""

from __future__ import annotations

import atexit
import json
import linecache
import os
import re
import sys
import threading
import time

__all__ = ["enabled", "install", "installed", "witness_graph", "dump_now",
           "LockdepGraph"]

# Real primitives captured at import time: the proxies and the graph's
# own bookkeeping must never recurse through the patched factories.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_ASSIGN_RE = re.compile(
    r"(?:(?P<self>self)\.)?(?P<name>\w+)\s*(?::[^=]+)?=\s*"
    r"(?:threading\.)?(?:Lock|RLock|Condition)\s*\(")


def enabled() -> bool:
    return os.environ.get("M3_TPU_LOCKDEP", "") not in ("", "0")


class LockdepGraph:
    """Process-wide witnessed acquisition-order graph."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # (a, b) -> {"count", "blocked", "site"}
        self.edges: dict = {}
        self.adj: dict = {}            # a -> set of b (cycle detection)
        self.cycles: list = []         # recorded cycle paths
        self.nodes: dict = {}          # name -> kind

    # ------------------------------------------------------------- held stack

    def _held(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_node(self, name: str, kind: str):
        with self._mu:
            self.nodes.setdefault(name, kind)

    def on_acquire(self, name: str, obj, blocked: bool, site: str,
                   record_edge: bool = True):
        held = self._held()
        if record_edge and not any(o is obj for _n, o in held):
            if held:
                self._edge(held[-1][0], name, blocked, site)
        held.append((name, obj))

    def on_block(self, name: str, obj, site: str) -> bool:
        """Record the (innermost-held -> name) edge BEFORE the thread
        parks on a contended acquire — a real deadlock never returns
        from the park, so waiting until after the acquire would witness
        nothing. Returns True when this edge closes a cycle (the caller
        dumps diagnostics before parking)."""
        held = self._held()
        if not held or any(o is obj for _n, o in held):
            return False
        with self._mu:
            ncycles = len(self.cycles)
        self._edge(held[-1][0], name, True, site)
        with self._mu:
            return len(self.cycles) > ncycles

    def on_release(self, name: str, obj):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is obj:
                del held[i]
                return

    # ------------------------------------------------------------------ edges

    def _edge(self, a: str, b: str, blocked: bool, site: str):
        if a == b:
            # same NAME, different objects: a hierarchy edge
            # (parent/child Enforcer chain); recorded, never a cycle
            with self._mu:
                e = self.edges.setdefault(
                    (a, b), {"count": 0, "blocked": 0, "site": site})
                e["count"] += 1
                e["blocked"] += int(blocked)
            return
        with self._mu:
            e = self.edges.get((a, b))
            if e is None:
                self.edges[(a, b)] = {"count": 1, "blocked": int(blocked),
                                      "site": site}
                self.adj.setdefault(a, set()).add(b)
                path = self._path(b, a)
                if path is not None:
                    self.cycles.append([a] + path)
            else:
                e["count"] += 1
                e["blocked"] += int(blocked)

    def _path(self, src: str, dst: str):
        """A path src ~> dst over witnessed edges (None when dst is
        unreachable). _mu held."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            cur, path = stack.pop()
            if cur == dst:
                return path
            if cur in seen:
                continue
            seen.add(cur)
            for nxt in self.adj.get(cur, ()):
                if nxt != cur:
                    stack.append((nxt, path + [nxt]))
        return None

    # ------------------------------------------------------------------- dump

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "pid": os.getpid(),
                "argv": sys.argv,
                "time": time.time(),
                "nodes": dict(self.nodes),
                "edges": [
                    {"from": a, "to": b, **info}
                    for (a, b), info in sorted(self.edges.items())
                ],
                "cycles": [list(c) for c in self.cycles],
            }

    def dump(self, path: str):
        snap = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        os.replace(tmp, path)


_GRAPH = LockdepGraph()


def witness_graph() -> LockdepGraph:
    return _GRAPH


# ------------------------------------------------------------------- proxies


class _WitnessedLock:
    """Proxy over a real Lock/RLock: every acquisition path — acquire,
    context manager, Condition's _release_save/_acquire_restore — feeds
    the witness graph. Unknown attributes delegate to the inner lock."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    # -- core protocol ----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(False)
        if got:
            _GRAPH.on_acquire(self._name, self, False, _call_site())
            return True
        if not blocking:
            return False
        # contended: record the held-while-blocking edge BEFORE parking
        # — a deadlocked park never returns, and this edge is the one
        # that proves it. If it closes a witnessed cycle, dump NOW so
        # the hang leaves diagnostics on disk even though atexit will
        # never run.
        site = _call_site()
        if _GRAPH.on_block(self._name, self, site):
            try:
                dump_now()
            except Exception:  # noqa: BLE001 — diagnostics must never
                pass               # turn a deadlock into a crash
        got = self._inner.acquire(True, timeout)
        if got:
            _GRAPH.on_acquire(self._name, self, True, site,
                              record_edge=False)
        return got

    def release(self):
        _GRAPH.on_release(self._name, self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()
        return False

    # -- Condition integration -------------------------------------------
    # Condition(wait) swaps the lock out and back; these keep the held
    # stack balanced whether the inner lock is an RLock (has the save/
    # restore protocol) or a plain Lock (emulated, as Condition does).

    def _release_save(self):
        _GRAPH.on_release(self._name, self)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        _GRAPH.on_acquire(self._name, self, False, _call_site())

    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def __repr__(self):
        return f"<witnessed {self._name} {self._inner!r}>"


# ------------------------------------------------------- site-derived naming


def _in_repo(filename: str) -> bool:
    return "m3_tpu_torch" in filename.replace(os.sep, "/").split("/")


def _call_site(depth: int = 2) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:  # noqa: BLE001 — witness must never kill the caller
        return "?"


def _defining_class(self_obj, code) -> str:
    """The class that DEFINES the method whose code object is `code`,
    walking the MRO: an inherited lock attr is named by the defining
    class (`MemStore._lock`), not the runtime subclass
    (`FileStore._lock`), as the reference names it."""
    for cls in type(self_obj).__mro__:
        fn = vars(cls).get(code.co_name)
        fn = getattr(fn, "__func__", fn)
        if getattr(fn, "__code__", None) is code:
            return cls.__name__
    return type(self_obj).__name__


def _site_name(frame) -> str:
    """The identity of a lock allocated at `frame`:
    'Class.attr' when the source line assigns `self.attr = ...Lock()`
    inside a method (Class = the DEFINING class of that method),
    'modbase.name' for module/local assignments, an anonymous site
    marker otherwise."""
    filename = frame.f_code.co_filename
    lineno = frame.f_lineno
    modbase = os.path.basename(filename)
    if modbase.endswith(".py"):
        modbase = modbase[:-3]
    if modbase == "__init__":
        # name by the package, so pkg/__init__.py locks read `pkg.X`
        modbase = os.path.basename(os.path.dirname(filename)) or modbase
    line = linecache.getline(filename, lineno)
    m = _ASSIGN_RE.search(line)
    if m is None:
        return f"{modbase}.anon@{lineno}"
    attr = m.group("name")
    if m.group("self"):
        self_obj = frame.f_locals.get("self")
        if self_obj is not None:
            return f"{_defining_class(self_obj, frame.f_code)}.{attr}"
        return f"{modbase}.{attr}"
    return f"{modbase}.{attr}"


# ----------------------------------------------------------------- factories


def _lock_factory():
    frame = sys._getframe(1)
    if not _in_repo(frame.f_code.co_filename):
        return _REAL_LOCK()
    name = _site_name(frame)
    _GRAPH.note_node(name, "lock")
    return _WitnessedLock(_REAL_LOCK(), name)


def _rlock_factory():
    frame = sys._getframe(1)
    if not _in_repo(frame.f_code.co_filename):
        return _REAL_RLOCK()
    name = _site_name(frame)
    _GRAPH.note_node(name, "rlock")
    return _WitnessedLock(_REAL_RLOCK(), name)


def _condition_factory(lock=None):
    frame = sys._getframe(1)
    if not _in_repo(frame.f_code.co_filename):
        return _REAL_CONDITION(lock)
    if lock is None:
        name = _site_name(frame)
        _GRAPH.note_node(name, "cond")
        lock = _WitnessedLock(_REAL_RLOCK(), name)
    # a caller-supplied lock keeps its own identity (witnessed or not)
    return _REAL_CONDITION(lock)


_INSTALLED = False


def installed() -> bool:
    return _INSTALLED


def default_out_dir() -> str:
    return os.environ.get("M3_TPU_LOCKDEP_OUT",
                          os.path.join("artifacts", "lockdep"))


def dump_now(path: str = "") -> str:
    """Write this process's witnessed graph; returns the file path."""
    if not path:
        out = default_out_dir()
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"lockdep-{os.getpid()}.json")
    _GRAPH.dump(path)
    return path


def _atexit_dump():
    try:
        dump_now()
    except Exception:  # noqa: BLE001 — a failed dump must not mask the
        pass               # process's own exit status


def install() -> LockdepGraph:
    """Patch the threading lock factories (idempotent). Only locks
    allocated from m3_tpu_torch source files are witnessed; everyone else
    gets the real primitive."""
    global _INSTALLED
    if _INSTALLED:
        return _GRAPH
    _INSTALLED = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    atexit.register(_atexit_dump)
    return _GRAPH


def uninstall():
    """Restore the real factories (tests). Already-witnessed locks keep
    their proxies; only NEW allocations revert."""
    global _INSTALLED
    if not _INSTALLED:
        return
    _INSTALLED = False
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
