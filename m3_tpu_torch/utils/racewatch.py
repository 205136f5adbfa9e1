"""Runtime race witness (port of m3_tpu/utils/racewatch.py, the dynamic
half of the reference's `go test -race` parity story).

Opt-in via ``M3_TPU_RACEWATCH=1``: `install()` (called by
``m3_tpu_torch/__init__`` when the variable is set) arms attribute
instrumentation on the shared-state attributes the port's modules have
REGISTERED, the same attributes the reference registers. Costs nothing
when unset: `register()` at a module bottom appends one tuple; no
descriptor is installed until the witness is armed.

Each witnessed attribute is named ``Class.attr``, the identity scheme of
the lockdep witness, so the two compare directly. Every instrumented
access records an access PROFILE:

    (thread id, locks held by this thread, read|write)

with the held-lock snapshot taken from the lockdep witness
(utils/lockdep.py, installed as a dependency: its per-thread held stack
names locks with the same ``Class.attr`` scheme). Profiles deduplicate
per attribute, so steady-state instrumented access is one GIL-atomic set
probe; only a NEVER-SEEN profile takes the table lock.

At exit (or `dump_now()`), the observation table is written as JSON into
``M3_TPU_RACEWATCH_OUT`` (a directory; one file per pid): per attribute
its profiles and its racy pairs, the cross-thread pairs with a write and
no common held lock (`racy_pairs`).

The first write a given instance makes to a watched attribute is not
recorded: `__init__` assignment precedes publication, and recording it
would charge every constructor thread with a spurious write profile.

Like lockdep and numwatch this is a smoke-tier tool: a watched attribute
becomes a Python descriptor (one extra call per access), never to be
enabled in production serving.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, FrozenSet, List, Tuple

from . import lockdep

__all__ = [
    "enabled", "installed", "install", "uninstall", "reset", "register",
    "watch", "findings", "observed_count", "dump_now", "racy_pairs",
]

# racewatch's own mutex must be a REAL lock even under lockdep's patched
# factories: the witness must never witness itself.
_MU = lockdep._REAL_LOCK()
_INSTALLED = False
_PENDING: List[Tuple[type, Tuple[str, ...]]] = []  # register() backlog
_WATCHED: Dict[str, type] = {}                     # ident -> class
# ident -> set of (thread id, locks frozenset, is_write)
_PROFILES: Dict[str, set] = {}
_SEEN: set = set()          # (ident, tid, locks, write) lock-free probe
_MAX_PROFILES = 4096        # bound the table; profiles dedup hard


def enabled() -> bool:
    return os.environ.get("M3_TPU_RACEWATCH", "") not in ("", "0")


def installed() -> bool:
    return _INSTALLED


def install():
    """Arm the witness (idempotent): installs lockdep for held-lock
    snapshots, instruments every registered attribute, and registers
    the exit dump."""
    global _INSTALLED
    with _MU:
        if _INSTALLED:
            return
        _INSTALLED = True
        pending = list(_PENDING)
        _PENDING.clear()
    if not lockdep.installed():
        lockdep.install()
    for cls, attrs in pending:
        _instrument(cls, attrs)
    atexit.register(_atexit_dump)


def uninstall():
    """Disarm recording. Installed descriptors stay in place (removing
    them cannot restore original slots safely) but record nothing."""
    global _INSTALLED
    with _MU:
        _INSTALLED = False


def reset():
    with _MU:
        _PROFILES.clear()
        _SEEN.clear()


# ------------------------------------------------------------ registration


def register(cls: type, *attrs: str):
    """Declare `cls.attr...` as witness-instrumented shared state.
    Modules call this at module bottom for the attrs the reference
    registers. No-op (one list append) until the witness is installed."""
    with _MU:
        if not _INSTALLED:
            _PENDING.append((cls, tuple(attrs)))
            return
    _instrument(cls, attrs)


def watch(cls: type, *attrs: str) -> type:
    """Instrument unconditionally (tests): wraps the attrs now, whether
    or not the witness is armed, and returns the class."""
    _instrument(cls, attrs)
    return cls


def _instrument(cls: type, attrs):
    for attr in attrs:
        ident = f"{cls.__name__}.{attr}"
        with _MU:
            if ident in _WATCHED:
                continue
            _WATCHED[ident] = cls
        inner = cls.__dict__.get(attr)  # slot/property descriptor, if any
        if inner is not None and not hasattr(inner, "__set__"):
            inner = None  # plain class attr default: shadow per-instance
        setattr(cls, attr, _WatchedAttr(ident, attr, inner))


class _WatchedAttr:
    """Data descriptor recording (thread, locks-held, kind) per access,
    delegating storage to the wrapped slot descriptor or (for plain
    instance attrs) an instance-dict key."""

    def __init__(self, ident: str, attr: str, inner):
        self._ident = ident
        self._attr = attr
        self._inner = inner
        self._key = "_racewatch_" + attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        _note(self._ident, False)
        if self._inner is not None:
            return self._inner.__get__(obj, objtype)
        try:
            return obj.__dict__[self._key]
        except KeyError:
            raise AttributeError(self._attr) from None

    def __set__(self, obj, value):
        if self._has(obj):
            _note(self._ident, True)
        # else: first write = construction, pre-publication by contract
        if self._inner is not None:
            self._inner.__set__(obj, value)
        else:
            obj.__dict__[self._key] = value

    def __delete__(self, obj):
        _note(self._ident, True)
        if self._inner is not None:
            self._inner.__delete__(obj)
        else:
            obj.__dict__.pop(self._key, None)

    def _has(self, obj) -> bool:
        if self._inner is not None:
            try:
                self._inner.__get__(obj, type(obj))
                return True
            except AttributeError:
                return False
        return self._key in getattr(obj, "__dict__", {})


# --------------------------------------------------------------- recording


def _held_locks() -> FrozenSet[str]:
    if not lockdep.installed():
        return frozenset()
    return frozenset(n for n, _o in lockdep.witness_graph()._held())


def _note(ident: str, write: bool):
    if not _INSTALLED:
        return
    tid = threading.get_ident()
    locks = _held_locks()
    key = (ident, tid, locks, write)
    if key in _SEEN:  # GIL-atomic probe: steady state takes no lock
        return
    with _MU:
        if key in _SEEN:
            return
        if len(_SEEN) >= _MAX_PROFILES:
            return
        _SEEN.add(key)
        _PROFILES.setdefault(ident, set()).add((tid, locks, write))


def observed_count() -> int:
    """Distinct access profiles witnessed (0 = the witness saw nothing:
    a vacuous run)."""
    with _MU:
        return sum(len(v) for v in _PROFILES.values())


def racy_pairs(profiles) -> List[Tuple[Dict, Dict]]:
    """Cross-thread pairs with at least one write and NO common held
    lock, from one attr's profile list (dicts with thread/locks/write):
    the pairs a lock-free protocol must account for."""
    out = []
    for i, a in enumerate(profiles):
        for b in profiles[i + 1:]:
            if a["thread"] == b["thread"]:
                continue
            if not (a["write"] or b["write"]):
                continue
            if set(a["locks"]) & set(b["locks"]):
                continue
            out.append((a, b))
    return out


def findings() -> List[Dict]:
    """Per-attr observation summary: profiles, distinct thread count,
    and the racy (disjoint-lock cross-thread) pairs."""
    with _MU:
        snap = {k: sorted(v) for k, v in _PROFILES.items()}
    out = []
    for ident in sorted(snap):
        profiles = [{"thread": t, "locks": sorted(locks), "write": w}
                    for t, locks, w in snap[ident]]
        threads = {p["thread"] for p in profiles}
        out.append({
            "attr": ident,
            "threads": len(threads),
            "profiles": profiles,
            "racy": [[a, b] for a, b in racy_pairs(profiles)],
        })
    return out


# ----------------------------------------------------------------- dumps


def default_out_dir() -> str:
    return os.environ.get("M3_TPU_RACEWATCH_OUT", "")


def dump_now(path: str = "") -> str:
    """Write this process's witness state as JSON; returns the path
    ('' when no output dir is configured and none was given)."""
    if not path:
        out_dir = default_out_dir()
        if not out_dir:
            return ""
        path = os.path.join(out_dir, f"racewatch-{os.getpid()}.json")
    payload = {
        "pid": os.getpid(),
        "observed": observed_count(),
        "attrs": findings(),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
    except OSError:
        return ""
    return path


def _atexit_dump():
    if _INSTALLED:
        dump_now()
