"""Disk-I/O discipline rule for the durability plane (persist/).

Rule:
  unchecked-disk-io   a broad handler (`except Exception` / bare except)
                      around direct file I/O — open/fsync/replace/
                      rename/remove and friends — with no typed
                      classification in the handler. The persist plane
                      fails in exactly the typed ways diskio.py defines
                      (CorruptionError for rot, DiskWriteError /
                      DiskFullError via classify_write_error for failed
                      durability), and everything above classifies on
                      those types: the WAL turns them into typed ACK
                      failures, Database.flush routes them into
                      DiskHealth's read-only posture, the scrubber and
                      retriever into quarantine. A broad handler eats
                      the classification — an ENOSPC that should trip
                      read-only shedding becomes a silent skip, torn
                      bytes that should quarantine keep serving.

A handler is exempt when it provably forwards the classification: an
unconditional bare `raise` tail, a raise of one of the typed disk
errors, or a call to `classify_write_error` (raising its result counts).
The seed module (persist/diskio.py) is itself exempt — it is where the
broad->typed translation is allowed to live.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from .core import Finding, Module, Rule, qualname

_BROAD = {"Exception", "BaseException"}
# Direct file-I/O entry points: the builtin/seam `open`, and the os/_io
# level durability calls. Attribute chains are matched on their last two
# parts so both `os.replace` and `self._io.replace` count.
_IO_BARE = {"open", "memmap"}
_IO_TAIL = {"open", "fsync", "replace", "rename", "remove", "unlink",
            "makedirs", "listdir", "getsize", "memmap", "truncate"}
_IO_OWNERS = {"os", "io", "_io", "diskio", "path", "shutil"}
# Typed disk-error taxonomy (persist/diskio.py): raising any of these —
# or calling the classifier that produces them — forwards the
# classification instead of eating it.
_TYPED = {"CorruptionError", "DiskWriteError", "DiskFullError"}
_CLASSIFIER = "classify_write_error"


def _is_exempt(mod: Module) -> bool:
    # diskio.py is the one place broad->typed translation lives.
    return mod.scope_parts[-2:] == ("persist", "diskio.py")


class UncheckedDiskIORule(Rule):
    """unchecked-disk-io: broad except around direct file I/O in the
    persist plane without typed classification."""

    id = "unchecked-disk-io"
    severity = "error"
    dirs = ("persist",)

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True  # bare except
        names = [qualname(e) for e in t.elts] \
            if isinstance(t, ast.Tuple) else [qualname(t)]
        return any(n is not None and n.split(".")[-1] in _BROAD
                   for n in names)

    def _classifies(self, handler: ast.ExceptHandler) -> bool:
        """The handler forwards the typed classification: unconditional
        bare re-raise tail, a raise of a typed disk error, or a
        classify_write_error call anywhere in its body."""
        if handler.body and isinstance(handler.body[-1], ast.Raise) \
                and handler.body[-1].exc is None:
            return True
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Call):
                q = qualname(sub.func)
                if q is not None and q.split(".")[-1] == _CLASSIFIER:
                    return True
            elif isinstance(sub, ast.Raise) and sub.exc is not None:
                exc = sub.exc
                if isinstance(exc, ast.Call):
                    exc = exc.func
                q = qualname(exc)
                if q is not None and q.split(".")[-1] in _TYPED:
                    return True
        return False

    def _io_calls(self, try_node: ast.Try) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        stack = list(try_node.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef, ast.Try)):
                # Nested scopes analyze separately; an inner try with its
                # own handlers owns its I/O calls.
                continue
            if isinstance(sub, ast.Call):
                q = qualname(sub.func)
                if q is not None:
                    parts = q.split(".")
                    if len(parts) == 1 and parts[0] in _IO_BARE:
                        out.append((parts[0], sub.lineno))
                    elif len(parts) > 1 and parts[-1] in _IO_TAIL and \
                            parts[-2] in _IO_OWNERS:
                        out.append((parts[-1], sub.lineno))
            stack.extend(ast.iter_child_nodes(sub))
        return out

    def check(self, mod: Module) -> Iterator[Finding]:
        if _is_exempt(mod):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            calls = self._io_calls(node)
            if not calls:
                continue
            for handler in node.handlers:
                if not self._is_broad(handler) or self._classifies(handler):
                    continue
                fn, line = calls[0]
                yield Finding(
                    self.id, mod.relpath, handler.lineno,
                    f"broad except around disk I/O {fn} (line {line}): "
                    "persist-plane I/O fails typed (CorruptionError, "
                    "DiskWriteError/DiskFullError via "
                    "classify_write_error) and the WAL ack, flush health "
                    "and scrub/quarantine layers classify on those — "
                    "catch the typed set or classify before swallowing",
                    self.severity)


RULES: List[Rule] = [UncheckedDiskIORule()]
