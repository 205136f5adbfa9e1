"""Retry-discipline rules: every networked layer must route retries and
transport-error handling through the shared resilience primitives
(m3_tpu_torch/utils/retry.py) instead of ad-hoc shapes.

Rules:
  raw-sleep-retry        a `time.sleep` inside a loop that also contains
                         a try/except — the hand-rolled fixed-delay retry
                         loop. Fixed delays either hammer a dead endpoint
                         (too short) or stall recovery (too long); the
                         Retrier's jittered exponential backoff (or at
                         least its backoff_for schedule) replaces both.
  broad-except-wire-io   `except Exception` / bare `except` around direct
                         wire.read_frame / write_frame / read_dict_frame
                         calls. Framed I/O fails in exactly three typed
                         ways (ConnectionError incl. WireTruncated,
                         OSError, ValueError) and retriers/breakers
                         classify on those types — a broad handler eats
                         the classification and turns desyncs into
                         silent retries.

Both rules exempt m3_tpu_torch/utils/retry.py itself (the primitives' own
internals) — everything else needs a justified suppression.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .core import Finding, Module, Rule, qualname

_WIRE_IO = {"read_frame", "write_frame", "read_dict_frame"}
_BROAD = {"Exception", "BaseException"}

# Peer-streaming session calls are wire I/O one hop removed: inside the
# peer-replication data plane (storage/bootstrap.py, storage/repair.py)
# a broad except around them eats the typed transport classification
# (client.session.PEER_SKIP_ERRORS) exactly like a broad except around
# read_frame would — the pre-fix `except Exception: continue` hole in
# PeersBootstrapper.bootstrap (peers unavailable silently claimed
# nothing) is the seeded positive for this scope extension.
_PEER_IO = {
    "fetch_bootstrap_blocks_from_peers", "fetch_blocks_metadata_from_peers",
    "fetch_block_metadata_tiles_from_peers", "fetch_block_tiles_from_peers",
    "fetch_block_tiles", "fetch_block_tiles_from_host",
    "fetch_blocks_from_host", "fetch_blocks",
}
_PEER_IO_SCOPES = {
    ("storage", "bootstrap.py"), ("storage", "repair.py"),
}
# The widened scope: in parallel/ and query/ the remote-exchange
# fan-in calls are wire I/O one hop removed the same way the
# peer-streaming session calls are — a broad except around them eats
# the typed transport classification (RetryableError / BreakerOpen /
# DeadlineExceeded) the retrier/breaker layer classifies on.
_PEER_IO_DIRS = ("parallel", "query")
_PEER_IO_EXTRA = {"_exchange", "_exchange_locked", "fetch_remote"}


def _is_exempt(mod: Module) -> bool:
    return mod.scope_parts[-2:] == ("utils", "retry.py")


def _walk_no_nested_scopes(nodes) -> Iterator[ast.AST]:
    """Descendants of the given statements, not entering nested function
    or class scopes (their loops/handlers are analyzed on their own)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue  # yielded for visibility, but never descended into
        stack.extend(ast.iter_child_nodes(node))


class RawSleepRetryRule(Rule):
    """raw-sleep-retry: time.sleep in a loop that also try/excepts —
    the hand-rolled fixed-delay retry loop; use utils.retry backoff."""

    id = "raw-sleep-retry"
    severity = "error"

    def check(self, mod: Module) -> Iterator[Finding]:
        if _is_exempt(mod):
            return
        seen: Set[int] = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.While, ast.For)):
                continue
            body = list(node.body) + list(node.orelse)
            sleeps: List[ast.Call] = []
            has_try = False
            for sub in _walk_no_nested_scopes(body):
                if isinstance(sub, ast.Try):
                    has_try = True
                elif isinstance(sub, ast.Call) and \
                        qualname(sub.func) == "time.sleep":
                    sleeps.append(sub)
            if not has_try:
                continue
            for call in sleeps:
                if call.lineno in seen:
                    continue
                seen.add(call.lineno)
                yield self.finding(
                    mod, call,
                    "raw time.sleep retry loop: fixed delays hammer dead "
                    "endpoints or stall recovery — drive the wait from "
                    "utils.retry (Retrier.attempt, or backoff_for for "
                    "scheduled scans) and gate reconnects with a Breaker")


class BroadExceptWireIORule(Rule):
    """broad-except-wire-io: `except Exception`/bare except around direct
    framed-wire I/O calls outside the retrier."""

    id = "broad-except-wire-io"
    severity = "error"

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            pass  # bare except: broad
        else:
            names = [qualname(e) for e in t.elts] \
                if isinstance(t, ast.Tuple) else [qualname(t)]
            if not any(n is not None and n.split(".")[-1] in _BROAD
                       for n in names):
                return False
        # A broad handler that re-raises on EVERY path FORWARDS the
        # original exception — the typed classification reaches the
        # retrier/breaker layer intact (the settle-the-grant-then-raise
        # shape in query/remote.py). The exemption requires the bare
        # `raise` to be unconditional: any return/break/continue or
        # exception-replacing raise elsewhere in the handler means some
        # path still swallows the classification.
        if handler.body and isinstance(handler.body[-1], ast.Raise) \
                and handler.body[-1].exc is None:
            if self._handler_escapes(handler.body[:-1], in_loop=False):
                return True
            return False
        return True

    def _handler_escapes(self, stmts, in_loop: bool) -> bool:
        """A statement that leaves the handler before the final bare
        raise: return anywhere, break/continue NOT bound to a loop
        inside the handler itself, or an exception-replacing raise."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Return):
                return True
            if isinstance(stmt, (ast.Break, ast.Continue)) and not in_loop:
                return True  # targets a loop OUTSIDE the handler
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                return True
            loops_here = isinstance(stmt, (ast.For, ast.While))
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub and self._handler_escapes(
                        sub, in_loop or loops_here):
                    return True
            for h in getattr(stmt, "handlers", []) or []:
                if self._handler_escapes(h.body, in_loop):
                    return True
        return False

    def _wire_calls(self, try_node: ast.Try,
                    peer_io: bool = False) -> List[Tuple[str, int]]:
        out: List[Tuple[str, int]] = []
        stack = list(try_node.body)
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef, ast.Try)):
                # nested scopes analyze separately; an inner try with its
                # own (possibly typed) handlers owns its wire calls
                continue
            if isinstance(sub, ast.Call):
                q = qualname(sub.func)
                if q is not None:
                    parts = q.split(".")
                    if parts[-1] in _WIRE_IO and \
                            (len(parts) == 1 or parts[-2] == "wire"):
                        out.append((parts[-1], sub.lineno))
                    elif peer_io and (parts[-1] in _PEER_IO
                                      or parts[-1] in _PEER_IO_EXTRA):
                        out.append((parts[-1], sub.lineno))
            stack.extend(ast.iter_child_nodes(sub))
        return out

    def check(self, mod: Module) -> Iterator[Finding]:
        if _is_exempt(mod):
            return
        peer_io = tuple(mod.scope_parts[-2:]) in _PEER_IO_SCOPES or \
            any(d in mod.scope_parts for d in _PEER_IO_DIRS)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            calls = self._wire_calls(node, peer_io)
            if not calls:
                continue
            for handler in node.handlers:
                if not self._is_broad(handler):
                    continue
                fn, line = calls[0]
                if fn in _WIRE_IO:
                    msg = (f"broad except around wire.{fn} (line {line}): "
                           "framed I/O fails typed (ConnectionError/"
                           "WireTruncated, OSError, ValueError) and the "
                           "retry/breaker layer classifies on those — "
                           "catch the typed set or route through "
                           "utils.retry")
                else:
                    msg = (f"broad except around peer-streaming {fn} "
                           f"(line {line}): peer RPC failures are typed "
                           "(client.session.PEER_SKIP_ERRORS + "
                           "RemoteError) — a broad handler eats the "
                           "classification and turns a dead peer into a "
                           "silent coverage hole; catch the typed set and "
                           "count the skip")
                yield Finding(self.id, mod.relpath, handler.lineno, msg,
                              self.severity)


RULES: List[Rule] = [RawSleepRetryRule(), BroadExceptWireIORule()]
