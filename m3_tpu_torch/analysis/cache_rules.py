"""Cache-key safety: memoization applied to buffer-typed hot paths.

The regression class this encodes: `murmur3_32_cached` wrapped a
`data: bytes` function in functools.lru_cache — the wire paths feed the
same routine bytes, bytearray and memoryview interchangeably, so the
memo either raises TypeError (bytearray/memoryview are unhashable) or,
worse for a hashable mutable buffer, keys on content that can change
under the cache. Any lru_cache over a buffer-typed parameter must
normalize to bytes first (and document it with a suppression) or skip
the cache for non-bytes input.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .core import (Finding, Module, Rule, annotation_names, func_params,
                   index_functions, qualname)

BUFFER_TYPES = {"bytes", "bytearray", "memoryview"}
_BUFFER_CTORS = {"bytes", "bytearray", "memoryview"}


def _cache_names(mod: Module) -> Set[str]:
    """Qualified + imported-bare spellings of the functools cache
    decorators valid in this module (a bare `cache(...)` only counts
    when it was imported from functools)."""
    names = {"functools.lru_cache", "functools.cache"}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "functools":
            for a in node.names:
                if a.name in ("lru_cache", "cache"):
                    names.add(a.asname or a.name)
    return names


def _buffer_params(fn: ast.FunctionDef) -> List[Tuple[str, Set[str]]]:
    """(param name, buffer type names in its annotation) for every
    buffer-annotated parameter."""
    out = []
    for arg in func_params(fn):
        hit = annotation_names(arg.annotation) & BUFFER_TYPES
        if hit:
            out.append((arg.arg, hit))
    return out


def _call_site_buffer_args(mod: Module, fname: str) -> Optional[int]:
    """Line of a call to `fname` passing an obviously buffer-typed
    argument (bytes literal or bytes/bytearray/memoryview constructor) —
    the inference path for unannotated cached functions."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        q = qualname(node.func)
        if not q or q.split(".")[-1] != fname:
            continue
        for a in node.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, bytes):
                return node.lineno
            if (isinstance(a, ast.Call)
                    and qualname(a.func) in _BUFFER_CTORS):
                return node.lineno
    return None


class CacheKeyBufferRule(Rule):
    """cache-key-buffer: functools.lru_cache / functools.cache applied
    (as a decorator or as `lru_cache(...)(fn)`) to a function taking
    buffer-typed arguments."""

    id = "cache-key-buffer"
    severity = "error"

    def _report(self, mod: Module, node: ast.AST, fn: ast.FunctionDef,
                params: List[Tuple[str, Set[str]]],
                inferred_line: Optional[int] = None) -> Finding:
        if params:
            detail = ", ".join(
                f"{name!r} ({'|'.join(sorted(kinds))})" for name, kinds in params)
            why = f"buffer-typed parameter(s) {detail}"
        else:
            why = (f"call site at line {inferred_line} passes a buffer "
                   f"argument")
        return self.finding(
            mod, node,
            f"lru_cache over {fn.name!r}: {why}. bytearray/memoryview are "
            "unhashable (TypeError at call time) and mutable buffers alias "
            "stale cache entries; normalize to bytes before the cached call "
            "or bypass the cache for non-bytes input.")

    def check(self, mod: Module) -> Iterator[Finding]:
        funcs = index_functions(mod)
        allowed = _cache_names(mod)

        def is_cache(dec: ast.AST) -> bool:
            if isinstance(dec, ast.Call):
                dec = dec.func
            return qualname(dec) in allowed

        # decorator form: @functools.lru_cache(...) on a def
        for fn in funcs.values():
            for dec in fn.decorator_list:
                if is_cache(dec):
                    yield from self._examine(mod, dec, fn)
        # wrapped-call form: cached = functools.lru_cache(...)(fn)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            inner = node.func
            wrapped = isinstance(inner, ast.Call) and is_cache(inner)
            if not wrapped and not is_cache(node.func):
                continue
            target = node.args[0]
            if isinstance(target, ast.Name) and target.id in funcs:
                yield from self._examine(mod, node, funcs[target.id])

    def _examine(self, mod: Module, site: ast.AST,
                 fn: ast.FunctionDef) -> Iterator[Finding]:
        params = _buffer_params(fn)
        if params:
            yield self._report(mod, site, fn, params)
            return
        # no annotations anywhere -> infer from call sites in this module
        if not any(a.annotation for a in func_params(fn)):
            line = _call_site_buffer_args(mod, fn.name)
            if line is not None:
                yield self._report(mod, site, fn, [], inferred_line=line)


class CacheMethodBufferKeyRule(Rule):
    """cache-buffer-key-method: hand-rolled cache classes must normalize
    buffer-typed parameters to bytes before they become (part of) a key.

    The functools rule above can't see custom caches (dict/OrderedDict
    wrapped in a class, like the index PostingsListCache); same
    regression class though: wire paths hand bytes/bytearray/memoryview
    interchangeably, and a mutable buffer flowing into a key tuple or a
    map subscript either raises (bytearray/memoryview aren't hashable)
    or keys on content that can change under the cache.

    Scope: classes whose name contains "Cache", methods whose name is a
    cache-boundary verb (get/put/set/add/insert/lookup/invalidate/_key),
    parameters annotated bytes/bytearray/memoryview. A param counts as
    normalized once rebound via `p = bytes(p)`; inline `bytes(p)` at the
    use site is fine. Raw uses flagged: inside a tuple literal, a
    subscript index, or an argument to .get/.pop/.setdefault on a self
    attribute."""

    id = "cache-buffer-key-method"
    severity = "error"
    _METHODS = {"get", "put", "set", "add", "insert", "lookup",
                "invalidate", "key", "_key"}
    _MAP_CALLS = {"get", "pop", "setdefault"}

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ClassDef) and "Cache" in node.name):
                continue
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name in self._METHODS):
                    yield from self._check_method(mod, node, item)

    def _check_method(self, mod: Module, cls: ast.ClassDef,
                      fn: ast.FunctionDef) -> Iterator[Finding]:
        buffer_params = {name for name, _ in _buffer_params(fn)}
        if not buffer_params:
            return
        normalized: Set[str] = set()
        for stmt in fn.body:
            use = self._raw_key_use(stmt, buffer_params - normalized)
            if use is not None:
                pname, site = use
                yield self.finding(
                    mod, site,
                    f"{cls.name}.{fn.name}: buffer-typed parameter "
                    f"{pname!r} reaches a cache key without bytes() "
                    "normalization. bytearray/memoryview are unhashable "
                    "and mutable buffers alias stale entries; rebind with "
                    f"`{pname} = bytes({pname})` at the boundary (or wrap "
                    "the use site in bytes(...)).")
                return  # one finding per method keeps the signal readable
            normalized |= self._normalized_in(stmt, buffer_params)

    @staticmethod
    def _normalized_in(stmt: ast.AST, params: Set[str]) -> Set[str]:
        """Params rebound via `p = bytes(p)` in this statement."""
        out: Set[str] = set()
        for node in ast.walk(stmt):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt, val = node.targets[0], node.value
            if (isinstance(tgt, ast.Name) and tgt.id in params
                    and isinstance(val, ast.Call)
                    and qualname(val.func) == "bytes"
                    and len(val.args) == 1
                    and isinstance(val.args[0], ast.Name)
                    and val.args[0].id == tgt.id):
                out.add(tgt.id)
        return out

    def _raw_key_use(self, stmt: ast.AST, params: Set[str]):
        """(param, node) for the first raw (un-wrapped) use of a buffer
        param in a key position within this statement."""
        if not params:
            return None
        for node in ast.walk(stmt):
            if isinstance(node, ast.Tuple):
                for elt in node.elts:
                    if isinstance(elt, ast.Name) and elt.id in params:
                        return elt.id, node
            elif isinstance(node, ast.Subscript):
                idx = node.slice
                if isinstance(idx, ast.Name) and idx.id in params:
                    return idx.id, node
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in self._MAP_CALLS
                  and isinstance(node.func.value, ast.Attribute)):
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in params:
                        return a.id, node
        return None


RULES: List[Rule] = [CacheKeyBufferRule(), CacheMethodBufferKeyRule()]
