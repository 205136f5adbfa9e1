"""Index query DSL (reference: src/m3ninx/idx/query.go — term / regexp /
conjunction / disjunction / negation builders compiled into searchers)."""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

# Bytes that start regex syntax; a literal prefix scan stops at the first
# one (mirrors regexp/syntax LiteralPrefix consumed by fst/regexp's
# prefix-range prune).
_META = frozenset(b".^$*+?{}[]\\|()")
_QUANT = frozenset(b"*?{")


def literal_prefix(pattern: bytes) -> bytes:
    """Longest guaranteed literal prefix of a regexp over bytes.

    Conservative by construction: a too-SHORT prefix only widens the term
    range that gets automaton-matched afterwards, never the results.
    Rules: an alternation ANYWHERE voids the prefix (a top-level `|`
    lets a match start down the other branch, and telling top-level from
    grouped needs a full parse — give up the prune instead); otherwise
    stop at the first metacharacter, and `*`/`?`/`{` quantify the
    previous literal, so it is dropped from the prefix."""
    if 0x7C in pattern:  # "|"
        return b""
    out = bytearray()
    for c in pattern:
        if c in _META:
            if c in _QUANT and out:
                out.pop()
            break
        out.append(c)
    return bytes(out)


class Query:
    pass


@dataclasses.dataclass(frozen=True)
class AllQuery(Query):
    """Matches every document (m3ninx all searcher)."""


@dataclasses.dataclass(frozen=True)
class TermQuery(Query):
    field: bytes
    value: bytes


@dataclasses.dataclass(frozen=True)
class RegexpQuery(Query):
    field: bytes
    pattern: bytes

    def __post_init__(self):
        # Compile ONCE at construction (idx.NewRegexpQuery compiles the
        # automaton up front); every per-segment execution reuses it.
        object.__setattr__(self, "_compiled", re.compile(self.pattern))

    def compiled(self):
        return self._compiled


@dataclasses.dataclass(frozen=True)
class ConjunctionQuery(Query):
    queries: Tuple[Query, ...]


@dataclasses.dataclass(frozen=True)
class DisjunctionQuery(Query):
    queries: Tuple[Query, ...]


@dataclasses.dataclass(frozen=True)
class NegationQuery(Query):
    query: Query


def new_term(field: bytes, value: bytes) -> TermQuery:
    return TermQuery(field, value)


def new_regexp(field: bytes, pattern: bytes) -> RegexpQuery:
    return RegexpQuery(field, pattern)  # constructor compiles eagerly


def new_conjunction(*queries: Query) -> Query:
    flat = []
    for q in queries:
        if isinstance(q, ConjunctionQuery):
            flat.extend(q.queries)
        else:
            flat.append(q)
    return flat[0] if len(flat) == 1 else ConjunctionQuery(tuple(flat))


def new_disjunction(*queries: Query) -> Query:
    flat = []
    for q in queries:
        if isinstance(q, DisjunctionQuery):
            flat.extend(q.queries)
        else:
            flat.append(q)
    return flat[0] if len(flat) == 1 else DisjunctionQuery(tuple(flat))


def new_negation(q: Query) -> NegationQuery:
    return NegationQuery(q)
