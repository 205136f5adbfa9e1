"""Tag glob filters (reference: src/metrics/filters/filter.go).

Pattern language: '*' wildcards, '?' single char, '[a-z]' ranges, '{a,b}'
alternatives, leading '!' negation (filter.go:53-61). Patterns compile to
anchored regexes once; a TagsFilter is the conjunction of per-tag patterns
plus an optional metric-name pattern (filters/tags_filter.go).

Host copy of m3_tpu/metrics/filters.py."""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

from . import id as metric_id

_SPECIAL = set(".^$+()|\\")


def _glob_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            out.append(".*")
        elif c == "?":
            out.append(".")
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j < 0:
                raise ValueError(f"unterminated range in filter {pattern!r}")
            out.append(pattern[i : j + 1])
            i = j
        elif c == "{":
            j = pattern.find("}", i + 1)
            if j < 0:
                raise ValueError(f"unterminated alternation in filter {pattern!r}")
            inner = pattern[i + 1 : j]
            if any(ch in inner for ch in "?[{"):
                raise ValueError(f"invalid nested pattern in filter {pattern!r}")
            alts = [re.escape(a) for a in inner.split(",")]
            out.append("(?:" + "|".join(alts) + ")")
            i = j
        elif c in _SPECIAL:
            out.append("\\" + c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


class Filter:
    """Single-value glob filter with optional '!' negation (filter.go:88)."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        negate = pattern.startswith("!")
        if negate and len(pattern) == 1:
            raise ValueError("invalid filter pattern: bare negation")
        body = pattern[1:] if negate else pattern
        self._negate = negate
        self._re = re.compile(_glob_to_regex(body).encode() + b"$")

    def matches(self, value: bytes) -> bool:
        ok = self._re.fullmatch(value) is not None
        return ok != self._negate

    def __repr__(self):
        return f"Filter({self.pattern!r})"


class TagsFilter:
    """Conjunction of tag-name -> pattern filters; tag absence fails a
    positive pattern and satisfies a negated one (tags_filter.go)."""

    NAME_KEY = "__name__"

    def __init__(self, filters: Mapping[str, str]):
        self.patterns = dict(filters)
        self._name: Optional[Filter] = None
        self._tags: Dict[bytes, Filter] = {}
        for key, pattern in filters.items():
            f = Filter(pattern)
            if key == self.NAME_KEY:
                self._name = f
            else:
                self._tags[key.encode()] = f

    def matches(self, mid: bytes) -> bool:
        name, tags = metric_id.decode(mid)
        if self._name is not None and not self._name.matches(name):
            return False
        for key, f in self._tags.items():
            value = tags.get(key)
            if value is None:
                if not f._negate:
                    return False
            elif not f.matches(value):
                return False
        return True

    def __repr__(self):
        return f"TagsFilter({self.patterns!r})"

    def to_json(self) -> Dict[str, str]:
        return dict(self.patterns)

    @staticmethod
    def from_json(obj: Mapping[str, str]) -> "TagsFilter":
        return TagsFilter(obj)


MATCH_ALL = TagsFilter({})
