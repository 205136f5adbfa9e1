"""Query data model: tags (labels) and matchers (reference:
src/query/models/{tags,matchers}.go — prom-style label sets and the four
matcher kinds =, !=, =~, !~).

Host copy of m3_tpu/query/model.py."""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

METRIC_NAME = b"__name__"


class MatchType(enum.IntEnum):
    """models/matcher.go MatchType."""

    EQUAL = 0
    NOT_EQUAL = 1
    REGEXP = 2
    NOT_REGEXP = 3


@dataclasses.dataclass(frozen=True)
class Matcher:
    type: MatchType
    name: bytes
    value: bytes

    def matches(self, value: bytes) -> bool:
        if self.type == MatchType.EQUAL:
            return value == self.value
        if self.type == MatchType.NOT_EQUAL:
            return value != self.value
        ok = re.fullmatch(self.value, value) is not None
        return ok if self.type == MatchType.REGEXP else not ok

    def __str__(self):
        op = {MatchType.EQUAL: "=", MatchType.NOT_EQUAL: "!=",
              MatchType.REGEXP: "=~", MatchType.NOT_REGEXP: "!~"}[self.type]
        return f'{self.name.decode()}{op}"{self.value.decode()}"'


@dataclasses.dataclass(frozen=True)
class Tags:
    """Immutable sorted label set (models/tags.go)."""

    pairs: Tuple[Tuple[bytes, bytes], ...]

    @staticmethod
    def of(d: Dict[bytes, bytes]) -> "Tags":
        return Tags(tuple(sorted(d.items())))

    def get(self, name: bytes) -> Optional[bytes]:
        for k, v in self.pairs:
            if k == name:
                return v
        return None

    def name(self) -> bytes:
        return self.get(METRIC_NAME) or b""

    def as_dict(self) -> Dict[bytes, bytes]:
        return dict(self.pairs)

    def without(self, names: Iterable[bytes]) -> "Tags":
        drop = set(names)
        return Tags(tuple((k, v) for k, v in self.pairs if k not in drop))

    def keep(self, names: Iterable[bytes]) -> "Tags":
        want = set(names)
        return Tags(tuple((k, v) for k, v in self.pairs if k in want))

    def with_tag(self, name: bytes, value: bytes) -> "Tags":
        return Tags.of({**self.as_dict(), name: value})

    def id(self) -> bytes:
        """Canonical series ID for grouping/output (models/tags.go ID)."""
        return b",".join(k + b"=" + v for k, v in self.pairs)

    def __str__(self):
        name = self.name().decode()
        rest = ",".join(
            f'{k.decode()}="{v.decode()}"'
            for k, v in self.pairs if k != METRIC_NAME)
        return f"{name}{{{rest}}}"


def matchers_to_index_query(matchers: Sequence[Matcher]):
    """Compile label matchers to an inverted-index query
    (query/storage/m3/storage.go FetchOptionsToM3Options ->
    idx query conversion in storage/index/convert)."""
    from ..index import query as iq

    parts = []
    for m in matchers:
        if m.type == MatchType.EQUAL:
            parts.append(iq.new_term(m.name, m.value))
        elif m.type == MatchType.NOT_EQUAL:
            parts.append(iq.new_negation(iq.new_term(m.name, m.value)))
        elif m.type == MatchType.REGEXP:
            parts.append(iq.new_regexp(m.name, m.value))
        else:
            parts.append(iq.new_negation(iq.new_regexp(m.name, m.value)))
    if not parts:
        return iq.AllQuery()
    if len(parts) == 1:
        return parts[0]
    return iq.new_conjunction(*parts)
