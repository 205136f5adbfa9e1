"""Canonical metric ID codec: name + sorted tags <-> bytes.

The reference keeps this configurable (metric/id NameAndTagsFn, with an m3
convention of 'm3+name+tag1=v1,tag2=v2'); this framework fixes one canonical
wire form so rules, the aggregator, and the index all agree:

    name;tag1=v1;tag2=v2        (tags sorted by name, ';'/'=' reserved)

Rollup IDs generated by rollup rules carry the reference's special rollup
tag (rules/rollup_target.go, aggregation/id convention) so reverse matching
can recognize them.

Host copy of m3_tpu/metrics/id.py."""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

ROLLUP_TAG = b"m3_rollup"


def encode(name: bytes, tags: Mapping[bytes, bytes]) -> bytes:
    parts = [name]
    for k in sorted(tags):
        parts.append(k + b"=" + tags[k])
    return b";".join(parts)


def decode(metric_id: bytes) -> Tuple[bytes, Dict[bytes, bytes]]:
    parts = metric_id.split(b";")
    tags: Dict[bytes, bytes] = {}
    for part in parts[1:]:
        k, _, v = part.partition(b"=")
        tags[k] = v
    return parts[0], tags


def rollup_id(new_name: bytes, tags: Mapping[bytes, bytes], keep: Iterable[bytes]) -> bytes:
    """New rollup metric ID keeping only `keep` dimensions + the rollup tag
    (rules/rollup_target.go semantics)."""
    kept = {k: tags[k] for k in keep if k in tags}
    kept[ROLLUP_TAG] = b"true"
    return encode(new_name, kept)


def is_rollup_id(metric_id: bytes) -> bool:
    _, tags = decode(metric_id)
    return ROLLUP_TAG in tags
