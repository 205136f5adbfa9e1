"""Carbon plaintext protocol parser (reference: src/metrics/carbon/parser.go
— 'dotted.metric.path value unix_timestamp\\n' lines).

Graphite paths map onto the tag model the way the reference coordinator
ingests carbon: path component i becomes tag __g{i}__ (m3 coordinator
graphite ingestion convention), so the same inverted index serves both
prom-style and graphite queries.

Host copy of m3_tpu/metrics/carbon.py."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

GRAPHITE_TAG_FMT = b"__g%d__"


def parse_line(line: bytes) -> Optional[Tuple[bytes, float, int]]:
    """One carbon line -> (path, value, unix_seconds); None if malformed
    (parser.go Parse: silently skips bad lines, counting errors)."""
    parts = line.strip().split()
    if len(parts) != 3:
        return None
    path, val_s, ts_s = parts
    if not path or path.startswith(b".") or path.endswith(b"."):
        return None
    try:
        value = float(val_s)
        ts = int(float(ts_s))
    except ValueError:
        return None
    if math.isnan(value):
        return None
    return path, value, ts


def parse_lines(data: bytes) -> Iterator[Tuple[bytes, float, int]]:
    for line in data.splitlines():
        if not line.strip():
            continue
        parsed = parse_line(line)
        if parsed is not None:
            yield parsed


def path_to_tags(path: bytes) -> Dict[bytes, bytes]:
    """'servers.web01.cpu' -> {__g0__: servers, __g1__: web01, __g2__: cpu}."""
    tags = {}
    for i, part in enumerate(path.split(b".")):
        tags[GRAPHITE_TAG_FMT % i] = part
    return tags


def tags_to_path(tags: Dict[bytes, bytes]) -> bytes:
    """Inverse of path_to_tags over however many __gN__ tags exist."""
    parts = []
    i = 0
    while True:
        part = tags.get(GRAPHITE_TAG_FMT % i)
        if part is None:
            break
        parts.append(part)
        i += 1
    return b".".join(parts)
