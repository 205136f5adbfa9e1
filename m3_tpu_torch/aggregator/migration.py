"""Dual-format ingestion migration (host copy of
m3_tpu/aggregator/migration.py; reference:
src/metrics/encoding/migration/unaggregated_iterator.go sniffing
msgpack-vs-protobuf per message, convert.go lifting legacy
metric+policies into the staged-metadata model).

One aggregator port accepts BOTH wire generations simultaneously, per
message, so fleets migrate client-by-client with no flag day:

* current: the framed binary codec (m3_tpu_torch.rpc.wire) — 4-byte
  big-endian length prefix + tagged binary body;
* legacy v1: newline-delimited JSON records, the pre-binary text schema
  that carried plain storage policies instead of staged metadatas:
      {"type": "counter"|"gauge"|"timer", "id": <str>,
       "value": <num or list>, "policies": ["10s:2d", ...]}

Format detection mirrors the reference's version-byte sniff, adapted to
this wire's little-endian length prefix: a message is legacy iff byte 0
is '{' (0x7b) AND byte 3 is non-zero — a binary frame under
MIGRATION_MAX_FRAME (16 MiB) always has 0x00 in byte 3 (the length's
most-significant byte), while byte 3 of a JSON record is printable
ASCII. Frames above that cap are rejected on migration-mode connections
so the two byte spaces can never collide."""

from __future__ import annotations

import json
import struct
from typing import List

from ..metrics.metric import MetricType
from ..rpc import wire

MIGRATION_MAX_FRAME = 1 << 24  # keeps length byte 3 at 0x00, unlike ASCII

_U32 = struct.Struct("<I")  # must match rpc/wire framing

_LEGACY_TYPES = {
    "counter": MetricType.COUNTER,
    "gauge": MetricType.GAUGE,
    "timer": MetricType.TIMER,
}


class RecoverableRecordError(ValueError):
    """A single bad record whose bytes were fully consumed — the stream is
    still frame-aligned, so the connection can keep reading (the reference
    iterator likewise reports per-message decode errors without tearing the
    reader down)."""


def legacy_to_entry(rec: dict) -> dict:
    """convert.go toUnaggregatedMessageUnion: legacy metric + policies ->
    a current-schema untimed entry. Legacy policies carry no aggregation
    types or pipelines, so they become one default staged metadata (agg_id
    0 = metric-type defaults, empty pipeline, cutover 0)."""
    try:
        mtype = _LEGACY_TYPES[rec["type"]]
    except KeyError:
        raise ValueError(f"legacy record: unknown type {rec.get('type')!r}")
    value = rec["value"]
    if mtype == MetricType.TIMER:
        value = [float(v) for v in value]
    elif mtype == MetricType.COUNTER:
        value = int(value)
    else:
        value = float(value)
    policies = [str(p) for p in rec.get("policies", [])]
    return {
        "t": "untimed",
        "mtype": int(mtype),
        "id": rec["id"].encode(),
        "value": value,
        "metadatas": [{
            "cutover": 0,
            "tombstoned": False,
            "pipelines": [{
                "agg_id": 0,
                "policies": policies,
                "pipeline": [],
                "drop": False,
            }],
        }],
    }


def write_legacy(sock, metric_type: str, metric_id: str, value,
                 policies: List[str] = ()) -> None:
    """Emit one legacy v1 record — what a not-yet-migrated client sends."""
    rec = {"type": metric_type, "id": metric_id, "value": value,
           "policies": list(policies)}
    sock.sendall(json.dumps(rec).encode() + b"\n")


class MigrationReader:
    """Per-connection reader yielding current-schema entries regardless of
    which generation each message was written in (the analog of
    migration.unaggregatedIterator holding both sub-iterators over one
    shared stream)."""

    def __init__(self, sock):
        self._sock = sock
        self._buf = bytearray()

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self._sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("migration: peer closed")
            self._buf += chunk

    def _take(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def read_entries(self) -> List[dict]:
        """Read ONE message (either generation); return its entries in the
        current schema (a binary batch frame may carry several)."""
        self._fill(4)
        if self._buf[0] == 0x7B and self._buf[3] != 0:  # legacy JSON line
            while b"\n" not in self._buf:
                self._fill(len(self._buf) + 1)
            line, _, rest = bytes(self._buf).partition(b"\n")
            self._buf = bytearray(rest)
            # A line that isn't JSON at all means the sniff mis-fired — most
            # likely a corrupt/oversize binary frame whose length LSB
            # happened to be '{' — and the bytes consumed up to this
            # arbitrary newline desynchronized the stream. That is NOT
            # recoverable: re-raise as a plain error so the server tears the
            # connection down instead of ingesting garbage. Only a
            # well-formed JSON object with a bad schema keeps the
            # frame-aligned recoverable contract.
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"migration: stream desync (not JSON): {e}")
            try:
                return [legacy_to_entry(rec)]
            except (ValueError, KeyError, TypeError) as e:
                raise RecoverableRecordError(f"bad legacy record: {e}")
        (n,) = _U32.unpack(self._take(4))
        if n > MIGRATION_MAX_FRAME:
            raise ValueError(
                f"migration: frame too large ({n} > {MIGRATION_MAX_FRAME})")
        frame = wire.decode(self._take(n))
        if isinstance(frame, dict) and frame.get("t") == "batch":
            return list(frame["entries"])
        return [frame]
