"""Prometheus remote write/read wire codecs: snappy block format +
hand-rolled protobuf for the remote-storage messages, so a real Prometheus
can speak to the coordinator with no external dependencies (reference:
src/query/api/v1/handler/prometheus/remote/write.go:46 ParseRequest ->
snappy.Decode -> proto Unmarshal prompb.WriteRequest; read.go for the
matching remote read path).

prompb messages implemented (proto3 field numbers per
prometheus/prompb/remote.proto and types.proto):
  WriteRequest { repeated TimeSeries timeseries = 1; }
  ReadRequest  { repeated Query queries = 1; }
  Query        { int64 start_timestamp_ms = 1; int64 end_timestamp_ms = 2;
                 repeated LabelMatcher matchers = 3; }
  ReadResponse { repeated QueryResult results = 1; }
  QueryResult  { repeated TimeSeries timeseries = 1; }
  TimeSeries   { repeated Label labels = 1; repeated Sample samples = 2; }
  Label        { string name = 1; string value = 2; }
  Sample       { double value = 1; int64 timestamp = 2; }   // ms
  LabelMatcher { Type type = 1; string name = 2; string value = 3; }
    (Type EQ=0 NEQ=1 RE=2 NRE=3 — numerically identical to
     the port's query.model.MatchType.)

Unknown fields are skipped (proto3 forward compatibility), so newer
Prometheus senders with exemplars/metadata fields still parse.

Port of m3_tpu/coordinator/promremote.py: pure host code, byte for
byte the reference's codec."""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..query.model import Matcher, MatchType

# ---------------------------------------------------------------------------
# snappy block format (github.com/google/snappy/blob/main/format_description.txt)
# ---------------------------------------------------------------------------


class SnappyError(ValueError):
    pass


def _read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise SnappyError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise SnappyError("varint too long")


def snappy_decompress(buf: bytes) -> bytes:
    """Decompress a snappy *block* (what Prometheus remote write sends)."""
    n, pos = _read_uvarint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                if pos + nbytes > len(buf):
                    raise SnappyError("truncated literal length")
                ln = int.from_bytes(buf[pos:pos + nbytes], "little")
                pos += nbytes
            ln += 1
            if pos + ln > len(buf):
                raise SnappyError("truncated literal")
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy with 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            if pos >= len(buf):
                raise SnappyError("truncated copy-1")
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy with 2-byte offset
            ln = (tag >> 2) + 1
            if pos + 2 > len(buf):
                raise SnappyError("truncated copy-2")
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy with 4-byte offset
            ln = (tag >> 2) + 1
            if pos + 4 > len(buf):
                raise SnappyError("truncated copy-4")
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("copy offset out of range")
        start = len(out) - offset
        if offset >= ln:
            # Non-overlapping (the common label-dedup case): bulk slice.
            out += out[start:start + ln]
        else:
            # Overlapping forward copy (offset < length): byte-at-a-time
            # semantics, the run-length trick snappy uses for RLE.
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != n:
        raise SnappyError(f"length mismatch: header {n}, decoded {len(out)}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Spec-compliant literals-only snappy block (every snappy reader
    decodes it; we trade compression ratio for zero dependencies on the
    response path — requests are decompressed fully either way)."""
    out = bytearray()
    # uvarint length
    n = len(data)
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1  # <= 65535 by the chunk cap
        if ln < 60:
            out.append(ln << 2)
        elif ln < (1 << 8):
            out.append(60 << 2)
            out += ln.to_bytes(1, "little")
        else:
            out.append(61 << 2)
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


# ---------------------------------------------------------------------------
# minimal protobuf wire codec
# ---------------------------------------------------------------------------


class ProtoError(ValueError):
    pass


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) — value is int for varint/
    fixed, memoryview for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_uvarint_mv(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_uvarint_mv(buf, pos)
            yield field, wt, v
        elif wt == 1:
            if pos + 8 > n:
                raise ProtoError("truncated fixed64")
            yield field, wt, int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        elif wt == 2:
            ln, pos = _read_uvarint_mv(buf, pos)
            if pos + ln > n:
                raise ProtoError("truncated bytes field")
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            if pos + 4 > n:
                raise ProtoError("truncated fixed32")
            yield field, wt, int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        else:
            raise ProtoError(f"unsupported wire type {wt}")


def _read_uvarint_mv(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ProtoError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ProtoError("varint too long")


def _zigzag_i64(v: int) -> int:
    """proto int64 arrives as unsigned varint; reinterpret two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _f64(bits: int) -> float:
    return struct.unpack("<d", bits.to_bytes(8, "little"))[0]


def decode_write_request(data: bytes) -> List[Tuple[dict, List[Tuple[int, float]]]]:
    """prompb.WriteRequest -> [(tags {bytes: bytes}, [(t_ms, value), ...])]."""
    out = []
    for field, wt, v in _fields(memoryview(data)):
        if field == 1 and wt == 2:
            out.append(_decode_timeseries(v))
    return out


def _decode_timeseries(buf: memoryview):
    tags = {}
    samples: List[Tuple[int, float]] = []
    for field, wt, v in _fields(buf):
        if field == 1 and wt == 2:
            name = value = b""
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    name = bytes(v2)
                elif f2 == 2 and w2 == 2:
                    value = bytes(v2)
            tags[name] = value
        elif field == 2 and wt == 2:
            val = 0.0
            t_ms = 0
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 1:
                    val = _f64(v2)
                elif f2 == 2 and w2 == 0:
                    t_ms = _zigzag_i64(v2)
            samples.append((t_ms, val))
    return tags, samples


def decode_read_request(data: bytes) -> List[dict]:
    """prompb.ReadRequest -> [{"start_ms", "end_ms", "matchers": [Matcher]}]."""
    queries = []
    for field, wt, v in _fields(memoryview(data)):
        if field == 1 and wt == 2:
            q = {"start_ms": 0, "end_ms": 0, "matchers": []}
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    q["start_ms"] = _zigzag_i64(v2)
                elif f2 == 2 and w2 == 0:
                    q["end_ms"] = _zigzag_i64(v2)
                elif f2 == 3 and w2 == 2:
                    mtype = 0
                    name = value = b""
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:
                            mtype = v3
                        elif f3 == 2 and w3 == 2:
                            name = bytes(v3)
                        elif f3 == 3 and w3 == 2:
                            value = bytes(v3)
                    q["matchers"].append(
                        Matcher(MatchType(mtype), name, value))
            queries.append(q)
    return queries


# -- encoding ---------------------------------------------------------------


def _put_uvarint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _put_field_bytes(out: bytearray, field: int, data: bytes):
    _put_uvarint(out, (field << 3) | 2)
    _put_uvarint(out, len(data))
    out += data


def _encode_timeseries(tags: dict, samples: List[Tuple[int, float]]) -> bytes:
    ts = bytearray()
    for name, value in sorted(tags.items()):
        lbl = bytearray()
        _put_field_bytes(lbl, 1, name)
        _put_field_bytes(lbl, 2, value)
        _put_field_bytes(ts, 1, bytes(lbl))
    for t_ms, val in samples:
        smp = bytearray()
        _put_uvarint(smp, (1 << 3) | 1)
        smp += struct.pack("<d", val)
        _put_uvarint(smp, (2 << 3) | 0)
        _put_uvarint(smp, t_ms & ((1 << 64) - 1))
        _put_field_bytes(ts, 2, bytes(smp))
    return bytes(ts)


def encode_read_response(results: List[List[Tuple[dict, List[Tuple[int, float]]]]]) -> bytes:
    """[[(tags, [(t_ms, v)])] per query] -> prompb.ReadResponse bytes."""
    out = bytearray()
    for series_list in results:
        qr = bytearray()
        for tags, samples in series_list:
            _put_field_bytes(qr, 1, _encode_timeseries(tags, samples))
        _put_field_bytes(out, 1, bytes(qr))
    return bytes(out)


def encode_write_request(series: List[Tuple[dict, List[Tuple[int, float]]]]) -> bytes:
    """Inverse of decode_write_request (test fixtures + client use)."""
    out = bytearray()
    for tags, samples in series:
        _put_field_bytes(out, 1, _encode_timeseries(tags, samples))
    return bytes(out)
