"""Binary wire format + framing for the node RPC data plane (host copy
of m3_tpu/rpc/wire.py; reference: src/dbnode/network/server/tchannelthrift).

A compact self-describing binary codec over length-prefixed TCP frames;
the bulk payloads are numpy arrays (packed u32 TSZ codewords, i64
timestamp / f64 value columns) serialized as raw buffers, so a fetch
response feeds the batched decode kernel without per-element
marshalling. Only numpy crosses the wire, never a tensor: a port node and
a reference node exchange the same bytes. The index segment files
(index/persist.py) carry their payload in the same value codec.

Frame: <u32 length><body>, body = encode(value). Values: None, bool,
int (i64), float (f64), bytes, str, list, dict, ndarray."""

from __future__ import annotations

import socket
import struct
from typing import Any

import numpy as np

_NIL = 0
_FALSE = 1
_TRUE = 2
_I64 = 3
_F64 = 4
_BYTES = 5
_STR = 6
_LIST = 7
_DICT = 8
_NDARRAY = 9

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I64S = struct.Struct("<q")
_F64S = struct.Struct("<d")

MAX_FRAME = 1 << 31  # 2 GiB hard cap against corrupt length prefixes


class WireTruncated(ConnectionError):
    """The peer died MID-FRAME: EOF inside the length prefix or body, so
    some bytes of a frame arrived and the rest never will. One typed
    error (instead of struct.error / short-read garbage) so retriers can
    classify it as a retryable transport failure, distinct from both a
    clean between-frames close (plain ConnectionError) and a malformed
    but complete frame (ValueError — NOT retryable: the stream is
    desynced and a re-send lands on garbage)."""


def _enc(out: bytearray, v: Any, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        raise ValueError(f"wire: nesting deeper than {MAX_DEPTH}")
    if v is None:
        out += b"\x00"
    elif v is True:
        out += b"\x02"
    elif v is False:
        out += b"\x01"
    elif isinstance(v, (int, np.integer)):
        out += _U8.pack(_I64)
        out += _I64S.pack(int(v))
    elif isinstance(v, (float, np.floating)):
        out += _U8.pack(_F64)
        out += _F64S.pack(float(v))
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out += _U8.pack(_BYTES)
        out += _U32.pack(len(v))
        out += v
    elif isinstance(v, str):
        b = v.encode()
        out += _U8.pack(_STR)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        dt = a.dtype.str.encode()
        out += _U8.pack(_NDARRAY)
        out += _U8.pack(len(dt))
        out += dt
        out += _U8.pack(a.ndim)
        for s in a.shape:
            out += _I64S.pack(s)
        buf = a.tobytes()
        out += _U32.pack(len(buf))
        out += buf
    elif isinstance(v, (list, tuple)):
        out += _U8.pack(_LIST)
        out += _U32.pack(len(v))
        for item in v:
            _enc(out, item, depth + 1)
    elif isinstance(v, dict):
        out += _U8.pack(_DICT)
        out += _U32.pack(len(v))
        for k, item in v.items():
            _enc(out, k, depth + 1)
            _enc(out, item, depth + 1)
    else:
        raise TypeError(f"wire: cannot encode {type(v)!r}")


def encode(v: Any) -> bytes:
    out = bytearray()
    _enc(out, v)
    return bytes(out)


# Containers deeper than this are rejected ON BOTH SIDES: encode fails
# fast at the sender with a clear error instead of the receiver dropping
# the connection as if the peer were malicious, and decode keeps a ~10KB
# frame of nested list tags from killing a handler thread with
# RecursionError. 64 is an order of magnitude above any real payload
# (recursive query trees cost 2 levels per node).
MAX_DEPTH = 64


def _dec(buf: memoryview, pos: int, depth: int = 0):
    if depth > MAX_DEPTH:
        raise ValueError(f"wire: nesting deeper than {MAX_DEPTH}")
    tag = buf[pos]
    pos += 1
    if tag == _NIL:
        return None, pos
    if tag == _FALSE:
        return False, pos
    if tag == _TRUE:
        return True, pos
    if tag == _I64:
        return _I64S.unpack_from(buf, pos)[0], pos + 8
    if tag == _F64:
        return _F64S.unpack_from(buf, pos)[0], pos + 8
    if tag == _BYTES:
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return bytes(buf[pos : pos + n]), pos + n
    if tag == _STR:
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return bytes(buf[pos : pos + n]).decode(), pos + n
    if tag == _NDARRAY:
        dtn = buf[pos]
        pos += 1
        dt = np.dtype(bytes(buf[pos : pos + dtn]).decode())
        pos += dtn
        ndim = buf[pos]
        pos += 1
        shape = []
        for _ in range(ndim):
            shape.append(_I64S.unpack_from(buf, pos)[0])
            pos += 8
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        a = np.frombuffer(buf[pos : pos + n], dtype=dt).reshape(shape).copy()
        return a, pos + n
    if tag == _LIST:
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        out = []
        for _ in range(n):
            item, pos = _dec(buf, pos, depth + 1)
            out.append(item)
        return out, pos
    if tag == _DICT:
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos, depth + 1)
            v, pos = _dec(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    raise ValueError(f"wire: bad tag {tag}")


def decode(buf: bytes) -> Any:
    try:
        v, pos = _dec(memoryview(buf), 0)
    except (struct.error, IndexError, TypeError) as e:
        # truncated fixed-width field, out-of-range read, or garbage
        # ndarray dtype string: surface the SAME error type as every
        # other malformed-buffer case so callers catch one thing
        raise ValueError(f"wire: malformed buffer ({e})")
    if pos != len(buf):
        raise ValueError(f"wire: trailing bytes ({len(buf) - pos})")
    return v


# ------------------------------------------------------------------- framing


def write_frame(sock: socket.socket, value: Any) -> None:
    body = encode(value)
    sock.sendall(_U32.pack(len(body)) + body)


def _read_exact(sock: socket.socket, n: int, mid_frame: bool = False) -> bytes:
    """Read exactly n bytes. EOF before the first byte is a clean close
    (plain ConnectionError) unless `mid_frame` — a frame header already
    committed the peer to a body — and EOF after a partial read is always
    WireTruncated: the peer died inside a frame."""
    want = n
    parts = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            if mid_frame or n != want:
                raise WireTruncated(
                    f"wire: peer closed mid-frame ({want - n}/{want} bytes)")
            raise ConnectionError("wire: peer closed")
        parts.append(chunk)
        n -= len(chunk)
    return b"".join(parts)


def read_frame(sock: socket.socket) -> Any:
    (n,) = _U32.unpack(_read_exact(sock, 4))
    if n > MAX_FRAME:
        raise ValueError(f"wire: frame too large ({n})")
    return decode(_read_exact(sock, n, mid_frame=True))


def read_dict_frame(sock: socket.socket) -> dict:
    """read_frame + top-level shape check: every server protocol in this
    codebase frames dict messages, and a well-formed frame with the wrong
    top type must surface as the SAME ValueError every handler loop
    already treats as drop-the-connection (not an AttributeError
    traceback at the first .get)."""
    v = read_frame(sock)
    if not isinstance(v, dict):
        raise ValueError(f"wire: expected dict frame, got {type(v).__name__}")
    return v


# ------------------------------------------------------ deadline propagation

# Optional request-frame key carrying the caller's REMAINING time budget
# in nanoseconds (a relative budget, not an absolute timestamp: monotonic
# clocks don't compare across hosts and wall clocks skew). Every server
# loop re-anchors it against its own clock on receipt.
DEADLINE_KEY = "d"


def deadline_from_frame(req: dict):
    """Deadline from a request frame's budget field, or None. A malformed
    budget (wrong type, negative) is treated as absent: deadline metadata
    must never be the thing that kills an otherwise-valid request."""
    from ..utils.retry import Deadline

    budget = req.get(DEADLINE_KEY)
    if not isinstance(budget, int) or isinstance(budget, bool) or budget < 0:
        return None
    return Deadline.from_wire(budget)


# ------------------------------------------------------ trace propagation

# Optional request-frame key carrying the caller's span context (trace id
# + parent span id) — only attached for SAMPLED traces, so its presence
# is the sampling decision and the server never rolls its own. Rides the
# frame beside the deadline "d" and priority "pri" hints. The matching
# RESPONSE key "sp" carries the server's finished span tree back for the
# client to graft, making one cross-process tree per request.
TRACE_KEY = "tr"
SPAN_KEY = "sp"


def trace_from_frame(req: dict):
    """SpanContext from a request frame, or None. Malformed trace
    metadata is treated as absent (same contract as the deadline field)."""
    from ..utils.tracing import SpanContext

    return SpanContext.from_wire(req.get(TRACE_KEY))


# -------------------------------------------------- index query serialization


def query_to_wire(q) -> dict:
    """index.Query <-> plain dict (thrift rpc.thrift Query equivalent)."""
    from ..index import query as iq

    if isinstance(q, iq.AllQuery):
        return {"t": "all"}
    if isinstance(q, iq.TermQuery):
        return {"t": "term", "f": q.field, "v": q.value}
    if isinstance(q, iq.RegexpQuery):
        return {"t": "regexp", "f": q.field, "v": q.pattern}
    if isinstance(q, iq.ConjunctionQuery):
        return {"t": "conj", "qs": [query_to_wire(s) for s in q.queries]}
    if isinstance(q, iq.DisjunctionQuery):
        return {"t": "disj", "qs": [query_to_wire(s) for s in q.queries]}
    if isinstance(q, iq.NegationQuery):
        return {"t": "neg", "q": query_to_wire(q.query)}
    raise TypeError(f"unknown query {type(q)!r}")


def query_from_wire(d: dict):
    from ..index import query as iq

    t = d["t"]
    if t == "all":
        return iq.AllQuery()
    if t == "term":
        return iq.TermQuery(d["f"], d["v"])
    if t == "regexp":
        return iq.RegexpQuery(d["f"], d["v"])
    if t == "conj":
        return iq.ConjunctionQuery(tuple(query_from_wire(s) for s in d["qs"]))
    if t == "disj":
        return iq.DisjunctionQuery(tuple(query_from_wire(s) for s in d["qs"]))
    if t == "neg":
        return iq.NegationQuery(query_from_wire(d["q"]))
    raise ValueError(f"unknown query type {t!r}")
