"""The wire value codec (host copy of the value half of
m3_tpu/rpc/wire.py): a compact self-describing binary encoding of None,
bool, int (i64), float (f64), bytes, str, list, dict and ndarray (raw
buffers, so packed codewords and columns travel without per-element
marshalling). The index segment files (index/persist.py) carry their
payload in it. The socket framing and the query wire forms belong to the
node RPC layer, which the port does not have yet."""

from __future__ import annotations

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
