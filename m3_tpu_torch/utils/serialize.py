"""Tag wire codec (host copy of m3_tpu/utils/serialize.py; reference:
src/x/serialize/encoder.go — the length-prefixed binary tag encoding
used on the dbnode write path and in fileset index entries: header
magic + tag count, then per-tag u16-length-prefixed name/value byte
strings)."""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

# Same u16 header marker value as the reference (encoder.go
# headerMagicNumber = 10101); the surrounding format is reference-shaped
# (little-endian u16 lengths), not byte-for-byte identical.
HEADER_MAGIC = 10101
_U16 = struct.Struct("<H")

MAX_TAGS = 0xFFFF
MAX_LEN = 0xFFFF


class TagEncodeError(ValueError):
    pass


def encode_tags(tags: Dict[bytes, bytes]) -> bytes:
    """serialize.TagEncoder#Encode."""
    if len(tags) > MAX_TAGS:
        raise TagEncodeError(f"too many tags ({len(tags)})")
    out = bytearray()
    out += _U16.pack(HEADER_MAGIC)
    out += _U16.pack(len(tags))
    for name in sorted(tags):
        value = tags[name]
        for part in (name, value):
            if len(part) > MAX_LEN:
                raise TagEncodeError("tag component too long")
            out += _U16.pack(len(part))
            out += part
    return bytes(out)


def decode_tags(buf: bytes) -> Dict[bytes, bytes]:
    """serialize.TagDecoder: validates the magic + structure."""
    return dict(iter_tags(buf))


def iter_tags(buf: bytes) -> Iterator[Tuple[bytes, bytes]]:
    if len(buf) < 4:
        raise TagEncodeError("short tag buffer")
    (magic,) = _U16.unpack_from(buf, 0)
    if magic != HEADER_MAGIC:
        raise TagEncodeError(f"bad tag header {magic:#x}")
    (count,) = _U16.unpack_from(buf, 2)
    pos = 4
    for _ in range(count):
        parts = []
        for _ in range(2):
            if pos + 2 > len(buf):
                raise TagEncodeError("truncated tag length")
            (n,) = _U16.unpack_from(buf, pos)
            pos += 2
            if pos + n > len(buf):
                raise TagEncodeError("truncated tag bytes")
            parts.append(buf[pos:pos + n])
            pos += n
        yield parts[0], parts[1]
    if pos != len(buf):
        raise TagEncodeError("trailing bytes after tags")
