"""The port's Prometheus remote write/read codecs (m3_tpu_torch/
coordinator/promremote.py: the snappy block format and the prompb
protobuf messages) against the reference's (m3_tpu/coordinator/
promremote.py), on the CPU: the bytes each package writes are equal in
both directions, each package decodes what the other wrote to equal
values, and a corrupt or truncated body raises the same error class with
the same message. Inputs are seeded with numpy; the cases of
tests/test_prom_remote.py are included. Everything is compared exactly:
no tolerance applies."""

import struct

import numpy as np
import pytest

from m3_tpu.coordinator import promremote as jpr
from m3_tpu_torch.coordinator import promremote as tpr
from test_torch_metrics_rules import canon

LENGTHS = [0, 1, 59, 60, 61, 255, 256, 257, 4096, 65535, 65536, 65537,
           200_000]


@pytest.mark.parametrize("n", LENGTHS)
def test_snappy_compress_bytes_equal_reference(n):
    """Literal-length edges (60, 256, the 64 KiB chunk) on seeded bytes:
    equal blocks, each package's block decoded by the other."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    block = jpr.snappy_compress(data)
    assert tpr.snappy_compress(data) == block
    assert tpr.snappy_decompress(block) == data
    assert jpr.snappy_decompress(tpr.snappy_compress(data)) == data


def _copy_streams():
    """tests/test_prom_remote.py's hand-made streams (a copy-1 run-length
    copy, a copy-2) and a copy-4, an overlapping copy and a long literal
    length."""
    data = b"0123456789" * 10
    c2 = bytearray([120 & 0x7F | 0x80, 120 >> 7, 60 << 2, 99]) + data
    c2 += bytes([((20 - 1) << 2) | 2]) + (100).to_bytes(2, "little")
    c4 = bytearray([110, 60 << 2, 99]) + data
    c4 += bytes([((10 - 1) << 2) | 3]) + (37).to_bytes(4, "little")
    lit = bytearray([0x80, 0x02, 61 << 2]) + (255).to_bytes(2, "little")
    lit += bytes(range(256))
    return [bytes([12, 0b000010_00, 97, 98, 99, 0b000_101_01, 3]),
            bytes(c2), bytes(c4), bytes(lit),
            bytes([6, 0, 120, 0b000_001_01, 1])]


@pytest.mark.parametrize("k", range(5))
def test_snappy_copy_elements_equal_reference(k):
    stream = _copy_streams()[k]
    assert tpr.snappy_decompress(stream) == jpr.snappy_decompress(stream)


BAD_SNAPPY = [b"", bytes([0x80]), bytes([0xFF] * 11),
              bytes([5, 0b000010_00, 97]), bytes([1, 0b000_000_01, 9]),
              bytes([4, 0b000_000_01]), bytes([4, 2, 1]), bytes([4, 3, 1, 0]),
              bytes([3, 0, 97]), bytes([70, 60 << 2]),
              bytes([2, 0, 97, 0b000_000_10, 0, 0])]


@pytest.mark.parametrize("k", range(len(BAD_SNAPPY)))
def test_snappy_errors_equal_reference(k):
    """Truncated varints, literals and copies, offsets out of range and a
    length mismatch: the same error and message in both packages."""
    stream = BAD_SNAPPY[k]
    with pytest.raises(jpr.SnappyError) as jerr:
        jpr.snappy_decompress(stream)
    with pytest.raises(tpr.SnappyError) as terr:
        tpr.snappy_decompress(stream)
    assert str(terr.value) == str(jerr.value)


def _series(seed, n=40):
    """Seeded WriteRequest series: label sets with shared names, samples
    with negative timestamps and values, NaN, infinities, -0.0 and
    denormals among them."""
    rng = np.random.default_rng(seed)
    specials = [float("nan"), float("inf"), -float("inf"), -0.0, 5e-324,
                1e300, -1.5]
    out = []
    for i in range(n):
        tags = {b"__name__": b"m%d" % rng.integers(5),
                b"job": b"j%d" % rng.integers(3),
                b"i": str(i).encode()}
        if rng.random() < 0.5:
            tags[b"le"] = b"0.%d" % rng.integers(99)
        k = int(rng.integers(0, 6))
        ts = rng.integers(-10**12, 2 * 10**12, k).tolist()
        vs = rng.normal(0, 1e6, k).tolist()
        for j in range(k):
            if rng.random() < 0.3:
                vs[j] = specials[int(rng.integers(len(specials)))]
        out.append((tags, list(zip(ts, vs))))
    return out


def _bits(series):
    """Decoded series with values as their f64 bit patterns, so NaN and
    -0.0 compare exactly."""
    return [(tags, [(t, struct.pack("<d", v)) for t, v in samples])
            for tags, samples in series]


@pytest.mark.parametrize("seed", range(5))
def test_write_request_bytes_equal_reference(seed):
    series = _series(seed)
    enc = jpr.encode_write_request(series)
    assert tpr.encode_write_request(series) == enc
    assert _bits(tpr.decode_write_request(enc)) == _bits(series)
    assert _bits(tpr.decode_write_request(enc)) == \
        _bits(jpr.decode_write_request(enc))
    # The remote-write body as Prometheus sends it: snappy around it.
    body = jpr.snappy_compress(enc)
    assert tpr.snappy_compress(tpr.encode_write_request(series)) == body
    assert _bits(tpr.decode_write_request(tpr.snappy_decompress(body))) == \
        _bits(series)


def test_unknown_fields_skipped_equal_reference():
    """Unknown varint, fixed32, fixed64 and bytes fields at every level
    are skipped alike (proto3 forward compatibility)."""
    series = [({b"n": b"v"}, [(123000, 4.5)])]
    enc = bytearray(jpr.encode_write_request(series))
    enc += bytes([7 << 3, 42])
    enc += bytes([(9 << 3) | 2, 3]) + b"xyz"
    enc += bytes([(10 << 3) | 5]) + b"\x01\x02\x03\x04"
    enc += bytes([(11 << 3) | 1]) + bytes(8)
    assert tpr.decode_write_request(bytes(enc)) == \
        jpr.decode_write_request(bytes(enc)) == series


def _read_request(seed):
    rng = np.random.default_rng(seed)
    req = bytearray()
    for _ in range(int(rng.integers(1, 4))):
        q = bytearray()
        jpr._put_uvarint(q, (1 << 3) | 0)
        jpr._put_uvarint(q, int(rng.integers(0, 2 * 10**12)))
        jpr._put_uvarint(q, (2 << 3) | 0)
        jpr._put_uvarint(q, int(rng.integers(0, 2 * 10**12)))
        for k in range(int(rng.integers(0, 4))):
            m = bytearray()
            jpr._put_uvarint(m, (1 << 3) | 0)
            jpr._put_uvarint(m, int(rng.integers(0, 4)))
            jpr._put_field_bytes(m, 2, b"l%d" % k)
            jpr._put_field_bytes(m, 3, b"v.*%d" % rng.integers(9))
            jpr._put_field_bytes(q, 3, bytes(m))
        jpr._put_field_bytes(req, 1, bytes(q))
    return bytes(req)


@pytest.mark.parametrize("seed", range(5))
def test_read_request_and_response_equal_reference(seed):
    """ReadRequest decode (matchers as equal values) and ReadResponse
    encode (equal bytes) for seeded queries and result sets."""
    req = _read_request(seed)
    assert canon(tpr.decode_read_request(req)) == \
        canon(jpr.decode_read_request(req))
    results = [_series(seed * 10 + k, 8) for k in range(3)]
    resp = jpr.encode_read_response(results)
    assert tpr.encode_read_response(results) == resp
    assert tpr.snappy_compress(resp) == jpr.snappy_compress(resp)


BAD_PROTO = [bytes([0x0A, 5, 1]), bytes([0x0A]), bytes([0x80]),
             bytes([(3 << 3) | 3]), bytes([(3 << 3) | 1, 1, 2]),
             bytes([(3 << 3) | 5, 1]), bytes([0xFF] * 12)]


@pytest.mark.parametrize("k", range(len(BAD_PROTO)))
def test_proto_errors_equal_reference(k):
    """Truncated fields and varints and an unsupported wire type: the
    same error and message from both decoders."""
    body = BAD_PROTO[k]
    for decode in ("decode_write_request", "decode_read_request"):
        with pytest.raises(jpr.ProtoError) as jerr:
            getattr(jpr, decode)(body)
        with pytest.raises(tpr.ProtoError) as terr:
            getattr(tpr, decode)(body)
        assert str(terr.value) == str(jerr.value)
