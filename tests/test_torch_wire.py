"""The port's wire framing (m3_tpu_torch.rpc.wire) against the
reference's (m3_tpu.rpc.wire), on the CPU: the same requests give the
same frame bytes (numpy columns, the deadline budget, the trace context
and every index query form), each package reads the other's frames, and
the typed short-read, oversize and shape errors match."""

import socket
import struct

import numpy as np
import pytest
import torch

from m3_tpu.index import query as jiq
from m3_tpu.rpc import wire as jwire
from m3_tpu.utils.retry import Deadline as JDeadline
from m3_tpu.utils.tracing import SpanContext as JSpanContext
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.rpc import wire
from m3_tpu_torch.utils.retry import Deadline
from m3_tpu_torch.utils.tracing import SpanContext


def _requests(rng):
    """Request frames as the node client builds them."""
    words = rng.integers(0, 2**32, (5, 7), dtype=np.uint64).astype(np.uint32)
    return [
        {"m": "health", "id": 1, "a": {}},
        {"m": "write_batch", "id": 2, "pri": "bulk",
         "a": {"ns": b"default", "ids": [b"a", b"b{x=1}"],
               "ts": rng.integers(0, 2**62, 2).astype(np.int64),
               "vals": rng.standard_normal(2),
               "tags": [{b"__name__": b"a"}, None]}},
        {"m": "fetch_block_tiles", "id": 3, "a": {
            "ns": b"n", "shard": 7, "blocks": [{"bs": 2**61, "ids": [b"s"]}]}},
        {"id": 4, "ok": True, "r": {
            "bs": 12, "rows": np.arange(5, dtype=np.int32), "words": words,
            "nbits": np.full(5, 77, np.int32),
            "npoints": np.zeros(5, np.int32), "window": 8, "time_unit": 3,
            "exhaustive": True, "f": 0.25, "neg": -(2**40), "none": None,
            "empty": np.zeros((0, 3), np.float64), "s": "text"}},
    ]


def _frame_bytes(mod, value) -> bytes:
    a, b = socket.socketpair()
    try:
        mod.write_frame(a, value)
        a.shutdown(socket.SHUT_WR)
        out = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(out)
            out.append(chunk)
    finally:
        a.close()
        b.close()


def _read_from(mod, data: bytes, dict_frame: bool = False):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.shutdown(socket.SHUT_WR)
        return (mod.read_dict_frame(b) if dict_frame else mod.read_frame(b))
    finally:
        a.close()
        b.close()


def _same(x, y):
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray) and x.dtype == y.dtype
        assert x.shape == y.shape and x.tobytes() == y.tobytes()
    elif isinstance(x, dict):
        assert list(x) == list(y)
        for k in x:
            _same(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            _same(a, b)
    else:
        assert type(x) is type(y) and x == y


@pytest.mark.parametrize("case", range(4))
def test_frames_are_byte_equal(case):
    req = _requests(np.random.default_rng(case))[case]
    port = _frame_bytes(wire, req)
    assert port == _frame_bytes(jwire, req)
    assert struct.unpack("<I", port[:4])[0] == len(port) - 4


@pytest.mark.parametrize("writer,reader", [(wire, jwire), (jwire, wire)],
                         ids=["port-to-ref", "ref-to-port"])
def test_each_package_reads_the_others_frames(writer, reader):
    for req in _requests(np.random.default_rng(5)):
        _same(req,
              _read_from(reader, _frame_bytes(writer, req), dict_frame=True))


def _query_pairs():
    """Every index query form, built in each package."""
    def build(m):
        term = m.TermQuery(b"city", b"sf")
        rx = m.RegexpQuery(b"host", b"web0[1-3]")
        return [m.AllQuery(), term, rx,
                m.ConjunctionQuery((term, rx)),
                m.DisjunctionQuery((term, m.NegationQuery(rx))),
                m.NegationQuery(m.ConjunctionQuery(
                    (m.AllQuery(), m.DisjunctionQuery((term, rx)))))]
    return list(zip(build(iq), build(jiq)))


@pytest.mark.parametrize("k", range(6))
def test_query_forms_are_equal(k):
    q, jq = _query_pairs()[k]
    d = wire.query_to_wire(q)
    assert d == jwire.query_to_wire(jq)
    assert wire.encode(d) == jwire.encode(jwire.query_to_wire(jq))
    back = wire.query_from_wire(jwire.query_to_wire(jq))
    assert wire.query_to_wire(back) == d and type(back).__name__ == \
        type(q).__name__
    jback = jwire.query_from_wire(d)
    assert jwire.query_to_wire(jback) == d
    with pytest.raises(ValueError, match="unknown query type"):
        wire.query_from_wire({"t": "nope"})


def test_deadline_and_trace_ride_the_frame():
    dl, jdl = Deadline.after(5.0), JDeadline.after(5.0)
    for mod, d in ((wire, dl), (jwire, jdl)):
        req = {"m": "fetch", "id": 1, "a": {}, mod.DEADLINE_KEY: d.to_wire(),
               mod.TRACE_KEY: {"t": 11, "s": 12}}
        for reader in (wire, jwire):
            got = _read_from(reader, _frame_bytes(mod, req), True)
            assert 0 < reader.deadline_from_frame(got).remaining() <= 5.0
            assert tuple(reader.trace_from_frame(got)) == (11, 12)
    assert (wire.DEADLINE_KEY, wire.TRACE_KEY, wire.SPAN_KEY) == \
        (jwire.DEADLINE_KEY, jwire.TRACE_KEY, jwire.SPAN_KEY)
    assert SpanContext(11, 12).to_wire() == JSpanContext(11, 12).to_wire()
    for bad in ({"d": -1}, {"d": True}, {"d": "5"}, {}):
        assert wire.deadline_from_frame(bad) is None
        assert jwire.deadline_from_frame(bad) is None
    for bad in ({"tr": {"t": True, "s": 1}}, {"tr": [1, 2]}, {}):
        assert wire.trace_from_frame(bad) is None
        assert jwire.trace_from_frame(bad) is None


def test_short_reads_oversize_and_shape_errors_match():
    full = _frame_bytes(wire, {"m": "health", "id": 9})
    for mod in (wire, jwire):
        with pytest.raises(mod.WireTruncated):
            _read_from(mod, full[:2])          # inside the length prefix
        with pytest.raises(mod.WireTruncated):
            _read_from(mod, full[:-3])         # inside the body
        with pytest.raises(ConnectionError) as err:
            _read_from(mod, b"")               # clean close between frames
        assert not isinstance(err.value, mod.WireTruncated)
        with pytest.raises(ValueError, match="too large"):
            _read_from(mod, struct.pack("<I", mod.MAX_FRAME + 1))
        with pytest.raises(ValueError, match="expected dict frame"):
            _read_from(mod, _frame_bytes(mod, [1, 2]), dict_frame=True)
    assert wire.MAX_FRAME == jwire.MAX_FRAME


def test_a_tensor_never_reaches_the_wire():
    with pytest.raises(TypeError, match="cannot encode"):
        wire.encode({"words": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(TypeError, match="cannot encode"):
        wire.encode(torch.tensor(3))
