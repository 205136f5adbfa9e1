"""Port of tests/test_index_persist.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Index segment persistence tests (reference: m3ninx/persist FST segment
files + the filesystem bootstrapper's index phase)."""

import numpy as np
import pytest

from m3_tpu_torch.index import persist as idx_persist
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.index.segment import Document, ImmutableSegment, MutableSegment, execute
from m3_tpu_torch.utils import xtime
from test_torch_cpu_default import cpu_default  # noqa: F401

S = xtime.SECOND
BLOCK = 4 * xtime.HOUR
T0 = 1_600_000_000 * S - (1_600_000_000 * S) % BLOCK


def mk_segment(n=20):
    seg = MutableSegment()
    for i in range(n):
        seg.insert(Document(b"series-%d" % i, (
            (b"dc", b"east" if i % 2 else b"west"),
            (b"host", b"h%d" % (i % 5)),
        )))
    return ImmutableSegment.from_mutable(seg)


class TestSegmentFiles:
    def test_roundtrip_query_parity(self, tmp_path):
        seg = mk_segment()
        idx_persist.write_segment(str(tmp_path), b"ns", T0, seg)
        back = idx_persist.read_segment(str(tmp_path), b"ns", T0)
        for q in [iq.new_term(b"dc", b"east"),
                  iq.new_regexp(b"host", b"h[12]"),
                  iq.new_conjunction(iq.new_term(b"dc", b"west"),
                                     iq.new_term(b"host", b"h0"))]:
            want = {seg.doc(int(p)).id for p in execute(seg, q)}
            got = {back.doc(int(p)).id for p in execute(back, q)}
            assert got == want, q

    def test_digest_detects_corruption(self, tmp_path):
        seg = mk_segment(5)
        d = idx_persist.write_segment(str(tmp_path), b"ns", T0, seg)
        with open(f"{d}/segment.bin", "r+b") as f:
            f.seek(10)
            f.write(b"\xff\xff")
        with pytest.raises(IOError):
            idx_persist.read_segment(str(tmp_path), b"ns", T0)

    def test_incomplete_segment_rejected(self, tmp_path):
        seg = mk_segment(5)
        d = idx_persist.write_segment(str(tmp_path), b"ns", T0, seg)
        import os

        os.unlink(f"{d}/checkpoint")
        with pytest.raises(IOError):
            idx_persist.read_segment(str(tmp_path), b"ns", T0)
        assert idx_persist.list_segments(str(tmp_path), b"ns") == []


class TestIndexFlushBootstrap:
    def test_flush_then_bootstrap_serves_queries(self, tmp_path):
        now = {"t": T0}
        nsi = NamespaceIndex(BLOCK, clock=lambda: now["t"])
        for i in range(30):
            nsi.insert(b"m-%d" % i, {b"app": b"api" if i < 20 else b"web"},
                       T0 + (i % 3) * xtime.HOUR)
        # Block not yet cold: nothing flushes.
        assert idx_persist.flush_index(str(tmp_path), b"ns", nsi,
                                       T0 + BLOCK - 1, 30 * xtime.DAY) == []
        # Cold: flushes once, then no-ops (no double persist).
        flushed = idx_persist.flush_index(str(tmp_path), b"ns", nsi,
                                          T0 + BLOCK + 1, 30 * xtime.DAY)
        assert flushed == [T0]
        assert idx_persist.flush_index(str(tmp_path), b"ns", nsi,
                                       T0 + BLOCK + 1, 30 * xtime.DAY) == []
        # Fresh index bootstraps from disk and serves the same queries.
        nsi2 = NamespaceIndex(BLOCK, clock=lambda: now["t"])
        loaded = idx_persist.bootstrap_index(str(tmp_path), b"ns", nsi2)
        assert loaded == [T0]
        got = nsi2.query(iq.new_term(b"app", b"api"))
        want = nsi.query(iq.new_term(b"app", b"api"))
        assert set(got) == set(want) and len(got) == 20
