"""Port of tests/test_property.py on m3_tpu_torch: the same cases on the
port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py). The codec oracle stays the reference's
`m3_tpu/ops/ref_codec.py` (plain numpy, no JAX), the wire-format oracle of
both packages.

Property-based tests (reference test tier 2, TESTING.md: gopter
generative tests — commitlog read/write roundtrip prop
(persist/fs/commitlog/read_write_prop_test.go), encoding roundtrip
(m3tsz/roundtrip_test.go), serialize lifecycle
(x/serialize/decoder_lifecycle_prop_test.go), index query proptest
(m3ninx/search/proptest), shard race prop
(storage/shard_race_prop_test.go — Python threads under the GIL still
exercise interleaving on the lock boundaries)."""

import threading

import numpy as np
import pytest
from test_torch_cpu_default import cpu_default  # noqa: F401

# hypothesis is an optional dev dependency: without it this tier-2 module
# must SKIP at collection, not error the whole collection pass.
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from m3_tpu.ops import ref_codec
from m3_tpu_torch.utils import serialize
from m3_tpu_torch.utils import xtime

S = xtime.SECOND
T0 = 1_600_000_000 * S


# --------------------------------------------------------------- codec

@st.composite
def series_points(draw):
    n = draw(st.integers(min_value=1, max_value=200))
    # Timestamps in TICKS (the codec encodes unit-scaled ticks; callers pick
    # the xtime unit): regular step with jitter, strictly increasing.
    base_step = draw(st.sampled_from([1, 10, 60]))
    jitter = draw(st.lists(
        st.integers(min_value=0, max_value=max(1, base_step // 2)),
        min_size=n, max_size=n))
    ts = np.cumsum(np.full(n, base_step) + np.array(jitter)) + T0 // S
    kind = draw(st.sampled_from(["int_like", "float", "mixed", "special"]))
    if kind == "int_like":
        vals = draw(st.lists(st.integers(min_value=-10**9, max_value=10**9),
                             min_size=n, max_size=n))
        values = np.array(vals, dtype=np.float64)
    elif kind == "float":
        vals = draw(st.lists(
            st.floats(min_value=-1e12, max_value=1e12,
                      allow_nan=False, allow_infinity=False),
            min_size=n, max_size=n))
        values = np.array(vals)
    elif kind == "mixed":
        vals = draw(st.lists(
            st.one_of(st.integers(min_value=-1000, max_value=1000),
                      st.floats(min_value=-1e6, max_value=1e6,
                                allow_nan=False, allow_infinity=False)),
            min_size=n, max_size=n))
        values = np.array([float(v) for v in vals])
    else:
        pool = [0.0, -0.0, 1e-300, -1e300, np.inf, -np.inf,
                float(np.finfo(np.float64).max), 1.5e-5]
        vals = draw(st.lists(st.sampled_from(pool), min_size=n, max_size=n))
        values = np.array(vals)
    return ts.astype(np.int64), values


class TestCodecRoundtripProperty:
    @settings(max_examples=60, deadline=None)
    @given(series_points())
    def test_roundtrip_bit_exact(self, pts):
        ts, values = pts
        blk = ref_codec.encode(ts, values)
        t2, v2 = ref_codec.decode(blk)
        np.testing.assert_array_equal(t2, ts)
        # Bit-exact float64 roundtrip (the codec's core invariant).
        np.testing.assert_array_equal(
            np.asarray(v2).view(np.uint64), values.view(np.uint64))


# --------------------------------------------------------------- serialize

class TestSerializeProperty:
    @settings(max_examples=60, deadline=None)
    @given(st.dictionaries(
        st.binary(min_size=0, max_size=40), st.binary(min_size=0, max_size=40),
        max_size=20))
    def test_tags_roundtrip(self, tags):
        assert serialize.decode_tags(serialize.encode_tags(tags)) == tags

    @settings(max_examples=60, deadline=None)
    @given(st.dictionaries(st.binary(min_size=1, max_size=10),
                           st.binary(max_size=10), max_size=6),
           st.integers(min_value=0, max_value=100))
    def test_truncation_always_detected(self, tags, cut):
        buf = serialize.encode_tags(tags)
        if cut == 0 or cut >= len(buf):
            return
        truncated = buf[:-cut]
        try:
            out = serialize.decode_tags(truncated)
        except serialize.TagEncodeError:
            return  # detected, good
        # If it decoded, it must NOT equal the original (no silent alias).
        assert out != tags


# --------------------------------------------------------------- commitlog

class TestCommitlogProperty:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(
        st.tuples(st.sampled_from([b"ns1", b"ns2"]),
                  st.binary(min_size=1, max_size=12),
                  st.integers(min_value=0, max_value=2**40),
                  st.floats(allow_nan=False, allow_infinity=False,
                            width=64)),
        min_size=0, max_size=120))
    def test_write_replay_roundtrip(self, entries):
        import tempfile

        from m3_tpu_torch.persist import commitlog as cl

        d = tempfile.mkdtemp(prefix="m3tpu-clprop-")
        log = cl.CommitLog(d, strategy=cl.Strategy.WRITE_WAIT)
        for ns, sid, t, v in entries:
            log.write(ns, sid, t, v)
        log.close()
        replayed = list(cl.replay(d))
        assert len(replayed) == len(entries)
        for (ns, sid, t, v), (rns, rsid, rt, rv) in zip(entries, replayed):
            assert (ns, sid, t) == (rns, rsid, rt)
            assert np.float64(v).view(np.uint64) == np.float64(rv).view(np.uint64)


# --------------------------------------------------------------- index

class TestIndexQueryProperty:
    @settings(max_examples=30, deadline=None)
    @given(st.data())
    def test_boolean_search_matches_bruteforce(self, data):
        from m3_tpu_torch.index import query as iq
        from m3_tpu_torch.index.segment import Document, MutableSegment, execute

        fields = [b"a", b"b", b"c"]
        values = [b"x", b"y", b"z"]
        n_docs = data.draw(st.integers(min_value=1, max_value=30))
        docs = []
        seg = MutableSegment()
        for i in range(n_docs):
            tags = {
                f: data.draw(st.sampled_from(values), label=f"doc{i}.{f}")
                for f in fields
                if data.draw(st.booleans(), label=f"has{i}.{f}")
            }
            sid = b"doc-%d" % i
            docs.append((sid, tags))
            seg.insert(Document(sid, tuple(sorted(tags.items()))))

        def rand_query(depth=0):
            kind = data.draw(st.sampled_from(
                ["term", "term", "regexp", "conj", "disj", "neg"]
                if depth < 2 else ["term", "regexp"]))
            if kind == "term":
                return iq.new_term(data.draw(st.sampled_from(fields)),
                                   data.draw(st.sampled_from(values)))
            if kind == "regexp":
                return iq.new_regexp(data.draw(st.sampled_from(fields)),
                                     data.draw(st.sampled_from([b"x|y", b"[yz]", b".*"])))
            if kind == "neg":
                return iq.new_negation(rand_query(depth + 1))
            parts = [rand_query(depth + 1) for _ in
                     range(data.draw(st.integers(min_value=1, max_value=3)))]
            return (iq.new_conjunction(*parts) if kind == "conj"
                    else iq.new_disjunction(*parts))

        def brute(q, tags):
            import re as _re

            if isinstance(q, iq.AllQuery):
                return True
            if isinstance(q, iq.TermQuery):
                return tags.get(q.field) == q.value
            if isinstance(q, iq.RegexpQuery):
                v = tags.get(q.field)
                return v is not None and _re.fullmatch(q.pattern, v) is not None
            if isinstance(q, iq.ConjunctionQuery):
                return all(brute(p, tags) for p in q.queries)
            if isinstance(q, iq.DisjunctionQuery):
                return any(brute(p, tags) for p in q.queries)
            if isinstance(q, iq.NegationQuery):
                return not brute(q.query, tags)
            raise AssertionError(q)

        q = rand_query()
        got = {seg.doc(p).id for p in execute(seg, q)}
        want = {sid for sid, tags in docs if brute(q, tags)}
        assert got == want


# --------------------------------------------------------------- shard race

class TestShardRace:
    def test_concurrent_writes_one_series_space(self):
        """storage/shard_race_prop_test.go analog: concurrent writers to an
        overlapping id space; every accepted write must be readable and
        series counts consistent."""
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        now = {"t": T0}
        db = Database(ShardSet(4), clock=lambda: now["t"])
        db.create_namespace(b"default", NamespaceOptions(index_enabled=False))
        n_threads, n_writes = 8, 200
        errors = []

        def writer(tid):
            try:
                for i in range(n_writes):
                    sid = b"race-%d" % ((tid * 7 + i) % 20)
                    db.write(b"default", sid, now["t"] + (i % 50) * S + tid,
                             float(tid * 1000 + i))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        # All 20 series exist, each readable, total points = dedup of writes.
        total = 0
        for i in range(20):
            t, v = db.read(b"default", b"race-%d" % i, 0, now["t"] + 3600 * S)
            assert len(t) == len(np.unique(t))
            total += len(t)
        assert total > 0
