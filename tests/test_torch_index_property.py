"""Port of tests/test_index_property.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Seeded property suite for the array-native inverted index.

The contract under test: the bitmap-kernel searcher (`execute`, dual-form
postings + density-adaptive word kernels + regexp prefix-range pruning)
is RESULT-IDENTICAL to the original pure set-algebra evaluator
(`execute_ref`, kept verbatim as the oracle) across randomized segments
and query trees — including negation-only conjunctions, duplicate doc
ids across merged segments, and regexps over empty/missing fields — and
the postings-list cache returns bit-identical arrays on hits, with
seal/merge/expiry invalidating per segment generation.

test_fuzz style: every case derives from a seed, failures print it."""

import re

import numpy as np
import pytest

from m3_tpu_torch.index import query as iq
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.index.postings_cache import PostingsListCache
from m3_tpu_torch.index.query import literal_prefix
from m3_tpu_torch.index.segment import (
    Document,
    ImmutableSegment,
    MutableSegment,
    TermDict,
    execute,
    execute_ref,
)
from m3_tpu_torch.utils import instrument, xtime
from test_torch_cpu_default import cpu_default  # noqa: F401

T0 = 1_600_000_000 * xtime.SECOND

# Alphabets chosen to stress the term dictionary's byte ordering: shared
# prefixes, embedded/trailing NULs, 0xFF bytes (prefix-successor carries),
# and empty values.
FIELDS = [b"f0", b"f1", b"f2", b"nul\x00fld"]
VALUE_PARTS = [b"", b"a", b"ab", b"abc", b"abd", b"b", b"ba", b"\x00",
               b"a\x00", b"a\x00b", b"\xff", b"\xff\xff", b"z\xff", b"zz"]
PATTERNS = [b"a.*", b"ab.*", b"a", b"", b".*", b"ab?c?", b"a\x00?b?",
            b"[ab].*", b"a.*|b.*", b"z?\xff.*", b"x.*", b"abc|abd",
            b"a+\x00*b*", b"(ab|ba).*"]


def _rand_value(rng):
    k = int(rng.integers(1, 3))
    return b"".join(VALUE_PARTS[int(rng.integers(len(VALUE_PARTS)))]
                    for _ in range(k))


def _rand_doc(rng, i):
    fields = []
    for f in FIELDS:
        if rng.random() < 0.75:  # some docs miss some fields
            fields.append((f, _rand_value(rng)))
    if rng.random() < 0.1 and fields:  # duplicate (name, value) pair
        fields.append(fields[0])
    return Document(b"doc-%05d" % i, tuple(fields))


def _rand_query(rng, depth=0):
    r = rng.random()
    field = FIELDS[int(rng.integers(len(FIELDS)))] if rng.random() < 0.9 \
        else b"missing_field"
    if depth >= 3 or r < 0.30:
        if rng.random() < 0.5:
            return iq.new_term(field, _rand_value(rng))
        return iq.new_regexp(field,
                             PATTERNS[int(rng.integers(len(PATTERNS)))])
    if r < 0.45:
        return iq.AllQuery()
    if r < 0.65:
        subs = [_rand_query(rng, depth + 1)
                for _ in range(int(rng.integers(2, 4)))]
        if rng.random() < 0.25:  # negation-only conjunction
            subs = [iq.new_negation(s) for s in subs]
        elif rng.random() < 0.5:
            subs[-1] = iq.new_negation(subs[-1])
        return iq.ConjunctionQuery(tuple(subs))
    if r < 0.85:
        return iq.DisjunctionQuery(tuple(
            _rand_query(rng, depth + 1)
            for _ in range(int(rng.integers(2, 4)))))
    return iq.new_negation(_rand_query(rng, depth + 1))


def _build_segment(rng):
    """Random segment in one of the shapes a query can meet: live
    mutable, sealed immutable, or a merge with OVERLAPPING doc ids (the
    duplicate-id compaction shape)."""
    n = int(rng.integers(1, 40))
    docs = [_rand_doc(rng, i) for i in range(n)]
    shape = int(rng.integers(3))
    if shape == 0:
        seg = MutableSegment()
        seg.insert_batch(docs)
        for d in docs[:: max(n // 4, 1)]:
            seg.insert(d)  # dedup re-inserts
        return seg
    if shape == 1:
        seg = MutableSegment()
        seg.insert_batch(docs)
        return ImmutableSegment.from_mutable(seg)
    cut_lo, cut_hi = sorted(rng.integers(0, n + 1, size=2))
    a, b = MutableSegment(), MutableSegment()
    a.insert_batch(docs[:cut_hi])
    b.insert_batch(docs[cut_lo:])  # overlap -> duplicate ids in the merge
    if not len(a):
        a.insert_batch(docs[:1])
    if not len(b):
        b.insert_batch(docs[-1:])
    return ImmutableSegment.merge([ImmutableSegment.from_mutable(a),
                                   ImmutableSegment.from_mutable(b)])


class TestBitmapVsSetAlgebra:
    def test_thousand_seeded_cases(self):
        """>= 1000 (segment, query) cases: execute == execute_ref."""
        cases = 0
        for seed in range(250):
            rng = np.random.default_rng(1000 + seed)
            seg = _build_segment(rng)
            cache = PostingsListCache(scope=instrument.Scope())
            for qi in range(5):
                q = _rand_query(rng)
                want = execute_ref(seg, q)
                got = execute(seg, q)
                got_cached = execute(seg, q, cache=cache)
                ctx = f"seed={1000 + seed} query#{qi} {q}"
                assert np.array_equal(got, want), ctx
                assert got.dtype == want.dtype == np.int32, ctx
                assert np.array_equal(got_cached, want), ctx
                cases += 1
        assert cases >= 1000

    def test_empty_field_regexps(self):
        seg = MutableSegment()
        seg.insert(Document(b"only", ((b"present", b"v"),)))
        imm = ImmutableSegment.from_mutable(seg)
        for s in (seg, imm):
            for pat in (b".*", b"", b"a.*"):
                q = iq.new_regexp(b"absent", pat)
                assert np.array_equal(execute(s, q), execute_ref(s, q))
                assert len(execute(s, q)) == 0

    def test_negation_only_conjunction_matches_ref(self):
        rng = np.random.default_rng(7)
        seg = _build_segment(rng)
        q = iq.ConjunctionQuery((
            iq.new_negation(iq.new_term(b"f0", b"a")),
            iq.new_negation(iq.new_regexp(b"f1", b"a.*")),
        ))
        assert np.array_equal(execute(seg, q), execute_ref(seg, q))

    def test_duplicate_ids_across_merge_query_path(self):
        """The namespace materialization dedups ids that a merged segment
        holds at two positions."""
        a, b = MutableSegment(), MutableSegment()
        for s in (a, b):
            s.insert(Document(b"shared", ((b"t", b"x"),)))
        b.insert(Document(b"extra", ((b"t", b"x"),)))
        merged = ImmutableSegment.merge([ImmutableSegment.from_mutable(a),
                                         ImmutableSegment.from_mutable(b)])
        pos = execute(merged, iq.new_term(b"t", b"x"))
        assert len(pos) == 3  # three postings...
        ids = merged.sorted_ids_for(pos).tolist()
        assert ids == [b"extra", b"shared"]  # ...two distinct sorted ids


class TestTermDict:
    def test_rank_matches_python_bisect(self):
        import bisect

        rng = np.random.default_rng(42)
        for _ in range(60):
            terms = sorted({_rand_value(rng)
                            for _ in range(int(rng.integers(0, 50)))})
            td = TermDict(terms)
            queries = [_rand_value(rng) for _ in range(20)] + terms[:5]
            got = td.rank(queries)
            for q, g in zip(queries, got):
                assert int(g) == bisect.bisect_left(terms, q), (terms, q)
                i = td.find(q)
                if q in terms:
                    assert terms[i] == q
                else:
                    assert i == -1

    def test_width_cap_long_terms(self):
        """Terms beyond WIDTH_CAP tie in the matrix and resolve via the
        exact-compare fallback; the padded matrix never exceeds the cap."""
        import bisect

        cap = TermDict.WIDTH_CAP
        base = b"P" * cap
        terms = sorted({base, base + b"a", base + b"ab", base + b"\x00",
                        base + b"z" * 100, base[:-1], b"Q" * 200,
                        b"Q" * 200 + b"x", b"short", b""})
        td = TermDict(terms)
        assert td.width == cap and td.padded.shape[1] == cap
        queries = terms + [base + b"b", base + b"\x00\x00", b"Q" * 199,
                           b"Q" * 201, b"P", b"R", base + b"z" * 99]
        for q in queries:
            assert int(td.rank([q])[0]) == bisect.bisect_left(terms, q), q
            assert (td.find(q) >= 0) == (q in terms), q
            if q in terms:
                assert terms[td.find(q)] == q
        for prefix in (base, base + b"a", b"Q" * 100, b"P", b""):
            lo, hi = td.prefix_range(prefix)
            assert terms[lo:hi] == [t for t in terms
                                    if t.startswith(prefix)], prefix

    def test_prefix_range_matches_scan(self):
        rng = np.random.default_rng(43)
        for _ in range(40):
            terms = sorted({_rand_value(rng)
                            for _ in range(int(rng.integers(1, 60)))})
            td = TermDict(terms)
            for prefix in (b"", b"a", b"ab", b"\xff", b"z\xff", b"a\x00",
                           _rand_value(rng)):
                lo, hi = td.prefix_range(prefix)
                want = [t for t in terms if t.startswith(prefix)]
                assert terms[lo:hi] == want, (terms, prefix)


class TestLiteralPrefix:
    @pytest.mark.parametrize("pattern,prefix", [
        (b"abc.*", b"abc"),
        (b"abc", b"abc"),
        (b"ab?c", b"a"),
        (b"ab*", b"a"),
        (b"ab{2,3}", b"a"),
        (b"ab+", b"ab"),
        (b"a|b", b""),
        (b"abc|abd", b""),
        (b"a(b|c)", b""),  # conservative: any "|" voids the prefix
        (b"a(bc)d", b"a"),
        (b".*", b""),
        (b"", b""),
        (b"a\\d+", b"a"),
        (b"^a", b""),
        (b"a[bc]d", b"a"),
    ])
    def test_prefix_extraction(self, pattern, prefix):
        assert literal_prefix(pattern) == prefix

    def test_prefix_is_sound_on_random_patterns(self):
        """Every fullmatch-accepted string starts with the extracted
        prefix — the prune can only narrow, never lose matches."""
        rng = np.random.default_rng(44)
        values = [_rand_value(rng) for _ in range(300)] + list(VALUE_PARTS)
        for pat in PATTERNS:
            p = literal_prefix(pat)
            cre = re.compile(pat)
            for v in values:
                if cre.fullmatch(v):
                    assert v.startswith(p), (pat, p, v)


class TestPostingsCache:
    def _fresh(self, **kw):
        return PostingsListCache(scope=instrument.Scope(), **kw)

    def test_hits_return_identical_arrays(self):
        rng = np.random.default_rng(45)
        seg = ImmutableSegment.from_mutable(
            (lambda m: (m.insert_batch([_rand_doc(rng, i)
                                        for i in range(30)]), m)[1])(
                MutableSegment()))
        cache = self._fresh()
        queries = [iq.new_term(b"f0", b"a"), iq.new_regexp(b"f1", b"a.*"),
                   iq.new_regexp(b"f2", b".*")]
        cold = [execute(seg, q, cache=cache) for q in queries]
        s0 = cache.stats()
        assert s0["misses"] >= len(queries) and s0["hits"] == 0
        warm = [execute(seg, q, cache=cache) for q in queries]
        s1 = cache.stats()
        assert s1["hits"] >= len(queries)
        assert s1["misses"] == s0["misses"]
        for c, w in zip(cold, warm):
            assert np.array_equal(c, w)
        # the cached leaf array is frozen: callers cannot corrupt it
        leaf = cache.get(seg.gen, b"f0", "term", b"a")
        if leaf is not None and len(leaf):
            with pytest.raises(ValueError):
                leaf[0] = 99

    def test_mutable_segments_bypass_cache(self):
        seg = MutableSegment()
        seg.insert(Document(b"d", ((b"f0", b"a"),)))
        cache = self._fresh()
        execute(seg, iq.new_term(b"f0", b"a"), cache=cache)
        s = cache.stats()
        assert s["hits"] == 0 and s["misses"] == 0 and s["size"] == 0

    def test_lru_capacity_evicts(self):
        cache = self._fresh(capacity=4)
        for i in range(10):
            cache.put(1, b"f", "term", b"k%d" % i, np.arange(i, dtype=np.int32))
        st = cache.stats()
        assert st["size"] == 4 and st["evictions"] == 6
        assert cache.get(1, b"f", "term", b"k0") is None
        assert cache.get(1, b"f", "term", b"k9") is not None

    def test_buffer_keys_normalized_at_boundary(self):
        cache = self._fresh()
        arr = np.arange(3, dtype=np.int32)
        field = bytearray(b"fld")
        key = bytearray(b"val")
        cache.put(1, field, "term", key, arr)
        field[0] = ord(b"X")  # mutating the caller's buffer...
        key[0] = ord(b"X")
        got = cache.get(1, b"fld", "term", b"val")  # ...must not move the key
        assert got is not None and np.array_equal(got, arr)
        assert cache.get(1, memoryview(b"fld"), "term",
                         memoryview(b"val")) is not None

    def test_invalidation_on_seal_and_merge(self):
        nsi = NamespaceIndex(block_size_ns=4 * xtime.HOUR)
        nsi.insert(b"s1", {b"host": b"a"}, T0)
        nsi.insert(b"s2", {b"host": b"b"}, T0)
        q = iq.new_term(b"host", b"a")
        assert nsi.query(q) == [b"s1"]
        assert nsi.query(q) == [b"s1"]  # warm: hits the snapshot's entries
        pre = nsi.postings_cache_stats()
        assert pre["size"] > 0
        # Seal drops the snapshot segment -> its entries are purged.
        nsi.tick(T0 + 5 * xtime.HOUR, retention_ns=30 * xtime.DAY)
        st = nsi.postings_cache_stats()
        assert st["invalidations"] >= 1
        assert nsi.query(q) == [b"s1"]  # re-resolved against the sealed seg
        # A second sealed block forces a merge on the next seal; merged-away
        # segment generations are invalidated too.
        blk = next(iter(nsi.blocks.values()))
        gens_before = [s.gen for s in blk.immutable]
        nsi.insert(b"s3", {b"host": b"a"}, T0)
        nsi.query(q)
        blk.seal()
        assert all(g != blk.immutable[0].gen for g in gens_before)
        assert nsi.query(q) == [b"s1", b"s3"]

    def test_put_after_invalidation_refused(self):
        """A query racing a seal outside the index lock must not
        repopulate entries for a dropped segment generation."""
        cache = self._fresh()
        arr = np.arange(3, dtype=np.int32)
        cache.put(7, b"f", "term", b"k", arr)
        cache.invalidate_segment(7)
        got = cache.put(7, b"f", "term", b"k", arr)  # late straggler
        assert np.array_equal(got, arr)  # caller still gets its array...
        assert cache.get(7, b"f", "term", b"k") is None  # ...but no entry
        assert cache.stats()["size"] == 0

    def test_expiry_invalidates(self):
        nsi = NamespaceIndex(block_size_ns=4 * xtime.HOUR)
        nsi.insert(b"s1", {b"host": b"a"}, T0)
        nsi.tick(T0 + 5 * xtime.HOUR, retention_ns=30 * xtime.DAY)
        assert nsi.query(iq.new_term(b"host", b"a")) == [b"s1"]
        assert len(nsi.postings_cache) > 0
        nsi.tick(T0 + 40 * xtime.DAY, retention_ns=30 * xtime.DAY)
        assert len(nsi.postings_cache) == 0
        assert nsi.query(iq.new_term(b"host", b"a")) == []

    def test_cold_and_warm_namespace_results_identical(self):
        rng = np.random.default_rng(46)
        nsi = NamespaceIndex(block_size_ns=4 * xtime.HOUR)
        for i in range(200):
            nsi.insert(b"id-%04d" % i,
                       {b"f0": _rand_value(rng), b"f1": _rand_value(rng)},
                       T0)
        nsi.tick(T0 + 5 * xtime.HOUR, retention_ns=30 * xtime.DAY)
        for seed in range(40):
            q = _rand_query(np.random.default_rng(5000 + seed))
            cold = nsi.query(q)
            warm = nsi.query(q)
            assert cold == warm, f"seed={5000 + seed}"
