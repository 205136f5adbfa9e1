"""Index segments (reference: src/m3ninx/index/segment).

MutableSegment mirrors segment/mem (hash-map terms dict -> postings); the
ImmutableSegment is the TPU-idiomatic stand-in for the FST segment
(segment/fst/segment.go), array-native end to end:

  * Each field's sorted terms live as ONE concatenated uint8 buffer +
    offsets, mirrored into a zero-padded (n_terms, width) matrix; term
    lookup is vectorized binary search over the matrix (TermDict), the
    counterpart of the FST's shared-prefix byte walk.
  * Regexp evaluation extracts the pattern's literal prefix and prunes to
    the [prefix, successor) TERM RANGE first (the fst/regexp prefix-range
    idiom, regexp/regexp.go LiteralPrefix), then runs the compiled
    automaton over only the survivors.
  * Postings resolve into dual-form PostingsLists (m3_tpu/index/postings):
    sorted int32 arrays AND packed uint64 bitmaps, with union/intersect/
    difference choosing the representation by density — the roaring-
    bitmap algebra of postings/roaring. Conjunctions run smallest-
    cardinality-first with early exit.
  * Query results materialize through ONE gather over the segment's
    precomputed id array (ids_for) — no per-posting Python.

execute() is the bitmap-kernel searcher; execute_ref() keeps the original
pure set-algebra evaluator as the property-test oracle (tests/
test_index_property.py proves them result-identical)."""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import postings as pl
from .query import (
    AllQuery,
    ConjunctionQuery,
    DisjunctionQuery,
    NegationQuery,
    Query,
    RegexpQuery,
    TermQuery,
    literal_prefix,
)

EMPTY = np.zeros(0, np.int32)

# Process-unique ImmutableSegment generation ids: the postings-list
# cache keys on them, so a sealed/merged/expired segment's entries can
# never be confused with its replacement's.
_GEN_LOCK = threading.Lock()
_GEN = [0]


def _next_gen() -> int:
    with _GEN_LOCK:
        _GEN[0] += 1
        return _GEN[0]


class Document(NamedTuple):
    """m3ninx/doc Document: opaque id + (name, value) fields.

    A NamedTuple, not a frozen dataclass: documents are built once per
    new series on the write path's insert-queue drain, and NamedTuple
    construction is a single C call where the frozen dataclass pays two
    object.__setattr__ round-trips."""

    id: bytes
    fields: Tuple[Tuple[bytes, bytes], ...]


class TermDict:
    """Sorted term dictionary in array form.

    terms (sorted unique bytes) are stored as a concatenated uint8
    buffer + int64 offsets plus a zero-padded (n, width) uint8 matrix.
    Ordering over the matrix is (padded row, true length) lexicographic,
    which equals bytes ordering for ALL byte strings (a zero-padded row
    tie means one term is the other plus trailing NULs — exactly the
    case the length tiebreak resolves), so embedded/trailing NUL bytes
    are handled, unlike numpy's S dtype.

    The matrix width is capped at WIDTH_CAP so one outlier-long term
    cannot inflate the whole field's dictionary to n * max_len bytes;
    rows that tie at the cap with bytes still unread fall back to an
    exact per-lane compare (rare by construction — ties require a
    WIDTH_CAP-byte shared prefix)."""

    WIDTH_CAP = 64

    __slots__ = ("terms", "n", "buf", "offs", "lens", "width", "padded")

    def __init__(self, terms: List[bytes]):
        self.terms = terms  # sorted; kept for survivors/persist/terms()
        self.n = len(terms)
        self.lens = np.fromiter((len(t) for t in terms), np.int64, self.n)
        self.offs = np.zeros(self.n + 1, np.int64)
        np.cumsum(self.lens, out=self.offs[1:])
        joined = b"".join(terms)
        self.buf = (np.frombuffer(joined, np.uint8) if joined
                    else np.zeros(0, np.uint8))
        self.width = min(int(self.lens.max()) if self.n else 0,
                         self.WIDTH_CAP)
        padded = np.zeros((self.n, max(self.width, 1)), np.uint8)
        if self.n and self.width:
            cols = np.arange(self.width)
            clipped = np.minimum(self.lens, self.width)
            mask = cols[None, :] < clipped[:, None]
            # Row-major mask order == buffer order only for uncapped
            # terms; gather capped rows through explicit offsets instead.
            if int(clipped.sum()) == len(self.buf):
                padded[mask] = self.buf
            else:
                idx = self.offs[:-1, None] + cols[None, :]
                padded[mask] = self.buf[np.minimum(idx, len(self.buf) - 1)[mask]]
        self.padded = padded

    def _pad_queries(self, qs: Sequence[bytes]) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """Queries -> (k, width) matrix (truncated to width — ties fall to
        the true-length tiebreak) + true lengths."""
        w = max(self.width, 1)
        out = np.zeros((len(qs), w), np.uint8)
        lens = np.zeros(len(qs), np.int64)
        for i, q in enumerate(qs):
            head = q[: self.width]
            out[i, : len(head)] = np.frombuffer(head, np.uint8)
            lens[i] = len(q)
        return out, lens

    def rank(self, qs: Sequence[bytes]) -> np.ndarray:
        """Vectorized binary search: bisect_left insertion point for each
        query, all lanes advancing together — each of the log2(n) steps
        gathers one candidate row per lane and compares the whole batch
        in a handful of numpy ops."""
        k = len(qs)
        if self.n == 0 or k == 0:
            return np.zeros(k, np.int64)
        qp, qlens = self._pad_queries(qs)
        lanes = np.arange(k)
        lo = np.zeros(k, np.int64)
        hi = np.full(k, self.n, np.int64)
        for _ in range(int(self.n).bit_length()):
            active = lo < hi
            if not active.any():
                break
            # Clamp for lanes already settled at lo == hi == n: they
            # gather a dummy row and are masked out of the updates.
            mid = np.minimum((lo + hi) >> 1, self.n - 1)
            rows = self.padded[mid]                      # (k, width)
            neq = rows != qp
            any_neq = neq.any(axis=1)
            first = np.where(any_neq, neq.argmax(axis=1), 0)
            rb = rows[lanes, first]
            qb = qp[lanes, first]
            less = np.where(any_neq, rb < qb, self.lens[mid] < qlens)
            # Capped-width tie with unread bytes on either side: the
            # matrix can't decide — compare the actual terms exactly.
            amb = active & ~any_neq & ((self.lens[mid] > self.width)
                                       | (qlens > self.width))
            for j in np.flatnonzero(amb):
                less[j] = self.terms[int(mid[j])] < qs[j]
            go_right = active & less
            go_left = active & ~less
            lo = np.where(go_right, mid + 1, lo)
            hi = np.where(go_left, mid, hi)
        return lo

    def find(self, term: bytes) -> int:
        """Index of term, or -1."""
        i = int(self.rank([term])[0])
        if i < self.n and self.terms[i] == term:
            return i
        return -1

    def prefix_range(self, prefix: bytes) -> Tuple[int, int]:
        """[lo, hi) of terms starting with prefix (whole dict for b'')."""
        if not prefix:
            return 0, self.n
        succ = _prefix_successor(prefix)
        if succ is None:
            return int(self.rank([prefix])[0]), self.n
        lo, hi = self.rank([prefix, succ])
        return int(lo), int(hi)


def dedup_sorted_ids(ids: np.ndarray) -> np.ndarray:
    """Adjacent dedup of a lexicographically sorted object array of doc
    ids (merged segments can hold the same id at two positions)."""
    if len(ids) > 1:
        keep = np.empty(len(ids), bool)
        keep[0] = True
        np.not_equal(ids[1:], ids[:-1], out=keep[1:])
        if not keep.all():
            ids = ids[keep]
    return ids


def _prefix_successor(prefix: bytes) -> Optional[bytes]:
    """Smallest bytes greater than every string with this prefix, or None
    when the prefix is all 0xFF (range extends to the end)."""
    b = bytearray(prefix)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None


class MutableSegment:
    """segment/mem: docs + id map on the write path; the terms dict
    (field -> value -> postings) integrates LAZILY on first read.

    Inserts are the storage write path's per-new-series cost (they run
    per insert-queue drain), so they do only the O(1) work dedup needs:
    append the doc, map its id. The field/term inversion is paid once,
    incrementally, when something actually reads terms — a query
    against the mutable segment, seal's from_mutable compaction, or
    fields()/terms() enumeration. This mirrors the reference's builder
    split (segment/builder accumulates docs; the FST is built at
    compaction, not per insert), and it is work-conserving: the
    namespace's query snapshot path already re-derives segments from
    the doc list, so no reader pays twice."""

    def __init__(self):
        self._docs: List[Document] = []
        self._ids: Dict[bytes, int] = {}
        self._terms: Dict[bytes, Dict[bytes, List[int]]] = {}
        self._terms_n = 0  # docs integrated into _terms so far

    def __len__(self) -> int:
        return len(self._docs)

    def insert(self, doc: Document) -> int:
        existing = self._ids.get(doc.id)
        if existing is not None:
            return existing
        pos = len(self._docs)
        self._docs.append(doc)
        self._ids[doc.id] = pos
        return pos

    def insert_batch(self, docs: Iterable[Document]) -> List[int]:
        """Bulk insert — the per-drain cost of the storage insert
        queue's batched index path (segment/mem's InsertBatch). The
        namespace filters already-known ids before calling, so the
        all-new case is the common one: one C-level membership probe,
        then extend + dict.update(zip(...)); duplicates fall back to a
        local-ref loop."""
        if not isinstance(docs, list):
            docs = list(docs)
        doc_list = self._docs
        ids = self._ids
        base = len(doc_list)
        new_ids = [d.id for d in docs]
        if not any(map(ids.__contains__, new_ids)) and \
                len(dict.fromkeys(new_ids)) == len(new_ids):
            doc_list.extend(docs)
            positions = range(base, base + len(docs))
            ids.update(zip(new_ids, positions))
            return list(positions)
        out: List[int] = []
        append_doc = doc_list.append
        append_out = out.append
        for d in docs:
            pos = ids.get(d.id)
            if pos is None:
                pos = len(doc_list)
                append_doc(d)
                ids[d.id] = pos
            append_out(pos)
        return out

    def _ensure_terms(self) -> Dict[bytes, Dict[bytes, List[int]]]:
        """Integrate not-yet-inverted docs into the terms dict. Postings
        lists stay sorted unique: positions only grow, and a doc
        repeating a (name, value) pair is caught by the tail check."""
        terms = self._terms
        docs = self._docs
        n = len(docs)
        if self._terms_n == n:
            return terms
        for pos in range(self._terms_n, n):
            for name, value in docs[pos].fields:
                fmap = terms.get(name)
                if fmap is None:
                    fmap = terms[name] = {}
                plist = fmap.get(value)
                if plist is None:
                    fmap[value] = [pos]
                elif plist[-1] != pos:
                    plist.append(pos)
        self._terms_n = n
        return terms

    def doc(self, pos: int) -> Document:
        return self._docs[pos]

    def ids_for(self, positions: np.ndarray) -> List[bytes]:
        return [self._docs[int(p)].id for p in positions]

    def all_postings(self) -> np.ndarray:
        return np.arange(len(self._docs), dtype=np.int32)

    def term_postings(self, field: bytes, value: bytes) -> np.ndarray:
        vals = self._ensure_terms().get(field)
        if not vals or value not in vals:
            return EMPTY
        return np.asarray(vals[value], np.int32)

    def regexp_postings(self, field: bytes, pattern) -> np.ndarray:
        vals = self._ensure_terms().get(field)
        if not vals:
            return EMPTY
        out = [np.asarray(p, np.int32) for v, p in vals.items() if pattern.fullmatch(v)]
        if not out:
            return EMPTY
        return np.unique(np.concatenate(out))

    def fields(self) -> List[bytes]:
        return sorted(self._ensure_terms())

    def terms(self, field: bytes) -> List[bytes]:
        return sorted(self._ensure_terms().get(field, ()))


class ImmutableSegment:
    """FST-segment equivalent: TermDicts + offset-indexed postings spans."""

    def __init__(self, docs: Sequence[Document],
                 fields: Dict[bytes, Tuple[List[bytes], List[np.ndarray]]]):
        self._docs = list(docs)
        # field -> (TermDict, postings offsets, concatenated postings)
        self._fields: Dict[bytes, Tuple[TermDict, np.ndarray, np.ndarray]] = {}
        for name, (terms, plists) in fields.items():
            lens = np.fromiter((len(p) for p in plists), np.int64, len(plists))
            offs = np.concatenate([[0], np.cumsum(lens)])
            cat = np.concatenate(plists) if plists else EMPTY
            self._fields[name] = (TermDict(terms), offs, cat.astype(np.int32))
        self._finish_init()

    def _finish_init(self):
        self.gen = _next_gen()
        self._field_names = sorted(self._fields)
        # One object-array gather materializes any result set; dtype
        # object keeps the ids as the exact bytes the caller inserted.
        self._id_arr = np.empty(len(self._docs), object)
        for i, d in enumerate(self._docs):
            self._id_arr[i] = d.id
        # Lexicographic rank of every position, paid once per segment:
        # sorted result sets then cost one int sort + one gather instead
        # of a Python bytes sort per query (sorted_ids_for).
        self._lex_order = np.argsort(self._id_arr, kind="stable")
        self._ids_lex = self._id_arr[self._lex_order]
        self._lex_rank = np.empty(len(self._docs), np.int64)
        self._lex_rank[self._lex_order] = np.arange(len(self._docs))

    @classmethod
    def from_raw(cls, docs: Sequence[Document],
                 fields: Dict[bytes, Tuple[List[bytes], np.ndarray,
                                           np.ndarray]]) -> "ImmutableSegment":
        """Zero-split constructor from already-built (terms, offsets,
        postings) triples — the persist read path."""
        seg = cls.__new__(cls)
        seg._docs = list(docs)
        seg._fields = {
            name: (TermDict(list(terms)), np.asarray(offs, np.int64),
                   np.asarray(cat, np.int32))
            for name, (terms, offs, cat) in fields.items()
        }
        seg._finish_init()
        return seg

    def field_raw(self, name: bytes) -> Tuple[List[bytes], np.ndarray,
                                              np.ndarray]:
        """(sorted terms, offsets, concatenated postings) — persist/merge."""
        td, offs, cat = self._fields[name]
        return td.terms, offs, cat

    def __len__(self) -> int:
        return len(self._docs)

    @staticmethod
    def from_mutable(seg: MutableSegment) -> "ImmutableSegment":
        """Builder path: batch docs -> sorted fields/terms (segment/builder)."""
        fields = {}
        for name in seg.fields():
            terms = seg.terms(name)
            # Mutable postings lists are sorted unique by construction.
            plists = [np.asarray(seg._terms[name][t], np.int32) for t in terms]
            fields[name] = (terms, plists)
        return ImmutableSegment(seg._docs, fields)

    @staticmethod
    def merge(segments: Sequence["ImmutableSegment"]) -> "ImmutableSegment":
        """Compaction: merge sorted runs (index/compaction/compactor.go).

        Doc ids are offset per input segment; duplicate document IDs across
        segments are kept (the namespace dedups at write time)."""
        docs: List[Document] = []
        offsets = []
        for s in segments:
            offsets.append(len(docs))
            docs.extend(s._docs)
        fields: Dict[bytes, Dict[bytes, List[np.ndarray]]] = {}
        for s, off in zip(segments, offsets):
            for name in s._fields:
                terms, offs, cat = s.field_raw(name)
                tmap = fields.setdefault(name, {})
                for i, t in enumerate(terms):
                    tmap.setdefault(t, []).append(cat[offs[i] : offs[i + 1]] + off)
        out = {}
        for name, tmap in fields.items():
            terms = sorted(tmap)
            # Per-segment spans are sorted unique and per-segment offsets
            # are disjoint ascending, so in-order concatenation IS the
            # merged sorted-unique list — no re-sort.
            plists = [tmap[t][0] if len(tmap[t]) == 1
                      else np.concatenate(tmap[t]) for t in terms]
            out[name] = (terms, plists)
        return ImmutableSegment(docs, out)

    def doc(self, pos: int) -> Document:
        return self._docs[pos]

    def ids_for(self, positions: np.ndarray) -> List[bytes]:
        """Materialize doc ids for a result set with one gather."""
        return self._id_arr[positions].tolist()

    def sorted_ids_for(self, positions: np.ndarray) -> np.ndarray:
        """Lexicographically sorted unique ids for a result set: rank
        gather + int sort + id gather + adjacent dedup (merged segments
        may hold the same document id at two positions). Object array
        out — callers concatenate/merge without re-boxing."""
        ranks = self._lex_rank[positions]
        ranks.sort()
        return dedup_sorted_ids(self._ids_lex[ranks])

    def all_postings(self) -> np.ndarray:
        return np.arange(len(self._docs), dtype=np.int32)

    def term_postings(self, field: bytes, value: bytes) -> np.ndarray:
        entry = self._fields.get(field)
        if entry is None:
            return EMPTY
        td, offs, cat = entry
        i = td.find(value)
        if i < 0:
            return EMPTY
        return cat[offs[i] : offs[i + 1]]

    def regexp_postings(self, field: bytes, pattern,
                        prefix: Optional[bytes] = None) -> np.ndarray:
        """Automaton over the term range surviving the literal-prefix
        prune; parts concatenate via one union over span slices."""
        entry = self._fields.get(field)
        if entry is None:
            return EMPTY
        td, offs, cat = entry
        if prefix is None:
            prefix = literal_prefix(pattern.pattern)
        lo, hi = td.prefix_range(prefix)
        if lo >= hi:
            return EMPTY
        if prefix and len(prefix) == len(pattern.pattern):
            # Fully-literal pattern: the range IS the single exact term.
            if lo + 1 == hi and td.terms[lo] == prefix:
                return cat[offs[lo] : offs[lo + 1]]
        match = pattern.fullmatch
        keep = [i for i in range(lo, hi) if match(td.terms[i])]
        if not keep:
            return EMPTY
        if len(keep) == hi - lo:
            # Contiguous survivor range: spans are pos-sorted per term but
            # overlap across terms, so a sort is still required; the slice
            # avoids per-term gathers.
            return np.unique(cat[offs[lo] : offs[hi]])
        parts = [cat[offs[i] : offs[i + 1]] for i in keep]
        return np.unique(np.concatenate(parts))

    def fields(self) -> List[bytes]:
        return list(self._field_names)

    def terms(self, field: bytes) -> List[bytes]:
        entry = self._fields.get(field)
        return list(entry[0].terms) if entry else []


# ---------------------------------------------------------------------------
# searchers
# ---------------------------------------------------------------------------


def _leaf_postings(seg, field: bytes, kind: str, key: bytes,
                   resolve, cache) -> np.ndarray:
    """Resolve a term/regexp leaf through the postings-list cache when the
    segment is cacheable (ImmutableSegments carry a generation id)."""
    gen = getattr(seg, "gen", None)
    if cache is None or gen is None:
        return resolve()
    arr = cache.get(gen, field, kind, key)
    if arr is not None:
        return arr
    return cache.put(gen, field, kind, key, resolve())


def _exec(seg, query: Query, n: int, cache) -> pl.PostingsList:
    if isinstance(query, AllQuery):
        return pl.full(n)
    if isinstance(query, TermQuery):
        arr = _leaf_postings(
            seg, query.field, "term", query.value,
            lambda: seg.term_postings(query.field, query.value), cache)
        return pl.PostingsList(n, arr=arr)
    if isinstance(query, RegexpQuery):
        arr = _leaf_postings(
            seg, query.field, "regexp", query.pattern,
            lambda: seg.regexp_postings(query.field, query.compiled()), cache)
        return pl.PostingsList(n, arr=arr)
    if isinstance(query, ConjunctionQuery):
        neg = [q for q in query.queries if isinstance(q, NegationQuery)]
        pos = [q for q in query.queries if not isinstance(q, NegationQuery)]
        if pos:
            acc = pl.intersect_many(
                [_exec(seg, q, n, cache) for q in pos], n)
        else:
            acc = pl.full(n)
        for q in neg:
            if acc.is_empty():
                break
            acc = pl.difference(acc, _exec(seg, q.query, n, cache))
        return acc
    if isinstance(query, DisjunctionQuery):
        return pl.union_many(
            [_exec(seg, q, n, cache) for q in query.queries], n)
    if isinstance(query, NegationQuery):
        sub = _exec(seg, query.query, n, cache)
        if sub.is_empty():
            return pl.full(n)
        return pl.complement(sub)
    raise TypeError(f"unknown query type {type(query)}")


def execute(seg, query: Query, cache=None) -> np.ndarray:
    """Boolean searcher over one segment (m3ninx/search/executor), running
    the density-adaptive bitmap/array kernels; returns sorted unique
    int32 positions (identical to execute_ref by the property suite)."""
    return _exec(seg, query, len(seg), cache).arr()


def execute_ref(seg, query: Query) -> np.ndarray:
    """Reference set-algebra searcher — the original pure-numpy
    implementation, kept verbatim as the oracle the property suite holds
    execute() identical to."""
    if isinstance(query, AllQuery):
        return seg.all_postings()
    if isinstance(query, TermQuery):
        return seg.term_postings(query.field, query.value)
    if isinstance(query, RegexpQuery):
        return seg.regexp_postings(query.field, query.compiled())
    if isinstance(query, ConjunctionQuery):
        neg = [q for q in query.queries if isinstance(q, NegationQuery)]
        pos = [q for q in query.queries if not isinstance(q, NegationQuery)]
        if not pos:
            acc = seg.all_postings()
        else:
            acc = execute_ref(seg, pos[0])
            for q in pos[1:]:
                if not len(acc):
                    return EMPTY
                acc = np.intersect1d(acc, execute_ref(seg, q), assume_unique=False)
        for q in neg:
            acc = np.setdiff1d(acc, execute_ref(seg, q.query), assume_unique=False)
        return acc.astype(np.int32)
    if isinstance(query, DisjunctionQuery):
        parts = [execute_ref(seg, q) for q in query.queries]
        parts = [p for p in parts if len(p)]
        if not parts:
            return EMPTY
        return np.unique(np.concatenate(parts)).astype(np.int32)
    if isinstance(query, NegationQuery):
        return np.setdiff1d(seg.all_postings(), execute_ref(seg, query.query)).astype(np.int32)
    raise TypeError(f"unknown query type {type(query)}")
