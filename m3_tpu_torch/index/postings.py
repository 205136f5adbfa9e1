"""Postings-list algebra: packed uint64 bitmap kernels + sorted-array ops
(reference: src/m3ninx/postings/roaring — roaring-bitmap union/intersect/
difference over container words; here the containers are one flat span of
uint64 words per segment, the batch-friendly dense equivalent).

A PostingsList carries BOTH forms lazily — sorted unique int32 positions
and a packed little-endian uint64 bitmap — and every operator picks the
representation by density: sparse operands stay in sorted-array land
(searchsorted membership, O(small * log(big))), dense operands drop into
bitwise word kernels (O(n_docs/64) regardless of cardinality).
Conjunctions execute smallest-cardinality-first with early exit;
negations are word-wise AND-NOT against a tail-masked complement.

The word layout is defined by the uint8 round trip (np.packbits /
np.unpackbits with bitorder="little"), so pack/unpack agree on any host
endianness; the bitwise kernels are elementwise and layout-agnostic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

EMPTY = np.zeros(0, np.int32)

# A side is "dense enough" for word kernels when its cardinality exceeds
# one doc per 16 (one set bit per quarter-word): below that, touching
# n_docs/64 words costs more than walking the sparse array itself.
DENSE_DIV = 16


def n_words(n_docs: int) -> int:
    return (n_docs + 63) // 64


def pack(positions: np.ndarray, n_docs: int) -> np.ndarray:
    """Sorted positions -> packed uint64 bitmap (length n_words(n_docs))."""
    bits = np.zeros(n_docs, np.uint8)
    if len(positions):
        bits[positions] = 1
    packed = np.packbits(bits, bitorder="little")
    out = np.zeros(n_words(n_docs) * 8, np.uint8)
    out[: packed.size] = packed
    return out.view(np.uint64)


def unpack(words: np.ndarray, n_docs: int) -> np.ndarray:
    """Packed uint64 bitmap -> sorted unique int32 positions."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little",
                         count=n_docs)
    return np.flatnonzero(bits).astype(np.int32)


def tail_mask(n_docs: int) -> np.ndarray:
    """All-ones bitmap over [0, n_docs) — the complement's AND mask, with
    the bits past n_docs in the last word held at zero."""
    m = np.full(n_words(n_docs), np.uint64(0xFFFFFFFFFFFFFFFF))
    rem = n_docs % 64
    if len(m) and rem:
        m[-1] = np.uint64((1 << rem) - 1)
    return m


class PostingsList:
    """Dual-form postings over a fixed doc space of size n_docs.

    Exactly one of (arr, bm) may be None at construction; the other form
    materializes lazily on first use. arr is always sorted unique int32."""

    __slots__ = ("n_docs", "_arr", "_bm", "_card")

    def __init__(self, n_docs: int, arr: Optional[np.ndarray] = None,
                 bm: Optional[np.ndarray] = None,
                 card: Optional[int] = None):
        self.n_docs = n_docs
        self._arr = arr
        self._bm = bm
        if card is None and arr is not None:
            card = len(arr)
        self._card = card

    # ------------------------------------------------------------- forms

    @property
    def card(self) -> int:
        if self._card is None:
            self._card = len(self.arr())
        return self._card

    def arr(self) -> np.ndarray:
        if self._arr is None:
            self._arr = unpack(self._bm, self.n_docs)
        return self._arr

    def bm(self) -> np.ndarray:
        if self._bm is None:
            self._bm = pack(self._arr, self.n_docs)
        return self._bm

    def has_bm(self) -> bool:
        return self._bm is not None

    def is_empty(self) -> bool:
        return self.card == 0

    def _dense(self) -> bool:
        return self._bm is not None or self.card * DENSE_DIV >= self.n_docs


def empty(n_docs: int) -> PostingsList:
    return PostingsList(n_docs, arr=EMPTY, card=0)


def full(n_docs: int) -> PostingsList:
    return PostingsList(n_docs, arr=np.arange(n_docs, dtype=np.int32),
                        bm=tail_mask(n_docs), card=n_docs)


def _sparse_in(small: np.ndarray, big: np.ndarray) -> np.ndarray:
    """Membership mask of sorted-unique `small` in sorted-unique `big`."""
    if not len(big):
        return np.zeros(len(small), bool)
    idx = np.searchsorted(big, small)
    idx[idx == len(big)] = 0
    return big[idx] == small


def intersect(a: PostingsList, b: PostingsList) -> PostingsList:
    if a.is_empty() or b.is_empty():
        return empty(a.n_docs)
    if a._dense() and b._dense():
        return PostingsList(a.n_docs, bm=a.bm() & b.bm())
    small, big = (a, b) if a.card <= b.card else (b, a)
    sa = small.arr()
    if big.has_bm():
        # Gather the small side's bits straight out of the big bitmap.
        words = big.bm()[sa >> 6]
        hit = (words >> (sa & 63).astype(np.uint64)) & np.uint64(1)
        return PostingsList(a.n_docs, arr=sa[hit.astype(bool)])
    return PostingsList(a.n_docs, arr=sa[_sparse_in(sa, big.arr())])


def intersect_many(plists: Sequence[PostingsList],
                   n_docs: int) -> PostingsList:
    """Conjunction: smallest-cardinality-first with early exit."""
    if not plists:
        return full(n_docs)
    acc = None
    for p in sorted(plists, key=lambda p: p.card):
        acc = p if acc is None else intersect(acc, p)
        if acc.is_empty():
            return empty(n_docs)
    return acc


def union_many(plists: Sequence[PostingsList], n_docs: int) -> PostingsList:
    parts = [p for p in plists if not p.is_empty()]
    if not parts:
        return empty(n_docs)
    if len(parts) == 1:
        return parts[0]
    total = sum(p.card for p in parts)
    if any(p.has_bm() for p in parts) or total * DENSE_DIV >= n_docs:
        acc = parts[0].bm().copy()
        for p in parts[1:]:
            acc |= p.bm()
        return PostingsList(n_docs, bm=acc)
    cat = np.concatenate([p.arr() for p in parts])
    return PostingsList(n_docs, arr=np.unique(cat))


def difference(a: PostingsList, b: PostingsList) -> PostingsList:
    """a AND NOT b."""
    if a.is_empty() or b.is_empty():
        return a
    if a._dense() and b._dense():
        return PostingsList(a.n_docs, bm=a.bm() & ~b.bm())
    aa = a.arr()
    if b.has_bm():
        words = b.bm()[aa >> 6]
        hit = (words >> (aa & 63).astype(np.uint64)) & np.uint64(1)
        return PostingsList(a.n_docs, arr=aa[~hit.astype(bool)])
    return PostingsList(a.n_docs, arr=aa[~_sparse_in(aa, b.arr())])


def complement(a: PostingsList) -> PostingsList:
    return PostingsList(a.n_docs, bm=~a.bm() & tail_mask(a.n_docs))
