"""Vectorized adler32 (reference: src/dbnode/digest — adler32 is the
digest convention of the whole persistence layer: per-chunk commitlog
checksums, per-row fileset index entries, per-file digest chains).

`adler32_rows` computes the checksum of EVERY row of a byte matrix in
one pass of numpy reductions instead of a Python loop of
zlib.adler32 calls — the unit recovery verification and repair
metadata pay per block, per fileset, per sweep. Bit-identical to
zlib.adler32 row-by-row (tests/test_durability.py property-checks it).

adler32 of a buffer d[0..n) from the (A0=1, B0=0) seed:

  A = (1 + sum(d))            mod 65521
  B = (n + sum((n - i) d_i))  mod 65521
  adler = (B << 16) | A

Width-adaptive: NARROW rows (the per-series stream matrices this
repo checksums — where a Python loop of zlib calls pays call overhead
per row, not bandwidth) run as ONE float64 gemv; every term
(n - i) * d_i <= 255n is exactly representable and all terms are
non-negative, so the accumulated sum is exact below 2^53. WIDE rows
take one zlib C call per row — zlib streams >1 GB/s, while the gemv
pays an 8x u8->f64 conversion in memory traffic, so past a width
threshold the C loop is strictly faster AND exact at any width. Both
paths are bit-identical to `zlib.adler32(row.tobytes())`
(tests/test_durability.py property-checks across the threshold)."""

from __future__ import annotations

import zlib

import numpy as np

_MOD = 65521
# Crossover measured on this host: the gemv wins below ~128 bytes/row
# (call overhead dominates the zlib loop), loses past it (conversion
# traffic dominates the gemv). Far below the f64-exactness bound of
# ~8.4e6 bytes (255 * n^2 / 2 < 2^53).
_GEMV_MAX_ROW_BYTES = 128


def adler32_rows(rows: np.ndarray) -> np.ndarray:
    """adler32 of every row of a [S, N] byte matrix -> int64 [S].

    Accepts any row-contiguous dtype (u32 codeword rows included);
    rows are checksummed over their little-endian byte representation,
    matching `zlib.adler32(row.tobytes())` on a C-contiguous row."""
    mat = np.ascontiguousarray(rows)
    if mat.ndim != 2:
        raise ValueError(f"adler32_rows wants [S, N], got shape {mat.shape}")
    u8 = mat.view(np.uint8).reshape(mat.shape[0], -1)
    n = u8.shape[1]
    if n > _GEMV_MAX_ROW_BYTES:
        return np.fromiter((zlib.adler32(r.tobytes()) for r in u8),
                           np.int64, count=len(u8))
    d = u8.astype(np.float64)
    a = (1 + d.sum(axis=1).astype(np.int64)) % _MOD
    weights = np.arange(n, 0, -1, dtype=np.float64)
    b = (n + (d @ weights).astype(np.int64)) % _MOD
    return (b << 16) | a
