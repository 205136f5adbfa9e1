"""Scalar reference implementation of the TTSZ codec (TPU-TSZ): the
port's own copy of m3_tpu/ops/ref_codec.py, plain numpy, the oracle of
the codec campaign (m3_tpu_torch/scripts/fuzz_codec.py). Nothing on the
port's serving path imports it.

TTSZ is this framework's time series compression format. It keeps the
algorithmic structure of the reference's M3TSZ codec —
delta-of-delta timestamps (reference: src/dbnode/encoding/m3tsz/encoder.go:113,
timestamp buckets src/dbnode/encoding/m3tsz/scheme.go:41-52) and Gorilla-style
XOR float encoding (encoder.go:371-391) with the M3 extension of an
integer-optimized path for decimal-scaled values
(src/dbnode/encoding/m3tsz/m3tsz.go:51,70-110 convertToIntFloat) — but the bit
layout is redesigned so a batch of N series encodes/decodes as a single
vectorized launch (see m3_tpu_torch/ops/tsz.py). It is NOT byte-compatible with
M3TSZ; it carries the same invariants (exact float64 roundtrip, ~1.45
bytes/datapoint on production-like workloads).

Wire format v2 (MSB-first bitstream, one stream per series block):

    header:
        mode   : 1 bit  (0 = float/XOR mode, 1 = int-optimized mode)
        k      : 3 bits (decimal exponent 0..6; only meaningful in int mode)
        tsreg  : 1 bit  (1 = regular timestamps: every delta equals delta0,
                         so per-point timestamp codes are omitted entirely —
                         the overwhelmingly common scrape-interval case)
        t0c    : 1 bit  (t0 payload size: 0 -> 32 bits, 1 -> 64)
        vc     : 1 bit  (int-mode v0 payload size: 0 -> 32, 1 -> 64;
                         written as 0 in float mode)
        dc     : 1 bit  (delta0 payload size: 0 -> 8, 1 -> 32; written as 0
                         when tsreg == 0)
        t0     : zigzag64(t0) in 32 or 64 bits (per t0c)
        delta0 : [only if tsreg] zigzag64(t[1]-t[0]) in 8 or 32 bits (per dc)
        v0     : float mode: raw IEEE-754 bits of value[0], 64 bits;
                 int mode: zigzag64(m0), m0 = rint(v0 * 10^k), 32/64 per vc
    per point i >= 1 (timestamp bits then value bits):
        timestamp (omitted when tsreg),
        dod = (t[i]-t[i-1]) - (t[i-1]-t[i-2]), with t[-1]=t[0]:
            dod == 0                  -> '0'
            -2^3  <= dod < 2^3        -> '10'      + 4-bit two's complement
            -2^6  <= dod < 2^6        -> '110'     + 7-bit two's complement
            -2^8  <= dod < 2^8        -> '1110'    + 9-bit two's complement
            -2^11 <= dod < 2^11       -> '11110'   + 12-bit two's complement
            -2^15 <= dod < 2^15       -> '111110'  + 16-bit two's complement
            -2^19 <= dod < 2^19       -> '1111110' + 20-bit two's complement
            otherwise                 -> '1111111' + 32-bit two's complement
        value, float mode (xor = bits(v[i]) ^ bits(v[i-1])); two windows are
        live, A = most recent rewrite, B = the one before it (real metric
        streams alternate between small-step and noise-step XOR shapes, so a
        second window sharply cuts rewrites vs classic Gorilla):
            xor == 0                 -> '0'
            reuse A                  -> '10'  + mlenA bits of xor >> trailA
            reuse B                  -> '110' + mlenB bits of xor >> trailB
            rewrite (B:=A; A:=new)   -> '111' + lead(6 bits) + (mlen-1)(6
                                        bits) + mlen bits of xor >> trail
            where lead = clz64(xor), trail = ctz64(xor),
            mlen = 64 - lead - trail; both windows start invalid (first
            non-zero xor always rewrites). Encoder policy (decode-neutral):
            rewrite when neither window fits, or when the cheapest fitting
            window wastes more than REWRITE_THRESHOLD bits vs the point's
            own tight window; otherwise reuse the cheaper window (A on tie).
            This is the TTSZ analog of the reference's significant-digit
            hysteresis (encoder.go:474-497 trackNewSig).
        value, int mode (vdod = (m[i]-m[i-1]) - (m[i-1]-m[i-2]), m[-1]=m[0];
                         zz = zigzag64(vdod)):
            zz == 0              -> '0'
            bitlen(zz) <= 4      -> '10'     + 4 bits
            bitlen(zz) <= 7      -> '110'    + 7 bits
            bitlen(zz) <= 12     -> '1110'   + 12 bits
            bitlen(zz) <= 20     -> '11110'  + 20 bits
            bitlen(zz) <= 32     -> '111110' + 32 bits
            otherwise            -> '111111' + 64 bits

The number of points is carried out-of-band in block metadata (the reference
instead writes an end-of-stream marker, scheme.go:197-242); batched device
decode wants explicit lengths. The all-ones 32-bit timestamp payload value
-2^31 is reserved as a marker sentinel (never a legal dod; see encode's
input validation) for mid-stream events.

Int-mode eligibility (mirrors the intent of convertToIntFloat): the smallest
k in 0..6 such that for every finite v, m = rint(v * 10^k) satisfies
|m| < 2^53 and float64(m) / 10^k == v exactly. NaN/Inf force float mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

U64 = 0xFFFFFFFFFFFFFFFF
MAX_DECIMAL_EXP = 6  # reference: m3tsz.go:51 maxMult = 10^6

# Timestamp DoD buckets: (prefix_bits, prefix_len, payload_bits). Finer than
# the reference's seconds-unit scheme (scheme.go:41-52 {7,9,12}+32): a 4-bit
# bucket for scrape jitter plus 16/20-bit intermediates before the 32 default.
TS_BUCKETS = (
    (0b10, 2, 4),
    (0b110, 3, 7),
    (0b1110, 4, 9),
    (0b11110, 5, 12),
    (0b111110, 6, 16),
    (0b1111110, 7, 20),
    (0b1111111, 7, 32),
)
# Int-mode value DoD buckets (zigzag payload), tuned so the small-step
# gauge/counter case (|vdod| <= 8) pays 6 bits instead of 9.
INT_BUCKETS = (
    (0b10, 2, 4),
    (0b110, 3, 7),
    (0b1110, 4, 12),
    (0b11110, 5, 20),
    (0b111110, 6, 32),
    (0b111111, 6, 64),
)
# Float window policy: rewrite when the cheapest fitting window would waste
# more than this many bits over the point's tight (lead, trail) window.
REWRITE_THRESHOLD = 8


def zigzag64(x: int) -> int:
    return ((x << 1) ^ (x >> 63)) & U64


def unzigzag64(z: int) -> int:
    x = (z >> 1) ^ (-(z & 1) & U64)
    return x - (1 << 64) if x >= (1 << 63) else x


def clz64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def ctz64(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else 64


def float_to_bits(v: float) -> int:
    return int(np.float64(v).view(np.uint64))


def bits_to_float(b: int) -> float:
    return float(np.uint64(b).view(np.float64))


def detect_int_mode(values: np.ndarray) -> tuple[bool, int]:
    """Return (int_mode, k): smallest decimal exponent giving exact roundtrip.

    Reference semantics: convertToIntFloat (m3tsz.go:70-110) tracks a decimal
    multiplier <= 10^6 per value; we resolve one exponent per block, which is
    what the batched kernel wants and what real workloads (fixed-precision
    gauges, integer counters) look like.
    """
    v = np.asarray(values, dtype=np.float64)
    if not np.isfinite(v).all():
        return False, 0
    if np.any((v == 0.0) & np.signbit(v)):
        # -0.0 would canonicalize to +0.0 through the integer path; float/XOR
        # mode round-trips the raw sign bit, so force it to keep the exact
        # float64 roundtrip invariant.
        return False, 0
    # Overflow in v*scale is an expected classification signal for huge
    # magnitudes (inf -> >= 2^53 -> not int-representable), not an error.
    with np.errstate(over="ignore"):
        for k in range(MAX_DECIMAL_EXP + 1):
            scale = np.float64(10.0**k)
            m = np.rint(v * scale)
            if np.abs(m).max(initial=0.0) >= 2.0**53:
                continue
            if np.array_equal(m / scale, v):
                return True, k
    return False, 0


class BitWriter:
    __slots__ = ("_acc", "_nbits")

    def __init__(self) -> None:
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 64
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1) if nbits < 64 else value & U64)
        self._nbits += nbits

    @property
    def nbits(self) -> int:
        return self._nbits

    def to_words(self) -> np.ndarray:
        """Pack MSB-first into big-endian uint32 words, zero-padded."""
        nwords = (self._nbits + 31) // 32
        acc = self._acc << (nwords * 32 - self._nbits)
        words = [(acc >> (32 * (nwords - 1 - i))) & 0xFFFFFFFF for i in range(nwords)]
        return np.array(words, dtype=np.uint32)


class BitReader:
    __slots__ = ("words", "pos")

    def __init__(self, words: np.ndarray, pos: int = 0) -> None:
        self.words = np.asarray(words, dtype=np.uint32)
        self.pos = pos

    def read(self, nbits: int) -> int:
        out = 0
        pos, need = self.pos, nbits
        while need > 0:
            w, b = pos >> 5, pos & 31
            take = min(32 - b, need)
            word = int(self.words[w])
            chunk = (word >> (32 - b - take)) & ((1 << take) - 1)
            out = (out << take) | chunk
            pos += take
            need -= take
        self.pos = pos
        return out

    def read_signed(self, nbits: int) -> int:
        u = self.read(nbits)
        return u - (1 << nbits) if u >= (1 << (nbits - 1)) else u


@dataclass
class EncodedBlock:
    words: np.ndarray  # uint32, MSB-first packed
    nbits: int
    npoints: int


def _write_ts_dod(w: BitWriter, dod: int) -> None:
    if not -(1 << 31) <= dod < (1 << 31):
        raise ValueError(f"timestamp delta-of-delta {dod} exceeds 32-bit signed range")
    if dod == 0:
        w.write(0, 1)
        return
    for prefix, plen, nbits in TS_BUCKETS[:-1]:
        if -(1 << (nbits - 1)) <= dod < (1 << (nbits - 1)):
            w.write(prefix, plen)
            w.write(dod, nbits)
            return
    prefix, plen, nbits = TS_BUCKETS[-1]
    w.write(prefix, plen)
    w.write(dod, nbits)


def _write_int_vdod(w: BitWriter, zz: int) -> None:
    if zz == 0:
        w.write(0, 1)
        return
    blen = zz.bit_length()
    for prefix, plen, nbits in INT_BUCKETS:
        if blen <= nbits:
            w.write(prefix, plen)
            w.write(zz, nbits)
            return
    raise AssertionError("unreachable: zigzag fits in 64 bits")


def encode(timestamps: np.ndarray, values: np.ndarray) -> EncodedBlock:
    """Encode one series window. timestamps int64 ticks, values float64."""
    ts = np.asarray(timestamps, dtype=np.int64)
    vs = np.asarray(values, dtype=np.float64)
    n = len(ts)
    assert n >= 1 and len(vs) == n
    int_mode, k = detect_int_mode(vs)

    deltas = [int(ts[i]) - int(ts[i - 1]) for i in range(1, n)]
    for d, dprev in zip(deltas, [0] + deltas):
        if not -(1 << 31) < d - dprev < (1 << 31):
            raise ValueError("timestamp delta-of-delta exceeds 32-bit signed range")
    delta0 = deltas[0] if deltas else 0
    tsreg = all(d == delta0 for d in deltas)
    zz_t0 = zigzag64(int(ts[0]))
    t0c = zz_t0 >= (1 << 32)
    zz_d = zigzag64(delta0)
    dc = tsreg and zz_d >= (1 << 8)
    if int_mode:
        m = np.rint(vs * np.float64(10.0**k)).astype(np.int64)
        zz_m0 = zigzag64(int(m[0]))
        vc = zz_m0 >= (1 << 32)
    else:
        vc = False

    w = BitWriter()
    w.write(1 if int_mode else 0, 1)
    w.write(k, 3)
    w.write(1 if tsreg else 0, 1)
    w.write(1 if t0c else 0, 1)
    w.write(1 if vc else 0, 1)
    w.write(1 if dc else 0, 1)
    w.write(zz_t0, 64 if t0c else 32)
    if tsreg:
        w.write(zz_d, 32 if dc else 8)
    if int_mode:
        w.write(zz_m0, 64 if vc else 32)
    else:
        w.write(float_to_bits(vs[0]), 64)

    prev_delta = 0
    prev_vdelta = 0
    win_a = win_b = None  # (lead, mlen) windows; A = latest rewrite
    inf = 1 << 30
    for i in range(1, n):
        if not tsreg:
            delta = deltas[i - 1]
            _write_ts_dod(w, delta - prev_delta)
            prev_delta = delta

        if int_mode:
            vdelta = int(m[i]) - int(m[i - 1])
            _write_int_vdod(w, zigzag64(vdelta - prev_vdelta))
            prev_vdelta = vdelta
        else:
            xor = float_to_bits(vs[i]) ^ float_to_bits(vs[i - 1])
            if xor == 0:
                w.write(0, 1)
            else:
                lz, tz = clz64(xor), ctz64(xor)
                tight = 64 - lz - tz
                fits_a = (win_a is not None and lz >= win_a[0]
                          and tz >= 64 - win_a[0] - win_a[1])
                fits_b = (win_b is not None and lz >= win_b[0]
                          and tz >= 64 - win_b[0] - win_b[1])
                cost_a = 2 + win_a[1] if fits_a else inf
                cost_b = 3 + win_b[1] if fits_b else inf
                reuse = min(cost_a, cost_b)
                if reuse >= inf or reuse - (2 + tight) > REWRITE_THRESHOLD:
                    w.write(0b111, 3)
                    w.write(lz, 6)
                    w.write(tight - 1, 6)
                    w.write(xor >> tz, tight)
                    win_b = win_a
                    win_a = (lz, tight)
                elif cost_a <= cost_b:
                    w.write(0b10, 2)
                    w.write(xor >> (64 - win_a[0] - win_a[1]), win_a[1])
                else:
                    w.write(0b110, 3)
                    w.write(xor >> (64 - win_b[0] - win_b[1]), win_b[1])
    return EncodedBlock(words=w.to_words(), nbits=w.nbits, npoints=n)


def decode(block: EncodedBlock) -> tuple[np.ndarray, np.ndarray]:
    """Decode an EncodedBlock back to (timestamps int64, values float64)."""
    r = BitReader(block.words)
    n = block.npoints
    int_mode = r.read(1)
    k = r.read(3)
    tsreg = r.read(1)
    t0c = r.read(1)
    vc = r.read(1)
    dc = r.read(1)
    t = unzigzag64(r.read(64 if t0c else 32))
    delta0 = unzigzag64(r.read(32 if dc else 8)) if tsreg else 0
    if int_mode:
        m0 = unzigzag64(r.read(64 if vc else 32))
    else:
        v0_bits = r.read(64)

    ts = np.empty(n, dtype=np.int64)
    ts[0] = t
    if int_mode:
        ms = np.empty(n, dtype=np.int64)
        ms[0] = m0
    else:
        vbits = np.empty(n, dtype=np.uint64)
        vbits[0] = v0_bits

    prev_delta = delta0 if tsreg else 0
    prev_vdelta = 0
    win_a = win_b = None  # (lead, mlen)
    for i in range(1, n):
        if tsreg:
            ts[i] = ts[i - 1] + delta0
        else:
            # ts: '0' | '10'+4 | '110'+7 | '1110'+9 | '11110'+12 |
            #     '111110'+16 | '1111110'+20 | '1111111'+32
            ones = 0
            while ones < 7 and r.read(1) == 1:
                ones += 1
            if ones == 0:
                dod = 0
            else:
                dod = r.read_signed(TS_BUCKETS[ones - 1][2])
            prev_delta = prev_delta + dod
            ts[i] = ts[i - 1] + prev_delta

        if int_mode:
            ones = 0
            while ones < 6 and r.read(1) == 1:
                ones += 1
            if ones == 0:
                vdod = 0
            else:
                vdod = unzigzag64(r.read(INT_BUCKETS[ones - 1][2]))
            prev_vdelta = prev_vdelta + vdod
            ms[i] = ms[i - 1] + prev_vdelta
        else:
            c = r.read(1)
            if c == 0:
                vbits[i] = vbits[i - 1]
            else:
                if r.read(1) == 0:  # '10' reuse window A
                    lead, mlen = win_a
                elif r.read(1) == 0:  # '110' reuse window B
                    lead, mlen = win_b
                else:  # '111' rewrite
                    lead = r.read(6)
                    mlen = r.read(6) + 1
                    win_b = win_a
                    win_a = (lead, mlen)
                xor = r.read(mlen) << (64 - lead - mlen)
                vbits[i] = vbits[i - 1] ^ np.uint64(xor)

    if int_mode:
        values = ms.astype(np.float64) / np.float64(10.0**k)
    else:
        values = vbits.view(np.float64).copy()
    return ts, values
