"""64-bit bit manipulation for the codec, on native torch.int64.

The reference (m3_tpu/ops/bits64.py) carries every 64-bit value as a
(hi, lo) pair of uint32 lanes because TPU lanes are 32-bit. PyTorch has
native int64 on both the CPU and the GPU, so the port carries 64-bit
values as int64 holding the two's-complement bit pattern, and the pair
helpers collapse onto plain int64 operators:

  add64 / sub64 / neg64   ->  +, -, unary - (int64 wraps mod 2^64)
  i32_to_pair             ->  .to(torch.int64) (sign-extends)
  mul64_const(a, c)       ->  a * c (wraps mod 2^64)
  sar63                   ->  x >> 63 (int64 >> is arithmetic)

What remains here is what int64 operators do not give directly: LOGICAL
shifts by dynamic amounts (int64 `>>` is arithmetic, and the reference
defines every shift >= the width, or by a negative count read as u32, as
0), zigzag, bit counts, and the two exact bit conversions.

torch on the CPU has no shifts, adds or comparisons on uint32/uint64, so
unsigned 32-bit words are carried as int64 in [0, 2^32) inside
computations (shifts of such values by 0..63 are then exact logical
shifts once masked with M32), and as int32 bit patterns in stored planes.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
I64 = torch.int64
I32 = torch.int32


# ---------------------------------------------------------------------------
# u32 words
# ---------------------------------------------------------------------------


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 -> int32 with the same bit pattern
    (the reference's pair_to_i32), without relying on narrowing casts."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 in [0, 2^32)."""
    return x.to(I64) & M32


def shl32(x: torch.Tensor, s) -> torch.Tensor:
    """Logical left shift of u32 words held in int64 [0, 2^32), kept to
    32 bits; s >= 32 (or s < 0) yields 0, as the reference's _shl32 does.
    Explicit, not left to the hardware: an int32 shift by 32 is masked to
    a shift by 0 on CUDA."""
    s = torch.as_tensor(s, dtype=I64, device=x.device)
    out = (x << s.clamp(0, 31)) & M32
    return torch.where((s < 0) | (s >= 32), 0, out)


def shr32(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of u32 words held in int64 [0, 2^32); s >= 32
    (or s < 0) yields 0, as the reference's _shr32 does."""
    s = torch.as_tensor(s, dtype=I64, device=x.device)
    out = x >> s.clamp(0, 31)
    return torch.where((s < 0) | (s >= 32), 0, out)


# ---------------------------------------------------------------------------
# logical shifts (shift counts outside [0, 63] give 0, as in the reference)
# ---------------------------------------------------------------------------


def low_mask(n) -> torch.Tensor:
    """int64 mask of the low n bits, n in [0, 64] (n >= 64 -> all ones)."""
    n = torch.as_tensor(n, dtype=I64)
    return torch.where(n >= 64, -1, (1 << n.clamp(0, 63)) - 1)


def shl64(x: torch.Tensor, s) -> torch.Tensor:
    """Logical left shift; s < 0 or s >= 64 yields 0."""
    return shl64_t(x, torch.as_tensor(s, dtype=I64, device=x.device))


def shr64(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift; s < 0 or s >= 64 yields 0."""
    return shr64_t(x, torch.as_tensor(s, dtype=I64, device=x.device))


# The typed forms below (a tensor count, literal constants, tensors on the
# left of mixed arithmetic) are the ones TorchScript compiles: the plain
# decode (codec_kernels.decode_points_plain) calls them from its script.


def shl64_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    out = x << s.clamp(0, 63)
    return torch.where((s < 0) | (s >= 64), torch.zeros_like(out), out)


def shr64_t(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    sc = s.clamp(0, 63)
    # Clear the sign fill of the arithmetic shift: keep the low 64-sc bits.
    out = (x >> sc) & ~((torch.full_like(sc, -1) << (-sc + 63)) << 1)
    return torch.where((s < 0) | (s >= 64), torch.zeros_like(out), out)


def zigzag64(x: torch.Tensor) -> torch.Tensor:
    return (x << 1) ^ (x >> 63)


def unzigzag64(z: torch.Tensor) -> torch.Tensor:
    return ((z >> 1) & 0x7FFFFFFFFFFFFFFF) ^ (z & 1).neg()


# ---------------------------------------------------------------------------
# bit counts
# ---------------------------------------------------------------------------


def bitlen64(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of x read as unsigned 64-bit (int64)."""
    neg = x < 0
    v = torch.where(neg, 0, x)
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        t = v >> s
        big = t != 0
        n = n + big.to(I64) * s
        v = torch.where(big, t, v)
    n = n + (v != 0).to(I64)
    return torch.where(neg, 64, n)


def clz64(x: torch.Tensor) -> torch.Tensor:
    return 64 - bitlen64(x)


def ctz64(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of x read as unsigned 64-bit; 64 for zero."""
    iso = x & -x
    return torch.where(x == 0, 64, bitlen64(iso) - 1)


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of a u32 word held in int64 [0, 2^32)."""
    return 32 - bitlen64(x & M32)


# ---------------------------------------------------------------------------
# exact bit conversions
# ---------------------------------------------------------------------------


def i64_to_f64_bits(v: torch.Tensor) -> torch.Tensor:
    """Exact f64 bits of the int64 v, by integer math: the reference's
    i64_pair_to_f64_bits. The caller guarantees |v| < 2^53 (the int-mode
    k=0 contract), where this equals the float64 conversion; outside it
    the bit recipe is kept as the reference defines it. Zero -> +0.0."""
    neg = v < 0
    mag = torch.where(neg, -v, v)
    e = (63 - clz64(mag)).clamp(min=0)
    mant = shl64(mag, (52 - e).clamp(0, 63))
    bits = ((e + 1023) << 52) | (mant & ((1 << 52) - 1))
    bits = torch.where(neg, bits | torch.iinfo(I64).min, bits)
    return torch.where(mag != 0, bits, 0)


def f64_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Exact float64 -> float32 from raw f64 bits (int64), in integer math:
    round-to-nearest-even over normals, overflow to inf, underflow to f32
    denormals and zero with a single rounding (sticky bits), inf
    passthrough, signed zeros, and NaN -> sign | 0x7FC00000. Bit-identical
    to the reference, including the NaN canonicalisation that a plain
    .to(torch.float32) would not do."""
    sign = ((bits >> 63) & 1) << 31
    exp64 = (bits >> 52) & 0x7FF
    mant = bits & ((1 << 52) - 1)
    m23 = mant >> 29
    rest = mant & 0x1FFFFFFF
    e32 = exp64 - 1023 + 127

    # normal path
    half = 0x10000000
    round_up = (rest > half) | ((rest == half) & ((m23 & 1) == 1))
    m23r = m23 + round_up.to(I64)
    carry = m23r >> 23
    m_norm = torch.where(carry > 0, 0, m23r & 0x7FFFFF)
    e_norm = e32 + carry
    norm_bits = sign | (e_norm.clamp(0, 255) << 23) | m_norm
    norm_bits = torch.where(e_norm >= 255, sign | 0x7F800000, norm_bits)

    # underflow path: shift the 24-bit significand right by 1 - e32
    shift = (1 - e32).clamp(0, 32)
    sig24 = 0x800000 | m23
    kept = torch.where(shift >= 24, 0, sig24 >> shift)
    dropped = torch.where(shift >= 32, sig24, sig24 & ((1 << shift) - 1))
    guard_mask = torch.where(shift == 0, 0, 1 << (shift - 1).clamp(min=0))
    guard = (dropped & guard_mask) != 0
    sticky = ((dropped & ((guard_mask - 1) & M32)) != 0) | (rest != 0)
    sub_up = guard & (sticky | ((kept & 1) == 1))
    sub_bits = sign | (kept + sub_up.to(I64))

    is_inf_nan = exp64 == 0x7FF
    is_nan = is_inf_nan & (mant != 0)
    spec_bits = torch.where(is_nan, sign | 0x7FC00000, sign | 0x7F800000)
    is_zero64 = exp64 == 0
    out = torch.where(is_inf_nan, spec_bits,
                      torch.where(is_zero64, sign,
                                  torch.where(e32 <= 0, sub_bits, norm_bits)))
    return u32_to_i32(out).view(torch.float32)
