"""The codec's hand-written CUDA kernels: build, wrappers, plain versions.

Counterpart of m3_tpu/ops/pallas_codec.py. Three kernels, each in its own
source under m3_tpu_torch/csrc/:

  pack_chunks   csrc/pack.cu    replaces pallas_codec._pack_kernel
  decode_points csrc/decode.cu  replaces pallas_codec._decode_kernel
  hash_words    csrc/hash.cu    replaces pallas_codec._hash_kernel

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. On a CPU tensor it runs the plain PyTorch version beside it
(`*_plain`); on a CUDA tensor it launches the kernel on the current stream
or raises; there is no fallback. Each wrapper counts its launches in a
plain integer attribute, `wrapper.launches`.

Build: at first use, torch.utils.cpp_extension.load compiles these three
sources, the query path's csrc/window.cu (wrapped in ops/window_kernels.py)
and the binding (csrc/binding.cpp, the only file that includes PyTorch's
headers) into one extension under build/m3_tpu_torch/ at the
root of the checkout; ninja runs one compiler per source, all together,
and rebuilds what changed. u32 data crosses the boundary as int32 tensors
holding the bit pattern.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from . import bits64 as b64

I32 = torch.int32
I64 = torch.int64
M32 = b64.M32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "m3_tpu_torch"
SOURCES = ("binding.cpp", "pack.cu", "decode.cu", "hash.cu", "window.cu")


@functools.cache
def build():
    """Compile (if needed) and load the kernels' extension module."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="m3_tpu_torch_kernels",
        sources=[str(CSRC / src) for src in SOURCES],
        extra_cflags=["-O3"],
        extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
        build_directory=str(BUILD_DIR))


def _check(name: str, tensors: dict, dtype, ndim: int, device) -> None:
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor")
        if t.dtype != dtype or t.dim() != ndim:
            raise TypeError(f"{name}: {arg} must be {ndim}-D {dtype}, got "
                            f"{t.dim()}-D {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


# ---------------------------------------------------------------------------
# K1: pack
# ---------------------------------------------------------------------------


def pack_chunks_plain(c0, c1, c2, nb, max_words: int) -> torch.Tensor:
    """The _pack_scatter twin: exclusive cumsum of the bit lengths, then
    each chunk's four cursor-shifted words added into the row (words never
    overlap, so add == OR), dropping words >= max_words."""
    n = nb.shape[0]
    offs = torch.cumsum(nb.to(I64), dim=1) - nb.to(I64)
    bofs = offs & 31
    wofs = offs >> 5
    c = [b64.i32_to_u32(x) for x in (c0, c1, c2)]
    c.append(torch.zeros_like(c[0]))
    out = torch.zeros((n, max_words + 1), dtype=I64, device=nb.device)
    for j in range(4):
        prev = c[j - 1] if j > 0 else torch.zeros_like(c[0])
        # u32 words in int64: >> is logical, and a shift by 32 gives 0
        sh = (c[j] >> bofs) | ((prev << (32 - bofs)) & M32)
        idx = wofs + j
        idx = torch.where((idx >= 0) & (idx < max_words), idx, max_words)
        out.scatter_add_(1, idx, sh)
    return b64.u32_to_i32(out[:, :max_words]).contiguous()


def pack_chunks(c0, c1, c2, nb, max_words: int) -> torch.Tensor:
    """Pack S slot chunks per series into rows of max_words u32 words.

    c0, c1, c2: int32 [N, S] chunk words (u32 bit patterns, left-aligned
    <= 96-bit chunks); nb: int32 [N, S] bit lengths. Returns int32
    [N, max_words] (u32 bit patterns)."""
    dev = nb.device
    _check("pack_chunks", dict(c0=c0, c1=c1, c2=c2, nb=nb), I32, 2, dev)
    if not (c0.shape == c1.shape == c2.shape == nb.shape):
        raise ValueError("pack_chunks: chunk and length planes differ in shape")
    max_words = int(max_words)
    if max_words < 1:
        raise ValueError("pack_chunks: max_words must be >= 1")
    if dev.type == "cpu":
        return pack_chunks_plain(c0, c1, c2, nb, max_words)
    n = nb.shape[0]
    out = torch.empty((n, max_words), dtype=I32, device=dev)
    if n == 0:
        return out
    build().pack(c0, c1, c2, nb, out)
    pack_chunks.launches += 1
    return out


pack_chunks.launches = 0


# ---------------------------------------------------------------------------
# K2: decode
# ---------------------------------------------------------------------------

# payload bits by leading-ones count of the timestamp / int-value prefix
_TS_PAYLOAD = (0, 4, 7, 9, 12, 16, 20, 32)
_INT_PAYLOAD = (0, 4, 7, 12, 20, 32, 64)


class _Reader:
    """Bit reader over [N, mw] word rows: the word index is clamped to
    [0, mw - 1] per logical word, as tsz._take_word does."""

    def __init__(self, words: torch.Tensor):
        self.words = b64.i32_to_u32(words)
        self.mw = words.shape[1]

    def _word(self, wi):
        idx = wi.clamp(0, self.mw - 1)
        return torch.gather(self.words, 1, idx[:, None])[:, 0]

    def read64(self, pos):
        wi = pos >> 5
        bi = pos & 31
        a = (self._word(wi) << 32) | self._word(wi + 1)
        return (a << bi) | (self._word(wi + 2) >> (32 - bi))


def _hi32(x):
    return (x >> 32) & M32


def _leading_ones32(x):
    return b64.clz32(~x & M32)


def _sext(v, nbits):
    """Sign-extend the low nbits (1..32) of the u32 v -> int64."""
    sb = 1 << (nbits - 1)
    return (v ^ sb) - sb


def decode_points_plain(words, npoints, window: int):
    """The _decode_header/_decode_step twin: a Python loop over the points
    of vectorized torch ops (all series in lockstep). Returns (dt int32
    [N, W], ticks int64 [N, W], value bits int64 [N, W], flags int32 [N])."""
    n = words.shape[0]
    dev = words.device
    rd = _Reader(words)
    ts_payload = torch.tensor(_TS_PAYLOAD, dtype=I64, device=dev)
    int_payload = torch.tensor(_INT_PAYLOAD, dtype=I64, device=dev)
    zero = torch.zeros(n, dtype=I64, device=dev)
    npts = npoints.to(I64)

    b0 = _hi32(rd.read64(zero))
    int_mode = (b0 >> 31) == 1
    ts_regular = ((b0 >> 27) & 1) == 1
    t0c = (b0 >> 26) & 1
    vc = (b0 >> 25) & 1
    dc = (b0 >> 24) & 1
    nt0 = 32 + 32 * t0c
    t0 = b64.unzigzag64(b64.shr64(rd.read64(zero + 8), 64 - nt0))
    pos = 8 + nt0
    nd = torch.where(ts_regular, 8 + 24 * dc, 0)
    dzz = b64.shr64(rd.read64(pos), 64 - nd)
    delta0 = torch.where(ts_regular, b64.u32_to_i32(b64.unzigzag64(dzz)).to(I64), 0)
    pos = pos + nd
    nv = torch.where(int_mode, 32 + 32 * vc, 64)
    vraw = b64.shr64(rd.read64(pos), 64 - nv)
    v0 = torch.where(int_mode, b64.unzigzag64(vraw), vraw)
    pos = pos + nv

    dt = torch.zeros((n, window), dtype=I32, device=dev)
    ts = torch.empty((n, window), dtype=I64, device=dev)
    vals = torch.empty((n, window), dtype=I64, device=dev)
    ts[:, 0] = t0
    vals[:, 0] = v0

    prev_delta = torch.where(ts_regular, delta0, 0)
    pvd = zero
    pv = v0
    tick = t0
    la = ma = lb = mb = torch.full((n,), -1, dtype=I64, device=dev)
    for i in range(1, window):
        t64 = rd.read64(pos)
        ones_t = _leading_ones32(_hi32(t64)).clamp(max=7)
        is0 = ones_t == 0
        plen = torch.where(is0, 1, torch.where(ones_t <= 5, ones_t + 1, 7))
        nbits = ts_payload[ones_t]
        pw = _hi32(t64 << plen)
        pay = pw >> (32 - nbits)
        dod = torch.where(is0 | ts_regular, 0, _sext(pay, nbits.clamp(min=1)))
        delta = b64.u32_to_i32(prev_delta + dod).to(I64)
        pos1 = pos + torch.where(ts_regular, 0,
                                 torch.where(is0, 1, plen + nbits))

        cf = _hi32(rd.read64(pos1))
        fxor0 = (cf >> 31) == 0
        fa = (cf >> 30) == 2
        fb = (cf >> 29) == 6
        frw = ~fxor0 & ~fa & ~fb
        lead_n = (cf >> 23) & 63
        mlen_n = ((cf >> 17) & 63) + 1
        xa = b64.shl64(b64.shr64(rd.read64(pos1 + 2), 64 - ma), 64 - la - ma)
        xb = b64.shl64(b64.shr64(rd.read64(pos1 + 3), 64 - mb), 64 - lb - mb)
        xw = b64.shl64(b64.shr64(rd.read64(pos1 + 15), 64 - mlen_n),
                       64 - lead_n - mlen_n)
        xor = torch.where(fxor0, 0, torch.where(fa, xa, torch.where(fb, xb, xw)))
        fval = pv ^ xor
        fconsumed = torch.where(fxor0, 1, torch.where(
            fa, 2 + ma, torch.where(fb, 3 + mb, 15 + mlen_n)))
        la2 = torch.where(frw, lead_n, la)
        ma2 = torch.where(frw, mlen_n, ma)
        lb2 = torch.where(frw, la, lb)
        mb2 = torch.where(frw, ma, mb)

        ones_i = _leading_ones32(cf).clamp(max=6)
        iz = ones_i == 0
        iplen = torch.where(iz, 1, torch.where(ones_i <= 4, ones_i + 1, 6))
        inb = int_payload[ones_i]
        zz = b64.shr64(rd.read64(pos1 + iplen), 64 - inb)
        vdod = torch.where(iz, 0, b64.unzigzag64(zz))
        nvd = pvd + vdod
        ival = pv + nvd
        iconsumed = torch.where(iz, 1, iplen + inb)

        active = i < npts
        val = torch.where(int_mode, ival, fval)
        pos2 = pos1 + torch.where(int_mode, iconsumed, fconsumed)
        pos = torch.where(active, pos2, pos)
        delta_o = torch.where(active, delta, 0)
        pv = torch.where(active, val, pv)
        prev_delta = torch.where(active, delta, prev_delta)
        pvd = torch.where(active & int_mode, nvd, pvd)
        la = torch.where(active, la2, la)
        ma = torch.where(active, ma2, ma)
        lb = torch.where(active, lb2, lb)
        mb = torch.where(active, mb2, mb)
        tick = tick + delta_o
        dt[:, i] = delta_o.to(I32)
        ts[:, i] = tick
        vals[:, i] = pv
    return dt, ts, vals, b64.u32_to_i32(b0 >> 24)


def decode_points(words, npoints, window: int):
    """Decode TTSZ streams: words int32 [N, mw] (u32 bit patterns, word
    reads clamped to mw), npoints int32 [N]. Returns (dt int32 [N, W],
    ticks int64 [N, W] = t0 + running delta sum, value bits int64 [N, W],
    header flag byte int32 [N])."""
    dev = words.device
    _check("decode_points", dict(words=words), I32, 2, dev)
    _check("decode_points", dict(npoints=npoints), I32, 1, dev)
    n, mw = words.shape
    window = int(window)
    if npoints.shape[0] != n or window < 1 or mw < 1:
        raise ValueError("decode_points: need npoints [N], window >= 1, mw >= 1")
    if dev.type == "cpu":
        return decode_points_plain(words, npoints, window)
    dt = torch.empty((n, window), dtype=I32, device=dev)
    ts = torch.empty((n, window), dtype=I64, device=dev)
    vals = torch.empty((n, window), dtype=I64, device=dev)
    flags = torch.empty((n,), dtype=I32, device=dev)
    if n == 0:
        return dt, ts, vals, flags
    build().decode(words, npoints, dt, ts, vals, flags)
    decode_points.launches += 1
    return dt, ts, vals, flags


decode_points.launches = 0


# ---------------------------------------------------------------------------
# K3: hash
# ---------------------------------------------------------------------------

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def hash_words_plain(words, lens, seed: int = 0) -> torch.Tensor:
    """The hash_batch numpy-loop twin: columnwise block mix with per-row
    active masks, tail bytes from word len // 4, then fmix."""
    n, cols = words.shape
    w = b64.i32_to_u32(words)
    ln = lens.to(I64)
    nblocks = ln >> 2
    h = torch.full((n,), int(seed) & M32, dtype=I64, device=words.device)
    for j in range(cols):
        k = _rotl((w[:, j] * _C1) & M32, 15) * _C2 & M32
        h2 = (_rotl(h ^ k, 13) * 5 + 0xE6546B64) & M32
        h = torch.where(nblocks > j, h2, h)
    tl = ln & 3
    tw = torch.gather(w, 1, nblocks.clamp(0, max(cols - 1, 0))[:, None])[:, 0]
    k = torch.where(tl >= 3, ((tw >> 16) & 0xFF) << 16, 0)
    k = torch.where(tl >= 2, k ^ (((tw >> 8) & 0xFF) << 8), k)
    k = torch.where(tl >= 1, k ^ (tw & 0xFF), k)
    k = _rotl((k * _C1) & M32, 15) * _C2 & M32
    h = torch.where(tl >= 1, h ^ k, h)
    h = h ^ (ln & M32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return b64.u32_to_i32(h)


def hash_words(words, lens, seed: int = 0) -> torch.Tensor:
    """murmur3-32 over zero-padded little-endian u32 rows: words int32
    [N, C] (u32 bit patterns), lens int32 [N] byte lengths (<= 4 C).
    Returns int32 [N] (u32 bit patterns)."""
    dev = words.device
    _check("hash_words", dict(words=words), I32, 2, dev)
    _check("hash_words", dict(lens=lens), I32, 1, dev)
    n, cols = words.shape
    if lens.shape[0] != n or cols < 1:
        raise ValueError("hash_words: need lens [N] and at least one column")
    if dev.type == "cpu":
        return hash_words_plain(words, lens, seed)
    out = torch.empty((n,), dtype=I32, device=dev)
    if n == 0:
        return out
    build().hash(words, lens, out, int(seed) & M32)
    hash_words.launches += 1
    return out


hash_words.launches = 0

KERNELS = {"pack": pack_chunks, "decode": decode_points, "hash": hash_words}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
