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

import threading
from pathlib import Path
from typing import Tuple

import torch

from . import bits64 as b64

I32 = torch.int32
I64 = torch.int64
M32 = b64.M32

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "m3_tpu_torch"
SOURCES = ("binding.cpp", "pack.cu", "decode.cu", "hash.cu", "window.cu")


# The card's oracles of these kernels: the tests that hold each against its
# plain version on the card, and the chip_smoke.py phase that does so on
# every run (m3lint's unguarded-kernel-dispatch reads both).
_CARD_ORACLE = "tests/test_torch_cuda.py"
_CHIP_SMOKE_PHASE = "3. kernels against their plain versions"

_BUILD_LOCK = threading.Lock()
_MODULE = None


def build():
    """Compile (if needed) and load the kernels' extension module, once.

    The node server's handler threads launch the kernels concurrently, so
    their first use may come from several threads at once: the lock makes
    every one of them wait for the single cpp_extension.load (two loads
    racing into one build directory would corrupt it)."""
    global _MODULE
    if _MODULE is not None:
        return _MODULE
    with _BUILD_LOCK:
        if _MODULE is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _MODULE = load(
                name="m3_tpu_torch_kernels",
                sources=[str(CSRC / src) for src in SOURCES],
                extra_cflags=["-O3"],
                extra_cuda_cflags=["-O3",
                                   "-gencode=arch=compute_90a,code=sm_90a"],
                build_directory=str(BUILD_DIR))
    return _MODULE


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


def _read64(w: torch.Tensor, three: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    """The 64 bits at each row's bit cursor `pos` of the u32 words `w`
    ([N, mw], int64 in [0, 2^32)); `three` is arange(3). The three words
    under the cursor come in one gather, each index clamped to [0, mw - 1]
    on its own, as tsz._take_word clamps it."""
    idx = ((pos >> 5).unsqueeze(1) + three).clamp(0, w.shape[1] - 1)
    g = torch.gather(w, 1, idx)
    bi = pos & 31
    a = (g[:, 0] << 32) | g[:, 1]
    return (a << bi) | (g[:, 2] >> (-bi + 32))


class _Reader:
    """Bit reader over [N, mw] word rows (_read64)."""

    def __init__(self, words: torch.Tensor):
        self.words = b64.i32_to_u32(words)
        self._three = torch.arange(3, dtype=I64, device=words.device)

    def read64(self, pos):
        return _read64(self.words, self._three, pos)


def _hi32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 32) & 0xFFFFFFFF


def _leading_ones32(x: torch.Tensor) -> torch.Tensor:
    # 32 - the bit length of the complement; frexp's exponent of a value
    # below 2^32, held exactly in f64, is its bit length (0 for 0).
    _m, e = torch.frexp((~x & 0xFFFFFFFF).to(torch.float64))
    return -e.to(torch.int64) + 32


def _decode_steps(words: torch.Tensor, npoints: torch.Tensor, window: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    n = words.shape[0]
    dev = words.device
    i64 = torch.int64
    w = words.to(i64) & 0xFFFFFFFF
    three = torch.arange(3, dtype=i64, device=dev)
    ts_prefix = torch.tensor([1, 2, 3, 4, 5, 6, 7, 7], dtype=i64, device=dev)
    ts_payload = torch.tensor([0, 4, 7, 9, 12, 16, 20, 32], dtype=i64,
                              device=dev)
    ts_consumed = ts_prefix + ts_payload
    ts_sign = torch.tensor([1, 8, 64, 256, 2048, 32768, 524288, 2147483648],
                           dtype=i64, device=dev)
    int_prefix = torch.tensor([1, 2, 3, 4, 5, 6, 6], dtype=i64, device=dev)
    int_payload = torch.tensor([0, 4, 7, 12, 20, 32, 64], dtype=i64,
                               device=dev)
    int_consumed = int_prefix + int_payload
    zero = torch.zeros(n, dtype=i64, device=dev)
    npts = npoints.to(i64)

    # the header: flags, t0, the regular delta, the first value
    b0 = _hi32(_read64(w, three, zero))
    int_mode = (b0 >> 31) == 1
    ts_regular = ((b0 >> 27) & 1) == 1
    nt0 = ((b0 >> 26) & 1) * 32 + 32
    t0 = b64.unzigzag64(b64.shr64_t(_read64(w, three, zero + 8), -nt0 + 64))
    pos = nt0 + 8
    nd = torch.where(ts_regular, ((b0 >> 24) & 1) * 24 + 8, zero)
    dzz = b64.shr64_t(_read64(w, three, pos), -nd + 64)
    delta0 = torch.where(ts_regular, b64.u32_to_i32(b64.unzigzag64(dzz)).to(i64),
                         zero)
    pos = pos + nd
    nv = torch.where(int_mode, ((b0 >> 25) & 1) * 32 + 32, zero + 64)
    vraw = b64.shr64_t(_read64(w, three, pos), -nv + 64)
    v0 = torch.where(int_mode, b64.unzigzag64(vraw), vraw)
    pos = pos + nv

    dt = torch.zeros((n, window), dtype=torch.int32, device=dev)
    ts = torch.empty((n, window), dtype=i64, device=dev)
    vals = torch.empty((n, window), dtype=i64, device=dev)
    ts[:, 0] = t0
    vals[:, 0] = v0

    prev_delta = torch.where(ts_regular, delta0, zero)
    pvd = zero
    pv = v0
    tick = t0
    la = torch.full((n,), -1, dtype=i64, device=dev)
    ma = la
    lb = la
    mb = la
    # A step at or past every row's npoints changes nothing (no row is
    # active): stop there and fill the rest as those steps would have.
    stop = 1
    if n > 0:
        stop = min(window, int(npts.max()))
    for i in range(1, stop):
        # the timestamp code: delta-of-delta, sign-extended
        t64 = _read64(w, three, pos)
        ones_t = _leading_ones32(_hi32(t64)).clamp(max=7)
        nbits = ts_payload[ones_t]
        pay = _hi32(t64 << ts_prefix[ones_t]) >> (-nbits + 32)
        sign = ts_sign[ones_t]
        dod = torch.where((ones_t == 0) | ts_regular, zero, (pay ^ sign) - sign)
        delta = b64.u32_to_i32(prev_delta + dod).to(i64)
        pos1 = pos + torch.where(ts_regular, zero, ts_consumed[ones_t])

        # the value code's control bits
        cf = _hi32(_read64(w, three, pos1))
        fxor0 = (cf >> 31) == 0
        fa = (cf >> 30) == 2
        fb = (cf >> 29) == 6
        frw = ~(fxor0 | fa | fb)
        lead_n = (cf >> 23) & 63
        mlen_n = ((cf >> 17) & 63) + 1
        ones_i = _leading_ones32(cf).clamp(max=6)
        # the float field's offset, width and leading zeros for its code
        off = torch.where(fa, zero + 2, torch.where(fb, zero + 3, zero + 15))
        m = torch.where(fa, ma, torch.where(fb, mb, mlen_n))
        lz = torch.where(fa, la, torch.where(fb, lb, lead_n))
        inb = int_payload[ones_i]

        # the value field, read once at the row's own position and width
        at = pos1 + torch.where(int_mode, int_prefix[ones_i], off)
        field = b64.shr64_t(_read64(w, three, at),
                         -torch.where(int_mode, inb, m) + 64)
        xor = torch.where(fxor0, zero, b64.shl64_t(field, -lz - m + 64))
        fval = pv ^ xor
        fconsumed = torch.where(fxor0, zero + 1, off + m)
        vdod = torch.where(ones_i == 0, zero, b64.unzigzag64(field))
        nvd = pvd + vdod
        ival = pv + nvd

        active = npts > i
        val = torch.where(int_mode, ival, fval)
        pos2 = pos1 + torch.where(int_mode, int_consumed[ones_i], fconsumed)
        pos = torch.where(active, pos2, pos)
        delta_o = torch.where(active, delta, zero)
        pv = torch.where(active, val, pv)
        prev_delta = torch.where(active, delta, prev_delta)
        pvd = torch.where(active & int_mode, nvd, pvd)
        rw = active & frw
        la_next = torch.where(rw, lead_n, la)
        ma_next = torch.where(rw, mlen_n, ma)
        lb = torch.where(rw, la, lb)
        mb = torch.where(rw, ma, mb)
        la = la_next
        ma = ma_next
        tick = tick + delta_o
        dt[:, i] = delta_o.to(torch.int32)
        ts[:, i] = tick
        vals[:, i] = pv
    if stop < window:
        lo = max(stop, 1)
        ts[:, lo:] = tick.unsqueeze(1).expand(n, window - lo)
        vals[:, lo:] = pv.unsqueeze(1).expand(n, window - lo)
    return dt, ts, vals, b64.u32_to_i32(b0 >> 24)


_DECODE_SCRIPT = None
_DECODE_SCRIPT_LOCK = threading.Lock()


def decode_points_plain(words, npoints, window: int):
    """The _decode_header/_decode_step twin: a loop over the points of
    vectorized torch ops (all series in lockstep). Returns (dt int32
    [N, W], ticks int64 [N, W], value bits int64 [N, W], flags int32 [N]).

    Each step reads three 64-bit windows: the timestamp code, the value
    code's control bits, and the value field. The field is read once for
    every row at the position and width its own mode picks (the int
    payload, or the XOR field of a reuse-A, reuse-B or rewrite code), and
    the code lengths come from tables indexed by the leading-ones count.

    The loop is compiled once by TorchScript and runs as one call. Run
    from Python, every torch op releases and retakes the interpreter lock:
    beside a node's server threads on a busy host, those handoffs made a
    plain decode take many times its own CPU time, and a read's latency
    with it (the CPU drills' read p99 passed their 2 s bound)."""
    global _DECODE_SCRIPT
    if _DECODE_SCRIPT is None:
        with _DECODE_SCRIPT_LOCK:
            if _DECODE_SCRIPT is None:
                _DECODE_SCRIPT = torch.jit.script(_decode_steps)
    return _DECODE_SCRIPT(words, npoints, int(window))


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
