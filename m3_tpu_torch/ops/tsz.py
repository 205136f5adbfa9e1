"""Batched TTSZ codec in PyTorch: N series encode/decode as tensor programs.

Port of m3_tpu/ops/tsz.py (wire format v2, defined by the reference's
scalar oracle m3_tpu/ops/ref_codec.py; this module is held bit-exact
against it and against the JAX codec by tests/test_torch_codec.py).

Encode: every per-point code word ("chunk", <= 96 bits left-aligned in
three u32 words) is computed over the (series, point) grid; the only
sequential encoder state, the Gorilla leading/meaningful-bits windows,
runs as a loop over the window axis with all series in one vector. The
chunks are then concatenated at running bit cursors by the pack kernel
(ops/codec_kernels.pack_chunks).

Decode: the header parse and point scan is the decode kernel
(ops/codec_kernels.decode_points); decode_plane adds the tick scaling,
the exact int -> f64 conversion and the /10^k finish on the device.

Both kernels dispatch through the compute-fault guard (parallel/guard,
routes codec.encode and codec.decode): a fault on the card raises a typed
ComputeError; nothing falls back to the plain versions.

Representation (see ops/bits64.py): 64-bit values (timestamps, f64 bits,
int-mode mantissas) are int64; packed words are int32 tensors holding the
u32 bit pattern, [N, max_words] as in the reference. Where the reference
passes (hi, lo) u32 pairs (t0, vhi/vlo), the port passes one int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bits64 as b64
from . import codec_kernels
from ..device import resolve
from ..parallel import guard
from ..parallel import mesh as pmesh

I32 = torch.int32
I64 = torch.int64
M32 = b64.M32

# Float window policy (ref_codec.REWRITE_THRESHOLD): rewrite when the
# cheapest fitting window would waste more than this many bits over the
# point's tight (lead, trail) window.
REWRITE_THRESHOLD = 8

# v2 header worst case: 8 flag bits + t0 (64) in slot 0; delta0 (32) + v0
# (64) in slot 1.
HEADER_MAX_BITS = (8 + 64) + (32 + 64)
# Worst case per point: ts '1111111'+32 = 39 bits, float rewrite 3+6+6+64 = 79.
MAX_POINT_BITS = 39 + 79


class CursorOverflowError(ValueError):
    """A packed bit cursor exceeded the block's max_words bound: the pack
    drops words past max_words, so an undersized bound would truncate
    streams; check_cursor turns that into this typed error."""


@functools.lru_cache(maxsize=None)
def max_words_for(window: int) -> int:
    """Conservative packed-words bound for a block of `window` points."""
    bits = HEADER_MAX_BITS + max(window - 1, 0) * MAX_POINT_BITS
    return (bits + 31) // 32 + 1


def check_cursor(nbits, max_words: int) -> None:
    """Raise CursorOverflowError if any stream's bit count exceeds
    32 * max_words, naming the worst row."""
    nb = torch.as_tensor(nbits)
    if nb.numel() == 0:
        return
    worst = int(nb.max())
    if worst > 32 * int(max_words):
        row = int(nb.argmax())
        raise CursorOverflowError(
            f"packed cursor overflow: row {row} needs {worst} bits but "
            f"max_words={int(max_words)} holds {32 * int(max_words)}")


def _as(x, dtype, dev) -> torch.Tensor:
    """Tensor of `dtype` on `dev` from a tensor or an array (unsigned
    numpy arrays are reinterpreted as the signed type of their width)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.kind == "u":
            a = a.view(a.dtype.str.replace("u", "i"))
        x = torch.tensor(a)
    # transient encode/decode inputs, consumed by the kernel call that follows
    # and freed with it
    return x.to(device=dev, dtype=dtype).contiguous()  # m3lint: disable=unbudgeted-device-put


# ---------------------------------------------------------------------------
# chunk96: <= 96-bit left-aligned code words (three u32 words in int64)
# ---------------------------------------------------------------------------


def _shl96(v0, v1, v2, s):
    """Left shift a 96-bit (3 u32 words, big-endian) value by s in [0, 95]."""
    r = s & 31
    q = s >> 5
    t0 = ((v0 << r) & M32) | (v1 >> (32 - r))
    t1 = ((v1 << r) & M32) | (v2 >> (32 - r))
    t2 = (v2 << r) & M32
    o0 = torch.where(q == 0, t0, torch.where(q == 1, t1, t2))
    o1 = torch.where(q == 0, t1, torch.where(q == 1, t2, 0))
    o2 = torch.where(q == 0, t2, 0)
    return o0, o1, o2


def chunk_empty(shape, dev):
    z = torch.zeros(shape, dtype=I64, device=dev)
    return (z, z, z), z


def chunk_append(chunk, cn, value, vbits):
    """Append the low `vbits` (0..64) bits of the int64 `value`."""
    c0, c1, c2 = chunk
    vm = value & b64.low_mask(vbits)
    p0, p1, p2 = _shl96(torch.zeros_like(vm), (vm >> 32) & M32, vm & M32,
                        96 - cn - vbits)
    return (c0 | p0, c1 | p1, c2 | p2), cn + vbits


def _select(conds, vals, dev):
    """vals[j] at the first true conds[j]; vals[-1] where none holds."""
    # a scalar fill on `dev`
    out = torch.tensor(vals[-1], dtype=I64, device=dev)  # m3lint: disable=unbudgeted-device-put
    for c, v in zip(reversed(conds), reversed(vals[:-1])):
        out = torch.where(c, v, out)
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _ts_chunks(dod, valid):
    """Timestamp DoD chunks; dod int64 (int32-valued), valid bool [N, W].

    v2 buckets: '0' | '10'+4 | '110'+7 | '1110'+9 | '11110'+12 |
    '111110'+16 | '1111110'+20 | '1111111'+32 (two's complement payloads).
    """
    dev = dod.device
    conds = [dod == 0] + [(dod >= -(1 << (b - 1))) & (dod < (1 << (b - 1)))
                          for b in (4, 7, 9, 12, 16, 20)]
    ctrl = _select(conds, (0, 0b10, 0b110, 0b1110, 0b11110, 0b111110,
                           0b1111110, 0b1111111), dev)
    ctrl_len = _select(conds, (1, 2, 3, 4, 5, 6, 7, 7), dev)
    pay_len = _select(conds, (0, 4, 7, 9, 12, 16, 20, 32), dev)
    vmask = valid.to(I64)
    chunk, cn = chunk_empty(dod.shape, dev)
    chunk, cn = chunk_append(chunk, cn, ctrl, ctrl_len * vmask)
    return chunk_append(chunk, cn, dod, pay_len * vmask)


def _int_value_chunks(zz, valid):
    """Int-mode zigzag(vdod) chunks; zz int64 [N, W].

    v2 buckets: '0' | '10'+4 | '110'+7 | '1110'+12 | '11110'+20 |
    '111110'+32 | '111111'+64.
    """
    dev = zz.device
    blen = b64.bitlen64(zz)
    conds = [blen == 0] + [blen <= b for b in (4, 7, 12, 20, 32)]
    ctrl = _select(conds, (0, 0b10, 0b110, 0b1110, 0b11110, 0b111110,
                           0b111111), dev)
    ctrl_len = _select(conds, (1, 2, 3, 4, 5, 6, 6), dev)
    pay_len = _select(conds, (0, 4, 7, 12, 20, 32, 64), dev)
    vmask = valid.to(I64)
    chunk, cn = chunk_empty(zz.shape, dev)
    chunk, cn = chunk_append(chunk, cn, ctrl, ctrl_len * vmask)
    return chunk_append(chunk, cn, zz, pay_len * vmask)


def _float_window_scan(xor, valid):
    """The two-window state (A = latest rewrite, B = the one before) over
    the point axis, as a loop over columns 1..W-1 (column 0 carries the
    header). Returns per-column (use_a, use_b, rewrite, xor0, lead_used,
    mlen_used)."""
    n, w = xor.shape
    dev = xor.device
    lz = b64.clz64(xor)
    tz = b64.ctz64(xor)
    xor0 = xor == 0
    inf = 1 << 20
    use_a = torch.zeros((n, w), dtype=torch.bool, device=dev)
    use_b = torch.zeros_like(use_a)
    rewrite = torch.zeros_like(use_a)
    lead_used = torch.zeros((n, w), dtype=I64, device=dev)
    mlen_used = torch.zeros_like(lead_used)
    la = ma = lb = mb = torch.full((n,), -1, dtype=I64, device=dev)
    for i in range(1, w):
        lz_i, tz_i = lz[:, i], tz[:, i]
        tight = 64 - lz_i - tz_i
        fits_a = (la >= 0) & (lz_i >= la) & (tz_i >= 64 - la - ma)
        fits_b = (lb >= 0) & (lz_i >= lb) & (tz_i >= 64 - lb - mb)
        cost_a = torch.where(fits_a, 2 + ma, inf)
        cost_b = torch.where(fits_b, 3 + mb, inf)
        reuse_cost = torch.minimum(cost_a, cost_b)
        live = ~xor0[:, i] & valid[:, i]
        rw = live & ((reuse_cost >= inf)
                     | (reuse_cost - (2 + tight) > REWRITE_THRESHOLD))
        ua = live & ~rw & (cost_a <= cost_b)
        ub = live & ~rw & ~ua
        use_a[:, i], use_b[:, i], rewrite[:, i] = ua, ub, rw
        lead_used[:, i] = torch.where(rw, lz_i, torch.where(ua, la, lb))
        mlen_used[:, i] = torch.where(rw, tight, torch.where(ua, ma, mb))
        la, ma, lb, mb = (torch.where(rw, lz_i, la), torch.where(rw, tight, ma),
                          torch.where(rw, la, lb), torch.where(rw, ma, mb))
    return use_a, use_b, rewrite, xor0, lead_used, mlen_used


def _float_value_chunks(v, valid):
    """Float-mode XOR chunks; v raw f64 bits int64 [N, W].

    v2 ctrl: '0' zero-xor | '10' reuse A | '110' reuse B | '111' rewrite.
    """
    xor = v ^ torch.roll(v, 1, dims=1)
    use_a, use_b, rewrite, xor0, lead_u, mlen_u = _float_window_scan(xor, valid)
    vmask = valid.to(I64)
    emit0 = xor0 & valid
    ctrl = torch.where(emit0, 0, torch.where(use_a, 0b10,
                                             torch.where(use_b, 0b110, 0b111)))
    ctrl_len = torch.where(emit0, 1, torch.where(use_a, 2, 3)) * vmask
    payload = b64.shr64(xor, 64 - lead_u - mlen_u)
    rw_bits = torch.where(rewrite, 6, 0)
    chunk, cn = chunk_empty(v.shape, v.device)
    chunk, cn = chunk_append(chunk, cn, ctrl, ctrl_len)
    chunk, cn = chunk_append(chunk, cn, lead_u, rw_bits)
    chunk, cn = chunk_append(chunk, cn, mlen_u - 1, rw_bits)
    return chunk_append(chunk, cn, payload, torch.where(xor0, 0, mlen_u) * vmask)


def encode_batch(dt, t0, v, int_mode, k, npoints, ts_regular=None,
                 delta0=None, *, max_words, device=None):
    """Encode a batch of series blocks (wire format v2, see ref_codec).

    Args:
      dt: int32 [N, W] timestamp deltas, dt[:, 0] == 0.
      t0: int64 [N] first timestamps.
      v: int64 [N, W] values: raw f64 bits (float mode) or the int64
        m = rint(v * 10^k) (int mode).
      int_mode: bool [N]; k: int32 [N] decimal exponent.
      npoints: int32 [N] valid points per series.
      ts_regular: bool [N], every valid delta equals delta0 (None ->
        computed here); delta0: int32 [N] (None -> computed here).
      max_words: output row width in u32 words.
      device: None (the CUDA device) or an explicit device.

    Returns: (words int32 [N, max_words] u32 bit patterns, nbits int32 [N]).
    """
    c0, c1, c2, snb = encode_chunks(dt, t0, v, int_mode, k, npoints,
                                    ts_regular, delta0, device=device)
    # The pack kernel through the compute-fault guard (route
    # codec.encode): a fault on the card raises typed, never falls back.
    words = guard.dispatch("codec.encode", lambda: codec_kernels.pack_chunks(
        c0, c1, c2, snb, max_words))
    return words, snb.sum(dim=1, dtype=I32)


def encode_chunks(dt, t0, v, int_mode, k, npoints, ts_regular=None,
                  delta0=None, *, device=None):
    """The slot planes encode_batch packs: per series 2W slots (slot 2i =
    timestamp code of point i, slot 2i+1 = value code; point 0's slots
    carry the header), each a <= 96-bit chunk left-aligned in three u32
    words. Returns (c0, c1, c2, nbits), int32 [N, 2W] each."""
    dev = resolve(device)
    dt = _as(dt, I32, dev)
    t0 = _as(t0, I64, dev)
    v = _as(v, I64, dev)
    int_mode = _as(int_mode, torch.bool, dev)
    k = _as(k, I64, dev)
    npoints = _as(npoints, I64, dev)
    n, w = dt.shape
    cols = torch.arange(w, device=dev)[None, :]
    valid = (cols < npoints[:, None]) & (cols >= 1)
    if delta0 is None:
        d1 = dt[:, 1] if w > 1 else torch.zeros(n, dtype=I32, device=dev)
        delta0 = torch.where(npoints > 1, d1, 0)
    delta0 = _as(delta0, I64, dev)
    if ts_regular is None:
        ts_regular = torch.where(valid, dt == delta0[:, None], True).all(dim=1)
    ts_regular = _as(ts_regular, torch.bool, dev)

    # Timestamp chunks (suppressed entirely for regular series); the DoD
    # wraps in int32 as the reference's does.
    dod = (dt - torch.roll(dt, 1, dims=1)).to(I64)
    ts_chunk, ts_bits = _ts_chunks(dod, valid & ~ts_regular[:, None])

    # Int-mode value chunks: zigzag of the delta-of-delta of m.
    col0 = cols == 0
    vdelta = torch.where(col0, 0, v - torch.roll(v, 1, dims=1))
    vdelta_prev = torch.where(col0, 0, torch.roll(vdelta, 1, dims=1))
    zz = b64.zigzag64(vdelta - vdelta_prev)
    int_chunk, int_bits = _int_value_chunks(zz, valid)

    flt_chunk, flt_bits = _float_value_chunks(v, valid)

    im = int_mode[:, None]
    val_chunk = [torch.where(im, a, b) for a, b in zip(int_chunk, flt_chunk)]
    val_bits = torch.where(im, int_bits, flt_bits)

    # Header chunks in slots 0 (ts stream) and 1 (value stream) of column 0:
    # slot 0 = 8 flag bits + t0, slot 1 = [delta0] + v0 (ref_codec layout).
    t0zz = b64.zigzag64(t0)
    t0c = ((t0zz >> 32) != 0).to(I64)
    dzz = b64.zigzag64(delta0)
    dc = (ts_regular & ((dzz & M32) >= 256)).to(I64)
    m0zz = b64.zigzag64(v[:, 0])
    vc = (int_mode & ((m0zz >> 32) != 0)).to(I64)
    flags = ((int_mode.to(I64) << 7) | (k << 4) | (ts_regular.to(I64) << 3)
             | (t0c << 2) | (vc << 1) | dc)
    hdr0, hn0 = chunk_empty((n,), dev)
    hdr0, hn0 = chunk_append(hdr0, hn0, flags, torch.full_like(hn0, 8))
    hdr0, hn0 = chunk_append(hdr0, hn0, t0zz, 32 + 32 * t0c)
    hdr1, hn1 = chunk_empty((n,), dev)
    hdr1, hn1 = chunk_append(hdr1, hn1, dzz, ts_regular.to(I64) * (8 + 24 * dc))
    v0 = torch.where(int_mode, m0zz, v[:, 0])
    hdr1, hn1 = chunk_append(hdr1, hn1, v0,
                             torch.where(int_mode, 32 + 32 * vc, 64))

    # Interleave into slot planes [N, 2W]: slot 2i = ts chunk of point i,
    # slot 2i+1 = value chunk (point 0 slots carry the header).
    def interleave(a, b, ha, hb):
        a = a.clone()
        b = b.clone()
        a[:, 0] = ha
        b[:, 0] = hb
        return torch.stack([a, b], dim=2).reshape(n, 2 * w)

    c0, c1, c2 = (b64.u32_to_i32(interleave(ts_chunk[j], val_chunk[j],
                                            hdr0[j], hdr1[j]))
                  for j in range(3))
    return c0, c1, c2, interleave(ts_bits, val_bits, hn0, hn1).to(I32)


# ---------------------------------------------------------------------------
# device-side encode prep from raw inputs
# ---------------------------------------------------------------------------


def _fits_i32(x):
    return (x >= -(1 << 31)) & (x < (1 << 31))


def prepare_on_device_math(ts, v, npoints):
    """Encode prep from RAW inputs on the device: ts int64 [N, W] ticks,
    v int64 [N, W] raw f64 bits, npoints int32 [N].

    Int mode is detected by f64 BIT inspection: a value with biased
    exponent e and 52-bit mantissa is an integer with |v| < 2^53 iff it is
    +/-0, or 1023 <= e <= 1075 with the low (1075 - e) mantissa bits zero;
    its int64 value is +/-((2^52 | mantissa) >> (1075 - e)). As in the
    reference, only k=0 rows take the int path (decimal series encode as
    floats). Returns (prep dict, range_ok bool scalar tensor); range_ok
    is False when a live delta or delta-of-delta leaves int32."""
    n, w = ts.shape
    dev = ts.device
    npoints = npoints.to(I32)
    cols = torch.arange(w, device=dev)[None, :]
    valid = cols < npoints[:, None]
    prev = torch.cat([ts[:, :1], ts[:, :-1]], dim=1)
    dt64 = torch.where(valid, ts - prev, 0)
    prev_dt = torch.cat([torch.zeros_like(dt64[:, :1]), dt64[:, :-1]], dim=1)
    dod64 = dt64 - prev_dt
    range_ok = torch.where(valid, _fits_i32(dt64) & _fits_i32(dod64), True).all()
    dt = b64.u32_to_i32(dt64)

    e = (v >> 52) & 0x7FF
    neg = v < 0
    mant = v & ((1 << 52) - 1)
    is_zero = (e == 0) & (mant == 0)
    neg_zero = is_zero & neg
    frac = (1075 - e).clamp(0, 63)
    low_zero = (mant & b64.low_mask(frac)) == 0
    col_int = is_zero | ((e >= 1023) & (e <= 1075) & low_zero)
    mag = b64.shr64(mant | (1 << 52), frac)
    m = torch.where(neg, -mag, mag)
    m = torch.where(is_zero | ~valid, 0, m)
    live_int = torch.where(valid, col_int, True).all(dim=1)
    row_int = live_int & ~(neg_zero & valid).any(dim=1)
    v_out = torch.where(row_int[:, None], m, v)

    d1 = dt[:, 1] if w > 1 else torch.zeros(n, dtype=I32, device=dev)
    delta0 = d1 * (npoints > 1).to(I32)
    ts_regular = torch.where(valid & (cols >= 1), dt == delta0[:, None],
                             True).all(dim=1)
    prep = dict(dt=dt, t0=ts[:, 0].contiguous(), v=v_out, int_mode=row_int,
                k=torch.zeros(n, dtype=I32, device=dev), npoints=npoints,
                ts_regular=ts_regular, delta0=delta0)
    return prep, range_ok


# ---------------------------------------------------------------------------
# host prep (numpy): int64/f64 arrays -> encode inputs
# ---------------------------------------------------------------------------

MAX_DECIMAL_EXP = 6


def detect_int_mode_batch(values: np.ndarray, npoints: np.ndarray):
    """Per-series int-mode detection: smallest k in [0, MAX_DECIMAL_EXP]
    with round(v*10^k)/10^k == v for every live point (ref_codec
    detect_int_mode). Returns (int_mode bool [N], k int32 [N])."""
    v = np.asarray(values, dtype=np.float64)
    n, w = v.shape
    cols = np.arange(w)[None, :] < np.asarray(npoints)[:, None]
    dead = ~cols
    with np.errstate(invalid="ignore"):
        eligible = (np.isfinite(v) | dead).all(axis=1)
        # -0.0 survives only the float path, so it forces float mode.
        eligible &= ~(((v == 0.0) & np.signbit(v) & cols).any(axis=1))
    best_k = np.full(n, -1, dtype=np.int32)
    rows = np.flatnonzero(eligible)
    for k in range(0, MAX_DECIMAL_EXP + 1):
        if rows.size == 0:
            break
        vr = v[rows]
        # huge magnitudes overflow vr*scale to inf, which fails the bound
        with np.errstate(invalid="ignore", over="ignore"):
            if k == 0:
                m = np.rint(vr)
                ok = (np.abs(m) < 2.0**53) & (m == vr)
            else:
                scale = np.float64(10.0**k)
                m = np.rint(vr * scale)
                ok = (np.abs(m) < 2.0**53) & ((m / scale) == vr)
        ok = (ok | dead[rows]).all(axis=1)
        best_k[rows[ok]] = k
        rows = rows[~ok]
    return best_k >= 0, np.maximum(best_k, 0)


def prepare_encode_inputs(timestamps, values, npoints) -> dict:
    """Host prep: int64 timestamps and f64 values [N, W] -> the numpy
    encode inputs (dt, t0, v, int_mode, k, npoints, ts_regular, delta0),
    with v the raw f64 bits for float rows and the int64 mantissa for
    int rows. Raises ValueError when a live delta or delta-of-delta
    leaves int32."""
    ts = np.asarray(timestamps, dtype=np.int64)
    v = np.asarray(values, dtype=np.float64)
    npts = np.asarray(npoints, dtype=np.int32)
    n, w = ts.shape
    dt64 = np.diff(ts, axis=1, prepend=ts[:, :1])
    valid = np.arange(w)[None, :] < npts[:, None]
    dt_checked = np.where(valid, dt64, 0)
    if np.abs(dt_checked).max(initial=0) >= 2**31:
        raise ValueError("timestamp deltas must fit in int32 ticks")
    dod = np.diff(dt_checked, axis=1, prepend=np.zeros_like(ts[:, :1]))
    if np.abs(np.where(valid, dod, 0)).max(initial=0) >= 2**31:
        raise ValueError("timestamp delta-of-deltas must fit in 32-bit signed")
    dt = dt_checked.astype(np.int32)
    int_mode, k = detect_int_mode_batch(v, npts)
    bits = np.ascontiguousarray(v).view(np.int64).copy()
    rows_i = np.flatnonzero(int_mode)
    if rows_i.size:
        vi = v[rows_i]
        ki = k[rows_i]
        if ki.any():
            vi = vi * np.power(10.0, ki.astype(np.float64))[:, None]
        with np.errstate(invalid="ignore", over="ignore"):
            vi = np.where(np.isfinite(vi), vi, 0.0)
        bits[rows_i] = np.rint(vi).astype(np.int64)
    delta0 = (dt[:, 1] if w > 1 else np.zeros(n, np.int32)) * (npts > 1)
    cols1 = np.arange(w)[None, :] >= 1
    ts_regular = np.where(valid & cols1, dt == delta0[:, None], True).all(axis=1)
    return dict(dt=dt, t0=ts[:, 0].copy(), v=bits, int_mode=int_mode, k=k,
                npoints=npts, ts_regular=ts_regular,
                delta0=delta0.astype(np.int32))


# The prepared inputs in encode_batch's argument order, with the dtype
# each is staged at.
_STAGE = {"dt": I32, "t0": I64, "v": I64, "int_mode": torch.bool, "k": I32,
          "npoints": I32, "ts_regular": torch.bool, "delta0": I32}


def prepared_tensors(inp: dict, device="cpu"):
    """The prepared inputs as tensors on `device`, in encode_batch's
    argument order (the mesh routes split them from the host)."""
    return [_as(inp[key], dtype, torch.device(device))
            for key, dtype in _STAGE.items()]


@functools.lru_cache(maxsize=32)
def encode_over(mesh: pmesh.Mesh, max_words: int):
    """encode_batch as one program over `mesh`: the prepared rows split
    over every mesh axis, each entry encoding its slice with the pack
    kernel, words and nbits reassembled in row order on the mesh's first
    device. The encode is row-independent, so the words are bit-identical
    to one device's."""

    def local(dt, t0, v, int_mode, k, npoints, ts_regular, delta0):
        return encode_batch(dt, t0, v, int_mode, k, npoints, ts_regular,
                            delta0, max_words=max_words, device=dt.device)

    rows, rowc = (mesh.axis_names,), (mesh.axis_names, None)
    return pmesh.shard_map(
        local, mesh, in_specs=(rowc, rows, rowc, rows, rows, rows, rows, rows),
        out_specs=[rowc, rows])


def encode_single(inp: dict, max_words: int, *, device=None):
    """encode_batch from prepared inputs on one device."""
    return encode_batch(inp["dt"], inp["t0"], inp["v"], inp["int_mode"],
                        inp["k"], inp["npoints"], inp["ts_regular"],
                        inp["delta0"], max_words=max_words, device=device)


def encode_prepared(inp: dict, max_words: int, *, device=None):
    """encode_batch from prepared inputs (the seal path). With several
    devices attached, the rows take the seal's mesh route
    (parallel/ingest.flush_encode_prepared, with its floor, its knob and
    its guard route), else encode_single on `device`."""
    from ..parallel import ingest

    got = ingest.flush_encode_prepared(inp, max_words, device=device)
    if got is None:
        return encode_single(inp, max_words, device=device)
    if device is None:
        return got
    return tuple(t.to(resolve(device)) for t in got)


def encode(timestamps, values, npoints=None, max_words: int | None = None, *,
           device=None):
    """Encode [N, W] int64 timestamps + f64 values -> (words, nbits)."""
    ts = np.asarray(timestamps)
    if npoints is None:
        npoints = np.full(ts.shape[0], ts.shape[1], dtype=np.int32)
    if max_words is None:
        max_words = max_words_for(ts.shape[1])
    inp = prepare_encode_inputs(ts, values, npoints)
    words, nbits = encode_prepared(inp, max_words, device=device)
    if max_words < max_words_for(ts.shape[1]):
        check_cursor(nbits, max_words)
    return words, nbits


def encode_with_boundary(timestamps, values, npoints=None,
                         max_words: int | None = None, *, device=None):
    """encode() that also returns the boundary metadata dict (seal path)."""
    ts = np.asarray(timestamps)
    if npoints is None:
        npoints = np.full(ts.shape[0], ts.shape[1], dtype=np.int32)
    if max_words is None:
        max_words = max_words_for(ts.shape[1])
    inp = prepare_encode_inputs(ts, values, npoints)
    words, nbits = encode_prepared(inp, max_words, device=device)
    return words, nbits, boundary_metadata(inp)


def boundary_metadata(inp: dict) -> dict:
    """Seal-time boundary metadata from prepared encode inputs (numpy):
    what the concat merge needs to append a later block without decoding
    this one."""
    npts = np.asarray(inp["npoints"])
    rows = np.arange(npts.shape[0])
    last_col = np.maximum(npts - 1, 0)
    prev_col = np.maximum(npts - 2, 0)
    v = np.asarray(inp["v"]).astype(np.int64)
    last_bits = v[rows, last_col]
    prev_bits = v[rows, prev_col]
    int_mode = np.asarray(inp["int_mode"])
    with np.errstate(over="ignore"):
        last_vdelta = np.where(int_mode & (npts >= 2), last_bits - prev_bits, 0)
    dt = np.asarray(inp["dt"])
    t0 = np.asarray(inp["t0"]).astype(np.int64)
    last_ticks = t0 + np.cumsum(dt, axis=1)[rows, last_col]
    return {"last_ticks": last_ticks, "last_v_bits": last_bits.view(np.uint64),
            "last_vdelta_bits": last_vdelta.view(np.uint64),
            "valid": np.ones(npts.shape[0], bool)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_core(words, npoints, window: int) -> dict:
    # The decode kernel through the compute-fault guard (codec.decode).
    dt, ticks, v, flags = guard.dispatch(
        "codec.decode",
        lambda: codec_kernels.decode_points(words, npoints, window))
    return {"dt": dt, "ts": ticks, "v": v, "int_mode": (flags >> 7) == 1,
            "k": (flags >> 4) & 7, "t0": ticks[:, 0]}


def decode_batch(words, npoints, *, window: int, device=None) -> dict:
    """Decode batched TTSZ streams.

    words: u32 [N, MW] packed streams (int32 bit patterns or np.uint32);
    npoints: int32 [N]; window: points W. Returns dict with dt int32
    [N, W], v int64 [N, W] (f64 bits or int64 m per mode), int_mode bool
    [N], k int32 [N], t0 int64 [N]."""
    dev = resolve(device)
    out = _decode_core(_as(words, I32, dev), _as(npoints, I32, dev), window)
    return {key: out[key] for key in ("dt", "v", "int_mode", "k", "t0")}


_POW10 = tuple(10.0 ** i for i in range(8))


def decode_plane(words, npoints, *, window: int, unit_nanos: int = 1,
                 with_f32: bool = False, device=None):
    """Fused whole-plane decode -> (ts int64 [N, W] nanos, vals float64
    [N, W][, vals_f32 float32 [N, W]]), tensors on the device.

    After the decode kernel's point scan: ticks scale by unit_nanos
    (int64, wrapping as the reference's mul64_const), int-mode k=0 values
    convert to exact f64 bits, and rows with decimal exponent k>0 finish
    with the exact f64 division by 10^k (an exactly representable divisor
    and a correctly rounded division, as on the host in the reference).
    with_f32 adds the float32 plane by the exact bit conversion."""
    dev = resolve(device)
    out = _decode_core(_as(words, I32, dev), _as(npoints, I32, dev), window)
    ts_ns = out["ts"] * int(unit_nanos)
    k = out["k"].to(I64)
    k0 = out["int_mode"] & (k == 0)
    fix = out["int_mode"] & (k > 0)
    bits = torch.where(k0[:, None], b64.i64_to_f64_bits(out["v"]), out["v"])
    pow10 = torch.tensor(_POW10, dtype=torch.float64, device=dev)[k]
    fixed = out["v"].to(torch.float64) / pow10[:, None]
    bits = torch.where(fix[:, None], fixed.view(I64), bits)
    vals = bits.view(torch.float64)
    if with_f32:
        return ts_ns, vals, b64.f64_bits_to_f32(bits)
    return ts_ns, vals


def decode(words, npoints, window: int, *, device=None):
    """Decode streams -> (timestamps int64 [N, W] ticks, values f64)."""
    return decode_plane(words, npoints, window=window, unit_nanos=1,
                        device=device)
