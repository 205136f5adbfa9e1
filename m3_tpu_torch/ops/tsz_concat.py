"""Merge of time-adjacent TTSZ blocks by bit concatenation, without the
decode scan (port of m3_tpu/ops/tsz_concat.py).

The reference merges filesets by iterating both streams point by point and
re-encoding (src/dbnode/persist/fs merge path). For two time-adjacent
blocks from one encoding epoch (same mode/k, both timestamp-regular with
the same delta0, boundary gap == delta0: continuous scrapes cut at a block
boundary), the merged stream is instead:

    block1's bits unchanged
    ++ a re-encoded boundary point (block2's v0 as a delta code against
       block1's last value)
    ++ [int mode] a re-encoded second point (its value double-delta now
       references the boundary delta)
    ++ the REST of block2's bits verbatim, funnel-shifted to the new offset

The verbatim tail stays decodable: regular blocks carry no per-point
timestamp codes; int-mode value codes are stateless double-deltas, so only
block2's first two codes reference pre-boundary state; in float mode the
boundary point is a '111' rewrite, valid in any window state, and block2's
own codes never reuse a window they did not establish. So int-mode concat
output is BIT-IDENTICAL to encoding the full window directly; float-mode
output decodes to the same values but may spend a few more bits at the
boundary than a direct encode.

Everything is elementwise over [N] series and [N, MW] words. Words are
int32 tensors holding the u32 bit pattern, as in ops/tsz; inside, they are
carried as int64 in [0, 2^32) and shifted with the explicit 32-bit logical
shifts of ops/bits64 (`shl32`/`shr32` give 0 at a count of 32, as the
reference's do). 64-bit values (v0, last values, deltas) are int64.

`merge_adjacent` sends eligible rows through the concat and the rest
through a decode (the decode kernel) + re-encode (the pack kernel). Its
`strategy="auto"` picks the concat when the inputs are on the card and
recodes everything on the CPU, the reference's accelerator/host split;
"concat" and "recode" force a path on either device. Results come back as
tensors on the merge's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bits64 as b64
from . import tsz
from .codec_kernels import _hi32, _Reader
from ..device import resolve

I32 = torch.int32
I64 = torch.int64
M32 = b64.M32

_INT_PAYLOAD = (0, 4, 7, 12, 20, 32, 64)


def _device_of(x, device) -> torch.device:
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve(device)


def _i32(x, dev) -> torch.Tensor:
    return tsz._as(x, I32, dev)


def _i64(x, dev) -> torch.Tensor:
    return tsz._as(x, I64, dev)


# ---------------------------------------------------------------- header peek


def parse_header(words, *, device=None) -> dict:
    """Vectorized header parse: flags + t0/delta0/v0 + total header bits
    (the prefix of the decode, without the point scan). words: u32 [N, MW]
    (int32 bit patterns, or np.uint32). Returns tensors: int_mode bool,
    k int32, ts_regular bool, delta0 int32, t0 int64, v0 int64 (the
    stream-space first value), header_bits int64."""
    dev = _device_of(words, device)
    rd = _Reader(_i32(words, dev))
    n = rd.words.shape[0]
    zero = torch.zeros(n, dtype=I64, device=dev)
    b0 = _hi32(rd.read64(zero))
    int_mode = (b0 >> 31) == 1
    kexp = ((b0 >> 28) & 7).to(I32)
    ts_regular = ((b0 >> 27) & 1) == 1
    t0c = (b0 >> 26) & 1
    vc = (b0 >> 25) & 1
    dc = (b0 >> 24) & 1
    nt0 = 32 + 32 * t0c
    t0 = b64.unzigzag64(b64.shr64(rd.read64(zero + 8), 64 - nt0))
    pos = 8 + nt0
    nd = torch.where(ts_regular, 8 + 24 * dc, 0)
    dzz = b64.shr64(rd.read64(pos), 64 - nd)
    delta0 = torch.where(ts_regular, b64.u32_to_i32(b64.unzigzag64(dzz)),
                         torch.zeros((), dtype=I32, device=dev))
    pos = pos + nd
    nv = torch.where(int_mode, 32 + 32 * vc, 64)
    vraw = b64.shr64(rd.read64(pos), 64 - nv)
    v0 = torch.where(int_mode, b64.unzigzag64(vraw), vraw)
    return {"int_mode": int_mode, "k": kexp, "ts_regular": ts_regular,
            "delta0": delta0, "t0": t0, "v0": v0, "header_bits": pos + nv}


def _peek_int_code(rd: _Reader, pos):
    """(vdod int64, code bit length) of the int-mode value code at bit pos."""
    int_payload = torch.tensor(_INT_PAYLOAD, dtype=I64, device=pos.device)
    ci = _hi32(rd.read64(pos))
    ones_i = b64.clz32(~ci & M32).clamp(max=6)
    iz = ones_i == 0
    iplen = torch.where(iz, 1, torch.where(ones_i <= 4, ones_i + 1, 6))
    inb = int_payload[ones_i]
    zz = b64.shr64(rd.read64(pos + iplen), 64 - inb)
    vdod = torch.where(iz, 0, b64.unzigzag64(zz))
    return vdod, torch.where(iz, 1, iplen + inb)


# ---------------------------------------------------------------- code emit


def _int_code_chunk(vdod):
    """One int-mode value code as a (chunk96, nbits) pair (v2 buckets)."""
    zz = b64.zigzag64(vdod)
    chunk, cn = tsz._int_value_chunks(
        zz[:, None], torch.ones((zz.shape[0], 1), dtype=torch.bool,
                                device=zz.device))
    return tuple(c[:, 0] for c in chunk), cn[:, 0]


def _float_rewrite_chunk(xor):
    """One float-mode value code: '0' for zero xor, else a '111' rewrite
    (valid in any window state)."""
    n = xor.shape[0]
    lz = b64.clz64(xor)
    tz = b64.ctz64(xor)
    xor0 = xor == 0
    mlen = torch.where(xor0, 1, 64 - lz - tz)  # avoid 0-size payload math
    payload = b64.shr64(xor, tz)
    chunk, cn = tsz.chunk_empty((n,), xor.device)
    chunk, cn = tsz.chunk_append(chunk, cn, torch.where(xor0, 0, 0b111),
                                 torch.where(xor0, 1, 3))
    rw = torch.where(xor0, 0, 1)
    chunk, cn = tsz.chunk_append(chunk, cn, lz, 6 * rw)
    chunk, cn = tsz.chunk_append(chunk, cn, mlen - 1, 6 * rw)
    return tsz.chunk_append(chunk, cn, payload, mlen * rw)


# ------------------------------------------------------------- bit placement


def _range_mask(j32, start, end):
    """Per-word u32 mask keeping global bit positions [start, end)."""
    a = (start - j32).clamp(0, 32)
    b = (end - j32).clamp(0, 32)
    ones = torch.full_like(a, M32)
    return b64.shr32(ones, a) & ~b64.shr32(ones, b) & M32


def _place_at(x, s, out_width: int):
    """View each row's bitstream (u32 words in int64) shifted right by s
    bits (dynamic per row) in an out_width-word row.

    The sub-word part is one neighbour funnel; the word part is ONE
    per-row gather. The reference builds the word shift as a chain of
    log2(out_width) static pad/slice selects, because element gathers
    serialize on a TPU; on the card a gather is one pass. The chain only
    looks at the bits of the word shift below next_pow2(out_width), so the
    gather masks the shift the same way: the two are bit-identical for
    every s, negative ones included."""
    n, k = x.shape
    if k < out_width:
        x = torch.nn.functional.pad(x, (0, out_width - k))
    else:
        x = x[:, :out_width]
    r = (s & 31)[:, None]
    xprev = torch.nn.functional.pad(x, (1, 0))[:, :-1]
    y = b64.shr32(x, r) | b64.shl32(xprev, 32 - r)
    span = 1 << max(out_width - 1, 0).bit_length()
    q = ((s >> 5) & (span - 1))[:, None]
    src = torch.arange(out_width, device=x.device)[None, :] - q
    got = torch.gather(y, 1, src.clamp(0, out_width - 1))
    return torch.where(src >= 0, got, 0)


def concat_regular_batch(words1, nbits1, np1, words2, nbits2, np2,
                         last_v, last_vdelta, *, max_words: int,
                         device=None):
    """Merge time-adjacent regular blocks by bit concatenation (no scan).

    Args:
      words1/words2: u32 [N, MW*] packed streams (int32 bit patterns or
        np.uint32); nbits*/np*: int32 [N].
      last_v: [N] block1's last value in stream space (int64 m in int
        mode, raw f64 bits in float mode; np.uint64 accepted): block
        metadata recorded at seal time.
      last_vdelta: [N] m[np1-1] - m[np1-2] (int mode; 0 when np1 < 2).
        Ignored in float mode.
      max_words: output width (>= max_words_for(total window)).

    The caller checks eligibility first (concat_eligible). Returns
    (words int32 [N, max_words], nbits int32 [N]) on the merge's device."""
    dev = _device_of(words1, device)
    words1 = _i32(words1, dev)
    words2 = _i32(words2, dev)
    nbits1 = _i64(nbits1, dev)
    nbits2 = _i64(nbits2, dev)
    np2 = _i64(np2, dev)
    last_v = _i64(last_v, dev)
    last_vdelta = _i64(last_vdelta, dev)
    n = words1.shape[0]
    h2 = parse_header(words2)
    im = h2["int_mode"]
    m0_2 = h2["v0"]
    hbits2 = h2["header_bits"]

    # Boundary point: block2's v0 re-expressed as a delta code.
    step_v = m0_2 - last_v  # m0 - last_m (int); unused for float
    int_b, int_b_len = _int_code_chunk(step_v - last_vdelta)
    flt_b, flt_b_len = _float_rewrite_chunk(m0_2 ^ last_v)
    cb = [torch.where(im, a, f) for a, f in zip(int_b, flt_b)]
    cb_len = torch.where(im, int_b_len, flt_b_len)

    # Second point of block2 (int mode, np2 >= 2): its double-delta now
    # references the boundary step instead of zero.
    rd2 = _Reader(words2)
    vdod1_old, len1_old = _peek_int_code(rd2, hbits2)
    has_v1 = im & (np2 >= 2)
    c1, c1_len = _int_code_chunk(
        torch.where(has_v1, vdod1_old - step_v, 0))
    c1_len = torch.where(has_v1, c1_len, 0)
    skip2 = torch.where(has_v1, len1_old, 0)

    src_start = hbits2 + skip2
    tail_len = (nbits2 - src_start).clamp(min=0)
    o_cb = nbits1
    dst = o_cb + cb_len + c1_len
    nbits_out = dst + tail_len

    j32 = (torch.arange(max_words, dtype=I64, device=dev) * 32)[None, :]

    # Part 1: block1 verbatim (its own padding bits are zero, mask anyway).
    w1 = b64.i32_to_u32(words1)
    if w1.shape[1] < max_words:
        w1 = torch.nn.functional.pad(w1, (0, max_words - w1.shape[1]))
    w1 = w1[:, :max_words]
    out = w1 & _range_mask(j32, torch.zeros((n, 1), dtype=I64, device=dev),
                           nbits1[:, None])

    # Parts 2+3: both boundary codes packed into one 8-word mini-stream
    # (cb || c1, <= 192 bits), then shifted into place as a unit.
    mini = torch.nn.functional.pad(torch.stack(cb, dim=1), (0, 5))
    mini = mini | _place_at(torch.stack(c1, dim=1), cb_len, 8)
    out = out | (_place_at(mini, o_cb, max_words)
                 & _range_mask(j32, o_cb[:, None], dst[:, None]))

    # Part 4: block2's tail moved from src_start to dst. The shift can be
    # slightly negative (tiny block1 + wide block2 header), so bias by 8
    # words and drop them after the shift.
    shift = dst - src_start
    tail = _place_at(rd2.words, shift + 8 * 32, max_words + 8)[:, 8:]
    out = out | (tail & _range_mask(j32, dst[:, None],
                                    (dst + tail_len)[:, None]))
    return b64.u32_to_i32(out), nbits_out.to(I32)


def concat_eligible(h1, h2, np1, np2, boundary_dt):
    """Per-series eligibility for the concat: both blocks regular, one
    encoding epoch, and the boundary gap continues the cadence. h1/h2 are
    parse_header dicts; np1, np2, boundary_dt int [N]. Returns bool [N]."""
    dev = h1["int_mode"].device
    np1 = _i64(np1, dev)
    np2 = _i64(np2, dev)
    boundary_dt = _i64(boundary_dt, dev)
    d1 = h1["delta0"].to(I64)
    same_epoch = (h1["int_mode"] == h2["int_mode"]) & (h1["k"] == h2["k"])
    cadence = boundary_dt == d1
    d2_ok = (np2 < 2) | (h2["delta0"].to(I64) == d1)
    # np1 >= 2 so block1's header delta0 is the real cadence (a 1-point
    # block encodes delta0 = 0, which the merged header would inherit).
    return (h1["ts_regular"] & h2["ts_regular"] & same_epoch & cadence
            & d2_ok & (np1 >= 2) & (np2 >= 1))


def merge_adjacent(words1, nbits1, np1, words2, nbits2, np2, boundary_dt,
                   last_v, last_vdelta, *, half_window: int, max_words: int,
                   strategy: str = "auto", force_recode=None, device=None):
    """Full merge: concat for eligible series; same-epoch leftovers decode
    + re-encode in stream space; epoch-mismatched pairs decode to real
    values and re-encode with fresh mode detection.

    boundary_dt: int32 [N], t2[0] - t1[np1-1] in ticks.
    half_window: per-input-block point capacity.
    strategy: "auto" (concat on the card, recode on the CPU), "concat" or
      "recode".
    force_recode: optional bool [N], rows whose seal metadata is stale.
    device: where the merge runs (None: the inputs' device if they are
      tensors, else the CUDA card).

    Returns (words int32 [N, max_words], nbits int32 [N]) on the device."""
    if strategy not in ("auto", "concat", "recode"):
        raise ValueError(f"unknown merge strategy {strategy!r}")
    dev = _device_of(words1, device)
    args = dict(words1=_i32(words1, dev), nbits1=_i32(nbits1, dev),
                np1=_i32(np1, dev), words2=_i32(words2, dev),
                nbits2=_i32(nbits2, dev), np2=_i32(np2, dev),
                boundary_dt=_i32(boundary_dt, dev),
                last_v=_i64(last_v, dev), last_vdelta=_i64(last_vdelta, dev))
    h1 = parse_header(args["words1"])
    h2 = parse_header(args["words2"])
    ok = concat_eligible(h1, h2, args["np1"], args["np2"],
                         args["boundary_dt"])
    same_epoch = (h1["int_mode"] == h2["int_mode"]) & (h1["k"] == h2["k"])
    if force_recode is not None:
        ok = ok & ~tsz._as(force_recode, torch.bool, dev)
    if strategy == "recode" or (strategy == "auto" and dev.type != "cuda"):
        ok = torch.zeros_like(ok)
    ok = ok.cpu()
    same_epoch = same_epoch.cpu()
    parts = (torch.nonzero(ok)[:, 0],
             torch.nonzero(~ok & same_epoch)[:, 0],
             torch.nonzero(~ok & ~same_epoch)[:, 0])
    n = args["words1"].shape[0]
    out_words = torch.zeros((n, max_words), dtype=I32, device=dev)
    out_nbits = torch.zeros(n, dtype=I32, device=dev)
    for which, idx in enumerate(parts):
        if idx.numel() == 0:
            continue
        # a row-index vector for this merge's gather, freed when the merge
        # returns
        idx = idx.to(dev)  # m3lint: disable=unbudgeted-device-put
        a = {k: v[idx] for k, v in args.items()}
        if which == 0:
            w, nb = concat_regular_batch(
                a["words1"], a["nbits1"], a["np1"], a["words2"],
                a["nbits2"], a["np2"], a["last_v"], a["last_vdelta"],
                max_words=max_words)
        elif which == 1:
            w, nb = _merge_by_recode(
                a["words1"], a["np1"], a["words2"], a["np2"],
                a["boundary_dt"], half_window=half_window,
                max_words=max_words)
        else:
            w, nb = _merge_values_recode(
                a["words1"], a["np1"], a["words2"], a["np2"],
                half_window=half_window, max_words=max_words)
        out_words[idx] = w
        out_nbits[idx] = nb
    return out_words, out_nbits


def _splice_cols(a1, a2, np1, half_window: int):
    """Per-series column splice: output col j reads a1[j] for j < np1[s],
    else a2[j - np1[s]]; blocks may be partially filled, so block2's
    points land right after block1's LIVE points."""
    w = 2 * half_window
    j = torch.arange(w, device=a1.device)[None, :]
    np1 = np1.to(I64)[:, None]
    from1 = j < np1
    idx2 = (j - np1).clamp(0, half_window - 1)
    a1p = torch.nn.functional.pad(a1, (0, w - a1.shape[1]))
    return torch.where(from1, a1p, torch.gather(a2, 1, idx2))


def _merge_by_recode(words1, np1, words2, np2, boundary_dt, *,
                     half_window: int, max_words: int):
    """Same-epoch fallback: decode both halves in stream space (the decode
    kernel), splice the live columns, re-encode (the pack kernel)."""
    dev = words1.device
    d1 = tsz.decode_batch(words1, np1, window=half_window, device=dev)
    d2 = tsz.decode_batch(words2, np2, window=half_window, device=dev)
    dt2 = d2["dt"].clone()
    dt2[:, 0] = boundary_dt.to(I32)
    dt = _splice_cols(d1["dt"], dt2, np1, half_window)
    v = _splice_cols(d1["v"], d2["v"], np1, half_window)
    return tsz.encode_batch(dt, d1["t0"], v, d1["int_mode"], d1["k"],
                            np1 + np2, max_words=max_words, device=dev)


def _merge_values_recode(words1, np1, words2, np2, *, half_window: int,
                         max_words: int):
    """Epoch-mismatched fallback: decode to REAL values (stream-space bits
    are not comparable across int_mode/k epochs), splice on the host,
    re-encode with fresh int-mode detection over the merged series."""
    dev = words1.device
    t1, v1 = (x.cpu().numpy() for x in tsz.decode(words1, np1, half_window,
                                                 device=dev))
    t2, v2 = (x.cpu().numpy() for x in tsz.decode(words2, np2, half_window,
                                                 device=dev))
    np1 = np1.cpu().numpy()
    np2 = np2.cpu().numpy()
    n = t1.shape[0]
    w = 2 * half_window
    j = np.arange(w)[None, :]
    from1 = j < np1[:, None]
    idx2 = np.clip(j - np1[:, None], 0, half_window - 1)
    rows = np.arange(n)[:, None]
    ts = np.where(from1, np.pad(t1, ((0, 0), (0, w - half_window))),
                  t2[rows, idx2])
    vs = np.where(from1, np.pad(v1, ((0, 0), (0, w - half_window))),
                  v2[rows, idx2])
    return tsz.encode(ts, vs, np1 + np2, max_words=max_words, device=dev)
