"""The port's flush merge (m3_tpu_torch.ops.tsz_concat and
storage.block.merge_sealed_blocks) against the reference's
(m3_tpu.ops.tsz_concat, m3_tpu.storage.block) on the CPU, on the same
seeded inputs: the plain versions of the pack and decode kernels on the
port's side, the default XLA routes on the reference's.

The merge is exact integer work: words, nbits, npoints, series indices and
every boundary column (`valid` included) must be identical, so no
tolerance applies anywhere in this file. Int-mode concat output must also
equal a direct encode of the full window.

The reference's `merge_adjacent(strategy="auto")` picks the concat only on
a TPU and recodes on the host; in float mode the two strategies give
different words for the same series (both decode-equal). So each forced
strategy is held against the reference's same strategy, and the block
merges (which use "auto") compare the CPU recode with the CPU recode."""

import numpy as np
import pytest
import torch

from m3_tpu.ops import bits64 as jb64
from m3_tpu.ops import tsz as jtsz
from m3_tpu.ops import tsz_concat as jconcat
from m3_tpu.storage import block as jblock
from m3_tpu.storage import block_cache as jcache
from m3_tpu.utils.hbm import HBMBudget as JHBMBudget
from m3_tpu_torch.ops import bits64 as b64
from m3_tpu_torch.ops import tsz as ptsz
from m3_tpu_torch.ops import tsz_concat as pconcat
from m3_tpu_torch.storage import block as pblock
from m3_tpu_torch.storage import block_cache as pcache
from m3_tpu_torch.testing import hostile_block
from m3_tpu_torch.utils.hbm import HBMBudget

CPU = "cpu"
S = 10**9


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Fresh, isolated process block caches for both packages."""
    monkeypatch.setattr(pcache, "_CACHE", pcache.DeviceBlockCache(
        budget=HBMBudget(64 << 20), admit_after=2))
    monkeypatch.setattr(jcache, "_CACHE", jcache.DeviceBlockCache(
        budget=JHBMBudget(64 << 20), admit_after=2))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pair64(pair) -> np.ndarray:
    """A reference (hi, lo) u32 pair as int64."""
    return jb64.to_u64_np(*(np.asarray(a) for a in pair)).view(np.int64)


def _encode_half(ts, v, max_words, npts=None):
    if npts is None:
        npts = np.full(ts.shape[0], ts.shape[1], np.int32)
    words, nbits = jtsz.encode(ts, v, npts, max_words=max_words)
    return np.asarray(words), np.asarray(nbits), npts


def _boundary_meta(v1):
    """Block1's seal-time metadata as u64: its last value in stream space
    and its last m-delta (the reference test's helper)."""
    im, k = jtsz.detect_int_mode_batch(
        v1, np.full(v1.shape[0], v1.shape[1], np.int32))
    scale = np.power(10.0, k.astype(np.float64))[:, None]
    with np.errstate(invalid="ignore", over="ignore"):
        m = np.rint(v1 * scale).astype(np.int64)
    last_bits = np.where(im, m[:, -1].view(np.uint64),
                         v1[:, -1].view(np.uint64))
    last_delta = np.where(im & (v1.shape[1] >= 2), m[:, -1] - m[:, -2], 0)
    return last_bits, last_delta.view(np.uint64)


def _halves(ts, v, half, mw_half=None, mw_half2=None):
    """Both halves encoded by the reference, block1's metadata and the
    boundary gap: the inputs both merges see."""
    mw_half = mw_half or jtsz.max_words_for(half)
    w1, nb1, np1 = _encode_half(ts[:, :half], v[:, :half], mw_half)
    w2, nb2, np2 = _encode_half(ts[:, half:], v[:, half:],
                                mw_half2 or mw_half)
    last_v, last_vd = _boundary_meta(v[:, :half])
    boundary = (ts[:, half] - ts[:, half - 1]).astype(np.int32)
    return (w1, nb1, np1, w2, nb2, np2), boundary, last_v, last_vd


def _both_concat(args, last_v, last_vd, max_words):
    ref_w, ref_nb = jconcat.concat_regular_batch(
        *args, jb64.from_u64_np(last_v), jb64.from_u64_np(last_vd),
        max_words=max_words)
    got_w, got_nb = pconcat.concat_regular_batch(
        *args, last_v, last_vd, max_words=max_words, device=CPU)
    np.testing.assert_array_equal(_u32(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(got_nb.numpy(), np.asarray(ref_nb))
    return _u32(got_w), got_nb.numpy()


def _both_merge(args, boundary, last_v, last_vd, half, max_words,
                strategy, force_recode=None):
    w1, nb1, np1, w2, nb2, np2 = args
    ref_w, ref_nb = jconcat.merge_adjacent(
        w1, nb1, np1, w2, nb2, np2, boundary, jb64.from_u64_np(last_v),
        jb64.from_u64_np(last_vd), half_window=half, max_words=max_words,
        strategy=strategy, force_recode=force_recode)
    got_w, got_nb = pconcat.merge_adjacent(
        w1, nb1, np1, w2, nb2, np2, boundary, last_v, last_vd,
        half_window=half, max_words=max_words, strategy=strategy,
        force_recode=force_recode, device=CPU)
    np.testing.assert_array_equal(_u32(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(got_nb.numpy(), np.asarray(ref_nb))
    return _u32(got_w), got_nb.numpy()


def _regular(n, w, step=10, start=1_600_000_000):
    ts = np.int64(start) + np.arange(w, dtype=np.int64)[None, :] * step
    return np.broadcast_to(ts, (n, w)).copy()


def _mixed_series(n, w, rng, regular=True):
    ts = _regular(n, w)
    if not regular:
        ts[:, 1::2] += 3
    kind = rng.integers(0, 3, size=(n, 1))
    ints = rng.integers(0, 1000, (n, w)).astype(np.float64)
    decs = np.round(rng.random((n, w)) * 100, 2)
    flts = rng.standard_normal((n, w)) * np.pi
    return ts, np.where(kind == 0, ints, np.where(kind == 1, decs, flts))


# ---------------------------------------------------------------- header


@pytest.mark.parametrize("seed,n,w", [(0, 96, 16), (1, 64, 60), (2, 40, 120)])
def test_parse_header_matches_reference(seed, n, w):
    ts, vals, npts = hostile_block(seed, n, w)
    words, _ = jtsz.encode(ts, vals, npts, max_words=jtsz.max_words_for(w))
    words = np.asarray(words)
    ref = jconcat.parse_header(words)
    got = pconcat.parse_header(words, device=CPU)
    for key in ("int_mode", "k", "ts_regular", "delta0", "header_bits"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for key in ("t0", "v0"):
        np.testing.assert_array_equal(got[key].numpy(), _pair64(ref[key]))


# ------------------------------------------------------------- bit helpers


@pytest.mark.parametrize("out_width", [1, 8, 9, 33])
def test_place_at_and_range_mask_match_reference(out_width):
    """Shifts of exactly 32 (word-aligned offsets), their neighbours, and
    negative and oversize shifts, where the reference's select chain masks
    the word shift."""
    import jax.numpy as jnp

    rng = np.random.default_rng(out_width)
    x = rng.integers(0, 2**32, (12, 7), dtype=np.uint64).astype(np.uint32)
    s = np.array([0, 1, 31, 32, 33, 64, 96, 95, -1, -32, 32 * out_width,
                  32 * (out_width + 9) + 5], np.int32)
    ref = np.asarray(jconcat._place_at(jnp.asarray(x), jnp.asarray(s),
                                       out_width))
    got = pconcat._place_at(torch.from_numpy(x.astype(np.int64)),
                            torch.from_numpy(s.astype(np.int64)), out_width)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    j32 = np.arange(out_width, dtype=np.int32)[None, :] * 32
    starts = np.array([[0], [32], [31], [64], [5], [0]], np.int32)
    ends = np.array([[32], [64], [33], [64], [200], [0]], np.int32)
    ref = np.asarray(jconcat._range_mask(jnp.asarray(j32), jnp.asarray(starts),
                                         jnp.asarray(ends)))
    got = pconcat._range_mask(torch.from_numpy(j32.astype(np.int64)),
                              torch.from_numpy(starts.astype(np.int64)),
                              torch.from_numpy(ends.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_shifts_by_32_give_zero():
    x = torch.tensor([0xFFFFFFFF, 1, 0x80000000], dtype=torch.int64)
    for s in (32, 33, 63, 64, -1):
        assert b64.shl32(x, s).tolist() == [0, 0, 0]
        assert b64.shr32(x, s).tolist() == [0, 0, 0]
    assert b64.shl32(x, 31).tolist() == [0x80000000, 0x80000000, 0]
    assert b64.shr32(x, 31).tolist() == [1, 0, 1]


# ----------------------------------------------------------------- concat


@pytest.mark.parametrize("half", [4, 17, 32, 60])
def test_int_mode_concat_bit_exact(half):
    """Int-mode concat equals the reference's and a direct encode of the
    full window. Constant rows make block1 end on a word boundary at
    half 17 (80 header bits + 16 one-bit codes = 96) and the tail shift a
    multiple of 32 at half 32."""
    rng = np.random.default_rng(42)
    n, w = 64, 2 * half
    ts = _regular(n, w)
    v = rng.integers(-500, 500, (n, w)).astype(np.float64)
    v[: n // 4] = np.round(rng.random((n // 4, w)) * 10, 3)  # k=3 series
    v[-8:] = 7.0                                              # constants
    args, boundary, last_v, last_vd = _halves(ts, v, half)
    mw_full = jtsz.max_words_for(w)
    h1 = pconcat.parse_header(args[0], device=CPU)
    assert h1["ts_regular"].all() and h1["int_mode"].all()
    got_w, got_nb = _both_concat(args, last_v, last_vd, mw_full)
    ref_w, ref_nb = jtsz.encode(ts, v, np.full(n, w, np.int32),
                                max_words=mw_full)
    np.testing.assert_array_equal(got_nb, np.asarray(ref_nb))
    np.testing.assert_array_equal(got_w, np.asarray(ref_w))
    if half == 17:
        assert (args[1][-8:] % 32 == 0).all()
    if half == 32:
        h2 = pconcat.parse_header(args[3], device=CPU)
        shift = args[1][-8:] + 2 - (h2["header_bits"][-8:].numpy() + 1)
        assert (shift % 32 == 0).all()


def test_float_mode_concat_round_trips():
    rng = np.random.default_rng(7)
    n, half = 48, 30
    w = 2 * half
    ts = _regular(n, w, step=15, start=1_700_000_000)
    v = rng.standard_normal((n, w)) * 1e3 + 0.1
    assert not jtsz.detect_int_mode_batch(v, np.full(n, w, np.int32))[0].any()
    args, _, last_v, last_vd = _halves(ts, v, half)
    got_w, _ = _both_concat(args, last_v, last_vd, jtsz.max_words_for(w))
    dts, dv = ptsz.decode(got_w, np.full(n, w, np.int32), w, device=CPU)
    np.testing.assert_array_equal(dts.numpy(), ts)
    np.testing.assert_array_equal(dv.numpy(), v)


def test_float_zero_xor_boundary():
    """Identical values across the boundary emit the 1-bit '0' code."""
    n, half = 4, 8
    w = 2 * half
    ts = _regular(n, w)
    v = np.full((n, w), 2.5)
    args, _, last_v, last_vd = _halves(ts, v, half)
    got_w, _ = _both_concat(args, last_v, last_vd, jtsz.max_words_for(w))
    dts, dv = ptsz.decode(got_w, np.full(n, w, np.int32), w, device=CPU)
    np.testing.assert_array_equal(dv.numpy(), v)
    np.testing.assert_array_equal(dts.numpy(), ts)


def test_concat_short_second_block():
    """np2 == 1 (a single trailing point) has no second code to rewrite."""
    rng = np.random.default_rng(11)
    n, half = 16, 10
    ts = _regular(n, half + 1)
    v = rng.integers(0, 100, (n, half + 1)).astype(np.float64)
    mw_full = jtsz.max_words_for(half + 1)
    args, _, last_v, last_vd = _halves(ts, v, half,
                                       mw_half2=jtsz.max_words_for(1))
    got_w, got_nb = _both_concat(args, last_v, last_vd, mw_full)
    ref_w, ref_nb = jtsz.encode(ts, v, np.full(n, half + 1, np.int32),
                                max_words=mw_full)
    np.testing.assert_array_equal(got_nb, np.asarray(ref_nb))
    np.testing.assert_array_equal(got_w, np.asarray(ref_w))


# --------------------------------------------------- eligibility and merge


@pytest.mark.parametrize("strategy", ["concat", "recode"])
def test_merge_adjacent_mixed_eligibility(strategy):
    """Regular series concat, irregular ones recode; each forced strategy
    equals the reference's same strategy and the union round-trips."""
    rng = np.random.default_rng(3)
    n, half = 40, 20
    w = 2 * half
    ts_r, v_r = _mixed_series(n // 2, w, rng, regular=True)
    ts_i, v_i = _mixed_series(n - n // 2, w, rng, regular=False)
    ts = np.concatenate([ts_r, ts_i])
    v = np.concatenate([v_r, v_i])
    args, boundary, last_v, last_vd = _halves(ts, v, half)
    w1, nb1, np1, w2, nb2, np2 = args
    ref_ok = np.asarray(jconcat.concat_eligible(
        jconcat.parse_header(w1), jconcat.parse_header(w2), np1, np2,
        boundary))
    got_ok = pconcat.concat_eligible(
        pconcat.parse_header(w1, device=CPU),
        pconcat.parse_header(w2, device=CPU), np1, np2, boundary).numpy()
    np.testing.assert_array_equal(got_ok, ref_ok)
    assert got_ok[: n // 2].all() and not got_ok[n // 2:].any()
    got_w, _ = _both_merge(args, boundary, last_v, last_vd, half,
                           jtsz.max_words_for(w), strategy)
    dts, dv = ptsz.decode(got_w, np.full(n, w, np.int32), w, device=CPU)
    np.testing.assert_array_equal(dts.numpy(), ts)
    np.testing.assert_array_equal(dv.numpy(), v)


@pytest.mark.parametrize("strategy", ["auto", "concat", "recode"])
def test_merge_adjacent_hostile_with_forced_recode(strategy):
    """Hostile rows (NaN holes, signed zeros, wild bit patterns, short
    rows) through every path at once, a third of the rows forced onto the
    recode path as if their seal metadata were stale. On the CPU "auto"
    is the recode."""
    half = 24
    ts, vals, npts = hostile_block(5, 84, 2 * half)
    npts = np.maximum(npts, 2 * half - 3)
    w1, nb1, np1 = _encode_half(ts[:, :half], vals[:, :half],
                                jtsz.max_words_for(half))
    np2 = npts - half
    w2, nb2, _ = _encode_half(ts[:, half:], vals[:, half:],
                              jtsz.max_words_for(half), np2)
    last_v, last_vd = _boundary_meta(vals[:, :half])
    boundary = (ts[:, half] - ts[:, half - 1]).astype(np.int32)
    stale = np.arange(84) % 3 == 0
    _both_merge((w1, nb1, np1, w2, nb2, np2), boundary, last_v, last_vd,
                half, jtsz.max_words_for(2 * half),
                "recode" if strategy == "auto" else strategy,
                force_recode=stale)
    auto_w, _ = pconcat.merge_adjacent(
        w1, nb1, np1, w2, nb2, np2, boundary, last_v, last_vd,
        half_window=half, max_words=jtsz.max_words_for(2 * half),
        force_recode=stale, device=CPU)
    dts, dv = ptsz.decode(auto_w, npts, 2 * half, device=CPU)
    for r in range(84):
        k = int(npts[r])
        np.testing.assert_array_equal(dts.numpy()[r, :k], ts[r, :k])
        np.testing.assert_array_equal(dv.numpy()[r, :k].view(np.uint64),
                                      vals[r, :k].view(np.uint64))


def test_merge_by_recode_matches_reference():
    """The same-epoch recode (two decodes, a splice, one encode) on
    partially filled, irregular blocks."""
    rng = np.random.default_rng(13)
    n, half = 24, 16
    ts, v = _mixed_series(n, 2 * half, rng, regular=False)
    live = rng.integers(2, half + 1, n).astype(np.int32)
    w1, _, _ = _encode_half(ts[:, :half], v[:, :half],
                            jtsz.max_words_for(half), live)
    w2, _, _ = _encode_half(ts[:, half:], v[:, half:],
                            jtsz.max_words_for(half), live)
    boundary = np.full(n, 7, np.int32)
    mw = jtsz.max_words_for(2 * half)
    ref_w, ref_nb = jconcat._merge_by_recode(
        w1, live, w2, live, boundary, half_window=half, max_words=mw)
    got_w, got_nb = pconcat._merge_by_recode(
        *(torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32
                                    else a))
          for a in (w1, live, w2, live, boundary)),
        half_window=half, max_words=mw)
    np.testing.assert_array_equal(_u32(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(got_nb.numpy(), np.asarray(ref_nb))


def test_merge_values_recode_matches_reference():
    """The epoch-mismatched recode: k=0 ints then k=2 decimals, decoded to
    real values and re-encoded with fresh int-mode detection."""
    n, half = 6, 8
    ts = _regular(n, 2 * half)
    v = np.arange(n * 2 * half, dtype=np.float64).reshape(n, 2 * half)
    v[:, half:] += 0.25
    w1, _, np1 = _encode_half(ts[:, :half], v[:, :half],
                              jtsz.max_words_for(half))
    w2, _, np2 = _encode_half(ts[:, half:], v[:, half:],
                              jtsz.max_words_for(half))
    mw = jtsz.max_words_for(2 * half)
    ref_w, ref_nb = jconcat._merge_values_recode(
        w1, np1, w2, np2, half_window=half, max_words=mw)
    got_w, got_nb = pconcat._merge_values_recode(
        *(torch.from_numpy(np.array(a)) for a in (w1.view(np.int32), np1,
                                                  w2.view(np.int32), np2)),
        half_window=half, max_words=mw)
    np.testing.assert_array_equal(_u32(got_w), np.asarray(ref_w))
    np.testing.assert_array_equal(got_nb.numpy(), np.asarray(ref_nb))


# ---------------------------------------------------------- block merges


def _blocks(start, sids, ts, v, npts=None):
    """The same block sealed by both packages (equal by the storage
    tests; asserted here too)."""
    if npts is None:
        npts = np.full(ts.shape[0], ts.shape[1], np.int32)
    sids = np.asarray(sids, np.int32)
    ref = jblock.encode_block(start, sids, ts, v, npts)
    got = pblock.encode_block(start, sids, ts, v, npts, device=CPU)
    np.testing.assert_array_equal(got.words, ref.words)
    return got, ref


def _assert_same_block(got, ref):
    for f in ("words", "nbits", "npoints", "series_indices"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert (got.block_start, got.window) == (ref.block_start, ref.window)
    assert got.time_unit.nanos == ref.time_unit.nanos
    assert (got.boundary is None) == (ref.boundary is None)
    if ref.boundary is not None:
        assert sorted(got.boundary) == sorted(ref.boundary)
        for key in ref.boundary:
            np.testing.assert_array_equal(got.boundary[key],
                                          ref.boundary[key])


def _merge_both(p1, r1, p2, r2):
    got = pblock.merge_sealed_blocks(p1, p2)
    ref = jblock.merge_sealed_blocks(r1, r2)
    _assert_same_block(got, ref)
    return got, ref


def _assert_reads(blk, sid, want_t, want_v):
    ts, vs = blk.read(sid)
    np.testing.assert_array_equal(ts, want_t)
    np.testing.assert_array_equal(np.asarray(vs).view(np.uint64),
                                  np.asarray(want_v).view(np.uint64))


def test_merge_shared_and_disjoint_series():
    rng = np.random.default_rng(5)
    half = 16
    t1 = (np.int64(1_600_000_000) * S
          + np.arange(half, dtype=np.int64)[None, :] * 10 * S)
    t2 = t1 + half * 10 * S
    v1 = rng.integers(0, 100, (3, half)).astype(np.float64)
    v2 = rng.integers(0, 100, (3, half)).astype(np.float64)
    p1, r1 = _blocks(0, [1, 2, 3], np.broadcast_to(t1, (3, half)).copy(), v1)
    p2, r2 = _blocks(1, [2, 3, 4], np.broadcast_to(t2, (3, half)).copy(), v2)
    merged, rmerged = _merge_both(p1, r1, p2, r2)
    assert merged.series_indices.tolist() == [1, 2, 3, 4]
    _assert_reads(merged, 2, np.concatenate([t1[0], t2[0]]),
                  np.concatenate([v1[1], v2[0]]))
    _assert_reads(merged, 1, t1[0], v1[0])
    _assert_reads(merged, 4, t2[0], v2[2])
    t3 = t2 + half * 10 * S
    v3 = rng.integers(0, 100, (1, half)).astype(np.float64)
    p3, r3 = _blocks(2, [2], np.broadcast_to(t3, (1, half)).copy(), v3)
    merged2, _ = _merge_both(merged, rmerged, p3, r3)
    _assert_reads(merged2, 2, np.concatenate([t1[0], t2[0], t3[0]]),
                  np.concatenate([v1[1], v2[0], v3[0]]))


def test_chained_merge_single_point_middle_block():
    """When b2 contributes ONE point, the merged last_vdelta_bits must be
    the boundary delta, not b2's sealed 0; the carried metadata then feeds
    a forced concat that decodes right."""
    half = 8
    t1 = (np.int64(1_600_000_001) * S
          + np.arange(half, dtype=np.int64)[None, :] * 10 * S)
    t2 = t1[:, :1] + half * 10 * S
    t3 = t1 + (half + 1) * 10 * S
    v1 = 100.0 + 2.0 * np.arange(half, dtype=np.float64)[None, :]
    v2 = np.array([[200.0]])
    v3 = 210.0 + 10.0 * np.arange(half, dtype=np.float64)[None, :]
    full = np.array([half], np.int32)
    p1, r1 = _blocks(0, [7], t1.copy(), v1, full)
    p2, r2 = _blocks(1, [7], t2.copy(), v2, np.array([1], np.int32))
    p3, r3 = _blocks(2, [7], t3.copy(), v3, full)
    merged, rmerged = _merge_both(p1, r1, p2, r2)
    assert int(merged.npoints[0]) == half + 1 and merged.boundary["valid"][0]
    merged2, _ = _merge_both(merged, rmerged, p3, r3)
    _assert_reads(merged2, 7, np.concatenate([t1[0], t2[0], t3[0]]),
                  np.concatenate([v1[0], v2[0], v3[0]]))
    h3 = pconcat.parse_header(p3.words, device=CPU)
    boundary_dt = (h3["t0"].numpy()
                   - merged.boundary["last_ticks"]).astype(np.int32)
    mw = jtsz.max_words_for(merged.window + p3.window)
    args = (merged.words, merged.nbits, merged.npoints,
            p3.words, p3.nbits, p3.npoints)
    got_w, _ = _both_merge(args, boundary_dt, merged.boundary["last_v_bits"],
                           merged.boundary["last_vdelta_bits"],
                           max(merged.window, p3.window), mw, "concat")
    ts_c, v_c = ptsz.decode(got_w, merged.npoints + p3.npoints,
                            merged.window + p3.window, device=CPU)
    n_all = 2 * half + 1
    np.testing.assert_array_equal(v_c.numpy()[0, :n_all],
                                  np.concatenate([v1[0], v2[0], v3[0]]))
    np.testing.assert_array_equal(ts_c.numpy()[0, :n_all]
                                  * merged.time_unit.nanos,
                                  np.concatenate([t1[0], t2[0], t3[0]]))


def test_merge_without_metadata_falls_back():
    rng = np.random.default_rng(9)
    half = 8
    t1 = (np.int64(1_700_000_000) * S
          + np.arange(half, dtype=np.int64)[None, :] * 10 * S)
    t2 = t1 + half * 10 * S
    v1 = rng.standard_normal((2, half)) * 3
    v2 = rng.standard_normal((2, half)) * 3
    p1, r1 = _blocks(0, [5, 6], np.broadcast_to(t1, (2, half)).copy(), v1)
    p2, r2 = _blocks(1, [5, 6], np.broadcast_to(t2, (2, half)).copy(), v2)
    p1.boundary = r1.boundary = None  # as if paged in from disk
    merged, _ = _merge_both(p1, r1, p2, r2)
    _assert_reads(merged, 5, np.concatenate([t1[0], t2[0]]),
                  np.concatenate([v1[0], v2[0]]))


def test_partial_blocks_splice_correctly():
    n, cap, live = 3, 16, 10
    t1 = (np.int64(1_600_000_000) * S
          + np.arange(cap, dtype=np.int64)[None, :] * 10 * S)
    t2 = t1 + cap * 10 * S
    rng = np.random.default_rng(2)
    t1 = np.broadcast_to(t1, (n, cap)).copy()
    t2 = np.broadcast_to(t2, (n, cap)).copy()
    t1[:, 1::2] += 3 * S
    t2[:, 1::2] += 3 * S
    v1 = rng.integers(0, 100, (n, cap)).astype(np.float64)
    v2 = rng.integers(0, 100, (n, cap)).astype(np.float64)
    npts = np.full(n, live, np.int32)
    p1, r1 = _blocks(0, [1, 2, 3], t1, v1, npts)
    p2, r2 = _blocks(1, [1, 2, 3], t2, v2, npts)
    merged, _ = _merge_both(p1, r1, p2, r2)
    _assert_reads(merged, 2, np.concatenate([t1[1, :live], t2[1, :live]]),
                  np.concatenate([v1[1, :live], v2[1, :live]]))


def test_epoch_mismatch_reencodes_values():
    n, half = 2, 8
    t1 = (np.int64(1_600_000_000) * S
          + np.arange(half, dtype=np.int64)[None, :] * 10 * S)
    t2 = t1 + half * 10 * S
    v1 = np.arange(n * half, dtype=np.float64).reshape(n, half)
    v2 = v1 + 0.25
    npts = np.full(n, half, np.int32)
    p1, r1 = _blocks(0, [1, 2], np.broadcast_to(t1, (n, half)).copy(), v1,
                     npts)
    p2, r2 = _blocks(1, [1, 2], np.broadcast_to(t2, (n, half)).copy(), v2,
                     npts)
    merged, rmerged = _merge_both(p1, r1, p2, r2)
    _assert_reads(merged, 1, np.concatenate([t1[0], t2[0]]),
                  np.concatenate([v1[0], v2[0]]))
    assert not merged.boundary["valid"].any()
    t3 = t2 + half * 10 * S
    p3, r3 = _blocks(2, [1, 2], np.broadcast_to(t3, (n, half)).copy(), v1,
                     npts)
    merged2, _ = _merge_both(merged, rmerged, p3, r3)
    _assert_reads(merged2, 1, np.concatenate([t1[0], t2[0], t3[0]]),
                  np.concatenate([v1[0], v2[0], v1[0]]))


def test_oversize_gap_rejected():
    half = 4
    t1 = np.arange(half, dtype=np.int64)[None, :] * 10 * S
    t2 = t1 + 2**32 * S
    v = np.ones((1, half))
    npts = np.full(1, half, np.int32)
    p1, _ = _blocks(0, [1], t1.copy(), v, npts)
    p2, _ = _blocks(1, [1], t2.copy(), v, npts)
    with pytest.raises(ValueError, match="gap exceeds int32"):
        pblock.merge_sealed_blocks(p1, p2)


def test_merge_rejects_unordered_blocks():
    t = (np.int64(1_600_000_000) * S
         + np.arange(4, dtype=np.int64)[None, :] * 10 * S)
    p1, _ = _blocks(5, [1], t.copy(), np.ones((1, 4)))
    with pytest.raises(ValueError, match="time-ordered"):
        pblock.merge_sealed_blocks(p1, p1)
