"""The port's TTSZ codec (m3_tpu_torch.ops.tsz, with the plain versions of
the pack and decode kernels on the CPU) against the JAX codec and the
scalar oracle ref_codec. The codec is exact integer work: words, nbits,
prepared inputs and decoded planes must be identical bit for bit, so no
tolerance applies anywhere in this file.

The JAX side runs as its own CPU tests run it: the default XLA routes
(scatter pack, lax.scan decode), which tests/test_codec_pallas.py holds
bit-identical to the Pallas kernels, plus one small case with the Pallas
pack in interpret mode."""

import numpy as np
import pytest
import torch

from m3_tpu.ops import ref_codec
from m3_tpu.ops import tsz as jtsz
from m3_tpu_torch import convert
from m3_tpu_torch.ops import codec_kernels
from m3_tpu_torch.ops import tsz as ptsz
from m3_tpu_torch.testing import hostile_block
from test_codec_pallas import _corpus, _encode_args

CPU = "cpu"
SHAPES = [(64, 16), (48, 40), (32, 120)]


def _port_args(ts, vals, npoints):
    inp = ptsz.prepare_encode_inputs(ts, vals, npoints)
    return {k: inp[k] for k in ("dt", "t0", "v", "int_mode", "k", "npoints",
                                "ts_regular", "delta0")}


def _ref_encode(ts, vals, npoints, max_words, pack="scatter"):
    words, nbits = jtsz.encode_batch(**_encode_args(ts, vals, npoints),
                                     max_words=max_words, pack=pack)
    return np.asarray(words), np.asarray(nbits)


@pytest.mark.parametrize("w", [1, 2, 16, 120, 360])
def test_max_words_for_matches_reference(w):
    assert ptsz.max_words_for(w) == jtsz.max_words_for(w)
    if w == 120:
        assert ptsz.max_words_for(w) == 446


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n,w", SHAPES)
def test_encode_bit_identical_to_jax(seed, n, w):
    ts, vals, npoints = _corpus(seed * 31 + w, n, w)
    mw = jtsz.max_words_for(w)
    ref_words, ref_nbits = _ref_encode(ts, vals, npoints, mw)
    words, nbits = ptsz.encode(ts, vals, npoints, mw, device=CPU)
    assert words.dtype == torch.int32 and words.shape == (n, mw)
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref_words)
    np.testing.assert_array_equal(nbits.numpy(), ref_nbits)


def test_hostile_block_encodes_and_decodes_as_jax():
    """The card's parity corpus (m3_tpu_torch.testing.hostile_block) is
    itself held to the JAX codec here."""
    ts, vals, npoints = hostile_block(7, 70, 120)
    mw = jtsz.max_words_for(120)
    ref_words, ref_nbits = _ref_encode(ts, vals, npoints, mw)
    words, nbits = ptsz.encode(ts, vals, npoints, mw, device=CPU)
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref_words)
    np.testing.assert_array_equal(nbits.numpy(), ref_nbits)
    rts, rv = jtsz.decode_plane(ref_words, npoints, window=120)
    pts, pv = ptsz.decode_plane(words, npoints, window=120, device=CPU)
    np.testing.assert_array_equal(pts.numpy(), rts)
    np.testing.assert_array_equal(pv.numpy().view(np.int64),
                                  np.asarray(rv).view(np.int64))


def test_encode_matches_pallas_pack_interpret_mode():
    ts, vals, npoints = _corpus(5, 16, 16)
    mw = jtsz.max_words_for(16)
    ref_words, ref_nbits = _ref_encode(ts, vals, npoints, mw, pack="pallas")
    words, nbits = ptsz.encode(ts, vals, npoints, mw, device=CPU)
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref_words)
    np.testing.assert_array_equal(nbits.numpy(), ref_nbits)


def test_encode_rows_match_scalar_oracle():
    ts, vals, _ = _corpus(9, 21, 40)
    words, nbits = ptsz.encode(ts, vals, device=CPU)
    words = convert.words_to_numpy(words)
    for r in range(ts.shape[0]):
        blk = ref_codec.encode(ts[r], vals[r])
        assert int(nbits[r]) == blk.nbits
        np.testing.assert_array_equal(words[r, :len(blk.words)], blk.words)
        assert not words[r, len(blk.words):].any()


def test_prepare_encode_inputs_matches_jax():
    ts, vals, npoints = _corpus(13, 40, 40)
    ref = jtsz.prepare_encode_inputs(ts, vals, npoints)
    got = ptsz.prepare_encode_inputs(ts, vals, npoints)
    for key in ("dt", "int_mode", "k", "npoints", "ts_regular", "delta0"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(got["t0"], convert.pair_to_int64(*ref["t0"]))
    np.testing.assert_array_equal(got["v"],
                                  convert.pair_to_int64(ref["vhi"], ref["vlo"]))
    bm_ref = jtsz.boundary_metadata(ref)
    bm = ptsz.boundary_metadata(got)
    for key in bm_ref:
        np.testing.assert_array_equal(bm[key], bm_ref[key], err_msg=key)


def test_prepare_on_device_math_matches_jax():
    from m3_tpu.ops import bits64 as jb

    ts, vals, npoints = _corpus(17, 48, 40)
    vals[3, 5] = -0.0  # a signed zero forces the row to float mode
    ref, ref_ok = jtsz.prepare_on_device_math(
        *jb.from_u64_np(ts.view(np.uint64)),
        *jb.from_u64_np(vals.view(np.uint64)), npoints)
    got, ok = ptsz.prepare_on_device_math(
        torch.from_numpy(ts), torch.from_numpy(vals.view(np.int64).copy()),
        torch.from_numpy(npoints))
    assert bool(ok) == bool(ref_ok)
    for key in ("dt", "int_mode", "k", "npoints", "ts_regular", "delta0"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got["t0"].numpy(),
                                  convert.pair_to_int64(*ref["t0"]))
    np.testing.assert_array_equal(got["v"].numpy(),
                                  convert.pair_to_int64(ref["vhi"], ref["vlo"]))


def test_prepare_rejects_deltas_outside_int32():
    ts = np.array([[0, 1, 2 + 2**31]], np.int64)
    with pytest.raises(ValueError):
        ptsz.prepare_encode_inputs(ts, np.zeros((1, 3)), np.array([3]))
    _, ok = ptsz.prepare_on_device_math(
        torch.from_numpy(ts), torch.zeros((1, 3), dtype=torch.int64),
        torch.tensor([3], dtype=torch.int32))
    assert not bool(ok)


@pytest.mark.parametrize("n,w", SHAPES)
def test_decode_plane_bit_identical_to_jax(n, w):
    ts, vals, npoints = _corpus(101 + w, n, w)
    ref_words, _ = _ref_encode(ts, vals, npoints, jtsz.max_words_for(w))
    rts, rv, rf = jtsz.decode_plane(ref_words, npoints, window=w,
                                    unit_nanos=10**9, with_f32=True)
    pts, pv, pf = ptsz.decode_plane(convert.words_to_torch(ref_words, CPU),
                                    npoints, window=w, unit_nanos=10**9,
                                    with_f32=True, device=CPU)
    np.testing.assert_array_equal(pts.numpy(), rts)
    np.testing.assert_array_equal(pv.numpy().view(np.int64),
                                  np.asarray(rv).view(np.int64))
    np.testing.assert_array_equal(pf.numpy().view(np.int32),
                                  np.asarray(rf).view(np.int32))


def test_decode_batch_matches_jax_every_key():
    ts, vals, npoints = _corpus(23, 40, 40)
    ref_words, _ = _ref_encode(ts, vals, npoints, jtsz.max_words_for(40))
    ref = jtsz.decode_batch(ref_words, npoints, window=40)
    got = ptsz.decode_batch(ref_words, npoints, window=40, device=CPU)
    np.testing.assert_array_equal(got["dt"].numpy(), np.asarray(ref["dt"]))
    np.testing.assert_array_equal(
        got["v"].numpy(), convert.pair_to_int64(ref["vhi"], ref["vlo"]))
    np.testing.assert_array_equal(got["t0"].numpy(),
                                  convert.pair_to_int64(*ref["t0"]))
    np.testing.assert_array_equal(got["int_mode"].numpy(),
                                  np.asarray(ref["int_mode"]))
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(ref["k"]))


def test_cross_decode_port_words_through_jax_and_back():
    ts, vals, npoints = _corpus(29, 48, 40)
    words, _ = ptsz.encode(ts, vals, npoints, device=CPU)
    # port words -> JAX decode
    rts, rv = jtsz.decode_plane(convert.words_to_numpy(words), npoints,
                                window=40, unit_nanos=1)
    # JAX words -> port decode
    ref_words, _ = _ref_encode(ts, vals, npoints, jtsz.max_words_for(40))
    pts, pv = ptsz.decode(convert.words_to_torch(ref_words, CPU), npoints, 40,
                          device=CPU)
    for r in range(ts.shape[0]):
        n = int(npoints[r])
        np.testing.assert_array_equal(rts[r, :n], ts[r, :n])
        np.testing.assert_array_equal(pts.numpy()[r, :n], ts[r, :n])
        np.testing.assert_array_equal(
            np.asarray(rv)[r, :n].view(np.uint64), vals[r, :n].view(np.uint64))
        np.testing.assert_array_equal(
            pv.numpy()[r, :n].view(np.uint64), vals[r, :n].view(np.uint64))


def test_undersized_bound_raises_typed_error():
    ts, vals, npoints = _corpus(31, 16, 64)
    npoints = np.full_like(npoints, 64)
    with pytest.raises(ptsz.CursorOverflowError):
        ptsz.encode(ts, vals, npoints, max_words=4, device=CPU)
    with pytest.raises(ptsz.CursorOverflowError):
        ptsz.check_cursor(torch.tensor([10, 129]), 4)
    ptsz.check_cursor(torch.tensor([10, 128]), 4)


def test_pack_plain_drop_semantics_match_jax_scatter():
    """An undersized max_words drops the same bits in both packers."""
    ts, vals, npoints = _corpus(3, 16, 64)
    mw = jtsz.max_words_for(64) // 2
    ref_words, _ = _ref_encode(ts, vals, npoints, mw)
    inp = _port_args(ts, vals, npoints)
    words, _ = ptsz.encode_batch(**inp, max_words=mw, device=CPU)
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref_words)


def test_pack_plain_matches_jax_on_random_chunks():
    """Arbitrary left-aligned chunks (not only codec output) with zero
    lengths, 96-bit chunks and words past the row end."""
    rng = np.random.default_rng(37)
    n, s, mw = 24, 30, 40
    nb = rng.integers(0, 97, (n, s)).astype(np.int32)
    nb[:, ::7] = 0
    raw = rng.integers(0, 2**32, (3, n, s), dtype=np.uint64).astype(np.uint32)
    # left-align: keep only the top nb bits of the 96-bit chunk
    chunks = []
    for j in range(3):
        keep = np.clip(nb - 32 * j, 0, 32)
        mask = np.where(keep >= 32, np.uint64(0xFFFFFFFF),
                        ((np.uint64(1) << keep.astype(np.uint64)) - np.uint64(1))
                        << (np.uint64(32) - keep.astype(np.uint64)))
        chunks.append((raw[j] & mask.astype(np.uint32)).astype(np.uint32))
    ref = np.asarray(jtsz._pack_scatter([c for c in chunks], nb, mw))
    got = codec_kernels.pack_chunks(
        *(convert.words_to_torch(c, CPU) for c in chunks),
        torch.from_numpy(nb), mw)
    np.testing.assert_array_equal(convert.words_to_numpy(got), ref)


def test_kernel_wrappers_validate_inputs():
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        codec_kernels.pack_chunks(z, z, z, z.to(torch.int64), 8)
    with pytest.raises(ValueError):
        codec_kernels.pack_chunks(z, z, z, torch.zeros((2, 5), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        codec_kernels.decode_points(torch.zeros((4, 2), dtype=torch.int32).t(),
                                    torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        codec_kernels.hash_words(z, torch.zeros(3, dtype=torch.int32))
    before = codec_kernels.launch_counts()
    codec_kernels.pack_chunks(z, z, z, z, 8)
    assert codec_kernels.launch_counts() == before  # the plain path launches nothing


def test_kernel_build_runs_once_under_concurrent_first_use(monkeypatch,
                                                           tmp_path):
    """The node server's handler threads may all make the kernels' first
    use at once: build() loads the extension exactly once and hands every
    thread the same module (cpp_extension.load stubbed by a slow fake)."""
    import threading
    import time

    import torch.utils.cpp_extension as cpp_ext

    from m3_tpu_torch.ops import codec_kernels as ck

    loads = []

    def slow_load(**kw):
        loads.append(kw["name"])
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(cpp_ext, "load", slow_load)
    monkeypatch.setattr(ck, "_MODULE", None)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
    start = threading.Barrier(8)
    got = []

    def first_use():
        start.wait()
        got.append(ck.build())

    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert loads == ["m3_tpu_torch_kernels"]
    assert len(got) == 8 and all(m is got[0] for m in got)
    assert ck.build() is got[0] and (tmp_path / "build").is_dir()
