"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: without an NVIDIA GPU every test here skips. The file
imports neither JAX nor m3_tpu, so a machine with only PyTorch runs it
(without the conftest, the marker is registered on the command line):
    python -m pytest tests/test_torch_cuda.py -q --noconftest \
        -o "markers=cuda: needs an NVIDIA GPU"
The codec kernels and their plain versions compute integer results:
equality is exact. The window kernel's count, min, max and last are exact
too (signed zeros included); its sum and m2 are f32 sums in another order,
held to the per-window reorder bound of m3_tpu_torch.testing.
window_reorder_bounds. Engine queries on the card against device="cpu"
use the oracle tolerance rtol 1e-5, atol 1e-8."""

import numpy as np
import pytest
import torch

from m3_tpu_torch.ops import codec_kernels as ck
from m3_tpu_torch.ops import tsz
from m3_tpu_torch.ops import window_kernels as wk
from m3_tpu_torch.parallel import ingest
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import (DictStorage, hostile_block,
                                  hostile_residuals, prometheus_ids,
                                  promql_corpus, window_reorder_bounds)
from m3_tpu_torch.utils.hashing import pad_ids

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ck.build()
    return torch.device("cuda")


def _chunks(seed, n, w, cuda):
    ts, vals, npts = hostile_block(seed, n, w)
    return tsz.encode_chunks(**tsz.prepare_encode_inputs(ts, vals, npts),
                             device=cuda), torch.from_numpy(npts).to(cuda)


@pytest.mark.parametrize("seed,n,w", [(0, 700, 120), (1, 333, 40), (2, 64, 600)])
def test_pack_kernel_matches_plain(cuda, seed, n, w):
    chunks, _ = _chunks(seed, n, w, cuda)
    for mw in (tsz.max_words_for(w), tsz.max_words_for(w) // 3):
        got = ck.pack_chunks(*chunks, mw)
        torch.cuda.synchronize()
        assert torch.equal(got, ck.pack_chunks_plain(*chunks, mw))


@pytest.mark.parametrize("seed,n,w", [(3, 700, 120), (4, 64, 600)])
def test_decode_kernel_matches_plain(cuda, seed, n, w):
    chunks, npts = _chunks(seed, n, w, cuda)
    words = ck.pack_chunks(*chunks, tsz.max_words_for(w))
    got = ck.decode_points(words, npts, w)
    torch.cuda.synchronize()
    for a, b in zip(got, ck.decode_points_plain(words, npts, w)):
        assert torch.equal(a, b)


def test_decode_kernel_matches_plain_on_garbage_words(cuda):
    """Random words exercise every shift-count edge and the clamped reads
    past the row end; the kernel must still agree with its plain twin."""
    rng = np.random.default_rng(5)
    for mw in (1, 3, 17):
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (512, mw),
                                              dtype=np.int64).astype(np.int32)).to(cuda)
        npts = torch.from_numpy(rng.integers(0, 40, 512).astype(np.int32)).to(cuda)
        got = ck.decode_points(words, npts, 40)
        torch.cuda.synchronize()
        for a, b in zip(got, ck.decode_points_plain(words, npts, 40)):
            assert torch.equal(a, b)


def test_hash_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    ids = [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in range(601)]
    ids += [b"y" * 2100] + prometheus_ids(2000, rng)
    w, lens = pad_ids(ids)
    w = torch.from_numpy(np.ascontiguousarray(w)).to(cuda)
    lens = torch.from_numpy(lens).to(cuda)
    for seed in (0, 0x9747B28C):
        got = ck.hash_words(w, lens, seed)
        torch.cuda.synchronize()
        assert torch.equal(got, ck.hash_words_plain(w, lens, seed))


def test_slice_on_card_matches_cpu_and_counts_launches(cuda):
    ts, vals, npts = hostile_block(7, 512, 120)
    ids = prometheus_ids(512, np.random.default_rng(7))
    mw = tsz.max_words_for(120)
    before = ck.launch_counts()
    outs = {}
    for dev in ("cuda", "cpu"):
        shards = ShardSet().lookup_batch(ids, device=dev)
        order = torch.argsort(shards, stable=True).cpu().numpy()
        raw = ingest.make_raw_batch(ts[order], vals[order], npts[order],
                                    device=dev)
        out = ingest.ingest_step_raw(raw, rollup_factor=6, max_words=mw, device=dev)
        dec = tsz.decode_plane(out[0], raw.npoints, window=120, device=dev)
        outs[dev] = [t.cpu() for t in (shards, out[0], out[1], out[4], dec[0],
                                       dec[1].view(torch.int64))]
    torch.cuda.synchronize()
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(a, b)
    after = ck.launch_counts()
    assert after["pack"] == before["pack"] + 1
    assert after["decode"] == before["decode"] + 1
    assert after["hash"] == before["hash"] + 1


@pytest.mark.parametrize("stat", wk.STATS)
@pytest.mark.parametrize("K,W,stride", [
    (119, 10, 1), (67, 6, 2), (67, 6, 3), (67, 6, 4), (358, 31, 3),
    (3300, 30, 30), (30, 30, 1), (438, 30, 3)])
def test_window_kernel_matches_plain(cuda, stat, K, W, stride):
    x = torch.from_numpy(hostile_residuals(K + W + stride, 777, K)).to(cuda)
    got, got_c = wk.window_stat(x, W, stride, stat)
    want, want_c = wk.window_stat_plain(x, W, stride, stat)
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    if stat in ("count", "min", "max", "last"):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        sum_b, m2_b = window_reorder_bounds(x, W, stride)
        bound = (sum_b if stat == "sum" else m2_b) + 1e-12
        assert ((got.double() - want.double()).abs() <= bound).all()


def test_engine_on_card_matches_cpu_and_launches_the_window_kernel(cuda):
    series, t = promql_corpus(300, 11)
    start, end, step = int(t[30]), int(t[-1]), 30 * 10**9
    card = Engine(DictStorage(series))
    cpu = Engine(DictStorage(series), device="cpu")
    for q in ("sum_over_time(bench_metric[5m])", "rate(bench_metric[5m])",
              "stddev_over_time(bench_metric[5m10s])",
              "max_over_time(rate(bench_metric[5m])[30m:1m])"):
        before = wk.window_stat.launches
        got = card.execute_range(q, start, end, step)
        want = cpu.execute_range(q, start, end, step)
        assert [x.id() for x in got.series_tags] == [
            x.id() for x in want.series_tags]
        np.testing.assert_array_equal(np.isnan(got.values),
                                      np.isnan(want.values))
        np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                                   atol=1e-8, equal_nan=True)
        grew = wk.window_stat.launches > before
        assert grew == q.startswith(("sum_", "stddev_", "max_")), q
