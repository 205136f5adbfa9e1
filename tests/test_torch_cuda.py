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
use the oracle tolerance rtol 1e-5, atol 1e-8. The storage node's tests
hold a Database on the card against device="cpu" bit for bit, the seal's
retained tensors against the budget, and a decode fault to raising. The
compiled plan route's tests hold each captured graph's replay to its body
run eagerly on the card bit for bit, and its answers to the CPU plan
route's under the oracle tolerance. The aggregator flush's rank selection
on the card equals its torch ops on the CPU index for index, a flush of
the agg_rollup_10x population on the card equals the CPU's bit for bit,
and the rules engine's f32 compare on the card equals the CPU's. The
durable path's blooms, WAL replay routing, recovered blocks and cold
reads through the retriever on the card equal the CPU's bit for bit, and
a hash fault on the bloom route raises typed. A 3-node cluster on the
card (node servers, a Session decoding its tiles on the card) gives the
same fetch_tagged answers, peers bootstrap words and repaired rows as the
same cluster with device="cpu", while handler threads launch the kernels
concurrently."""

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


# -- edges of the tiled window kernel and the staged decode ---------------


def _window_case(x, W, stride, stat):
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


@pytest.mark.parametrize("stat", wk.STATS)
def test_window_kernel_takes_a_misaligned_row_slice(cuda, stat):
    """resid[1:] at K = 119 starts 476 bytes into its allocation, off a
    16-byte line: the staged copy takes its head and tail singly."""
    base = torch.from_numpy(hostile_residuals(31, 900, 119)).to(cuda)
    for lo in (1, 2, 3):
        x = base[lo:]
        assert x.is_contiguous() and x.data_ptr() % 16
        _window_case(x, 10, 1, stat)
        _window_case(x, 31, 3, stat)


@pytest.mark.parametrize("stat", wk.STATS)
def test_window_kernel_ragged_row_tiles(cuda, stat):
    """Row counts around the tile size: the kernel aims at 8 tiles per SM,
    so at R * 8 * SMs -/+ 1 rows the tiles hold R (or R + 1) rows and the
    last one is ragged."""
    tiles = 8 * torch.cuda.get_device_properties(cuda).multi_processor_count
    for rows in (1, 2, 3 * tiles - 1, 3 * tiles + 1):
        x = torch.from_numpy(hostile_residuals(rows, rows, 119)).to(cuda)
        _window_case(x, 10, 1, stat)
        _window_case(x, 30, 3, stat)


@pytest.mark.parametrize("stat", wk.STATS)
@pytest.mark.parametrize("K,W,stride", [
    (1, 1, 1), (2, 1, 1), (2, 2, 1), (3, 2, 5), (3, 3, 1), (119, 119, 1),
    (119, 1, 1), (119, 1, 4), (67, 6, 7), (67, 4, 9), (67, 6, 6),
    (5000, 30, 3), (5000, 100, 7), (4500, 2000, 1), (9000, 2100, 300)])
def test_window_kernel_edges(cuda, stat, K, W, stride):
    """K < 4, W = K, W = 1, stride > W, rows longer than a tile (column
    tiles) and windows wider than half a tile (the direct kernel)."""
    x = torch.from_numpy(hostile_residuals(K * 7 + W, 40, K)).to(cuda)
    _window_case(x, W, stride, stat)


@pytest.mark.parametrize("stat", ("min", "max"))
def test_window_kernel_signed_zero_ties(cuda, stat):
    """Windows of only -0.0, +0.0 and holes: min gives -0.0 wherever the
    window holds one, max +0.0; the order keys must not lose the sign."""
    rng = np.random.default_rng(12)
    x = np.where(rng.random((300, 64)) < 0.5, -0.0, 0.0).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    x = torch.from_numpy(x).to(cuda)
    for W, stride in ((1, 1), (4, 1), (6, 3), (5, 2)):
        _window_case(x, W, stride, stat)


def test_window_kernel_raises_on_bad_input(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        wk.window_stat(x.double(), 4, 1, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x.t(), 4, 1, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x, 9, 1, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x, 4, 0, "sum")
    with pytest.raises(ValueError):
        wk.window_stat(x, 4, 1, "median")


@pytest.mark.parametrize("n,w", [(1, 1), (127, 1), (129, 13), (300, 41),
                                 (257, 120), (128, 7)])
def test_decode_kernel_staged_edges(cuda, n, w):
    """N not a multiple of the block's 128 series, W = 1 and W not a
    multiple of the 8 points staged between stores."""
    chunks, npts = _chunks(8 + n, max(n, 3), w, cuda)
    words = ck.pack_chunks(*chunks, tsz.max_words_for(w))[:n]
    npts = npts[:n]
    got = ck.decode_points(words, npts, w)
    torch.cuda.synchronize()
    for a, b in zip(got, ck.decode_points_plain(words, npts, w)):
        assert torch.equal(a, b)


def test_decode_kernel_takes_a_row_slice(cuda):
    """words[1:] (and npoints[1:]) as the kernel's input: a row slice that
    starts one row into its allocation."""
    chunks, npts = _chunks(9, 300, 120, cuda)
    words = ck.pack_chunks(*chunks, tsz.max_words_for(120))
    for lo in (1, 3):
        got = ck.decode_points(words[lo:], npts[lo:], 120)
        torch.cuda.synchronize()
        for a, b in zip(got, ck.decode_points_plain(words[lo:], npts[lo:], 120)):
            assert torch.equal(a, b)


# ------------------------------------------------------- the storage node

_BLOCK = 2 * 3600 * 10**9
_T0 = (1_700_000_000 * 10**9 // _BLOCK) * _BLOCK


def _sealed_db(device, n=300, ppb=24, monkeypatch=None, cache=None):
    """A 4-shard Database on `device` holding two sealed 2 h blocks of
    `ppb` points for n series (bench_hot_set_read's build, small)."""
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    now = {"t": _T0}
    db = Database(ShardSet(4), clock=lambda: now["t"], device=device)
    db.ensure_namespace(b"bench", NamespaceOptions(
        index_enabled=False, writes_to_commitlog=False,
        retention_ns=4 * 86400 * 10**9))
    ids = [b"hot-%06d" % i for i in range(n)]
    vals = np.random.default_rng(53).standard_normal((2 * ppb, n))
    for s in range(2 * ppb):
        now["t"] = _T0 + s * (_BLOCK // ppb)
        db.write_batch(b"bench", ids, np.full(n, now["t"], np.int64), vals[s])
    now["t"] = _T0 + 2 * _BLOCK + 11 * 60 * 10**9
    assert db.tick()["sealed"] == 8
    return db, ids


@pytest.fixture
def fresh_cache(monkeypatch):
    from m3_tpu_torch.storage import block_cache
    from m3_tpu_torch.utils.hbm import HBMBudget

    c = block_cache.DeviceBlockCache(budget=HBMBudget(1 << 30), admit_after=2)
    monkeypatch.setattr(block_cache, "_CACHE", c)
    monkeypatch.delenv("M3_TPU_BLOCK_CACHE_RETAIN", raising=False)
    return c


def test_seal_retains_cuda_tensors_charged_and_released(cuda, fresh_cache):
    """A seal on the card hands its word tensors to the cache: CUDA int32
    tensors, charged at numel * element_size while the block lives and
    released on close."""
    ck.reset_launch_counts()
    db, _ = _sealed_db(cuda)
    assert ck.launch_counts()["hash"] == 48 and ck.launch_counts()["pack"] == 8
    charged = 0
    for shard in db.namespace(b"bench").shards.values():
        for blk in shard.blocks.values():
            words, npoints = fresh_cache.encoded(blk)
            assert words.is_cuda and words.dtype == torch.int32
            assert words.shape[0] >= blk.num_series
            charged += words.numel() * 4 + npoints.numel() * 4
    assert fresh_cache.stats()["retained"] == 8
    assert fresh_cache.budget.total() == charged > 0
    db.close()
    assert fresh_cache.budget.total() == 0 and len(fresh_cache) == 0


def test_read_all_on_card_equals_cpu(cuda, fresh_cache):
    """Every sealed block and every read on the card equals device="cpu"
    bit for bit, cold and through the cache."""
    gpu, ids = _sealed_db(cuda)
    cpu, _ = _sealed_db("cpu")
    for sh, shard in gpu.namespace(b"bench").shards.items():
        other = cpu.namespace(b"bench").shards[sh]
        for bs, blk in shard.blocks.items():
            ref = other.blocks[bs]
            assert (blk.words == ref.words).all()
            for _ in range(3):
                for a, b in zip(blk.read_all(), ref.read_all()):
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for sid in ids[:40]:
        a = gpu.read(b"bench", sid, _T0, _T0 + 2 * _BLOCK)
        b = cpu.read(b"bench", sid, _T0, _T0 + 2 * _BLOCK)
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()


def test_decode_fault_on_card_raises(cuda, fresh_cache, monkeypatch):
    """No fallback on the path: when the decode kernel faults, a read
    raises instead of running a host decoder."""
    db, ids = _sealed_db(cuda, n=40)

    class Faulty:
        def __getattr__(self, name):
            def fault(*args):
                raise RuntimeError("injected kernel fault")
            return fault

    monkeypatch.setattr(ck, "build", lambda: Faulty())
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        db.read(b"bench", ids[0], _T0, _T0 + 2 * _BLOCK)
    blk = next(iter(db.namespace(b"bench").shards[0].blocks.values()))
    with pytest.raises(RuntimeError, match="injected kernel fault"):
        blk.read_all()


# ------------------------------------------- the flush merge and the guard


def _flush_halves(n, half, seed, device):
    """bench_flush_merge's inputs, small: make_example_raw split into two
    sealed half-blocks (one encoding epoch per series), block1's boundary
    metadata and the boundary gap."""
    ts, vals, npts = ingest.make_example_raw(n, 2 * half,
                                             np.random.default_rng(seed))
    full = tsz.prepare_encode_inputs(ts, vals, npts)
    mw = tsz.max_words_for(half)
    out = []
    for lo in (0, half):
        dt = full["dt"][:, lo:lo + half].copy()
        dt[:, 0] = 0
        inp = dict(dt=dt, t0=ts[:, lo].copy(), v=full["v"][:, lo:lo + half],
                   int_mode=full["int_mode"], k=full["k"],
                   npoints=np.full(n, half, np.int32),
                   ts_regular=(dt[:, 1:] == dt[:, 1:2]).all(axis=1),
                   delta0=dt[:, 1].copy())
        w, nb = tsz.encode_prepared(inp, mw, device=device)
        out += [w, nb, torch.from_numpy(inp["npoints"]).to(device)]
        if lo == 0:
            meta = tsz.boundary_metadata(inp)
    boundary = (ts[:, half] - ts[:, half - 1]).astype(np.int32)
    return ts, vals, out, boundary, meta


@pytest.mark.parametrize("strategy", ["auto", "concat", "recode"])
def test_flush_merge_on_card_equals_cpu(cuda, strategy):
    """merge_adjacent on the card equals the same strategy on the CPU word
    for word ("auto" is the concat on the card), and decodes to the raw
    points."""
    from m3_tpu_torch.ops import tsz_concat

    n, half = 600, 60
    ts, vals, args, boundary, meta = _flush_halves(n, half, 17, cuda)
    mw = tsz.max_words_for(2 * half)
    kw = dict(half_window=half, max_words=mw)
    meta_v = (meta["last_v_bits"], meta["last_vdelta_bits"])
    got = tsz_concat.merge_adjacent(*args, boundary, *meta_v,
                                    strategy=strategy, **kw)
    cpu_args = [a.cpu() for a in args]
    want = tsz_concat.merge_adjacent(
        *cpu_args, boundary, *meta_v, device="cpu",
        strategy="concat" if strategy == "auto" else strategy, **kw)
    torch.cuda.synchronize()
    assert got[0].is_cuda
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    dts, dv = tsz.decode(got[0], np.full(n, 2 * half, np.int32), 2 * half)
    assert (dts.cpu().numpy() == ts).all()
    assert (dv.cpu().numpy().view(np.uint64) == vals.view(np.uint64)).all()


def test_merge_sealed_blocks_on_card_reads_back(cuda, fresh_cache):
    """Each shard's two card-sealed blocks merge (the concat) into one
    block whose read_all equals the two blocks' reads side by side."""
    from m3_tpu_torch.storage.block import merge_sealed_blocks

    ck.reset_launch_counts()
    db, _ = _sealed_db(cuda)
    for shard in db.namespace(b"bench").shards.values():
        (_, b1), (_, b2) = sorted(shard.blocks.items())
        t1, v1, n1 = b1.read_all()
        t2, v2, n2 = b2.read_all()
        merged = merge_sealed_blocks(b1, b2)
        assert merged.window == b1.window + b2.window
        assert merged.boundary["valid"].all()
        tm, vm, nm = merged.read_all()
        assert (nm == n1 + n2).all()
        for r in range(merged.num_series):
            a, b = int(n1[r]), int(n2[r])
            assert tm[r, :a + b].tobytes() == np.concatenate(
                [t1[r, :a], t2[r, :b]]).tobytes()
            assert vm[r, :a + b].tobytes() == np.concatenate(
                [v1[r, :a], v2[r, :b]]).tobytes()
    db.close()


def test_injected_decode_fault_on_card_raises_typed(cuda):
    """No fallback: an injected codec.decode fault on the card raises
    KernelFault (and never hands back the plain version's answer); an open
    breaker, a quarantined key and a corrupted output raise typed too."""
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.testing import faultcomp
    from m3_tpu_torch.utils.retry import BreakerOptions

    chunks, npts = _chunks(7, 64, 40, cuda)
    words = ck.pack_chunks(*chunks, tsz.max_words_for(40))
    plain = []
    real_plain = ck.decode_points_plain

    def spy(*args):
        plain.append(1)
        return real_plain(*args)

    guard.reset()
    try:
        ck.decode_points_plain = spy
        for kind in ("dispatch_raise", "corrupt"):
            guard.reset()
            plan = faultcomp.ComputeFaultPlan(seed=0, route_filter="codec.",
                                              **{kind: 1.0})
            with faultcomp.injected(plan):
                with pytest.raises(guard.KernelFault):
                    tsz.decode_batch(words, npts, window=40)
        assert plain == []
        guard.configure("codec.decode", opts=BreakerOptions(
            window=4, failure_ratio=0.5, min_samples=1, cooldown_s=3600.0))
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=0, dispatch_raise=1.0)):
            with pytest.raises(guard.KernelFault):
                tsz.decode_batch(words, npts, window=40)
        with pytest.raises(guard.ComputeError, match="breaker open"):
            tsz.decode_batch(words, npts, window=40)
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=0, dispatch_raise=1.0)):
            with pytest.raises(guard.KernelFault):
                guard.dispatch("block.decode", lambda: words, key="w")
        with pytest.raises(guard.KernelFault, match="quarantined"):
            guard.dispatch("block.decode", lambda: words, key="w")
        assert plain == []
    finally:
        ck.decode_points_plain = real_plain
        guard.reset()
    got = tsz.decode_batch(words, npts, window=40)
    torch.cuda.synchronize()
    assert torch.equal(got["v"], real_plain(words, npts, 40)[2])


# -- the rest of the query path: six functions, caches, Graphite, placement


_FAMILY_TOL = {"deriv": dict(rtol=1e-3, atol=1e-4),
               "predict_linear": dict(rtol=2e-3, atol=1e-2),
               "holt_winters": dict(rtol=2e-3, atol=1e-2)}


def _gauge_grid(seed, s=500, k=139):
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 10.0, (s, k))
    g[rng.random((s, k)) < 0.2] = np.nan
    g[0] = np.nan
    g[1] = 3.0
    return g


@pytest.mark.parametrize("W,stride", [(10, 1), (31, 3)])
def test_six_functions_on_card_match_cpu(cuda, W, stride):
    """changes, resets and quantile_over_time equal the CPU run exactly
    (the same comparisons and stable-argsort indices of the same f32
    residuals); deriv, predict_linear and holt_winters within the
    reference's family bounds (tests/test_plan_compile.py:170-175)."""
    from m3_tpu_torch.ops import temporal as tp

    step = 10 * 10**9
    for g in (_gauge_grid(W), np.cumsum(np.random.default_rng(W).poisson(
            5.0, (500, 139)), axis=1).astype(np.float64)):
        calls = {
            "quantile_over_time": lambda d: tp.quantile_over_time(
                g, W, 0.9, stride, device=d),
            "changes": lambda d: tp.changes(g, W, stride, device=d),
            "resets": lambda d: tp.resets(g, W, stride, device=d),
            "deriv": lambda d: tp.deriv(g, W, step, stride, device=d),
            "predict_linear": lambda d: tp.predict_linear(
                g, W, step, 600.0, stride, device=d),
            "holt_winters": lambda d: tp.holt_winters(
                g, W, 0.3, 0.6, stride, device=d),
        }
        for name, call in calls.items():
            got, want = call(cuda), call("cpu")
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            if name in _FAMILY_TOL:
                np.testing.assert_allclose(got, want, equal_nan=True,
                                           **_FAMILY_TOL[name])
            else:
                np.testing.assert_array_equal(got, want)


def test_content_tier_hits_on_card(cuda):
    """On the card an equal grid in a new object skips the host prep and
    the upload through the content-hash tier; the answers are equal."""
    from m3_tpu_torch.ops import temporal as tp

    g = np.cumsum(np.random.default_rng(5).poisson(5.0, (300, 139)),
                  axis=1).astype(np.float64)
    misses = tp._DERIVED_METRICS.counter("misses").value()
    hits = tp._DERIVED_METRICS.counter("hits").value()
    a = tp.rate(g, 10, 10**10, 10**11, device=cuda)
    b = tp.rate(g.copy(), 10, 10**10, 10**11, device=cuda)
    c = tp.rate(g, 10, 10**10, 10**11, device="cpu")
    assert tp._DERIVED_METRICS.counter("misses").value() == misses + 1
    assert tp._DERIVED_METRICS.counter("hits").value() == hits + 1
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-8, equal_nan=True)


def test_graphite_render_on_card_matches_cpu(cuda):
    from m3_tpu_torch.metrics import carbon
    from m3_tpu_torch.query.graphite import GraphiteEngine

    series, t = promql_corpus(200, 29)
    gseries = {b"bench.h%d.m" % i: {
        "tags": carbon.path_to_tags(b"bench.h%d.m" % i), "t": t,
        "v": series[sid]["v"]} for i, sid in enumerate(series)}
    card = GraphiteEngine(DictStorage(gseries))
    cpu = GraphiteEngine(DictStorage(gseries), device="cpu")
    for target in ("movingAverage(bench.*.m, '5min')",
                   "movingMedian(bench.*.m, '5min')",
                   "movingMax(bench.*.m, 7)", "stdev(bench.*.m, 30)",
                   "perSecond(bench.*.m)"):
        before = wk.window_stat.launches
        got = card.render(target, int(t[60]), int(t[-1]))
        want = cpu.render(target, int(t[60]), int(t[-1]))
        np.testing.assert_array_equal(np.isnan(got.values),
                                      np.isnan(want.values))
        np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                                   atol=1e-8, equal_nan=True)
        grew = wk.window_stat.launches > before
        assert grew == target.startswith(("movingAverage", "movingMax",
                                          "stdev")), target


def test_placement_probe_measures_the_card(cuda):
    from m3_tpu_torch.query.placement import QueryPlacement

    p = QueryPlacement(cuda)
    p._probe_link()
    snap = p.snapshot()
    assert snap["rtt_ms"] is not None and 0 < snap["rtt_ms"] < 1000
    assert snap["d2h_bw_mb_s"] is not None and snap["d2h_bw_mb_s"] > 10
    # Measured: the card at a large evaluation, the host at a tiny one.
    assert p.choose(10**8, 10**6) is None
    assert p.choose(10, 10) == torch.device("cpu")


# -- the compiled plan route: one CUDA graph per plan shape ---------------

PLAN_QUERIES = ("sum by (host) (rate(bench_requests[5m]))",
                "avg_over_time(bench_requests[5m])",
                "quantile_over_time(0.9, bench_requests[5m])",
                "topk(3, irate(bench_requests[1m]))",
                "max_over_time(rate(bench_requests[5m])[10m:1m])")


def _plan_engines(n=300, seed=17):
    series, t = promql_corpus(n, seed, hosts=20, metric=b"bench_requests")
    st = DictStorage(series)
    return Engine(st), Engine(st, device="cpu"), int(t[30]), int(t[-1])


def test_plan_replay_equals_eager_and_cpu(cuda):
    """Each query takes the compiled route on the card; its executable is
    a captured CUDA graph whose replay equals the same body run eagerly
    on the card bit for bit, and the answers equal the CPU plan route's
    (rtol 1e-5, atol 1e-8). The window kernel launches inside the graph
    of an *_over_time (but not quantile_over_time's)."""
    from m3_tpu_torch.parallel import compile as pcompile

    card, cpu, start, end = _plan_engines()
    for q in PLAN_QUERIES:
        before = wk.window_stat.launches
        got = card.execute_range(q, start, end, 30 * 10**9)
        assert card.last_route()["route"] == "compiled", q
        want = cpu.execute_range(q, start, end, 30 * 10**9)
        assert [x.id() for x in got.series_tags] == [
            x.id() for x in want.series_tags], q
        np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                                   atol=1e-8, equal_nan=True, err_msg=q)
        grew = wk.window_stat.launches > before
        assert grew == q.startswith(("avg_", "max_")), q
    on_card = [e for label, e in pcompile.executables()
               if label.endswith(":cuda")]
    assert len(on_card) >= len(PLAN_QUERIES)
    for exe in on_card:
        assert exe.graph is not None and exe.replays >= 1
        assert exe.replay_matches_eager()


def test_plan_lazy_blocks_of_one_executable_keep_their_answers(cuda):
    """Two queries of one plan shape replay one graph; read in reverse
    order, each LazyBlock still holds its own answer."""
    a_series, t = promql_corpus(300, 17, hosts=20, metric=b"bench_requests")
    b_series, _ = promql_corpus(300, 18, hosts=20, metric=b"other")
    st = DictStorage({**a_series, **b_series})
    card, cpu = Engine(st), Engine(st, device="cpu")
    start, end, step = int(t[30]), int(t[-1]), 30 * 10**9
    qa = "sum by (host) (rate(bench_requests[5m]))"
    qb = "sum by (host) (rate(other[5m]))"
    misses = card.execute_range(qa, start, end, step)
    first = card.execute_range(qa, start, end, step)
    second = card.execute_range(qb, start, end, step)
    vb, va = second.values, first.values
    np.testing.assert_array_equal(va, misses.values)
    for vals, q in ((va, qa), (vb, qb)):
        np.testing.assert_allclose(
            vals, cpu.execute_range(q, start, end, step).values, rtol=1e-5,
            atol=1e-8, equal_nan=True)
    assert not np.array_equal(va, vb, equal_nan=True)


def test_plan_tenant_eviction_frees_the_graph(cuda):
    """The `plan` tenant of the shared budget charges each executable's
    pool and static inputs; its evict-one drops the least recently used
    executable and releases its graph."""
    from m3_tpu_torch.parallel import compile as pcompile
    from m3_tpu_torch.utils import hbm

    pcompile.clear()
    card, _, start, end = _plan_engines()
    for q in PLAN_QUERIES[:3]:
        card.execute_range(q, start, end, 30 * 10**9).values
    cached = [e for _, e in pcompile.executables()]
    assert len(cached) == 3 and all(e.charged > 0 for e in cached)
    budget = hbm.shared_budget()
    total = budget.usage()["plan"]
    assert total == sum(e.charged for e in cached)
    oldest = cached[0]
    freed = pcompile._evict_one_plan()
    assert freed > 0 and oldest.graph is None and oldest.charged == 0
    assert budget.usage()["plan"] == total - freed
    assert len(pcompile.executables()) == 2
    pcompile.clear()
    assert budget.usage()["plan"] == 0


def test_plan_fault_on_card_raises_typed_and_quarantines(cuda):
    """An injected device fault on the `plan` route raises a typed
    KernelFault (the port never falls back to the interpreter there) and
    quarantines the shape bucket, which then raises at once."""
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.testing import faultcomp

    card, _, start, end = _plan_engines()
    q = "avg_over_time(bench_requests[5m])"
    guard.reset()
    try:
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=1, dispatch_raise=1.0, route_filter="plan")):
            with pytest.raises(guard.KernelFault):
                card.execute_range(q, start, end, 30 * 10**9)
            assert guard.quarantined_keys("plan")
            with pytest.raises(guard.KernelFault, match="quarantined"):
                card.execute_range(q, start, end, 30 * 10**9)
    finally:
        guard.reset()
    card.execute_range(q, start, end, 30 * 10**9).values
    assert card.last_route()["route"] == "compiled"


AGG_QS = (0.0, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


@pytest.mark.parametrize("w", [128, 256, 1024])
def test_agg_rank_select_on_card_matches_plain(cuda, w):
    """The agg flush's rank selection on the card equals the same torch
    ops on the CPU, index for index, on rows with NaN of both signs, -0.0
    and +0.0, ties, infinities, and empty and full rows."""
    from m3_tpu_torch.ops import aggregation as agg
    from m3_tpu_torch.testing import hostile_rank_rows

    v, c = hostile_rank_rows(w, 2_000, w)
    vt, ct = torch.from_numpy(v), torch.from_numpy(c)
    got = agg.quantile_rank_select(vt.to(cuda), ct.to(cuda), AGG_QS)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), agg.quantile_rank_select(vt, ct, AGG_QS))


def test_aggregator_flush_on_card_equals_cpu(cuda):
    """_agg10x_build's population at 3,000 metrics: the card's emissions
    (both windows and the second stage) equal the CPU's bit for bit."""
    from m3_tpu_torch import testing as T

    out = []
    planes = T.agg10x_planes(3_000)
    for dev in ("cuda", "cpu"):
        lists, elems, _, _ = T.agg10x_build(3_000, dev)
        lst = lists.for_resolution(60 * 10**9)
        T.agg10x_stage(elems, planes)
        rows = []
        cap = lambda m, t, v, p, _r=rows: _r.append((m, t, v))  # noqa: E731
        fwd = T.loopback_forward(lst)
        for s in (120, 180):
            lst.flush(T.AGG_BASE_NS + s * 10**9, cap, fwd)
        out.append(sorted(rows))
    assert out[0] == out[1] and len(out[0]) > 6_000


def test_agg_flush_fault_on_card_raises_typed(cuda):
    """An injected device fault on the `agg_flush` route raises a typed
    KernelFault on the card (no fallback) and is counted once."""
    from m3_tpu_torch.parallel import agg_flush, guard
    from m3_tpu_torch.testing import faultcomp
    from m3_tpu_torch.utils.instrument import ROOT

    buckets = [np.arange(n, dtype=np.float64) for n in (3, 0, 200)]
    counts = np.array([3, 0, 200])
    key = "telemetry.compute.faults{kind=kernel,route=agg_flush}"
    guard.reset()
    before = ROOT.snapshot().get(key, 0)
    try:
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=1, dispatch_raise=1.0, route_filter="agg_flush")):
            with pytest.raises(guard.KernelFault):
                agg_flush.exact_quantile_values(buckets, counts, (0.5,))
    finally:
        guard.reset()
    assert ROOT.snapshot().get(key, 0) - before == 1
    vals = agg_flush.exact_quantile_values(buckets, counts, (0.5,))
    assert vals[:, 0].tolist() == [1.0, 0.0, 99.0]


def test_rules_compare_on_card_is_f32(cuda):
    """The rules engine's compare at 4,096 cells or more runs on the
    engine's device in f32: on the card it equals the CPU's torch compare,
    so 1.0 + 2**-30 > 1.0 does not fire there."""
    from m3_tpu_torch.coordinator.rules_engine import _compile_compare

    rng = np.random.default_rng(5)
    vals = rng.standard_normal((400, 20))
    vals[rng.random((400, 20)) < 0.1] = np.nan
    th = np.quantile(vals[np.isfinite(vals)], [0.1, 0.5, 0.9])
    for op in (">", "<=", "!="):
        assert np.array_equal(_compile_compare(op, cuda)(vals, th),
                              _compile_compare(op, torch.device("cpu"))(
                                  vals, th))
    big = np.full((100, 50), 1.0 + 2.0 ** -30)
    assert not _compile_compare(">", cuda)(big, np.array([1.0])).any()


# ---------------------------------------------------------------------------
# the durable path: blooms, WAL replay and recovered blocks on the card
# ---------------------------------------------------------------------------


def _durable_dir(root, n=300):
    """A CPU database's commit log and flushed filesets: one sealed,
    flushed 2 h block and one warm block in the WAL, abandoned."""
    import os

    from m3_tpu_torch.persist import commitlog as cl
    from m3_tpu_torch.persist.fs import PersistManager
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    now = {"t": _T0 + 60 * 10**9}
    log = cl.CommitLog(os.path.join(root, "cl"))
    db = Database(ShardSet(4), commitlog=log, clock=lambda: now["t"],
                  device="cpu")
    db.ensure_namespace(b"d", NamespaceOptions(index_enabled=False))
    pm = PersistManager(os.path.join(root, "data"))
    ids = [b"dur-%05d" % i for i in range(n)]
    vals = np.random.default_rng(83).standard_normal((2, n))
    db.write_batch(b"d", ids, np.full(n, _T0), vals[0])
    now["t"] = _T0 + _BLOCK + 11 * 60 * 10**9
    db.tick()
    assert db.flush(pm) == 4
    db.write_batch(b"d", ids, np.full(n, now["t"]), vals[1])
    log.flush()
    return pm, os.path.join(root, "cl"), ids, now


def _recover_on(device, pm, cl_dir, now):
    from m3_tpu_torch.storage.bootstrap import BootstrapContext, BootstrapProcess
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions

    db = Database(ShardSet(4), clock=lambda: now["t"], device=device)
    db.ensure_namespace(b"d", NamespaceOptions(index_enabled=False))
    BootstrapProcess(chain=("filesystem", "commitlog"), ctx=BootstrapContext(
        persist=pm, commitlog_dir=cl_dir,
        shard_lookup=db.shard_set.lookup)).run(db, now_ns=now["t"])
    return db


def test_bloom_on_card_equals_cpu(cuda):
    from m3_tpu_torch.utils.bloom import BloomFilter

    ids = prometheus_ids(20_000, np.random.default_rng(3)) + [b"", b"x" * 700]
    gpu, cpu = (BloomFilter.for_capacity(len(ids)) for _ in range(2))
    ck.reset_launch_counts()
    gpu.add_batch(ids, device=cuda)
    assert ck.launch_counts()["hash"] == 2
    cpu.add_batch(ids, device="cpu")
    assert gpu.tobytes() == cpu.tobytes()
    assert all(sid in gpu for sid in ids[:200])


def test_replay_and_recovered_blocks_on_card_equal_cpu(cuda, fresh_cache,
                                                       tmp_path):
    """The WAL replay routes its chunks through the hash kernel, the
    filesystem bootstrap hashes each bloom there, and the recovered
    blocks decode on the card: registries, buffers and every read equal
    a CPU bootstrap of the same dir bit for bit."""
    pm, cl_dir, ids, now = _durable_dir(str(tmp_path))
    ck.reset_launch_counts()
    gpu = _recover_on(cuda, pm, cl_dir, now)
    counts = ck.launch_counts()
    assert counts["hash"] >= 4 + 1  # a bloom a fileset, a launch a chunk
    cpu = _recover_on("cpu", pm, cl_dir, now)
    for s, shard in gpu.namespace(b"d").shards.items():
        other = cpu.namespace(b"d").shards[s]
        assert shard.registry.all_ids() == other.registry.all_ids()
        for bstart, blk in shard.blocks.items():
            a, b = blk.read_all(), other.blocks[bstart].read_all()
            for x, y in zip(a, b):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    before = ck.launch_counts()["decode"]
    end = now["t"] + 1
    for sid in ids:
        ga, ca = gpu.read(b"d", sid, 0, end), cpu.read(b"d", sid, 0, end)
        assert len(ga[0]) == 2
        assert ga[0].tobytes() == ca[0].tobytes()
        assert ga[1].tobytes() == ca[1].tobytes()
    assert ck.launch_counts()["decode"] > before


def test_cold_read_through_retriever_on_card(cuda, fresh_cache, tmp_path):
    """Flush, evict, then every read through the retriever on the card
    (one decode launch of one row a miss) equals the pre-eviction read;
    later passes hit the WiredList, and the third reads the block cache's
    planes without a launch."""
    from m3_tpu_torch.persist.fs import PersistManager
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.retriever import BlockRetriever

    now = {"t": _T0}
    pm = PersistManager(str(tmp_path))
    retr = BlockRetriever(pm, device=cuda)
    db = Database(ShardSet(4), clock=lambda: now["t"], retriever=retr)
    db.ensure_namespace(b"d", NamespaceOptions(index_enabled=False))
    ids = [b"cold-%04d" % i for i in range(200)]
    for j in range(6):
        now["t"] = _T0 + j * 10**10
        db.write_batch(b"d", ids, np.full(200, now["t"]),
                       np.full(200, float(j)) + np.arange(200))
    now["t"] = _T0 + _BLOCK + 11 * 60 * 10**9
    db.tick()
    want = [db.read(b"d", sid, 0, now["t"]) for sid in ids]
    assert db.flush(pm) == 4 and db.evict_flushed() == 4
    passes, launches = [], []
    for _ in range(3):
        before = ck.launch_counts()["decode"]
        passes.append([db.read(b"d", sid, 0, now["t"]) for sid in ids])
        launches.append(ck.launch_counts()["decode"] - before)
    # A miss decodes its row; the second touch of a wired row admits it to
    # the block cache (one more decode); the third reads the cached plane.
    assert launches == [len(ids), len(ids), 0]
    assert retr.stats["seeks"] == len(ids)
    assert retr.stats["wired_hits"] == 2 * len(ids)
    for got in passes:
        for (wt, wv), (gt, gv) in zip(want, got):
            assert wt.tobytes() == gt.tobytes()
            assert wv.tobytes() == gv.tobytes()


def test_hash_fault_on_the_bloom_route_raises_typed(cuda):
    """No fallback to a host hash: a fault injected on codec.hash while a
    bloom hashes on the card raises the guard's typed error."""
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.testing import faultcomp
    from m3_tpu_torch.utils.bloom import BloomFilter

    guard.reset()
    try:
        plan = faultcomp.ComputeFaultPlan(seed=0, route_filter="codec.hash",
                                          dispatch_raise=1.0)
        with faultcomp.injected(plan):
            with pytest.raises(guard.ComputeError):
                BloomFilter(1 << 12, 4).add_batch([b"a", b"b"], device=cuda)
    finally:
        guard.reset()


def _cluster_run(device, root):
    """A 3-node RF=3 cluster on `device`: 64 tagged series x 12 points at
    ALL, sealed, 2 buffered points; then (fetch_tagged, a joiner's peers
    bootstrap words, node0's rows after one value diverged and a repair)."""
    from m3_tpu_torch.client import Session, SessionOptions
    from m3_tpu_torch.cluster.topology import ConsistencyLevel
    from m3_tpu_torch.index import query as iq
    from m3_tpu_torch.storage import bootstrap as bs
    from m3_tpu_torch.storage.block import encode_block
    from m3_tpu_torch.storage.buffer import to_dense
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.storage.namespace import NamespaceOptions
    from m3_tpu_torch.storage.repair import ShardRepairer
    from m3_tpu_torch.testing.cluster import ClusterHarness

    block = 2 * 3600 * 10**9
    t0 = (1_600_000_000 * 10**9 // block) * block
    h = ClusterHarness(3, 3, 8, start_ns=t0 + 120 * 10**9, data_root=root,
                       device=device)
    s = Session(h.topology, SessionOptions(
        timeout_s=30, write_consistency=ConsistencyLevel.ALL), device=device)
    try:
        ids = [b"c.%02d" % i for i in range(64)]
        vals = np.random.default_rng(5).standard_normal((12, 64))
        for k in range(12):
            s.write_batch(b"default", ids, np.full(64, t0 + k * 10**10),
                          vals[k], [{b"__name__": b"c"}] * 64)
        h.clock.advance(block + 11 * 60 * 10**9)
        h.tick_all()
        now = h.clock.now_ns
        s.write_batch(b"default", ids, np.full(64, now), vals[0],
                      [{b"__name__": b"c"}] * 64)
        got = s.fetch_tagged(b"default", iq.TermQuery(b"__name__", b"c"),
                             0, now + 1)
        fetched = {k: (v["t"].tobytes(), v["v"].tobytes())
                   for k, v in got.items()}
        joiner = Database(ShardSet(8), clock=h.clock, device=device)
        joiner.create_namespace(b"default", NamespaceOptions(
            index_enabled=False))
        bs.BootstrapProcess(chain=("peers",), ctx=bs.BootstrapContext(
            session=s, placement=h.placement_svc.get(),
            host_id="joiner")).run(joiner)
        words = {(sid, st): np.asarray(b.words).tobytes()
                 for sid, sh in joiner.namespace(b"default").shards.items()
                 for st, b in sh.blocks.items()}
        node0 = h.nodes["node0"].db
        shard_id = node0.shard_set.lookup(ids[3])
        shard = node0.namespace(b"default").shards[shard_id]
        blk = shard.blocks[t0]
        ts, vs, npts = blk.read_all()
        vs = np.array(vs)
        vs[blk.row_of(shard.registry.get(ids[3])), 2] += 1.0
        mask = np.arange(ts.shape[1]) < npts[:, None]
        shard.blocks[t0] = encode_block(t0, *to_dense(
            np.repeat(blk.series_indices, npts), ts[mask], vs[mask]),
            device=device)
        stats = ShardRepairer(s, host_id="node0").repair_shard(
            node0.namespace(b"default"), shard_id, t0, t0 + block)
        healed = np.asarray(shard.blocks[t0].words).tobytes()
        peer = np.asarray(h.nodes["node1"].db.namespace(b"default")
                          .shards[shard_id].blocks[t0].words).tobytes()
        return fetched, words, healed, peer, stats
    finally:
        s.close()
        h.close()


def test_cluster_on_card_equals_cpu(cuda, tmp_path):
    before = ck.launch_counts()
    card = _cluster_run("cuda", str(tmp_path / "card"))
    after = ck.launch_counts()
    host = _cluster_run("cpu", str(tmp_path / "host"))
    assert all(after[k] > before[k] for k in ("pack", "decode", "hash"))
    assert card[0] == host[0] and len(card[0]) == 64
    assert card[1] == host[1] and card[1]
    assert card[2] == card[3] == host[2] == host[3]
    assert card[4].blocks_rebuilt == host[4].blocks_rebuilt == 1


def test_run_dbnode_defaults_to_the_card(cuda, fresh_cache, tmp_path):
    """run_dbnode with no device runs the node and its embedded
    coordinator on the card: a write_batch routes through K3, the tick's
    seal packs through K1 and a read of the sealed block decodes through
    K2, bit for bit the written points."""
    from m3_tpu_torch.services import load_dict, run_dbnode

    now = {"t": _T0}
    h = run_dbnode(load_dict({"data_dir": str(tmp_path / "node"),
                              "num_shards": 4, "coordinator": {}}, "dbnode"),
                   clock=lambda: now["t"])
    try:
        assert h.db.device.type == "cuda"
        assert h.coordinator.engine.device.type == "cuda"
        assert h.server.service.device.type == "cuda"
        ids = [b"svc-%03d" % i for i in range(64)]
        ck.reset_launch_counts()
        for j in range(6):
            now["t"] = _T0 + j * 10**10
            h.db.write_batch(b"default", ids, np.full(64, now["t"]),
                             np.arange(64) * 0.5 + j)
        assert ck.launch_counts()["hash"] >= 6
        now["t"] = _T0 + _BLOCK + 11 * 60 * 10**9
        assert h.db.tick()["sealed"] > 0
        assert ck.launch_counts()["pack"] > 0
        before = ck.launch_counts()["decode"]
        for i, sid in enumerate(ids):
            t, v = h.db.read(b"default", sid, 0, now["t"])
            assert t.tolist() == [_T0 + j * 10**10 for j in range(6)]
            assert v.tolist() == [i * 0.5 + j for j in range(6)]
        assert ck.launch_counts()["decode"] > before
    finally:
        h.close()
