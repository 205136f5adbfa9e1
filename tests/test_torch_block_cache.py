"""The port's device block cache (m3_tpu_torch/storage/block_cache.py) and
shared HBM budget (m3_tpu_torch/utils/hbm.py) on CPU tensors: the scenarios
of tests/test_block_cache.py — cached-decode bit-identity against the
uncached path over seeded cases, admission after repeated touch, frozen
planes, the seal/merge/expiry/wired-list/close invalidation matrix, the
racing-seal re-pin refusal, retained seal tensors, budget-driven eviction
across tenants and the lock-free finalizer release — plus the isolation of
the port's process cache and budget from the reference's.

Reads compare bit for bit (no tolerance): a cached read must equal the
cache-bypassed decode exactly. Blocks seal and decode on device="cpu",
where the kernels' plain versions run. The reference's evict-flushed case
needs the disk retriever, which the port does not have yet; its
load_block replacement case is kept."""

import gc

import numpy as np
import pytest
import torch

from m3_tpu_torch.storage import block_cache
from m3_tpu_torch.storage.block import WiredList, encode_block
from m3_tpu_torch.storage.block_cache import DeviceBlockCache
from m3_tpu_torch.storage.shard import Shard, ShardOptions
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hbm import HBMBudget

CPU = "cpu"

BLOCK = 2 * xtime.HOUR
T0 = (1_700_000_000 * 1_000_000_000 // BLOCK) * BLOCK
S_NS = xtime.SECOND


@pytest.fixture()
def cache(monkeypatch):
    """A fresh, isolated cache installed as the process cache, with its
    own budget (no cross-test residency, no shared-budget coupling)."""
    budget = HBMBudget(64 * 1024 * 1024)
    c = DeviceBlockCache(budget=budget, admit_after=2)
    monkeypatch.setattr(block_cache, "_CACHE", c)
    return c


def make_block(rng, s=None, w=None, bs=T0):
    """Seeded sealed block: regular grid, per-series npoints, rows padded
    with the last real point per the codec contract. Fewer rows than the
    reference test draws (2-11, not 2-23): a cold per-row read runs the
    decode kernel's plain version, a Python loop over the window."""
    s = int(rng.integers(2, 12)) if s is None else s
    w = int(rng.integers(4, 90)) if w is None else w
    ts = bs + np.arange(w, dtype=np.int64)[None, :] * 10 * S_NS \
        + np.zeros((s, 1), np.int64)
    vals = rng.standard_normal((s, w)) * 100
    # Mix in int-mode-friendly rows (both codec modes exercised).
    vals[:: 2] = np.round(vals[:: 2])
    npoints = rng.integers(1, w + 1, size=s).astype(np.int32)
    for i in range(s):
        n = npoints[i]
        ts[i, n:] = ts[i, n - 1]
        vals[i, n:] = vals[i, n - 1]
    return encode_block(bs, np.arange(s, dtype=np.int32), ts, vals, npoints,
                        device=CPU)


def as_tensors(blk):
    """The block's words and npoints as the (words, npoints) tensors a
    seal leaves for the cache (int32 u32 bit patterns)."""
    return (torch.from_numpy(blk.words.view(np.int32).copy()),
            torch.from_numpy(blk.npoints.astype(np.int32)))


def read_rows(blk):
    return [blk.read(int(sidx)) for sidx in blk.series_indices]


class TestCachedDecodeBitIdentity:
    @pytest.mark.parametrize("seed", range(10))
    def test_per_series_reads_identical(self, seed, cache):
        rng = np.random.default_rng(seed)
        blk = make_block(rng)
        with block_cache.disabled():
            want = read_rows(blk)
        # Touch past admission, then read every row from the cached plane.
        read_rows(blk)
        read_rows(blk)
        assert cache.stats()["admitted"] >= 1
        got = read_rows(blk)
        assert cache.stats()["hits"] > 0
        for (wt, wv), (gt, gv) in zip(want, got):
            assert np.array_equal(wt, gt) and wt.dtype == gt.dtype
            assert np.array_equal(wv, gv) and wv.dtype == gv.dtype

    @pytest.mark.parametrize("seed", range(6))
    def test_read_all_identical(self, seed, cache):
        rng = np.random.default_rng(100 + seed)
        blk = make_block(rng)
        with block_cache.disabled():
            wt, wv, wn = blk.read_all()
        blk.read_all()
        gt, gv, gn = blk.read_all()  # second touch: admitted, from cache
        ht, hv, hn = blk.read_all()  # pure hit
        for t, v, n in ((gt, gv, gn), (ht, hv, hn)):
            assert np.array_equal(wt, t) and np.array_equal(wv, v)
            assert np.array_equal(wn, n)
        assert cache.stats()["hits"] >= 1

    def test_cached_planes_are_frozen(self, cache):
        blk = make_block(np.random.default_rng(0))
        blk.read_all()
        t, v, _ = blk.read_all()
        with pytest.raises(ValueError):
            v[0, 0] = 1.0
        with pytest.raises(ValueError):
            t[0, 0] = 1

    def test_admission_requires_repeat_touch(self, cache):
        blk = make_block(np.random.default_rng(1))
        assert blk.read(0) is not None  # touch 1: no admission
        assert cache.stats()["admitted"] == 0
        assert len(cache) == 0
        blk.read(0)  # touch 2: whole-block decode admitted
        assert cache.stats()["admitted"] == 1

    def test_disabled_bypass_serves_and_caches_nothing(self, cache):
        blk = make_block(np.random.default_rng(2))
        with block_cache.disabled():
            for _ in range(4):
                blk.read_all()
        assert cache.stats() == {
            "hits": 0, "misses": 0, "evictions": 0, "invalidations": 0,
            "admitted": 0, "retained": 0, "entries": 0, "bytes": 0}


class TestShardReadPath:
    def make_shard(self, cache, n=20):
        shard = Shard(0, ShardOptions(), namespace_name=b"t", device=CPU)
        ids = [b"s-%03d" % i for i in range(n)]
        for step in range(12):
            t = T0 + step * xtime.MINUTE
            shard.write_batch(ids, np.full(n, t, np.int64),
                              np.arange(n, dtype=np.float64) + step, t)
        shard.tick(T0 + BLOCK + 11 * xtime.MINUTE)
        assert shard.blocks
        return shard, ids

    def test_shard_reads_bit_identical_and_hit(self, cache):
        shard, ids = self.make_shard(cache)
        span = (T0 - xtime.MINUTE, T0 + BLOCK)
        with block_cache.disabled():
            want = [shard.read(sid, *span) for sid in ids]
        for _ in range(3):
            got = [shard.read(sid, *span) for sid in ids]
        assert cache.stats()["hits"] > 0
        for (wt, wv), (gt, gv) in zip(want, got):
            assert np.array_equal(wt, gt) and np.array_equal(wv, gv)

    def test_same_start_reseal_invalidates_and_serves_merged(self, cache):
        """The seal/merge drop hook: a re-seal replaces the block; the old
        generation's residency dies and reads see the merged content."""
        shard, ids = self.make_shard(cache)
        bs = next(iter(shard.blocks))
        old = shard.blocks[bs]
        shard.read(ids[0], T0, T0 + BLOCK)
        shard.read(ids[0], T0, T0 + BLOCK)  # admit old block's plane
        assert cache.stats()["bytes"] > 0
        # Late drain racing the seal (test_write_path's arrangement).
        idx, _ = shard.registry.get_or_create(b"late")
        shard.buffer.write_batch(np.array([idx], np.int32),
                                 np.array([bs + 2 * xtime.MINUTE], np.int64),
                                 np.array([42.0]))
        shard.tick(T0 + BLOCK + 12 * xtime.MINUTE)
        merged = shard.blocks[bs]
        assert merged is not old
        assert cache.stats()["invalidations"] >= 1
        # Old generation is dead: no entry for it survives or can return.
        with cache._lock:
            assert old.gen not in cache._entries
            assert old.gen in cache._dead
        t, v = shard.read(b"late", bs, bs + BLOCK)
        np.testing.assert_array_equal(v, [42.0])
        # Warm the merged block and check it serves identically.
        with block_cache.disabled():
            want = shard.read(ids[3], bs, bs + BLOCK)
        shard.read(ids[3], bs, bs + BLOCK)
        got = shard.read(ids[3], bs, bs + BLOCK)
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])

    def test_expiry_drops_residency(self, cache):
        shard, ids = self.make_shard(cache)
        shard.read(ids[0], T0, T0 + BLOCK)
        shard.read(ids[0], T0, T0 + BLOCK)
        assert cache.stats()["bytes"] > 0
        shard.tick(T0 + shard.opts.retention_ns + 2 * BLOCK)
        assert not shard.blocks
        assert cache.stats()["bytes"] == 0
        assert cache.stats()["invalidations"] >= 1

    def test_load_block_replacement_invalidates(self, cache):
        shard, ids = self.make_shard(cache)
        bs = next(iter(shard.blocks))
        old = shard.blocks[bs]
        shard.read(ids[0], T0, T0 + BLOCK)
        shard.read(ids[0], T0, T0 + BLOCK)
        assert cache.stats()["bytes"] > 0
        replacement = make_block(np.random.default_rng(9), bs=bs)
        shard.load_block(replacement)
        with cache._lock:
            assert old.gen not in cache._entries

    def test_close_leaves_zero_residency(self, cache):
        shard, ids = self.make_shard(cache)
        shard.read(ids[0], T0, T0 + BLOCK)
        shard.read(ids[0], T0, T0 + BLOCK)
        assert cache.stats()["bytes"] > 0
        shard.close()
        assert cache.stats()["bytes"] == 0
        assert len(cache) == 0


class TestRacingSealRepin:
    def test_put_refused_for_dead_generation(self, cache):
        """A query holding a block object across a seal must never re-pin
        the dropped generation (the postings-cache hazard): the
        decode still returns correct data, but nothing stays resident."""
        blk = make_block(np.random.default_rng(5), s=6, w=24)
        with block_cache.disabled():
            want = read_rows(blk)
        blk.read(0)  # touch 1
        cache.invalidate_block(blk)  # the seal drops the generation
        for _ in range(4):  # way past admit_after
            got = read_rows(blk)
        for (wt, wv), (gt, gv) in zip(want, got):
            assert np.array_equal(wt, gt) and np.array_equal(wv, gv)
        assert len(cache) == 0
        assert cache.stats()["bytes"] == 0

    def test_retain_refused_for_dead_generation(self, cache):
        blk = make_block(np.random.default_rng(6))
        blk._encoded_dev = as_tensors(blk)
        cache.invalidate_block(blk)
        assert cache.retain_encoded(blk, b"t", 0) is False
        assert cache.stats()["bytes"] == 0


class TestRetainedEncoded:
    def test_seal_retains_and_serves_bit_identical(self, cache, monkeypatch):
        """M3_TPU_BLOCK_CACHE_RETAIN=1: the seal hands its encoded device
        buffers to the cache and admission decodes FROM them — results
        bit-identical to the host-words decode."""
        monkeypatch.setenv("M3_TPU_BLOCK_CACHE_RETAIN", "1")
        shard = Shard(0, ShardOptions(), namespace_name=b"t", device=CPU)
        ids = [b"r-%02d" % i for i in range(8)]
        for step in range(6):
            t = T0 + step * xtime.MINUTE
            shard.write_batch(ids, np.full(8, t, np.int64),
                              np.full(8, 1.5 * step), t)
        shard.tick(T0 + BLOCK + 11 * xtime.MINUTE)
        assert cache.stats()["retained"] >= 1
        bs = next(iter(shard.blocks))
        blk = shard.blocks[bs]
        words, npoints = cache.encoded(blk)
        # The seal's own tensors: padded rows, charged by element size.
        assert words.dtype == torch.int32 and words.shape == (8, 33)
        assert cache.resident_bytes() == 8 * 33 * 4 + 8 * 4
        np.testing.assert_array_equal(words[:8].numpy().view(np.uint32),
                                      blk.words)
        with block_cache.disabled():
            want = read_rows(blk)
        read_rows(blk)
        got = read_rows(blk)  # admitted: decoded from retained buffers
        assert cache.stats()["admitted"] >= 1
        for (wt, wv), (gt, gv) in zip(want, got):
            assert np.array_equal(wt, gt) and np.array_equal(wv, gv)

    def test_retain_disabled_keeps_no_device_handle(self, cache,
                                                    monkeypatch):
        monkeypatch.setenv("M3_TPU_BLOCK_CACHE_RETAIN", "0")
        blk = make_block(np.random.default_rng(7))
        assert not hasattr(blk, "_encoded_dev")
        assert cache.retain_encoded(blk, b"t", 0) is False


class TestAdmissionRaces:
    def test_decoded_plane_supersedes_retained_encode(self, cache):
        """Once a block's decoded planes are resident, the retained
        encode buffers are released — a hot block never double-charges
        the budget."""
        blk = make_block(np.random.default_rng(21))
        blk._encoded_dev = as_tensors(blk)
        assert cache.retain_encoded(blk, b"t", 0)
        enc_bytes = cache.resident_bytes()
        assert enc_bytes == blk.words.nbytes + blk.npoints.size * 4
        blk.read_all()
        blk.read_all()  # admission
        assert cache.encoded(blk) is None
        ts, vals, _ = blk.read_all()
        assert cache.resident_bytes() == ts.nbytes + vals.nbytes

    def test_concurrent_admission_single_flight(self, cache):
        """A thread burst crossing the admission threshold decodes once
        (single-flight); every thread still reads correct data."""
        import concurrent.futures as cf
        import threading

        blk = make_block(np.random.default_rng(22), s=16, w=32)
        with block_cache.disabled():
            want = blk.read(0)
        n_decodes = [0]
        real = blk._decode_plane
        decode_lock = threading.Lock()

        def counting_decode(encoded=None):
            with decode_lock:
                n_decodes[0] += 1
            return real(encoded)

        blk._decode_plane = counting_decode
        errors = []

        def reader(_):
            try:
                for _ in range(20):
                    got = blk.read(0)
                    assert np.array_equal(want[0], got[0])
                    assert np.array_equal(want[1], got[1])
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        with cf.ThreadPoolExecutor(8) as ex:
            list(ex.map(reader, range(8)))
        assert not errors, errors
        assert cache.stats()["admitted"] == 1
        assert n_decodes[0] == 1  # no stampede


class TestWiredListHooks:
    def test_drop_and_evict_invalidate(self, cache):
        rng = np.random.default_rng(8)
        b1, b2 = make_block(rng, s=4, w=16), make_block(rng, s=4, w=16)
        wl = WiredList(max_bytes=max(b1.nbytes(), b2.nbytes()) + 1)
        wl.put(("ns", 0, T0, b"a"), b1)
        b1.read_all()
        b1.read_all()
        assert cache.stats()["bytes"] > 0
        wl.put(("ns", 0, T0, b"b"), b2)  # evicts b1 from the wired list
        with cache._lock:
            assert b1.gen not in cache._entries
        b2.read_all()
        b2.read_all()
        assert cache.stats()["bytes"] > 0
        assert wl.drop(lambda k: True) == 1
        assert cache.stats()["bytes"] == 0


class TestBudget:
    def test_eviction_under_tiny_budget(self, monkeypatch):
        budget = HBMBudget(4096)
        c = DeviceBlockCache(budget=budget, admit_after=1)
        monkeypatch.setattr(block_cache, "_CACHE", c)
        rng = np.random.default_rng(11)
        blocks = [make_block(rng, s=8, w=64) for _ in range(4)]
        for blk in blocks:
            blk.read_all()
        assert c.stats()["evictions"] >= 1
        # Reclaim keeps the resident total inside the budget (every plane
        # here is larger than the budget, so at most the newest survives
        # only if it fits — with these sizes nothing does).
        assert c.resident_bytes() <= max(
            budget.limit, max(b.nbytes() for b in blocks) * 16)
        # Reads stay correct throughout.
        with block_cache.disabled():
            want = blocks[0].read(0)
        got = blocks[0].read(0)
        assert np.array_equal(want[0], got[0])
        assert np.array_equal(want[1], got[1])

    def test_reclaim_rotates_across_tenants(self):
        budget = HBMBudget(100)
        state = {"a": 300, "b": 300}
        calls = {"a": 0, "b": 0}

        def evict(name):
            def fn():
                calls[name] += 1
                freed = min(50, state[name])
                state[name] -= freed
                return freed
            return fn

        budget.register("a", lambda: state["a"], evict("a"))
        budget.register("b", lambda: state["b"], evict("b"))
        freed = budget.reclaim()
        assert freed >= 500
        assert budget.total() <= budget.limit
        assert calls["a"] > 0 and calls["b"] > 0  # both tenants shrank

    def test_reclaim_terminates_when_nothing_evictable(self):
        budget = HBMBudget(10)
        budget.register("stuck", lambda: 1000, lambda: 0)
        assert budget.reclaim() == 0  # no progress -> no spin

    def test_pressure_zero_within_budget(self):
        budget = HBMBudget(100)
        budget.register("t", lambda: 100)
        assert budget.pressure() == 0.0
        budget.register("t", lambda: 150)
        assert budget.pressure() == pytest.approx(0.5)
        budget.register("t", lambda: 500)
        assert budget.pressure() == 1.0

    def test_budgeted_put_charges_for_lifetime(self):
        budget = HBMBudget(1 << 30)
        arr = np.arange(1024, dtype=np.float32)
        dev = budget.device_put(arr, CPU)
        assert isinstance(dev, torch.Tensor) and dev.device.type == CPU
        assert budget.usage()["transient"] == 1024 * 4
        del dev
        gc.collect()
        assert budget.usage()["transient"] == 0

    def test_finalizer_release_is_lock_free(self):
        """A GC-run finalizer may fire while the budget lock is held: the
        release path must not acquire it (it appends to a pending list
        the usage probe drains)."""
        budget = HBMBudget(1 << 20)
        with budget._lock:
            budget._release_transient(123)  # must not deadlock
        budget._transient = 123
        assert budget._transient_usage() == 0

    def test_dead_usage_probe_reads_zero(self):
        budget = HBMBudget(100)

        def boom():
            raise RuntimeError("probe died")

        budget.register("dead", boom)
        assert budget.total() == 0
        assert budget.pressure() == 0.0

    def test_device_put_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HBMBudget(1 << 20).device_put(np.zeros(4))


class TestRetainPolicy:
    def test_wants_encoded_follows_the_seal_device(self, cache, monkeypatch):
        monkeypatch.delenv("M3_TPU_BLOCK_CACHE_RETAIN", raising=False)
        assert block_cache.wants_encoded(torch.device("cuda"))
        assert not block_cache.wants_encoded(torch.device(CPU))
        monkeypatch.setenv("M3_TPU_BLOCK_CACHE_RETAIN", "1")
        assert block_cache.wants_encoded(torch.device(CPU))
        monkeypatch.setenv("M3_TPU_BLOCK_CACHE_RETAIN", "0")
        assert not block_cache.wants_encoded(torch.device("cuda"))
        with block_cache.disabled():
            monkeypatch.delenv("M3_TPU_BLOCK_CACHE_RETAIN")
            assert not block_cache.wants_encoded(torch.device("cuda"))

    def test_cpu_seal_retains_nothing_by_default(self, cache, monkeypatch):
        monkeypatch.delenv("M3_TPU_BLOCK_CACHE_RETAIN", raising=False)
        blk = make_block(np.random.default_rng(31))
        assert not hasattr(blk, "_encoded_dev")

    def test_retained_charge_released_on_close(self, cache, monkeypatch):
        monkeypatch.setenv("M3_TPU_BLOCK_CACHE_RETAIN", "1")
        shard = Shard(0, ShardOptions(), namespace_name=b"t", device=CPU)
        ids = [b"k-%02d" % i for i in range(5)]
        shard.write_batch(ids, np.full(5, T0, np.int64), np.arange(5.0), T0)
        shard.tick(T0 + BLOCK + 11 * xtime.MINUTE)
        words, npoints = cache.encoded(next(iter(shard.blocks.values())))
        charged = words.numel() * 4 + npoints.numel() * 4
        assert cache.budget.total() == cache.resident_bytes() == charged
        shard.close()
        assert cache.budget.total() == cache.resident_bytes() == 0


class TestIsolationFromTheReference:
    def test_process_cache_and_budget_are_the_ports_own(self):
        """A process that imports both packages keeps two caches, two
        budgets and two health trackers: reads through the port move only
        the port's counters."""
        from m3_tpu.storage import block_cache as ref_cache
        from m3_tpu.utils import health as ref_health
        from m3_tpu.utils import hbm as ref_hbm
        from m3_tpu_torch.utils import health, hbm

        assert block_cache.get_cache() is not ref_cache.get_cache()
        assert hbm.shared_budget() is not ref_hbm.shared_budget()
        assert health.TRACKER is not ref_health.TRACKER
        assert "hbm_pressure" in health.TRACKER._sources
        before = ref_cache.get_cache().stats()
        blk = make_block(np.random.default_rng(41))
        for _ in range(3):
            blk.read_all()
        assert block_cache.get_cache().stats()["hits"] >= 1
        assert ref_cache.get_cache().stats() == before
