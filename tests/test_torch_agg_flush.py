"""The aggregator flush's quantile ordering (m3_tpu_torch/parallel/
agg_flush.py, m3_tpu_torch/ops/aggregation.quantile_rank_select) on the
CPU against the reference's (m3_tpu/parallel/agg_flush.py,
m3_tpu/ops/aggregation.quantile_rank_select).

Tolerance: none. The selection returns integer indices and the gather
reads exact f64 values, so indices and values are held equal bit for bit
(NaN equal to NaN) on seeded ragged buckets with NaN, -0.0/+0.0, ties and
empty rows at widths 128 to 1024, and the rank rule ceil(q*n) (q*n in
f32, as the reference computes it without x64) for every n in 1..100,000.
A fault on the `agg_flush` guard route raises typed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3_tpu.aggregator import list as jlist
from m3_tpu.ops import aggregation as jagg
from m3_tpu.parallel import agg_flush as jflush
from m3_tpu_torch.aggregator import list as tlist
from m3_tpu_torch.ops import aggregation as tagg
from m3_tpu_torch.parallel import agg_flush, guard
from m3_tpu_torch.testing import faultcomp, hostile_rank_rows
from m3_tpu_torch.utils import numwatch
from m3_tpu_torch.utils.instrument import ROOT

QS = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def hostile_buckets(seed: int, n: int = 120, max_len: int = 900):
    """Ragged f64 buckets: empty ones, NaN-bearing ones, ties, signed
    zeros, lengths up to max_len (tiles of 128 to 1024 columns)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        nv = 0 if k == 0 else int(rng.integers(1, 14)) if k < 3 else \
            int(rng.integers(1, max_len))
        b = rng.lognormal(0, 1, nv)
        if nv and rng.random() < 0.4:
            b[rng.integers(0, nv, max(1, nv // 20))] = np.nan
        if nv and rng.random() < 0.3:
            b[::2] = np.round(b[::2])
        if nv and rng.random() < 0.2:
            b[rng.integers(0, nv, 2)] = rng.choice([0.0, -0.0], 2)
        out.append(b)
    return out


@pytest.mark.parametrize("w", [128, 256, 512, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_rank_select_equals_reference(seed, w):
    v, c = hostile_rank_rows(seed, 257, w)
    want = np.asarray(jagg.quantile_rank_select(jnp.asarray(v),
                                                jnp.asarray(c), QS))
    got = tagg.quantile_rank_select(torch.from_numpy(v), torch.from_numpy(c),
                                    QS)
    assert got.dtype == torch.int32 and got.shape == (257, len(QS))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95, 0.99, 0.999])
def test_rank_rule_for_every_count(q):
    """ceil(q*n) in f32 for every n in 1..100,000 (in f64, q = 0.999
    would pick another rank at 108 counts, the first at n = 32,999)."""
    n = np.arange(1, 100_001, dtype=np.int32)
    want = np.asarray(jnp.clip(jnp.maximum(
        jnp.ceil(q * jnp.asarray(n)).astype(jnp.int32), 1) - 1, 0, 100_000))
    got = tagg._rank_index(q, torch.from_numpy(n), 100_001)
    np.testing.assert_array_equal(got.numpy(), want)
    if q == 0.999:
        f64 = np.maximum(np.ceil(q * n.astype(np.float64)).astype(np.int64),
                         1) - 1
        assert int((f64 != want).sum()) == 108


@pytest.mark.parametrize("seed", range(4))
def test_exact_quantile_values_equal_reference(seed):
    buckets = hostile_buckets(seed)
    counts = np.array([b.size for b in buckets], np.int64)
    qs = (0.5, 0.95, 0.99)
    want = jflush.exact_quantile_values(buckets, counts, qs)
    got = agg_flush.exact_quantile_values(buckets, counts, qs, device="cpu")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert (got[counts == 0] == 0).all()
    # the tile and its gather rows equal the reference's too
    for a, b in zip(agg_flush.build_quantile_tile(buckets, counts),
                    jflush.build_quantile_tile(buckets, counts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_oracle_rows_equal_reference(seed):
    """The oracle's row-by-row tile (_quantile_rows_for) equals the
    reference's, and the production path equals the oracle."""
    buckets = hostile_buckets(seed + 10, n=60)
    qs = (0.5, 0.99)
    want = jlist._quantile_rows_for(buckets, qs)
    got = tlist._quantile_rows_for(buckets, qs, "cpu")
    counts = np.array([b.size for b in buckets], np.int64)
    prod = agg_flush.exact_quantile_values(buckets, counts, qs, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        for j, q in enumerate(qs):
            assert g[q] == w[q] or (np.isnan(g[q]) and np.isnan(w[q])), (i, q)
            assert np.array_equal(prod[i, j], g[q], equal_nan=True)


def test_batched_reduce_equals_reference():
    buckets = hostile_buckets(21, n=40, max_len=200)
    qs = (0.5, 0.9)
    gs, gq = tlist.batched_reduce(buckets, qs, device="cpu")
    ws, wq = jlist.batched_reduce(buckets, qs)
    assert len(gs) == len(ws)
    for a, b in zip(gs + gq, ws + wq):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_numwatch_witnesses_the_gather(monkeypatch):
    """With the numerics witness installed, the gather is observed under
    the `agg_flush` site; a count-0 row is exactly zero."""
    monkeypatch.setattr(numwatch, "_INSTALLED", True)
    numwatch.reset()
    buckets = [np.array([1.0, 2.0]), np.zeros(0), np.array([3.0])]
    counts = np.array([2, 0, 1])
    vals = agg_flush.exact_quantile_values(buckets, counts, (0.5,), "cpu")
    assert numwatch.observed_count() == 1
    assert numwatch.findings() == []
    assert vals.tolist() == [[1.0], [0.0], [3.0]]


class TestGuard:
    @pytest.fixture(autouse=True)
    def _clean(self):
        faultcomp.uninstall()
        guard.reset()
        yield
        faultcomp.uninstall()
        guard.reset()

    def test_dispatch_fault_raises_typed_and_counts_once(self):
        buckets = hostile_buckets(5, n=20)
        counts = np.array([b.size for b in buckets], np.int64)
        before = ROOT.snapshot()
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=3, dispatch_raise=1.0, route_filter="agg_flush")) as seam:
            with pytest.raises(guard.KernelFault) as err:
                agg_flush.exact_quantile_values(buckets, counts, (0.5,),
                                                device="cpu")
            assert err.value.route == "agg_flush"
            assert seam.decisions["agg_flush"] == ["dispatch_raise"]
        after = ROOT.snapshot()
        key = "telemetry.compute.faults{kind=kernel,route=agg_flush}"
        assert after.get(key, 0) - before.get(key, 0) == 1

    def test_corrupt_indices_are_caught(self):
        buckets = hostile_buckets(6, n=20)
        counts = np.array([b.size for b in buckets], np.int64)
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=0, corrupt=1.0, route_filter="agg_flush")):
            with pytest.raises(guard.KernelFault, match="corrupted output"):
                agg_flush.quantile_rank_rows(
                    *agg_flush.build_quantile_tile(buckets, counts)[:1],
                    counts.astype(np.int32), (0.5, 0.99), device="cpu")

    def test_clean_campaign_is_exact_or_typed(self):
        """A seeded campaign of every fault kind: each call answers the
        clean indices or raises the typed error its draws imply."""
        buckets = hostile_buckets(7, n=30)
        counts = np.array([b.size for b in buckets], np.int64)
        tile = agg_flush.build_quantile_tile(buckets, counts)[0]
        c32 = counts.astype(np.int32)
        clean = agg_flush.quantile_rank_rows(tile, c32, QS, "cpu")
        plan = faultcomp.ComputeFaultPlan(
            seed=11, compile_fail=0.1, dispatch_raise=0.15, oom=0.1,
            corrupt=0.15, route_filter="agg_flush")
        answered = raised = 0
        with faultcomp.injected(plan) as seam:
            for _ in range(40):
                mark = seam.mark()
                try:
                    out = agg_flush.quantile_rank_rows(tile, c32, QS, "cpu")
                except guard.ComputeError as err:
                    assert faultcomp.unexplained(seam.since(mark), err) is None
                    raised += 1
                    guard.reset()
                    continue
                assert faultcomp.unexplained(seam.since(mark), None) is None
                np.testing.assert_array_equal(out, clean)
                answered += 1
        assert answered and raised
