"""The port of tests/test_ingest_pipeline.py: the single-device ingest step,
the sharded step over the shard x time mesh, the executor's sharded
aggregation, sum_rate over the mesh and the multi-device dry run, on the
CPU, held against m3_tpu on the same seeded inputs.

The reference runs on the conftest's eight virtual CPU devices; the port
runs on eight `cpu` entries (`device.attach([cpu] * 8)`, the analogue of
--xla_force_host_platform_device_count=8). Words, nbits, the decoded
planes and count/min/max/first/last are bit-equal to the reference's;
sum, sumsq and m2 are held to bench.py's f32 reorder bound
(tests/test_torch_aggregation.py); sum_rate and the sharded aggregations
to rtol 1e-5 (the reference's own bound, __graft_entry__.py). Also here:
the mesh module itself (layout, collectives in slice order, XLA's
signed-zero order) and attach()'s cache clearing."""

import functools

import jax
import numpy as np
import pytest
import torch

from m3_tpu.ops import tsz as jtsz
from m3_tpu.parallel import ingest as jingest
from m3_tpu.parallel import query as jquery
from m3_tpu.query import Engine as JEngine
from m3_tpu_torch import convert
from m3_tpu_torch.device import attach, attached
from m3_tpu_torch.ops import temporal, tsz
from m3_tpu_torch.parallel import ingest, mesh as pmesh
from m3_tpu_torch.parallel import query as pq
from m3_tpu_torch.parallel.dryrun import dryrun_multichip
from m3_tpu_torch.query import executor as qexec
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.utils.instrument import ROOT
from test_torch_aggregation import _bits_equal, _compare_stats

CPU = torch.device("cpu")


@pytest.fixture
def cpu8():
    with attach([CPU] * 8) as devs:
        yield devs


def _rng():
    return np.random.default_rng(12345)


# ----------------------------------------------------------- one device


def test_single_chip_ingest_roundtrip():
    n, w = 32, 24
    jbatch = jingest.make_example_batch(n, w, _rng())
    batch = ingest.make_example_batch(n, w, _rng(), device="cpu")
    want = convert.ingest_batch_to_torch(jbatch, "cpu")
    for a, b in zip(batch, want):
        assert torch.equal(a, b)
    mw = tsz.max_words_for(w)
    words, nbits, roll, blk, qtl = ingest.ingest_step(
        batch, rollup_factor=6, max_words=mw, device="cpu")
    ref = jax.jit(functools.partial(jingest.ingest_step, rollup_factor=6,
                                    max_words=mw))(jbatch)
    np.testing.assert_array_equal(convert.words_to_numpy(words),
                                  np.asarray(ref[0]))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(ref[1]))
    assert tuple(roll["sum"].shape) == (n, w // 6)
    assert tuple(qtl.shape) == (n, w // 6, 2)
    # The streams decode back to the exact input points.
    _, vals = tsz.decode(words, np.full(n, w, np.int32), w, device="cpu")
    np.testing.assert_allclose(vals.numpy(), batch.values.double().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(blk["sum"].numpy(),
                               roll["sum"].numpy().sum(-1), rtol=1e-4)


def test_device_prep_matches_host_prep():
    """prepare_on_device_math reproduces the host prep bit for bit on
    live cells for k=0 and float rows (decimal rows take the float path
    on the device, as in the reference), and equals the reference's
    device prep."""
    rng = _rng()
    n, w = 256, 24
    raw_ts, raw_vals, npoints = ingest.make_example_raw(n, w, rng)
    npoints[:32] = rng.integers(1, w, 32)
    raw_vals[1, 2] = -0.0
    raw_vals[2, 3] = np.nan
    raw_vals[3, :] = 2.0**52
    raw_vals[4, :] = 2.0**53
    raw_vals[5, :] = -(2.0**52 + 1)
    raw_vals[6, :] = 0.25
    host = tsz.prepare_encode_inputs(raw_ts, raw_vals, npoints)
    raw = ingest.make_raw_batch(raw_ts, raw_vals, npoints, device="cpu")
    prep, ok = tsz.prepare_on_device_math(
        raw.ts, raw.values.view(torch.int64), raw.npoints)
    assert bool(ok)
    decimal = host["int_mode"] & (host["k"] > 0)
    assert decimal[6] and not bool(prep["int_mode"][6])
    rows = ~decimal
    np.testing.assert_array_equal(prep["int_mode"].numpy()[rows],
                                  host["int_mode"][rows])
    for key in ("dt", "ts_regular", "delta0"):
        np.testing.assert_array_equal(prep[key].numpy(), host[key],
                                      err_msg=key)
    live = (np.arange(w)[None, :] < npoints[:, None]) & rows[:, None]
    np.testing.assert_array_equal(prep["v"].numpy()[live], host["v"][live])
    jraw = jingest.make_raw_batch(raw_ts, raw_vals, npoints)
    hi, lo = jingest._HI, 1 - jingest._HI
    jprep, jok = jax.jit(jtsz.prepare_on_device_math)(
        jraw.ts_pairs[..., hi], jraw.ts_pairs[..., lo],
        jraw.v_pairs[..., hi], jraw.v_pairs[..., lo], jraw.npoints)
    assert bool(jok)
    np.testing.assert_array_equal(
        prep["v"].numpy(), convert.pair_to_int64(jprep["vhi"], jprep["vlo"]))
    np.testing.assert_array_equal(prep["int_mode"].numpy(),
                                  np.asarray(jprep["int_mode"]))


def test_raw_ingest_step_decodes_and_flags_range():
    n, w = 64, 24
    raw_ts, raw_vals, npoints = ingest.make_example_raw(n, w, _rng())
    mw = tsz.max_words_for(w)
    step = functools.partial(ingest.ingest_step_raw, rollup_factor=6,
                             max_words=mw, device="cpu")
    out = step(ingest.make_raw_batch(raw_ts, raw_vals, npoints, device="cpu"))
    assert bool(out[-1])
    ts, vals = tsz.decode(out[0], npoints, w, device="cpu")
    np.testing.assert_array_equal(ts.numpy(), raw_ts)
    np.testing.assert_array_equal(vals.numpy(), raw_vals)
    bad_ts = raw_ts.copy()
    bad_ts[0, 10] += 2**33  # the delta leaves int32 ticks
    out_bad = step(ingest.make_raw_batch(bad_ts, raw_vals, npoints,
                                         device="cpu"))
    assert not bool(out_bad[-1])


# ------------------------------------------------------------- the mesh


def _sharded(n, w, t):
    """The reference's and the port's sharded step on the same batch."""
    jmesh = jingest.make_mesh(8)
    jbatch = jingest.make_example_batch(n, w, _rng(), chunks=t)
    mw = tsz.max_words_for(w)
    jstep = jingest.make_sharded_ingest(jmesh, rollup_factor=6, max_words=mw)
    ref = jax.tree.map(np.asarray, jstep(*jingest.shard_batch(jbatch, jmesh)))
    mesh = ingest.make_mesh(8)
    batch = ingest.make_example_batch(n, w, _rng(), chunks=t, device="cpu")
    step = ingest.make_sharded_ingest(mesh, rollup_factor=6, max_words=mw)
    return jbatch, ref, batch, step(ingest.shard_batch(batch, mesh)), mw


def test_sharded_ingest_on_virtual_mesh(cpu8):
    mesh = ingest.make_mesh(8)
    assert mesh.shape == {"shard": 4, "time": 2}
    t = mesh.shape["time"]
    n, w = 16, 12
    jbatch, ref, batch, got, mw = _sharded(n, w, t)
    for a, b in zip(batch, convert.ingest_batch_to_torch(jbatch, "cpu")):
        assert torch.equal(a, b)
    words, nbits, roll, qtl, whole, total_bits = got
    assert tuple(words.shape) == (t, n, mw)
    np.testing.assert_array_equal(convert.words_to_numpy(words), ref[0])
    np.testing.assert_array_equal(nbits.numpy(), ref[1])
    for i in range(t):
        _compare_stats({k: v[i] for k, v in roll.items()},
                       {k: v[i] for k, v in ref[2].items()})
    _bits_equal(qtl.numpy(), ref[3], "quantiles")
    _compare_stats(whole, ref[4])
    assert int(total_bits) == int(ref[5]) == int(nbits.to(torch.int64).sum())

    # Whole-window stats from the collectives == a host reduction.
    flat = np.concatenate(list(batch.values.double().numpy()), axis=1)
    np.testing.assert_allclose(whole["sum"].numpy(), flat.sum(-1), rtol=1e-5)
    np.testing.assert_array_equal(whole["min"].numpy(), flat.min(-1))
    np.testing.assert_array_equal(whole["max"].numpy(), flat.max(-1))
    np.testing.assert_array_equal(whole["last"].numpy(), flat[:, -1])
    np.testing.assert_array_equal(whole["first"].numpy(), flat[:, 0])

    # Every chunk's streams decode back to its input.
    for i in range(t):
        dec = tsz.decode_batch(words[i], batch.npoints[i], window=w,
                               device="cpu")
        assert torch.equal(dec["dt"], batch.dt[i])
        assert torch.equal(dec["v"], batch.v[i])


def test_sharded_ingest_chunk_equals_single_device(cpu8):
    """Each time chunk's words and nbits are the single-device step's on
    that chunk, bit for bit."""
    mesh = ingest.make_mesh(8)
    batch = ingest.make_example_batch(24, 16, _rng(), chunks=2, device="cpu")
    mw = tsz.max_words_for(16)
    step = ingest.make_sharded_ingest(mesh, rollup_factor=4, max_words=mw)
    words, nbits, *_ = step(ingest.shard_batch(batch, mesh))
    for i in range(2):
        one = ingest.ingest_step(ingest.IngestBatch(*(a[i] for a in batch)),
                                 rollup_factor=4, max_words=mw, device="cpu")
        assert torch.equal(one[0], words[i]) and torch.equal(one[1], nbits[i])


def test_sharded_ingest_first_last_skip_empty_chunks(cpu8):
    """first/last come from the first/last chunk holding data: rows whose
    later (or earlier) chunk is empty take the other chunk's value."""
    mesh = ingest.make_mesh(8)
    batch = ingest.make_example_batch(8, 12, _rng(), chunks=2, device="cpu")
    npts = batch.npoints.clone()
    npts[1, :4] = 0          # chunk 1 empty on rows 0-3
    npts[0, 4:] = 0          # chunk 0 empty on rows 4-7
    batch = batch._replace(npoints=npts)
    _, _, _, _, whole, _ = ingest.make_sharded_ingest(
        mesh, rollup_factor=6, max_words=tsz.max_words_for(12))(
            ingest.shard_batch(batch, mesh))
    v = batch.values.numpy()
    np.testing.assert_array_equal(whole["last"].numpy()[:4], v[0, :4, -1])
    np.testing.assert_array_equal(whole["first"].numpy()[4:], v[1, 4:, 0])
    np.testing.assert_array_equal(whole["count"].numpy(), np.full(8, 12.0))


class TestShardedServingPath:
    """The executor's mesh route (Engine._eval_sharded_agg) fires for
    dashboard-shaped aggregations over the attached devices and agrees
    with the single-device evaluation and with the reference's mesh
    route."""

    def _storage(self, n=37, npts=48):
        s_ns = 1_000_000_000
        rng = np.random.default_rng(5)
        t = 1_700_000_000 * s_ns + np.arange(npts, dtype=np.int64) * 10 * s_ns
        vals = np.cumsum(rng.poisson(3.0, (n, npts)), axis=1).astype(float)
        vals[rng.random((n, npts)) < 0.05] = np.nan
        series = {
            b"m{i=%d}" % i: {"tags": {b"__name__": b"m",
                                      b"i": str(i).encode()},
                             "t": t, "v": vals[i]}
            for i in range(n)}

        class _S:
            def fetch_raw(self, matchers, start_ns, end_ns):
                return {k: dict(v) for k, v in series.items()}

        return _S(), int(t[12]), int(t[-1]), 30 * s_ns

    def test_sharded_agg_fires_and_matches_host(self, cpu8):
        st, start, end, step = self._storage()
        eng = Engine(st, device="cpu")
        one = Engine(st, device="cpu", mesh=None)
        ref = JEngine(st)                   # the reference's 8-device mesh
        assert eng.mesh is not None and eng.mesh.shape == {"shard": 8}
        for q in ("sum(rate(m[1m]))", "avg(increase(m[1m]))",
                  "count(delta(m[1m]))", "max(rate(m[1m]))",
                  "min(rate(m[1m]))"):
            before = ROOT.counter("query.sharded_agg").value()
            got = eng.execute_range(q, start, end, step)
            assert ROOT.counter("query.sharded_agg").value() == before + 1, q
            want = one.execute_range(q, start, end, step)
            theirs = ref.execute_range(q, start, end, step)
            assert got.n_series == want.n_series == theirs.n_series == 1
            np.testing.assert_allclose(got.values, want.values, rtol=1e-5,
                                       equal_nan=True, err_msg=q)
            np.testing.assert_allclose(got.values, theirs.values, rtol=1e-5,
                                       equal_nan=True, err_msg=q)

    def test_grouped_and_nonrate_fall_back_to_host(self, cpu8):
        st, start, end, step = self._storage()
        eng = Engine(st, device="cpu")
        before = ROOT.counter("query.sharded_agg").value()
        eng.execute_range("sum by (i) (rate(m[1m]))", start, end, step)
        eng.execute_range("sum(m)", start, end, step)
        eng.execute_range("sum(rate(m[1m] @ 1700000300))", start, end, step)
        assert ROOT.counter("query.sharded_agg").value() == before

    def test_one_device_keeps_the_host_path(self):
        st, start, end, step = self._storage()
        eng = Engine(st, device="cpu")
        assert eng.mesh is None
        before = ROOT.counter("query.sharded_agg").value()
        eng.execute_range("sum(rate(m[1m]))", start, end, step)
        assert ROOT.counter("query.sharded_agg").value() == before


@pytest.mark.parametrize("n", [8, 4, 3])
def test_dryrun_multichip(n):
    """The port's dryrun_multichip, the counterpart of the reference's
    __graft_entry__.dryrun_multichip(8), over n CPU entries."""
    out = dryrun_multichip([CPU] * n)
    t = 2 if n >= 4 and n % 2 == 0 else 1
    assert out["mesh"] == {"shard": n // t, "time": t}
    assert out["sharded_agg"] == 1 and out["total_bits"] > 0
    assert attached() == []                 # nothing stays attached


class TestShardedQuery:
    def _grid(self, s_, t):
        rng = np.random.default_rng(4)
        grid = np.cumsum(rng.poisson(4.0, (s_, t)), axis=1).astype(np.float64)
        grid[rng.random((s_, t)) < 0.1] = np.nan
        return grid

    def test_sum_rate_matches_host(self, cpu8):
        """sum(rate(...)) over the mesh equals the per-series rate plus
        the NaN-excluding host sum, and the reference's mesh sum_rate."""
        mesh = ingest.make_mesh(8)
        grid = self._grid(37, 30)          # S not divisible by the axis
        kw = dict(W=6, step_ns=10 * 10**9, range_ns=60 * 10**9)
        got = pq.sum_rate(grid, mesh, **kw)
        want = pq.sum_rate_host_reference(grid, device="cpu", **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
        theirs = jquery.sum_rate(grid, jingest.make_mesh(8), **kw)
        np.testing.assert_allclose(got, theirs, rtol=1e-5, equal_nan=True)
        np.testing.assert_allclose(
            want, jquery.sum_rate_host_reference(grid, **kw), rtol=1e-5,
            equal_nan=True)

    @pytest.mark.parametrize("op", pq.AGG_OPS)
    @pytest.mark.parametrize("func", sorted(pq.RANGE_FUNCS))
    def test_agg_rate_against_reference(self, cpu8, op, func):
        grid = self._grid(29, 36)
        kw = dict(op=op, func=func, W=6, step_ns=10 * 10**9,
                  range_ns=60 * 10**9, stride=2)
        got = pq.agg_rate(grid, pq_mesh(), **kw)
        # The per-series rates are f32 in both packages, rounded in
        # different orders: rtol 1e-5 (count exact).
        want = jquery.agg_rate(grid, jingest.make_mesh(8), **kw)
        np.testing.assert_allclose(got, want, rtol=0 if op == "count" else
                                   1e-5, equal_nan=True)
        # Against the port's single-device rates: count, min and max
        # bit-equal, sum and avg within the f32 reorder of the sum.
        fn = getattr(temporal, func)
        per = fn(grid, 6, 10 * 10**9, 60 * 10**9, stride=2, device="cpu")
        fin = np.isfinite(per)
        with np.errstate(all="ignore"):
            host = {"count": fin.sum(0).astype(np.float64),
                    "min": np.nanmin(per, 0), "max": np.nanmax(per, 0),
                    "sum": np.nansum(per, 0),
                    "avg": np.nansum(per, 0) / np.maximum(fin.sum(0), 1)}
        host = np.where(fin.any(0), host[op], np.nan)
        np.testing.assert_allclose(
            got, host, rtol=0 if op in ("count", "min", "max") else 1e-5,
            equal_nan=True)


def pq_mesh():
    return pmesh.make(attached(), (len(attached()),), ("shard",))


# ------------------------------------------------------- the mesh module


def test_mesh_layout_and_hashing():
    m = pmesh.make([CPU] * 8, (4, 2), ("shard", "time"))
    assert m.shape == {"shard": 4, "time": 2} and m.size == 8
    assert m == pmesh.make(["cpu"] * 8, (4, 2), ("shard", "time"))
    assert hash(m) == hash(pmesh.make(["cpu"] * 8, (4, 2),
                                      ("shard", "time")))
    assert m != pmesh.make(["cpu"] * 8, (8, 1), ("shard", "time"))
    assert m.one_device()
    t = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    outs = pmesh.map_slices(lambda a: a, m, [t], [("time", "shard", None)])
    # Entry (s, t) holds chunk t, rows 2s..2s+1; the slice is its own
    # tensor, not a view of the input.
    assert torch.equal(outs[1, 1], t[1:2, 2:4])
    assert outs[1, 1].untyped_storage().data_ptr() != \
        t.untyped_storage().data_ptr()
    assert torch.equal(pmesh.gather(outs, m, ("time", "shard", None)), t)
    parts = pmesh.split_rows(torch.arange(16), m, ("shard", "time"))
    assert [int(p[0]) for p in parts] == list(range(0, 16, 2))
    assert torch.equal(pmesh.concat_rows(parts), torch.arange(16))


def test_collectives_in_slice_order_and_signed_zero():
    m = pmesh.make([CPU] * 4, (2, 2), ("shard", "time"))
    vals = np.empty((2, 2), dtype=object)
    vals[0, 0] = torch.tensor([1e8, 0.0, -0.0], dtype=torch.float32)
    vals[0, 1] = torch.tensor([1.0, -0.0, -0.0], dtype=torch.float32)
    vals[1, 0] = torch.tensor([-1e8, 0.0, 0.0], dtype=torch.float32)
    vals[1, 1] = torch.tensor([1.0, -0.0, 0.0], dtype=torch.float32)
    s = pmesh.psum(vals, m, "time")
    assert torch.equal(s[0, 0], s[0, 1])
    assert torch.equal(s[0, 0], vals[0, 0] + vals[0, 1])
    both = pmesh.psum(pmesh.psum(vals, m, "time"), m, "shard")
    # Slice order: (1e8 + 1) + (-1e8 + 1) in f32, the same every time.
    want = (vals[0, 0] + vals[0, 1]) + (vals[1, 0] + vals[1, 1])
    assert all(torch.equal(both[c], want) for c in m.entries())
    lo = pmesh.pmin(vals, m, "time")[0, 0]
    hi = pmesh.pmax(vals, m, "time")[1, 1]
    assert torch.signbit(lo[1]) and torch.signbit(lo[2])   # min(+0, -0)
    assert not torch.signbit(hi[1]) and not torch.signbit(hi[2])
    g = pmesh.all_gather(vals, m, "shard")[0, 1]
    assert torch.equal(g, torch.stack([vals[0, 1], vals[1, 1]]))


def test_attach_clears_every_cached_mesh(monkeypatch):
    assert attached() == [] and ingest.flush_mesh() is None
    assert qexec._default_query_mesh() is None
    with attach([CPU] * 4):
        assert ingest.flush_mesh().shape == {"shard": 2, "time": 2}
        assert qexec._default_query_mesh().shape == {"shard": 4}
        with attach([CPU] * 2):
            assert ingest.flush_mesh().shape == {"shard": 2, "time": 1}
        assert ingest.flush_mesh().shape == {"shard": 2, "time": 2}
        monkeypatch.setenv("M3_TPU_MESH_FLUSH", "0")
        ingest.flush_mesh.cache_clear()
        assert ingest.flush_mesh() is None
    assert ingest.flush_mesh() is None
    assert qexec._default_query_mesh() is None
    with attach([CPU]):
        # One device: every route stays single-device.
        assert ingest.flush_mesh() is None
        assert qexec._default_query_mesh() is None
