"""The port's host copies of the metrics model (m3_tpu_torch/metrics:
policy, aggregation types and IDs, pipelines, metadata, transformations)
against the reference's (m3_tpu/metrics), on the cases of
tests/test_metrics_model.py and a sweep of every aggregation type.

Tolerance: none for the host copies (equal strings, IDs and values).
The batch transformations compare the port's torch ops with the
reference's jnp forms on f32 values and integer times that fit in int32
(the reference runs without x64, so its times are int32): equal bit for
bit, NaN equal to NaN."""

import itertools

import numpy as np
import pytest
import torch

from m3_tpu.metrics import aggregation as jagg
from m3_tpu.metrics import pipeline as jpipe
from m3_tpu.metrics import policy as jpolicy
from m3_tpu.metrics import transformation as jtr
from m3_tpu_torch.metrics import aggregation as tagg
from m3_tpu_torch.metrics import metadata as tmeta
from m3_tpu_torch.metrics import pipeline as tpipe
from m3_tpu_torch.metrics import policy as tpolicy
from m3_tpu_torch.metrics import transformation as ttr
from m3_tpu_torch.metrics.metric import MetricType, MetricUnion
from m3_tpu_torch.utils import xtime

POLICIES = ("10s:2d", "1m:40d", "1m@1s:40d", "5m:40h", "1h@1m:30d",
            "30s:6h", "1s@1ms:1d")


@pytest.mark.parametrize("s", POLICIES)
def test_storage_policy_equals_reference(s):
    p, r = tpolicy.StoragePolicy.parse(s), jpolicy.StoragePolicy.parse(s)
    assert str(p) == str(r)
    assert tpolicy.StoragePolicy.parse(str(p)) == p
    assert p.resolution.window_ns == r.resolution.window_ns
    assert p.retention_ns == r.retention_ns
    assert int(p.resolution.precision) == int(r.resolution.precision)
    assert tpolicy.StoragePolicy.parse("10s:2d").resolution.precision == \
        xtime.Unit.SECOND


@pytest.mark.parametrize("bad", ["10s", "1m@2s:1d", "1m@1x:1d"])
def test_storage_policy_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jpolicy.StoragePolicy.parse(bad)
    with pytest.raises(ValueError):
        tpolicy.StoragePolicy.parse(bad)


def test_agg_types_equal_reference():
    assert [t.name for t in tagg.AggType] == [t.name for t in jagg.AggType]
    for t, r in zip(tagg.AggType, jagg.AggType):
        assert int(t) == int(r)
        assert t.quantile() == r.quantile()
        assert t.type_string == r.type_string
        for mt in MetricType:
            assert t.is_valid_for(mt) == r.is_valid_for(int(mt))
    for mt in (MetricType.COUNTER, MetricType.TIMER, MetricType.GAUGE):
        assert [int(x) for x in tagg.default_types_for(mt)] == \
            [int(x) for x in jagg.default_types_for(int(mt))]
    types = tagg.parse_types("Sum,Max,P99")
    assert set(tagg.AggID.decompress(tagg.AggID.compress(types))) == set(types)
    assert tagg.is_expensive(types) is False
    assert tagg.is_expensive((tagg.AggType.STDEV,)) is True


@pytest.mark.parametrize("k", [1, 2, 3])
def test_agg_id_round_trip_equals_reference(k):
    """Every k-subset of the valid types packs to the reference's bitmask
    and unpacks to the same types."""
    valid = [t for t in tagg.AggType if t != tagg.AggType.UNKNOWN]
    for combo in itertools.combinations(valid, k):
        mask = tagg.AggID.compress(combo)
        assert mask == jagg.AggID.compress(
            [jagg.AggType(int(t)) for t in combo])
        assert [int(t) for t in tagg.AggID.decompress(mask)] == \
            [int(t) for t in jagg.AggID.decompress(mask)]
    with pytest.raises(ValueError):
        tagg.AggID.compress([tagg.AggType.UNKNOWN])


def test_pipeline_and_metadata_equal_reference():
    sum_id = tagg.AggID.compress([tagg.AggType.SUM])
    ops = (tpipe.Op.aggregate(tagg.AggType.MAX),
           tpipe.Op.transform(ttr.TransformType.PERSECOND),
           tpipe.Op.roll(b"requests.by_dc", [b"dc"], sum_id))
    rops = (jpipe.Op.aggregate(jagg.AggType.MAX),
            jpipe.Op.transform(jtr.TransformType.PERSECOND),
            jpipe.Op.roll(b"requests.by_dc", [b"dc"], sum_id))
    p, r = tpipe.Pipeline(ops), jpipe.Pipeline(rops)
    assert len(p) == len(r) == 3 and not p.is_empty()
    for a, b in zip(p.ops, r.ops):
        assert int(a.type) == int(b.type)
    assert p.at(2).rollup.new_name == r.at(2).rollup.new_name
    assert p.at(2).rollup.tags == r.at(2).rollup.tags == (b"dc",)
    assert p.sub(1) == tpipe.Pipeline(ops[1:]) and len(r.sub(1)) == 2
    assert tpipe.EMPTY_PIPELINE.is_empty()
    pm = tmeta.PipelineMetadata(sum_id, (tpolicy.StoragePolicy.parse("1m:40d"),),
                                p)
    assert not pm.is_default() and tmeta.PipelineMetadata().is_default()
    assert tmeta.DEFAULT_STAGED_METADATA.is_default()
    assert not tmeta.StagedMetadata(5).is_default()
    mu = MetricUnion.batch_timer(b"t", [1.0, 2.0])
    assert mu.type == MetricType.TIMER and mu.batch_timer_val == (1.0, 2.0)


def test_scalar_transformations_equal_reference():
    cases = [((0, 10.0), (2_000_000_000, 30.0)), ((5, 10.0), (5, 30.0)),
             ((0, 30.0), (5, 10.0)), ((0, float("nan")), (5, 1.0)),
             ((1, 1.0), (3, float("nan"))), ((0, -3.0), (7, -1.0))]
    for (t0, v0), (t1, v1) in cases:
        got = ttr.per_second(ttr.Datapoint(t0, v0), ttr.Datapoint(t1, v1))
        want = jtr.per_second(jtr.Datapoint(t0, v0), jtr.Datapoint(t1, v1))
        assert got.time_nanos == want.time_nanos
        assert np.array_equal(got.value, want.value, equal_nan=True)
        for tt in (ttr.TransformType.ABSOLUTE, ttr.TransformType.PERSECOND):
            g = ttr.apply(tt, None, ttr.Datapoint(t1, v1))
            w = jtr.apply(jtr.TransformType(int(tt)), None,
                          jtr.Datapoint(t1, v1))
            assert g.time_nanos == w.time_nanos
            assert np.array_equal(g.value, w.value, equal_nan=True)


def test_batch_transformations_equal_jnp():
    t = np.array([0, 1, 2, 3], np.int64) * 1_000_000_000
    v = np.array([0.0, 10.0, 5.0, 6.0], np.float32)
    out = ttr.per_second_batch(torch.from_numpy(t), torch.from_numpy(v)).numpy()
    assert np.isnan(out[0]) and out[1] == 10.0 and np.isnan(out[2]) \
        and out[3] == 1.0
    np.testing.assert_array_equal(out, np.asarray(jtr.per_second_batch(t, v)))


@pytest.mark.parametrize("seed", range(4))
def test_batch_transformations_seeded_equal_jnp(seed):
    """[8, 40] windows with repeated and backward times, NaN and
    decreasing values: the port's torch ops equal the jnp forms."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0, 1, 2, 5, -1], (8, 39), p=[0.1, 0.5, 0.2, 0.1, 0.1])
    t = np.concatenate([np.zeros((8, 1), np.int64),
                        np.cumsum(steps, axis=1) * 10_000_000], axis=1)
    v = np.cumsum(rng.standard_normal((8, 40)), axis=1).astype(np.float32)
    v[rng.random((8, 40)) < 0.1] = np.nan
    want = np.asarray(jtr.per_second_batch(t.astype(np.int32), v))
    got = ttr.per_second_batch(torch.from_numpy(t), torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == (8, 40)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttr.absolute_batch(torch.from_numpy(v)).numpy(),
        np.asarray(jtr.absolute_batch(v)))
