"""The port's embedded downsampler (m3_tpu_torch/coordinator/
downsample.py, its Aggregator on device="cpu") against the reference's
(m3_tpu/coordinator/downsample.py), on the CPU.

The same rule set (the reference's, moved to the port through the KV
JSON) and the same samples go through both packages' Downsampler; the
matched and dropped counts must be equal, and the rows each flush writes
(id, tags, time, value, storage policy) must be equal with their values
bit for bit (NaN equal to NaN). No tolerance applies. In the port,
write_batch (the batch matcher and grouped adds) must also equal
write_ref (the per-metric oracle), as the reference's benchmark holds
its own two paths. Corpora: the downsample benchmark's (bench.py
_rules_corpus, gauges, counters and timers with a DROP_MUST class) at
2,000 metrics against 80 mapping and 20 rollup rules over 80 services (so
every metric lands on a rule, as at the benchmark's 800 rules over 500),
and tests/test_batch_matcher.py's random rule sets."""

import random
import struct

import pytest

import bench
from m3_tpu.cluster import kv as jkv
from m3_tpu.coordinator.downsample import Downsampler as JDownsampler
from m3_tpu.metrics import matcher as jmatcher
from m3_tpu.metrics.metric import MetricType as JMetricType
from m3_tpu_torch.cluster import kv as tkv
from m3_tpu_torch.coordinator.downsample import Downsampler
from m3_tpu_torch.metrics import matcher as tmatcher
from m3_tpu_torch.metrics.metric import MetricType
from test_batch_matcher import T0, _rand_batch, _rand_ruleset
from test_torch_metrics_rules import canon, to_port

S = 1_000_000_000


def _row_key(row):
    """(id, tags, time, value bits, policy) — NaN payloads fold to one."""
    mid, tags, t, v, pol = row
    bits = "nan" if v != v else struct.pack("<d", v)
    return (mid, canon(tags), t, bits, canon(pol))


def _jds(rs, clock, batched=True):
    store = jmatcher.RuleSetStore(jkv.MemStore())
    store.publish(rs)
    rows = []
    kw = ({"write_aggregated_batch": rows.extend} if batched else {})
    ds = JDownsampler(jmatcher.Matcher(store, b"default", clock=clock),
                      lambda *a: rows.append(a), clock=clock, **kw)
    return ds, rows


def _tds(rs, clock, batched=True):
    store = tmatcher.RuleSetStore(tkv.MemStore())
    store.publish(to_port(rs))
    rows = []
    kw = ({"write_aggregated_batch": rows.extend} if batched else {})
    ds = Downsampler(tmatcher.Matcher(store, b"default", clock=clock),
                     lambda *a: rows.append(a), clock=clock, device="cpu",
                     **kw)
    return ds, rows


def _port_samples(samples):
    return [(tags, t, v, MetricType(int(mt))) for tags, t, v, mt in samples]


def _run(rs, samples, flush_at, now):
    """Both packages' write_batch, then one flush at `flush_at`; the port
    also through write_ref. Returns the three (ds, rows) pairs."""
    clock = lambda: now["t"]  # noqa: E731
    jds, jrows = _jds(rs, clock)
    tds, trows = _tds(rs, clock)
    rds, rrows = _tds(rs, clock, batched=False)
    jres = jds.write_batch(samples)
    tres = tds.write_batch(_port_samples(samples))
    for tags, t, v, mt in _port_samples(samples):
        rds.write_ref(tags, t, v, mt)
    assert tres == jres
    now["t"] = flush_at
    jds.flush()
    tds.flush()
    rds.flush()
    return (jds, jrows), (tds, trows), (rds, rrows)


@pytest.mark.parametrize("n", [600, 2000])
def test_bench_corpus_flush_rows_equal_reference(n):
    """The downsample benchmark's corpus: matched and dropped counts and
    every flushed row equal to the reference's, and write_batch equal to
    write_ref in the port (the benchmark's own check)."""
    rs, samples = bench._rules_corpus(n, 80, 20, n_services=80)
    t0 = samples[0][1]
    now = {"t": t0}
    (jds, jrows), (tds, trows), (rds, rrows) = _run(
        rs, samples, t0 + 10 * 60 * S, now)
    want = (jds.samples_matched, jds.samples_dropped)
    assert (tds.samples_matched, tds.samples_dropped) == want
    assert (rds.samples_matched, rds.samples_dropped) == want
    assert want[0] > 0.9 * n and want[1] > 0
    assert jrows
    assert sorted(map(_row_key, trows)) == sorted(map(_row_key, jrows))
    assert sorted(map(_row_key, rrows)) == sorted(map(_row_key, trows))


@pytest.mark.parametrize("seed", range(4))
def test_random_rulesets_flush_rows_equal_reference(seed):
    """tests/test_batch_matcher.py's random rule sets (mapping and rollup
    pipelines, cutovers, tombstones): gauge, counter and timer samples
    over two flush windows, rows equal to the reference's."""
    rng = random.Random(seed)
    rs = _rand_ruleset(rng, version=1, first_op_rollups_only=True)
    types = [JMetricType.GAUGE, JMetricType.COUNTER, JMetricType.TIMER]
    batch = [(tags, T0 + (i % 3) * 20 * S, float(i % 13) - 4.75,
              types[i % 3])
             for i, tags in enumerate(_rand_batch(rng, 250))]
    now = {"t": T0}
    (jds, jrows), (tds, trows), (rds, rrows) = _run(rs, batch,
                                                    T0 + 180 * S, now)
    assert jrows
    assert sorted(map(_row_key, trows)) == sorted(map(_row_key, jrows))
    assert sorted(map(_row_key, rrows)) == sorted(map(_row_key, jrows))


def test_downsampler_raises_without_a_card(monkeypatch):
    import torch

    store = tmatcher.RuleSetStore(tkv.MemStore())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Downsampler(tmatcher.Matcher(store, b"default"), lambda *a: None)
