"""The port's query engine against the reference's interpreter, on the CPU:
m3_tpu_torch.query.executor.Engine(storage, device="cpu").execute_range
against m3_tpu.query.Engine(storage, mesh=None).execute_range_ref on the
same storage.

mesh=None keeps the reference on one device (the test conftest forces
eight CPU devices, which would take its sharded route), and
execute_range_ref is its per-node interpreter, the route the port has
(its compiled route differs by about 1e-7 relative).

Each query must give the same series tags in the same order, NaN at the
same cells, and values within rtol 1e-5, atol 1e-8 (the oracle tolerance
of bench.py's compiled-vs-interpreter check)."""

import numpy as np
import pytest
import torch

from m3_tpu.query import Engine as JEngine
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import DictStorage, promql_corpus

S = 1_000_000_000
MIN = 60 * S

# The chip smoke's query phase, over bench_promql's and
# bench_promql_plan_agg's corpora.
PHASE_QUERIES = (
    [f"{f}(bench_metric[5m])" for f in ("rate", "increase", "irate", "delta")]
    + [f"{k}_over_time(bench_metric[5m])" for k in (
        "sum", "avg", "min", "max", "count", "last", "stddev", "stdvar",
        "present")]
    + ["sum_over_time(bench_metric[5m10s])",
       "max_over_time(rate(bench_metric[5m])[30m:1m])"])
AGG_QUERIES = ("sum by (host) (rate(bench_requests[5m]))",
               "max by (host) (rate(bench_requests[5m]))",
               "topk(5, rate(bench_requests[5m]))")
MORE_QUERIES = (
    "idelta(bench_metric[5m])",
    "rate(bench_metric[5m] offset 10m)",
    "sum_over_time(bench_metric[5m] offset 90s)",
    "sum_over_time(bench_metric[5m] @ 1700002000)",
    "rate(bench_metric[5m] @ end())",
    "rate(bench_metric[5m]) * 60 - irate(bench_metric[1m])",
    "bench_metric - bench_metric offset 5m",
    "sum_over_time(bench_metric[5m]) > bool 3000",
    "absent_over_time(bench_metric[5m])",
    "absent_over_time(bench_metric[5m] offset 2h)",
    "avg_over_time(bench_metric[2m:30s])",
    "min_over_time(delta(bench_metric[1m])[10m:45s])",
    "count(rate(bench_metric[5m]) > 0.5)",
    "stddev(increase(bench_metric[5m]))",
    "quantile(0.9, rate(bench_metric[5m]))",
    "bottomk(3, last_over_time(bench_metric[5m]))",
)


def _same(got, ref, what):
    assert [t.id() for t in got.series_tags] == [
        t.id() for t in ref.series_tags], what
    g, r = np.asarray(got.values), np.asarray(ref.values)
    assert g.shape == r.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=what)
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-8, equal_nan=True,
                               err_msg=what)


@pytest.fixture(scope="module")
def bench():
    series, t = promql_corpus(200, 11)
    series.update(promql_corpus(200, 17, hosts=20,
                                metric=b"bench_requests")[0])
    st = DictStorage(series)
    return (Engine(st, device="cpu"), JEngine(st, mesh=None),
            int(t[30]), int(t[-1]), 30 * S)


@pytest.mark.parametrize("q", PHASE_QUERIES + list(AGG_QUERIES)
                         + list(MORE_QUERIES))
def test_bench_corpus_matches_reference(bench, q):
    eng, ref, start, end, step = bench
    _same(eng.execute_range(q, start, end, step),
          ref.execute_range_ref(q, start, end, step), q)


def test_large_fan_in_takes_the_f32_device_forms():
    """4,200 series: grouped aggregation takes the f32 segment reduce (at
    least 4,096 rows) and a *_over_time result of 462,000 cells the f32
    device finish (at least 262,144), in both engines."""
    series, t = promql_corpus(4200, 17, hosts=50, metric=b"bench_requests")
    st = DictStorage(series)
    eng, ref = Engine(st, device="cpu"), JEngine(st, mesh=None)
    for q in ("sum by (host) (rate(bench_requests[5m]))",
              "avg by (host) (increase(bench_requests[5m]))",
              "min by (host) (irate(bench_requests[5m]))",
              "sum_over_time(bench_requests[5m])",
              "stddev_over_time(bench_requests[5m])"):
        _same(eng.execute_range(q, int(t[30]), int(t[-1]), 30 * S),
              ref.execute_range_ref(q, int(t[30]), int(t[-1]), 30 * S), q)


class MemStorage:
    """tests/test_query_engine.py's in-memory storage: matchers select,
    and each fetch returns fresh entry dicts over [start, end)."""

    def __init__(self):
        self.series = []

    def add(self, tags, t, v):
        self.series.append(({k.encode(): x.encode() for k, x in tags.items()},
                            np.asarray(t, np.int64), np.asarray(v, np.float64)))
        return self

    def fetch_raw(self, matchers, start_ns, end_ns):
        out = {}
        for tags, t, v in self.series:
            if all(m.matches(tags.get(m.name, b"")) for m in matchers):
                keep = (t >= start_ns) & (t < end_ns)
                sid = b",".join(k + b"=" + val for k, val in sorted(tags.items()))
                out[sid] = {"tags": tags, "t": t[keep], "v": v[keep]}
        return out


@pytest.fixture(scope="module")
def mem():
    st = MemStorage()
    t = np.arange(0, 40) * 15 * S
    rng = np.random.default_rng(3)
    for job, inst, slope in (("api", "a", 10.0), ("api", "b", 5.0),
                             ("db", "c", 2.0)):
        v = np.arange(40) * slope
        v[25:] -= v[25]                       # a counter reset
        st.add({"__name__": "http_requests_total", "job": job,
                "instance": inst}, t, v)
    for inst, level in (("a", 100.0), ("b", 300.0)):
        v = level + rng.standard_normal(40)
        v[rng.random(40) < 0.2] = np.nan
        st.add({"__name__": "memory_bytes", "job": "api", "instance": inst},
               t, v)
    for le, frac in (("0.1", 0.2), ("0.5", 0.6), ("1", 0.9), ("+Inf", 1.0)):
        st.add({"__name__": "lat_bucket", "job": "api", "le": le},
               t, np.arange(40) * 10.0 * frac)
    return Engine(st, device="cpu"), JEngine(st, mesh=None)


@pytest.mark.parametrize("q", [
    "rate(http_requests_total[5m])", "increase(http_requests_total[2m])",
    "delta(memory_bytes[2m])", "irate(http_requests_total[1m])",
    'sum by (job) (rate(http_requests_total{job=~"a.*|db"}[5m]))',
    "sum without (instance) (rate(http_requests_total[5m]))",
    "max_over_time(memory_bytes[3m])", "min_over_time(memory_bytes[45s])",
    "last_over_time(memory_bytes[1m])", "stddev_over_time(memory_bytes[5m])",
    "count_over_time(memory_bytes[2m])", "avg(memory_bytes)",
    "memory_bytes offset 1m", "memory_bytes @ start()",
    "rate(http_requests_total[2m] offset 1m) / on(instance) group_left "
    "memory_bytes",
    "http_requests_total > 100", "http_requests_total and memory_bytes",
    "memory_bytes unless http_requests_total",
    'histogram_quantile(0.9, sum by (le) (rate(lat_bucket[2m])))',
    'label_replace(memory_bytes, "host", "$1", "instance", "(.*)")',
    'label_join(memory_bytes, "x", "-", "job", "instance")',
    "absent_over_time(nothing_here[1m])", "absent(nothing_here)",
    "sum_over_time(http_requests_total[2m:15s])",
    "count_values(\"v\", count_over_time(memory_bytes[1m]))",
    "timestamp(memory_bytes)", "sort_desc(memory_bytes)", "abs(-memory_bytes)",
    "scalar(sum(memory_bytes)) * 2", "vector(1) + 1", "time()", "hour()",
])
def test_memstorage_matches_reference(mem, q):
    eng, ref = mem
    _same(eng.execute_range(q, 5 * MIN, 9 * MIN, 30 * S),
          ref.execute_range_ref(q, 5 * MIN, 9 * MIN, 30 * S), q)


def test_instant_query_matches_reference(mem):
    eng, ref = mem
    for q in ("rate(http_requests_total[5m])", "sum(memory_bytes)"):
        _same(eng.execute_instant(q, 7 * MIN), ref.execute_instant(q, 7 * MIN),
              q)


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(MemStorage())
    assert Engine(MemStorage(), device="cpu").device.type == "cpu"
