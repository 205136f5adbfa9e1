"""Seeded inputs for checking the codec and the hash on the card.

hostile_block draws the same seven kinds of series as the reference's
codec property corpus (tests/test_codec_pallas.py `_corpus`): counters,
2-decimal gauges, raw float noise that churns the rewrite window, sparse
NaN holes, constants, signed zeros and denormals, and wild raw f64 bit
patterns (infinities, NaN payloads), with npoints edges 0, 1 and W.
prometheus_ids draws series IDs shaped like Prometheus label sets.

For the query path: hostile_residuals draws f32 residual grids for the
window kernel, window_reorder_bounds gives the per-window tolerance of its
f32 sums, and promql_corpus builds the reference benchmark's PromQL
storage (bench.py bench_promql / bench_promql_plan_agg), gauge_corpus
mixed-sign gauges on the same grid. write_corpus writes such a corpus
into a storage Database in time order.

For the aggregator tier: counter_gauge_population and agg10x_build build
the populations of the reference benchmark's aggregator flushes
(bench.py bench_counter_gauge, BASELINE config #2, and _agg10x_build),
agg10x_planes their values and loopback_forward the local second stage
their rollup forwards feed; hostile_rank_rows draws tiles for the flush's
rank selection. gap_thresholds places alert thresholds where no answer
within the compiled route's bound of the data could cross them.

For the coordinator: serve_corpus builds the reference serving
benchmark's counters (bench.py bench_query_serve_e2e) and rules_corpus
the downsample benchmark's rule set and samples (bench.py
_rules_corpus).

The package also exports what the reference's m3_tpu/testing does: the
in-process cluster (ClusterHarness, ClusterNode, make_node_server), the
network fault plane (FaultPlan, FaultProxy) and the churn drill
(ChurnScenario, ChurnScenarioOptions, ScenarioResult, WriteLedger)."""

from __future__ import annotations

import numpy as np
import torch

EPS = 1.2e-7  # 2^-23


def hostile_block(seed: int, n: int, w: int):
    """(timestamps int64 [n, w], values f64 [n, w], npoints int32 [n])."""
    rng = np.random.default_rng(seed)
    base = np.int64(rng.choice([1_700_000_000, 2**40, 7]))
    step = int(rng.choice([1, 10, 1 << 20]))
    ts = base + np.arange(w, dtype=np.int64)[None, :] * step \
        + rng.integers(0, 2, (n, w))
    ts = np.sort(ts, axis=1)
    kind = np.arange(n) % 7
    vals = np.empty((n, w), np.float64)
    vals[kind == 0] = np.cumsum(rng.poisson(5.0, ((kind == 0).sum(), w)), axis=1)
    vals[kind == 1] = np.round(rng.normal(100, 5, ((kind == 1).sum(), w)), 2)
    vals[kind == 2] = rng.normal(0, 1, ((kind == 2).sum(), w))
    holes = rng.random(((kind == 3).sum(), w)) < 0.1
    vals[kind == 3] = np.where(holes, np.nan, np.round(
        rng.normal(10, 1, holes.shape), 3))
    vals[kind == 4] = rng.integers(0, 100, ((kind == 4).sum(), 1)).astype(np.float64)
    picks = rng.integers(0, 4, ((kind == 5).sum(), w))
    vals[kind == 5] = np.choose(picks, [0.0, -0.0, 5e-324, -5e-324])
    vals[kind == 6] = rng.integers(0, 2**64, ((kind == 6).sum(), w),
                                   dtype=np.uint64).view(np.float64)
    npoints = rng.integers(1, w + 1, n).astype(np.int32)
    npoints[0] = 0
    npoints[1] = 1
    npoints[2] = w
    return ts, vals, npoints


_METRICS = ("http_requests_total", "node_cpu_seconds_total",
            "container_memory_working_set_bytes",
            "apiserver_request_duration_seconds_bucket",
            "go_gc_duration_seconds", "kube_pod_status_ready")


def prometheus_ids(n: int, rng: np.random.Generator) -> list:
    """n series IDs of about 60-200 bytes: a metric name and a label set
    (instance and job, then optionally a pod and a variable-length path)."""
    m = rng.integers(0, len(_METRICS), n)
    a, b, c = (rng.integers(0, 256, n) for _ in range(3))
    job = rng.integers(0, 40, n)
    pod = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    has_pod = rng.random(n) < 0.5
    plen = rng.integers(-20, 60, n)
    out = []
    for i in range(n):
        labels = f'instance="10.{a[i]}.{b[i]}.{c[i]}:9100",job="job-{job[i]}"'
        if has_pod[i]:
            labels += f',pod="p-{pod[i]:08x}"'
        if plen[i] > 0:
            labels += f',path="/{"x" * int(plen[i])}"'
        out.append(f"{_METRICS[m[i]]}{{{labels}}}".encode())
    return out


def hostile_residuals(seed: int, s: int, k: int) -> np.ndarray:
    """f32 [s, k] residual grid: N(0, 1) scaled per row by 1e-2..1e3,
    about 20% NaN holes, some +-inf (missing, like NaN), -0.0 and +0.0
    runs, an all-NaN row, an all -0.0 row and a row of alternating signed
    zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((s, k))
         * 10.0 ** rng.integers(-2, 4, (s, 1))).astype(np.float32)
    zeros = rng.random((s, k)) < 0.05
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    x[rng.random((s, k)) < 0.2] = np.nan
    x[rng.random((s, k)) < 0.01] = np.inf
    x[rng.random((s, k)) < 0.01] = -np.inf
    x[0] = np.nan
    if s > 2:
        x[1] = -0.0
        x[2, ::2] = 0.0
        x[2, 1::2] = -0.0
    return x


def window_reorder_bounds(resid: torch.Tensor, W: int, stride: int):
    """Per-window tolerance (sum, m2), f64 [S, T_out], for two f32
    computations of the window sum and the two-pass m2 that add the same
    cells in different orders: bench.py's reduction-reorder bound
    2 n eps sqrt(n sum x^2) for the sum; for m2, 2 n eps m2 plus the
    first- and second-order effect of the two means differing by the sum's
    bound over n plus one rounding of the divide."""
    vol = resid.double().unfold(1, W, stride)
    mask = torch.isfinite(vol)
    x = torch.where(mask, vol, 0.0)
    cnt = mask.sum(-1).double()
    n1 = cnt.clamp(min=1)
    total = x.sum(-1)
    m2 = torch.where(mask, vol - (total / n1)[..., None], 0.0).pow(2).sum(-1)
    depth = 2.0 * n1 * EPS
    sum_b = depth * torch.sqrt(cnt * (x * x).sum(-1))
    mu_shift = (sum_b + EPS * total.abs()) / n1
    m2_b = depth * m2 + 2.0 * torch.sqrt(cnt * m2) * mu_shift \
        + cnt * mu_shift * mu_shift
    return sum_b, m2_b


class DictStorage:
    """fetch_raw over a fixed {id: {tags, t, v}} dict: the series whose
    tags the matchers accept, whole (no time filter), as the same entry
    objects on every fetch, like the reference benchmark's storage."""

    def __init__(self, series: dict):
        self.series = series

    def fetch_raw(self, matchers, start_ns, end_ns):
        return {sid: e for sid, e in self.series.items()
                if all(m.matches(e["tags"].get(m.name, b"")) for m in matchers)}


def promql_corpus(n: int, seed: int, hosts: int = 0,
                  metric: bytes = b"bench_metric"):
    """(series dict, timestamps) of the reference PromQL benchmark: n
    Poisson(5) counters, 360 points at 10 s from 1,700,000,000 s, drawn
    from np.random.default_rng(seed); with hosts > 0 each series also
    carries host=host-%03d (i % hosts), as bench_promql_plan_agg's do."""
    s_ns = 1_000_000_000
    rng = np.random.default_rng(seed)
    t = 1_700_000_000 * s_ns + np.arange(360, dtype=np.int64) * 10 * s_ns
    vals = np.cumsum(rng.poisson(5.0, (n, 360)), axis=1).astype(np.float64)
    series = {}
    for i in range(n):
        tags = {b"__name__": metric, b"i": str(i).encode()}
        if hosts:
            tags[b"host"] = b"host-%03d" % (i % hosts)
            sid = b"%s{host=%s,i=%d}" % (metric, tags[b"host"], i)
        else:
            sid = b"%s{i=%d}" % (metric, i)
        series[sid] = {"tags": tags, "t": t, "v": vals[i]}
    return series, t


def gauge_corpus(n: int, seed: int, metric: bytes = b"bench_gauge",
                 nan_frac: float = 0.2):
    """(series dict, timestamps): n mixed-sign gauges, normal(0, 1) x 10,
    on promql_corpus's grid (360 points at 10 s from 1,700,000,000 s),
    with `nan_frac` of the values NaN, drawn from
    np.random.default_rng(seed). Windows over them cancel: their f32 sums
    are held to the reference's scale-aware bound, not to rtol 1e-5."""
    s_ns = 1_000_000_000
    rng = np.random.default_rng(seed)
    t = 1_700_000_000 * s_ns + np.arange(360, dtype=np.int64) * 10 * s_ns
    vals = rng.standard_normal((n, 360)) * 10.0
    vals[rng.random((n, 360)) < nan_frac] = np.nan
    return {b"%s{i=%d}" % (metric, i): {
        "tags": {b"__name__": metric, b"i": str(i).encode()}, "t": t,
        "v": vals[i]} for i in range(n)}, t


def write_corpus(db, namespace: bytes, series: dict, t, now: dict,
                 steps_per_batch: int = 1) -> int:
    """Write a promql_corpus-shaped {id: {tags, t, v}} dict (every series
    on the grid `t`) through db.write_batch in time order, with tags,
    `steps_per_batch` grid steps per call and the database's clock (the
    dict `now`, key "t") at each call's last timestamp, so every point is
    inside the acceptance window. Works for any Database with the
    reference's write_batch signature. Returns the number of calls."""
    sids = list(series)
    tags = [series[s]["tags"] for s in sids]
    vals = np.stack([series[s]["v"] for s in sids], axis=1)  # [T, S]
    calls = 0
    for j in range(0, len(t), steps_per_batch):
        steps = np.asarray(t[j:j + steps_per_batch], np.int64)
        now["t"] = int(steps[-1])
        db.write_batch(namespace, sids * len(steps),
                       np.repeat(steps, len(sids)),
                       vals[j:j + len(steps)].reshape(-1),
                       tags=tags * len(steps))
        calls += 1
    return calls


S_NS = 1_000_000_000
# agg_rollup_10x's base time: 1,700,000,000 s aligned down to the minute.
AGG_BASE_NS = 1_700_000_000 * S_NS - (1_700_000_000 * S_NS) % (60 * S_NS)


def counter_gauge_population(n: int, device=None, seed: int = 23):
    """bench_counter_gauge's population (bench.py:507): n metrics, the
    first half counters (Poisson(5)), the rest gauges (normal), each with
    the storage policies 1m:40h and 5m:40h, drawn from
    np.random.default_rng(seed). Returns (lists {60: MetricList, 300:
    MetricList} on `device`, stage, target): stage() adds 5 minutes of
    10 s values from 1,700,000,000 s (five 1m windows of 6 and one 5m
    window of 30 per metric, as the bench stages them), and a flush of
    both lists at `target` closes n * 6 windows."""
    from ..aggregator.elem import Elem, ElemKey
    from ..aggregator.list import MetricList
    from ..metrics.metric import MetricType
    from ..metrics.policy import StoragePolicy

    pols = {60: StoragePolicy.parse("1m:40h"), 300: StoragePolicy.parse("5m:40h")}
    base = 1_700_000_000 * S_NS
    rng = np.random.default_rng(seed)
    cvals = rng.poisson(5.0, (n // 2, 30)).astype(np.float64)
    gvals = rng.standard_normal((n - n // 2, 30))
    lists = {res: MetricList(res * S_NS, device) for res in pols}
    elems = []
    for i in range(n):
        mt = MetricType.COUNTER if i < n // 2 else MetricType.GAUGE
        vals = cvals[i] if i < n // 2 else gvals[i - n // 2]
        mid = b"bench.cg.%d" % i
        for res, pol in pols.items():
            key = ElemKey(mid, pol)
            e = lists[res].get_or_create(key, lambda k=key, m=mt: Elem(k, m))
            elems.append((e, res, vals))

    def stage():
        for e, res, vals in elems:
            if res == 60:
                for wi in range(5):
                    e.add_values(base + wi * 60 * S_NS, vals[wi * 6:(wi + 1) * 6])
            else:
                e.add_values(base, vals)

    return lists, stage, base + 300 * S_NS


def agg10x_build(n: int, device=None):
    """_agg10x_build's population (bench.py:595) in one 1m MetricList on
    `device`: 40% counters, 40% gauges, 20% timers (default agg types, so
    timers emit p50/p95/p99), 10% of the gauges on a rollup-only pipeline
    (Rollup(Sum)) into n_piped // 40 rollup ids. Returns (lists, elems,
    n_piped, n_rollup_ids), elems [(elem, kind, row)]."""
    from ..aggregator.elem import Elem, ElemKey
    from ..aggregator.list import MetricLists
    from ..metrics import aggregation as magg
    from ..metrics.metric import MetricType
    from ..metrics.pipeline import Op, Pipeline
    from ..metrics.policy import StoragePolicy

    pol = StoragePolicy.parse("1m:40h")
    lists = MetricLists(device)
    lst = lists.for_resolution(60 * S_NS)
    n_counter = (n * 2) // 5
    n_gauge = (n * 2) // 5
    n_timer = n - n_counter - n_gauge
    n_piped = n_gauge // 10
    n_rollup_ids = max(1, n_piped // 40)
    elems = []
    for i in range(n_counter):
        key = ElemKey(b"bench.a10.c.%d" % i, pol)
        elems.append((lst.get_or_create(
            key, lambda k=key: Elem(k, MetricType.COUNTER)), "counter", i))
    sum_id = magg.AggID.compress([magg.AggType.SUM])
    last_id = magg.AggID.compress([magg.AggType.LAST])
    for i in range(n_gauge):
        if i < n_piped:
            pipe = Pipeline((Op.roll(
                b"bench.a10.rollup.%d" % (i % n_rollup_ids), (b"host",),
                sum_id),))
            key = ElemKey(b"bench.a10.g.%d" % i, pol, last_id, pipe)
        else:
            key = ElemKey(b"bench.a10.g.%d" % i, pol)
        elems.append((lst.get_or_create(
            key, lambda k=key: Elem(k, MetricType.GAUGE)), "gauge", i))
    for i in range(n_timer):
        key = ElemKey(b"bench.a10.t.%d" % i, pol)
        elems.append((lst.get_or_create(
            key, lambda k=key: Elem(k, MetricType.TIMER)), "timer", i))
    return lists, elems, n_piped, n_rollup_ids


def agg10x_planes(n: int, seed: int = 31) -> dict:
    """bench_agg_rollup_10x's values: 12 per metric (two 1m windows of 6
    at 10 s) for each kind, drawn from np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return {"counter": rng.poisson(5.0, (n, 12)).astype(np.float64),
            "gauge": rng.standard_normal((n, 12)),
            "timer": rng.lognormal(0.0, 1.0, (n, 12))}


def agg10x_stage(elems, planes: dict) -> None:
    """Stage both windows of every metric (AGG_BASE_NS and one minute
    later) from its row of `planes`."""
    w0, w1 = AGG_BASE_NS, AGG_BASE_NS + 60 * S_NS
    for e, kind, i in elems:
        row = planes[kind][i]
        e.add_values(w0, row[:6])
        e.add_values(w1, row[6:])


def loopback_forward(lst):
    """The agg benches' forward sink: each rollup partial lands in an elem
    of `lst` created on first delivery (the local ForwardedWriter's
    shape), and a round's forwards arrive batched (forward_batch)."""
    from ..aggregator.elem import Elem, ElemKey
    from ..metrics.metric import MetricType

    def forward_fn(new_id, t_nanos, value, meta, source_id):
        key = ElemKey(new_id, meta.storage_policy, meta.aggregation_id,
                      meta.pipeline, meta.num_forwarded_times)
        lst.get_or_create(key, lambda: Elem(key, MetricType.GAUGE)).add_value(
            t_nanos, value)

    forward_fn.forward_batch = lambda items: [forward_fn(*it) for it in items]
    return forward_fn


def hostile_rank_rows(seed: int, b: int, w: int):
    """A [b, w] f32 tile and [b] int32 counts for the flush's rank
    selection: ties, -0.0 and +0.0, NaN of both signs, infinities, and
    empty (the first 4) and full (the next 4) rows."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, w)).astype(np.float32)
    v[:, ::3] = np.round(v[:, ::3])
    v[rng.random((b, w)) < 0.05] = 0.0
    v[rng.random((b, w)) < 0.05] = -0.0
    v[rng.random((b, w)) < 0.04] = np.nan
    v[rng.random((b, w)) < 0.01] = -np.nan
    v[rng.random((b, w)) < 0.01] = np.inf
    v[rng.random((b, w)) < 0.01] = -np.inf
    c = rng.integers(0, w + 1, b).astype(np.int32)
    c[:4] = 0
    c[4:8] = w
    return v, c


def gap_thresholds(values: np.ndarray, k: int, rtol: float = 2e-5,
                   atol_scale: float = 1e-6) -> list:
    """k alert thresholds near the (i + 0.5) / k quantiles of `values`,
    each at the midpoint of a gap between adjacent distinct values that is
    wider on both sides than the compiled route's bound (rtol 2e-5, atol
    1e-6 x max|value|, PERF.md section 2): two answers within that bound
    of each other compare alike against every threshold."""
    v = np.unique(values[np.isfinite(values)])
    atol = atol_scale * float(np.abs(v).max())
    mids = (v[:-1] + v[1:]) / 2
    half = (v[1:] - v[:-1]) / 2
    cand = mids[half > rtol * np.abs(v[1:]) + atol]
    want = np.quantile(v, (np.arange(k) + 0.5) / k)
    return [float(cand[np.argmin(np.abs(cand - w))]) for w in want]


def serve_corpus(n: int = 10_000, hosts: int = 200, seed: int = 61):
    """(series dict, timestamps) of the reference's serving benchmark
    (bench.py bench_query_serve_e2e): n Poisson(5) counters over
    `hosts` hosts, 240 points at 10 s from 1,700,000,000 s, offset by
    1e9 x (1 + i % 4), drawn from np.random.default_rng(seed)."""
    s_ns = 1_000_000_000
    rng = np.random.default_rng(seed)
    t = 1_700_000_000 * s_ns + np.arange(240, dtype=np.int64) * 10 * s_ns
    vals = np.cumsum(rng.poisson(5.0, (n, 240)), axis=1).astype(np.float64)
    vals += 1e9 * (1 + np.arange(n)[:, None] % 4)
    series = {}
    for i in range(n):
        series[b"bench_requests{i=%d}" % i] = {
            "tags": {b"__name__": b"bench_requests",
                     b"host": b"host-%03d" % (i % hosts),
                     b"i": str(i).encode()},
            "t": t, "v": vals[i]}
    return series, t


def rules_corpus(n_metrics: int, n_mapping: int, n_rollup: int,
                 n_services: int = 500):
    """(RuleSet, samples) of the reference's downsample benchmark
    (bench.py _rules_corpus), in the port's metrics types: per-service
    mapping rules on literal-prefix name globs (every seventh with a dc
    filter, every fifth at 5m:40h), a DROP_MUST class on drop_*, and
    rollup rules whose first op is the rollup; samples are (tags, t,
    value, metric type) rows, gauge/counter/timer in turn, 2% drop_*."""
    from ..metrics.aggregation import AggID, AggType
    from ..metrics.filters import TagsFilter
    from ..metrics.metric import MetricType
    from ..metrics.pipeline import Op, Pipeline
    from ..metrics.policy import DropPolicy, StoragePolicy
    from ..metrics.rules import (MappingRuleSnapshot, RollupRuleSnapshot,
                                 RollupTarget, Rule, RuleSet)

    pol_1m = (StoragePolicy.parse("1m:40h"),)
    pol_5m = (StoragePolicy.parse("5m:40h"),)
    mapping = []
    for k in range(n_mapping):
        svc = k % n_services
        filt = {"__name__": f"svc{svc:03d}_*"}
        if k % 7 == 0:
            filt["dc"] = "east" if k % 2 else "west"
        mapping.append(Rule([MappingRuleSnapshot(
            f"map-{k}", 0, TagsFilter(filt),
            storage_policies=pol_5m if k % 5 == 0 else pol_1m)]))
    mapping.append(Rule([MappingRuleSnapshot(
        "map-drop", 0, TagsFilter({"__name__": "drop_*"}),
        storage_policies=pol_1m, drop_policy=DropPolicy.DROP_MUST)]))
    rollup = []
    for k in range(n_rollup):
        svc = (k * 3) % n_services
        pipe = Pipeline((Op.roll(b"rollup_svc%03d" % svc, (b"dc",),
                                 AggID.compress([AggType.SUM])),))
        rollup.append(Rule([RollupRuleSnapshot(
            f"roll-{k}", 0, TagsFilter({"__name__": f"svc{svc:03d}_*"}),
            (RollupTarget(pipe, pol_1m),))]))
    rs = RuleSet(b"default", 1, mapping, rollup)
    types = (MetricType.GAUGE, MetricType.COUNTER, MetricType.TIMER)
    samples = []
    t0 = 1_700_000_000 * 1_000_000_000
    for i in range(n_metrics):
        if i % 50 == 49:
            name = b"drop_%d" % i
        else:
            name = b"svc%03d_lat_%d" % (i % n_services, i)
        tags = {b"__name__": name, b"host": b"h%02d" % (i % 64),
                b"dc": b"east" if i % 2 else b"west",
                b"endpoint": b"e%02d" % (i % 16)}
        samples.append((tags, t0, float(i % 97) + 0.5, types[i % 3]))
    return rs, samples


from .cluster import ClusterHarness, ClusterNode, make_node_server  # noqa: E402
from .faultnet import FaultPlan, FaultProxy  # noqa: E402
from .scenario import (  # noqa: E402
    ChurnScenario,
    ChurnScenarioOptions,
    ScenarioResult,
    WriteLedger,
)
