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
storage (bench.py bench_promql / bench_promql_plan_agg). write_corpus
writes such a corpus into a storage Database in time order."""

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
