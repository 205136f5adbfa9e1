"""Metric lists: per-resolution collections of elems with batched device
consumption (reference: src/aggregator/aggregator/list.go:296 Flush).

The reference walks a linked list of elems and calls Consume on each, which
re-reduces one locked struct per bucket. Here the flush is columnar end to
end: collect_into pops every closed bucket across all elems straight into a
FlushBatch (parallel row columns grouped by interned EmitClass — no
per-window job tuples), emit_batch reduces each class with host-exact f64
moments (np.reduceat, the reference's float64-accumulator contract) plus ONE
device call for the exact sort-based timer quantile ordering
(parallel/agg_flush.py), and emission lands as array slices — one columnar handler call or one tight
per-class loop, never a Python callback chain per datapoint. Rollup-pipeline
forwards coalesce into a per-round sink that ships as per-destination
batches (ForwardedWriter.forward_batch).

The per-window host flush is retained as `reduce_and_emit_ref`, the
bit-exactness oracle: tests/test_torch_aggregator.py and chip_smoke.py hold
the columnar path bit-identical to it across counter/gauge/timer mixes,
empty/NaN windows and pipeline forwarding.

Port of m3_tpu/aggregator/list.py. The lists, the flush and the oracle
take a `device` (None: the card, raising without one; "cpu": the plain
torch ops) on which the quantile ordering runs.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import deque
from itertools import repeat
from operator import attrgetter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ops import aggregation as aggops
from ..parallel import agg_flush
from .elem import STAT_DEPS, Elem, ElemKey, EmitClass, _concat, stat_column

_LANE = agg_flush.LANE  # pad the value axis to lane multiples (shared rule)


def _columnar_moments(buckets: List[np.ndarray], needed=None) -> dict:
    """Mergeable moments over a ragged bucket list as COLUMNAR f64 arrays
    (np.reduceat — exact f64, matching the reference's float64
    accumulators): sum/sumsq/count/min/max/first/last/m2, each [B].

    `needed` limits which columns are computed ("count" always is): a
    pure counter/gauge flush only pays for the sums/lasts it emits, not
    the m2 chain's extra full-length passes."""
    need = set(_STAT_KEYS if needed is None else needed)
    counts = np.fromiter(map(attrgetter("size"), buckets), np.int64,
                         len(buckets))
    nonempty = counts > 0
    if nonempty.all():
        cat = np.concatenate(buckets)
        sizes = counts
    else:
        safe = [b if b.size else np.zeros(1) for b in buckets]
        sizes = np.maximum(counts, 1)
        cat = np.concatenate(safe)
    starts = np.zeros(len(buckets), dtype=np.int64)
    starts[1:] = np.cumsum(sizes)[:-1]
    m = {"count": counts.astype(np.float64)}
    if need & {"sum", "m2"}:
        m["sum"] = sums = np.where(nonempty, np.add.reduceat(cat, starts), 0.0)
    if "sumsq" in need:
        m["sumsq"] = np.where(nonempty, np.add.reduceat(cat * cat, starts), 0.0)
    if "min" in need:
        m["min"] = np.where(nonempty, np.minimum.reduceat(cat, starts), np.inf)
    if "max" in need:
        m["max"] = np.where(nonempty, np.maximum.reduceat(cat, starts), -np.inf)
    if "first" in need:
        m["first"] = np.where(nonempty, cat[starts], 0.0)
    if "last" in need:
        m["last"] = np.where(nonempty, cat[starts + sizes - 1], 0.0)
    if "m2" in need:
        mu = np.where(nonempty, sums / sizes, 0.0)
        dev = cat - np.repeat(mu, sizes)
        m["m2"] = np.where(nonempty, np.add.reduceat(dev * dev, starts), 0.0)
    return m


def _quantile_rows_for(buckets: List[np.ndarray], qs: Tuple[float, ...],
                       device=None):
    """Batched device quantile ordering over a bucket list -> per-bucket
    {q: value} dicts (host gathers exact f64 values by device index).
    Serves the retained oracle path and batched_reduce; the production
    flush orders through parallel/agg_flush.exact_quantile_values.

    The sort runs on the device in f32; only indices come back, and the
    host reads the exact f64 values by index (ties at f32 granularity
    pick either of two values that agree to 2^-24, far inside the
    reference CM sketch's eps-rank tolerance)."""
    counts = np.array([b.size for b in buckets], dtype=np.int64)
    max_n = max(1, int(counts.max()))
    width = ((max_n + _LANE - 1) // _LANE) * _LANE
    tile = np.zeros((len(buckets), width), dtype=np.float32)
    for i, b in enumerate(buckets):
        tile[i, : b.size] = b
    dev = resolve(device)
    idx = aggops.quantile_rank_select(
        torch.from_numpy(tile).to(dev),
        torch.from_numpy(counts.astype(np.int32)).to(dev), qs).cpu().numpy()
    return [
        {
            q: float(buckets[i][min(idx[i, j], counts[i] - 1)]) if counts[i] else 0.0
            for j, q in enumerate(qs)
        }
        for i in range(len(buckets))
    ]


def batched_reduce(buckets: List[np.ndarray], qs: Tuple[float, ...],
                   device=None):
    """Reduce a ragged list of value arrays: mergeable moments + quantiles.

    Moments are one vectorized host pass (_columnar_moments); the heavy
    O(W log W) work, batched quantile ordering, runs on device. Returns
    (stats_rows, quantile_rows): per-bucket dicts of python floats.
    """
    if not buckets:
        return [], []
    m = _columnar_moments(buckets)
    stats_rows = _stats_rows(m, range(len(buckets)))
    if not qs:
        return stats_rows, [{} for _ in buckets]
    return stats_rows, _quantile_rows_for(buckets, qs, device)


def _stats_rows(m: dict, idxs) -> list:
    cols = [m[k] for k in _STAT_KEYS]
    return [dict(zip(_STAT_KEYS, (float(c[i]) for c in cols))) for i in idxs]


_STAT_KEYS = ("sum", "sumsq", "count", "min", "max", "first", "last", "m2")

def _reconcile_degraded(elem, b, vals):
    """Degraded-elem drain epilogue (rare; gated on the sticky
    `_degraded` flag a merging `_stage` sets BEFORE its merge becomes
    visible, so every drain that popped a merged slot lands here).

    Under the elem lock — serialized against further merges — this
    (1) normalizes popped chunk lists via `_concat`, and (2) sweeps the
    surviving buckets for the one lock-free hazard left: a merge that
    re-created a just-popped slot as [popped_chunk, late_value]. Chunks
    IDENTICAL (by id) to anything this drain popped are dropped from
    surviving slots, so an emitted window can never be re-emitted;
    identities are stable because `vals` keeps every popped object
    alive for the duration. Returns the normalized vals."""
    with elem._lock:
        emitted = set(map(id, vals))
        for v in vals:
            if type(v) is list:
                emitted.update(map(id, v))
        for s in list(b):
            slot = b[s]
            if type(slot) is list:
                keep = [c for c in slot if id(c) not in emitted]
                if len(keep) != len(slot):
                    if keep:
                        b[s] = keep
                    else:
                        del b[s]
        if not b:
            # nothing survives, so no chunk merge can be outstanding: a
            # stager racing this reset re-sets the flag under this same
            # lock before its merge becomes visible
            elem._degraded = False
        return [_concat(v) for v in vals]


# --------------------------------------------------------------- columnar flush


class _ClassRows:
    """Parallel row columns for one EmitClass: one starts/buckets entry
    per closed window; elems stored run-length ((elem, n_windows) runs —
    windows of one elem are contiguous and ascending), so the collect
    loop appends one run instead of repeating the elem per window and
    the id-column build expands runs with C-level list repeats."""

    __slots__ = ("runs", "starts", "buckets")

    def __init__(self):
        self.runs: List[tuple] = []
        self.starts: List[int] = []
        self.buckets: List[np.ndarray] = []


class FlushBatch:
    """Columnar staged flush: every closed window of one flush round —
    gathered across resolutions, lists and aggregation shards — grouped
    by interned EmitClass. This is the input of ONE emit_batch reduce,
    so all aggregation shards flush in one device call."""

    __slots__ = ("classes",)

    def __init__(self):
        self.classes: Dict[EmitClass, _ClassRows] = {}

    def rows_for(self, cls: EmitClass) -> _ClassRows:
        rows = self.classes.get(cls)
        if rows is None:
            rows = self.classes[cls] = _ClassRows()
        return rows

    def add(self, elem: Elem, start: int, values: np.ndarray):
        rows = self.rows_for(elem._eclass)
        rows.runs.append((elem, 1))
        rows.starts.append(start)
        rows.buckets.append(values)

    def __len__(self):
        return sum(len(r.starts) for r in self.classes.values())


def emit_batch(batch: FlushBatch, flush_fn: Callable,
               forward_fn: Optional[Callable] = None, device=None) -> int:
    """Reduce + emit one columnar flush batch.

    Per class: host-exact f64 moments over the class's buckets; quantile
    classes additionally feed ONE ordering call on `device` covering
    every quantile row of the round (agg_flush.exact_quantile_values —
    timer quantile ordering on the device, exact f64 values landed by
    one columnar gather). Emission consumes the result as array slices:
    a flush_fn exposing `handle_columnar` receives the round's columnar
    groups in ONE call; plain callables get a tight per-class loop.
    Rollup forwards collect into one sink, shipped per-destination via
    forward_fn.forward_batch when available."""
    classes = batch.classes
    if not classes:
        return 0
    # ---- one device ordering pass over every quantile row of the round
    q_slices: Dict[EmitClass, tuple] = {}
    q_classes = [(cls, rows) for cls, rows in classes.items() if cls.quantiles]
    if q_classes:
        qs = tuple(sorted({q for cls, _ in q_classes for q in cls.quantiles}))
        q_buckets: List[np.ndarray] = []
        spans = []
        for cls, rows in q_classes:
            spans.append((cls, len(q_buckets), len(q_buckets) + len(rows.buckets)))
            q_buckets.extend(rows.buckets)
        counts = np.fromiter((b.size for b in q_buckets), np.int64,
                             len(q_buckets))
        vals = agg_flush.exact_quantile_values(q_buckets, counts, qs,
                                               device)
        # Column indices resolved per CLASS (a handful per round), then
        # consumed positionally per row — the tuple-index keying that
        # replaces the old per-row float-equality quantile lookup.
        pos = {q: j for j, q in enumerate(qs)}
        for cls, a, b in spans:
            q_slices[cls] = vals[a:b][:, [pos[q] for q in cls.quantiles]]

    n = 0
    fsink: Optional[list] = [] if forward_fn is not None else None
    columnar = getattr(flush_fn, "handle_columnar", None)
    col_groups: Optional[list] = [] if columnar is not None else None
    # C-speed consumer for the map-driven callback shim: maxlen=0 KEEPS
    # NOTHING by design (it exists to drive the map, not to buffer).
    drain = deque(maxlen=0).extend  # m3lint: disable=unbounded-queue
    for cls, rows in classes.items():
        m = _columnar_moments(rows.buckets, cls.needed)
        nrows = len(rows.starts)
        n += nrows
        ends_arr = np.asarray(rows.starts, dtype=np.int64) + cls.res_ns
        qv = q_slices.get(cls)
        ends_l = None
        if cls.piped:
            ends_l = ends_arr.tolist()
            for at in cls.agg_types:
                qi = cls.q_idx.get(at)
                col = qv[:, qi] if qi is not None else stat_column(at, m)
                vl = np.asarray(col, dtype=np.float64).tolist()
                # Transforms are stateful per elem (prev-window datapoint),
                # so pipelines stay per-row — but rollup forwards append to
                # the shared sink and ship batched after the loop.
                i = 0
                for e, k in rows.runs:
                    pp = e._process_pipeline
                    for r in range(i, i + k):
                        pp(at, ends_l[r], vl[r], flush_fn, forward_fn,
                           fsink)
                    i += k
        else:
            for j, at in enumerate(cls.agg_types):
                qi = cls.q_idx.get(at)
                col = qv[:, qi] if qi is not None else stat_column(at, m)
                col = np.asarray(col, dtype=np.float64)
                if len(rows.runs) == nrows:  # all single-window runs
                    ids = [e._out_tuple[j] for e, _ in rows.runs]
                else:
                    ids = []
                    id_append, id_extend = ids.append, ids.extend
                    for e, k in rows.runs:
                        if k == 1:
                            id_append(e._out_tuple[j])
                        else:
                            id_extend([e._out_tuple[j]] * k)
                if col_groups is not None:
                    col_groups.append((ids, ends_arr, col, cls.policy))
                    continue
                if ends_l is None:
                    ends_l = ends_arr.tolist()
                # Compat shim for plain-callable sinks (tests, capture
                # lambdas): per-datapoint callbacks, but driven by the C
                # map loop; batch-capable handlers take the single
                # handle_columnar call below instead.
                drain(map(flush_fn, ids, ends_l, col.tolist(),
                          repeat(cls.policy)))
    if col_groups:
        columnar(col_groups)
    if fsink:
        forward_batch = getattr(forward_fn, "forward_batch", None)
        if forward_batch is not None:
            forward_batch(fsink)
        else:
            # Compat shim for plain-callable forward sinks (tests, the
            # embedded downsampler); routed writers batch per
            # destination through forward_batch above.
            # m3lint: disable=per-datapoint-callback-in-flush
            for item in fsink:
                forward_fn(*item)
    return n


def reduce_and_emit(jobs, device=None) -> int:
    """Reduce a batch of (elem, window_start, values, flush_fn, forward_fn)
    jobs — possibly gathered across many lists and shards — in one columnar
    pass, then emit each window through its sink.

    Compat shim over FlushBatch/emit_batch for tuple-job callers; the hot
    flush paths (MetricList.flush, Aggregator.flush) collect straight into
    a FlushBatch and never build per-window tuples."""
    if not jobs:
        return 0
    groups: Dict[tuple, tuple] = {}
    for j in jobs:
        key = (id(j[3]), id(j[4]))
        g = groups.get(key)
        if g is None:
            g = groups[key] = (FlushBatch(), j[3], j[4])
        g[0].add(j[0], j[1], j[2])
    for grp_batch, f, fw in groups.values():
        emit_batch(grp_batch, f, fw, device)
    return len(jobs)


def reduce_and_emit_ref(jobs, device=None) -> int:
    """The per-window host flush, retained as the bit-exactness oracle
    for the columnar path: reduces each job with the same host f64
    moments, orders quantiles through _quantile_rows_for on `device`
    (one tile filled row by row, no guard), and emits per window through
    Python callbacks. tests/test_torch_aggregator.py and chip_smoke.py
    hold emit_batch's output bit-identical to this."""
    if not jobs:
        return 0
    slow_idx = [i for i, j in enumerate(jobs) if j[0]._simple_type is None]
    if slow_idx:
        needed = None  # slow emit reads the full stats row
    else:
        needed = {k for j in jobs for k in STAT_DEPS[j[0]._simple_type]}
    m = _columnar_moments([j[2] for j in jobs], needed)
    # quantile ordering only over the slow jobs that want quantiles
    q_idx = [i for i in slow_idx if jobs[i][0]._quantiles]
    qrows = {}
    if q_idx:
        qs = tuple(sorted({q for i in q_idx for q in jobs[i][0]._quantiles}))
        for i, row in zip(q_idx, _quantile_rows_for(
                [jobs[i][2] for i in q_idx], qs, device)):
            qrows[i] = row
    if slow_idx:
        for i, srow in zip(slow_idx, _stats_rows(m, slow_idx)):
            elem, start, _, flush_fn, forward_fn = jobs[i]
            row = qrows.get(i)
            qvals = [row[q] for q in elem._quantiles] if row else ()
            elem.emit(start, srow, qvals, flush_fn, forward_fn)
    if len(slow_idx) < len(jobs):
        slow = set(slow_idx)
        cols = {}
        for i, (elem, start, _, flush_fn, _fw) in enumerate(jobs):
            if i in slow:
                continue
            at = elem._simple_type
            col = cols.get(at)
            if col is None:
                col = cols[at] = stat_column(at, m)
            flush_fn(elem._out_ids[at], start + elem.resolution_ns,
                     float(col[i]), elem.key.storage_policy)
    return len(jobs)


class MetricList:
    """All elems sharing one resolution (list.go metricList); flushes are
    aligned to resolution boundaries by the flush manager. `device` is
    where the flush's quantile ordering runs (None: the card)."""

    def __init__(self, resolution_ns: int, device=None):
        self.resolution_ns = resolution_ns
        self.device = resolve(device)
        self._elems: Dict[ElemKey, Elem] = {}

    def get_or_create(self, key: ElemKey, factory: Callable[[], Elem]) -> Elem:
        e = self._elems.get(key)
        if e is None:
            e = self._elems[key] = factory()
        elif e.tombstoned:
            # A metadata change removed this key and a later change re-added
            # it before GC drained the elem: revive it, otherwise collect()
            # drops it from the list and cached Entry references write into
            # an orphan that never flushes.
            e.tombstoned = False
        return e

    def __len__(self):
        return len(self._elems)

    def elems(self) -> List[Elem]:
        return list(self._elems.values())

    def collect(self, target_nanos: int) -> List[Tuple[Elem, int, np.ndarray]]:
        """Pop every window closed before target_nanos as (elem, start, values)
        jobs, and GC drained tombstoned elems (list.go removes closed elems).
        Tuple-job compat path (follower discard, tests); the flush hot loop
        uses collect_into."""
        jobs = []
        for elem in self._elems.values():
            for start, vals in elem.closed_buckets(target_nanos):
                jobs.append((elem, start, vals))
        self._elems = {
            k: e for k, e in self._elems.items()
            if not (e.tombstoned and e.is_empty())
        }
        return jobs

    def collect_into(self, target_nanos: int, batch: FlushBatch,
                     already: int = 0) -> Tuple[int, int]:
        """Pop every window closed before target_nanos straight into
        `batch`'s columnar class rows — no per-window tuples, no
        ElemKey re-hashing (GC deletes only the keys that died). With
        `already` (a previous leader's persisted flushed-up-to time),
        covered windows are dropped, not re-emitted. Returns
        (collected, dropped)."""
        res = self.resolution_ns
        classes = batch.classes
        rows_cache: Dict[EmitClass, _ClassRows] = {}
        dead = None
        n = 0
        dropped = 0
        for elem in self._elems.values():
            b = elem._buckets
            if b:
                # Lock-free drain: only this drain ever REMOVES keys
                # (stagers merge get-then-set under elem._lock, never
                # pop), so the plain C pops below cannot miss. Closure
                # is decided off the sorted snapshot itself — a current
                # open window staged just before the snapshot routes to
                # the filtered branch, never the full drain — and a
                # fresh window staged after sorted() survives untouched
                # for the next round.
                if len(b) == 1:
                    # single staged window (half a typical mixed-policy
                    # population): peek, and only pop once the window is
                    # known closed — an open window is never removed, so
                    # a concurrent stage of it can't be clobbered by a
                    # put-back
                    start = next(iter(b))
                    if start + res > target_nanos:
                        continue
                    v = b.pop(start)
                    starts = (start,)
                    if elem._degraded:
                        vals = _reconcile_degraded(elem, b, [v])
                    else:
                        vals = (v,)
                elif (starts := sorted(b))[-1] + res <= target_nanos:
                    # every SNAPSHOTTED bucket is closed (the aligned-
                    # flush common case)
                    vals = list(map(b.pop, starts))
                    if elem._degraded:
                        vals = _reconcile_degraded(elem, b, vals)
                else:
                    starts = [s for s in starts
                              if s + res <= target_nanos]
                    if not starts:
                        continue
                    vals = list(map(b.pop, starts))
                    if elem._degraded:
                        vals = _reconcile_degraded(elem, b, vals)
                if already:
                    lo = bisect_right(starts, already - res)
                    if lo:
                        dropped += lo
                        starts = starts[lo:]
                        vals = vals[lo:]
                k = len(starts)
                if k:
                    cls = elem._eclass
                    rows = rows_cache.get(cls)
                    if rows is None:
                        rows = classes.get(cls)
                        if rows is None:
                            rows = classes[cls] = _ClassRows()
                        rows_cache[cls] = rows
                    rows.runs.append((elem, k))
                    if k == 1:
                        rows.starts.append(starts[0])
                        rows.buckets.append(vals[0])
                    else:
                        rows.starts.extend(starts)
                        rows.buckets.extend(vals)
                    n += k
            if not b and elem.tombstoned:
                if dead is None:
                    dead = []
                dead.append(elem.key)
        if dead:
            for key in dead:
                e = self._elems.get(key)
                if e is not None and e.tombstoned and not e._buckets:
                    del self._elems[key]
        return n, dropped

    def flush(self, target_nanos: int, flush_fn: Callable,
              forward_fn: Optional[Callable] = None) -> int:
        """Consume every window closed before target_nanos across all elems
        in one columnar batched reduction. Returns windows consumed."""
        batch = FlushBatch()
        n, _ = self.collect_into(target_nanos, batch)
        emit_batch(batch, flush_fn, forward_fn, self.device)
        return n


class MetricLists:
    """Resolution -> MetricList registry (list.go metricLists); every list
    orders its quantiles on the registry's device."""

    def __init__(self, device=None):
        self.device = resolve(device)
        self._lists: Dict[int, MetricList] = {}

    def for_resolution(self, resolution_ns: int) -> MetricList:
        lst = self._lists.get(resolution_ns)
        if lst is None:
            lst = self._lists[resolution_ns] = MetricList(resolution_ns,
                                                          self.device)
        return lst

    def resolutions(self) -> List[int]:
        return sorted(self._lists)

    def lists(self) -> List[MetricList]:
        return [self._lists[r] for r in sorted(self._lists)]
