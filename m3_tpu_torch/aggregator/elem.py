"""Aggregation elements: per-(id, storage policy, agg types, pipeline) windowed
state (reference: src/aggregator/aggregator/generic_elem.go:116 and the genny
instantiations counter_elem_gen.go / gauge_elem_gen.go / timer_elem_gen.go).

Batched redesign: the reference's elem holds one locked aggregation struct
per time bucket and folds values in scalar-at-a-time (generic_elem.go:199
AddUnion -> lockedAgg.Add). Here an elem only *stages* raw values columnar
per bucket (cheap numpy appends on the ingest path); all reduction work is
deferred to consume time, where the owning metric list pads every closed
bucket of every elem into one (buckets x values) tile and reduces them in a
single batched reduce (see list.py): host-exact f64 moments, and the
timer quantile ordering on the device. That keeps the ingest path free of
device transfers.

Host copy of m3_tpu/aggregator/elem.py, with its race-witness
registration.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..metrics import aggregation as magg
from ..metrics.metadata import ForwardMetadata
from ..metrics.metric import MetricType, MetricUnion
from ..metrics.pipeline import OpType, Pipeline
from ..metrics.policy import StoragePolicy
from ..metrics.transformation import TransformType, apply as apply_transform, Datapoint


@dataclasses.dataclass(frozen=True)
class ElemKey:
    """Identity of one aggregation element (aggregator/elem_base.go elemBase:
    id x storage policy x aggregation types x remaining pipeline)."""

    metric_id: bytes
    storage_policy: StoragePolicy
    aggregation_id: int = 0
    pipeline: Pipeline = Pipeline()
    num_forwarded_times: int = 0


def _concat(staged) -> np.ndarray:
    """One window's staged value(s) -> one array. A bucket holds the
    ndarray itself after a single columnar add (the ingest fast path —
    zero copies, zero wrappers) and degrades to a chunk list only when a
    window receives multiple adds."""
    if type(staged) is not list:
        return staged
    if len(staged) == 1:
        return staged[0]
    if not staged:
        return np.empty(0, dtype=np.float64)
    return np.concatenate(staged)


class EmitClass:
    """Shared emission shape of every elem with the same (agg types,
    quantiles, policy, piped) signature — the unit the columnar flush
    (list.py emit_batch) groups rows by. Interned process-wide so the
    per-window classification in the collect hot loop is one identity-
    hashed dict lookup, never a tuple hash of enums and policies."""

    __slots__ = ("agg_types", "quantiles", "policy", "res_ns", "piped",
                 "needed", "q_idx")

    def __init__(self, agg_types, quantiles, policy, piped: bool):
        self.agg_types = agg_types
        self.quantiles = quantiles
        self.policy = policy
        self.res_ns = policy.resolution.window_ns
        self.piped = piped
        # Moment columns this class's emissions read; the flush only
        # ever computes these for the class's buckets ("count" is always
        # available — it gates the empty-window defaults).
        self.needed = frozenset(
            k for at in agg_types if at.quantile() is None
            for k in STAT_DEPS[at])
        # Quantile agg type -> POSITION in `quantiles` (tuple-index
        # keying: emission never looks a quantile up by float equality).
        self.q_idx: Dict["magg.AggType", int] = {
            at: quantiles.index(q) for at in agg_types
            if (q := at.quantile()) is not None}


_EMIT_CLASSES: Dict[tuple, EmitClass] = {}
_EMIT_CLASSES_LOCK = threading.Lock()


def _emit_class_for(agg_types, quantiles, policy, piped: bool) -> EmitClass:
    key = (agg_types, quantiles, policy, piped)
    cls = _EMIT_CLASSES.get(key)
    if cls is None:
        # Check-then-create under the lock: elems are constructed from
        # concurrent connection-handler threads.
        with _EMIT_CLASSES_LOCK:
            cls = _EMIT_CLASSES.get(key)
            if cls is None:
                cls = _EMIT_CLASSES[key] = EmitClass(
                    agg_types, quantiles, policy, piped)
    return cls


class Elem:
    """One metric's windowed aggregation state for one storage policy.

    add_union/add_value stage values into the bucket for the aligned window;
    closed_buckets hands (window_start, values) pairs to the list's batched
    consumer and drops them (generic_elem.go:264 Consume).
    """

    __slots__ = ("key", "metric_type", "agg_types", "resolution_ns",
                 "_quantiles", "_q_idx", "_out_ids", "_out_tuple",
                 "_simple_type", "_eclass", "_buckets",
                 "_degraded", "_lock", "_prev", "tombstoned")

    def __init__(self, key: ElemKey, metric_type: MetricType,
                 agg_types: Optional[Sequence[magg.AggType]] = None):
        self.key = key
        self.metric_type = metric_type
        if agg_types is None:
            if key.aggregation_id == magg.AggID.DEFAULT:
                agg_types = magg.default_types_for(metric_type)
            else:
                agg_types = magg.AggID.decompress(key.aggregation_id)
        self.agg_types: Tuple[magg.AggType, ...] = tuple(agg_types)
        self.resolution_ns = key.storage_policy.resolution.window_ns
        # Static per-elem facts, precomputed: the flush hot loop touches
        # every elem every window, and recomputing these 250k times per
        # flush dominated the aggregation tier's cost.
        self._quantiles: Tuple[float, ...] = tuple(
            sorted({q for t in self.agg_types
                    if (q := t.quantile()) is not None}))
        # Quantile agg type -> POSITION in self._quantiles: emission
        # looks quantile values up by tuple index, so a recomputed float
        # can never miss on bit inequality (reduce paths hand emit a
        # value row aligned to this tuple).
        self._q_idx: Dict[magg.AggType, int] = {
            at: self._quantiles.index(q) for at in self.agg_types
            if (q := at.quantile()) is not None}
        self._out_ids: Dict[magg.AggType, bytes] = {
            at: self._output_id(at) for at in self.agg_types}
        # Positionally aligned with agg_types: the columnar emit indexes
        # output ids by agg-type position (int index beats an enum-keyed
        # dict hash in the 2M-output flush loop).
        self._out_tuple: Tuple[bytes, ...] = tuple(
            self._out_ids[at] for at in self.agg_types)
        # The vectorized-emission shape (list.py reduce_and_emit_ref): ONE
        # non-quantile agg type, no pipeline — counters (Sum) and gauges
        # (Last), i.e. the overwhelming majority of a metrics workload.
        self._simple_type: Optional[magg.AggType] = (
            self.agg_types[0]
            if (key.pipeline.is_empty() and len(self.agg_types) == 1
                and self.agg_types[0].quantile() is None)
            else None)
        # Columnar-flush grouping handle (list.py emit_batch), interned
        # so collect classifies each window by one identity hash.
        self._eclass: EmitClass = _emit_class_for(
            self.agg_types, self._quantiles, key.storage_policy,
            not key.pipeline.is_empty())
        # start -> list of staged value chunks (plain list: the ingest
        # path appends, the collect path concatenates; no per-bucket
        # object or method dispatch on either hot loop).
        self._buckets: Dict[int, List[np.ndarray]] = {}
        # True while this elem's staging MAY hold chunk-list merges (a
        # window received a second add). Collect skips the per-window
        # _concat/reconcile pass until then; reset under the lock once a
        # drain leaves no buckets behind.
        self._degraded = False
        # Serializes slot MUTATION against the flush drain (the
        # reference's per-elem lockedAggregation, generic_elem.go): a
        # first add of a window inserts lock-free (a fresh key can never
        # resurrect flushed data), but degrading a slot to a chunk list
        # and the collect-time pops hold this lock, so a racing flush
        # can never emit a window and then see its data re-staged.
        self._lock = threading.Lock()
        # Per-pipeline-transform previous datapoint, for binary transforms
        # (PerSecond needs the prior window's value: generic_elem.go:300
        # processValueWithAggregationLock keeps lastConsumedValues).
        self._prev: Dict[int, Datapoint] = {}
        self.tombstoned = False

    # -- ingest path -------------------------------------------------------

    def _stage(self, t_nanos: int, values: np.ndarray):
        """Stage one value array into its aligned window. The first add
        stores the array itself (the columnar ingest path stages each
        window exactly once — no wrapper, no chunk list); later adds to
        the same window degrade the slot to a chunk list, concatenated
        lazily at collect time (_concat)."""
        start = t_nanos - t_nanos % self.resolution_ns
        b = self._buckets
        cur = b.get(start)
        if cur is None:
            # lock-free fast path: the common staging shape is exactly
            # one columnar add per window, and inserting a FRESH key can
            # neither disturb a concurrent drain's snapshot (a key
            # inserted after sorted() simply survives for the next
            # round) nor resurrect popped data
            b[start] = values
            return
        with self._lock:
            # Degraded staging (multi-add to one window). The flag is
            # STICKY and set BEFORE the merge becomes visible: a drain
            # that pops a merged slot — or whose popped window gets
            # merged back by this path — is guaranteed to observe
            # _degraded on its post-pop read (GIL total order) and run
            # the locked reconciliation sweep. Keys are NEVER removed
            # here (get-then-merge only), so the drain's plain C pops
            # can never miss.
            self._degraded = True
            cur = b.get(start)
            if cur is None:
                # a racing drain popped (and will emit) the window: the
                # late value starts a FRESH slot, emitted next round
                b[start] = values
            elif type(cur) is list:
                # in place: a drain that already popped this list sees
                # the chunk or not (torn adds stage-or-drop exactly
                # once, the pre-rebuild _Bucket semantics)
                cur.append(values)
            else:
                # slot re-creation is the one hazard (cur may be popped
                # and emitted between our get and this set) — the
                # drain's reconciliation sweep drops just-emitted chunks
                # from merged-back slots by identity, under this lock
                b[start] = [cur, values]

    def add_union(self, t_nanos: int, mu: MetricUnion):
        if mu.type == MetricType.COUNTER:
            self._stage(t_nanos, np.asarray([mu.counter_val], dtype=np.float64))
        elif mu.type == MetricType.GAUGE:
            self._stage(t_nanos, np.asarray([mu.gauge_val], dtype=np.float64))
        elif mu.type == MetricType.TIMER:
            self._stage(t_nanos, np.asarray(mu.batch_timer_val, dtype=np.float64))
        else:
            raise ValueError(f"invalid metric type {mu.type}")

    def add_value(self, t_nanos: int, value: float):
        self._stage(t_nanos, np.asarray([value], dtype=np.float64))

    def add_values(self, t_nanos: int, values: np.ndarray):
        self._stage(t_nanos, np.asarray(values, dtype=np.float64))

    # -- consume path ------------------------------------------------------

    def closed_buckets(self, target_nanos: int) -> List[Tuple[int, np.ndarray]]:
        """Pop buckets whose window has fully closed before target_nanos."""
        out = []
        with self._lock:  # same drain-vs-degrade discipline as collect_into
            for start in sorted(self._buckets):
                if start + self.resolution_ns <= target_nanos:
                    out.append((start, _concat(self._buckets.pop(start))))
            if not self._buckets:
                self._degraded = False  # no surviving chunk merges
        return out

    def is_empty(self) -> bool:
        return not self._buckets

    # -- post-reduction emission ------------------------------------------

    def quantiles_needed(self) -> Tuple[float, ...]:
        return self._quantiles

    def emit(self, window_start: int, stats_row: Dict[str, float],
             quantile_vals: Sequence[float],
             flush_fn: Callable, forward_fn: Optional[Callable] = None):
        """Turn one reduced window into flushed datapoints (the per-window
        scalar path, used by the retained host oracle reduce_and_emit_ref;
        the production columnar path is list.py emit_batch).

        flush_fn(metric_id, time_nanos, value, storage_policy) per agg type;
        an elem with remaining pipeline ops instead applies transforms and
        forwards through forward_fn (aggregator/forwarded_writer.go).
        `quantile_vals` is positionally aligned with self._quantiles and
        indexed through _q_idx — a tuple-index lookup, so a recomputed
        quantile float can never miss on bit inequality. Timestamp is the
        window end, matching the reference's convention
        (generic_elem.go:283 timestamp = timeNanos + resolution).
        """
        end_nanos = window_start + self.resolution_ns
        # The per-window scalar emit exists to serve the retained
        # bit-exactness oracle (reduce_and_emit_ref); production flushes
        # batch through list.py emit_batch and never take this loop.
        # m3lint: disable=per-datapoint-callback-in-flush
        for at in self.agg_types:
            if at in self._q_idx:
                value = quantile_vals[self._q_idx[at]]
            else:
                value = _stat_value(at, stats_row)
            if self.key.pipeline.is_empty():
                flush_fn(self._out_ids[at], end_nanos, value, self.key.storage_policy)
            else:
                self._process_pipeline(at, end_nanos, value, flush_fn, forward_fn)

    def _process_pipeline(self, at, t_nanos: int, value: float,
                          flush_fn, forward_fn, forward_sink=None):
        """Apply the remaining pipeline ops to one reduced value.

        With `forward_sink` (a list), rollup outputs are APPENDED as
        (new_id, t_nanos, value, meta, source_id) instead of calling
        forward_fn per datapoint — the columnar flush coalesces the
        round's forwards into per-destination batches (list.py
        emit_batch -> ForwardedWriter.forward_batch)."""
        ops = self.key.pipeline.ops
        dp = Datapoint(t_nanos, value)
        for i, op in enumerate(ops):
            if op.type == OpType.TRANSFORMATION:
                tt: TransformType = op.transformation
                prev = self._prev.get(int(at))
                if tt.is_binary() and prev is None:
                    self._prev[int(at)] = dp
                    return
                out = apply_transform(tt, prev, dp)
                self._prev[int(at)] = dp
                if out.time_nanos == 0 and math.isnan(out.value):
                    # Empty transform output (transformation/binary.go
                    # emptyDatapoint: NaN input, non-increasing time, or
                    # negative diff): never emitted or forwarded — the
                    # reference's default DiscardNaNAggregatedValues. A
                    # forwarded (t=0, NaN) would stage a bogus epoch-0
                    # window in the next aggregation stage.
                    return
                dp = out
            elif op.type == OpType.ROLLUP:
                if forward_sink is None and forward_fn is None:
                    return
                rop = op.rollup
                meta = ForwardMetadata(
                    aggregation_id=rop.aggregation_id,
                    storage_policy=self.key.storage_policy,
                    pipeline=self.key.pipeline.sub(i + 1),
                    source_id=self.key.metric_id,
                    num_forwarded_times=self.key.num_forwarded_times + 1,
                )
                if forward_sink is not None:
                    forward_sink.append((rop.new_name, dp.time_nanos,
                                         dp.value, meta, self.key.metric_id))
                else:
                    forward_fn(rop.new_name, dp.time_nanos, dp.value, meta,
                               self.key.metric_id)
                return
            else:
                raise ValueError(f"unsupported pipeline op {op.type} in elem")
        flush_fn(self._out_ids[at], dp.time_nanos, dp.value, self.key.storage_policy)

    def _output_id(self, at: magg.AggType) -> bytes:
        """Aggregated output ID: metric name + '.' + type suffix, suppressed
        when the type is the metric type's single default (types_options.go
        default type strings; counters default to bare 'id' for Sum, gauges
        for Last). The suffix lands on the NAME component of a canonical
        'name;tag=v' ID (metrics/id.py) so tag values stay intact."""
        defaults = magg.default_types_for(self.metric_type)
        if len(defaults) == 1 and self.agg_types == tuple(defaults):
            return self.key.metric_id
        name, sep, rest = self.key.metric_id.partition(b";")
        suffixed = name + b"." + at.type_string.encode()
        return suffixed + sep + rest if rest else suffixed


# Moment columns each non-quantile agg type reads ("count" is always
# available — it gates the empty-window defaults).
STAT_DEPS: Dict[magg.AggType, Tuple[str, ...]] = {
    magg.AggType.SUM: ("sum",), magg.AggType.SUMSQ: ("sumsq",),
    magg.AggType.COUNT: (), magg.AggType.MIN: ("min",),
    magg.AggType.MAX: ("max",), magg.AggType.LAST: ("last",),
    magg.AggType.MEAN: ("sum",), magg.AggType.STDEV: ("m2",),
}


def stat_column(at: magg.AggType, m: Dict[str, np.ndarray]):
    """Output value(s) for one non-quantile agg type over moment COLUMNS
    (list.py's vectorized flush emission). _stat_value below is its
    plain-float twin for the per-window scalar emit path — same mapping,
    same empty-window defaults; change both together (tests assert their
    parity)."""
    cnt = m["count"]
    if at == magg.AggType.SUM:
        return m["sum"]
    if at == magg.AggType.SUMSQ:
        return m["sumsq"]
    if at == magg.AggType.COUNT:
        return cnt
    if at == magg.AggType.MIN:
        return np.where(cnt > 0, m["min"], 0.0)
    if at == magg.AggType.MAX:
        return np.where(cnt > 0, m["max"], 0.0)
    if at == magg.AggType.LAST:
        return m["last"]
    if at == magg.AggType.MEAN:
        return np.where(cnt > 0, m["sum"] / np.maximum(cnt, 1), 0.0)
    if at == magg.AggType.STDEV:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(cnt > 1,
                            np.sqrt(m["m2"] / np.maximum(cnt - 1, 1)), 0.0)
    raise ValueError(f"no stat mapping for {at}")


def _stat_value(at: magg.AggType, stats: Dict[str, float]) -> float:
    """Plain-float twin of stat_column for the per-window scalar emit path:
    one call per agg type per window is a hot loop for timers/pipelines,
    and routing scalars through numpy's where/errstate boxing is ~7x
    slower than float branches (same arithmetic, same empty-window
    defaults)."""
    cnt = stats["count"]
    if at == magg.AggType.SUM:
        return float(stats["sum"])
    if at == magg.AggType.SUMSQ:
        return float(stats["sumsq"])
    if at == magg.AggType.COUNT:
        return float(cnt)
    if at == magg.AggType.MIN:
        return float(stats["min"]) if cnt > 0 else 0.0
    if at == magg.AggType.MAX:
        return float(stats["max"]) if cnt > 0 else 0.0
    if at == magg.AggType.LAST:
        return float(stats["last"])
    if at == magg.AggType.MEAN:
        return float(stats["sum"]) / cnt if cnt > 0 else 0.0
    if at == magg.AggType.STDEV:
        return math.sqrt(stats["m2"] / (cnt - 1)) if cnt > 1 else 0.0
    raise ValueError(f"no stat mapping for {at}")



# Runtime race witness registration (utils/racewatch.py), as the
# reference registers it: _buckets is the lock-free fresh-key fast path;
# _degraded is lock-protected and rides along as a witnessed locked pair
# (its cross-thread accesses should share Elem._lock). Both are slots:
# the witness wraps the slot descriptors.
from ..utils import racewatch as _racewatch  # noqa: E402

_racewatch.register(Elem, "_buckets", "_degraded")
