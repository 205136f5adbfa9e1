"""Embedded downsampler: the aggregator running inside the coordinator
(reference: src/cmd/services/m3coordinator/downsample/{downsampler,
metrics_appender,flush_handler,leader_local}.go).

Every incoming write is matched against the KV rule sets; matched samples
feed a local leaderless aggregator whose flush handler writes the
aggregated output back into storage under its aggregated namespace.

Two ingest paths with identical semantics:

  * write_batch — the compiled streaming engine. One batch-matcher pass
    over the batch's encoded ids (metrics/batch_matcher.py via
    Matcher.match_batch: memoized per (rule-set generation, id), one
    inverted-index pass for the misses), then grouped columnar adds into
    the aggregator per (pipeline, policy) metadata class
    (Aggregator.add_untimed_batch) instead of per-metric add_untimed.
  * write_ref — the retained per-metric oracle (metrics_appender.go
    SamplesAppender, verbatim pre-batch shape): re-match, then one
    add_untimed per matched pipeline. The downsample_rules bench and the
    property suite hold the two paths' counters and flushed rows equal.

Flush rides the columnar plane: the aggregator's emit_batch hands
the WHOLE round's (ids, times, values, policy) groups to handle_columnar
in one call; ids decode once through a cross-round memo and rows sink
batched (write_aggregated_batch when the coordinator provides one).

Port of m3_tpu/coordinator/downsample.py. `Downsampler(..., device=None)`
builds its Aggregator on the card (its flush's quantile ordering takes
the agg_flush route there) and raises without one unless given
`device="cpu"`."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..aggregator import Aggregator
from ..aggregator.handler import AggregatedMetric, Handler, _tolist
from ..metrics import id as metric_id
from ..metrics.matcher import Matcher
from ..metrics.metric import MetricType, MetricUnion
from ..metrics.policy import DropPolicy


class _ColumnarFlushHandler(Handler):
    """The embedded flush handler on the columnar plane
    (flush_handler.go downsamplerFlushHandler): per-round batches via
    handle_columnar, per-datapoint handle() kept for the ref path."""

    def __init__(self, downsampler: "Downsampler"):
        self._ds = downsampler

    def handle(self, metric: AggregatedMetric):
        self._ds._on_flushed(metric)

    def handle_columnar(self, groups):
        self._ds._on_flushed_columnar(groups)


class Downsampler:
    def __init__(self, matcher: Matcher,
                 write_aggregated: Callable,
                 clock: Optional[Callable[[], int]] = None,
                 num_shards: int = 16,
                 write_aggregated_batch: Optional[Callable] = None,
                 device=None):
        """write_aggregated(id_bytes, tags_dict, time_nanos, value,
        storage_policy) persists one aggregated sample (flush_handler.go
        downsamplerFlushHandlerWriter.Write). write_aggregated_batch, when
        given, persists a whole flush round of such rows in one call —
        rows are (id, tags, time_nanos, value, storage_policy) tuples.
        device: the embedded Aggregator's (None: the card)."""
        self._matcher = matcher
        self._write = write_aggregated
        self._write_rows = write_aggregated_batch
        # id -> decoded tags (with __name__): standing series decode once
        # across flush rounds, not once per round.
        self._decode_memo: Dict[bytes, Dict[bytes, bytes]] = {}
        # id(MatchResult) -> (result, drop, targets): the per-result add
        # plan, compiled once per memoized match result (holds a strong
        # ref so the id stays valid; identity re-checked on probe).
        self._plan_memo: Dict[int, tuple] = {}
        # metadata class -> canonical instance: the deep tuple hash is
        # paid once per distinct rule class, after which groups key on
        # object identity.
        self._group_intern: Dict[tuple, tuple] = {}
        # Local leader: the embedded aggregator always flushes
        # (downsample/leader_local.go — a single-instance election).
        self._agg = Aggregator(
            num_shards=num_shards, clock=clock,
            flush_handler=_ColumnarFlushHandler(self), device=device)
        self.samples_matched = 0
        self.samples_dropped = 0

    # -- ingest: compiled batch path ---------------------------------------

    def write_batch(self, samples: Sequence[tuple]) -> Tuple[int, int]:
        """One columnar ingest batch of (tags, time_nanos, value,
        metric_type) rows: single match pass, grouped aggregator adds.
        Returns (matched, dropped) — the same per-sample accounting the
        per-metric path keeps in samples_matched/samples_dropped."""
        samples = list(samples)
        # One encoding per tags object: a remote-write body's samples
        # share their series' dict (the samples hold every dict alive,
        # so no id() is reused within the call).
        memo: Dict[int, bytes] = {}
        mids = []
        for tags, _t, _v, _mt in samples:
            mid = memo.get(id(tags))
            if mid is None:
                mid = memo[id(tags)] = _encode_tags(tags)
            mids.append(mid)
        results = self._matcher.match_batch(mids)
        if results is None:
            return 0, 0
        n = len(samples)
        accepted = [False] * n
        dropped = 0
        plan_memo = self._plan_memo
        # metadata class (canonical, by identity) -> (metadatas, rows,
        # unions): one aggregator feed per (pipeline, policy) class.
        groups: Dict[int, tuple] = {}
        first_type: Dict[bytes, object] = {}
        for i in range(n):
            result = results[i]
            rk = id(result)
            plan = plan_memo.get(rk)
            # identity re-check: a recycled id() after a memo eviction
            # must not replay another result's plan
            if plan is None or plan[0] is not result:
                plan = self._compile_plan(result, mids[i])
                if len(plan_memo) >= 262144:
                    plan_memo.clear()
                plan_memo[rk] = plan
            if plan[1]:
                dropped += 1
                continue
            _tags, _t, value, mtype = samples[i]
            for canon, out_id in plan[2]:
                g = groups.get(id(canon))
                if g is None:
                    g = groups[id(canon)] = (canon, [], [])
                g[1].append(i)
                g[2].append(_to_union(mtype, out_id, value))
                if out_id not in first_type:
                    first_type[out_id] = mtype
        # Entry creation is first-write-wins on metric type; pre-create
        # entries in GLOBAL sample order so an output id fed from more
        # than one group resolves its type exactly as the per-metric
        # path would (grouped adds then attach to existing entries).
        ensure = getattr(self._agg, "ensure_entries", None)
        if ensure is not None and first_type:
            ensure(first_type.items())
        for metadatas, rows, mus in groups.values():
            oks = self._agg.add_untimed_batch(mus, metadatas)
            for i, ok in zip(rows, oks):
                if ok:
                    accepted[i] = True
        matched = sum(accepted)
        self.samples_matched += matched
        self.samples_dropped += dropped
        return matched, dropped

    def _compile_plan(self, result, mid: bytes) -> tuple:
        """(result, must_drop, ((canonical metadatas, output id), ...)) —
        every sample sharing this memoized match result feeds the same
        aggregator groups, so the plan compiles once per (generation,
        id). Metadata classes intern to a canonical instance: group
        identity is a pointer compare in the hot loop."""
        metadatas = result.for_existing_id
        if _must_drop(metadatas):
            return (result, True, ())
        intern = self._group_intern
        targets = []
        if any(sm.metadata.pipelines for sm in metadatas):
            targets.append((intern.setdefault(metadatas, metadatas), mid))
        for idm in result.for_new_rollup_ids:
            targets.append(
                (intern.setdefault(idm.metadatas, idm.metadatas), idm.id))
        return (result, False, tuple(targets))

    # -- ingest: retained per-metric oracle --------------------------------

    def write(self, tags: Dict[bytes, bytes], t_nanos: int, value: float,
              metric_type: MetricType = MetricType.GAUGE) -> bool:
        return self.write_ref(tags, t_nanos, value, metric_type)

    def write_ref(self, tags: Dict[bytes, bytes], t_nanos: int, value: float,
                  metric_type: MetricType = MetricType.GAUGE) -> bool:
        """metrics_appender.go SamplesAppender: match + append, one metric
        at a time — the pre-batch shape, retained verbatim as the oracle
        the compiled path is held equal to."""
        mid = _encode_tags(tags)
        result = self._matcher.match(mid)
        if result is None:
            return False
        wrote = False
        metadatas = result.for_existing_id
        if _must_drop(metadatas):
            self.samples_dropped += 1
            return True
        if any(sm.metadata.pipelines for sm in metadatas):
            mu = _to_union(metric_type, mid, value)
            wrote = self._agg.add_untimed(mu, metadatas) or wrote
        for idm in result.for_new_rollup_ids:
            mu = _to_union(metric_type, idm.id, value)
            wrote = self._agg.add_untimed(mu, idm.metadatas) or wrote
        if wrote:
            self.samples_matched += 1
        return wrote

    # -- flush -------------------------------------------------------------

    def flush(self, now_nanos: Optional[int] = None) -> int:
        return self._agg.flush(now_nanos)

    def _decoded_tags(self, mid: bytes) -> Dict[bytes, bytes]:
        tags = self._decode_memo.get(mid)
        if tags is None:
            name, tags = metric_id.decode(mid)
            if name:
                tags = {b"__name__": name, **tags}
            if len(self._decode_memo) >= 262144:
                self._decode_memo.clear()
            self._decode_memo[mid] = tags
        return tags

    def _on_flushed(self, metric: AggregatedMetric):
        self._write(metric.id, self._decoded_tags(metric.id),
                    metric.time_nanos, metric.value, metric.storage_policy)

    def _on_flushed_columnar(self, groups):
        """One flush round's columnar groups -> one storage sink call.
        Decode is memoized across rounds (standing series pay it once);
        rows assemble per group and sink batched."""
        rows: List[tuple] = []
        for ids, times, values, policy in groups:
            for mid, t, v in zip(ids, _tolist(times), _tolist(values)):
                rows.append((mid, self._decoded_tags(mid), t, v, policy))
        self._sink_rows(rows)

    def _sink_rows(self, rows: List[tuple]):
        if self._write_rows is not None:
            self._write_rows(rows)
            return
        write = self._write
        for mid, tags, t, v, policy in rows:
            write(mid, tags, t, v, policy)


def _encode_tags(tags: Dict[bytes, bytes]) -> bytes:
    name = tags.get(b"__name__", b"")
    return metric_id.encode(name, {k: v for k, v in tags.items()
                                   if k != b"__name__"})


def _to_union(metric_type: MetricType, mid: bytes, value: float) -> MetricUnion:
    if metric_type == MetricType.COUNTER:
        return MetricUnion.counter(mid, int(value))
    if metric_type == MetricType.TIMER:
        return MetricUnion.batch_timer(mid, [value])
    return MetricUnion.gauge(mid, value)


def _must_drop(metadatas) -> bool:
    for sm in metadatas:
        pipes = sm.metadata.pipelines
        if pipes and all(p.drop_policy == DropPolicy.DROP_MUST for p in pipes):
            return True
    return False
