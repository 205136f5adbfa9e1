"""The aggregator: shard-aware ingestion with placement-watched ownership
(reference: src/aggregator/aggregator/aggregator.go:88 — AddUntimed :167,
AddTimed :189, AddForwarded :208, shardFor :268, placement watch :307;
shard.go aggregatorShard).

Each instance owns the shards the placement assigns it; metric IDs hash to
shards with murmur3 % num_shards (aggregator/sharding/hash.go:89). Each
shard owns its own metric map + lists so flushes and ticks parallelize per
shard; a forwarded-writer loops multi-stage pipeline outputs back into the
aggregation ring (forwarded_writer.go).

Port of m3_tpu/aggregator/aggregator.py: host code, with the flush's
quantile ordering on the aggregator's device (None: the card, raising
without one; "cpu": the plain torch ops). With forward routing set, the
forwarded writer delivers each rollup partial to the owners of its shard
in the aggregator placement (cluster/placement.py), over the wire or
locally; without it everything loops back locally."""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Dict, List, Optional, Sequence

from ..metrics.metadata import ForwardMetadata, StagedMetadata
from ..metrics.metric import MetricType, MetricUnion
from ..device import resolve
from ..metrics.policy import StoragePolicy
from ..utils.hashing import murmur3_32_cached
from .election import ElectionManager
from .entry import MetricMap
from .flush import FlushManager, FlushTimesManager
from .handler import Handler
from .list import MetricLists


class AggregatorShard:
    """One shard's aggregation state (aggregator/shard.go): a metric map over
    its own lists, with cutover/cutoff write gating for placement changes."""

    def __init__(self, shard_id: int, clock: Callable[[], int],
                 rate_limit_per_second: int = 0,
                 default_policies: Sequence[StoragePolicy] = (),
                 device=None):
        self.shard_id = shard_id
        self.lists = MetricLists(device)
        self.map = MetricMap(self.lists, clock, rate_limit_per_second,
                             default_policies)
        # Writes accepted only within [cutover, cutoff) — shards being handed
        # off stop accepting before they're removed (shard.go SetWriteableRange).
        self.cutover_nanos = 0
        self.cutoff_nanos = 2**63 - 1
        self._clock = clock

    def is_writeable(self) -> bool:
        now = self._clock()
        return self.cutover_nanos <= now < self.cutoff_nanos


class ForwardedWriter:
    """Routes rollup-pipeline outputs to the next aggregation stage
    (forwarded_writer.go): the forwarded ID hashes to a shard, and the
    partial aggregate is delivered to every instance owning that shard in
    the aggregator placement — over the wire when the owner is another
    instance, directly when it is this one. Without routing configuration
    (the embedded single-instance downsampler) everything loops back into
    the local aggregator, which owns all shards."""

    def __init__(self, target: "Aggregator"):
        self._target = target
        self._placement = None      # Callable[[], Placement] | None
        self._transports = {}       # instance_id -> send_forwarded fn
        self._local_id = None
        self.dropped = 0

    def set_routing(self, placement_getter, transports, local_instance_id):
        """transports: instance_id -> either a transport OBJECT exposing
        send_forwarded / send_forwarded_batch (TCPTransport — enables the
        one-frame-per-destination batched forwarding) or a bare
        fn(metric_type, id, t, value, meta) (legacy per-item form)."""
        self._placement = placement_getter
        self._transports = dict(transports)
        self._local_id = local_instance_id

    @staticmethod
    def _send_fn(transport):
        send = getattr(transport, "send_forwarded", None)
        return send if send is not None else transport

    def __call__(self, new_id: bytes, t_nanos: int, value: float,
                 meta: ForwardMetadata, source_id: bytes):
        if self._placement is None:
            self._target.add_forwarded(
                MetricType.GAUGE, new_id, t_nanos, value, meta)
            return
        from ..cluster.placement import ShardState

        shard = self._target.shard_for(new_id)
        delivered = False
        for inst in self._placement().replicas_for(
                shard, states=(ShardState.INITIALIZING, ShardState.AVAILABLE)):
            if inst.id == self._local_id:
                delivered |= self._target.add_forwarded(
                    MetricType.GAUGE, new_id, t_nanos, value, meta)
                continue
            tr = self._transports.get(inst.id)
            if tr is not None and self._send_fn(tr)(
                    MetricType.GAUGE, new_id, t_nanos, value, meta):
                delivered = True
        if not delivered:
            self.dropped += 1

    def forward_batch(self, items):
        """Ship one flush round's rollup forwards batched (the sink
        list.py emit_batch collects instead of per-datapoint forward_fn
        calls). Local deliveries apply directly; remote deliveries
        coalesce into ONE columnar `fbatch` frame per (destination
        instance, forward-meta group) per flush round, through the
        transport's send_forwarded_batch. Items are (new_id, t_nanos,
        value, meta, source_id)."""
        if self._placement is None:
            add = self._target.add_forwarded
            for new_id, t_nanos, value, meta, _src in items:
                add(MetricType.GAUGE, new_id, t_nanos, value, meta)
            return
        from ..cluster.placement import ShardState

        states = (ShardState.INITIALIZING, ShardState.AVAILABLE)
        placement = self._placement()
        delivered = [False] * len(items)
        pending: Dict[str, List[int]] = {}
        for i, (new_id, t_nanos, value, meta, _src) in enumerate(items):
            shard = self._target.shard_for(new_id)
            for inst in placement.replicas_for(shard, states=states):
                if inst.id == self._local_id:
                    if self._target.add_forwarded(
                            MetricType.GAUGE, new_id, t_nanos, value, meta):
                        delivered[i] = True
                    continue
                if inst.id in self._transports:
                    pending.setdefault(inst.id, []).append(i)
        for inst_id, idxs in pending.items():
            tr = self._transports[inst_id]
            batch_send = getattr(tr, "send_forwarded_batch", None)
            if batch_send is None:
                send = self._send_fn(tr)
                for i in idxs:
                    new_id, t_nanos, value, meta, _src = items[i]
                    if send(MetricType.GAUGE, new_id, t_nanos, value, meta):
                        delivered[i] = True
                continue
            # one frame per meta group (metas differ only across
            # pipelines/policies, so a flush round is typically one
            # frame per destination)
            groups: Dict[tuple, List[int]] = {}
            for i in idxs:
                meta = items[i][3]
                gk = (meta.aggregation_id, meta.storage_policy,
                      meta.pipeline, meta.num_forwarded_times)
                groups.setdefault(gk, []).append(i)
            for gidx in groups.values():
                if batch_send(MetricType.GAUGE, [items[i] for i in gidx]):
                    for i in gidx:
                        delivered[i] = True
        undelivered = delivered.count(False)
        if undelivered:
            self.dropped += undelivered


class Aggregator:
    def __init__(self, num_shards: int = 64,
                 clock: Optional[Callable[[], int]] = None,
                 flush_handler: Optional[Handler] = None,
                 election: Optional[ElectionManager] = None,
                 flush_times: Optional[FlushTimesManager] = None,
                 rate_limit_per_second: int = 0,
                 default_policies: Sequence[StoragePolicy] = (),
                 buffer_past_ns: int = 0, device=None):
        self.num_shards = num_shards
        self.device = resolve(device)
        self._clock = clock or (lambda: _time.time_ns())
        self._rate_limit = rate_limit_per_second
        self._default_policies = tuple(default_policies)
        self._shards: Dict[int, AggregatorShard] = {}
        self._owned = set(range(num_shards))
        self._flush_handler = flush_handler
        self._forward = ForwardedWriter(self)
        self._flush_mgrs: Dict[int, FlushManager] = {}
        self._election = election
        self._flush_times = flush_times
        self._buffer_past_ns = buffer_past_ns
        self.writes_for_unowned_shard = 0
        # Accepted forwarded partials (tally counter analog; lets tests and
        # operators await "all N stage-1 partials arrived" instead of racing
        # on first-entry creation). Incremented from concurrent
        # per-connection handler threads — guard the non-atomic += the same
        # way RawTCPServer guards frames/errors.
        self.forwarded_received = 0
        self._stats_lock = threading.Lock()
        self._shards_lock = threading.Lock()

    # -- placement ---------------------------------------------------------

    def assign_shards(self, shard_ids: Sequence[int]):
        """React to a placement change (aggregator.go:307 updateShardsWithLock):
        new shards open, removed shards get a cutoff and stop accepting."""
        new = set(shard_ids)
        now = self._clock()
        for sid in new - self._owned:
            if sid in self._shards:
                self._shards[sid].cutoff_nanos = 2**63 - 1
        for sid in self._owned - new:
            if sid in self._shards:
                self._shards[sid].cutoff_nanos = now
        self._owned = new

    def set_forward_routing(self, placement_getter, transports,
                            local_instance_id):
        """Enable cross-instance forwarded pipelines: rollup outputs are
        routed to the instances owning the forwarded ID's shard
        (forwarded_writer.go; proven end-to-end by the reference's
        multi_server_forwarding_pipeline_test.go)."""
        self._forward.set_routing(placement_getter, transports,
                                  local_instance_id)

    def owned_shards(self) -> List[int]:
        return sorted(self._owned)

    def shard_for(self, metric_id: bytes) -> int:
        """aggregator/sharding/hash.go:89 — murmur3 % num_shards."""
        return murmur3_32_cached(metric_id) % self.num_shards

    def _shard(self, metric_id: bytes) -> Optional[AggregatorShard]:
        sid = self.shard_for(metric_id)
        if sid not in self._owned:
            with self._stats_lock:
                self.writes_for_unowned_shard += 1
            return None
        shard = self._shards.get(sid)
        if shard is None:
            # Check-then-create under the lock: concurrent connection
            # handler threads must not each construct the shard — the loser's
            # writes would land in an orphaned object and never flush.
            with self._shards_lock:
                shard = self._shards.get(sid)
                if shard is None:
                    shard = self._shards[sid] = AggregatorShard(
                        sid, self._clock, self._rate_limit,
                        self._default_policies, self.device)
        return shard if shard.is_writeable() else None

    # -- ingest ------------------------------------------------------------

    def add_untimed(self, mu: MetricUnion,
                    metadatas: Sequence[StagedMetadata] = ()) -> bool:
        shard = self._shard(mu.id)
        return shard is not None and shard.map.add_untimed(mu, metadatas)

    def add_untimed_batch(self, mus: Sequence[MetricUnion],
                          metadatas: Sequence[StagedMetadata] = ()
                          ) -> List[bool]:
        """Grouped columnar add: every sample in the batch shares ONE
        staged-metadata list (a (pipeline, policy) class from the batch
        matcher), so the clock read and active-stage resolution are paid
        once for the group instead of per metric (entry.go:446
        activeStagedMetadataWith hoisted out of the hot loop). Returns
        per-sample acceptance, order-aligned with mus."""
        from .entry import _active_stage

        now = self._clock()
        active = _active_stage(metadatas, now)
        out = []
        for mu in mus:
            shard = self._shard(mu.id)
            out.append(shard is not None and shard.map.add_untimed_staged(
                mu, active, now))
        return out

    def ensure_entries(self, pairs) -> None:
        """Pre-create entries for (metric_id, metric_type) pairs in
        order — entry type resolution is first-write-wins, so a batched
        writer passes global sample order here before grouped adds."""
        for mid, mtype in pairs:
            shard = self._shard(mid)
            if shard is not None:
                shard.map.ensure_entry(mid, mtype)

    def add_timed(self, metric_type: MetricType, metric_id: bytes,
                  t_nanos: int, value: float, policy: StoragePolicy,
                  aggregation_id: int = 0) -> bool:
        shard = self._shard(metric_id)
        return shard is not None and shard.map.add_timed(
            metric_type, metric_id, t_nanos, value, policy, aggregation_id)

    def add_forwarded(self, metric_type: MetricType, metric_id: bytes,
                      t_nanos: int, value: float, meta: ForwardMetadata) -> bool:
        shard = self._shard(metric_id)
        ok = shard is not None and shard.map.add_forwarded(
            metric_type, metric_id, t_nanos, value, meta)
        if ok:
            with self._stats_lock:
                self.forwarded_received += 1
        return ok

    # -- flush/tick --------------------------------------------------------

    def _flush_mgr(self, shard: AggregatorShard) -> FlushManager:
        mgr = self._flush_mgrs.get(shard.shard_id)
        if mgr is None:
            if self._election is None or self._flush_times is None:
                raise RuntimeError("aggregator not configured for managed flush")
            mgr = self._flush_mgrs[shard.shard_id] = FlushManager(
                shard.lists, self._election, self._flush_times,
                self._flush_handler, self._forward,
                buffer_past_ns=self._buffer_past_ns, shard_id=shard.shard_id)
        return mgr

    def flush(self, now_nanos: Optional[int] = None) -> int:
        """One flush pass over all owned shards, batched into a single
        columnar reduction: every shard collects into ONE FlushBatch, so
        all aggregation shards reduce in one emit_batch (one device call
        for the round's quantile ordering). With an
        election manager the leader/follower protocol gates emission, and
        the round's per-shard flush times commit as ONE kv transaction
        (FlushTimesManager.store_many); without one, flush directly (the
        embedded coordinator downsampler runs leaderless,
        downsample/leader_local.go)."""
        from .list import FlushBatch, emit_batch

        now = self._clock() if now_nanos is None else now_nanos
        batch = FlushBatch()
        commits = []
        with self._shards_lock:  # snapshot: handler threads insert shards
            shards = {sid: self._shards[sid] for sid in sorted(self._shards)}
        for sid, shard in shards.items():
            if self._election is not None:
                _, commit = self._flush_mgr(shard).plan_into(now, batch)
                commits.append(commit)
            else:
                for lst in shard.lists.lists():
                    res = lst.resolution_ns
                    target = (now - self._buffer_past_ns) // res * res
                    lst.collect_into(target, batch)
        total = emit_batch(batch, self._flush_handler, self._forward,
                           self.device)
        if commits:
            pending: Dict[int, Dict[int, int]] = {}
            for commit in commits:
                commit(pending)
            if pending:
                self._flush_times.store_many(pending)
        return total

    def tick(self) -> int:
        """Expire idle entries across shards (aggregator.go tickInternal)."""
        with self._shards_lock:
            shards = list(self._shards.values())
        return sum(s.map.tick() for s in shards)

    def num_entries(self) -> int:
        with self._shards_lock:
            shards = list(self._shards.values())
        return sum(len(s.map) for s in shards)
