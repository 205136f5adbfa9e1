"""Per-metric-ID entry: metadata resolution, rate limiting, elem fan-out
(reference: src/aggregator/aggregator/entry.go:221 AddUntimed).

An Entry is created per unique unaggregated metric ID; it resolves the
metric's staged metadatas (sent by the client alongside each sample) into
aggregation elements — one per (storage policy x aggregation types x
pipeline) — and routes every incoming sample into those elems' staging
buckets.

Host copy of m3_tpu/aggregator/entry.py."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

from ..metrics.metadata import ForwardMetadata, StagedMetadata
from ..metrics.metric import MetricType, MetricUnion
from ..metrics.policy import DropPolicy, StoragePolicy
from .elem import Elem, ElemKey
from .list import MetricLists


class RateLimiter:
    """Simple per-second token limiter (reference: src/aggregator/rate/limiter.go
    — limits values/sec admitted per entry)."""

    def __init__(self, limit_per_second: int, clock: Callable[[], int]):
        self.limit = limit_per_second
        self._clock = clock
        self._window_start = 0
        self._seen = 0

    def is_allowed(self, n: int) -> bool:
        if self.limit <= 0:
            return True
        now = self._clock()
        sec = now // 1_000_000_000
        if sec != self._window_start:
            self._window_start = sec
            self._seen = 0
        self._seen += n
        return self._seen <= self.limit


class Entry:
    def __init__(self, metric_id: bytes, metric_type: MetricType,
                 lists: MetricLists, clock: Callable[[], int],
                 rate_limit_per_second: int = 0,
                 default_policies: Sequence[StoragePolicy] = ()):
        self.metric_id = metric_id
        self.metric_type = metric_type
        self._lists = lists
        self._clock = clock
        self._limiter = RateLimiter(rate_limit_per_second, clock)
        self._default_policies = tuple(default_policies)
        self._elems: Dict[ElemKey, Elem] = {}
        self._active_metadata = None  # (cutover, Metadata) of last rebuild
        self.last_access_nanos = clock()
        self.dropped = 0

    # -- untimed (client-timestamped at arrival) ---------------------------

    def add_untimed(self, mu: MetricUnion,
                    metadatas: Sequence[StagedMetadata] = ()) -> bool:
        """Route one sample into the elems of the currently-active metadata
        stage (entry.go:221; stage selection :446 activeStagedMetadataWith).
        Returns False if rate-limited or dropped by policy."""
        now = self._clock()
        return self.add_untimed_staged(mu, _active_stage(metadatas, now), now)

    def add_untimed_staged(self, mu: MetricUnion,
                           active: Optional[StagedMetadata],
                           now: int) -> bool:
        """add_untimed with the metadata stage already resolved — the
        batched aggregator feed resolves (clock, active stage) ONCE per
        (pipeline, policy) class and fans the group's samples in here."""
        self.last_access_nanos = now
        n = max(1, len(mu.batch_timer_val))
        if not self._limiter.is_allowed(n):
            self.dropped += n
            return False
        if active is not None and active.tombstoned:
            return False
        self._maybe_update_elems(active)
        if not self._elems:
            return False
        for elem in self._elems.values():
            elem.add_union(now, mu)
        return True

    def add_timed(self, t_nanos: int, value: float,
                  policy: StoragePolicy, aggregation_id: int = 0) -> bool:
        """Timed metric with explicit client timestamp (entry.go AddTimed)."""
        self.last_access_nanos = self._clock()
        if not self._limiter.is_allowed(1):
            self.dropped += 1
            return False
        key = ElemKey(self.metric_id, policy, aggregation_id)
        elem = self._get_elem(key)
        elem.add_value(t_nanos, value)
        return True

    def add_forwarded(self, t_nanos: int, value: float,
                      meta: ForwardMetadata) -> bool:
        """Partial aggregate forwarded from an earlier pipeline stage
        (entry.go AddForwarded)."""
        self.last_access_nanos = self._clock()
        key = ElemKey(self.metric_id, meta.storage_policy, meta.aggregation_id,
                      meta.pipeline, meta.num_forwarded_times)
        elem = self._get_elem(key)
        elem.add_value(t_nanos, value)
        return True

    # -- internals ---------------------------------------------------------

    def _get_elem(self, key: ElemKey) -> Elem:
        elem = self._elems.get(key)
        if elem is None:
            lst = self._lists.for_resolution(key.storage_policy.resolution.window_ns)
            elem = lst.get_or_create(key, lambda: Elem(key, self.metric_type))
            self._elems[key] = elem
        return elem

    def _maybe_update_elems(self, active: Optional[StagedMetadata]):
        """(Re)build the elem set when the active metadata stage changes
        (entry.go:509 updateStagedMetadatasWithLock; staleness is judged on
        the metadata contents, not just the cutover — entry.go compares the
        staged metadatas themselves, so a rules update that keeps the same
        cutover still takes effect)."""
        current = (
            (active.cutover_nanos, active.metadata) if active is not None else None
        )
        if self._active_metadata == current and self._elems:
            return
        wanted: Dict[ElemKey, Tuple[int, object]] = {}
        if active is None or not active.metadata.pipelines:
            for sp in self._default_policies:
                wanted[ElemKey(self.metric_id, sp)] = None
        else:
            for pm in active.metadata.pipelines:
                if pm.drop_policy == DropPolicy.DROP_MUST:
                    continue
                policies = pm.storage_policies or self._default_policies
                for sp in policies:
                    wanted[ElemKey(self.metric_id, sp, pm.aggregation_id, pm.pipeline)] = None
        for key, old in list(self._elems.items()):
            if key not in wanted:
                old.tombstoned = True
                del self._elems[key]
        for key in wanted:
            self._get_elem(key)
        self._active_metadata = current


def _active_stage(metadatas: Sequence[StagedMetadata], t_nanos: int):
    """Last stage with cutover <= t (metadata.go StagedMetadatas semantics)."""
    active = None
    for sm in metadatas:
        if sm.cutover_nanos <= t_nanos and (
            active is None or sm.cutover_nanos >= active.cutover_nanos
        ):
            active = sm
    return active


class MetricMap:
    """Sharded id -> Entry map (reference: src/aggregator/aggregator/map.go:145
    AddUntimed; entry expiry :258 tick)."""

    def __init__(self, lists: MetricLists, clock: Callable[[], int],
                 rate_limit_per_second: int = 0,
                 default_policies: Sequence[StoragePolicy] = (),
                 entry_ttl_ns: int = 24 * 3600 * 1_000_000_000):
        self._entries: Dict[bytes, Entry] = {}
        self._lists = lists
        self._clock = clock
        self._rate_limit = rate_limit_per_second
        self._default_policies = tuple(default_policies)
        self._entry_ttl_ns = entry_ttl_ns

    def __len__(self):
        return len(self._entries)

    def _entry_for(self, metric_id: bytes, metric_type: MetricType) -> Entry:
        e = self._entries.get(metric_id)
        if e is None:
            e = self._entries[metric_id] = Entry(
                metric_id, metric_type, self._lists, self._clock,
                self._rate_limit, self._default_policies,
            )
        return e

    def ensure_entry(self, metric_id: bytes, metric_type: MetricType):
        """Pre-create the entry for an id (first-write-wins on type):
        batched writers resolve mixed-type output-id contention in
        sample order before their grouped adds."""
        self._entry_for(metric_id, metric_type)

    def add_untimed(self, mu: MetricUnion,
                    metadatas: Sequence[StagedMetadata] = ()) -> bool:
        return self._entry_for(mu.id, mu.type).add_untimed(mu, metadatas)

    def add_untimed_staged(self, mu: MetricUnion,
                           active: Optional[StagedMetadata],
                           now: int) -> bool:
        return self._entry_for(mu.id, mu.type).add_untimed_staged(
            mu, active, now)

    def add_timed(self, metric_type: MetricType, metric_id: bytes,
                  t_nanos: int, value: float, policy: StoragePolicy,
                  aggregation_id: int = 0) -> bool:
        return self._entry_for(metric_id, metric_type).add_timed(
            t_nanos, value, policy, aggregation_id)

    def add_forwarded(self, metric_type: MetricType, metric_id: bytes,
                      t_nanos: int, value: float, meta: ForwardMetadata) -> bool:
        return self._entry_for(metric_id, metric_type).add_forwarded(
            t_nanos, value, meta)

    def tick(self) -> int:
        """Expire idle entries (map.go tick + entry.go ShouldExpire)."""
        now = self._clock()
        expired = [
            mid for mid, e in self._entries.items()
            if now - e.last_access_nanos > self._entry_ttl_ns
        ]
        for mid in expired:
            for elem in self._entries[mid]._elems.values():
                elem.tombstoned = True
            del self._entries[mid]
        return len(expired)
