"""Rule matcher: KV-watched rule sets compiled per namespace with a result
cache (reference: src/metrics/matcher/{match.go,ruleset.go,namespaces.go,
cache/cache.go}).

The collector/coordinator matches every incoming metric ID against the
namespace's active rule set; match results carry an expiry (the next rule
cutover) so the cache invalidates itself exactly when rules change.

Host copy of m3_tpu/metrics/matcher.py."""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, Optional

from ..cluster import kv as cluster_kv
from .filters import TagsFilter
from .pipeline import Op, Pipeline
from .policy import StoragePolicy
from .rules import (
    MappingRuleSnapshot,
    MatchResult,
    RollupRuleSnapshot,
    RollupTarget,
    Rule,
    RuleSet,
)


def pipeline_to_json(p: Pipeline) -> list:
    """Generic op-list serialization: aggregation, transformation, and
    rollup ops all round-trip (pipeline/type.go Pipeline proto shape)."""
    out = []
    for op in p.ops:
        if op.rollup is not None:
            out.append({"t": "rollup", "new_name": op.rollup.new_name.decode(),
                        "tags": [t.decode() for t in op.rollup.tags],
                        "agg_id": op.rollup.aggregation_id})
        elif op.transformation is not None:
            out.append({"t": "transform", "op": int(op.transformation)})
        elif op.aggregation is not None:
            out.append({"t": "agg", "op": int(op.aggregation)})
        else:
            raise ValueError(f"unserializable pipeline op {op}")
    return out


def pipeline_from_json(ops: list) -> Pipeline:
    from .aggregation import AggType
    from .transformation import TransformType

    built = []
    for d in ops:
        if d["t"] == "rollup":
            built.append(Op.roll(d["new_name"].encode(),
                                 tuple(t.encode() for t in d["tags"]),
                                 d["agg_id"]))
        elif d["t"] == "transform":
            built.append(Op.transform(TransformType(d["op"])))
        else:
            built.append(Op.aggregate(AggType(d["op"])))
    return Pipeline(tuple(built))


def ruleset_to_json(rs: RuleSet) -> dict:
    """Serialize a rule set for KV storage (the reference stores protobuf
    rule sets under one key per namespace, matcher/ruleset.go kv watch)."""

    def snap(s):
        if isinstance(s, MappingRuleSnapshot):
            return {
                "kind": "mapping", "name": s.name, "cutover": s.cutover_nanos,
                "filter": s.filter.to_json(),
                "agg_id": s.aggregation_id,
                "policies": [str(p) for p in s.storage_policies],
                "drop": s.drop_policy, "tomb": s.tombstoned,
            }
        return {
            "kind": "rollup", "name": s.name, "cutover": s.cutover_nanos,
            "filter": s.filter.to_json(), "tomb": s.tombstoned,
            "targets": [
                {
                    "pipeline": pipeline_to_json(t.pipeline),
                    "policies": [str(p) for p in t.storage_policies],
                }
                for t in s.targets
            ],
        }

    return {
        "namespace": rs.namespace.decode(),
        "version": rs.version,
        "tombstoned": rs.tombstoned,
        "mapping": [[snap(s) for s in r.snapshots] for r in rs.mapping_rules],
        "rollup": [[snap(s) for s in r.snapshots] for r in rs.rollup_rules],
    }


def ruleset_from_json(obj: dict) -> RuleSet:
    def unsnap(d):
        filt = TagsFilter.from_json(d["filter"])
        if d["kind"] == "mapping":
            return MappingRuleSnapshot(
                d["name"], d["cutover"], filt, d["agg_id"],
                tuple(StoragePolicy.parse(p) for p in d["policies"]),
                d["drop"], d["tomb"],
            )
        return RollupRuleSnapshot(
            d["name"], d["cutover"], filt,
            tuple(
                RollupTarget(
                    pipeline_from_json(t["pipeline"]),
                    tuple(StoragePolicy.parse(p) for p in t["policies"]),
                )
                for t in d["targets"]
            ),
            d["tomb"],
        )

    return RuleSet(
        obj["namespace"].encode(), obj["version"],
        [Rule([unsnap(s) for s in snaps]) for snaps in obj["mapping"]],
        [Rule([unsnap(s) for s in snaps]) for snaps in obj["rollup"]],
        obj["tombstoned"],
    )


class RuleSetStore:
    """Publish/read rule sets in KV, one key per namespace
    (matcher/namespaces.go namespaces key + per-ns ruleset keys)."""

    def __init__(self, store: cluster_kv.MemStore, prefix: str = "_rules"):
        self._store = store
        self._prefix = prefix

    def _key(self, namespace: bytes) -> str:
        return f"{self._prefix}/{namespace.decode()}"

    def publish(self, rs: RuleSet) -> int:
        return self._store.set(
            self._key(rs.namespace), json.dumps(ruleset_to_json(rs)).encode())

    def get(self, namespace: bytes) -> Optional[RuleSet]:
        val = self._store.get(self._key(namespace))
        if val is None:
            return None
        return ruleset_from_json(json.loads(val.data.decode()))

    def on_change(self, namespace: bytes, fn: Callable[[RuleSet], None]):
        self._store.on_change(
            self._key(namespace),
            lambda _k, v: fn(ruleset_from_json(json.loads(v.data.decode()))))


class Matcher:
    """Per-namespace matcher with KV watch + expiring result cache
    (matcher/match.go, cache/cache.go).

    Match results memoize keyed on (rule-set generation, id): a KV rule
    update bumps the generation, so entries written against a dead
    generation are UNREACHABLE by construction (the postings cache's
    dead-generation pattern) — and a computation racing the swap is
    additionally refused at insert. match_batch() routes misses through
    the compiled batch matcher (metrics/batch_matcher.py): the rule set
    compiles once per (generation, snapshot epoch) into index queries,
    so a steady-state batch is a per-id hash probe and a cold batch is
    one inverted-index pass instead of ids x rules filter evaluations."""

    def __init__(self, store: RuleSetStore, namespace: bytes,
                 clock: Optional[Callable[[], int]] = None,
                 cache_capacity: int = 1 << 20):
        import time as _time

        self._store = store
        self._namespace = namespace
        self._clock = clock or _time.time_ns
        self._lock = threading.Lock()
        # (generation, id) -> MatchResult; the generation in the key is
        # what makes stale entries unreachable without a scan.
        self._cache: Dict[tuple, MatchResult] = {}
        self._capacity = cache_capacity
        self._generation = 0
        self._compiled = None  # CompiledRuleSet for _generation, or None
        rs = store.get(namespace)
        self._active = rs.active_set() if rs is not None else None
        store.on_change(namespace, self._on_ruleset_change)
        self.hits = 0
        self.misses = 0

    def _on_ruleset_change(self, rs: RuleSet):
        with self._lock:
            self._active = rs.active_set()
            self._cache.clear()  # new generation invalidates everything
            self._compiled = None
            self._generation += 1

    def match(self, metric_id: bytes,
              from_nanos: Optional[int] = None,
              to_nanos: Optional[int] = None) -> Optional[MatchResult]:
        now = self._clock()
        from_nanos = now if from_nanos is None else from_nanos
        to_nanos = now + 1 if to_nanos is None else to_nanos
        with self._lock:
            active = self._active
            generation = self._generation
            cached = self._cache.get((generation, metric_id))
            if cached is not None and not cached.has_expired(now):
                self.hits += 1
                return cached
        if active is None:
            return None
        self.misses += 1
        result = active.forward_match(metric_id, from_nanos, to_nanos)
        self._put(generation, metric_id, result)
        return result

    def _put(self, generation: int, metric_id: bytes, result: MatchResult):
        with self._lock:
            # Only cache if no rule-set swap raced this computation — a
            # stale insert after the invalidating clear would otherwise be
            # served until its (possibly infinite) expiry.
            if self._generation == generation:
                if len(self._cache) >= self._capacity:
                    self._cache.clear()  # simple full-flush eviction
                self._cache[(generation, metric_id)] = result

    def _compiled_for(self, active, generation: int, now: int):
        """Compiled rule set for this generation + snapshot epoch, built
        at most once per epoch (rule cutovers expire it)."""
        from .batch_matcher import CompiledRuleSet

        with self._lock:
            compiled = self._compiled
            if (compiled is not None and self._generation == generation
                    and not compiled.has_expired(now)):
                return compiled
        compiled = CompiledRuleSet(active, now)
        with self._lock:
            if self._generation == generation:
                self._compiled = compiled
        return compiled

    def match_batch(self, metric_ids) -> Optional[list]:
        """One match pass over a batch of encoded ids (order-aligned
        list of MatchResult, or None when no rule set is installed).
        Memoized ids are hash probes; the distinct misses run through
        the compiled batch matcher in one inverted-index pass."""
        from .batch_matcher import match_batch as _batch

        now = self._clock()
        n = len(metric_ids)
        out = [None] * n
        misses: Dict[bytes, list] = {}
        with self._lock:
            active = self._active
            generation = self._generation
            if active is None:
                return None
            cache = self._cache
            for i, mid in enumerate(metric_ids):
                cached = cache.get((generation, mid))
                if cached is not None and not cached.has_expired(now):
                    out[i] = cached
                else:
                    misses.setdefault(mid, []).append(i)
        self.hits += n - sum(map(len, misses.values()))
        if misses:
            self.misses += sum(map(len, misses.values()))
            miss_ids = list(misses)
            compiled = self._compiled_for(active, generation, now)
            results = _batch(compiled, miss_ids, now)
            with self._lock:
                if self._generation == generation:
                    for mid, result in zip(miss_ids, results):
                        if len(cache) >= self._capacity:
                            cache.clear()
                        cache[(generation, mid)] = result
            for mid, result in zip(miss_ids, results):
                for i in misses[mid]:
                    out[i] = result
        return out
