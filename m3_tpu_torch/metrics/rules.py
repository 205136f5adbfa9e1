"""Mapping + rollup rules with time-versioned snapshots and forward matching
(reference: src/metrics/rules/{mapping,rollup,ruleset,active_ruleset}.go).

A rule is a list of snapshots, each active from its cutover time until the
next snapshot's cutover (or tombstoned). An ActiveRuleSet matches a metric ID
over a [from, to) time range by evaluating at `from` and at every rule
cutover inside the range, merging results into staged metadatas — so a rule
change mid-range produces a metadata stage at exactly its cutover
(active_ruleset.go:102-144 ForwardMatch).

Host copy of m3_tpu/metrics/rules.py."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import id as metric_id
from .filters import TagsFilter
from .metadata import (
    IDWithMetadatas,
    Metadata,
    PipelineMetadata,
    StagedMetadata,
)
from .pipeline import Pipeline, RollupOp
from .policy import StoragePolicy


@dataclasses.dataclass(frozen=True)
class MappingRuleSnapshot:
    """One state of a mapping rule (rules/mapping.go mappingRuleSnapshot)."""

    name: str
    cutover_nanos: int
    filter: TagsFilter
    aggregation_id: int = 0
    storage_policies: Tuple[StoragePolicy, ...] = ()
    drop_policy: int = 0
    tombstoned: bool = False


@dataclasses.dataclass(frozen=True)
class RollupTarget:
    """A rollup pipeline + its output storage policies
    (rules/rollup_target.go)."""

    pipeline: Pipeline
    storage_policies: Tuple[StoragePolicy, ...]


@dataclasses.dataclass(frozen=True)
class RollupRuleSnapshot:
    name: str
    cutover_nanos: int
    filter: TagsFilter
    targets: Tuple[RollupTarget, ...] = ()
    tombstoned: bool = False


class Rule:
    """Snapshots sorted by cutover; activeSnapshot(t) = last with cutover <= t
    (mapping.go activeSnapshot)."""

    def __init__(self, snapshots: Sequence):
        self.snapshots = sorted(snapshots, key=lambda s: s.cutover_nanos)
        self._cutovers = [s.cutover_nanos for s in self.snapshots]

    def active_snapshot(self, t_nanos: int):
        i = bisect.bisect_right(self._cutovers, t_nanos) - 1
        return self.snapshots[i] if i >= 0 else None


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """active_ruleset.go MatchResult: staged metadatas for the existing ID,
    metadatas for new rollup IDs, and when this result expires."""

    version: int
    expire_at_nanos: int
    for_existing_id: Tuple[StagedMetadata, ...]
    for_new_rollup_ids: Tuple[IDWithMetadatas, ...]

    def has_expired(self, t_nanos: int) -> bool:
        return t_nanos >= self.expire_at_nanos


class ActiveRuleSet:
    """Matches IDs against active mapping + rollup rule snapshots."""

    def __init__(self, version: int, mapping_rules: Sequence[Rule], rollup_rules: Sequence[Rule]):
        self.version = version
        self.mapping_rules = list(mapping_rules)
        self.rollup_rules = list(rollup_rules)
        cutovers = set()
        for rule in [*self.mapping_rules, *self.rollup_rules]:
            cutovers.update(rule._cutovers)
        self.cutover_times_asc = sorted(cutovers)

    def _next_cutover(self, t_nanos: int) -> int:
        i = bisect.bisect_right(self.cutover_times_asc, t_nanos)
        if i < len(self.cutover_times_asc):
            return self.cutover_times_asc[i]
        return 2**63 - 1

    def _mappings_at(self, mid: bytes, t_nanos: int) -> Tuple[int, List[PipelineMetadata]]:
        cutover, pipelines = 0, []
        for rule in self.mapping_rules:
            snap = rule.active_snapshot(t_nanos)
            if snap is None or not snap.filter.matches(mid):
                continue
            cutover = max(cutover, snap.cutover_nanos)
            if snap.tombstoned:
                continue
            pipelines.append(
                PipelineMetadata(snap.aggregation_id, snap.storage_policies, drop_policy=snap.drop_policy)
            )
        return cutover, pipelines

    def _rollups_at(self, mid: bytes, t_nanos: int):
        """Returns (cutover, pipelines for existing id, list of (rollup_id,
        pipeline metadata)) — a rollup whose first op is the rollup itself
        generates a new ID immediately (active_ruleset.go rollupResultsFor)."""
        cutover, for_existing, for_new = 0, [], []
        name, tags = metric_id.decode(mid)
        for rule in self.rollup_rules:
            snap = rule.active_snapshot(t_nanos)
            if snap is None or not snap.filter.matches(mid):
                continue
            cutover = max(cutover, snap.cutover_nanos)
            if snap.tombstoned:
                continue
            for target in snap.targets:
                ops = target.pipeline.ops
                if ops and ops[0].rollup is not None:
                    rop: RollupOp = ops[0].rollup
                    rid = metric_id.rollup_id(rop.new_name, tags, rop.tags)
                    for_new.append(
                        (rid, PipelineMetadata(rop.aggregation_id, target.storage_policies, target.pipeline.sub(1)))
                    )
                else:
                    for_existing.append(PipelineMetadata(0, target.storage_policies, target.pipeline))
        return cutover, for_existing, for_new

    def _match_at(self, mid: bytes, t_nanos: int):
        mc, mapping_pipes = self._mappings_at(mid, t_nanos)
        rc, rollup_existing, rollup_new = self._rollups_at(mid, t_nanos)
        cutover = max(mc, rc)
        pipelines = tuple(dict.fromkeys(mapping_pipes + rollup_existing))
        staged = StagedMetadata(cutover, False, Metadata(pipelines))
        new_ids = tuple(
            IDWithMetadatas(rid, (StagedMetadata(cutover, False, Metadata((pm,))),))
            for rid, pm in sorted(rollup_new, key=lambda x: x[0])
        )
        return staged, new_ids

    def forward_match(self, mid: bytes, from_nanos: int, to_nanos: int) -> MatchResult:
        staged, new_ids = self._match_at(mid, from_nanos)
        for_existing = [staged]
        for_new: Dict[bytes, List[StagedMetadata]] = {i.id: list(i.metadatas) for i in new_ids}
        next_cutover = self._next_cutover(from_nanos)
        while next_cutover < to_nanos:
            staged_n, new_ids_n = self._match_at(mid, next_cutover)
            if staged_n.metadata != for_existing[-1].metadata:
                for_existing.append(dataclasses.replace(staged_n, cutover_nanos=next_cutover))
            for idm in new_ids_n:
                stages = for_new.setdefault(idm.id, [])
                for sm in idm.metadatas:
                    if not stages or stages[-1].metadata != sm.metadata:
                        stages.append(dataclasses.replace(sm, cutover_nanos=next_cutover))
            next_cutover = self._next_cutover(next_cutover)
        return MatchResult(
            self.version,
            next_cutover,
            tuple(for_existing),
            tuple(IDWithMetadatas(k, tuple(v)) for k, v in sorted(for_new.items())),
        )


class RuleSet:
    """A namespace's versioned rule set (rules/ruleset.go): immutable list of
    rules per version; activates into an ActiveRuleSet."""

    def __init__(self, namespace: bytes, version: int = 1,
                 mapping_rules: Sequence[Rule] = (), rollup_rules: Sequence[Rule] = (),
                 tombstoned: bool = False):
        self.namespace = namespace
        self.version = version
        self.mapping_rules = list(mapping_rules)
        self.rollup_rules = list(rollup_rules)
        self.tombstoned = tombstoned

    def active_set(self) -> ActiveRuleSet:
        return ActiveRuleSet(self.version, self.mapping_rules, self.rollup_rules)
