"""Compiled batch rule matching: one KV rule-set version compiled into
index queries, evaluated over a per-batch inverted segment.

The per-metric path (rules.ActiveRuleSet.forward_match) evaluates every
rule's TagsFilter against every metric id — each check re-decodes the id
and runs per-tag regexes, so a 100k-id batch against a 1k-rule set pays
~10^8 Python-level filter evaluations. This module inverts the loop into
the index machinery (index/segment.py, index/query.py):

  * compile: every ACTIVE rule snapshot's TagsFilter translates ONCE per
    (rule-set version, snapshot epoch) into an index Query — literal
    glob patterns become TermQuery, glob patterns become RegexpQuery
    (same compiled-regex semantics as filters.Filter), '!'-negated
    patterns become NegationQuery (tag absence satisfies negation via
    postings complement, exactly the TagsFilter absence rule). The
    compiled set is valid until the next rule cutover.
  * match: the batch's distinct ids become Documents in ONE
    MutableSegment -> ImmutableSegment (TermDict + postings inversion);
    each snapshot query runs once over the whole segment (vectorized
    binary search + bitmap algebra, literal-prefix prune for globs), and
    per-row results assemble from the per-snapshot row sets.

Row assembly replicates ActiveRuleSet._match_at / forward_match
structurally (rule-order pipeline merging, dict.fromkeys dedup, rollup
new-id generation, last-wins duplicate-rollup-id merge, cutover = max of
matched snapshot cutovers including tombstoned ones), so results are
EQUAL (dataclass equality) to the per-metric oracle — the property suite
(tests/test_batch_matcher.py) and the downsample_rules bench hold the
two paths identical.

Host copy of m3_tpu/metrics/batch_matcher.py, over the port's
index/{segment,query,postings_cache}."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..index.postings_cache import PostingsListCache
from ..index.query import (
    AllQuery,
    NegationQuery,
    Query,
    RegexpQuery,
    TermQuery,
    new_conjunction,
)
from ..index.segment import Document, ImmutableSegment, MutableSegment, execute
from . import id as metric_id
from .filters import TagsFilter, _glob_to_regex
from .metadata import IDWithMetadatas, Metadata, PipelineMetadata, StagedMetadata
from .rules import ActiveRuleSet, MatchResult

_NAME_FIELD = b"__name__"
_GLOB_META = set("*?[{")


def filter_to_query(tf: TagsFilter) -> Query:
    """TagsFilter -> index Query with identical match semantics.

    Positive pattern: docs holding the tag with a matching value (tag
    absence fails — absent tags simply have no postings). Negated
    pattern: complement of the inner query (tag absence satisfies it).
    Empty filter: AllQuery (filters.MATCH_ALL)."""
    parts: List[Query] = []
    for key, pattern in tf.patterns.items():
        field = _NAME_FIELD if key == TagsFilter.NAME_KEY else key.encode()
        negate = pattern.startswith("!")
        body = pattern[1:] if negate else pattern
        if _GLOB_META.isdisjoint(body):
            inner: Query = TermQuery(field, body.encode())
        else:
            # Same anchored-regex compilation as filters.Filter (the
            # segment matches terms with pattern.fullmatch, so the
            # trailing '$' is redundant but keeps the bytes identical to
            # the per-metric compiled form).
            inner = RegexpQuery(field, _glob_to_regex(body).encode() + b"$")
        parts.append(NegationQuery(inner) if negate else inner)
    if not parts:
        return AllQuery()
    return new_conjunction(*parts)


@dataclasses.dataclass(frozen=True)
class _MappingEntry:
    query: Query
    cutover_nanos: int
    tombstoned: bool
    pipeline: Optional[PipelineMetadata]  # None when tombstoned


@dataclasses.dataclass(frozen=True)
class _RollupEntry:
    query: Query
    cutover_nanos: int
    tombstoned: bool
    # Targets whose pipeline STARTS with the rollup generate new ids:
    # (rollup op, shared sub-pipeline metadata). Others aggregate under
    # the existing id.
    new_id_targets: Tuple[tuple, ...]
    existing_targets: Tuple[PipelineMetadata, ...]


class CompiledRuleSet:
    """One ActiveRuleSet compiled at a snapshot epoch.

    Valid for match times in [compiled-at, expire_at): the active
    snapshot per rule cannot change inside that window (expire_at is the
    rule set's next cutover), so the per-snapshot queries and shared
    PipelineMetadata objects are reusable for every batch until then."""

    __slots__ = ("version", "expire_at_nanos", "mapping", "rollup")

    def __init__(self, active: ActiveRuleSet, t_nanos: int):
        self.version = active.version
        self.expire_at_nanos = active._next_cutover(t_nanos)
        self.mapping: List[_MappingEntry] = []
        for rule in active.mapping_rules:
            snap = rule.active_snapshot(t_nanos)
            if snap is None:
                continue
            pm = None
            if not snap.tombstoned:
                pm = PipelineMetadata(snap.aggregation_id,
                                      snap.storage_policies,
                                      drop_policy=snap.drop_policy)
            self.mapping.append(_MappingEntry(
                filter_to_query(snap.filter), snap.cutover_nanos,
                snap.tombstoned, pm))
        self.rollup: List[_RollupEntry] = []
        for rule in active.rollup_rules:
            snap = rule.active_snapshot(t_nanos)
            if snap is None:
                continue
            new_id_targets: List[tuple] = []
            existing: List[PipelineMetadata] = []
            if not snap.tombstoned:
                for target in snap.targets:
                    ops = target.pipeline.ops
                    if ops and ops[0].rollup is not None:
                        rop = ops[0].rollup
                        new_id_targets.append((rop, PipelineMetadata(
                            rop.aggregation_id, target.storage_policies,
                            target.pipeline.sub(1))))
                    else:
                        existing.append(PipelineMetadata(
                            0, target.storage_policies, target.pipeline))
            self.rollup.append(_RollupEntry(
                filter_to_query(snap.filter), snap.cutover_nanos,
                snap.tombstoned, tuple(new_id_targets), tuple(existing)))

    def has_expired(self, t_nanos: int) -> bool:
        return t_nanos >= self.expire_at_nanos


def build_segment(mids: Sequence[bytes],
                  decoded: Optional[Sequence[tuple]] = None
                  ) -> Tuple[ImmutableSegment, List[tuple]]:
    """Invert a batch of encoded metric ids into an immutable segment.

    Returns (segment, decoded) where decoded[i] = (name, tags dict) —
    the rollup-id generator needs the tags again, so decode is paid once
    per id for the whole match (the per-metric path re-decodes per
    RULE)."""
    if decoded is None:
        decoded = [metric_id.decode(mid) for mid in mids]
    seg = MutableSegment()
    docs = [
        Document(mid, ((_NAME_FIELD, name), *tags.items()))
        for mid, (name, tags) in zip(mids, decoded)
    ]
    seg.insert_batch(docs)
    return ImmutableSegment.from_mutable(seg), list(decoded)


def match_batch(compiled: CompiledRuleSet, mids: Sequence[bytes],
                t_nanos: int,
                decoded: Optional[Sequence[tuple]] = None
                ) -> List[MatchResult]:
    """Match every id in the batch in one pass per rule snapshot.

    Equivalent to [active.forward_match(mid, t, t + 1) for mid in mids]
    with t inside the compiled set's validity window (a streaming match
    at `now`: the [t, t+1) range never crosses a cutover, since the next
    cutover is strictly greater than t)."""
    assert not compiled.has_expired(t_nanos), "stale compiled rule set"
    seg, decoded = build_segment(mids, decoded)
    # Everything below is indexed by segment POSITION: duplicate mids
    # share one document, so positions are NOT input order — route the
    # decoded (name, tags) through the id -> position table before the
    # rollup-id generator reads tags.
    n = len(seg)
    pos = {seg.doc(i).id: i for i in range(n)}
    dec_by_pos: List[tuple] = [None] * n
    for mid, dec in zip(mids, decoded):
        dec_by_pos[pos[mid]] = dec
    # Per-batch leaf cache: distinct snapshots frequently share terms
    # (the same tag filter across many rules resolves one postings list).
    cache = PostingsListCache()
    cutovers = [0] * n
    map_pipes: List[List[PipelineMetadata]] = [[] for _ in range(n)]
    roll_pipes: List[List[PipelineMetadata]] = [[] for _ in range(n)]
    roll_new: List[List[tuple]] = [[] for _ in range(n)]
    for entry in compiled.mapping:
        rows = execute(seg, entry.query, cache).tolist()
        c = entry.cutover_nanos
        for r in rows:
            if c > cutovers[r]:
                cutovers[r] = c
        if entry.tombstoned:
            continue
        pm = entry.pipeline
        for r in rows:
            map_pipes[r].append(pm)
    for entry in compiled.rollup:
        rows = execute(seg, entry.query, cache).tolist()
        c = entry.cutover_nanos
        for r in rows:
            if c > cutovers[r]:
                cutovers[r] = c
        if entry.tombstoned:
            continue
        for rop, pm in entry.new_id_targets:
            for r in rows:
                rid = metric_id.rollup_id(rop.new_name, dec_by_pos[r][1],
                                          rop.tags)
                roll_new[r].append((rid, pm))
        for pm in entry.existing_targets:
            for r in rows:
                roll_pipes[r].append(pm)
    expire = compiled.expire_at_nanos
    version = compiled.version
    out: List[MatchResult] = []
    memo: Dict[int, MatchResult] = {}
    for mid in mids:
        r = pos[mid]
        hit = memo.get(r)
        if hit is not None:
            out.append(hit)
            continue
        cutover = cutovers[r]
        pipelines = tuple(dict.fromkeys(map_pipes[r] + roll_pipes[r]))
        staged = StagedMetadata(cutover, False, Metadata(pipelines))
        # Mirror _match_at + forward_match exactly: sort by rollup id,
        # then the dict rebuild keeps the LAST entry per duplicate id.
        for_new = {
            rid: (StagedMetadata(cutover, False, Metadata((pm,))),)
            for rid, pm in sorted(roll_new[r], key=lambda x: x[0])
        }
        result = MatchResult(
            version, expire, (staged,),
            tuple(IDWithMetadatas(k, v) for k, v in sorted(for_new.items())))
        memo[r] = result
        out.append(result)
    return out
