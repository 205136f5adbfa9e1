"""Bootstrap chain (port of m3_tpu/storage/bootstrap.py; reference:
src/dbnode/storage/bootstrap).

Chain-of-responsibility bootstrappers, each claiming shard-time-ranges
and passing the unfulfilled remainder to the next (process.go:150; chain
order filesystem -> commitlog -> peers -> uninitialized_topology per
src/dbnode/config/m3dbnode-local-etcd.yml:72-76, built in
cmd/services/m3dbnode/config/bootstrap.go:115-160).

- filesystem: load complete flushed filesets (bootstrapper/fs/source.go)
- commitlog: most-recent snapshots + WAL replay (bootstrapper/commitlog)
- peers: AdminSession block streaming from replicas, best peer per block
  by checksum agreement (peer_streaming.md)
- uninitialized_topology: succeeds only for brand-new topologies

The device work runs on each namespace's device (the database's): the
filesystem bootstrapper's blooms (verify_rows) and block reads, the
snapshot tiles' reads, and the WAL replay's shard routing (the hash
kernel, one launch a chunk, one copy of the shard ids to the host). A
fault of the hash kernel on the card raises typed; nothing falls back to
a host hash. What needs a cluster is not ported: a peers bootstrapper
given a session, or an uninitialized-topology bootstrapper given a
placement, raises PeersBootstrapUnsupported (the client session and the
placement are later work); without them both behave as the reference's
do on a single node."""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve
from ..persist import commitlog as cl
from ..persist.diskio import CorruptionError
from ..persist.fs import FilesetReader, PersistManager, quarantine_fileset
from ..utils import xtime
from ..utils.hashing import hash_batch
from ..utils.instrument import ROOT
from .timerange import ShardTimeRanges, overlaps

# Commitlog-bootstrap observability: a skipped WAL replay (no shard
# lookup on a partial shard set) means acked data was LEFT ON DISK —
# counted, logged, and surfaced on the BootstrapResult, never silent.
_CL_BOOT_METRICS = ROOT.sub_scope("bootstrap.commitlog")
# Filesystem-bootstrap observability: a fileset flunking its integrity
# verification is quarantined (not served, not silently skipped) and the
# unclaimed range falls through to the commitlog/peers chain.
_FS_BOOT_METRICS = ROOT.sub_scope("bootstrap.fs")
_LOG = logging.getLogger("m3_tpu_torch.storage.bootstrap")


class PeersBootstrapUnsupported(NotImplementedError):
    """Peer streaming and placement-aware bootstrap need the client
    session and the cluster placement, which the port does not have
    yet."""


@dataclasses.dataclass
class BootstrapContext:
    """The sources a chain reads. `session` and `placement` are the
    cluster's (the reference's peer-streaming host id and deadline go with
    them when they are ported): given either, the bootstrappers that need
    them raise PeersBootstrapUnsupported."""

    persist: Optional[PersistManager] = None
    commitlog_dir: Optional[str] = None
    session: Optional[object] = None       # client.Session (admin surface)
    placement: Optional[object] = None     # cluster.placement.Placement
    shard_lookup: Optional[object] = None  # Callable[[bytes], int] (shard set)


@dataclasses.dataclass
class BootstrapResult:
    """Per-namespace outcome: what each bootstrapper claimed and what was
    left unfulfilled (bootstrap/result pkg). `notes` carries operator-
    facing anomalies a claim can't express — e.g. the commitlog
    bootstrapper claiming ranges while having SKIPPED WAL replay."""

    requested: ShardTimeRanges
    claimed: Dict[str, ShardTimeRanges] = dataclasses.field(default_factory=dict)
    unfulfilled: Optional[ShardTimeRanges] = None
    notes: List[str] = dataclasses.field(default_factory=list)


class Bootstrapper:
    name = "base"

    def bootstrap(self, ns, shard_ranges: ShardTimeRanges,
                  ctx: BootstrapContext) -> ShardTimeRanges:
        """Load what it can into `ns`, return the claimed (fulfilled) ranges."""
        raise NotImplementedError


class FilesystemBootstrapper(Bootstrapper):
    """bootstrapper/fs: read complete filesets whose block intersects the
    requested ranges, install as sealed blocks."""

    name = "filesystem"

    def __init__(self):
        self.notes: List[str] = []

    def pop_notes(self) -> List[str]:
        notes, self.notes = self.notes, []
        return notes

    def bootstrap(self, ns, shard_ranges, ctx):
        claimed = ShardTimeRanges()
        if ctx.persist is None:
            return claimed
        if ns.index is not None:
            # Index phase: load persisted segments before data blocks
            # (bootstrapper/base_index_step.go).
            from ..index import persist as idx_persist

            idx_persist.bootstrap_index(ctx.persist.root, ns.name, ns.index)
        bsz = ns.opts.block_size_ns
        for shard_id in shard_ranges.shards():
            shard = ns.shards.get(shard_id)
            if shard is None:
                continue
            for bs, path in ctx.persist.list_filesets(ns.name, shard_id):
                if not overlaps(shard_ranges.ranges(shard_id), bs, bs + bsz):
                    continue
                try:
                    reader = FilesetReader(path, device=ns.device)
                    reader.verify_rows()
                    blk, ids = reader.to_block()
                except FileNotFoundError:
                    continue  # cleanup raced the listing
                except (CorruptionError, ValueError, KeyError, OSError) as e:
                    # The fileset flunked its integrity verification:
                    # quarantine it so nothing ever serves it, leave the
                    # range UNCLAIMED so the chain falls through to the
                    # commitlog (snapshot + WAL replay) / peers sources,
                    # and surface the anomaly to the operator.
                    _FS_BOOT_METRICS.counter("corrupt_quarantined").inc()
                    qdst = quarantine_fileset(
                        path,
                        reason=f"bootstrap: {type(e).__name__}: {e}",
                        rows=getattr(e, "rows", ()),
                        ids=getattr(e, "ids", ()))
                    note = (f"filesystem: fileset at {path} failed "
                            f"verification ({type(e).__name__}: {e}); "
                            + (f"quarantined to {qdst}" if qdst else
                               "quarantine FAILED, left in place")
                            + " — range left to the commitlog/peers chain")
                    _LOG.warning(note)
                    self.notes.append(note)
                    continue
                with shard.write_lock:
                    remap, _created = shard.registry.get_or_create_batch(ids)
                shard.load_block(blk, np.asarray(remap, np.int32))
                claimed.add(shard_id, bs, bs + bsz)
        return claimed


def load_snapshots(ns, shard_ranges, ctx) -> Dict[int, Dict[int, Optional[Tuple[int, int]]]]:
    """Install the newest snapshot fileset per (shard, block) as a
    sealed (series x time) tile: digest chain already verified at
    reader construction, row adlers + bloom verified in one vectorized
    pass, registry resolution ONE batch per fileset, and the encoded
    codeword matrix installed directly via load_block — no per-row
    decode, no per-row registry probe (the apply_peer_tiles shape).
    WAL entries replayed on top land in the mutable buffer; when the
    window seals, Shard._tick_locked folds them in via merge_same_start.

    Returns {shard_id: {block_start: wal_position-or-None}} — the
    chunk-aligned commit log positions the snapshots were cut at, so
    WAL replay can skip chunks the snapshot provably contains."""
    from .shard import FlushState

    positions: Dict[int, Dict[int, Optional[Tuple[int, int]]]] = {}
    bsz = ns.opts.block_size_ns
    for shard_id in shard_ranges.shards():
        shard = ns.shards.get(shard_id)
        if shard is None:
            continue
        newest: Dict[int, Tuple[int, str]] = {}
        for bs, version, path in ctx.persist.list_snapshots(ns.name, shard_id):
            if not overlaps(shard_ranges.ranges(shard_id), bs, bs + bsz):
                continue
            if bs not in newest or version > newest[bs][0]:
                newest[bs] = (version, path)
        for bs, (_v, path) in newest.items():
            try:
                reader = FilesetReader(path, device=ns.device)
                reader.verify_rows()
                blk, ids = reader.to_block()
            except (IOError, FileNotFoundError):
                continue
            with shard.write_lock:
                remap, _created = shard.registry.get_or_create_batch(ids)
            # NOT_STARTED: a snapshot is not a durable flush — the
            # rebuilt block must stay on the flush schedule.
            shard.load_block(blk, np.asarray(remap, np.int32),
                             flush_state=FlushState.NOT_STARTED)
            positions.setdefault(shard_id, {})[bs] = reader.wal_position()
    return positions


def load_snapshots_ref(ns, shard_ranges, ctx):
    """The pre-batching per-row snapshot install, retained verbatim as
    the equivalence ORACLE (tests/test_durability.py asserts the tile
    install read- and registry-identical to this): per-row registry
    get_or_create, one buffer write per series row. Never used on the
    recovery path."""
    bsz = ns.opts.block_size_ns
    for shard_id in shard_ranges.shards():
        shard = ns.shards.get(shard_id)
        if shard is None:
            continue
        newest: Dict[int, Tuple[int, str]] = {}
        for bs, version, path in ctx.persist.list_snapshots(ns.name, shard_id):
            if not overlaps(shard_ranges.ranges(shard_id), bs, bs + bsz):
                continue
            if bs not in newest or version > newest[bs][0]:
                newest[bs] = (version, path)
        for bs, (_v, path) in newest.items():
            try:
                blk, ids = FilesetReader(path, device=ns.device).to_block()
            except (IOError, FileNotFoundError):
                continue
            ts, vals, npoints = blk.read_all()
            for row, sid in enumerate(ids):
                idx, _ = shard.registry.get_or_create(sid)
                n = int(npoints[row])
                shard.buffer.write_batch(
                    np.full(n, idx, np.int32),
                    np.asarray(ts[row, :n], np.int64),
                    np.asarray(vals[row, :n], np.float64),
                )


def replay_wal(ns, shard_ranges, ctx,
               snap_positions: Optional[Dict[int, Dict[int, Optional[Tuple[int, int]]]]] = None,
               ) -> bool:
    """Columnar WAL replay (iterator.go replay, batched): consume
    `commitlog.replay_batches` chunk-at-a-time, route each chunk's
    surviving rows to shards in one vectorized murmur pass
    (hash_batch: the hash kernel on the namespace's device, its shard ids
    brought to the host in one copy), and apply ONE registry
    batch-resolve + ONE columnar
    buffer append per shard per chunk — no per-entry host loop. Chunks
    wholly at-or-before a snapshot's recorded WAL position skip that
    snapshot's block (their entries are provably inside the installed
    tile). Returns False when replay was SKIPPED because no shard
    lookup exists for a partial shard set (the caller surfaces it).

    Called once per NAMESPACE by the chain, so a K-namespace node pays
    K streaming decode passes over the shared WAL; K is the configured
    namespace count (typically 1-2) and each pass stays chunk-bounded
    in memory — the trade keeps the bootstrapper contract (per-ns
    claim/remainder) instead of threading cross-namespace state through
    the chain."""
    lookup = ctx.shard_lookup
    murmur_n = None
    lookup_batch = None
    if lookup is None:
        # Fallback only valid when this node owns the FULL contiguous
        # shard space (single-node): murmur3 % N matches the cluster
        # routing. Otherwise skip replay rather than misroute.
        if ns.shards and len(ns.shards) == max(ns.shards) + 1:
            murmur_n = len(ns.shards)
        else:
            return False
    else:
        # A bound ShardSet.lookup routes whole columns through its
        # sibling lookup_batch (vectorized murmur) instead of one scalar
        # hash per entry.
        lookup_batch = getattr(getattr(lookup, "__self__", None),
                               "lookup_batch", None)
    bsz = ns.opts.block_size_ns
    snap_positions = snap_positions or {}
    route_cache: Dict[bytes, int] = {}
    # Per-shard ids whose tags are already resolved (indexed or known
    # tagged): persists across the whole replay stream so each series
    # pays its tag probe ONCE, not once per chunk.
    tags_resolved: Dict[int, set] = {}
    for batch in cl.replay_batches(ctx.commitlog_dir):
        sel = batch.namespaces == ns.name
        if not sel.any():
            continue
        ids = batch.ids[sel]
        ts = batch.t_ns[sel]
        vs = batch.values[sel]
        tgs = batch.tags[sel] if batch.tags is not None else None
        # Untagged chunks (raw-id writers, benches) skip the whole tag/
        # index recovery plane — one cheap scan here instead of a
        # per-shard per-entry pass below.
        if tgs is not None and all(t is None for t in tgs):
            tgs = None
        if murmur_n is not None:
            shard_ids = (hash_batch(ids, device=ns.device) % murmur_n
                         ).cpu().numpy()
        elif lookup_batch is not None:
            shard_ids = lookup_batch(ids, device=ns.device).cpu().numpy(
                ).astype(np.int64)
        else:
            # Arbitrary caller-provided lookup: memoized per distinct id
            # (the id set is far smaller than the entry stream).
            shard_ids = np.empty(len(ids), np.int64)
            get = route_cache.get
            for i, sid in enumerate(ids):
                r = get(sid)
                if r is None:
                    r = route_cache[sid] = lookup(sid)
                shard_ids[i] = r
        for raw_shard in np.unique(shard_ids):
            shard_id = int(raw_shard)
            if shard_id not in shard_ranges.m:
                continue
            shard = ns.shards.get(shard_id)
            if shard is None:
                continue
            m = shard_ids == raw_shard
            ids_shard = ids[m]
            tgs_shard = tgs[m] if tgs is not None else None
            # Index recovery is DECOUPLED from the data filters below: a
            # series installed untagged from a snapshot tile (or whose
            # chunks the snapshot position-skip drops) still needs its
            # WAL-carried tags to rebuild the reverse-index document —
            # without them, recovered data is unreachable by query.
            fresh: List[Tuple[bytes, dict, int]] = []
            if tgs_shard is not None:
                seen = tags_resolved.setdefault(shard_id, set())
                reg = shard.registry
                for sid, tg in zip(ids_shard, tgs_shard):
                    if tg is None or sid in seen:
                        continue
                    seen.add(sid)
                    idx = reg.get(sid)
                    if idx is not None and reg.tags_of(idx) is None:
                        reg.ensure_tags(idx, tg)
                        fresh.append((sid, tg, int(idx)))
            tss = ts[m]
            keep = np.zeros(len(tss), bool)
            for s, e in shard_ranges.ranges(shard_id):
                keep |= (tss >= s) & (tss < e)
            pos_map = snap_positions.get(shard_id)
            if pos_map and keep.any():
                starts = tss - tss % bsz
                for bs, pos in pos_map.items():
                    if batch.before(pos):
                        keep &= starts != bs
            if keep.any():
                ids_kept = ids_shard[keep].tolist()
                tags_kept = (tgs_shard[keep].tolist()
                             if tgs_shard is not None else None)
                with shard.write_lock:
                    sidx, created = shard.registry.get_or_create_batch_tagged(
                        ids_kept, tags_kept)
                    shard.buffer.write_batch(
                        np.asarray(sidx, np.int32), tss[keep], vs[m][keep])
                if tags_kept is not None:
                    # Tags come from the REGISTRY after resolution, not
                    # from the created position: a series first seen
                    # untagged whose tagged entry lands later in the
                    # SAME chunk had its tags backfilled inside the
                    # batch call — the hook must still fire for it.
                    reg = shard.registry
                    seen = tags_resolved.setdefault(shard_id, set())
                    for j in created:
                        tg = reg.tags_of(int(sidx[j]))
                        if tg is not None:
                            fresh.append((ids_kept[j], tg, int(sidx[j])))
                            seen.add(ids_kept[j])
            if fresh:
                # Same hook wiring as the write path's insert-queue
                # drain: ONE batched reverse-index insert per shard per
                # chunk, outside the shard lock.
                if shard.on_new_series_batch is not None:
                    shard.on_new_series_batch(fresh)
                elif shard.on_new_series is not None:
                    for sid, tg, ix in fresh:
                        shard.on_new_series(sid, tg, ix)
    return True


def replay_wal_ref(ns, shard_ranges, ctx) -> bool:
    """The pre-batching per-entry WAL replay, retained verbatim as the
    bit-identity ORACLE (tests/test_durability.py asserts replay_wal
    leaves buffer columns and registries bit-identical to this): one
    (ns, id, t, value) tuple at a time over the per-entry iterator,
    per-entry shard routing and filtering, per-entry registry resolve.
    Never used on the recovery path."""
    batch: Dict[int, List[Tuple[bytes, int, float]]] = {}
    lookup = ctx.shard_lookup
    if lookup is None:
        if ns.shards and len(ns.shards) == max(ns.shards) + 1:
            n = len(ns.shards)
            lookup = lambda sid: _murmur_shard(sid, n)  # noqa: E731
        else:
            return False
    for entry_ns, sid, t_ns, value in cl.replay_ref(ctx.commitlog_dir):
        if entry_ns != ns.name:
            continue
        shard_id = lookup(sid)
        if shard_id not in shard_ranges.m:
            continue
        if not overlaps(shard_ranges.ranges(shard_id), t_ns, t_ns + 1):
            continue
        batch.setdefault(shard_id, []).append((sid, t_ns, value))
    for shard_id, entries in batch.items():
        shard = ns.shards.get(shard_id)
        if shard is None:
            continue
        sidx = np.empty(len(entries), np.int32)
        for i, (sid, _t, _v) in enumerate(entries):
            sidx[i], _ = shard.registry.get_or_create(sid)
        shard.buffer.write_batch(
            sidx,
            np.array([t for _s, t, _v in entries], np.int64),
            np.array([v for _s, _t, v in entries], np.float64),
        )
    return True


class CommitlogBootstrapper(Bootstrapper):
    """bootstrapper/commitlog: install the newest snapshot fileset per
    block as a sealed columnar tile, then replay the WAL tail on top as
    chunk batches; claims ALL requested ranges (the commit log cannot
    prove absence of data, matching the reference's source which marks
    everything fulfilled). A replay skipped for want of shard routing
    is counted (`bootstrap.commitlog` replay_skipped), logged, and
    surfaced on the BootstrapResult notes."""

    name = "commitlog"

    def __init__(self):
        self.notes: List[str] = []

    def pop_notes(self) -> List[str]:
        notes, self.notes = self.notes, []
        return notes

    def bootstrap(self, ns, shard_ranges, ctx):
        claimed = ShardTimeRanges()
        if ctx.persist is None and ctx.commitlog_dir is None:
            # No durability sources configured: claim nothing so the chain
            # falls through to peers/uninitialized.
            return claimed
        # Snapshots first (newest version per block start).
        snap_positions = None
        if ctx.persist is not None:
            snap_positions = load_snapshots(ns, shard_ranges, ctx)
        # WAL replay on top (iterator.go replay, columnar).
        if ctx.commitlog_dir is not None:
            if not replay_wal(ns, shard_ranges, ctx, snap_positions):
                _CL_BOOT_METRICS.counter("replay_skipped").inc()
                note = (f"commitlog: WAL replay SKIPPED for namespace "
                        f"{ns.name!r}: no shard_lookup and this node's "
                        f"shard set is not the full contiguous space — "
                        f"acked data may remain unreplayed on disk at "
                        f"{ctx.commitlog_dir}")
                _LOG.warning(note)
                self.notes.append(note)
        for shard_id in shard_ranges.shards():
            for s, e in shard_ranges.ranges(shard_id):
                claimed.add(shard_id, s, e)
        return claimed


def _murmur_shard(sid: bytes, num_shards: int) -> int:
    from ..utils.hashing import murmur3_32

    return murmur3_32(sid) % num_shards


class PeersBootstrapper(Bootstrapper):
    """bootstrapper/peers: stream replica blocks via the admin session.
    Without a session (a single node) it claims nothing, as the
    reference's does, and the chain falls through; with one it raises
    PeersBootstrapUnsupported, since the port has no client session."""

    name = "peers"

    def bootstrap(self, ns, shard_ranges, ctx):
        claimed = ShardTimeRanges()
        if ctx.session is None:
            return claimed
        raise PeersBootstrapUnsupported(
            "peers bootstrap streams blocks through client.Session, which "
            "m3_tpu_torch does not have yet (ROADMAP A13.2)")


class UninitializedTopologyBootstrapper(Bootstrapper):
    """bootstrapper/uninitialized: succeeds only when every replica of the
    shard is still INITIALIZING — i.e. a brand-new topology where no peer
    could possibly have data."""

    name = "uninitialized_topology"

    def bootstrap(self, ns, shard_ranges, ctx):
        claimed = ShardTimeRanges()
        if ctx.placement is None:
            # No cluster: single-node fresh start claims everything.
            for shard_id in shard_ranges.shards():
                for s, e in shard_ranges.ranges(shard_id):
                    claimed.add(shard_id, s, e)
            return claimed
        raise PeersBootstrapUnsupported(
            "uninitialized_topology with a placement reads shard states "
            "from cluster/placement.py, which m3_tpu_torch does not have "
            "yet (ROADMAP A13.2)")


DEFAULT_CHAIN = ("filesystem", "commitlog", "peers", "uninitialized_topology")

_REGISTRY = {
    "filesystem": FilesystemBootstrapper,
    "commitlog": CommitlogBootstrapper,
    "peers": PeersBootstrapper,
    "uninitialized_topology": UninitializedTopologyBootstrapper,
}


class BootstrapProcess:
    """process.go:150 run: compute target ranges from retention, run the
    chain per namespace, mark the db bootstrapped."""

    def __init__(self, chain=DEFAULT_CHAIN, ctx: BootstrapContext = None):
        self.bootstrappers = [_REGISTRY[name]() for name in chain]
        self.ctx = ctx or BootstrapContext()

    def target_ranges(self, ns, now_ns: int,
                      shard_ids: Optional[List[int]] = None) -> ShardTimeRanges:
        bsz = ns.opts.block_size_ns
        start = xtime.truncate(now_ns - ns.opts.retention_ns, bsz)
        end = xtime.truncate(now_ns, bsz) + bsz
        shards = shard_ids if shard_ids is not None else sorted(ns.shards)
        return ShardTimeRanges.uniform(shards, start, end)

    def run(self, db, now_ns: Optional[int] = None,
            shard_ids: Optional[List[int]] = None) -> Dict[bytes, BootstrapResult]:
        """Bootstrap every namespace of `db` on the db's device (raising
        when that is the CUDA card and none is present)."""
        resolve(db.device)
        now = now_ns if now_ns is not None else db.clock()
        results: Dict[bytes, BootstrapResult] = {}
        for name, ns in db.namespaces.items():
            requested = self.target_ranges(ns, now, shard_ids)
            remaining = requested.copy()
            result = BootstrapResult(requested=requested)
            for b in self.bootstrappers:
                if remaining.is_empty():
                    break
                claimed = b.bootstrap(ns, remaining, self.ctx)
                result.claimed[b.name] = claimed
                pop_notes = getattr(b, "pop_notes", None)
                if pop_notes is not None:
                    # Anomalies the claim can't express (e.g. a skipped
                    # WAL replay) ride the result to the operator.
                    result.notes.extend(pop_notes())
                remaining = remaining.subtract(claimed)
            result.unfulfilled = remaining
            results[name] = result
        db.mark_bootstrapped()
        return results
