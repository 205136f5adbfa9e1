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
snapshot tiles' reads, the WAL replay's shard routing (the hash kernel,
one launch a chunk, one copy of the shard ids to the host), and the peers
bootstrapper's mixed-unit re-encodes (the decode, then the pack kernel).
Peer tiles arrive as host numpy words and install without a decode. A
fault of a kernel on the card raises typed; nothing falls back to a host
codec."""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve
from ..persist import commitlog as cl
from ..persist.diskio import CorruptionError
from ..persist.fs import FilesetReader, PersistManager, quarantine_fileset
from ..utils import tracing, xtime
from ..utils.hashing import hash_batch
from ..utils.instrument import ROOT
from ..utils.retry import Deadline
from .block import SealedBlock
from .timerange import ShardTimeRanges, normalize, overlaps, subtract

# Peer-bootstrap observability: typed peer failures and partial coverage
# count here instead of disappearing into except/continue.
_PEER_BOOT_METRICS = ROOT.sub_scope("bootstrap.peers")

# Commitlog-bootstrap observability: a skipped WAL replay (no shard
# lookup on a partial shard set) means acked data was LEFT ON DISK —
# counted, logged, and surfaced on the BootstrapResult, never silent.
_CL_BOOT_METRICS = ROOT.sub_scope("bootstrap.commitlog")
# Filesystem-bootstrap observability: a fileset flunking its integrity
# verification is quarantined (not served, not silently skipped) and the
# unclaimed range falls through to the commitlog/peers chain.
_FS_BOOT_METRICS = ROOT.sub_scope("bootstrap.fs")
_LOG = logging.getLogger("m3_tpu_torch.storage.bootstrap")


@dataclasses.dataclass
class BootstrapContext:
    persist: Optional[PersistManager] = None
    commitlog_dir: Optional[str] = None
    session: Optional[object] = None       # client.Session (admin surface)
    host_id: Optional[str] = None
    placement: Optional[object] = None     # cluster.placement.Placement
    shard_lookup: Optional[object] = None  # Callable[[bytes], int] (shard set)
    # Per-shard peer-streaming budget: rides every metadata/tile RPC as a
    # Deadline, so one faultnet-delayed peer bounds that shard's fetch
    # instead of stalling the whole bootstrap. None = unbounded.
    peer_deadline_s: Optional[float] = None


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


def _iter_tile_rows(tiles: Dict[int, List[dict]]):
    """Canonical row order over a tile map: block starts ascending, tiles
    in arrival order, rows in tile order. BOTH apply paths register
    series in this order, so their registries — and therefore the
    sorted-by-index block layouts — are bit-identical by construction."""
    for bs in sorted(tiles):
        for tile in tiles[bs]:
            yield bs, tile


def _install_encoded(shard, bs: int, built: SealedBlock):
    """Install a freshly re-encoded block (mixed-unit merge): replace any
    resident block, adopt the encode's device buffers into the block
    cache, reclaim the HBM budget OUTSIDE the shard lock."""
    from . import block_cache
    from .shard import FlushState

    cache = block_cache.get_cache()
    with shard.write_lock:
        old = shard.blocks.get(bs)
        if old is not None:
            # Replacing a resident block: its generation's cached planes
            # die with it.
            cache.invalidate_block(old)
        shard.blocks[bs] = built
        # Adopt (or drop) the encode's device buffers: a long-lived
        # block must never pin them outside the budget's sight.
        cache.retain_encoded(built, getattr(shard, "namespace_name", None),
                             shard.shard_id)
        shard.flush_states.setdefault(bs, FlushState.SUCCESS)
    # Per-block reclaim OUTSIDE the shard lock: a many-block peers
    # bootstrap must not overshoot the HBM budget for the whole recovery
    # window (Shard.tick makes the same call after its seals).
    cache.budget.reclaim()


def _apply_mixed_unit_rows(shard, bs: int, rows: List[Tuple[int, dict]]):
    """Replicas sealed this block with different tick scales
    (choose_time_unit diverged): decode each row at its own unit
    (pow2-bucketed batched decode, the decode kernel) and re-encode the
    tile uniformly (the pack kernel), both on the shard's device."""
    from ..client.decode import decode_segment_groups
    from .block import encode_block
    from .buffer import to_dense

    decoded = decode_segment_groups([b for _i, b in rows],
                                    device=shard.device)
    sidx = np.concatenate([
        np.full(len(t), idx, np.int32)
        for (idx, _b), (t, _v) in zip(rows, decoded)])
    ts = np.concatenate([t for t, _v in decoded])
    vs = np.concatenate([v for _t, v in decoded])
    order = np.lexsort((ts, sidx))
    series, td, vd, counts = to_dense(sidx[order], ts[order], vs[order])
    _install_encoded(shard, bs, encode_block(bs, series, td, vd, counts,
                                             device=shard.device))


def apply_peer_tiles(shard, tiles: Dict[int, List[dict]],
                     tags_by_sid: Dict[bytes, dict]) -> int:
    """Batched peer-block apply: register every streamed series in ONE
    registry batch (the insert-queue drain's registry call), then install
    each block start from its columnar tiles — per-tile slice assignment
    into the [rows, max_words] matrix, no per-row fills, no per-series
    get_or_create. Mixed-time-unit blocks (replicas sealed at different
    tick scales) fall back to the batched decode + re-encode path.
    Returns the number of blocks installed."""
    ids = list(dict.fromkeys(
        sid for _bs, tile in _iter_tile_rows(tiles) for sid in tile["ids"]))
    if not ids:
        return 0
    tags = [tags_by_sid.get(sid) or None for sid in ids]
    with shard.write_lock:
        idxs, _created = shard.registry.get_or_create_batch_tagged(ids, tags)
    rank = dict(zip(ids, (int(i) for i in idxs)))
    installed = 0
    for bs in sorted(tiles):
        tlist = tiles[bs]
        units = {int(t["time_unit"]) for t in tlist}
        if len(units) != 1:
            rows: List[Tuple[int, dict]] = []
            for tile in tlist:
                words = np.asarray(tile["words"])
                nbits = np.asarray(tile["nbits"])
                npoints = np.asarray(tile["npoints"])
                rows.extend(
                    (rank[sid], {"bs": bs, "words": words[i],
                                 "nbits": int(nbits[i]),
                                 "npoints": int(npoints[i]),
                                 "window": int(tile["window"]),
                                 "time_unit": int(tile["time_unit"])})
                    for i, sid in enumerate(tile["ids"]))
            _apply_mixed_unit_rows(shard, bs, rows)
            installed += 1
            continue
        n = sum(len(t["ids"]) for t in tlist)
        window = max(int(t["window"]) for t in tlist)
        mw = max(np.asarray(t["words"]).shape[-1] for t in tlist)
        words = np.zeros((n, mw), np.uint32)
        nbits = np.empty(n, np.int32)
        npoints = np.empty(n, np.int32)
        remap = np.empty(n, np.int32)
        r = 0
        for tile in tlist:
            w = np.asarray(tile["words"])
            k = w.shape[0]
            words[r:r + k, : w.shape[-1]] = w
            nbits[r:r + k] = np.asarray(tile["nbits"])
            npoints[r:r + k] = np.asarray(tile["npoints"])
            remap[r:r + k] = np.fromiter(
                (rank[sid] for sid in tile["ids"]), np.int32, count=k)
            r += k
        blk = SealedBlock(
            block_start=bs, window=window,
            series_indices=np.arange(n, dtype=np.int32),
            words=words, nbits=nbits, npoints=npoints,
            time_unit=xtime.Unit(units.pop()), device=shard.device)
        shard.load_block(blk, remap)
        installed += 1
    return installed


def apply_peer_tiles_ref(shard, tiles: Dict[int, List[dict]],
                         tags_by_sid: Dict[bytes, dict]) -> int:
    """The pre-batching per-row apply path, retained as the property-test
    ORACLE (the tests assert apply_peer_tiles bit-identical to this):
    per-series registry get_or_create, per-row np fills into the block
    tile. Never used on the serving path."""
    installed = 0
    per_block: Dict[int, List[Tuple[int, dict]]] = {}
    for bs, tile in _iter_tile_rows(tiles):
        words = np.asarray(tile["words"])
        nbits = np.asarray(tile["nbits"])
        npoints = np.asarray(tile["npoints"])
        for i, sid in enumerate(tile["ids"]):
            idx, _ = shard.registry.get_or_create(
                sid, tags_by_sid.get(sid) or None)
            per_block.setdefault(bs, []).append(
                (idx, {"bs": bs, "words": words[i], "nbits": int(nbits[i]),
                       "npoints": int(npoints[i]),
                       "window": int(tile["window"]),
                       "time_unit": int(tile["time_unit"])}))
    for bs, rows in per_block.items():
        units = {int(b["time_unit"]) for _i, b in rows}
        if len(units) == 1:
            window = max(int(b["window"]) for _i, b in rows)
            mw = max(np.asarray(b["words"]).shape[-1] for _i, b in rows)
            words = np.zeros((len(rows), mw), np.uint32)
            nbits = np.zeros(len(rows), np.int32)
            npoints = np.zeros(len(rows), np.int32)
            remap = np.zeros(len(rows), np.int32)
            for i, (idx, b) in enumerate(rows):
                w = np.asarray(b["words"])
                words[i, : w.shape[-1]] = w
                nbits[i] = b["nbits"]
                npoints[i] = b["npoints"]
                remap[i] = idx
            blk = SealedBlock(
                block_start=bs, window=window,
                series_indices=np.arange(len(rows), dtype=np.int32),
                words=words, nbits=nbits, npoints=npoints,
                time_unit=xtime.Unit(units.pop()), device=shard.device,
            )
            shard.load_block(blk, remap)
        else:
            _apply_mixed_unit_rows(shard, bs, rows)
        installed += 1
    return installed


class PeersBootstrapper(Bootstrapper):
    """bootstrapper/peers: stream replica blocks via the admin session
    (columnar tile streaming), choosing the best peer per block by
    checksum agreement, with xresil retry/breaker underneath and
    mid-stream peer death re-planned onto the next checksum holder.

    Partial coverage is SURFACED, not swallowed: blocks whose every
    holder failed subtract their windows from the claim (the chain's
    unfulfilled remainder names them), typed peer failures count in the
    `bootstrap.peers` instrument scope, and untyped errors propagate."""

    name = "peers"

    def bootstrap(self, ns, shard_ranges, ctx):
        # Typed transport classification shared with the session layer
        # (imported lazily: storage must not import client at module
        # scope — client.session already imports storage types).
        from ..client.session import PEER_SKIP_ERRORS

        claimed = ShardTimeRanges()
        if ctx.session is None:
            return claimed
        bsz = ns.opts.block_size_ns
        for shard_id in shard_ranges.shards():
            shard = ns.shards.get(shard_id)
            if shard is None:
                continue
            ranges = shard_ranges.ranges(shard_id)
            start = min(s for s, _e in ranges)
            end = max(e for _s, e in ranges)
            deadline = (Deadline.after(ctx.peer_deadline_s)
                        if ctx.peer_deadline_s is not None else None)
            errors: Dict[str, str] = {}
            meta_errors: Dict[str, str] = {}
            # Span per peer-streamed shard: a churn-era bootstrap under a
            # sampled span yields one tree whose children are the peer
            # metadata/tile RPCs (grafted server spans included), so
            # shard-migration time is attributable per hop.
            with tracing.child_span("bootstrap.peer_shard",
                                    shard=shard_id) as bsp:
                try:
                    tiles, tags_by_sid, failed = \
                        ctx.session.fetch_block_tiles_from_peers(
                            ns.name, shard_id, start, end,
                            exclude_host=ctx.host_id, deadline=deadline,
                            errors=errors, meta_errors=meta_errors)
                except PEER_SKIP_ERRORS:
                    # Whole-shard typed transport failure (topology gone,
                    # budget spent before any peer answered): claim nothing
                    # for THIS shard, keep bootstrapping the rest.
                    _PEER_BOOT_METRICS.counter("on_error").inc()
                    continue
                if errors or meta_errors:
                    _PEER_BOOT_METRICS.counter("on_error").inc(
                        len(errors) + len(meta_errors))
                bsp.set_tag("blocks", sum(len(t) for t in tiles.values()))
                # Whatever DID arrive is real data — always install it.
                apply_peer_tiles(shard, tiles, tags_by_sid)
            if failed:
                _PEER_BOOT_METRICS.counter("blocks_failed").inc(len(failed))
            if meta_errors:
                # A peer lost during the METADATA phase may have held
                # sealed blocks nobody else has (e.g. it was the only
                # surviving acker): the plan itself is incomplete and
                # the missing blocks cannot even be enumerated — claim
                # NOTHING for this shard so the hole surfaces as
                # unfulfilled instead of being silently sealed over.
                _PEER_BOOT_METRICS.counter("shards_uncovered").inc()
                continue
            # Claim what was actually covered: the requested ranges minus
            # the block windows whose every checksum holder failed.
            fail_windows = normalize(
                [(bs, bs + bsz) for _sid, bs in failed])
            for s, e in subtract(ranges, fail_windows):
                claimed.add(shard_id, s, e)
        return claimed


class UninitializedTopologyBootstrapper(Bootstrapper):
    """bootstrapper/uninitialized: succeeds only when every replica of the
    shard is still INITIALIZING — i.e. a brand-new topology where no peer
    could possibly have data."""

    name = "uninitialized_topology"

    def bootstrap(self, ns, shard_ranges, ctx):
        from ..cluster.placement import ShardState

        claimed = ShardTimeRanges()
        if ctx.placement is None:
            # No cluster: single-node fresh start claims everything.
            for shard_id in shard_ranges.shards():
                for s, e in shard_ranges.ranges(shard_id):
                    claimed.add(shard_id, s, e)
            return claimed
        for shard_id in shard_ranges.shards():
            replicas = ctx.placement.replicas_for(
                shard_id, states=(ShardState.INITIALIZING, ShardState.AVAILABLE))
            all_new = all(
                inst.shards[shard_id].state == ShardState.INITIALIZING
                for inst in replicas
            ) if replicas else True
            if all_new:
                for s, e in shard_ranges.ranges(shard_id):
                    claimed.add(shard_id, s, e)
        return claimed


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
