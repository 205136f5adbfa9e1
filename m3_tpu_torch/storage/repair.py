"""Peer checksum-diff repair (port of m3_tpu/storage/repair.py;
reference: src/dbnode/storage/repair.go — dbRepairer :370 drives
shardRepairer :85, which diffs local block metadata against replica
peers' and reconciles divergent blocks).

Repair granularity is (shard, block): local rows whose checksum differs
from the peer-majority checksum are fetched as columnar tiles (one word
matrix per (host, block), not one dict per series), decoded in batched
pow2-bucketed launches of the decode kernel, merged point-wise with the
local copy (last-write-wins, peer-later), and the whole block tile
re-encoded in one launch of the pack kernel, all on the shard's device.
Peer failures are typed: a dead majority holder falls back to the next
host with the same checksum, and only rows every holder failed are
dropped (counted, never silent).

The decode -> merge -> re-encode pipeline runs OUTSIDE the shard write
lock (snapshot in, install out, with a same-start merge if a seal raced
the rebuild), so a concurrent repair sweep cannot monopolize the write
path's locks.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..client.decode import decode_tile
from ..utils.instrument import ROOT
from ..utils.retry import Deadline, RetryOptions, Retrier
from . import block_cache
from .block import encode_block, merge_same_start
from .buffer import to_dense

_REPAIR_METRICS = ROOT.sub_scope("repair")


@dataclasses.dataclass
class RepairStats:
    blocks_compared: int = 0
    checksum_mismatches: int = 0
    rows_missing_locally: int = 0
    blocks_rebuilt: int = 0
    # Typed peer-streaming failures observed (metadata peers skipped +
    # block-fetch holders that failed over) and rows no holder served.
    peer_errors: int = 0
    rows_unfetched: int = 0

    def add(self, other: "RepairStats"):
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


class ShardRepairer:
    """repair.go:85 shardRepairer."""

    def __init__(self, session, host_id: Optional[str] = None,
                 deadline_s: Optional[float] = None):
        self.session = session
        self.host_id = host_id
        # Per-shard peer-streaming budget: a faultnet-delayed peer bounds
        # the sweep instead of stalling it (None = unbounded).
        self.deadline_s = deadline_s

    def repair_shard(self, ns, shard_id: int, start_ns: int, end_ns: int) -> RepairStats:
        stats = RepairStats()
        shard = ns.shards.get(shard_id)
        if shard is None:
            return stats
        deadline = (Deadline.after(self.deadline_s)
                    if self.deadline_s is not None else None)
        errors: Dict[str, str] = {}
        meta = self.session.fetch_block_metadata_tiles_from_peers(
            ns.name, shard_id, start_ns, end_ns, exclude_host=self.host_id,
            deadline=deadline, errors=errors)
        stats.peer_errors += len(errors)
        if not meta:
            return stats

        # Checksum-majority vote per (series, block) — vectorized over
        # the columnar metadata — then compare against local rows in
        # batch: registry resolve once per shard, row resolve one
        # searchsorted per block, local checksums one pass per block.
        tags_by_sid, sids, hosts_list, per_bs = \
            self.session.plan_block_majority(meta)
        lidx = shard.registry.lookup_batch(sids)  # -1 = unknown locally
        # One plan per "copy slot": a row diverging from SEVERAL distinct
        # peer checksums fetches one copy of EACH (slot k holds each
        # row's k-th divergent checksum), so one sweep merges the FULL
        # union — majority-only fetching converges pairwise and can
        # stall on vote ties when all replicas diverge.
        plans: List[Dict[Tuple[bytes, int], List[str]]] = []
        for bs in sorted(per_bs):
            p = per_bs[bs]
            gids = p["gids"]
            want = p["sums"]
            stats.blocks_compared += len(gids)
            local_sum = np.full(len(gids), -1, np.int64)
            blk = shard.blocks.get(bs)
            if blk is not None:
                li = lidx[gids]
                known = li >= 0
                si = blk.series_indices
                if len(si) and known.any():
                    cand = np.searchsorted(si, li[known])
                    cand = np.minimum(cand, len(si) - 1)
                    present = si[cand] == li[known]
                    rows = cand[present]
                    if len(rows):
                        # The block's memoized row checksums are THE
                        # checksum convention (SealedBlock.row_checksums
                        # — shared with the metadata tiles RPC).
                        local_sum[np.flatnonzero(known)[present]] = \
                            blk.row_checksums()[rows]
            diverged = local_sum != want
            stats.rows_missing_locally += int((local_sum == -1).sum())
            stats.checksum_mismatches += int(
                (diverged & (local_sum != -1)).sum())
            lsum_by_gid = dict(zip(gids.tolist(), local_sum.tolist()))
            # Same-checksum failover chains (no cross-checksum tail:
            # repair wants THAT copy, the other checksums get their own
            # slots), shared per combo via the session's single chain
            # builder: a dead holder fails over to the next host with
            # the SAME copy; rows no holder serves are counted, never
            # silently dropped.
            chain = self.session.holder_chain_builder(
                p, hosts_list, cross_checksum_tail=False)
            slot_of: Dict[int, int] = {}
            for gi, cc, rr in zip(p["run_g"].tolist(), p["run_c"].tolist(),
                                  p["run_r0"].tolist()):
                if cc == lsum_by_gid.get(gi):
                    continue  # this copy matches local: nothing to fetch
                slot = slot_of.get(gi, 0)
                slot_of[gi] = slot + 1
                while len(plans) <= slot:
                    plans.append({})
                plans[slot][(sids[gi], bs)] = chain(cc, rr)

        if not any(plans):
            return stats

        # Stream the peer copies as columnar tiles (holder-ranked waves;
        # typed failures count, never vanish) and merge per block.
        tiles: Dict[int, List[dict]] = {}
        for plan in plans:
            fetch_errors: Dict[str, str] = {}
            got, failed = self.session.fetch_block_tiles(
                ns.name, shard_id, plan, deadline=deadline,
                errors=fetch_errors)
            stats.peer_errors += len(fetch_errors)
            stats.rows_unfetched += len(failed)
            if failed:
                _REPAIR_METRICS.counter("rows_unfetched").inc(len(failed))
            for bs, tlist in got.items():
                tiles.setdefault(bs, []).extend(tlist)
        for bs in sorted(tiles):
            self._rebuild_block(ns, shard, bs, tiles[bs], tags_by_sid)
            stats.blocks_rebuilt += 1
        return stats

    def _rebuild_block(self, ns, shard, bs: int, tlist: List[dict],
                       tags_by_sid: Dict[bytes, dict]):
        """Decode local block + peer tiles, union points, re-encode the
        tile — all OUTSIDE the shard write lock. The lock is held only to
        snapshot inputs (local block + registry batch) and to install the
        result; a seal/merge that raced the rebuild is folded in with a
        same-start merge instead of being overwritten."""
        with shard.write_lock:
            local = shard.blocks.get(bs)
            # ONE registry batch registers every peer series (the
            # insert-queue drain's registry call — no per-series
            # get_or_create loop under the lock).
            ids = list(dict.fromkeys(
                sid for t in tlist for sid in t["ids"]))
            idxs, _created = shard.registry.get_or_create_batch_tagged(
                ids, [tags_by_sid.get(sid) or None for sid in ids])
        rank = dict(zip(ids, (int(i) for i in idxs)))

        # Flatten (registry idx, t, v) columns: local rows first, peer
        # rows after — the arrival order that makes "keep last per
        # (series, timestamp)" mean peer-wins, matching the session-side
        # LAST_PUSHED replica merge.
        sidx_parts: List[np.ndarray] = []
        t_parts: List[np.ndarray] = []
        v_parts: List[np.ndarray] = []

        def flatten(row_idx: np.ndarray, ts_plane, vs_plane, npoints):
            npoints = np.asarray(npoints, np.int64)
            mask = np.arange(ts_plane.shape[1]) < npoints[:, None]
            sidx_parts.append(np.repeat(row_idx.astype(np.int32), npoints))
            t_parts.append(np.asarray(ts_plane)[mask])
            v_parts.append(np.asarray(vs_plane)[mask])

        if local is not None:
            lts, lvs, lnp = local.read_all()
            flatten(np.asarray(local.series_indices), lts, lvs, lnp)
        for tile in tlist:
            pts, pvs = decode_tile(tile["words"], tile["npoints"],
                                   int(tile["window"]),
                                   int(tile["time_unit"]),
                                   device=shard.device)
            row_idx = np.fromiter((rank[sid] for sid in tile["ids"]),
                                  np.int32, count=len(tile["ids"]))
            flatten(row_idx, pts, pvs, tile["npoints"])

        sidx = np.concatenate(sidx_parts)
        ts = np.concatenate(t_parts)
        vs = np.concatenate(v_parts)
        arrival = np.arange(len(sidx))
        order = np.lexsort((arrival, ts, sidx))
        sidx, ts, vs = sidx[order], ts[order], vs[order]
        if len(sidx) > 1:
            # Keep the LAST arrival per (series, timestamp): contiguous
            # after the sort, later arrival (= peer copy) last.
            keep = np.empty(len(sidx), bool)
            np.logical_or(sidx[1:] != sidx[:-1], ts[1:] != ts[:-1],
                          out=keep[:-1])
            keep[-1] = True
            sidx, ts, vs = sidx[keep], ts[keep], vs[keep]
        series, tdense, vdense, counts = to_dense(sidx, ts, vs)
        rebuilt = encode_block(bs, series, tdense, vdense, counts,
                               device=shard.device)

        cache = block_cache.get_cache()
        with shard.write_lock:
            current = shard.blocks.get(bs)
            if current is not None and current is not local:
                # A seal/drain replaced the block while we rebuilt: fold
                # its (newer) points over the rebuild instead of dropping
                # them. Both inputs' generations die with the merge.
                merged = merge_same_start(rebuilt, current)
                cache.invalidate_block(current)
                cache.invalidate_block(rebuilt)
                rebuilt = merged
            elif current is not None:
                # The divergent block is replaced wholesale: its
                # generation's cached planes must die with it (a
                # concurrent query holding the old object re-decodes,
                # put refused).
                cache.invalidate_block(current)
            shard.blocks[bs] = rebuilt
            cache.retain_encoded(rebuilt,
                                 getattr(shard, "namespace_name", None),
                                 shard.shard_id)
            shard.flush_states.pop(bs, None)  # needs re-flush
        # Rebuilt-block retains count against the shared HBM budget;
        # reclaim OUTSIDE the shard lock (evictors take their own locks).
        cache.budget.reclaim()


@dataclasses.dataclass(frozen=True)
class RepairOptions:
    """dbRepairer scheduling knobs (repair.go repairInterval + jitter +
    check backoff). The throttle paces shard sweeps so a repair running
    concurrently with serving traffic yields the shard locks between
    shards instead of monopolizing them."""

    interval_s: float = 10.0
    jitter_frac: float = 0.5      # uniform [0, frac*interval) added per run
    throttle_s: float = 0.0       # pause between shard sweeps
    deadline_s: Optional[float] = None  # per-shard peer-streaming budget
    seed: Optional[int] = None    # deterministic jitter for tests
    # Failure backoff: consecutive failed sweeps back off on this
    # schedule (Retrier.backoff_for) instead of retrying at full cadence.
    backoff: RetryOptions = RetryOptions(
        initial_backoff_s=1.0, max_backoff_s=60.0, jitter=False)


class DatabaseRepairer:
    """repair.go:370 dbRepairer: sweeps every namespace/shard over the
    repairable window (retention minus the mutable head). `run()` does
    one sweep; `start()` runs sweeps on a jittered interval with failure
    backoff until `stop()` — per-namespace stats export as counters in
    the `repair` instrument scope either way."""

    def __init__(self, db, session, host_id: Optional[str] = None,
                 opts: RepairOptions = RepairOptions()):
        self.db = db
        self.opts = opts
        self.repairer = ShardRepairer(session, host_id,
                                      deadline_s=opts.deadline_s)
        self._rng = (random.Random(opts.seed) if opts.seed is not None
                     else random.Random())
        self._backoff = Retrier(opts.backoff)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.runs = 0
        self.failures = 0
        self.consecutive_failures = 0

    def run(self, now_ns: Optional[int] = None) -> Dict[bytes, RepairStats]:
        now = now_ns if now_ns is not None else self.db.clock()
        out: Dict[bytes, RepairStats] = {}
        for name, ns in self.db.namespaces.items():
            total = RepairStats()
            start = now - ns.opts.retention_ns
            end = now - ns.opts.block_size_ns  # sealed territory only
            for shard_id in list(ns.shards):
                if self._stop.is_set():
                    break
                total.add(self.repairer.repair_shard(ns, shard_id, start, end))
                if self.opts.throttle_s > 0:
                    # Yield between shards: a concurrent writer gets the
                    # shard locks while the sweep breathes.
                    self._stop.wait(self.opts.throttle_s)
            out[name] = total
            scope = _REPAIR_METRICS.sub_scope("ns", ns=name.decode(
                "utf-8", "replace"))
            for f in dataclasses.fields(total):
                scope.counter(f.name).inc(getattr(total, f.name))
        self.runs += 1
        return out

    # ------------------------------------------------------------- scheduling

    def next_delay_s(self) -> float:
        """Interval + seeded jitter, stretched by the failure backoff
        schedule after consecutive failed sweeps (dbRepairer's check
        interval semantics)."""
        delay = self.opts.interval_s
        if self.opts.jitter_frac > 0:
            delay += self._rng.uniform(
                0, self.opts.jitter_frac * self.opts.interval_s)
        if self.consecutive_failures:
            delay += self._backoff.backoff_for(self.consecutive_failures)
        return delay

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.run()
                self.consecutive_failures = 0
            except Exception:  # noqa: BLE001 — a failed sweep backs off
                self.failures += 1
                self.consecutive_failures += 1
                _REPAIR_METRICS.counter("sweep_failures").inc()
            self._stop.wait(self.next_delay_s())

    def start(self) -> "DatabaseRepairer":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="db-repairer",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
