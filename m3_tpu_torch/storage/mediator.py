"""Mediator: the background lifecycle driver (port of
m3_tpu/storage/mediator.py; reference:
src/dbnode/storage/mediator.go:112 Open -> :157 ongoingTick; tick.go,
flush.go, fs.go:115 flush/snapshot run, cleanup.go).

`run_once` is the deterministic unit tests call; `start` wraps it in a
ticker thread the service binary owns. Order per tick matches the
reference: tick (seal/expire) -> flush sealed blocks -> snapshot warm
buffers -> cleanup (expired filesets, old snapshots, rotated commitlog
files).

Seals (tick) and snapshot encodes run on each shard's device: the pack
kernel on the card. A snapshot's block is written and dropped, its
encode's device tensors released at once, so snapshots pin no device
memory outside the HBM budget's sight. `start` runs
`run_once` on its own thread, which then launches kernels on the card
from that thread."""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
from typing import Dict, Optional

from ..persist.diskio import DiskWriteError
from ..persist.fs import PersistManager
from .block import encode_block
from ..utils import xtime


@dataclasses.dataclass
class MediatorOptions:
    tick_interval_ns: int = 10 * xtime.SECOND
    snapshot_enabled: bool = True


class Mediator:
    def __init__(self, db, persist: Optional[PersistManager] = None,
                 opts: MediatorOptions = MediatorOptions()):
        self.db = db
        self.persist = persist
        self.opts = opts
        self._snapshot_version = 0
        self._version_seeded = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_stats: Dict[str, int] = {}

    # ------------------------------------------------------------------ steps

    def run_once(self, now_ns: Optional[int] = None) -> Dict[str, int]:
        now = now_ns if now_ns is not None else self.db.clock()
        stats = dict(self.db.tick(now))
        if self.persist is not None:
            stats["flushed"] = self.db.flush(self.persist, now)
            if self.opts.snapshot_enabled:
                stats["snapshotted"] = self.snapshot(now)
            stats["cleaned"] = self.cleanup(now)
        self.last_stats = stats
        return stats

    def snapshot(self, now_ns: int) -> int:
        """Persist warm (still-mutable) buckets as snapshot filesets
        (storage/flush.go snapshot state; persist/fs snapshot volumes).

        The commit log position is recorded ONCE, before any buffer is
        read: every WAL entry durable at-or-before it is provably
        visible to the buffer reads below, so recovery replays only the
        WAL tail past the position — the conservative overlap window
        dedups at read/seal, never loses. Sync writes land in the
        buffer BEFORE their commit log append; ASYNC new-series writes
        (write_new_series_async) sit in the insert queue with their WAL
        append already durable, so every queue is drained between
        taking the position and reading buffers — an entry whose chunk
        is at-or-before the position was enqueued before position() ran
        and therefore lands in the buffer the snapshot reads."""
        if not self._version_seeded:
            # Resume ABOVE any version already on disk: after a restart
            # a counter reset to 1 would lose every new snapshot to the
            # pre-kill generation's higher versions at cleanup.
            self._version_seeded = True
            for ns in list(self.db.namespaces.values()):
                for shard_id in ns.shards:
                    for _bs, version, _p in self.persist.list_snapshots(
                            ns.name, shard_id):
                        self._snapshot_version = max(
                            self._snapshot_version, version)
        self._snapshot_version += 1
        version = self._snapshot_version
        wal_position = None
        commitlog = getattr(self.db, "commitlog", None)
        if commitlog is not None:
            try:
                wal_position = commitlog.position()
            except ValueError:
                wal_position = None  # closed log: snapshot without one
        if wal_position is not None:
            for ns in list(self.db.namespaces.values()):
                for shard in ns.shards.values():
                    shard.insert_queue.drain()
        count = 0
        for ns in list(self.db.namespaces.values()):
            if not ns.opts.snapshot_enabled:
                continue
            for shard in ns.shards.values():
                for bs in sorted(shard.buffer.buckets):
                    if bs in shard.blocks:
                        # The block start already has a sealed
                        # representation (a snapshot-recovered tile, or
                        # a seal racing a late drain): the BUFFER's
                        # content alone is a partial view, and a
                        # snapshot of it would record a WAL position
                        # claiming coverage of chunks whose data lives
                        # only in the block — a later restart would
                        # position-skip them and lose acked writes.
                        # These buckets stay WAL-replayable instead
                        # (the pre-existing snapshot, if any, remains
                        # the newest for this block start).
                        continue
                    dense = shard.buffer.snapshot(bs)
                    if dense is None:
                        continue
                    series, tdense, vdense, npoints = dense
                    blk = encode_block(bs, series, tdense, vdense, npoints,
                                       device=shard.device)
                    # Nobody retains a snapshot's block: drop the encode's
                    # device tensors now, not when the block dies.
                    blk.__dict__.pop("_encoded_dev", None)
                    try:
                        self.persist.write_snapshot(
                            ns.name, shard.shard_id, blk, shard.registry,
                            version, wal_position=wal_position)
                    except DiskWriteError:
                        # Typed snapshot failure: the bucket stays WAL-
                        # replayable (nothing is lost, recovery just
                        # replays more), health degrades, the sweep
                        # continues — the next tick re-attempts.
                        health = getattr(self.db, "disk_health", None)
                        if health is not None:
                            health.failure()
                        continue
                    count += 1
        return count

    def cleanup(self, now_ns: int) -> int:
        """cleanup.go: remove filesets past retention, superseded snapshots,
        and snapshots for blocks already flushed."""
        removed = 0
        for ns in list(self.db.namespaces.values()):
            cutoff = now_ns - ns.opts.retention_ns
            for shard_id in ns.shards:
                shard_dir = os.path.join(self.persist.root, ns.name.decode(),
                                         f"shard-{shard_id:05d}")
                if os.path.isdir(shard_dir):
                    for name in os.listdir(shard_dir):
                        if name.endswith(".tmp"):
                            # Mid-write crash residue (SIGKILL between
                            # the checkpoint write and os.replace):
                            # never servable, never auto-replaced.
                            shutil.rmtree(os.path.join(shard_dir, name),
                                          ignore_errors=True)
                            removed += 1
                shard_removed = 0
                for bs, path in self.persist.list_filesets(ns.name, shard_id):
                    if bs + ns.opts.block_size_ns <= cutoff:
                        shutil.rmtree(path, ignore_errors=True)
                        shard_removed += 1
                if shard_removed and getattr(self.db, "retriever", None) is not None:
                    # Cached listings/seekers/wired rows now point at deleted
                    # directories — drop them before the next cold read.
                    self.db.retriever.invalidate(ns.name, shard_id)
                removed += shard_removed
                snaps = self.persist.list_snapshots(ns.name, shard_id)
                newest: Dict[int, int] = {}
                for bs, version, _p in snaps:
                    newest[bs] = max(newest.get(bs, -1), version)
                flushed = {bs for bs, _p in self.persist.list_filesets(ns.name, shard_id)}
                for bs, version, path in snaps:
                    stale = (version < newest[bs] or bs in flushed
                             or bs + ns.opts.block_size_ns <= cutoff)
                    if stale:
                        shutil.rmtree(path, ignore_errors=True)
                        removed += 1
        removed += self._trim_commitlog()
        return removed

    def _trim_commitlog(self) -> int:
        """Delete commit log files that can no longer contribute to any
        bootstrap (cleanup.go's commit log cleanup): a non-active file
        last written more than max-retention-plus-slack of WALL time ago
        holds only entries whose data timestamps (bounded by the
        acceptance window around their write time) are past every
        namespace's retention — replay would range-filter every one.
        Without this the WAL grows without bound and every restart
        replays history that can never be served."""
        commitlog = getattr(self.db, "commitlog", None)
        if commitlog is None:
            return 0
        namespaces = list(self.db.namespaces.values())
        retention = max((ns.opts.retention_ns for ns in namespaces),
                        default=0)
        if not retention:
            return 0
        # An entry written at file-mtime M carries a data timestamp of
        # at most M + buffer_future, so the slack must cover the widest
        # configured future window (plus an hour of margin) — a fixed
        # slack would delete still-in-retention entries under a large
        # buffer_future.
        slack = max((ns.opts.buffer_future_ns for ns in namespaces),
                    default=0) + xtime.HOUR
        # Wall clock, not the db clock: file mtimes are wall time (a
        # test driving a fake clock simply never trims — safe).
        horizon = time.time_ns() - retention - slack
        active = commitlog.active_file()
        removed = 0
        for path in commitlog.files():
            if path == active:
                continue
            try:
                if os.stat(path).st_mtime_ns < horizon:
                    os.remove(path)
                    removed += 1
            except OSError:
                continue
        return removed

    # ------------------------------------------------------------- background

    def start(self, interval_s: Optional[float] = None):
        iv = interval_s if interval_s is not None else self.opts.tick_interval_ns / 1e9
        self._stop.clear()

        def loop():
            while not self._stop.wait(iv):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 — background loop survives
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
