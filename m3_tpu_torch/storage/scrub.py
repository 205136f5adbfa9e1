"""Background fileset scrubbing, quarantine-only (port of
m3_tpu/storage/scrub.py): walk cold on-disk filesets verifying row
checksums (+ bloom agreement) at a bounded read rate and quarantine
anything rotten (reference: the reference platform pairs its repairer
with fileset digest verification at open; scrubbing closes the gap for
bit-rot that lands AFTER a fileset was written and verified — media
decay the serve path only notices when a query happens to touch the bad
row).

`DatabaseScrubber` rides the `DatabaseRepairer` scheduling shape
(seeded jitter, failure backoff, start/stop loop). Each sweep, per
(namespace, shard):

  1. Previously-quarantined blocks are re-attempted: a resident sealed
     block is authoritative (serve-time verification drops corrupt
     in-memory copies), so when one exists its flush state is cleared —
     the next flush sweep rewrites the fileset — and the quarantined
     copy is removed (un-quarantine).
  2. Cold filesets (outside the mutable head, inside retention) are
     opened and `verify_rows()`-checked — digest chain, per-row adlers,
     bloom agreement (rebuilt through the hash kernel on the database's
     device) — throttled to `max_bytes_per_s`. Corruption quarantines
     the fileset (JSON sidecar naming the failing rows), invalidates the
     retriever's cached handles, and goes straight to step 1.

Repair from replica peers needs the client session, which the port does
not have yet: a scrubber given a `repairer` raises RepairUnsupported.
Counters export under `storage.scrub`; corruption events also land in
the shared `storage.corruption` scope (persist/fs quarantine counters).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Dict, Optional

from ..persist import fs as pfs
from ..persist.diskio import CorruptionError
from ..utils.instrument import ROOT
from ..utils.retry import RetryOptions, Retrier

_SCRUB_METRICS = ROOT.sub_scope("storage.scrub")


class RepairUnsupported(NotImplementedError):
    """Repair from replica peers needs the client session and the
    cluster placement, which the port does not have yet."""


@dataclasses.dataclass
class ScrubStats:
    filesets_scanned: int = 0
    bytes_verified: int = 0
    corrupt_found: int = 0
    quarantined: int = 0
    repair_attempts: int = 0
    blocks_repaired: int = 0
    unquarantined: int = 0

    def add(self, other: "ScrubStats"):
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass(frozen=True)
class ScrubOptions:
    """DatabaseRepairer-shaped scheduling plus the read-rate bound."""

    interval_s: float = 30.0
    jitter_frac: float = 0.5        # uniform [0, frac*interval) per run
    max_bytes_per_s: float = 64e6   # verification read-rate ceiling
    seed: Optional[int] = None      # deterministic jitter for tests
    backoff: RetryOptions = RetryOptions(
        initial_backoff_s=1.0, max_backoff_s=60.0, jitter=False)


class DatabaseScrubber:
    """Cold-data integrity sweeps. `run()` does one
    sweep; `start()` runs sweeps on a jittered interval with failure
    backoff until `stop()` — per-namespace stats export as counters in
    the `storage.scrub` scope either way. `repairer` must be None
    (quarantine-only: corruption is detected and isolated, and the
    resident sealed block is the only repair source); a ShardRepairer
    raises RepairUnsupported."""

    def __init__(self, db, persist, repairer=None,
                 opts: ScrubOptions = ScrubOptions()):
        if repairer is not None:
            raise RepairUnsupported(
                "the scrubber's repair from peers needs client.Session, "
                "which m3_tpu_torch does not have yet (ROADMAP A13.2); "
                "pass repairer=None for the quarantine-only scrubber")
        self.db = db
        self.persist = persist
        self.opts = opts
        self._rng = (random.Random(opts.seed) if opts.seed is not None
                     else random.Random())
        self._backoff = Retrier(opts.backoff)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.runs = 0
        self.failures = 0
        self.consecutive_failures = 0

    def run(self, now_ns: Optional[int] = None) -> Dict[bytes, ScrubStats]:
        now = now_ns if now_ns is not None else self.db.clock()
        out: Dict[bytes, ScrubStats] = {}
        for name, ns in self.db.namespaces.items():
            total = ScrubStats()
            bsz = ns.opts.block_size_ns
            cutoff = now - ns.opts.retention_ns
            # Cold territory: fully sealed AND outside the head block a
            # flush may still be racing to write.
            cold_end = now - 2 * bsz
            for shard_id in list(ns.shards):
                if self._stop.is_set():
                    break
                total.add(self._scrub_shard(ns, shard_id, cutoff, cold_end,
                                            bsz))
            out[name] = total
            scope = _SCRUB_METRICS.sub_scope("ns", ns=name.decode(
                "utf-8", "replace"))
            for f in dataclasses.fields(total):
                scope.counter(f.name).inc(getattr(total, f.name))
        self.runs += 1
        return out

    # ------------------------------------------------------------ one shard

    def _scrub_shard(self, ns, shard_id: int, cutoff: int, cold_end: int,
                     bsz: int) -> ScrubStats:
        st = ScrubStats()
        # 1. Quarantined blocks first: every sweep is a repair retry, so
        # a peer that was down when corruption was found doesn't leave
        # the block isolated forever.
        for bs, _path in self.persist.list_quarantined(ns.name, shard_id):
            if self._stop.is_set():
                return st
            if bs + bsz <= cutoff:
                # Past retention: nothing left to repair toward.
                self.persist.clear_quarantined(ns.name, shard_id, bs)
                st.unquarantined += 1
                continue
            if self._repair(ns, shard_id, bs, bsz, st):
                self.persist.clear_quarantined(ns.name, shard_id, bs)
                st.unquarantined += 1
        # 2. Cold fileset verification at a bounded read rate.
        try:
            listed = self.persist.list_filesets(ns.name, shard_id)
        except OSError:
            return st
        for bs, path in listed:
            if self._stop.is_set():
                return st
            if bs + bsz <= cutoff or bs > cold_end:
                continue
            st.filesets_scanned += 1
            nbytes = 0
            try:
                nbytes = os.path.getsize(os.path.join(path, pfs.DATA_FILE))
            except OSError:
                pass
            err: Optional[Exception] = None
            try:
                pfs.FilesetReader(path, device=self.db.device).verify_rows()
            except FileNotFoundError:
                continue  # cleanup raced the listing
            except (CorruptionError, ValueError, KeyError, OSError) as e:
                err = e
            st.bytes_verified += nbytes
            if err is not None:
                st.corrupt_found += 1
                _SCRUB_METRICS.counter("corrupt_found").inc()
                if pfs.quarantine_fileset(
                        path, reason=f"scrub: {type(err).__name__}: {err}",
                        rows=getattr(err, "rows", ()),
                        ids=getattr(err, "ids", ())) is not None:
                    st.quarantined += 1
                retriever = getattr(self.db, "retriever", None)
                if retriever is not None:
                    # Cached seekers/wired rows may hold the rotten bytes.
                    retriever.invalidate(ns.name, shard_id)
                if self._repair(ns, shard_id, bs, bsz, st):
                    self.persist.clear_quarantined(ns.name, shard_id, bs)
                    st.unquarantined += 1
            if self.opts.max_bytes_per_s > 0 and nbytes:
                # Rate bound: breathe AFTER each fileset for as long as
                # its bytes took out of the per-second budget.
                self._stop.wait(nbytes / self.opts.max_bytes_per_s)
        return st

    def _repair(self, ns, shard_id: int, bs: int, bsz: int,
                st: ScrubStats) -> bool:
        """True when a verified-good copy of the block is resident again:
        the already-resident sealed block (authoritative: serve-time
        verification evicts corrupt in-memory copies) re-scheduled for
        flush. Its flush state is cleared, so the next flush sweep
        rewrites the fileset and the caller may un-quarantine."""
        shard = ns.shards.get(shard_id)
        if shard is None:
            return False
        blk = shard.blocks.get(bs)
        if blk is not None:
            try:
                blk._verify_rows()  # cheap when already verified
            except CorruptionError:
                shard._drop_corrupt_block(bs, blk)
                return False
            # Re-schedule, don't pop: flushable() only considers block
            # starts PRESENT in flush_states, so removal would strand
            # the rewrite forever.
            shard.mark_flushed(bs, ok=False)
            return True
        return False

    # ------------------------------------------------------------ scheduling

    def next_delay_s(self) -> float:
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
                _SCRUB_METRICS.counter("sweep_failures").inc()
            self._stop.wait(self.next_delay_s())

    def start(self) -> "DatabaseScrubber":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="db-scrubber",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
