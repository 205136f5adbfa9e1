"""Async batched insert queue (reference:
src/dbnode/storage/shard_insert_queue.go:52 dbShardInsertQueue and
storage/index/index_insert_queue.go nsIndexInsertQueue).

The reference's write path never inserts a new series synchronously:
writes that miss the shard's series map enqueue a pending insert (the
datapoint rides along with it), a per-shard queue coalesces everything
that arrives within one wakeup into ONE batch, and a single drain pays
the shard lock + index insert once per batch instead of once per id.
Callers either wait for the drain (sync mode — read-your-write) or
return immediately (WriteNewSeriesAsync — visible after one drain).

Here the queue is the same shape with one structural divergence
(DIVERGENCES.md): the reference dedicates a goroutine per queue, but a
namespace here owns up to 4096 virtual shards and a thread per shard is
not a sane Python footprint. Drains are therefore caller-driven by
default — a sync insert drains inline (coalescing everything other
threads enqueued meanwhile), `Shard.tick` drains before sealing, and
`stop()` drains on shutdown — while `start()` opts a queue into the
reference's dedicated-drainer behavior for shards that want async
inserts flushed on a cadence without waiting for a tick.

Bounded depth rides the overload machinery from utils.health: every
enqueue admits against an AdmissionGate sized `max_pending`, so BULK
backfill sheds at the high watermark and NORMAL past capacity with the
typed `Backpressure` the whole ingest plane already understands —
nothing is partially applied on a shed. `interval_ns` rate-limits
drains (one per interval, arrivals in between coalesce), the analog of
the reference's insertBatchBackoff.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..utils.health import AdmissionGate, Priority
from ..utils.instrument import ROOT


class InsertGroup:
    """One write call's queued new-series inserts, columnar: the ids and
    tags of every first-seen series plus their pending datapoints (the
    reference's pendingWrite riding the insert, shard.go
    insertSeriesBatch) as (counts, ts, vals) columns — points for
    ids[j] occupy the j-th counts-run of ts/vals. Columnar groups keep
    the enqueue path free of per-series array allocation and let a
    drain apply each group as ONE registry batch + ONE buffer append."""

    __slots__ = ("ids", "tags", "counts", "ts", "vals")

    def __init__(self, ids, tags, counts=None,
                 ts: Optional[np.ndarray] = None,
                 vals: Optional[np.ndarray] = None):
        self.ids = ids          # List[bytes], distinct within the group
        self.tags = tags        # aligned List[Optional[dict]] or None
        # per-id pending point counts; None means one point per id
        self.counts = counts
        self.ts = ts
        self.vals = vals

    def __len__(self) -> int:
        return len(self.ids)


class InsertBatch:
    """Wait handle for one drain generation (the reference's
    sync.WaitGroup per batch): sync writers block on it, and a drain
    error propagates to every waiter."""

    __slots__ = ("_event", "_err")

    def __init__(self):
        self._event = threading.Event()
        self._err: Optional[BaseException] = None

    def finish(self, err: Optional[BaseException] = None):
        self._err = err
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("insert batch not drained within timeout")
        if self._err is not None:
            raise self._err

    @property
    def drained(self) -> bool:
        return self._event.is_set()


class InsertQueue:
    """Per-shard batcher of new-series inserts.

    `on_drain` receives the whole coalesced batch (List[PendingInsert])
    and must apply it atomically with respect to the owner's locking —
    the Shard registers series, appends pending datapoints, and fires
    ONE batched reverse-index insert per drain."""

    def __init__(self, on_drain: Callable[[List[InsertGroup]], None], *,
                 max_pending: int = 65536, high_watermark: float = 0.75,
                 interval_ns: int = 0, name: str = "",
                 clock: Callable[[], int] = time.monotonic_ns):
        self.on_drain = on_drain
        self.interval_ns = interval_ns
        self._clock = clock
        # Bounded depth through the standard overload gate: shed raises
        # the typed Backpressure producers already back off on.
        self.gate = AdmissionGate(max_pending, high_watermark, name=name)
        self._mu = threading.Lock()
        self._wake = threading.Condition(self._mu)
        self._pending: List[InsertGroup] = []
        self._pending_n = 0  # series across pending groups (gate units)
        self._batch = InsertBatch()
        # Serializes drains: concurrent sync writers coalesce — the
        # first claims the drain, the rest find their batch finished.
        self._drain_mu = threading.Lock()
        self._last_drain_ns = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.drains = 0
        self.inserted = 0
        self._metrics = ROOT.sub_scope("storage.insert_queue")

    # ---------------------------------------------------------------- insert

    def insert(self, group: InsertGroup,
               priority: Priority = Priority.NORMAL,
               sync: bool = True) -> InsertBatch:
        """Enqueue one write call's new-series inserts. Raises
        Backpressure (nothing enqueued, nothing applied) when the
        bounded depth sheds this priority — the gate is charged per
        SERIES, not per group. sync=True waits for the containing
        batch's drain — read-your-write on return; sync=False returns
        immediately and the entries become visible after one drain
        (tick, background loop, a later sync insert, or stop)."""
        n = len(group)
        self.gate.admit(n, priority)
        with self._mu:
            self._pending.append(group)
            self._pending_n += n
            batch = self._batch
            running = self._running
            if running:
                self._wake.notify()
        if sync:
            if not running:
                self._drain()
            batch.wait()
        return batch

    # ----------------------------------------------------------------- drain

    def drain(self) -> int:
        """Force one drain of everything currently pending; returns the
        number of entries applied. Safe from any thread."""
        return self._drain()

    def _drain(self) -> int:
        if self.interval_ns:
            # Rate limit OUTSIDE the drain lock (a sleeping drainer must
            # not stall the coalescing swap below for other callers).
            rem_ns = self._last_drain_ns + self.interval_ns - self._clock()
            if rem_ns > 0:
                time.sleep(rem_ns / 1e9)
        with self._drain_mu:
            with self._mu:
                if not self._pending:
                    return 0
                groups = self._pending
                n = self._pending_n
                batch = self._batch
                self._pending = []
                self._pending_n = 0
                self._batch = InsertBatch()
            err: Optional[BaseException] = None
            try:
                self.on_drain(groups)
            except BaseException as e:  # propagate to every sync waiter
                err = e
            self.gate.release(n)
            self._last_drain_ns = self._clock()
            self.drains += 1
            self.inserted += n
            self._metrics.counter("drains").inc()
            self._metrics.counter("inserted").inc(n)
            batch.finish(err)
            return n

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "InsertQueue":
        """Opt into a dedicated background drainer (the reference's
        per-queue goroutine): async inserts then flush on signal,
        rate-limited by interval_ns."""
        with self._mu:
            if self._running:
                return self
            self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="insert-queue", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while True:
            with self._wake:
                # Timed wait: a notify racing the wait re-arms within one
                # period instead of hanging the drainer.
                while self._running and not self._pending:
                    self._wake.wait(0.05)
                if not self._running:
                    break
            self._drain()
        self._drain()  # drain whatever arrived before the stop signal

    def stop(self):
        """Shutdown: stop the drainer (if any) and drain everything
        still pending — a stopped queue never strands a write."""
        with self._wake:
            self._running = False
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._drain()

    # ----------------------------------------------------------------- stats

    def pending(self) -> int:
        """Series (not groups) currently queued."""
        with self._mu:
            return self._pending_n

    def stats(self) -> dict:
        with self._mu:
            pending = self._pending_n
        return {"pending": pending, "drains": self.drains,
                "inserted": self.inserted, "gate": self.gate.stats()}
