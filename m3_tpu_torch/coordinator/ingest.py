"""Coordinator ingest: dual-path downsample-and/or-write (reference:
src/cmd/services/m3coordinator/ingest/write.go:78-337
DownsamplerAndWriter — every incoming sample goes to the downsampler
(rule-matched aggregation) and/or directly to unaggregated storage) and
the m3msg ingester (ingest/m3msg/ingest.go) consuming aggregated metrics
published by a standalone aggregator tier.

Port of m3_tpu/coordinator/ingest.py, with one method of its own:
write_request, the remote-write body's batch path."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..aggregator.handler import decode_aggregated_batch
from ..metrics.metric import MetricType
from ..utils.health import AdmissionGate, Priority
from ..utils.instrument import ROOT
from .downsample import Downsampler

_scope = ROOT.sub_scope("coordinator.ingest")


class DownsamplerAndWriter:
    """Dual-path writer behind a bounded admission gate: in-flight write
    work past the high watermark sheds bulk backfill first, past capacity
    sheds normal producer traffic too (typed Backpressure — HTTP callers
    get a retryable error, msg-path callers skip the ack so the producer
    redelivers on its exponential backoff schedule), while the aggregated
    pipeline's own output (M3MsgIngester) is never shed."""

    def __init__(self, storage, downsampler: Optional[Downsampler] = None,
                 gate: Optional[AdmissionGate] = None):
        """storage: query-storage-like .write(series_id, tags, t, v)."""
        self._storage = storage
        self._downsampler = downsampler
        # Generous-but-finite default: ingest overload protection is on by
        # default; services size it from config where it matters.
        self.gate = gate if gate is not None else AdmissionGate(
            capacity=4096, name="coordinator.ingest")
        self.written = 0
        self.downsampled = 0

    def write(self, tags: Dict[bytes, bytes], t_nanos: int, value: float,
              metric_type: MetricType = MetricType.GAUGE,
              downsample: bool = True, write_unaggregated: bool = True,
              priority: Priority = Priority.NORMAL):
        """write.go WriteBatch dual path. Raises Backpressure when the
        admission gate sheds this priority class."""
        with self.gate.held(priority=priority):
            self._write_admitted(tags, t_nanos, value, metric_type,
                                 downsample, write_unaggregated)

    def _write_admitted(self, tags, t_nanos, value, metric_type,
                        downsample, write_unaggregated):
        if downsample and self._downsampler is not None:
            if self._downsampler.write(tags, t_nanos, value, metric_type):
                self.downsampled += 1
                _scope.counter("downsampled").inc()
        if write_unaggregated:
            sid = _series_id(tags)
            self._storage.write(sid, tags, t_nanos, value)
            self.written += 1
            _scope.counter("written").inc()

    def write_batch(self, samples: Sequence[tuple],
                    priority: Priority = Priority.NORMAL, **kw):
        """All-or-nothing admission: the whole batch is admitted ONCE up
        front. Per-sample admission would let a mid-batch shed leave a
        partially-written prefix that the 429-retrying producer then
        re-writes, double-counting it — the same partial-prefix hazard
        m3lint's batch-partial-ingest rule polices at the codec layer.

        Downsampling takes the compiled streaming path: ONE
        Downsampler.write_batch call matches the whole batch against the
        rule set (batch matcher + grouped columnar aggregator adds)
        instead of a per-sample match+append loop; the unaggregated leg
        rides the storage's columnar write_batch when it has one."""
        samples = list(samples)
        if not samples:
            return
        metric_type = kw.get("metric_type", MetricType.GAUGE)
        downsample = kw.get("downsample", True)
        write_unaggregated = kw.get("write_unaggregated", True)
        with self.gate.held(len(samples), priority=priority):
            self._write_batch_admitted(samples, metric_type, downsample,
                                       write_unaggregated)

    def write_request(self, samples: Sequence[tuple],
                      priority: Priority = Priority.NORMAL) -> int:
        """One write request (a remote-write body) stored as write()'s
        per-sample loop stores it, at batch speed. Port-only: the
        reference's HTTP handler calls write() once per sample.

        The request holds ONE unit of the gate while it runs: concurrent
        bodies and carbon lines share the gate as the reference's
        per-sample admissions do, where write_batch's one unit per
        sample would let a large body shed every other writer. Below the
        gate each run of samples the storage accepts goes as one
        write_batch (the batch match, one shard-routed append), and the
        first sample it refuses goes through write()'s body, which
        downsamples it and raises the storage's own error. So after an
        error the stored and aggregated rows are the same prefix the
        per-sample loop leaves. A storage without a columnar write and
        an acceptance mask takes the per-sample loop itself. Returns the
        samples written."""
        samples = list(samples)
        accepts = getattr(self._storage, "accepts", None)
        batched = accepts is not None and \
            getattr(self._storage, "write_batch", None) is not None
        with self.gate.held(priority=priority):
            if not batched:
                for tags, t_nanos, value in samples:
                    self._write_admitted(tags, t_nanos, value,
                                         MetricType.GAUGE, True, True)
                return len(samples)
            rest = samples
            while rest:
                ok = accepts([t for _tags, t, _v in rest])
                k = len(rest) if ok.all() else int(np.argmin(ok))
                if k:
                    self._write_batch_admitted(rest[:k], MetricType.GAUGE,
                                               True, True)
                if k < len(rest):
                    tags, t_nanos, value = rest[k]
                    self._write_admitted(tags, t_nanos, value,
                                         MetricType.GAUGE, True, True)
                    k += 1
                rest = rest[k:]
        return len(samples)

    def _write_batch_admitted(self, samples, metric_type, downsample,
                              write_unaggregated):
        if downsample and self._downsampler is not None:
            matched, dropped = self._downsampler.write_batch(
                [(tags, t, v, metric_type) for tags, t, v in samples])
            # write() counts a sample as downsampled when the
            # downsampler accepted it — DROP_MUST drops included.
            accepted = matched + dropped
            self.downsampled += accepted
            if accepted:
                _scope.counter("downsampled").inc(accepted)
        if write_unaggregated:
            self._storage_write_batch(samples)

    def _storage_write_batch(self, samples: Sequence[tuple]):
        # One id encoding per tags object, as in Downsampler.write_batch.
        memo: Dict[int, bytes] = {}
        sids = []
        for tags, _t, _v in samples:
            sid = memo.get(id(tags))
            if sid is None:
                sid = memo[id(tags)] = _series_id(tags)
            sids.append(sid)
        batch_write = getattr(self._storage, "write_batch", None)
        if batch_write is not None:
            batch_write(sids, [s[0] for s in samples],
                        [s[1] for s in samples], [s[2] for s in samples])
        else:
            write = self._storage.write
            for sid, (tags, t_nanos, value) in zip(sids, samples):
                write(sid, tags, t_nanos, value)
        self.written += len(samples)
        _scope.counter("written").inc(len(samples))


class M3MsgIngester:
    """Handler for the m3msg consumer: decodes aggregated metrics published
    by the aggregator tier's ProducerHandler and writes them to storage,
    choosing the namespace for the sample's storage policy
    (ingest/m3msg/ingest.go -> storage write)."""

    def __init__(self, storage_for_policy: Callable,
                 gate: Optional[AdmissionGate] = None):
        """storage_for_policy(storage_policy) -> storage with .write(...)."""
        self._storage_for = storage_for_policy
        self.gate = gate
        self.ingested = 0

    def __call__(self, shard: int, payload: bytes):
        from ..metrics import id as metric_id

        # CRITICAL priority: this is the aggregation pipeline's own
        # output, already accepted and acked upstream — shedding it here
        # would silently lose aggregated data the platform promised to
        # keep. It is counted against the gate (the depth is honest) but
        # never refused; raw producer traffic sheds first, upstream.
        metrics = decode_aggregated_batch(payload)
        gate = self.gate
        if gate is not None:
            gate.admit(len(metrics), priority=Priority.CRITICAL)
        try:
            for m in metrics:
                storage = self._storage_for(m.storage_policy)
                if storage is None:
                    continue
                name, tags = metric_id.decode(m.id)
                if name:
                    tags = {b"__name__": name, **tags}
                storage.write(m.id, tags, m.time_nanos, m.value)
                self.ingested += 1
        finally:
            if gate is not None:
                gate.release(len(metrics))


def _series_id(tags: Dict[bytes, bytes]) -> bytes:
    from ..metrics import id as metric_id

    name = tags.get(b"__name__", b"")
    return metric_id.encode(name, {k: v for k, v in tags.items()
                                   if k != b"__name__"})
