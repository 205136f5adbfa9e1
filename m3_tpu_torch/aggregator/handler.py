"""Flush output handlers (reference: src/aggregator/aggregator/handler/ —
blackhole, capture).

A handler receives fully-aggregated datapoints (id, timestamp, value,
storage policy), one at a time or as one flush round's columnar groups.

Host copy of the handler base, BlackholeHandler, CaptureHandler and
ProducerHandler of m3_tpu/aggregator/handler.py, with the ingester's
decode_aggregated(_batch): the producer handler publishes the wire
codec's payloads onto any object with publish(shard, payload) (the m3msg
producer of the reference; the port's msg/ tier is later work)."""

from __future__ import annotations

from typing import List, NamedTuple

from ..metrics.policy import StoragePolicy
from ..utils.limits import Backpressure


class AggregatedMetric(NamedTuple):
    id: bytes
    time_nanos: int
    value: float
    storage_policy: StoragePolicy


def _tolist(col):
    return col.tolist() if hasattr(col, "tolist") else list(col)


class Handler:
    def handle(self, metric: AggregatedMetric):  # pragma: no cover - iface
        raise NotImplementedError

    # Adapter so handlers can be passed directly as MetricList flush_fn.
    def __call__(self, metric_id: bytes, time_nanos: int, value: float,
                 storage_policy: StoragePolicy):
        self.handle(AggregatedMetric(metric_id, time_nanos, value, storage_policy))

    def handle_columnar(self, groups):
        """One flush round's emissions as columnar groups of
        (ids, times int64 array, values f64 array, storage_policy) —
        the columnar flush (aggregator/list.py emit_batch) hands the
        WHOLE round in one call so handlers can batch per destination
        (a producer handler overrides it: one publish per topic shard per
        round). Default: unbatched per-datapoint handle()."""
        for ids, times, values, policy in groups:
            for mid, t, v in zip(ids, _tolist(times), _tolist(values)):
                self.handle(AggregatedMetric(mid, t, v, policy))


class BlackholeHandler(Handler):
    """Drops everything (handler/blackhole.go)."""

    def handle(self, metric: AggregatedMetric):
        pass


class CaptureHandler(Handler):
    """Accumulates flushed metrics in memory — the test sink."""

    def __init__(self):
        self.metrics: List[AggregatedMetric] = []

    def handle(self, metric: AggregatedMetric):
        self.metrics.append(metric)

    def by_id(self, metric_id: bytes) -> List[AggregatedMetric]:
        return [m for m in self.metrics if m.id == metric_id]


class ProducerHandler(Handler):
    """Publishes flushed metrics onto an m3msg producer (handler/protobuf.go:38
    NewProtobufHandler), sharded by metric id the same way the data plane
    shards series. The coordinator's m3msg ingester decodes and writes to
    storage (src/cmd/services/m3coordinator/ingest/m3msg)."""

    def __init__(self, producer, num_shards: int):
        from ..rpc import wire
        from ..utils.hashing import murmur3_32_cached

        self._producer = producer
        self._num_shards = num_shards
        self._encode = wire.encode
        self._hash = murmur3_32_cached
        self.dropped_backpressure = 0
        self.publishes = 0

    def handle(self, metric: AggregatedMetric):
        payload = self._encode({
            "id": metric.id,
            "t": metric.time_nanos,
            "v": metric.value,
            "sp": str(metric.storage_policy),
        })
        try:
            self._producer.publish(
                self._hash(metric.id) % self._num_shards, payload)
            self.publishes += 1
        except Backpressure:
            # The producer buffer is past its watermark: the flush must
            # finish (a wedged flush loses EVERY window, not one metric),
            # so this datapoint is counted as dropped — the same outcome
            # drop-oldest would have forced, surfaced explicitly and
            # earlier, while the buffer still holds undropped history.
            self.dropped_backpressure += 1

    def handle_columnar(self, groups):
        """One flush round batched: rows bucket by topic shard and ship
        as ONE columnar publish per shard per round (ids + raw int64/f64
        columns + per-row policy strings) instead of one encode+publish
        per datapoint. The coordinator ingester decodes either payload
        form via decode_aggregated_batch. Publishes counted in
        `publishes` so tests/smokes can assert the one-publish-per-
        destination contract."""
        import numpy as np

        shards: dict = {}
        nsh = self._num_shards
        h = self._hash
        for ids, times, values, policy in groups:
            sp = str(policy)
            for mid, t, v in zip(ids, _tolist(times), _tolist(values)):
                shards.setdefault(h(mid) % nsh, []).append((mid, t, v, sp))
        for shard, rows in shards.items():
            payload = self._encode({
                "b": 1,
                "ids": [r[0] for r in rows],
                "ts": np.asarray([r[1] for r in rows], np.int64),
                "vs": np.asarray([r[2] for r in rows], np.float64),
                "sps": [r[3] for r in rows],
            })
            try:
                self._producer.publish(shard, payload)
                self.publishes += 1
            except Backpressure:
                # same contract as handle(): the flush must finish; the
                # whole shard batch is counted dropped
                self.dropped_backpressure += len(rows)


def decode_aggregated(payload: bytes) -> AggregatedMetric:
    """Inverse of ProducerHandler's encoding, for the coordinator ingester."""
    from ..metrics.policy import StoragePolicy
    from ..rpc import wire

    obj = wire.decode(payload)
    return AggregatedMetric(
        obj["id"], obj["t"], obj["v"], StoragePolicy.parse(obj["sp"]))


def decode_aggregated_batch(payload: bytes) -> List[AggregatedMetric]:
    """Decode either ProducerHandler payload form — one single-metric
    dict (handle) or one columnar shard batch (handle_columnar) — into
    a list of AggregatedMetric."""
    from ..metrics.policy import StoragePolicy
    from ..rpc import wire

    obj = wire.decode(payload)
    if not obj.get("b"):
        return [AggregatedMetric(
            obj["id"], obj["t"], obj["v"], StoragePolicy.parse(obj["sp"]))]
    pols: dict = {}
    out = []
    for mid, t, v, sp in zip(obj["ids"], _tolist(obj["ts"]),
                             _tolist(obj["vs"]), obj["sps"]):
        pol = pols.get(sp)
        if pol is None:
            pol = pols[sp] = StoragePolicy.parse(sp)
        out.append(AggregatedMetric(mid, t, v, pol))
    return out
