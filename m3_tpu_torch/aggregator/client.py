"""Aggregator client: shard-aware routing of unaggregated metrics to the
aggregator instances owning each metric's shard (host copy of
m3_tpu/aggregator/client.py; reference:
src/aggregator/client/client.go:191-259 WriteUntimedCounter/BatchTimer/Gauge
and the placement-watched shard routing in writer_mgr/queue.go).

Transport is pluggable: the in-process transport calls a local Aggregator
directly (how the coordinator embeds its downsampler); the network transport
sends over the framed-RPC wire (m3_tpu_torch.rpc.wire) like the reference's
raw TCP msgpack/protobuf connections. Host code with no device: routing is
the host murmur3 (`murmur3_32_cached`) over the placement."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..cluster.placement import Placement, ShardState
from ..metrics.metadata import StagedMetadata
from ..metrics.metric import MetricUnion
from ..utils.hashing import murmur3_32_cached


class AggregatorClient:
    def __init__(self, num_shards: int,
                 placement_getter: Callable[[], Placement],
                 transports: Dict[str, Callable[[MetricUnion, Sequence[StagedMetadata]], bool]]):
        """transports: instance_id -> delivery fn (add_untimed of a local
        Aggregator, or a connection's send)."""
        self.num_shards = num_shards
        self._placement = placement_getter
        self._transports = transports
        self.dropped = 0

    def shard_for(self, metric_id: bytes) -> int:
        return murmur3_32_cached(metric_id) % self.num_shards

    def _instances_for(self, shard: int) -> List[str]:
        p = self._placement()
        return [
            inst.id for inst in p.replicas_for(
                shard, states=(ShardState.INITIALIZING, ShardState.AVAILABLE))
        ]

    def write_untimed(self, mu: MetricUnion,
                      metadatas: Sequence[StagedMetadata] = ()) -> bool:
        """Deliver to every replica of the metric's shard (client.go write:
        one writer per instance owning the shard)."""
        shard = self.shard_for(mu.id)
        delivered = False
        for instance_id in self._instances_for(shard):
            send = self._transports.get(instance_id)
            if send is not None and send(mu, metadatas):
                delivered = True
        if not delivered:
            self.dropped += 1
        return delivered

    def write_untimed_counter(self, metric_id: bytes, value: int,
                              metadatas: Sequence[StagedMetadata] = ()) -> bool:
        return self.write_untimed(MetricUnion.counter(metric_id, value), metadatas)

    def write_untimed_batch_timer(self, metric_id: bytes, values: Sequence[float],
                                  metadatas: Sequence[StagedMetadata] = ()) -> bool:
        return self.write_untimed(MetricUnion.batch_timer(metric_id, values), metadatas)

    def write_untimed_gauge(self, metric_id: bytes, value: float,
                            metadatas: Sequence[StagedMetadata] = ()) -> bool:
        return self.write_untimed(MetricUnion.gauge(metric_id, value), metadatas)
