"""Streaming windowed aggregation tier (reference: src/aggregator; port of
m3_tpu/aggregator).

The host keeps the reference's control shape (shard-aware routing, per-ID
entries, leader/follower flush with KV-persisted flush times); a flush
batches every closed window of every shard into one columnar reduce:
host-exact f64 moments and one device call for the timer quantile
ordering (list.py emit_batch over parallel/agg_flush.py)."""

from .aggregator import Aggregator, AggregatorShard, ForwardedWriter
from .client import AggregatorClient
from .election import ElectionManager, ElectionState
from .elem import Elem, ElemKey
from .entry import Entry, MetricMap, RateLimiter
from .flush import FlushManager, FlushTimesManager
from .handler import (AggregatedMetric, BlackholeHandler, BroadcastHandler,
                      CallbackHandler, CaptureHandler, FileHandler, Handler,
                      LoggingHandler, ProducerHandler, decode_aggregated,
                      decode_aggregated_batch)
from .list import (FlushBatch, MetricList, MetricLists, batched_reduce,
                   emit_batch, reduce_and_emit, reduce_and_emit_ref)

__all__ = [
    "AggregatedMetric", "Aggregator", "AggregatorClient", "AggregatorShard",
    "BlackholeHandler", "BroadcastHandler", "CallbackHandler",
    "CaptureHandler", "Elem", "ElemKey", "ElectionManager", "ElectionState",
    "Entry", "FileHandler", "FlushBatch", "FlushManager",
    "FlushTimesManager", "ForwardedWriter", "Handler", "LoggingHandler",
    "MetricList", "MetricLists", "MetricMap", "ProducerHandler",
    "RateLimiter", "batched_reduce", "decode_aggregated",
    "decode_aggregated_batch", "emit_batch", "reduce_and_emit",
    "reduce_and_emit_ref",
]
