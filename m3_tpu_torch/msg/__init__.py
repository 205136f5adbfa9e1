"""m3msg-style sharded pub/sub (port of m3_tpu/msg; reference: src/msg —
topics in KV). The topic service only: the producer and the consumer are
later work."""

from .topic import ConsumerService, ConsumptionType, Topic, TopicService

__all__ = ["ConsumerService", "ConsumptionType", "Topic", "TopicService"]
