"""m3msg-style sharded pub/sub with at-least-once delivery (port of
m3_tpu/msg; reference: src/msg — topics in KV, ref-counted producer
buffer, ack-tracked message writers, TCP consumers with explicit acks).
Host code with no device."""

from .consumer import Consumer
from .producer import ConsumerServiceWriter, MessageWriter, Producer
from .topic import ConsumerService, ConsumptionType, Topic, TopicService

__all__ = [
    "Consumer", "ConsumerService", "ConsumerServiceWriter", "ConsumptionType",
    "MessageWriter", "Producer", "Topic", "TopicService",
]
