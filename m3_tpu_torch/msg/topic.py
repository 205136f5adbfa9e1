"""Topic service: sharded pub/sub topics stored/watched in KV (reference:
src/msg/topic/{topic,service}.go — a topic has a name, a shard count, and
the set of consumer services receiving it).

Host copy of m3_tpu/msg/topic.py."""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

from ..cluster import kv as cluster_kv


class ConsumptionType:
    """topic/types.go: Shared = any instance of the service may consume a
    message (work-queue); Replicated = every replica gets every message."""

    SHARED = "shared"
    REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class ConsumerService:
    service_id: str
    consumption_type: str = ConsumptionType.SHARED

    def to_json(self):
        return {"service_id": self.service_id, "ct": self.consumption_type}

    @staticmethod
    def from_json(obj):
        return ConsumerService(obj["service_id"], obj["ct"])


@dataclasses.dataclass(frozen=True)
class Topic:
    name: str
    num_shards: int
    consumer_services: Tuple[ConsumerService, ...] = ()
    version: int = 0

    def add_consumer(self, cs: ConsumerService) -> "Topic":
        return dataclasses.replace(
            self, consumer_services=self.consumer_services + (cs,))

    def remove_consumer(self, service_id: str) -> "Topic":
        return dataclasses.replace(
            self, consumer_services=tuple(
                c for c in self.consumer_services if c.service_id != service_id))

    def to_json(self):
        return {
            "name": self.name, "num_shards": self.num_shards,
            "consumer_services": [c.to_json() for c in self.consumer_services],
        }

    @staticmethod
    def from_json(obj, version: int = 0):
        return Topic(
            obj["name"], obj["num_shards"],
            tuple(ConsumerService.from_json(c) for c in obj["consumer_services"]),
            version,
        )


class TopicService:
    """CRUD + watch over topics in the KV store (msg/topic/service.go)."""

    def __init__(self, store: cluster_kv.MemStore, prefix: str = "_topics"):
        self._store = store
        self._prefix = prefix

    def _key(self, name: str) -> str:
        return f"{self._prefix}/{name}"

    def get(self, name: str) -> Optional[Topic]:
        val = self._store.get(self._key(name))
        if val is None:
            return None
        return Topic.from_json(json.loads(val.data.decode()), val.version)

    def upsert(self, topic: Topic) -> Topic:
        version = self._store.set(
            self._key(topic.name), json.dumps(topic.to_json()).encode())
        return dataclasses.replace(topic, version=version)

    def delete(self, name: str):
        self._store.delete(self._key(name))

    def watch(self, name: str):
        return self._store.watch(self._key(name))

    def on_change(self, name: str, fn):
        self._store.on_change(
            self._key(name),
            lambda _k, v: fn(Topic.from_json(json.loads(v.data.decode()), v.version)))
