"""Coordinator admin API handlers: namespace / placement / database-create /
topic (reference: src/query/api/v1/handler/{namespace,placement,database,
topic} — database/create.go is the README quickstart one-call setup).

Port of m3_tpu/coordinator/admin.py."""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional

from ..cluster import kv as cluster_kv
from ..cluster.placement import Instance, PlacementService, initial_placement
from ..msg.topic import ConsumerService, Topic, TopicService
from ..utils import xtime


class AdminAPI:
    def __init__(self, store: cluster_kv.MemStore,
                 placement: Optional[PlacementService] = None,
                 topics: Optional[TopicService] = None,
                 create_namespace: Optional[Callable] = None):
        """create_namespace(name_bytes, retention_ns) registers a namespace
        on the serving database(s)."""
        self.store = store
        self.placement = placement or PlacementService(store)
        self.topics = topics or TopicService(store)
        self._create_namespace = create_namespace
        self._namespaces: Dict[str, dict] = {}

    # -------------------------------------------------------- namespaces

    def get_namespaces(self, req) -> dict:
        return {"registry": {"namespaces": self._namespaces}}

    def add_namespace(self, req) -> dict:
        body = req.json()
        name = body["name"]
        retention = body.get("retentionTime", "48h")
        opts = {
            "retentionOptions": {"retentionPeriod": retention},
            "indexOptions": {"enabled": True},
        }
        self._namespaces[name] = opts
        if self._create_namespace is not None:
            self._create_namespace(name.encode(), _duration_ns(retention))
        return {"registry": {"namespaces": self._namespaces}}

    # -------------------------------------------------------- placement

    def get_placement(self, req) -> dict:
        p = self.placement.get()
        if p is None:
            from .http_api import HTTPError

            raise HTTPError(404, "placement not found")
        return {"placement": p.to_json(), "version": p.version}

    def init_placement(self, req) -> dict:
        body = req.json()
        instances = [
            Instance(id=i["id"], endpoint=i["endpoint"],
                     isolation_group=i.get("isolationGroup", ""),
                     weight=i.get("weight", 1), zone=i.get("zone", ""))
            for i in body["instances"]
        ]
        p = self.placement.init(instances, body.get("numShards", 64),
                                body.get("replicationFactor", 1))
        return {"placement": p.to_json(), "version": p.version}

    def add_instance(self, req) -> dict:
        body = req.json()
        inst = body["instances"][0] if "instances" in body else body
        p = self.placement.add_instance(Instance(
            id=inst["id"], endpoint=inst["endpoint"],
            isolation_group=inst.get("isolationGroup", ""),
            weight=inst.get("weight", 1), zone=inst.get("zone", "")))
        return {"placement": p.to_json(), "version": p.version}

    # -------------------------------------------------------- database

    def database_create(self, req) -> dict:
        """database/create.go: one call = namespace + placement init for a
        local (single node) or cluster database (README.md:36-43)."""
        body = req.json()
        ns_name = body["namespaceName"]
        db_type = body.get("type", "local")
        retention = body.get("retentionTime", "48h")
        self._namespaces[ns_name] = {
            "retentionOptions": {"retentionPeriod": retention},
            "indexOptions": {"enabled": True},
        }
        if self._create_namespace is not None:
            self._create_namespace(ns_name.encode(), _duration_ns(retention))
        if self.placement.get() is None:
            if db_type == "local":
                instances = [Instance(id="m3db_local", endpoint="127.0.0.1:0")]
                num_shards, rf = body.get("numShards", 64), 1
            else:
                instances = [
                    Instance(id=h["id"], endpoint=h.get("endpoint", ""),
                             isolation_group=h.get("isolationGroup", ""))
                    for h in body.get("hosts", [])
                ]
                num_shards = body.get("numShards", 64)
                rf = body.get("replicationFactor", 3)
            self.placement.init(instances, num_shards, rf)
        p = self.placement.get()
        return {"namespace": {"registry": {"namespaces": self._namespaces}},
                "placement": {"placement": p.to_json(), "version": p.version}}

    # -------------------------------------------------------- topics

    def get_topic(self, req) -> dict:
        name = req.param("name", "aggregated_metrics")
        t = self.topics.get(name)
        if t is None:
            from .http_api import HTTPError

            raise HTTPError(404, f"topic {name!r} not found")
        return {"topic": t.to_json(), "version": t.version}

    def init_topic(self, req) -> dict:
        body = req.json()
        t = Topic(body.get("name", "aggregated_metrics"),
                  body.get("numberOfShards", 64),
                  tuple(ConsumerService(c["serviceId"],
                                        c.get("consumptionType", "shared"))
                        for c in body.get("consumerServices", [])))
        t = self.topics.upsert(t)
        return {"topic": t.to_json(), "version": t.version}


def _duration_ns(s: str) -> int:
    from ..query.promql import parse_duration_ns

    return parse_duration_ns(s)
