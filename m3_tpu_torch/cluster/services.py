"""Service discovery, heartbeats, leader election (host copy of
m3_tpu/cluster/services.py; reference: src/cluster/services —
advertise+watch instances, etcd-TTL heartbeats (services/heartbeat),
campaign-based leader election (services/leader) used by the
aggregator's election manager)."""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, List, Optional

from . import kv as kvmod


@dataclasses.dataclass(frozen=True)
class ServiceInstance:
    instance_id: str
    endpoint: str
    zone: str = ""


class HeartbeatService:
    """TTL-stamped liveness entries (services/heartbeat): an instance is
    alive while its last beat is younger than the TTL."""

    def __init__(self, store, ttl_ns: int = 10_000_000_000, clock: Optional[Callable[[], int]] = None):
        self.store = store
        self.ttl_ns = ttl_ns
        self.clock = clock or time.time_ns

    def _key(self, service: str, instance_id: str) -> str:
        return f"_hb/{service}/{instance_id}"

    def beat(self, service: str, instance_id: str):
        kvmod.set_json(self.store, self._key(service, instance_id), {"at": self.clock()})

    def alive(self, service: str, instance_id: str) -> bool:
        obj, _ = kvmod.get_json(self.store, self._key(service, instance_id))
        return obj is not None and self.clock() - obj["at"] < self.ttl_ns

    def alive_instances(self, service: str) -> List[str]:
        prefix = f"_hb/{service}/"
        out = []
        for key in self.store.keys(prefix):
            obj, _ = kvmod.get_json(self.store, key)
            if obj is not None and self.clock() - obj["at"] < self.ttl_ns:
                out.append(key[len(prefix):])
        return out


class Services:
    """Advertise/watch service instances (services.Services)."""

    def __init__(self, store, heartbeat: Optional[HeartbeatService] = None):
        self.store = store
        self.heartbeat = heartbeat or HeartbeatService(store)

    def _key(self, service: str) -> str:
        return f"_svc/{service}"

    def advertise(self, service: str, instance: ServiceInstance):
        obj, version = kvmod.get_json(self.store, self._key(service))
        obj = obj or {}
        obj[instance.instance_id] = {"endpoint": instance.endpoint, "zone": instance.zone}
        self.store.check_and_set(self._key(service), version, json.dumps(obj).encode())
        self.heartbeat.beat(service, instance.instance_id)

    def unadvertise(self, service: str, instance_id: str):
        obj, version = kvmod.get_json(self.store, self._key(service))
        if obj and instance_id in obj:
            del obj[instance_id]
            self.store.check_and_set(self._key(service), version, json.dumps(obj).encode())

    def instances(self, service: str) -> List[ServiceInstance]:
        obj, _ = kvmod.get_json(self.store, self._key(service))
        if not obj:
            return []
        return [ServiceInstance(iid, d["endpoint"], d.get("zone", "")) for iid, d in sorted(obj.items())]

    def watch(self, service: str):
        return self.store.watch(self._key(service))


class CampaignState:
    """services/leader/campaign states."""

    LEADER = "leader"
    FOLLOWER = "follower"
    PENDING_FOLLOWER = "pending_follower"


class LeaderService:
    """Lease-based leader election (services/leader): campaign() takes the
    lease if free or expired; leaders renew; resign() releases. Equivalent
    of the etcd election with TTL sessions."""

    def __init__(self, store, election_id: str, instance_id: str,
                 lease_ttl_ns: int = 10_000_000_000, clock: Optional[Callable[[], int]] = None):
        self.store = store
        self.key = f"_leader/{election_id}"
        self.instance_id = instance_id
        self.lease_ttl_ns = lease_ttl_ns
        self.clock = clock or time.time_ns

    def _current(self):
        obj, version = kvmod.get_json(self.store, self.key)
        return obj, version

    def campaign(self) -> str:
        """Try to become leader; returns resulting CampaignState."""
        now = self.clock()
        obj, version = self._current()
        if obj is None or now - obj["at"] >= self.lease_ttl_ns or obj["leader"] == self.instance_id:
            try:
                self.store.check_and_set(
                    self.key, version,
                    json.dumps({"leader": self.instance_id, "at": now}).encode(),
                )
                return CampaignState.LEADER
            except ValueError:
                return CampaignState.FOLLOWER
        return CampaignState.FOLLOWER

    def renew(self) -> bool:
        obj, version = self._current()
        if obj is None or obj["leader"] != self.instance_id:
            return False
        self.store.check_and_set(
            self.key, version, json.dumps({"leader": self.instance_id, "at": self.clock()}).encode()
        )
        return True

    def leader(self) -> Optional[str]:
        obj, _ = self._current()
        if obj is None or self.clock() - obj["at"] >= self.lease_ttl_ns:
            return None
        return obj["leader"]

    def is_leader(self) -> bool:
        return self.leader() == self.instance_id

    def resign(self):
        obj, version = self._current()
        if obj is not None and obj["leader"] == self.instance_id:
            self.store.check_and_set(
                self.key, version, json.dumps({"leader": obj["leader"], "at": 0}).encode()
            )
