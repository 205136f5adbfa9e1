"""Lease-based leader election (reference: src/cluster/services/leader,
used by the aggregator's election manager).

Host copy of LeaderService and CampaignState from
m3_tpu/cluster/services.py; service advertisement and heartbeats wait for
the client slice."""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from . import kv as kvmod


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
