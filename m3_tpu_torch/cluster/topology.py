"""Topology: host <-> shard maps + consistency levels (host copy of
m3_tpu/cluster/topology.py; reference:
src/dbnode/topology — static & dynamic placement-watched maps
(dynamic.go:75-109), consistency levels consistency_level.go, majority
calc Map.MajorityReplicas)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

from .placement import Placement, PlacementService, ShardState


class ConsistencyLevel(enum.Enum):
    """Write consistency (topology/consistency_level.go)."""

    ONE = "one"
    MAJORITY = "majority"
    ALL = "all"


class ReadConsistencyLevel(enum.Enum):
    ONE = "one"
    UNSTRICT_MAJORITY = "unstrict_majority"
    MAJORITY = "majority"
    ALL = "all"


def majority(replicas: int) -> int:
    return replicas // 2 + 1


def required_acks(level: ConsistencyLevel, replicas: int) -> int:
    if level == ConsistencyLevel.ONE:
        return 1
    if level == ConsistencyLevel.MAJORITY:
        return majority(replicas)
    return replicas


def required_reads(level: ReadConsistencyLevel, replicas: int) -> int:
    if level == ReadConsistencyLevel.ONE:
        return 1
    if level in (ReadConsistencyLevel.MAJORITY, ReadConsistencyLevel.UNSTRICT_MAJORITY):
        return majority(replicas)
    return replicas


@dataclasses.dataclass(frozen=True)
class Host:
    id: str
    endpoint: str


class TopologyMap:
    """Immutable shard -> hosts view of one placement version
    (topology.Map)."""

    def __init__(self, placement: Placement):
        self.placement = placement
        self.replica_factor = placement.replica_factor
        self.num_shards = placement.num_shards
        self.hosts = {
            iid: Host(iid, inst.endpoint) for iid, inst in placement.instances.items()
        }
        # WRITE targets include INITIALIZING owners (they must receive new
        # points while bootstrapping); READABLE owners are only those whose
        # shard holds data — AVAILABLE and LEAVING. An INITIALIZING owner
        # has not bootstrapped yet, and a consistency-ONE read accepting
        # its empty response would silently lose every point the real
        # replicas hold (reference: src/dbnode/topology shard-state
        # semantics — session reads check IsAvailable/Leaving).
        self._shard_hosts: Dict[int, List[Host]] = {}
        self._shard_hosts_readable: Dict[int, List[Host]] = {}
        for iid, inst in placement.instances.items():
            for a in inst.shards.values():
                if a.state in (ShardState.AVAILABLE, ShardState.INITIALIZING,
                               ShardState.LEAVING):
                    self._shard_hosts.setdefault(a.shard, []).append(
                        self.hosts[iid])
                if a.state in (ShardState.AVAILABLE, ShardState.LEAVING):
                    self._shard_hosts_readable.setdefault(a.shard, []).append(
                        self.hosts[iid])
        for m in (self._shard_hosts, self._shard_hosts_readable):
            for hosts in m.values():
                hosts.sort(key=lambda h: h.id)

    def route_shard(self, shard: int) -> List[Host]:
        """All owners that accept WRITES (incl. initializing)."""
        return self._shard_hosts.get(shard, [])

    def route_shard_readable(self, shard: int) -> List[Host]:
        """Owners that can serve READS (available/leaving). Falls back to
        the full owner set when nothing is readable yet (a cluster mid
        initial claim) — a degraded read beats no read, matching the
        unstrict consistency spirit."""
        return (self._shard_hosts_readable.get(shard)
                or self._shard_hosts.get(shard, []))

    def majority_replicas(self) -> int:
        return majority(self.replica_factor)

    def shards_for_host(self, host_id: str) -> List[int]:
        inst = self.placement.instances.get(host_id)
        return inst.shard_ids() if inst else []


class StaticTopology:
    def __init__(self, placement: Placement):
        self._map = TopologyMap(placement)

    def get(self) -> TopologyMap:
        return self._map


class DynamicTopology:
    """Placement-watched topology (topology/dynamic.go): rebuilds the map on
    placement change and notifies subscribers (storage/cluster/database.go
    reacts by assigning/retiring shards)."""

    def __init__(self, placement_service: PlacementService):
        self.svc = placement_service
        self._subs: List[Callable[[TopologyMap], None]] = []
        self._map: Optional[TopologyMap] = None
        self.svc.store.on_change(self.svc.key, lambda key, value: self._rebuild())
        self._rebuild()

    def _rebuild(self):
        p = self.svc.get()
        if p is None:
            return
        self._map = TopologyMap(p)
        for fn in self._subs:
            fn(self._map)

    def get(self) -> Optional[TopologyMap]:
        return self._map

    def subscribe(self, fn: Callable[[TopologyMap], None]):
        self._subs.append(fn)
        if self._map is not None:
            fn(self._map)
