"""Placement: instance <-> shard assignment (host copy of
m3_tpu/cluster/placement.py; reference:
src/cluster/placement — sharded algorithm placement/algo/sharded.go,
shard states cluster/shard with Initializing/Available/Leaving and
cutover/cutoff times, storage in KV as versioned snapshots).

The balanced sharded algorithm assigns every virtual shard to
replica-factor distinct instances, balancing counts; add/remove/replace
move the minimum number of shards, marking moves Initializing on the
receiver and Leaving on the donor so data can migrate before cutover."""

from __future__ import annotations

import dataclasses
import enum
import heapq
import json
from typing import Dict, List, Optional, Sequence, Tuple

from . import kv as kvmod


class ShardState(enum.Enum):
    INITIALIZING = "initializing"
    AVAILABLE = "available"
    LEAVING = "leaving"


@dataclasses.dataclass
class ShardAssignment:
    shard: int
    state: ShardState = ShardState.INITIALIZING
    source_id: Optional[str] = None  # donor instance for Initializing shards


@dataclasses.dataclass
class Instance:
    id: str
    endpoint: str
    isolation_group: str = ""
    weight: int = 1
    zone: str = ""
    shard_set_id: str = ""  # mirrored placements: instances grouped in sets
    shards: Dict[int, ShardAssignment] = dataclasses.field(default_factory=dict)

    def shard_ids(self, states=(ShardState.INITIALIZING, ShardState.AVAILABLE)) -> List[int]:
        return sorted(s.shard for s in self.shards.values() if s.state in states)


@dataclasses.dataclass
class Placement:
    instances: Dict[str, Instance]
    num_shards: int
    replica_factor: int
    version: int = 0
    is_mirrored: bool = False

    def replicas_for(self, shard: int,
                     states=(ShardState.INITIALIZING, ShardState.AVAILABLE)) -> List[Instance]:
        return [
            inst for inst in self.instances.values()
            if shard in inst.shards and inst.shards[shard].state in states
        ]

    def validate(self):
        for s in range(self.num_shards):
            owners = self.replicas_for(s)
            if len(owners) != self.replica_factor:
                raise ValueError(
                    f"shard {s} has {len(owners)} replicas, want {self.replica_factor}"
                )

    def shard_sets(self) -> Dict[str, List[Instance]]:
        """Mirrored grouping: shard_set_id -> member instances (sorted)."""
        groups: Dict[str, List[Instance]] = {}
        for inst in self.instances.values():
            groups.setdefault(inst.shard_set_id, []).append(inst)
        for members in groups.values():
            members.sort(key=lambda i: i.id)
        return groups

    def validate_mirrored(self):
        """Every shard set has exactly RF members all holding identical
        shard assignments, and every shard lives in exactly one set
        (algo/mirrored.go Validate semantics)."""
        self.validate()
        owner: Dict[int, str] = {}
        for ssid, members in self.shard_sets().items():
            if len(members) != self.replica_factor:
                raise ValueError(
                    f"shard set {ssid!r} has {len(members)} members, "
                    f"want RF={self.replica_factor}")
            ref = {s: a.state for s, a in members[0].shards.items()}
            for m in members[1:]:
                if {s: a.state for s, a in m.shards.items()} != ref:
                    raise ValueError(
                        f"shard set {ssid!r} members diverge: {m.id}")
            for s in ref:
                if s in owner:
                    raise ValueError(
                        f"shard {s} in sets {owner[s]!r} and {ssid!r}")
                owner[s] = ssid

    def to_json(self) -> dict:
        return {
            "num_shards": self.num_shards,
            "replica_factor": self.replica_factor,
            "is_mirrored": self.is_mirrored,
            "instances": {
                iid: {
                    "endpoint": inst.endpoint,
                    "isolation_group": inst.isolation_group,
                    "weight": inst.weight,
                    "zone": inst.zone,
                    "shard_set_id": inst.shard_set_id,
                    "shards": [
                        {"shard": a.shard, "state": a.state.value, "source_id": a.source_id}
                        for a in inst.shards.values()
                    ],
                }
                for iid, inst in self.instances.items()
            },
        }

    @staticmethod
    def from_json(obj: dict, version: int = 0) -> "Placement":
        instances = {}
        for iid, d in obj["instances"].items():
            inst = Instance(iid, d["endpoint"], d.get("isolation_group", ""),
                            d.get("weight", 1), d.get("zone", ""),
                            d.get("shard_set_id", ""))
            for a in d["shards"]:
                inst.shards[a["shard"]] = ShardAssignment(
                    a["shard"], ShardState(a["state"]), a.get("source_id")
                )
            instances[iid] = inst
        return Placement(instances, obj["num_shards"], obj["replica_factor"],
                         version, obj.get("is_mirrored", False))


def _rebalance_targets(counts: Dict[str, int], num_shards: int, rf: int) -> Dict[str, int]:
    total = num_shards * rf
    n = len(counts)
    base, extra = divmod(total, n)
    targets = {}
    for i, iid in enumerate(sorted(counts)):
        targets[iid] = base + (1 if i < extra else 0)
    return targets


def initial_placement(instances: Sequence[Instance], num_shards: int,
                      replica_factor: int) -> Placement:
    """algo/sharded.go InitialPlacement: round-robin replicas across
    instances, never two replicas of one shard on one instance."""
    if len(instances) < replica_factor:
        raise ValueError("fewer instances than replica factor")
    insts = {i.id: dataclasses.replace(i, shards={}) for i in instances}
    heap = [(0, iid) for iid in sorted(insts)]
    heapq.heapify(heap)
    for shard in range(num_shards):
        picked = []
        skipped = []
        while len(picked) < replica_factor:
            cnt, iid = heapq.heappop(heap)
            picked.append((cnt, iid))
        for cnt, iid in picked:
            insts[iid].shards[shard] = ShardAssignment(shard, ShardState.AVAILABLE)
            heapq.heappush(heap, (cnt + 1, iid))
    p = Placement(insts, num_shards, replica_factor)
    p.validate()
    return p


def _available_replicas(insts: Dict[str, Instance], shard: int) -> int:
    return sum(
        1 for inst in insts.values()
        if (a := inst.shards.get(shard)) is not None
        and a.state == ShardState.AVAILABLE)


def add_instance(p: Placement, new: Instance) -> Placement:
    """algo/sharded.go AddInstance: pull shards from the most loaded
    instances onto the new one as Initializing with source donors.

    Replica-safe on unsettled placements (the reference planner's
    guarantee, placement/algo/planner.go): a donor copy only turns LEAVING
    when the shard still has a full RF of AVAILABLE replicas, so no
    sequence of placement changes drops a shard below RF-1 available."""
    insts = {iid: dataclasses.replace(i, shards=dict(i.shards)) for iid, i in p.instances.items()}
    newinst = dataclasses.replace(new, shards={})
    insts[new.id] = newinst
    counts = {iid: len(i.shards) for iid, i in insts.items()}
    targets = _rebalance_targets(counts, p.num_shards, p.replica_factor)
    want = targets[new.id]
    donors = sorted((iid for iid in insts if iid != new.id),
                    key=lambda i: -counts[i])
    for donor_id in donors:
        if len(newinst.shards) >= want:
            break
        donor = insts[donor_id]
        surplus = counts[donor_id] - targets[donor_id]
        movable = [s for s in donor.shards.values()
                   if s.state == ShardState.AVAILABLE
                   and s.shard not in newinst.shards
                   and _available_replicas(insts, s.shard) >= p.replica_factor]
        for a in movable[: max(surplus, 0)]:
            if len(newinst.shards) >= want:
                break
            donor.shards[a.shard] = ShardAssignment(a.shard, ShardState.LEAVING)
            newinst.shards[a.shard] = ShardAssignment(a.shard, ShardState.INITIALIZING, donor_id)
            counts[donor_id] -= 1
    return Placement(insts, p.num_shards, p.replica_factor, p.version,
                     p.is_mirrored)


def remove_instance(p: Placement, instance_id: str) -> Placement:
    """algo/sharded.go RemoveInstance: redistribute its shards to the
    least-loaded instances that don't already own them.

    Replica-safe: refuses (whole-op, placement untouched) when any of the
    leaving instance's AVAILABLE shards lacks RF-1 AVAILABLE replicas
    elsewhere — earlier moves must settle (mark available) first."""
    if instance_id not in p.instances:
        raise KeyError(instance_id)
    leaving = p.instances[instance_id]
    for a in leaving.shards.values():
        if (a.state == ShardState.AVAILABLE
                and _available_replicas(p.instances, a.shard) - 1
                < p.replica_factor - 1):
            raise ValueError(
                f"removing {instance_id!r} would drop shard {a.shard} below "
                f"RF-1 available replicas; settle pending moves first")
    insts = {iid: dataclasses.replace(i, shards=dict(i.shards))
             for iid, i in p.instances.items() if iid != instance_id}
    heap = [(len(i.shards), iid) for iid, i in insts.items()]
    heapq.heapify(heap)
    for a in leaving.shards.values():
        if a.state == ShardState.LEAVING:
            continue
        # A shard the removed instance was still *receiving* keeps its
        # original donor as the source — re-sourcing it to the (now gone)
        # removed id would orphan the donor's LEAVING copy forever.
        source = a.source_id if a.state == ShardState.INITIALIZING else instance_id
        placed = False
        buffer = []
        while heap and not placed:
            cnt, iid = heapq.heappop(heap)
            if a.shard not in insts[iid].shards:
                insts[iid].shards[a.shard] = ShardAssignment(
                    a.shard, ShardState.INITIALIZING, source
                )
                heapq.heappush(heap, (cnt + 1, iid))
                placed = True
            else:
                buffer.append((cnt, iid))
        for item in buffer:
            heapq.heappush(heap, item)
        if not placed:
            raise ValueError(f"cannot place shard {a.shard}: all instances own it")
    return Placement(insts, p.num_shards, p.replica_factor, p.version,
                     p.is_mirrored)


def replace_instance(p: Placement, leaving_id: str, new: Instance) -> Placement:
    """algo/sharded.go ReplaceInstance: the new instance inherits the
    leaving instance's shards 1:1 (Initializing <- source).

    Replica-safe: the victim's AVAILABLE copies become INITIALIZING on the
    replacement, so each such shard must have RF-1 AVAILABLE replicas
    elsewhere or the whole operation is refused."""
    if leaving_id not in p.instances:
        raise KeyError(leaving_id)
    for a in p.instances[leaving_id].shards.values():
        if (a.state == ShardState.AVAILABLE
                and _available_replicas(p.instances, a.shard) - 1
                < p.replica_factor - 1):
            raise ValueError(
                f"replacing {leaving_id!r} would drop shard {a.shard} below "
                f"RF-1 available replicas; settle pending moves first")
    insts = {iid: dataclasses.replace(i, shards=dict(i.shards)) for iid, i in p.instances.items()}
    old = insts.pop(leaving_id)
    newinst = dataclasses.replace(new, shards={})
    for a in old.shards.values():
        newinst.shards[a.shard] = ShardAssignment(a.shard, ShardState.INITIALIZING, leaving_id)
    insts[new.id] = newinst
    return Placement(insts, p.num_shards, p.replica_factor, p.version,
                     p.is_mirrored)


def mark_shard_available(p: Placement, instance_id: str, shard: int) -> Placement:
    """placement.Service MarkShardAvailable: Initializing -> Available on the
    receiver, dropping the donor's Leaving assignment."""
    insts = {iid: dataclasses.replace(i, shards=dict(i.shards)) for iid, i in p.instances.items()}
    inst = insts[instance_id]
    a = inst.shards.get(shard)
    if a is None or a.state != ShardState.INITIALIZING:
        raise ValueError(f"shard {shard} not initializing on {instance_id}")
    if a.source_id and a.source_id in insts:
        donor = insts[a.source_id]
        da = donor.shards.get(shard)
        if da is not None and da.state == ShardState.LEAVING:
            del donor.shards[shard]
    inst.shards[shard] = ShardAssignment(shard, ShardState.AVAILABLE)
    return Placement(insts, p.num_shards, p.replica_factor, p.version,
                     p.is_mirrored)


# ---------------------------------------------------------------------------
# mirrored placements (reference: src/cluster/placement/algo/mirrored.go —
# aggregator HA pairs: instances grouped into shard sets of exactly RF
# members that hold identical shards; each shard lives in one set)
# ---------------------------------------------------------------------------


def _group_reps(instances: Sequence[Instance], replica_factor: int) -> Dict[str, List[Instance]]:
    groups: Dict[str, List[Instance]] = {}
    for i in instances:
        if not i.shard_set_id:
            raise ValueError(f"instance {i.id!r} missing shard_set_id")
        groups.setdefault(i.shard_set_id, []).append(i)
    for ssid, members in groups.items():
        if len(members) != replica_factor:
            raise ValueError(
                f"shard set {ssid!r} has {len(members)} members, want RF={replica_factor}")
        members.sort(key=lambda i: i.id)
    return groups


def _expand_groups(p_virtual: Placement, groups: Dict[str, List[Instance]],
                   src_groups: Optional[Dict[str, List[Instance]]] = None) -> Placement:
    """Virtual (one-instance-per-set, RF=1) placement -> real mirrored
    placement: each member mirrors its set's shards; Initializing sources
    map positionally onto the donor set's members."""
    src_groups = src_groups or groups
    insts: Dict[str, Instance] = {}
    for ssid, members in groups.items():
        virt = p_virtual.instances.get(ssid)
        shards = dict(virt.shards) if virt is not None else {}
        for k, member in enumerate(members):
            mshards = {}
            for s, a in shards.items():
                src = None
                if a.source_id is not None and a.source_id in src_groups:
                    donors = src_groups[a.source_id]
                    src = donors[min(k, len(donors) - 1)].id
                mshards[s] = ShardAssignment(s, a.state, src)
            insts[member.id] = dataclasses.replace(member, shards=mshards)
    return Placement(insts, p_virtual.num_shards, len(next(iter(groups.values()))),
                     p_virtual.version, is_mirrored=True)


def _to_virtual(p: Placement) -> Tuple[Placement, Dict[str, List[Instance]]]:
    """Real mirrored placement -> virtual RF=1 placement over shard sets."""
    groups = p.shard_sets()
    insts = {}
    for ssid, members in groups.items():
        rep = members[0]
        shards = {}
        for s, a in rep.shards.items():
            src_set = None
            if a.source_id is not None and a.source_id in p.instances:
                src_set = p.instances[a.source_id].shard_set_id
            shards[s] = ShardAssignment(s, a.state, src_set)
        insts[ssid] = Instance(ssid, "", shards=shards)
    return Placement(insts, p.num_shards, 1, p.version), groups


def mirrored_initial_placement(instances: Sequence[Instance], num_shards: int,
                               replica_factor: int) -> Placement:
    """algo/mirrored.go InitialPlacement."""
    groups = _group_reps(instances, replica_factor)
    reps = [Instance(ssid, "") for ssid in sorted(groups)]
    pv = initial_placement(reps, num_shards, 1)
    p = _expand_groups(pv, groups)
    p.validate_mirrored()
    return p


def mirrored_add_shard_set(p: Placement, new_members: Sequence[Instance]) -> Placement:
    """algo/mirrored.go AddInstances: a whole new shard set joins; shards
    move set-to-set so members stay mirrored."""
    pv, groups = _to_virtual(p)
    new_groups = _group_reps(new_members, p.replica_factor)
    if len(new_groups) != 1:
        raise ValueError("add one shard set at a time")
    (ssid, members), = new_groups.items()
    if ssid in groups:
        raise ValueError(f"shard set {ssid!r} already in placement")
    pv2 = add_instance(pv, Instance(ssid, ""))
    groups2 = dict(groups)
    groups2[ssid] = sorted(members, key=lambda i: i.id)
    return _expand_groups(pv2, groups2)


def mirrored_remove_shard_set(p: Placement, shard_set_id: str) -> Placement:
    """algo/mirrored.go RemoveInstances: a whole set leaves. The leaving
    set STAYS in the placement with its shards LEAVING until the receiving
    sets cut over (mirrored_mark_available drops emptied sets) — dropping
    it immediately would leave its shards with zero available replicas
    while the receivers are still initializing."""
    pv, groups = _to_virtual(p)
    if shard_set_id not in groups:
        raise KeyError(shard_set_id)
    insts = {iid: dataclasses.replace(i, shards=dict(i.shards))
             for iid, i in pv.instances.items()}
    leaving = insts[shard_set_id]
    heap = [(len(i.shards), iid) for iid, i in insts.items()
            if iid != shard_set_id]
    heapq.heapify(heap)
    for a in list(leaving.shards.values()):
        if a.state == ShardState.LEAVING:
            continue
        source = (a.source_id if a.state == ShardState.INITIALIZING
                  else shard_set_id)
        placed = False
        buffer = []
        while heap and not placed:
            cnt, iid = heapq.heappop(heap)
            if a.shard not in insts[iid].shards:
                insts[iid].shards[a.shard] = ShardAssignment(
                    a.shard, ShardState.INITIALIZING, source)
                heapq.heappush(heap, (cnt + 1, iid))
                placed = True
            else:
                buffer.append((cnt, iid))
        for item in buffer:
            heapq.heappush(heap, item)
        if not placed:
            raise ValueError(
                f"cannot place shard {a.shard}: all shard sets own it")
        leaving.shards[a.shard] = ShardAssignment(a.shard, ShardState.LEAVING)
    pv2 = Placement(insts, pv.num_shards, 1, pv.version)
    return _expand_groups(pv2, groups, src_groups=groups)


def mirrored_mark_available(p: Placement, shard_set_id: str) -> Placement:
    """Cut over every Initializing shard of one set (all members at once —
    mirrored sets move in lockstep). Shard sets fully emptied by the
    cutover (a removed set whose last LEAVING copies just dropped) leave
    the placement."""
    out = p
    members = p.shard_sets()[shard_set_id]
    for m in members:
        for s, a in list(m.shards.items()):
            if a.state == ShardState.INITIALIZING:
                out = mark_shard_available(out, m.id, s)
    emptied = [ssid for ssid, mem in out.shard_sets().items()
               if all(not m.shards for m in mem)]
    if emptied:
        insts = {iid: inst for iid, inst in out.instances.items()
                 if inst.shard_set_id not in emptied}
        out = Placement(insts, out.num_shards, out.replica_factor,
                        out.version, out.is_mirrored)
    return out


# ---------------------------------------------------------------------------
# deployment planner (reference: src/cluster/placement/planner.go
# NewShardAwareDeploymentPlanner: group instances into deployment steps such
# that no two instances in one step share any shard, so every shard keeps
# >= RF-1 replicas up through every step)
# ---------------------------------------------------------------------------


def plan_deployment(p: Placement, max_step_size: int = 0) -> List[List[str]]:
    """Greedy shard-aware coloring: most-loaded instances first, packed into
    the earliest step whose members share none of their shards."""
    order = sorted(p.instances, key=lambda iid: (-len(p.instances[iid].shards), iid))
    steps: List[List[str]] = []
    step_shards: List[set] = []
    for iid in order:
        shards = set(p.instances[iid].shards)
        for k in range(len(steps)):
            if max_step_size and len(steps[k]) >= max_step_size:
                continue
            if not (shards & step_shards[k]):
                steps[k].append(iid)
                step_shards[k] |= shards
                break
        else:
            steps.append([iid])
            step_shards.append(set(shards))
    return steps


def validate_deployment_plan(p: Placement, steps: List[List[str]]) -> None:
    """Every shard keeps >= RF-1 replicas outside the step being deployed."""
    seen: List[str] = []
    for step in steps:
        for s in range(p.num_shards):
            owners = {i.id for i in p.replicas_for(s, states=tuple(ShardState))}
            down = owners & set(step)
            if len(owners) - len(down) < p.replica_factor - 1:
                raise ValueError(
                    f"step {step} takes shard {s} below RF-1 replicas")
        seen.extend(step)
    all_ids = set(p.instances)
    if set(seen) != all_ids or len(seen) != len(all_ids):
        raise ValueError("plan does not cover every instance exactly once")


class PlacementService:
    """KV-backed placement storage + operations (placement.Service)."""

    def __init__(self, store, key: str = "_placement"):
        self.store = store
        self.key = key

    def get(self) -> Optional[Placement]:
        obj, version = kvmod.get_json(self.store, self.key)
        if obj is None:
            return None
        return Placement.from_json(obj, version)

    def _put(self, p: Placement, expect_version: int) -> Placement:
        data = json.dumps(p.to_json()).encode()
        new_version = self.store.check_and_set(self.key, expect_version, data)
        p.version = new_version
        return p

    def init(self, instances: Sequence[Instance], num_shards: int, replica_factor: int) -> Placement:
        return self._put(initial_placement(instances, num_shards, replica_factor), 0)

    def add_instance(self, new: Instance) -> Placement:
        cur = self.get()
        return self._put(add_instance(cur, new), cur.version)

    def remove_instance(self, instance_id: str) -> Placement:
        cur = self.get()
        return self._put(remove_instance(cur, instance_id), cur.version)

    def replace_instance(self, leaving_id: str, new: Instance) -> Placement:
        cur = self.get()
        return self._put(replace_instance(cur, leaving_id, new), cur.version)

    def mark_shard_available(self, instance_id: str, shard: int) -> Placement:
        cur = self.get()
        return self._put(mark_shard_available(cur, instance_id, shard), cur.version)

    def mark_instance_available(self, instance_id: str) -> Placement:
        cur = self.get()
        p = cur
        for a in list(cur.instances[instance_id].shards.values()):
            if a.state == ShardState.INITIALIZING:
                p = mark_shard_available(p, instance_id, a.shard)
        return self._put(p, cur.version)

    def watch(self):
        return self.store.watch(self.key)
