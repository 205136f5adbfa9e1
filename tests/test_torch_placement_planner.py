"""Port of tests/test_placement_planner.py on m3_tpu_torch: the same cases
on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Mirrored placements + shard-aware deployment planner (reference:
src/cluster/placement/algo/mirrored.go, placement/planner.go), plus the
replica-safety property: random add/remove/replace sequences never drop a
shard below RF-1 available replicas at any intermediate placement."""

import random

import pytest

from m3_tpu_torch.cluster.placement import (
    Instance,
    Placement,
    ShardState,
    add_instance,
    initial_placement,
    mark_shard_available,
    mirrored_add_shard_set,
    mirrored_initial_placement,
    mirrored_mark_available,
    mirrored_remove_shard_set,
    plan_deployment,
    remove_instance,
    replace_instance,
    validate_deployment_plan,
)
from test_torch_cpu_default import cpu_default  # noqa: F401


def mk_set(ssid, n):
    return [Instance(f"{ssid}-{k}", f"{ssid}-{k}:1", shard_set_id=ssid)
            for k in range(n)]


def mark_all_available(p: Placement) -> Placement:
    for iid, inst in list(p.instances.items()):
        for s, a in list(inst.shards.items()):
            if a.state == ShardState.INITIALIZING:
                p = mark_shard_available(p, iid, s)
    return p


class TestMirrored:
    def test_initial_placement_mirrors(self):
        insts = mk_set("ss1", 2) + mk_set("ss2", 2) + mk_set("ss3", 2)
        p = mirrored_initial_placement(insts, num_shards=12, replica_factor=2)
        p.validate_mirrored()
        assert p.is_mirrored
        groups = p.shard_sets()
        assert set(groups) == {"ss1", "ss2", "ss3"}
        for members in groups.values():
            a, b = members
            assert set(a.shards) == set(b.shards)
        # every shard in exactly one set, counts balanced
        sizes = sorted(len(m[0].shards) for m in groups.values())
        assert sum(sizes) == 12 and max(sizes) - min(sizes) <= 1

    def test_wrong_set_size_rejected(self):
        with pytest.raises(ValueError):
            mirrored_initial_placement(
                mk_set("ss1", 2) + mk_set("ss2", 3), 8, replica_factor=2)

    def test_add_and_remove_shard_set(self):
        p = mirrored_initial_placement(
            mk_set("ss1", 2) + mk_set("ss2", 2), 8, replica_factor=2)
        p2 = mirrored_add_shard_set(p, mk_set("ss3", 2))
        newbies = p2.shard_sets()["ss3"]
        assert len(newbies[0].shards) > 0
        assert all(a.state == ShardState.INITIALIZING and a.source_id
                   for a in newbies[0].shards.values())
        # members' initializing sources land on distinct donor members
        srcs = {m.id: {a.source_id for a in m.shards.values()}
                for m in newbies}
        assert srcs["ss3-0"] != srcs["ss3-1"]
        p3 = mirrored_mark_available(p2, "ss3")
        p3.validate_mirrored()
        p4 = mirrored_remove_shard_set(p3, "ss1")
        # The leaving set stays (LEAVING) until receivers cut over — its
        # shards never drop to zero available replicas mid-move.
        assert "ss1-0" in p4.instances
        assert all(a.state == ShardState.LEAVING
                   for a in p4.instances["ss1-0"].shards.values())
        for s in range(8):
            avail = p4.replicas_for(s, states=(ShardState.AVAILABLE,
                                               ShardState.LEAVING))
            assert len(avail) >= 2, s
        for ssid in ("ss2", "ss3"):
            p4 = mirrored_mark_available(p4, ssid)
        # Fully handed off: the emptied set leaves the placement.
        assert "ss1-0" not in p4.instances
        p4.validate_mirrored()
        assert sum(len(m[0].shards) for m in p4.shard_sets().values()) == 8

    def test_json_roundtrip_preserves_mirroring(self):
        p = mirrored_initial_placement(
            mk_set("ss1", 2) + mk_set("ss2", 2), 8, replica_factor=2)
        p2 = Placement.from_json(p.to_json(), version=3)
        assert p2.is_mirrored and p2.version == 3
        p2.validate_mirrored()
        assert p2.instances["ss1-0"].shard_set_id == "ss1"


class TestDeploymentPlanner:
    def test_plan_is_replica_safe(self):
        p = initial_placement(
            [Instance(f"i{k}", f"h{k}:1") for k in range(6)], 24, 3)
        steps = plan_deployment(p)
        validate_deployment_plan(p, steps)
        assert sum(len(s) for s in steps) == 6

    def test_mirrored_members_never_share_a_step(self):
        p = mirrored_initial_placement(
            mk_set("ss1", 2) + mk_set("ss2", 2) + mk_set("ss3", 2),
            12, replica_factor=2)
        steps = plan_deployment(p)
        validate_deployment_plan(p, steps)
        for step in steps:
            sets = [p.instances[iid].shard_set_id for iid in step]
            assert len(sets) == len(set(sets)), step

    def test_max_step_size_respected(self):
        p = initial_placement(
            [Instance(f"i{k}", f"h{k}:1") for k in range(8)], 16, 2)
        steps = plan_deployment(p, max_step_size=2)
        validate_deployment_plan(p, steps)
        assert all(len(s) <= 2 for s in steps)

    def test_bad_plan_rejected(self):
        p = mirrored_initial_placement(
            mk_set("ss1", 2) + mk_set("ss2", 2), 8, replica_factor=2)
        with pytest.raises(ValueError):
            validate_deployment_plan(p, [["ss1-0", "ss1-1"], ["ss2-0", "ss2-1"]])


class TestReplicaSafetyProperty:
    RF = 3

    def _assert_safe(self, p: Placement, when: str):
        for s in range(p.num_shards):
            avail = p.replicas_for(s, states=(ShardState.AVAILABLE,))
            live = p.replicas_for(s)  # INITIALIZING + AVAILABLE
            assert len(avail) >= self.RF - 1, (when, s, len(avail))
            assert len(live) >= self.RF, (when, s, len(live))

    @pytest.mark.parametrize("seed", [1, 7, 23, 99])
    def test_random_topology_churn_never_underreplicates(self, seed):
        rng = random.Random(seed)
        n0 = 5
        p = initial_placement(
            [Instance(f"i{k}", f"h{k}:1") for k in range(n0)], 30, self.RF)
        self._assert_safe(p, "initial")
        next_id = n0
        for step in range(25):
            op = rng.choice(["add", "remove", "replace", "settle"])
            try:
                if op == "add":
                    p = add_instance(p, Instance(f"i{next_id}", f"h{next_id}:1"))
                    next_id += 1
                elif op == "remove" and len(p.instances) > self.RF + 1:
                    victim = rng.choice(sorted(p.instances))
                    p = remove_instance(p, victim)
                elif op == "replace":
                    victim = rng.choice(sorted(p.instances))
                    p = replace_instance(
                        p, victim, Instance(f"i{next_id}", f"h{next_id}:1"))
                    next_id += 1
                else:
                    p = mark_all_available(p)
            except ValueError:
                # Legal rejection (e.g. shard unplaceable) must leave the
                # placement untouched; safety still holds below.
                pass
            self._assert_safe(p, f"step {step} {op}")
        p = mark_all_available(p)
        self._assert_safe(p, "final settle")
        p.validate()
