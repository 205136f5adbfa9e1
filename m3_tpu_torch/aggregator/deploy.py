"""Staged safe-deploy orchestration for aggregator fleets (host copy of
m3_tpu/aggregator/deploy.py, no device; reference:
src/aggregator/tools/deploy — deploy in batches, always followers first,
force leader resignation before touching a leader, validate health between
stages so a bad build never takes out both replicas of a shard set)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class InstanceInfo:
    instance_id: str
    shard_set_id: str
    is_leader: bool
    healthy: bool = True


class DeployError(RuntimeError):
    pass


class Deployer:
    """tools/deploy/planner.go + helper.go: plan stages (followers of each
    shard set first, then leaders after resignation), execute with health
    validation."""

    def __init__(self,
                 inspect: Callable[[str], InstanceInfo],
                 deploy_one: Callable[[str], None],
                 resign: Callable[[str], None],
                 max_stage_fraction: float = 0.5,
                 health_timeout_s: float = 30.0,
                 poll_interval_s: float = 0.2):
        """inspect(id) -> InstanceInfo; deploy_one(id) updates+restarts;
        resign(id) forces leadership hand-off."""
        self._inspect = inspect
        self._deploy_one = deploy_one
        self._resign = resign
        self._max_fraction = max_stage_fraction
        self._health_timeout_s = health_timeout_s
        self._poll_interval_s = poll_interval_s
        self.stages_executed: List[List[str]] = []

    def plan(self, instance_ids: Sequence[str]) -> List[List[str]]:
        """Followers first (batched by shard set so at most one replica of a
        shard set per stage), leaders last (planner.go GeneratePlan)."""
        infos = [self._inspect(i) for i in instance_ids]
        followers = [i for i in infos if not i.is_leader]
        leaders = [i for i in infos if i.is_leader]
        stages: List[List[str]] = []
        for group in (followers, leaders):
            pending = list(group)
            while pending:
                stage, used_sets = [], set()
                limit = max(1, int(len(infos) * self._max_fraction))
                rest = []
                for info in pending:
                    if (info.shard_set_id not in used_sets
                            and len(stage) < limit):
                        stage.append(info.instance_id)
                        used_sets.add(info.shard_set_id)
                    else:
                        rest.append(info)
                stages.append(stage)
                pending = rest
        return stages

    def execute(self, instance_ids: Sequence[str]) -> List[List[str]]:
        stages = self.plan(instance_ids)
        for stage in stages:
            for iid in stage:
                info = self._inspect(iid)
                if info.is_leader:
                    # Never deploy a live leader (helper.go resign-first).
                    self._resign(iid)
                    self._wait(lambda: not self._inspect(iid).is_leader,
                               f"{iid} did not resign leadership")
                self._deploy_one(iid)
            for iid in stage:
                self._wait(lambda: self._inspect(iid).healthy,
                           f"{iid} unhealthy after deploy")
            self.stages_executed.append(stage)
        return stages

    def _wait(self, cond: Callable[[], bool], msg: str):
        deadline = time.monotonic() + self._health_timeout_s
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(self._poll_interval_s)
        raise DeployError(msg)
