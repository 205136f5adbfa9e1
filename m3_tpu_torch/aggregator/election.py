"""Aggregator election manager (reference:
src/aggregator/aggregator/election_mgr.go — Leader/Follower/PendingFollower
states :99-126, campaigning via etcd election).

Wraps the cluster leader service: each aggregator instance campaigns for its
shard-set's election; the winner flushes, everyone else shadows. Losing
leadership moves Leader -> PendingFollower until the follower flush manager
has caught up to the new leader's persisted flush times, then Follower —
which prevents double-flushing the same window during a hand-off.

Host copy of m3_tpu/aggregator/election.py."""

from __future__ import annotations

import enum
from typing import Callable, Optional

from ..cluster.services import LeaderService


class ElectionState(enum.IntEnum):
    FOLLOWER = 0
    PENDING_FOLLOWER = 1
    LEADER = 2


class ElectionManager:
    def __init__(self, leader_service: LeaderService,
                 on_change: Optional[Callable[[ElectionState], None]] = None):
        self._leader = leader_service
        self._state = ElectionState.FOLLOWER
        self._on_change = on_change

    @property
    def state(self) -> ElectionState:
        return self._state

    def campaign(self) -> ElectionState:
        """One campaign step: attempt/renew leadership and update state."""
        outcome = self._leader.campaign()
        if outcome == "leader":
            self._set(ElectionState.LEADER)
        elif self._state == ElectionState.LEADER:
            # Lost the election while leading: drain before following.
            self._set(ElectionState.PENDING_FOLLOWER)
        elif self._state != ElectionState.PENDING_FOLLOWER:
            # PENDING_FOLLOWER only resolves via confirm_follower() once the
            # follower flush manager reports caught-up; campaigning again must
            # not short-circuit the hand-off drain.
            self._set(ElectionState.FOLLOWER)
        return self._state

    def confirm_follower(self):
        """Called by the follower flush manager once caught up
        (election_mgr.go:126 pendingFollowerToFollower)."""
        if self._state == ElectionState.PENDING_FOLLOWER:
            self._set(ElectionState.FOLLOWER)

    def resign(self):
        self._leader.resign()
        self._set(ElectionState.FOLLOWER)

    def is_leader(self) -> bool:
        return self._state == ElectionState.LEADER

    def _set(self, s: ElectionState):
        if s != self._state:
            self._state = s
            if self._on_change:
                self._on_change(s)
