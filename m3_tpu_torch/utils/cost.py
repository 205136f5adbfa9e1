"""Query cost enforcement (reference: src/x/cost/enforcer.go — per-query and
global cost accounting with limits, used by the query engine to bound
datapoints processed)."""

from __future__ import annotations

import threading
from typing import Optional


class CostLimitExceeded(RuntimeError):
    pass


class Enforcer:
    """Tracks charged cost against a limit (cost.Enforcer). Child enforcers
    chain to a parent (per-query -> global) so one query can't starve the
    process."""

    def __init__(self, limit: Optional[float] = None,
                 parent: Optional["Enforcer"] = None, name: str = "query"):
        self.limit = limit
        self.parent = parent
        self.name = name
        self._lock = threading.Lock()
        self._current = 0.0

    def add(self, cost: float) -> float:
        """Charge cost; raises CostLimitExceeded past the limit
        (enforcer.go Add). A rejected charge is rolled back at every level
        so callers can continue within the remaining budget."""
        with self._lock:
            self._current += cost
            current = self._current
        try:
            if self.limit is not None and current > self.limit:
                raise CostLimitExceeded(
                    f"{self.name} cost {current:g} exceeds limit {self.limit:g}")
            if self.parent is not None:
                self.parent.add(cost)
        except CostLimitExceeded:
            with self._lock:
                self._current -= cost
            raise
        return current

    def current(self) -> float:
        with self._lock:
            return self._current

    def release(self, cost: Optional[float] = None):
        """Return capacity when a query finishes (enforcer.go Remove).

        cost=None releases this enforcer's FULL current charge. The
        amount actually released is captured BEFORE the local decrement
        and propagated to the parent: a full release must credit the
        whole chain, or every completed query would permanently leak
        its charge from the global budget (the release(None) parent
        leak — regression-tested in tests/test_overload.py)."""
        with self._lock:
            released = self._current if cost is None else cost
            self._current -= released
        if self.parent is not None and released:
            self.parent.release(released)

    def child(self, limit: Optional[float] = None, name: str = "query"
              ) -> "Enforcer":
        return Enforcer(limit, parent=self, name=name)


NOOP = Enforcer(limit=None, name="noop")
