"""Shared device-memory budget for every cache that pins device or host
buffers on the serving path (port of m3_tpu/utils/hbm.py over CUDA
memory; reference: the byte-bounded WiredList of
src/dbnode/storage/block/wired_list.go:77, generalized to ONE budget over
every resident tier the way dbnode's cache policies share the wired-list
capacity).

`HBMBudget` is the process-wide cap: tenants register a usage probe plus
an evict-one callback, and `reclaim()` rotates across tenants evicting
least-recently-used entries until the total fits (per-tenant ceilings
still apply first, so existing knobs keep their meaning as shares of the
global budget).

Accounting is PULL-based — the budget reads each tenant's live byte
counter instead of mirroring charges — so a tenant that clears itself
can never leave phantom bytes behind in a push-ledger.

Locking: the budget lock is only ever held to snapshot the tenant table;
evict callbacks run with NO budget lock held, so a tenant is free to take
its own lock inside them (tenant lock -> budget lock is the one permitted
order; callers must invoke `reclaim()` only outside their own locks when
their evictor takes that lock).

`budgeted_put` is the upload for one-shot transfers on the serving path:
`tensor.to(device)` charged at `numel() * element_size()` to a transient
tenant and released when the device tensor is garbage-collected, so
memory pressure from in-flight uploads is visible to the same budget that
governs the resident caches.

Saturation exports through instrument gauges (`hbm.bytes`,
`hbm.saturation`) and `pressure()` registers as a HealthTracker probe:
pressure stays 0.0 while reclaim keeps the total inside the budget (a full
LRU cache is a HEALTHY steady state, not an incident) and rises only when
pinned bytes exceed the budget and eviction cannot free them.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Dict, Optional

from .instrument import ROOT

__all__ = ["HBMBudget", "shared_budget", "budgeted_put", "tensor_nbytes"]

DEFAULT_BUDGET_BYTES = 2 * 1024 * 1024 * 1024


class HBMBudget:
    """One byte budget across every registered resident-memory tenant."""

    def __init__(self, limit_bytes: int, name: str = "hbm"):
        if limit_bytes <= 0:
            raise ValueError(f"budget must be positive, got {limit_bytes}")
        self.limit = int(limit_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._usage: Dict[str, Callable[[], int]] = {}
        self._evictors: Dict[str, Callable[[], int]] = {}
        # Rotation cursor: reclaim starts each pass one tenant further
        # along, approximating global LRU without a cross-tenant clock.
        self._rotation = 0
        self._metrics = ROOT.sub_scope(name)
        self._transient = 0
        # Releases arrive from weakref finalizers, which the cyclic GC may
        # run at ANY bytecode boundary — including while this thread holds
        # self._lock. A finalizer must therefore never acquire a lock:
        # it appends to this list (list.append is GIL-atomic) and the
        # usage probe drains it under the lock.
        self._transient_released: list = []
        self.register("transient", self._transient_usage)

    # ---------------------------------------------------------------- tenants

    def register(self, tenant: str, usage: Callable[[], int],
                 evict_one: Optional[Callable[[], int]] = None):
        """Add a tenant: `usage()` returns its current resident bytes;
        `evict_one()` (optional) drops its least-recently-used entry and
        returns the bytes freed (0 when it cannot shrink further)."""
        with self._lock:
            self._usage[tenant] = usage
            if evict_one is not None:
                self._evictors[tenant] = evict_one
            else:
                self._evictors.pop(tenant, None)

    def unregister(self, tenant: str):
        with self._lock:
            self._usage.pop(tenant, None)
            self._evictors.pop(tenant, None)

    # --------------------------------------------------------------- readings

    def total(self) -> int:
        with self._lock:
            probes = list(self._usage.values())
        total = 0
        for fn in probes:
            try:
                total += max(0, int(fn()))
            except Exception:  # noqa: BLE001 — a dead probe contributes 0
                pass
        return total

    def usage(self) -> Dict[str, int]:
        with self._lock:
            probes = dict(self._usage)
        out = {}
        for tenant, fn in probes.items():
            try:
                out[tenant] = max(0, int(fn()))
            except Exception:  # noqa: BLE001
                out[tenant] = 0
        return out

    def saturation(self) -> float:
        return min(1.0, self.total() / self.limit)

    def pressure(self) -> float:
        """Health-probe reading: 0 while the budget holds (a full cache is
        healthy), rising toward 1 as unreclaimable bytes exceed the limit
        (at 2x the budget the probe reads fully saturated)."""
        total = self.total()
        if total <= self.limit:
            return 0.0
        return min(1.0, (total - self.limit) / self.limit)

    # --------------------------------------------------------------- reclaim

    def reclaim(self) -> int:
        """Evict LRU entries across tenants (rotating the starting tenant
        so no single cache absorbs all evictions) until the total fits the
        budget or a full pass frees nothing. Returns bytes freed. Called
        with NO tenant locks held (evictors take their own)."""
        freed = 0
        while self.total() > self.limit:
            with self._lock:
                names = list(self._evictors)
                if not names:
                    break
                start = self._rotation % len(names)
                self._rotation += 1
                evictors = [(n, self._evictors[n])
                            for n in names[start:] + names[:start]]
            pass_freed = 0
            for _name, evict in evictors:
                try:
                    pass_freed += max(0, int(evict()))
                except Exception:  # noqa: BLE001 — one tenant's failure
                    pass               # must not wedge global reclaim
                if self.total() <= self.limit:
                    break
            if pass_freed == 0:
                break
            freed += pass_freed
        self._metrics.gauge("bytes").update(self.total())
        self._metrics.gauge("saturation").update(self.saturation())
        return freed

    def reclaim_pass(self) -> int:
        """ONE forced eviction rotation regardless of the tracked total: a
        device-reported out-of-memory error means the card is out of memory
        even if the host-side ledger is under budget (fragmentation,
        untracked scratch, another process), so the compute-fault guard
        frees one LRU entry per tenant before its single dispatch retry.
        Returns bytes freed. Same locking contract as reclaim()."""
        with self._lock:
            names = list(self._evictors)
            if not names:
                return 0
            start = self._rotation % len(names)
            self._rotation += 1
            evictors = [(n, self._evictors[n])
                        for n in names[start:] + names[:start]]
        freed = 0
        for _name, evict in evictors:
            try:
                freed += max(0, int(evict()))
            except Exception:  # noqa: BLE001 — one tenant's failure
                pass               # must not wedge the OOM retry
        self._metrics.gauge("bytes").update(self.total())
        self._metrics.gauge("saturation").update(self.saturation())
        return freed

    # ------------------------------------------------------- transient puts

    def _release_transient(self, n: int):
        # Finalizer context: lock-free by contract (see __init__).
        self._transient_released.append(n)

    def _transient_usage(self) -> int:
        with self._lock:
            while self._transient_released:
                self._transient -= self._transient_released.pop()
            if self._transient < 0:
                self._transient = 0
            return self._transient

    def device_put(self, arr, dst=None):
        """`arr` (a tensor, or an array torch.as_tensor accepts) moved to
        `dst` (None: the CUDA device, raising without one), charged to the budget for the
        LIFETIME of the device tensor: numel() * element_size() on upload,
        released when the tensor is collected, so transient uploads show
        up as real memory pressure."""
        import torch

        from ..device import resolve

        dev = torch.as_tensor(arr).to(resolve(dst))
        n = tensor_nbytes(dev)
        # Transfer telemetry at the same choke point the budget charges
        # (lazy import: utils must stay importable without parallel).
        from ..parallel import telemetry

        telemetry.count_h2d(n)
        with self._lock:
            self._transient += n
        try:
            weakref.finalize(dev, self._release_transient, n)
        except TypeError:
            # Objects that refuse weakrefs: release immediately
            # (accounting degrades to charge-at-upload only).
            self._release_transient(n)
        self.reclaim()
        return dev


def tensor_nbytes(t) -> int:
    """Bytes a tensor's elements occupy (numel * element_size); numpy
    arrays and other objects report their `nbytes`, or 0."""
    numel = getattr(t, "numel", None)
    if callable(numel):
        return int(numel()) * int(t.element_size())
    return int(getattr(t, "nbytes", 0))


_SHARED: Optional[HBMBudget] = None
_SHARED_LOCK = threading.Lock()


def shared_budget() -> HBMBudget:
    """The process-wide budget (`M3_TPU_HBM_BUDGET_BYTES`, default 2GiB).
    First use wires `pressure()` into the process HealthTracker as the
    memory-pressure probe beside the admission gates' depth probes."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = HBMBudget(int(os.environ.get(
                "M3_TPU_HBM_BUDGET_BYTES", str(DEFAULT_BUDGET_BYTES))))
            from .health import TRACKER

            TRACKER.register("hbm_pressure", _SHARED.pressure)
        return _SHARED


def budgeted_put(arr, dst=None):
    """Module-level convenience over shared_budget().device_put."""
    return shared_budget().device_put(arr, dst)
