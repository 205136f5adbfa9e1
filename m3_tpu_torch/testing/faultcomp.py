"""Seeded compute-fault injection for the guarded dispatch seam (port of
m3_tpu/testing/faultcomp.py).

`ComputeFaultPlan` is frozen and seeded; the fault schedule is a PURE
FUNCTION of (seed, route, call-index): each intercepted dispatch makes
exactly ONE draw from `random.Random(f"{seed}/{route}/{index}")` against
cumulative thresholds in a FIXED order (compile_fail -> dispatch_raise
-> oom -> delay -> corrupt), the reference's schedule draw for draw.
`plan.schedule(route, n)` replays the first n decisions without
dispatching anything.

`FaultComp` implements `parallel.guard.DispatchSeam`. The injected errors
are the ones torch raises, so the guard's `classify` maps them as it maps
real faults:

  compile_fail    RuntimeError("Error building extension ...") — what
                  torch.utils.cpp_extension.load raises: CompileError;
  dispatch_raise  torch.AcceleratorError where the build has it, else a
                  RuntimeError("CUDA error: an illegal memory access ...")
                  — KernelFault;
  oom             torch.cuda.OutOfMemoryError("CUDA out of memory ...")
                  — DeviceOOM, which triggers the guard's reclaim and
                  single retry (the retry is a FRESH call index: a
                  schedule can fault the first attempt and clear the
                  retry);
  delay           sleeps `delay_s` then dispatches normally: the answer
                  is right, but past the guard's timeout the slow
                  dispatch counts against the breaker;
  corrupt         dispatches normally then POISONS every tensor and array
                  leaf of the output (all-NaN or all-garbage,
                  `guard.GARBAGE_*`): the guard's validator must catch it,
                  so no corrupted output is ever returned.

`route_filter` (substring match) scopes faults to one route family
(e.g. "codec."). Install with `install(plan)` / `uninstall()` or the
`injected(plan)` context manager.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..parallel import guard

__all__ = ["ComputeFaultPlan", "FaultComp", "NO_FAULT", "install",
           "uninstall", "injected", "expected_outcome", "unexplained"]

NO_FAULT = "ok"


@dataclasses.dataclass(frozen=True)
class ComputeFaultPlan:
    """Per-kind fault probabilities. All zero = benign passthrough (the
    injector still records decisions, and activates the guard's output
    validators, so determinism is testable without faults)."""

    seed: int = 0
    compile_fail: float = 0.0    # the extension build fails
    dispatch_raise: float = 0.0  # a kernel launch or device call raises
    oom: float = 0.0             # an allocation on the card fails
    delay: float = 0.0           # dispatch hang: sleep then answer
    corrupt: float = 0.0         # poisoned output planes (NaN/garbage)
    delay_s: float = 0.05        # hang duration for `delay`
    route_filter: str = ""       # substring: faults only matching routes

    def _probs(self) -> Tuple[Tuple[str, float], ...]:
        return (("compile_fail", self.compile_fail),
                ("dispatch_raise", self.dispatch_raise),
                ("oom", self.oom),
                ("delay", self.delay),
                ("corrupt", self.corrupt))

    def matches(self, route: str) -> bool:
        return not self.route_filter or self.route_filter in route

    def decide_at(self, route: str, index: int) -> str:
        """ONE draw for dispatch `index` on `route` against cumulative
        thresholds in fixed order."""
        draw = random.Random(f"{self.seed}/{route}/{index}").random()
        acc = 0.0
        for name, p in self._probs():
            acc += p
            if draw < acc:
                return name
        return NO_FAULT

    def schedule(self, route: str, n: int) -> List[str]:
        """The first n decisions for `route`."""
        return [self.decide_at(route, i) for i in range(n)]


def _poison_leaf(leaf, mode: str):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bool:
            return leaf
        if leaf.is_floating_point():
            val = float("nan") if mode == "nan" else guard.GARBAGE_F
        else:
            np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
            val = int(guard.garbage_int(np_dtype))
        return torch.full_like(leaf, val)
    a = np.asarray(leaf)
    if a.dtype.kind == "f":
        val = np.nan if mode == "nan" else guard.GARBAGE_F
        return np.full(a.shape, np.asarray(val).astype(a.dtype), a.dtype)
    if a.dtype.kind in "iu":
        return np.full(a.shape, guard.garbage_int(a.dtype), a.dtype)
    return leaf


def _poison_tree(out, mode: str):
    """Every tensor or array leaf replaced by a fully-poisoned plane of
    the same shape, dtype and device: all-NaN ("nan") or all
    guard.GARBAGE_* ("garbage"). Bool planes and non-array leaves pass
    through untouched."""
    if isinstance(out, tuple):
        return tuple(_poison_tree(v, mode) for v in out)
    if isinstance(out, list):
        return [_poison_tree(v, mode) for v in out]
    if isinstance(out, dict):
        return {k: _poison_tree(v, mode) for k, v in out.items()}
    if not (hasattr(out, "dtype") and hasattr(out, "shape")):
        return out
    return _poison_leaf(out, mode)


def _device_fault(msg: str) -> Exception:
    """What a faulting kernel raises: torch.AcceleratorError where this
    torch has it, else the RuntimeError older builds raise."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(f"CUDA error: an illegal memory access was encountered ({msg})")


class FaultComp(guard.DispatchSeam):
    """Seeded fault-injecting dispatch seam. Thread-safe; `decisions`
    and `faults_injected` record what it did."""

    def __init__(self, plan: ComputeFaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self.decisions: Dict[str, List[str]] = {}
        self.faults_injected = 0

    def call(self, route: str, fn):
        if not self.plan.matches(route):
            return fn()
        with self._lock:
            index = self._calls.get(route, 0)
            self._calls[route] = index + 1
            d = self.plan.decide_at(route, index)
            self.decisions.setdefault(route, []).append(d)
            if d != NO_FAULT:
                self.faults_injected += 1
        # Apply OUTSIDE the lock: fn may sleep or dispatch a nested route.
        where = f"injected (route={route}, index={index})"
        if d == "compile_fail":
            raise RuntimeError(
                f"Error building extension 'm3_tpu_torch_kernels': {where}")
        if d == "dispatch_raise":
            raise _device_fault(where)
        if d == "oom":
            raise torch.cuda.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate 2.00 GiB: {where}")
        if d == "delay":
            time.sleep(self.plan.delay_s)
            return fn()
        if d == "corrupt":
            out = fn()
            # A derived rng: the NaN-vs-garbage pick never perturbs the
            # decision stream.
            mode_rng = random.Random(
                f"{self.plan.seed}/pos/{route}/{index}")
            return _poison_tree(
                out, "nan" if mode_rng.random() < 0.5 else "garbage")
        return fn()

    def mark(self) -> Dict[str, int]:
        """The number of decisions drawn so far, per route."""
        with self._lock:
            return {r: len(ds) for r, ds in self.decisions.items()}

    def since(self, mark: Dict[str, int]) -> Dict[str, List[str]]:
        """The decisions drawn after `mark`, per route, in order."""
        with self._lock:
            return {r: ds[mark.get(r, 0):] for r, ds in self.decisions.items()
                    if len(ds) > mark.get(r, 0)}


# ------------------------------------------------------- outcome contract

# The typed raise each decision must end in (an oom is retried once).
_RAISES = {"compile_fail": "CompileError", "dispatch_raise": "KernelFault",
           "corrupt": "KernelFault"}


def expected_outcome(decisions: List[str]) -> str:
    """What the guard must make of the decisions one call drew on one
    route, in order: "exact" when every dispatch answers (ok, delay, or
    an oom whose retry answers), else the class name of the typed raise
    that ends the call. "unexplained" for a sequence the guard cannot
    produce (decisions drawn after a raise, an oom with no retry)."""
    i = 0
    while i < len(decisions):
        d = decisions[i]
        i += 1
        if d == "oom":
            if i == len(decisions):
                return "unexplained"
            d = decisions[i]
            i += 1
            if d == "oom":
                return "DeviceOOM" if i == len(decisions) else "unexplained"
        if d in _RAISES:
            return _RAISES[d] if i == len(decisions) else "unexplained"
    return "exact"


def unexplained(drawn: Dict[str, List[str]], err) -> "str | None":
    """None when one call's outcome is what its decisions (`drawn`, from
    `FaultComp.since`) imply: an answer when every route's decisions end
    "exact"; else a raise typed as its own route's decisions say, or an
    open breaker or quarantined key on a route that drew no raising
    decision. Otherwise a reason string."""
    if err is None:
        bad = {r: ds for r, ds in drawn.items()
               if expected_outcome(ds) != "exact"}
        return f"answered despite {bad}" if bad else None
    ds = drawn.get(err.route, [])
    if err.detail == "breaker open" or err.detail.startswith(
            "quarantined key"):
        want = "exact"
    else:
        want = type(err).__name__
    if expected_outcome(ds) != want:
        return (f"raised {type(err).__name__} ({err.detail[:80]}) on "
                f"{err.route} but drew {ds}")
    return None


# ------------------------------------------------------------ installation


def install(plan: ComputeFaultPlan) -> FaultComp:
    """Swap the guarded dispatch seam to a fault injector; returns it."""
    seam = FaultComp(plan)
    guard.install_seam(seam)
    return seam


def uninstall() -> None:
    guard.uninstall_seam()


@contextlib.contextmanager
def injected(plan: ComputeFaultPlan):
    seam = install(plan)
    try:
        yield seam
    finally:
        uninstall()
