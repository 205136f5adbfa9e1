"""The port's compute-fault plane (m3_tpu_torch.parallel.guard and
m3_tpu_torch.testing.faultcomp) on the CPU: seeded fault injection against
the guarded dispatch of every kernel route (codec.encode, codec.decode,
codec.hash, block.decode, temporal.*).

The port never falls back: where the reference's guard serves a twin, the
port's raises the typed ComputeError. So the campaigns here hold every call
to "the exact answer of a clean call, or a typed raise", never a corrupted
output; on the CPU the primary is the plain version, and the guard still
types and counts.

Cases of the reference's tests/test_compute_faults.py that live elsewhere
or do not apply, and why:
  * the fallback-equality campaigns (answers served by the XLA twin, the
    host codec or the eager path): the port has no fallback; each is
    replaced by an exact-or-typed-raise campaign over the same route;
  * the kill switch (`set_disabled`): struck with the fallback it chose;
  * the plan route (compiled plans, their quarantine and EXPLAIN
    surface): its campaigns are in tests/test_torch_plan_compile.py;
  * the aggregator flush (`agg_flush`): its campaign is in
    tests/test_torch_agg_flush.py;
  * the mesh flush encode (all-or-nothing `flush_encode`) and the
    agg_flush mesh campaign: in tests/test_torch_mesh_routes.py, under
    `attach([cpu] * 8)`;
  * the churn composition drill (TestComputeFaultChurn): in
    tests/test_torch_scenario.py, over the port's ComputeFaultChurnScenario."""

import inspect
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.testing import faultcomp as jfaultcomp
from m3_tpu_torch.ops import temporal, tsz
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.storage import block as blk
from m3_tpu_torch.storage import block_cache
from m3_tpu_torch.testing import faultcomp
from m3_tpu_torch.utils import hashing, hbm
from m3_tpu_torch.utils.hbm import HBMBudget
from m3_tpu_torch.utils.instrument import ROOT
from m3_tpu_torch.utils.retry import Breaker, BreakerOptions

CPU = "cpu"
S = 1_000_000_000


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    """Every test starts and ends on the real seam with fresh routes and
    a fresh block cache."""
    monkeypatch.setattr(block_cache, "_CACHE", block_cache.DeviceBlockCache(
        budget=HBMBudget(64 << 20), admit_after=2))
    faultcomp.uninstall()
    guard.reset()
    yield
    faultcomp.uninstall()
    guard.reset()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt


def _find_seed(route: str, want, n: int = 2, **rates) -> int:
    """A plan seed whose first n decisions on `route` equal `want`."""
    for seed in range(500):
        plan = faultcomp.ComputeFaultPlan(seed=seed, **rates)
        if plan.schedule(route, n) == list(want):
            return seed
    raise AssertionError(f"no seed gives {want} on {route}")


def _counter(snap, key) -> float:
    return snap.get(key, 0)


def _exact_or_typed(call, check, seam):
    """Run `call`: it must either raise the typed ComputeError its drawn
    decisions imply or return an answer `check` accepts when they imply
    one. Returns True when it answered."""
    mark = seam.mark()
    try:
        out = call()
    except guard.ComputeError as err:
        bad = faultcomp.unexplained(seam.since(mark), err)
        assert bad is None, bad
        return False
    bad = faultcomp.unexplained(seam.since(mark), None)
    assert bad is None, bad
    check(out)
    return True


# ---------------------------------------------------------------------------
# the schedule: the reference's, draw for draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,rates", [
    (0, dict(dispatch_raise=1.0)),
    (5, dict(dispatch_raise=0.25, oom=0.15, corrupt=0.2)),
    (11, dict(compile_fail=0.1, dispatch_raise=0.3, oom=0.2, delay=0.1,
              corrupt=0.1)),
    (29, dict(dispatch_raise=0.2, oom=0.1, delay=0.05, corrupt=0.2)),
])
def test_schedule_equals_reference(seed, rates):
    port = faultcomp.ComputeFaultPlan(seed=seed, **rates)
    ref = jfaultcomp.ComputeFaultPlan(seed=seed, **rates)
    for route in ("codec.encode", "codec.decode", "codec.hash",
                  "block.decode", "temporal.over_time", "temporal.rate"):
        assert port.schedule(route, 64) == ref.schedule(route, 64)
    assert faultcomp.NO_FAULT == jfaultcomp.NO_FAULT


class TestScheduleReplay:
    def test_decide_at_is_pure(self):
        plan = faultcomp.ComputeFaultPlan(seed=11, dispatch_raise=0.3,
                                          oom=0.2, corrupt=0.1)
        a = [plan.decide_at("r", i) for i in range(64)]
        b = [plan.decide_at("r", i) for i in reversed(range(64))]
        assert a == list(reversed(b))
        assert plan.schedule("r", 64) == a

    def test_schedule_varies_by_seed_and_route(self):
        mk = lambda s: faultcomp.ComputeFaultPlan(seed=s, dispatch_raise=0.5)
        assert mk(1).schedule("r", 64) != mk(2).schedule("r", 64)
        assert mk(1).schedule("r1", 64) != mk(1).schedule("r2", 64)

    def test_decision_log_equals_schedule(self):
        plan = faultcomp.ComputeFaultPlan(seed=5, dispatch_raise=0.25,
                                          oom=0.15, corrupt=0.2)
        never = BreakerOptions(window=64, failure_ratio=1.01,
                               min_samples=1000, cooldown_s=0.0)
        with faultcomp.injected(plan) as seam:
            for route in ("a.x", "a.y"):
                guard.configure(route, opts=never)
                for _ in range(20):
                    _exact_or_typed(
                        lambda: guard.dispatch(route, lambda: np.ones(2)),
                        lambda out: np.testing.assert_array_equal(
                            out, np.ones(2)), seam)
        for route in ("a.x", "a.y"):
            n = len(seam.decisions[route])
            assert n >= 20  # OOM retries draw fresh indices
            assert seam.decisions[route] == plan.schedule(route, n)
        assert seam.faults_injected == sum(
            1 for r in ("a.x", "a.y")
            for d in seam.decisions[r] if d != faultcomp.NO_FAULT)

    def test_route_filter_scopes_faults(self):
        plan = faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0,
                                          route_filter="codec.")
        with faultcomp.injected(plan) as seam:
            assert guard.dispatch("temporal.rate", lambda: 7) == 7
            with pytest.raises(guard.KernelFault):
                guard.dispatch("codec.hash", lambda: 7)
        assert "temporal.rate" not in seam.decisions
        assert seam.decisions["codec.hash"] == ["dispatch_raise"]


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------


class TestClassify:
    @pytest.mark.parametrize("kind,want", [
        ("compile_fail", guard.CompileError),
        ("dispatch_raise", guard.KernelFault),
        ("oom", guard.DeviceOOM)])
    def test_injected_kinds_map_to_taxonomy(self, kind, want):
        seam = faultcomp.FaultComp(faultcomp.ComputeFaultPlan(
            seed=0, **{kind: 1.0}))
        with pytest.raises(Exception) as info:
            seam.call("r", lambda: 1)
        assert not isinstance(info.value, guard.ComputeError)
        err = guard.classify(info.value, "r")
        assert type(err) is want and err.route == "r"
        assert err.cause is info.value

    def test_torch_exceptions_map_to_taxonomy(self):
        cases = [
            (torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB"),
             guard.DeviceOOM),
            (RuntimeError("CUDA error: out of memory"), guard.DeviceOOM),
            (RuntimeError("CUDA error: an illegal memory access was "
                          "encountered"), guard.KernelFault),
            (RuntimeError("CUDA error: device-side assert triggered"),
             guard.KernelFault),
            (RuntimeError("Error building extension 'm3_tpu_torch_kernels'"),
             guard.CompileError),
            (subprocess.CalledProcessError(1, ["ninja", "-v"]),
             guard.CompileError),
            (TimeoutError("dispatch timed out"), guard.DispatchTimeout),
            (RuntimeError("DEADLINE_EXCEEDED: collective"),
             guard.DispatchTimeout),
        ]
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None:
            cases.append((accel("CUDA error: unspecified launch failure"),
                          guard.KernelFault))
        for exc, want in cases:
            assert type(guard.classify(exc, "r")) is want, exc

    def test_program_bugs_are_not_device_faults(self):
        bugs = [ValueError("bad shape"), TypeError("nope"),
                ZeroDivisionError(), IndexError("index 9 is out of bounds"),
                RuntimeError("The size of tensor a (3) must match the size "
                             "of tensor b (4) at non-singleton dimension 1")]
        try:  # a host allocator failure is not a device fault either
            torch.empty(2**60, dtype=torch.uint8)
        except RuntimeError as exc:
            bugs.append(exc)
        for exc in bugs:
            assert guard.classify(exc, "r") is None, exc

    def test_compute_error_passthrough(self):
        e = guard.KernelFault("r", "x")
        assert guard.classify(e, "other") is e

    def test_unclassified_exception_reraises_through_dispatch(self):
        def bad():
            return torch.zeros(3) + torch.zeros(4)  # a real shape bug

        with pytest.raises(RuntimeError, match="must match"):
            guard.dispatch("r", bad)
        # ...and the probe slot was released: the breaker still works.
        assert guard.dispatch("r", lambda: 5) == 5
        assert guard.debug_snapshot()["r"]["state"] == Breaker.CLOSED

    def test_dispatch_takes_no_fallback(self):
        params = inspect.signature(guard.dispatch).parameters
        assert "fallback" not in params
        assert not hasattr(guard, "set_disabled")
        assert not hasattr(guard, "eager")


# ---------------------------------------------------------------------------
# breaker lifecycle
# ---------------------------------------------------------------------------


class TestBreakerLifecycle:
    OPTS = BreakerOptions(window=8, failure_ratio=0.5, min_samples=2,
                          cooldown_s=10.0)

    def test_trips_within_min_samples_then_raises_at_once(self):
        clock = FakeClock()
        guard.configure("t.trip", opts=self.OPTS, clock=clock)
        calls = {"n": 0}

        def primary():
            calls["n"] += 1
            return 1

        plan = faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)
        with faultcomp.injected(plan) as seam:
            for i in range(6):
                want = guard.KernelFault if i < 2 else guard.ComputeError
                with pytest.raises(want) as info:
                    guard.dispatch("t.trip", primary)
                if i >= 2:
                    assert "breaker open" in str(info.value)
        assert guard.debug_snapshot()["t.trip"]["state"] == Breaker.OPEN
        assert len(seam.decisions["t.trip"]) == 2  # the rest never dispatched
        assert calls["n"] == 0
        assert not guard.available("t.trip")

    def test_half_open_recovery_after_faults_clear(self):
        clock = FakeClock()
        guard.configure("t.rec", opts=self.OPTS, clock=clock)
        before = ROOT.snapshot()
        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            for _ in range(4):
                with pytest.raises(guard.ComputeError):
                    guard.dispatch("t.rec", lambda: 1)
        assert guard.debug_snapshot()["t.rec"]["state"] == Breaker.OPEN
        # While OPEN before the cooldown the dispatch raises, even clean.
        with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0)):
            with pytest.raises(guard.ComputeError, match="breaker open"):
                guard.dispatch("t.rec", lambda: 1)
        clock.advance(self.OPTS.cooldown_s + 1)  # -> half-open re-probe
        with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0)):
            assert guard.dispatch("t.rec", lambda: 1) == 1
        assert guard.debug_snapshot()["t.rec"]["state"] == Breaker.CLOSED
        assert guard.available("t.rec")
        after = ROOT.snapshot()
        for key, want in (
                ("telemetry.compute.trip_open{route=t.rec}", 1),
                ("telemetry.compute.trip_closed{route=t.rec}", 1),
                ("telemetry.compute.trips", 1),
                ("telemetry.compute.raised{route=t.rec}", 5),
                ("telemetry.compute.faults{kind=kernel,route=t.rec}", 2)):
            assert _counter(after, key) - _counter(before, key) == want, key

    def test_available_does_not_consume_probe_slot(self):
        clock = FakeClock()
        guard.configure("t.avail", opts=self.OPTS, clock=clock)
        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            for _ in range(4):
                with pytest.raises(guard.ComputeError):
                    guard.dispatch("t.avail", lambda: 1)
        clock.advance(self.OPTS.cooldown_s + 1)
        for _ in range(10):  # half-open now; reads must not burn the probe
            guard.available("t.avail")
        assert guard.dispatch("t.avail", lambda: 1) == 1
        assert guard.debug_snapshot()["t.avail"]["state"] == Breaker.CLOSED

    def test_slow_dispatch_keeps_answer_but_counts_against_breaker(self):
        guard.configure("t.slow", opts=self.OPTS, timeout_s=0.005)
        plan = faultcomp.ComputeFaultPlan(seed=0, delay=1.0, delay_s=0.02)
        before = ROOT.snapshot()
        with faultcomp.injected(plan):
            for _ in range(2):
                assert guard.dispatch("t.slow", lambda: 41) == 41
        assert guard.debug_snapshot()["t.slow"]["state"] == Breaker.OPEN
        after = ROOT.snapshot()
        key = "telemetry.compute.faults{kind=timeout,route=t.slow}"
        assert _counter(after, key) - _counter(before, key) == 2


# ---------------------------------------------------------------------------
# OOM: reclaim_pass, then one retry
# ---------------------------------------------------------------------------


class TestOOMReclaimThenRetry:
    def test_oom_reclaim_pass_then_retries_once(self, monkeypatch):
        seed = _find_seed("t.oom", ["oom", "ok"], oom=0.5)
        evictions = {"n": 0}
        passes = {"n": 0}

        def evict_one():
            evictions["n"] += 1
            return 4096

        budget = hbm.shared_budget()
        real_pass = budget.reclaim_pass

        def counted_pass():
            passes["n"] += 1
            return real_pass()

        monkeypatch.setattr(budget, "reclaim_pass", counted_pass)
        # Under budget on the host ledger: reclaim() frees nothing, so the
        # guard must force the pass.
        budget.register("test-compute-oom", lambda: 0, evict_one)
        before = ROOT.snapshot()
        try:
            plan = faultcomp.ComputeFaultPlan(seed=seed, oom=0.5)
            with faultcomp.injected(plan) as seam:
                out = guard.dispatch("t.oom", lambda: torch.full((3,), 7.0))
            assert seam.decisions["t.oom"] == ["oom", "ok"]
        finally:
            budget.unregister("test-compute-oom")
        assert torch.equal(out, torch.full((3,), 7.0))
        assert passes["n"] == 1 and evictions["n"] >= 1
        after = ROOT.snapshot()
        key = "telemetry.compute.oom_reclaims{route=t.oom}"
        assert _counter(after, key) - _counter(before, key) == 1
        assert _counter(after, "telemetry.compute.oom_reclaimed_bytes") \
            - _counter(before, "telemetry.compute.oom_reclaimed_bytes") >= 4096
        assert guard.debug_snapshot()["t.oom"]["state"] == Breaker.CLOSED

    def test_double_oom_raises_device_oom(self):
        seed = _find_seed("t.oom2", ["oom", "oom"], oom=0.9)
        plan = faultcomp.ComputeFaultPlan(seed=seed, oom=0.9)
        with faultcomp.injected(plan) as seam:
            with pytest.raises(guard.DeviceOOM):
                guard.dispatch("t.oom2", lambda: 1)
        assert seam.decisions["t.oom2"] == ["oom", "oom"]

    def test_kernel_fault_is_not_retried(self):
        # The OOM retry is the only retry: a kernel fault raises after
        # one attempt even when the next draw would have succeeded.
        seed = _find_seed("t.oom3", ["dispatch_raise", "ok"],
                          dispatch_raise=0.5)
        with faultcomp.injected(faultcomp.ComputeFaultPlan(
                seed=seed, dispatch_raise=0.5)) as seam:
            with pytest.raises(guard.KernelFault):
                guard.dispatch("t.oom3", lambda: 1)
        assert seam.decisions["t.oom3"] == ["dispatch_raise"]

    def test_route_defaults_are_the_module_constants(self):
        r = guard.configure("t.defaults")
        assert r.timeout_s == guard.TIMEOUT_S
        assert r.quarantine_ttl_s == guard.QUARANTINE_TTL_S
        assert r.breaker.opts.cooldown_s == guard.COOLDOWN_S

    def test_reclaim_pass_evicts_one_entry_per_tenant(self):
        budget = HBMBudget(1 << 30)
        held = {"a": [100, 200], "b": [50]}

        def evictor(name):
            def evict():
                return held[name].pop() if held[name] else 0
            return evict

        for name in held:
            budget.register(name, lambda n=name: sum(held[n]), evictor(name))
        assert budget.reclaim() == 0  # under budget: nothing to do
        assert budget.reclaim_pass() == 250
        assert held == {"a": [100], "b": []}
        assert budget.reclaim_pass() == 100
        assert budget.reclaim_pass() == 0


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------


class TestQuarantine:
    def test_faulting_key_is_quarantined_and_raises_at_once(self):
        clock = FakeClock()
        guard.configure("t.q", clock=clock, quarantine_ttl_s=100.0)
        evicted = {"n": 0}
        attempts = {"n": 0}

        def primary():
            attempts["n"] += 1
            return 1

        plan = faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)
        before = ROOT.snapshot()
        with faultcomp.injected(plan) as seam:
            for _ in range(5):
                with pytest.raises(guard.KernelFault):
                    guard.dispatch(
                        "t.q", primary, key=("bucket", 1),
                        evict=lambda: evicted.__setitem__(
                            "n", evicted["n"] + 1))
        assert len(seam.decisions["t.q"]) == 1
        assert evicted["n"] == 1 and attempts["n"] == 0
        assert guard.is_quarantined("t.q", ("bucket", 1))
        assert guard.quarantined_keys("t.q") == [("bucket", 1)]
        after = ROOT.snapshot()
        key = "telemetry.compute.quarantined{route=t.q}"
        assert _counter(after, key) - _counter(before, key) == 1

    def test_quarantine_ttl_expires(self):
        clock = FakeClock()
        guard.configure("t.qttl", clock=clock, quarantine_ttl_s=50.0)
        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            with pytest.raises(guard.KernelFault):
                guard.dispatch("t.qttl", lambda: 1, key="k")
        assert guard.is_quarantined("t.qttl", "k")
        clock.advance(51.0)
        assert not guard.is_quarantined("t.qttl", "k")
        assert guard.quarantined_keys("t.qttl") == []
        with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0)):
            assert guard.dispatch("t.qttl", lambda: 1, key="k") == 1

    def test_evict_exception_does_not_mask_the_typed_raise(self):
        def bad_evict():
            raise RuntimeError("cache refused")

        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            with pytest.raises(guard.KernelFault):
                guard.dispatch("t.qe", lambda: 1, key="k", evict=bad_evict)
        assert guard.is_quarantined("t.qe", "k")


# ---------------------------------------------------------------------------
# corrupted output planes
# ---------------------------------------------------------------------------


class TestCorruptionValidator:
    def test_poisoned_detects_nan_and_garbage_planes(self):
        g = guard.GARBAGE_I
        for bad in (np.full(8, np.nan), np.full(8, guard.GARBAGE_F),
                    np.full(8, g, np.int32), torch.full((8,), float("nan")),
                    torch.full((2, 3), guard.GARBAGE_F, dtype=torch.float64),
                    torch.full((4,), g, dtype=torch.int32),
                    torch.full((4,), g, dtype=torch.int64),
                    {"a": torch.ones(2), "b": (torch.full((2,), g),)}):
            assert guard.poisoned(bad) is not None, bad
        for good in ((np.ones(4), np.zeros(4)), torch.arange(4),
                     np.array([1.0, np.nan, 2.0]),  # one NaN sample is data
                     torch.tensor([True, True]), torch.zeros(0)):
            assert guard.poisoned(good) is None, good

    def test_poison_tree_keeps_shape_dtype_and_bools(self):
        out = (torch.ones(2, 3), torch.arange(4, dtype=torch.int32),
               torch.tensor([True]), np.arange(3, dtype=np.uint8), "tag")
        for mode in ("nan", "garbage"):
            bad = faultcomp._poison_tree(out, mode)
            for a, b in zip(out[:4], bad[:4]):
                assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(bad[2], out[2]) and bad[4] == "tag"
            assert guard.poisoned(bad) is not None

    def test_corrupt_fault_raises_never_returns(self):
        plan = faultcomp.ComputeFaultPlan(seed=1, corrupt=1.0)
        before = ROOT.snapshot()
        with faultcomp.injected(plan):
            with pytest.raises(guard.KernelFault, match="corrupted output"):
                guard.dispatch("t.c", lambda: (torch.ones(4),
                                               torch.arange(4)))
        after = ROOT.snapshot()
        key = "telemetry.compute.faults{kind=kernel,route=t.c}"
        assert _counter(after, key) - _counter(before, key) == 1

    def test_validator_inert_without_seam(self):
        out = guard.dispatch("t.cv", lambda: torch.full((4,), float("nan")))
        assert torch.isnan(out).all()


# ---------------------------------------------------------------------------
# campaigns over the port's routes: exact, or a typed raise
# ---------------------------------------------------------------------------

MIXED = dict(dispatch_raise=0.2, oom=0.1, delay=0.05, corrupt=0.2,
             delay_s=0.001)
KINDS = [dict(compile_fail=1.0), dict(dispatch_raise=1.0), dict(oom=1.0),
         dict(delay=1.0, delay_s=0.001), dict(corrupt=1.0), MIXED]


def _corpus(seed, n, w):
    rng = np.random.default_rng(seed)
    base = np.int64(1_700_000_000)
    ts = base + np.arange(w, dtype=np.int64)[None, :] * 10 \
        + rng.integers(0, 2, (n, w))
    ts = np.sort(ts, axis=1)
    vals = np.where(rng.random((n, w)) < 0.05, np.nan,
                    np.round(rng.normal(100, 10, (n, w)), 2))
    npoints = rng.integers(1, w + 1, n).astype(np.int32)
    return ts, vals, npoints


def _campaign(plan_kw, route_filter, seed, calls, check, rounds):
    """Run `calls` `rounds` times under the plan: each call is exact or
    raises typed. Returns (answers, raises, seam)."""
    plan = faultcomp.ComputeFaultPlan(seed=seed, route_filter=route_filter,
                                      **plan_kw)
    answered = raised = 0
    with faultcomp.injected(plan) as seam:
        for _ in range(rounds):
            for call in calls:
                if _exact_or_typed(call, check, seam):
                    answered += 1
                else:
                    raised += 1
    return answered, raised, seam


def _assert_outcomes(plan_kw, answered, raised):
    always_faults = any(plan_kw.get(k) == 1.0 for k in
                        ("compile_fail", "dispatch_raise", "oom", "corrupt"))
    if always_faults:
        assert answered == 0 and raised > 0
    if plan_kw.get("delay") == 1.0:
        assert raised == 0 and answered > 0


@pytest.mark.parametrize("kinds", KINDS)
def test_codec_encode_decode_exact_or_typed_under_faults(kinds):
    ts, vals, npoints = _corpus(31, 16, 16)
    inp = tsz.prepare_encode_inputs(ts, vals, npoints)
    args = {k: inp[k] for k in ("dt", "t0", "v", "int_mode", "k", "npoints",
                                "ts_regular", "delta0")}
    mw = tsz.max_words_for(16)
    ow, onb = tsz.encode_batch(**args, max_words=mw, device=CPU)
    ots, ovals = tsz.decode_plane(ow, npoints, window=16, device=CPU)

    def check(out):
        if len(out) == 2 and out[0].dtype == torch.int32:
            assert torch.equal(out[0], ow) and torch.equal(out[1], onb)
        else:
            assert torch.equal(out[0], ots)
            assert torch.equal(out[1].view(torch.int64),
                               ovals.view(torch.int64))

    calls = [lambda: tsz.encode_batch(**args, max_words=mw, device=CPU),
             lambda: tsz.decode_plane(ow, npoints, window=16, device=CPU)]
    answered, raised, seam = _campaign(kinds, "codec.", 3, calls, check, 4)
    _assert_outcomes(kinds, answered, raised)
    assert seam.decisions.get("codec.encode") and \
        seam.decisions.get("codec.decode")


@pytest.mark.parametrize("kinds", [dict(dispatch_raise=1.0),
                                   dict(corrupt=1.0), MIXED])
def test_hash_exact_or_typed_under_faults(kinds):
    rng = np.random.default_rng(7)
    ids = [bytes(rng.integers(0, 256, ln, dtype=np.uint8))
           for ln in rng.integers(1, 33, 64)]
    ref = torch.tensor([hashing.murmur3_32(i) for i in ids])

    def check(out):
        assert torch.equal(out, ref)

    answered, raised, seam = _campaign(
        kinds, "codec.hash", 9,
        [lambda: hashing.hash_batch(ids, device=CPU)], check, 6)
    _assert_outcomes(kinds, answered, raised)
    assert seam.decisions.get("codec.hash")


@pytest.mark.parametrize("kinds", [dict(dispatch_raise=1.0),
                                   dict(corrupt=1.0), MIXED])
def test_block_reads_exact_or_typed_under_faults(kinds):
    ts, vals, npoints = _corpus(41, 8, 8)
    ts = ts * S
    b = blk.encode_block(0, np.arange(8, dtype=np.int32), ts, vals, npoints,
                         device=CPU)
    o_ts, o_vals, o_np = b.read_all()

    def check(out):
        if len(out) == 3:
            np.testing.assert_array_equal(out[0], o_ts)
            np.testing.assert_array_equal(out[1].view(np.uint64),
                                          o_vals.view(np.uint64))
            np.testing.assert_array_equal(out[2], o_np)
        else:
            n = int(npoints[3])
            np.testing.assert_array_equal(out[0], ts[3, :n])
            np.testing.assert_array_equal(out[1].view(np.uint64),
                                          vals[3, :n].view(np.uint64))

    def fresh_read_all():
        # A new block each call: no cache residency short-cuts the decode.
        return blk.encode_block(0, np.arange(8, dtype=np.int32), ts, vals,
                                npoints, device=CPU).read_all()

    answered, raised, seam = _campaign(
        kinds, "block.decode", 13, [fresh_read_all, lambda: b.read(3)],
        check, 3)
    _assert_outcomes(kinds, answered, raised)
    assert seam.decisions.get("block.decode")


@pytest.mark.parametrize("kinds", [dict(dispatch_raise=0.5, corrupt=0.3),
                                   dict(corrupt=1.0), MIXED])
def test_temporal_builders_exact_or_typed_under_faults(kinds):
    rng = np.random.default_rng(3)
    grid = np.cumsum(rng.poisson(5.0, (6, 40)), axis=1).astype(np.float64)
    grid[rng.random(grid.shape) < 0.1] = np.nan
    finite = torch.from_numpy(rng.random((4, 32)) > 0.3)
    calls = {
        "temporal.last_two_idx": lambda: temporal._last_two_idx_fn(8)(finite),
        "temporal.rate": lambda: temporal.rate(grid, 10, 10 * S, 100 * S,
                                               device=CPU),
        "temporal.over_time": lambda: temporal.over_time(
            grid, 10, "max", device=CPU),
        "temporal.over_time_finish": lambda: temporal.over_time(
            grid, 10, "sum", finish="device", device=CPU),
    }
    clean = {route: call() for route, call in calls.items()}

    for route, call in calls.items():
        want = clean[route]

        def check(out, want=want):
            if isinstance(want, torch.Tensor):
                assert torch.equal(out, want)
            else:
                np.testing.assert_array_equal(out, want)

        answered, raised, seam = _campaign(kinds, "temporal.", 2, [call],
                                           check, 6)
        _assert_outcomes(kinds, answered, raised)
        assert any(d != faultcomp.NO_FAULT
                   for d in seam.decisions.get(route, [])), route
        guard.reset()


def test_nested_route_error_passes_through_untouched():
    """A typed error raised by a guarded route nested in a primary (the
    block decode runs the codec decode) passes through the outer route as
    it is: counted and charged to a breaker once, where it happened."""
    guard.configure("t.outer", opts=BreakerOptions(
        window=4, failure_ratio=0.5, min_samples=1, cooldown_s=60.0))
    before = ROOT.snapshot()
    with faultcomp.injected(faultcomp.ComputeFaultPlan(
            seed=0, dispatch_raise=1.0, route_filter="t.inner")):
        with pytest.raises(guard.KernelFault) as info:
            guard.dispatch("t.outer",
                           lambda: guard.dispatch("t.inner", lambda: 1))
    assert info.value.route == "t.inner"
    snap = guard.debug_snapshot()
    assert snap["t.outer"]["state"] == Breaker.CLOSED
    assert guard.dispatch("t.outer", lambda: 2) == 2
    after = ROOT.snapshot()
    key = "telemetry.compute.faults{kind=kernel,route=%s}"
    assert _counter(after, key % "t.inner") \
        - _counter(before, key % "t.inner") == 1
    assert _counter(after, key % "t.outer") \
        - _counter(before, key % "t.outer") == 0


def test_block_decode_d2h_fault_is_typed_and_counted_once(monkeypatch):
    """A device fault in the D2H copy that ends block.decode's primary,
    after the nested codec.decode answered: typed KernelFault of the
    block.decode route, one fault counted there and none on codec.decode
    (the route's port meaning, ROADMAP C2)."""
    ts, vals, npoints = _corpus(43, 8, 8)
    b = blk.encode_block(0, np.arange(8, dtype=np.int32), ts * S, vals,
                         npoints, device=CPU)
    real = tsz.decode_plane

    class _FaultyCopy:
        def __init__(self, t):
            self.t = t

        def cpu(self):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    def decode_then_fault(*a, **k):
        out_ts, out_vals = real(*a, **k)
        return _FaultyCopy(out_ts), out_vals

    monkeypatch.setattr(blk.tsz, "decode_plane", decode_then_fault)
    before = ROOT.snapshot()
    with pytest.raises(guard.KernelFault) as info:
        b.read_all()
    assert info.value.route == "block.decode"
    after = ROOT.snapshot()
    key = "telemetry.compute.faults{kind=kernel,route=%s}"
    assert _counter(after, key % "block.decode") \
        - _counter(before, key % "block.decode") == 1
    assert _counter(after, key % "codec.decode") \
        == _counter(before, key % "codec.decode")
    guard.reset()


def test_builder_forwarding_survives_guard():
    assert temporal._last_two_idx_fn.cache_info is not None
    assert isinstance(temporal._last_two_idx_fn(8), guard._GuardedFn)
    assert isinstance(temporal._rate_fn(10, 10.0, 100.0, True, True),
                      guard._GuardedFn)


def test_quarantined_key_raises_before_the_primary():
    """A quarantined key raises typed without running the primary: the
    plain version is never called in its place."""
    guard.configure("t.kq", quarantine_ttl_s=100.0)
    with faultcomp.injected(faultcomp.ComputeFaultPlan(seed=0, oom=1.0)):
        with pytest.raises(guard.DeviceOOM):
            guard.dispatch("t.kq", lambda: 1, key="shape")
    ran = []
    with pytest.raises(guard.KernelFault, match="quarantined"):
        guard.dispatch("t.kq", lambda: ran.append(1), key="shape")
    assert ran == []


# ---------------------------------------------------------------------------
# degradation surfaces
# ---------------------------------------------------------------------------


class TestDegradationSurfaces:
    def test_tripped_breaker_reads_degraded_never_shedding(self):
        from m3_tpu_torch.utils import health

        guard.configure("t.h", opts=BreakerOptions(
            window=8, failure_ratio=0.5, min_samples=2, cooldown_s=60.0))
        assert guard._degradation() == 0.0
        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            for _ in range(4):
                with pytest.raises(guard.ComputeError):
                    guard.dispatch("t.h", lambda: 1)
        sat = guard._degradation()
        tracker = health.HealthTracker()
        assert tracker.degraded_at <= sat < tracker.shedding_at
        assert "compute_degraded" in health.TRACKER._sources

    def test_debug_snapshot_names_state_quarantine_and_counts(self):
        guard.configure("t.d", opts=BreakerOptions(
            window=8, failure_ratio=0.5, min_samples=2, cooldown_s=60.0))
        assert guard.dispatch("t.d", lambda: 1) == 1
        with faultcomp.injected(
                faultcomp.ComputeFaultPlan(seed=0, dispatch_raise=1.0)):
            for i in range(4):
                with pytest.raises(guard.ComputeError):
                    guard.dispatch("t.d", lambda: 1, key=("shape", i))
        snap = guard.debug_snapshot()["t.d"]
        assert snap["state"] == Breaker.OPEN
        # One success and one fault are 2 samples at ratio 0.5: the first
        # fault trips the breaker, and the later dispatches raise at
        # allow() without reaching the seam, so only shape 0 is held.
        assert snap["quarantined"] == [repr(("shape", 0))]
        counts = snap["counts"]
        assert counts["primary"] >= 1 and counts["raised"] >= 4
        assert counts["faults.kernel"] >= 1 and counts["trip_open"] >= 1


@pytest.mark.parametrize("drawn,err,ok", [
    ({"r": ["ok", "delay"]}, None, True),
    ({"r": ["oom", "ok"]}, None, True),
    ({"r": ["corrupt"]}, None, False),
    ({"r": ["oom", "oom"]}, guard.DeviceOOM("r", "x"), True),
    ({"r": ["oom", "corrupt"]}, guard.KernelFault("r", "x"), True),
    ({"r": ["compile_fail"]}, guard.CompileError("r", "x"), True),
    ({"r": ["dispatch_raise"]}, guard.DeviceOOM("r", "x"), False),
    ({"r": ["ok"]}, guard.KernelFault("r", "x"), False),
    ({"r": ["dispatch_raise", "ok"]}, guard.KernelFault("r", "x"), False),
    ({"r": ["oom"]}, guard.DeviceOOM("r", "x"), False),
    ({}, guard.ComputeError("r", "breaker open"), True),
    ({"o": ["corrupt"], "r": ["dispatch_raise"]},
     guard.KernelFault("r", "x"), True),
    ({"r": ["dispatch_raise"]}, guard.ComputeError("r", "breaker open"),
     False),
])
def test_unexplained_outcomes(drawn, err, ok):
    """The outcome contract the campaigns hold each call to: a raise the
    drawn decisions do not explain, or an answer despite a raising
    decision, is named."""
    assert (faultcomp.unexplained(drawn, err) is None) == ok
