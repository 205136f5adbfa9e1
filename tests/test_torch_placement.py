"""The port's QueryPlacement against the reference's decision model, on
injected measurements (the cases of tests/test_placement.py), and its
wiring into the port's Engine.

The port's model is the reference's "auto" mode and differs from it in
two ways only: the host device is torch.device("cpu") and exists only for
an engine on `cuda` (an engine on the CPU has nothing to place, like the
reference under JAX_PLATFORMS=cpu), and a probe's device error raises
typed instead of being swallowed. The reference's other two modes are
the port's defaults: an Engine without a placement stays on its device
("device"), and Engine(device="cpu") runs on the host ("host"). The
compiled route ignores placement, as the reference's does, so the Engine
cases here run the interpreter (execute_range_ref)."""

import numpy as np
import pytest
import torch

from m3_tpu.query.placement import QueryPlacement as JPlacement
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.query import placement as tp
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.testing import DictStorage, promql_corpus
from m3_tpu_torch.utils.instrument import ROOT

CUDA = torch.device("cuda")
HOST = torch.device("cpu")
CELLS = 10_000 * 447          # bench_promql's extended grid
RESULT = 10_000 * 110 * 4     # one f32 result plane


class _FakeDev:
    platform = "cpu"
    id = 0


def _mk(bw=None, rtt=0.003, host_rate=None, accel_rate=None):
    """A port model for an engine on the card, probe suppressed."""
    p = tp.QueryPlacement(CUDA)
    p._probed_at = float("inf")
    p._d2h_bw, p._rtt = bw, rtt
    p._host_rate, p._accel_rate = host_rate, accel_rate
    return p


def _ref(bw=None, rtt=0.003, host_rate=None, accel_rate=None):
    p = JPlacement()
    p._mode = "auto"
    p._cpu_checked = True
    p._cpu_device = _FakeDev()
    p._probed_at = float("inf")
    p._d2h_bw, p._rtt = bw, rtt
    p._host_rate, p._accel_rate = host_rate, accel_rate
    return p


# (bw, rtt, host_rate, accel_rate, cells, result_bytes): the reference's
# TestChoose cases under "auto" and a sweep around the break-even points.
CHOOSE_CASES = [
    (15e6, 0.003, None, None, CELLS, RESULT),      # slow link: host
    (5e9, 0.003, None, None, CELLS, RESULT),       # local: device
    (15e6, 0.003, None, None, CELLS, 110 * 4),     # tiny result
    (1e3, 0.003, None, None, CELLS, RESULT),       # a crawling link
    (1e12, 0.003, None, None, CELLS, RESULT),      # a free link
    (None, 0.003, None, None, CELLS, RESULT),      # never probed
] + [(bw, rtt, hr, ar, cells, cells // 447 * 110 * 4)
     for bw in (2e9, 20e9) for rtt in (1e-5, 3e-3)
     for hr, ar in ((None, None), (1e8, 1e10), (5e8, 2e8))
     for cells in (100, 10_000, 1_000_000, CELLS)]


@pytest.mark.parametrize("case", CHOOSE_CASES)
def test_choose_matches_reference(case):
    bw, rtt, hr, ar, cells, result = case
    got = _mk(bw, rtt, hr, ar).choose(cells, result)
    want = _ref(bw, rtt, hr, ar).choose(cells, result)
    assert (got is not None) == (want is not None)
    assert got is None or got == HOST


@pytest.mark.parametrize("obs", [
    (True, 1_000_000, 0, 0.01), (True, 1_000_000, 0, 0.02),
    (False, 1_000_000, 4_000_000, 0.05), (False, 1_000_000, 4_000_000, 0.04),
    (False, 0, 0, 0.0), (False, 4_470_000, 440_000, 0.0964),
    (True, 4_470_000, 440_000, 0.0007)])
@pytest.mark.parametrize("bw,rtt", [(100e6, 0.0), (None, 0.003), (2e9, 1e-4)])
def test_observe_matches_reference(obs, bw, rtt):
    host, cells, result, seconds = obs
    got, want = _mk(bw=bw, rtt=rtt), _ref(bw=bw, rtt=rtt)
    for _ in range(3):
        got.observe(HOST if host else None, cells, result, seconds)
        want.observe(_FakeDev() if host else None, cells, result, seconds)
    assert got._host_rate == want._host_rate
    assert got._accel_rate == want._accel_rate


def test_snapshot_keys_extend_the_reference():
    """Every key of the reference's snapshot but "mode" (the port has one
    mode, "auto")."""
    got = _mk(bw=50e6, host_rate=1e8).snapshot()
    want = _ref(bw=50e6, host_rate=1e8).snapshot()
    assert want.pop("mode") == "auto" and "mode" not in got
    assert {k: got[k] for k in want} == want
    assert got["placed_host"] == got["placed_device"] == 0


def test_ewma_matches_reference():
    from m3_tpu.query.placement import _ewma

    for old, new in ((None, 10.0), (10.0, 20.0), (3.5, -1.0)):
        assert tp._ewma(old, new) == _ewma(old, new)


def test_probe_guard_fresh_instance_even_early_in_uptime():
    p = tp.QueryPlacement(CUDA)
    assert p._claim_probe(1.0)
    assert p._probed_at == 1.0
    assert not p._claim_probe(1.0 + tp.PROBE_REFRESH_S / 2)
    assert p._claim_probe(1.0 + tp.PROBE_REFRESH_S + 1.0)


def test_probe_measures_rtt_and_bandwidth():
    """The probe's arithmetic on the device it is given (the CPU here; the
    card test runs it on `cuda`)."""
    p = tp.QueryPlacement(HOST)
    p._probe_link()
    assert p._rtt is not None and p._rtt > 0
    assert p._d2h_bw is not None and p._d2h_bw > 0
    rtt = p._rtt
    p._probe_link()              # fresh: no second probe
    assert p._rtt == rtt


def test_probe_device_error_raises_typed(monkeypatch):
    """The reference swallows every probe error; the port classifies a
    device fault and raises it."""
    p = tp.QueryPlacement(CUDA)

    def fault():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(p, "_measure", fault)
    with pytest.raises(guard.KernelFault):
        p.choose(CELLS, RESULT)
    assert p._d2h_bw is None


def test_probe_other_error_propagates(monkeypatch):
    p = tp.QueryPlacement(CUDA)

    def broken():
        raise ValueError("not a device fault")

    monkeypatch.setattr(p, "_measure", broken)
    with pytest.raises(ValueError):
        p.choose(CELLS, RESULT)


def test_placement_for_another_device_is_refused():
    series, _ = promql_corpus(4, 11)
    with pytest.raises(ValueError):
        Engine(DictStorage(series), device="cpu",
               placement=tp.QueryPlacement(CUDA))


def test_cpu_engine_never_places():
    series, t = promql_corpus(40, 11)
    eng = Engine(DictStorage(series), device="cpu",
                 placement=tp.QueryPlacement(HOST))
    before = ROOT.counter("query.placement.host").value()
    for q in ("rate(bench_metric[5m])", "deriv(bench_metric[5m])"):
        eng.execute_range_ref(q, int(t[30]), int(t[-1]), 30 * 10**9).values
    assert ROOT.counter("query.placement.host").value() == before
    snap = eng.placement_snapshot()
    assert snap["placed_host"] == 0 and snap["placed_device"] == 2


def test_device_mode_never_places_on_the_host(fake_card_engine):
    """The reference's "device" mode is the port's default: an engine on
    the card without a placement decides nothing and counts nothing."""
    from m3_tpu_torch.query import executor

    eng, _, _, _ = fake_card_engine
    default = executor.Engine(eng.storage)
    before = (ROOT.counter("query.placement.host").value(),
              ROOT.counter("query.placement.device").value())
    assert all(default._place(c, c) is None for c in (10, 10**6, 10**9))
    assert (ROOT.counter("query.placement.host").value(),
            ROOT.counter("query.placement.device").value()) == before
    assert default.placement_snapshot() is None
    assert default._route()["placement"] is None


class _Recorder:
    """Stands in for ops.temporal in the executor: records the device of
    every call and forwards to the real function on that device."""

    def __init__(self, real):
        self.real, self.devices = real, []

    def __getattr__(self, name):
        fn = getattr(self.real, name)
        if not callable(fn):
            return fn

        def call(*args, device=None, **kwargs):
            self.devices.append((name, device))
            return fn(*args, device=device, **kwargs)

        return call


@pytest.fixture()
def fake_card_engine(monkeypatch):
    """An Engine that believes it runs on `cuda` (the resolve is faked)
    with a placement whose measured link is so slow that every range
    evaluation is placed on the host and must reach ops.temporal with
    device="cpu"."""
    from m3_tpu_torch.query import executor

    series, t = promql_corpus(40, 11)
    cpu = Engine(DictStorage(series), device="cpu")
    monkeypatch.setattr(executor, "resolve", lambda device=None: CUDA)
    rec = _Recorder(executor.temporal)
    monkeypatch.setattr(executor, "temporal", rec)
    eng = Engine(DictStorage(series), placement=_mk(bw=1.0))
    return eng, rec, t, cpu


def test_placed_evaluation_runs_on_the_host(fake_card_engine):
    eng, rec, t, cpu = fake_card_engine
    before = ROOT.counter("query.placement.host").value()
    for q in ("rate(bench_metric[5m])", "quantile_over_time(0.9, "
              "bench_metric[5m])", "holt_winters(bench_metric[5m], 0.3, 0.6)",
              "sum_over_time(bench_metric[5m])"):
        got = eng.execute_range_ref(q, int(t[30]), int(t[-1]), 30 * 10**9)
        want = cpu.execute_range_ref(q, int(t[30]), int(t[-1]),
                                     30 * 10**9)
        np.testing.assert_array_equal(got.values, want.values)
    assert rec.devices and all(d == HOST for _, d in rec.devices)
    assert ROOT.counter("query.placement.host").value() == before + 4
    assert eng.placement_snapshot()["placed_host"] == 4
    assert eng._route()["placement"] == "host"
