"""The port's runtime numerics witness (m3_tpu_torch/utils/numwatch.py)
and its gate, `python -m m3_tpu_torch.analysis.witness numerics`: the
reference's tests/test_numerics_witness.py on the port — live-lane
NaN/inf trips, padding-lane value trips, masked-pad passes, the
aggregator's count-0 zero convention, the dump round trip, the statically
derived acceptance set (m3_tpu_torch/analysis/numeric_rules
.accepted_witness, equal to the reference's), the gate's exit codes, and
the compiled-plan and flush observation points on the CPU."""

import contextlib
import io
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

from m3_tpu.analysis import numeric_rules as ref_numeric_rules
from m3_tpu_torch.analysis import numeric_rules, witness as gate
from m3_tpu_torch.utils import numwatch

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def witness():
    numwatch.install()
    numwatch.reset()
    yield numwatch
    numwatch.reset()
    numwatch.uninstall()


def kinds(w):
    return sorted((f["site"], f["kind"]) for f in w.findings())


class TestObserveResult:
    def test_masked_pad_passes(self, witness):
        # the contract shape: live lanes finite, padding rows all-NaN
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert witness.findings() == []
        assert witness.observed_count() == 1

    @pytest.mark.parametrize("value,kind", [(np.nan, "nan-live"),
                                            (np.inf, "inf-live")])
    def test_non_finite_in_live_lane_trips(self, witness, value, kind):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[2, 3] = value
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", kind)]

    def test_padding_lane_value_trips(self, witness):
        # a finite value in a padding ROW: the unmasked-gather leak
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[6, 2] = 42.0
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "pad-finite")]

    def test_pad_row_pad_column_leak_trips(self, witness):
        plane = np.full((8, 16), np.nan)
        plane[:5, :12] = 1.5
        plane[6, 14] = 42.0  # pad row x pad column
        witness.observe_result("plan", plane, live_rows=5, live_cols=12)
        assert kinds(witness) == [("plan", "pad-finite")]

    def test_column_padding_is_time_slack_not_a_finding(self, witness):
        plane = np.full((1, 16), np.nan)
        plane[0, :12] = 1.0
        plane[0, 14] = 1.0  # pad column, finite: sliced by the host
        witness.observe_result("plan", plane, live_rows=1, live_cols=12)
        assert witness.findings() == []

    def test_counts_aggregate_per_site_kind(self, witness):
        plane = np.full((4, 4), np.nan)
        plane[0, 0] = np.inf
        witness.observe_result("plan", plane, live_rows=1, live_cols=4)
        witness.observe_result("plan", plane, live_rows=1, live_cols=4)
        (f,) = [f for f in witness.findings() if f["kind"] == "inf-live"]
        assert f["count"] == 2

    def test_disabled_witness_is_free(self):
        numwatch.uninstall()
        numwatch.reset()
        numwatch.observe_result("plan", np.full((2, 2), np.inf))
        assert numwatch.findings() == []
        assert numwatch.observed_count() == 0


class TestObserveRows:
    def test_count0_zero_convention_passes(self, witness):
        vals = np.array([[1.0, 2.0], [0.0, 0.0]])
        witness.observe_rows("agg_flush", vals, np.array([True, False]))
        assert witness.findings() == []

    def test_pad_nonzero_trips(self, witness):
        vals = np.array([[1.0, 2.0], [0.0, 7.0]])
        witness.observe_rows("agg_flush", vals, np.array([True, False]))
        assert kinds(witness) == [("agg_flush", "pad-nonzero")]


class TestAggFlushHookEndToEnd:
    """The real observation point: exact_quantile_values on the CPU with
    the witness armed."""

    def test_clean_buckets_observe_no_findings(self, witness):
        from m3_tpu_torch.parallel import agg_flush

        buckets = [np.array([3.0, 1.0, 2.0]), np.array([]),
                   np.array([5.0])]
        counts = np.array([3, 0, 1])
        vals = agg_flush.exact_quantile_values(buckets, counts, (0.5, 0.99),
                                               device="cpu")
        assert witness.observed_count() >= 1
        assert (vals[1] == 0.0).all()
        assert [f for f in witness.findings()
                if f["kind"] in ("pad-nonzero", "inf-live")] == []

    def test_nan_bucket_records_accepted_nan_live(self, witness):
        from m3_tpu_torch.parallel import agg_flush

        agg_flush.exact_quantile_values([np.array([np.nan, np.nan])],
                                        np.array([2]), (0.99,), device="cpu")
        assert ("agg_flush", "nan-live") in kinds(witness)
        # ... and the static pass ACCEPTS that kind at that site
        accepted = numeric_rules.accepted_witness(
            str(REPO / "m3_tpu_torch"))
        assert ("agg_flush", "nan-live") in accepted


class TestAcceptedSet:
    def test_accepted_set_is_derived_not_listed(self):
        accepted = numeric_rules.accepted_witness(
            str(REPO / "m3_tpu_torch"))
        # NaN-as-missing is provable at both sites; the padding kinds
        # are NEVER accepted anywhere.
        assert ("plan", "nan-live") in accepted
        assert ("agg_flush", "nan-live") in accepted
        assert not any(k in ("pad-finite", "pad-nonzero")
                       for _s, k in accepted)

    def test_accepted_set_equals_the_reference_s(self):
        assert numeric_rules.accepted_witness(
            str(REPO / "m3_tpu_torch")) == \
            ref_numeric_rules.accepted_witness(str(REPO / "m3_tpu"))

    def test_unaccepted_filter(self):
        witnessed = [
            {"site": "plan", "kind": "nan-live", "count": 3, "detail": ""},
            {"site": "plan", "kind": "pad-finite", "count": 1,
             "detail": ""},
        ]
        bad = numwatch.unaccepted(witnessed, {("plan", "nan-live")})
        assert [f["kind"] for f in bad] == ["pad-finite"]


def _check(tmp_path, payload=None):
    """`python -m m3_tpu_torch.analysis.witness numerics DIR` through its
    main(): (returncode, stdout)."""
    if payload is not None:
        (tmp_path / "numerics-1.json").write_text(json.dumps(payload))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = gate.main(["numerics", str(tmp_path)])
    return types.SimpleNamespace(returncode=rc, stdout=out.getvalue())


class TestDumpAndGate:
    def test_dump_round_trip(self, witness, tmp_path):
        plane = np.full((4, 4), np.nan)
        plane[:2, :] = 1.0   # live lanes clean
        plane[3, 0] = 5.0    # the padding-row leak
        witness.observe_result("plan", plane, live_rows=2, live_cols=4)
        path = witness.dump_now(str(tmp_path / "numerics-1.json"))
        payload = json.loads(pathlib.Path(path).read_text())
        assert payload["observed"] == 1
        assert payload["findings"][0]["kind"] == "pad-finite"
        # the dump the witness wrote fails the gate hard
        assert _check(tmp_path).returncode == 2

    def test_check_green_on_accepted_findings(self, tmp_path):
        proc = _check(tmp_path, {
            "pid": 1, "observed": 5,
            "findings": [{"site": "plan", "kind": "nan-live", "count": 4,
                          "detail": "NaN in live lanes"}]})
        assert proc.returncode == 0, proc.stdout

    def test_check_fails_hard_on_padding_violation(self, tmp_path):
        proc = _check(tmp_path, {
            "pid": 1, "observed": 5,
            "findings": [{"site": "plan", "kind": "pad-finite", "count": 1,
                          "detail": "finite value in padding rows"}]})
        assert proc.returncode == 2, proc.stdout
        assert "PADDING CONTRACT VIOLATION" in proc.stdout

    def test_check_fails_on_unaccepted_site_kind(self, tmp_path):
        proc = _check(tmp_path, {
            "pid": 1, "observed": 5,
            "findings": [{"site": "agg_flush", "kind": "inf-live",
                          "count": 1, "detail": "inf in live rows"}]})
        assert proc.returncode == 1, proc.stdout
        assert "UNACCEPTED" in proc.stdout

    def test_check_refuses_vacuous_pass(self, tmp_path):
        proc = _check(tmp_path, {"pid": 1, "observed": 0, "findings": []})
        assert proc.returncode == 2
        assert "vacuous" in proc.stdout

    def test_check_refuses_an_empty_dump_dir(self, tmp_path):
        assert _check(tmp_path).returncode == 2

    def test_cli_entry_point(self, tmp_path):
        (tmp_path / "numerics-1.json").write_text(json.dumps({
            "pid": 1, "observed": 2,
            "findings": [{"site": "plan", "kind": "nan-live", "count": 1,
                          "detail": ""}]}))
        proc = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.analysis.witness",
             "numerics", str(tmp_path)],
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "numerics: OK" in proc.stdout


class TestPlanHookEndToEnd:
    """The compiled-plan observation point through the port's executor on
    the CPU: compiled queries under the witness observe padded planes,
    and every finding stays inside the static-accepted set."""

    def test_compiled_queries_witnessed_within_accepted(self, witness,
                                                        monkeypatch):
        from test_plan_compile import END, START, STEP, make_storage

        from m3_tpu_torch.query import plan as qplan
        from m3_tpu_torch.query.executor import Engine

        monkeypatch.setattr(qplan, "PLAN_MIN_CELLS", 1)
        eng = Engine(make_storage(7), device="cpu")
        # one query per padded-output family: grouped exact sum (group
        # rows pad), rangefunc root (series rows pad), vv binary
        # (match-row pad), topk (masked winners + host row filter)
        for q in ("sum by (host) (m)", "rate(m[5m])",
                  "m * on(host, i) b", "topk(2, m)"):
            eng.execute_range(q, START, END, STEP)
            assert eng.last_route()["route"] == "compiled", q
        assert witness.observed_count() >= 4
        accepted = numeric_rules.accepted_witness(
            str(REPO / "m3_tpu_torch"))
        bad = numwatch.unaccepted(witness.findings(), accepted)
        assert bad == [], f"witnessed findings outside accepted: {bad}"
