"""The port's lock-order witness (m3_tpu_torch/utils/lockdep.py) against
the reference's (m3_tpu/utils/lockdep.py): the graph's recording, online
cycle detection and block-time flagging, the witnessed-lock proxy with
Condition waits, the env-gated install in a child process, and the site
names, which must be the reference's for the counterpart classes, the
block times the port adds to the dump, and the reference's cases for
scripts/lockdep_check.py run against the port's counterpart,
`python -m m3_tpu_torch.analysis.witness lockdep` (the static lock graph
of m3_tpu_torch/ and the port's reconcile ledger), exit codes included."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import m3_tpu.utils.lockdep as jld
import m3_tpu_torch.utils.lockdep as ld
from m3_tpu_torch.utils.lockdep import LockdepGraph, _WitnessedLock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestGraph:
    def test_nested_acquire_records_innermost_edge(self):
        g = LockdepGraph()
        a, b, c = object(), object(), object()
        g.on_acquire("A", a, False, "x:1")
        g.on_acquire("B", b, False, "x:2")
        g.on_acquire("C", c, True, "x:3")
        assert ("A", "B") in g.edges
        assert ("B", "C") in g.edges
        assert ("A", "C") not in g.edges  # innermost-held only
        assert g.edges[("B", "C")]["blocked"] == 1
        g.on_release("C", c)
        g.on_release("B", b)
        g.on_release("A", a)
        assert g._held() == []

    def test_reentrant_same_object_records_nothing(self):
        g = LockdepGraph()
        a = object()
        g.on_acquire("A", a, False, "x:1")
        g.on_acquire("A", a, False, "x:2")
        assert g.edges == {}
        g.on_release("A", a)
        g.on_release("A", a)
        assert g._held() == []

    def test_abba_is_a_witnessed_cycle(self):
        g = LockdepGraph()
        a, b = object(), object()
        g.on_acquire("A", a, False, "t1:1")
        g.on_acquire("B", b, False, "t1:2")
        g.on_release("B", b)
        g.on_release("A", a)
        assert g.cycles == []
        g.on_acquire("B", b, False, "t2:1")
        g.on_acquire("A", a, True, "t2:2")
        assert len(g.cycles) == 1
        assert set(g.cycles[0]) == {"A", "B"}

    def test_three_lock_cycle_detected(self):
        g = LockdepGraph()
        objs = {n: object() for n in "ABC"}

        def pair(x, y):
            g.on_acquire(x, objs[x], False, "s")
            g.on_acquire(y, objs[y], False, "s")
            g.on_release(y, objs[y])
            g.on_release(x, objs[x])

        pair("A", "B")
        pair("B", "C")
        assert g.cycles == []
        pair("C", "A")
        assert len(g.cycles) == 1

    def test_same_name_hierarchy_edge_is_not_a_cycle(self):
        # parent/child Enforcer chains: both locks are Enforcer._lock
        g = LockdepGraph()
        child, parent = object(), object()
        g.on_acquire("Enforcer._lock", child, False, "cost:1")
        g.on_acquire("Enforcer._lock", parent, False, "cost:2")
        assert g.cycles == []
        e = g.edges[("Enforcer._lock", "Enforcer._lock")]
        assert e["count"] == 1


class TestWitnessedLockProxy:
    def test_nesting_and_contention_flags(self, monkeypatch):
        g = LockdepGraph()
        monkeypatch.setattr(ld, "_GRAPH", g)
        la = _WitnessedLock(threading.Lock(), "A")
        lb = _WitnessedLock(threading.Lock(), "B")
        with la:
            with lb:
                pass
        assert ("A", "B") in g.edges
        assert not la.locked() and not lb.locked()

    def test_condition_wait_rebalances_held_stack(self, monkeypatch):
        g = LockdepGraph()
        monkeypatch.setattr(ld, "_GRAPH", g)
        mu = _WitnessedLock(threading.RLock(), "M")
        cond = threading.Condition(mu)
        hits = []
        entered = threading.Event()

        def waiter():
            with cond:
                hits.append("in")
                entered.set()
                cond.wait(timeout=5)
                # the stack must show M held again after the wake
                hits.append(tuple(n for n, _o in g._held()))

        t = threading.Thread(target=waiter)
        t.start()
        assert entered.wait(timeout=5)
        with cond:
            cond.notify_all()
        t.join(5)
        assert not t.is_alive()
        assert hits[-1] == ("M",)
        # the main thread's stack drained too
        assert g._held() == []

    def test_contended_acquire_is_flagged_blocked(self, monkeypatch):
        g = LockdepGraph()
        monkeypatch.setattr(ld, "_GRAPH", g)
        la = _WitnessedLock(threading.Lock(), "A")
        lb = _WitnessedLock(threading.Lock(), "B")
        lb.acquire()
        parked = threading.Event()
        done = threading.Event()

        def other():
            with la:
                parked.set()
                with lb:  # contends: the main thread holds B
                    pass
            done.set()

        t = threading.Thread(target=other)
        t.start()
        assert parked.wait(timeout=5)
        # the edge is recorded before the park, so it is there while the
        # other thread still waits
        for _ in range(500):
            if ("A", "B") in g.edges:
                break
            time.sleep(0.01)
        assert g.edges[("A", "B")]["blocked"] == 1
        lb.release()
        assert done.wait(timeout=5)
        t.join(5)
        assert g.edges[("A", "B")]["count"] == 1


class TestBlockTimeWitness:
    def test_on_block_records_edge_before_park_and_flags_cycle(self):
        # a real deadlock never returns from the park: the edge (and the
        # cycle verdict) must exist BEFORE the blocking acquire
        g = LockdepGraph()
        a, b = object(), object()
        g.on_acquire("A", a, False, "t1:1")
        g.on_acquire("B", b, False, "t1:2")
        g.on_release("B", b)
        g.on_release("A", a)
        g.on_acquire("B", b, False, "t2:1")
        closed = g.on_block("A", a, "t2:2")
        assert closed is True
        assert ("B", "A") in g.edges
        assert g.edges[("B", "A")]["blocked"] == 1
        assert len(g.cycles) == 1

    def test_on_block_with_nothing_held_is_a_noop(self):
        g = LockdepGraph()
        assert g.on_block("A", object(), "s") is False
        assert g.edges == {}


# One acquisition script, run through both packages' graphs: each step is
# (op, name, object key, blocked, site[, record_edge]); a contended acquire
# is a "block" (the edge recorded before the park) and then an "acq" that
# records no edge, as the witnessed lock does it.
_SCRIPTS = {
    "nested": [("acq", "A", 0, False, "x:1"), ("acq", "B", 1, False, "x:2"),
               ("acq", "C", 2, True, "x:3"), ("rel", "C", 2),
               ("rel", "B", 1), ("acq", "B", 1, False, "x:4"),
               ("rel", "B", 1), ("rel", "A", 0)],
    "abba": [("acq", "A", 0, False, "t1:1"), ("acq", "B", 1, False, "t1:2"),
             ("rel", "B", 1), ("rel", "A", 0),
             ("acq", "B", 1, False, "t2:1"), ("block", "A", 0, True, "t2:2"),
             ("acq", "A", 0, True, "t2:2", False), ("rel", "A", 0),
             ("rel", "B", 1)],
    "three_cycle": [("acq", "A", 0, False, "s"), ("acq", "B", 1, False, "s"),
                    ("rel", "B", 1), ("rel", "A", 0),
                    ("acq", "B", 1, False, "s"), ("acq", "C", 2, False, "s"),
                    ("rel", "C", 2), ("rel", "B", 1),
                    ("acq", "C", 2, False, "s"), ("acq", "A", 0, True, "s"),
                    ("rel", "A", 0), ("rel", "C", 2)],
    "hierarchy_and_reentry": [
        ("acq", "Enforcer._lock", 0, False, "cost:1"),
        ("acq", "Enforcer._lock", 1, False, "cost:2"),
        ("acq", "Enforcer._lock", 1, False, "cost:3"),
        ("block", "Scope._lock", 2, True, "i:1"),
        ("acq", "Scope._lock", 2, True, "i:1", False),
        ("rel", "Scope._lock", 2), ("rel", "Enforcer._lock", 1),
        ("rel", "Enforcer._lock", 1), ("rel", "Enforcer._lock", 0),
        ("block", "X", 3, True, "n:1")],
}


def _play(graph_cls, script):
    g = graph_cls()
    objs = [object() for _ in range(4)]
    flags = []
    for step in script:
        op, name, k = step[:3]
        if op == "acq":
            g.on_acquire(name, objs[k], step[3], step[4],
                         record_edge=step[5] if len(step) > 5 else True)
        elif op == "block":
            flags.append((name, g.on_block(name, objs[k], step[4])))
        else:
            g.on_release(name, objs[k])
    snap = g.snapshot()
    return {"edges": snap["edges"], "cycles": snap["cycles"],
            "flags": flags, "held": [n for n, _o in g._held()]}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_graph_equals_reference(script):
    """The same acquisitions give the same edges (counts, blocked flags,
    first sites), the same on_block verdicts and the same cycles."""
    assert _play(LockdepGraph, _SCRIPTS[script]) == _play(
        jld.LockdepGraph, _SCRIPTS[script])


def test_repo_match_is_the_port_package():
    """A lock is witnessed when a path component is m3_tpu_torch: never
    for the reference's files, in a process that holds both packages."""
    assert ld._in_repo(os.path.join(ROOT, "m3_tpu_torch", "utils", "x.py"))
    assert not ld._in_repo(os.path.join(ROOT, "m3_tpu", "utils", "x.py"))
    assert not ld._in_repo("/usr/lib/python3/threading.py")
    assert jld._in_repo(os.path.join(ROOT, "m3_tpu", "utils", "x.py"))


_NAMES_CODE = """
import json, os, sys, tempfile
pkg = sys.argv[1]
__import__(pkg)
lockdep = __import__(pkg + ".utils.lockdep", fromlist=["x"])
assert lockdep.installed()
health = __import__(pkg + ".utils.health", fromlist=["x"])
kv = __import__(pkg + ".cluster.kv", fromlist=["x"])
g = health.AdmissionGate(8, name="")
with g.held():
    pass
kv.FileStore(os.path.join(tempfile.mkdtemp(), "kv.json"))
print(lockdep.dump_now())
"""


def _dump(pkg, out_dir):
    env = dict(os.environ, M3_TPU_LOCKDEP="1", M3_TPU_LOCKDEP_OUT=str(out_dir),
               PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _NAMES_CODE, pkg], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    path = res.stdout.strip().splitlines()[-1]
    return json.loads(open(path).read())


class TestEndToEnd:
    def test_env_gated_install_names_real_locks(self, tmp_path):
        """A child with M3_TPU_LOCKDEP=1 driving the port's admission gate
        dumps a graph named with the Class.attr scheme, with the gate's
        canonical cross-class edge, no cycle, and no lock of the
        reference."""
        d = _dump("m3_tpu_torch", tmp_path)
        assert "AdmissionGate._lock" in d["nodes"]
        assert d["cycles"] == []
        pairs = {(e["from"], e["to"]) for e in d["edges"]}
        assert ("AdmissionGate._lock", "Scope._lock") in pairs
        assert all("m3_tpu" not in e["site"].split(":")[0].split("/")
                   for e in d["edges"])

    def test_site_names_equal_reference(self, tmp_path):
        """The counterpart classes get the reference's names: the gate's
        lock and its edge, and FileStore's inherited lock as
        MemStore._lock (the defining class), never FileStore._lock."""
        port = _dump("m3_tpu_torch", tmp_path / "port")
        ref = _dump("m3_tpu", tmp_path / "ref")
        for d in (port, ref):
            assert "MemStore._lock" in d["nodes"], sorted(d["nodes"])
            assert "FileStore._lock" not in d["nodes"]
        names = ("AdmissionGate._lock", "Scope._lock", "MemStore._lock")
        assert {n: port["nodes"][n] for n in names} == {
            n: ref["nodes"][n] for n in names}
        edge = ("AdmissionGate._lock", "Scope._lock")
        assert edge in {(e["from"], e["to"]) for e in port["edges"]}
        assert edge in {(e["from"], e["to"]) for e in ref["edges"]}

    def test_uninstalled_by_default(self):
        if os.environ.get("M3_TPU_LOCKDEP", "") not in ("", "0"):
            pytest.skip("suite running under the witness")
        assert not ld.installed()
        assert type(threading.Lock()).__name__ in ("lock", "LockType")

    def test_install_uninstall_round_trip(self, monkeypatch):
        """install() patches the factories for new allocations from the
        port's files only; uninstall() restores the real ones."""
        if ld.installed():
            pytest.skip("suite running under the witness")
        monkeypatch.setattr(ld, "_GRAPH", LockdepGraph())
        monkeypatch.setattr(ld.atexit, "register", lambda fn: fn)
        ld.install()
        try:
            assert ld.installed() and threading.Lock is ld._lock_factory
            # allocated here (tests/): a real lock, not a witness
            assert not isinstance(threading.Lock(), _WitnessedLock)
            from m3_tpu_torch.utils.health import AdmissionGate

            gate = AdmissionGate(4, name="")
            assert isinstance(gate._lock, _WitnessedLock)
            assert "AdmissionGate._lock" in ld.witness_graph().nodes
        finally:
            ld.uninstall()
        assert not ld.installed() and threading.Lock is ld._REAL_LOCK

    def test_dump_now_writes_one_file_per_pid(self, tmp_path, monkeypatch):
        g = LockdepGraph()
        g.on_acquire("A", object(), False, "x:1")
        monkeypatch.setattr(ld, "_GRAPH", g)
        monkeypatch.setenv("M3_TPU_LOCKDEP_OUT", str(tmp_path))
        path = ld.dump_now()
        assert path == str(tmp_path / f"lockdep-{os.getpid()}.json")
        d = json.loads(open(path).read())
        assert d["pid"] == os.getpid() and d["nodes"] == {}
        assert d["cycles"] == [] and d["edges"] == []


class TestBlockTimes:
    def test_contended_acquire_charges_its_park_to_the_edge(self):
        g = LockdepGraph()
        a, b = object(), object()
        g.on_acquire("A", a, False, "x:1")
        g.on_block("B", b, "x:2")
        g.on_blocked_for("B", b, 0.25)
        g.on_acquire("B", b, True, "x:2", record_edge=False)
        g.on_release("B", b)
        g.on_block("B", b, "x:3")
        g.on_blocked_for("B", b, 0.5)
        snap = g.snapshot()
        assert snap["block_times"] == [{"from": "A", "to": "B", "parks": 2,
                                        "total_s": 0.75, "max_s": 0.5}]
        # the edges themselves stay the reference's
        assert snap["edges"] == [{"from": "A", "to": "B", "count": 2,
                                  "blocked": 2, "site": "x:2"}]

    def test_park_with_nothing_held_is_charged_to_a_dash(self):
        g = LockdepGraph()
        g.on_blocked_for("A", object(), 1.0)
        snap = g.snapshot()
        assert snap["block_times"] == [{"from": "-", "to": "A", "parks": 1,
                                        "total_s": 1.0, "max_s": 1.0}]
        assert snap["edges"] == []


@pytest.fixture(scope="module")
def static_graph():
    """The static lock graph of m3_tpu_torch/, built once for the file."""
    from m3_tpu_torch.analysis import witness

    return witness.static_lock_graph()


def _run_check(tmp_path, graph, *dumps):
    """`python -m m3_tpu_torch.analysis.witness lockdep DIR` through its
    main(), with the file's static graph: (returncode, stdout)."""
    import contextlib
    import io
    import types

    from m3_tpu_torch.analysis import witness

    for i, dump in enumerate(dumps, 1):
        (tmp_path / f"lockdep-{i}.json").write_text(json.dumps(dump))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(witness, "static_lock_graph", lambda root=None: graph)
        rc = witness.main(["lockdep", str(tmp_path)])
    return types.SimpleNamespace(returncode=rc, stdout=out.getvalue())


class TestLockdepCheck:
    """The reference's tests/test_lockdep.py TestLockdepCheck and
    TestUnionCycle on the port's checker."""

    BASE = {"pid": 1, "argv": ["x"], "time": 0.0, "nodes": {},
            "edges": [], "cycles": []}

    def test_green_on_statically_known_edge(self, tmp_path, static_graph):
        d = dict(self.BASE)
        d["edges"] = [{"from": "hbm._SHARED_LOCK", "to": "HBMBudget._lock",
                       "count": 1, "blocked": 0, "site": "hbm.py:1"}]
        out = _run_check(tmp_path, static_graph, d)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "GREEN" in out.stdout

    def test_cycle_fails_with_exit_2(self, tmp_path, static_graph):
        d = dict(self.BASE)
        d["cycles"] = [["A._x", "B._y", "A._x"]]
        out = _run_check(tmp_path, static_graph, d)
        assert out.returncode == 2
        assert "cycle" in out.stdout

    def test_unreconciled_edge_fails_with_exit_1(self, tmp_path, static_graph):
        d = dict(self.BASE)
        d["edges"] = [{"from": "Nope._a", "to": "Nada._b", "count": 3,
                       "blocked": 1, "site": "zz.py:9"}]
        out = _run_check(tmp_path, static_graph, d)
        assert out.returncode == 1
        assert "Nope._a -> Nada._b" in out.stdout

    @pytest.mark.parametrize("edge", [
        ("InsertQueue._drain_mu", "Shard.write_lock"),
        ("Shard.write_lock", "Breaker._lock"),
        ("guard._LOCK", "HealthTracker._lock")])
    def test_reconciled_edge_passes(self, tmp_path, static_graph, edge):
        # entries actually present in the port's ledger, each witnessed by
        # the kill drill's child (the static graph does not derive them)
        d = dict(self.BASE)
        d["edges"] = [{"from": edge[0], "to": edge[1], "count": 2,
                       "blocked": 0, "site": "shard.py:210"}]
        out = _run_check(tmp_path, static_graph, d)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "reconciled (1)" in out.stdout

    def test_cross_process_abba_fails_exit_2(self, tmp_path, static_graph):
        # one process witnesses A->B, another B->A: neither records a
        # cycle online, only the union of the dumps closes the loop
        d1 = dict(self.BASE)
        d1["edges"] = [{"from": "Zed._a", "to": "Qux._b", "count": 1,
                        "blocked": 0, "site": "p1:1"}]
        d2 = dict(self.BASE)
        d2["edges"] = [{"from": "Qux._b", "to": "Zed._a", "count": 1,
                        "blocked": 1, "site": "p2:1"}]
        out = _run_check(tmp_path, static_graph, d1, d2)
        assert out.returncode == 2, out.stdout + out.stderr
        assert "union-of-dumps" in out.stdout

    def test_no_dump_fails_with_exit_1(self, tmp_path, static_graph):
        out = _run_check(tmp_path, static_graph)
        assert out.returncode == 1
        assert "NO dumps" in out.stdout

    def test_a_real_child_dump_is_green(self, tmp_path):
        """A child driving the admission gate and the KV store under the
        witness: every edge it witnesses is in the static graph."""
        _dump("m3_tpu_torch", tmp_path)
        out = subprocess.run(
            [sys.executable, "-m", "m3_tpu_torch.analysis.witness",
             "lockdep", str(tmp_path), "--verbose"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "AdmissionGate._lock -> Scope._lock" in out.stdout

    def test_longest_blocked_orders_by_seconds_parked(self):
        from m3_tpu_torch.analysis import witness

        d = dict(self.BASE)
        d["edges"] = [{"from": "A", "to": "B", "count": 3, "blocked": 2,
                       "site": "s"},
                      {"from": "C", "to": "D", "count": 1, "blocked": 1,
                       "site": "s"}]
        d["block_times"] = [{"from": "A", "to": "B", "parks": 2,
                             "total_s": 0.1, "max_s": 0.08},
                            {"from": "C", "to": "D", "parks": 1,
                             "total_s": 0.3, "max_s": 0.3}]
        d["block_times"].append({"from": "-", "to": "E", "parks": 4,
                                 "total_s": 0.2, "max_s": 0.1})
        edges, _, _ = witness.witnessed_edges([("x", d)])
        assert edges[("A", "B")]["blocked_s"] == 0.1
        assert witness.longest_blocked(witness.block_times([("x", d)])) == [
            ("C", "D", 1, 0.3, 0.3), ("-", "E", 4, 0.2, 0.1),
            ("A", "B", 2, 0.1, 0.08)]
