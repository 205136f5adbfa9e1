"""The port's race witness (m3_tpu_torch/utils/racewatch.py) against the
reference's (m3_tpu/utils/racewatch.py): access-profile recording, the
racy-pair computation, the first-write (construction) skip, slot wrapping,
registration before and after arming, the dump round trip, and the armed
registrations of the port's SeriesRegistry and Elem in a child process.

The reference's cases for scripts/race_check.py (its lock-free ledger and
static protection model) are not mirrored: the port does not port
analysis/."""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from m3_tpu.utils import racewatch as jracewatch
from m3_tpu_torch.utils import racewatch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _arm(monkeypatch, mod, held):
    """Arm `mod`'s recording WITHOUT installing lockdep: held-lock
    snapshots come from a per-thread override, so tests control the lock
    story exactly."""
    monkeypatch.setattr(mod, "_held_locks",
                        lambda: frozenset(getattr(held, "locks", ())))
    monkeypatch.setattr(mod, "_INSTALLED", True)
    # fresh ident table: each test's throwaway class gets its own
    # descriptor even when names (Box.v) repeat across tests
    monkeypatch.setattr(mod, "_WATCHED", {})
    mod.reset()


@pytest.fixture
def witness(monkeypatch):
    held = threading.local()
    _arm(monkeypatch, racewatch, held)
    yield held
    racewatch.reset()


def in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


class TestProfileRecording:
    def test_disjoint_lock_cross_thread_write_is_racy(self, witness):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        witness.locks = ("Box._lock",)
        b.v = 1  # main thread, under the lock

        def other():
            witness.locks = ()
            b.v = 2  # lock-free from another thread

        in_thread(other)
        (f,) = racewatch.findings()
        assert f["attr"] == "Box.v"
        assert f["threads"] == 2
        assert f["racy"], f
        (a, c) = f["racy"][0]
        assert not (set(a["locks"]) & set(c["locks"]))

    def test_common_lock_pair_is_not_racy(self, witness):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        witness.locks = ("Box._lock",)
        b.v = 1

        def other():
            witness.locks = ("Box._lock",)
            b.v = 2

        in_thread(other)
        (f,) = racewatch.findings()
        assert f["threads"] == 2
        assert f["racy"] == []

    def test_read_read_pair_is_not_racy(self, witness):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        witness.locks = ()
        assert b.v == 0

        def other():
            witness.locks = ()
            assert b.v == 0

        in_thread(other)
        (f,) = racewatch.findings()
        assert f["threads"] == 2
        assert f["racy"] == []

    def test_first_write_is_construction_not_a_profile(self, witness):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        witness.locks = ()
        Box()  # only the __init__ store: pre-publication by contract
        assert racewatch.observed_count() == 0
        b = Box()
        b.v = 1  # the SECOND store is a real write profile
        (f,) = racewatch.findings()
        assert [p["write"] for p in f["profiles"]] == [True]

    def test_profiles_deduplicate(self, witness):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        witness.locks = ()
        for _ in range(50):
            b.v += 1  # read+write, same thread/locks every iteration
        assert racewatch.observed_count() == 2  # one read + one write

    def test_slots_class_wraps_the_slot_descriptor(self, witness):
        class SBox:
            __slots__ = ("v",)

            def __init__(self):
                self.v = 7

        racewatch.watch(SBox, "v")
        b = SBox()
        witness.locks = ()
        assert b.v == 7
        b.v = 8
        assert b.v == 8
        (f,) = racewatch.findings()
        assert f["attr"] == "SBox.v"
        assert {p["write"] for p in f["profiles"]} == {True, False}

    def test_disarmed_witness_records_nothing(self, witness, monkeypatch):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        monkeypatch.setattr(racewatch, "_INSTALLED", False)
        b.v = 1
        assert b.v == 1  # descriptor still delegates storage
        assert racewatch.observed_count() == 0

    def test_delete_and_missing_attribute(self, witness):
        class Box:
            pass

        racewatch.watch(Box, "v")
        b = Box()
        with pytest.raises(AttributeError):
            b.v
        b.v = 1  # construction-like first store: not a profile
        del b.v  # a write profile
        with pytest.raises(AttributeError):
            b.v
        (f,) = racewatch.findings()
        assert sorted(p["write"] for p in f["profiles"]) == [False, True]


class TestRegistration:
    def test_register_is_pending_until_installed(self, monkeypatch):
        monkeypatch.setattr(racewatch, "_INSTALLED", False)
        monkeypatch.setattr(racewatch, "_PENDING", [])

        class Box:
            pass

        racewatch.register(Box, "v")
        assert not isinstance(Box.__dict__.get("v"),
                              racewatch._WatchedAttr)
        assert racewatch._PENDING == [(Box, ("v",))]

    def test_register_instruments_when_armed(self, witness):
        class Box:
            pass

        racewatch.register(Box, "v")
        assert isinstance(Box.__dict__["v"], racewatch._WatchedAttr)

    def test_port_modules_register_the_reference_attrs(self):
        """The port's registrations are the reference's: SeriesRegistry
        (_index, _ids, _tags) and Elem (_buckets, _degraded)."""
        import m3_tpu.aggregator.elem  # noqa: F401
        import m3_tpu.storage.series  # noqa: F401
        import m3_tpu_torch.aggregator.elem  # noqa: F401
        import m3_tpu_torch.storage.series  # noqa: F401

        def regs(mod, prefix):
            # pending (unarmed) registrations of this package's classes
            return sorted((cls.__name__, attrs) for cls, attrs in mod._PENDING
                          if cls.__module__.startswith(prefix))

        if racewatch.installed():
            pytest.skip("suite running under the witness")
        assert regs(racewatch, "m3_tpu_torch.") == [
            ("Elem", ("_buckets", "_degraded")),
            ("SeriesRegistry", ("_index", "_ids", "_tags"))]
        assert regs(racewatch, "m3_tpu_torch.") == regs(jracewatch, "m3_tpu.")


class TestRacyPairs:
    P = [
        {"thread": 1, "locks": ["A"], "write": True},
        {"thread": 2, "locks": ["A"], "write": True},
        {"thread": 2, "locks": [], "write": False},
        {"thread": 1, "locks": [], "write": False},
    ]

    def test_cross_thread_disjoint_with_write_only(self):
        got = racewatch.racy_pairs(self.P)
        # (1,A,w)x(2,[],r) and (2,A,w)x(1,[],r): write vs bare read on
        # the other thread; the read-read and common-lock pairs drop
        assert len(got) == 2
        for a, b in got:
            assert a["thread"] != b["thread"]
            assert a["write"] or b["write"]
            assert not (set(a["locks"]) & set(b["locks"]))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_racy_pairs_equal_reference(self, seed):
        import random

        rng = random.Random(seed)
        profiles = [{"thread": rng.randrange(3),
                     "locks": sorted(rng.sample(["A", "B", "C"],
                                                rng.randrange(3))),
                     "write": rng.random() < 0.5} for _ in range(12)]
        assert racewatch.racy_pairs(profiles) == jracewatch.racy_pairs(
            profiles)


def test_findings_equal_reference(monkeypatch):
    """One access script through both packages' witnesses gives the same
    findings (profiles, thread counts, racy pairs), thread ids aside."""
    out = []
    for mod in (racewatch, jracewatch):
        held = threading.local()
        _arm(monkeypatch, mod, held)

        class Box:
            __slots__ = ("v", "w")

            def __init__(self):
                self.v = 0
                self.w = 0

        mod.watch(Box, "v", "w")
        b = Box()
        held.locks = ("Box._lock",)
        b.v = 1
        b.w += 1

        def other():
            held.locks = ()
            b.v = b.w

        in_thread(other)
        names = {}
        got = mod.findings()
        for f in got:
            for p in f["profiles"]:
                p["thread"] = names.setdefault(p["thread"], len(names))
            for pair in f["racy"]:
                for p in pair:
                    p["thread"] = names.setdefault(p["thread"], len(names))
        out.append(got)
        mod.reset()
    assert out[0] == out[1] and len(out[0]) == 2


class TestDump:
    def test_dump_round_trip(self, witness, tmp_path):
        class Box:
            def __init__(self):
                self.v = 0

        racewatch.watch(Box, "v")
        b = Box()
        witness.locks = ()
        b.v = 1
        path = racewatch.dump_now(str(tmp_path / "racewatch-1.json"))
        payload = json.loads(pathlib.Path(path).read_text())
        assert payload["observed"] == 1
        (f,) = [a for a in payload["attrs"] if a["attr"] == "Box.v"]
        assert f["profiles"][0]["write"] is True

    def test_no_out_dir_is_a_noop(self, witness, monkeypatch):
        monkeypatch.delenv("M3_TPU_RACEWATCH_OUT", raising=False)
        assert racewatch.dump_now() == ""


_ARMED_CODE = """
import json, threading
import numpy as np
from m3_tpu_torch.aggregator.elem import Elem, ElemKey
from m3_tpu_torch.metrics.metric import MetricType
from m3_tpu_torch.metrics.policy import StoragePolicy
from m3_tpu_torch.storage.series import SeriesRegistry
from m3_tpu_torch.utils import lockdep, racewatch
assert racewatch.installed() and lockdep.installed()
assert isinstance(Elem.__dict__["_buckets"], racewatch._WatchedAttr)
assert isinstance(SeriesRegistry.__dict__["_index"], racewatch._WatchedAttr)
reg = SeriesRegistry()
elem = Elem(ElemKey(b"m", StoragePolicy.parse("1m:40h")), MetricType.GAUGE)
def work(base):
    for i in range(32):
        reg.get_or_create(b"%d-%d" % (base, i), None)
        reg.get(b"%d-%d" % (base, i))
        elem.add_value(60 * 10**9 * (i % 3), float(i))
ts = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
[t.start() for t in ts]
work(0)
[t.join(30) for t in ts]
closed = elem.closed_buckets(10**12)
assert sum(len(v) for _s, v in closed) == 96, closed
assert len(reg) == 96
print(json.dumps({"observed": racewatch.observed_count()}))
"""


class TestAutoInstallEndToEnd:
    """The wired path: M3_TPU_RACEWATCH=1 arms the witness at the port's
    package import, the port's register() calls instrument SeriesRegistry
    and Elem (a __slots__ class), real threaded traffic keeps working and
    produces a dump naming the registered attributes, and lockdep's dump
    of the same process has no cycle."""

    def test_registry_and_elem_traffic_dumps(self, tmp_path):
        env = dict(os.environ, M3_TPU_RACEWATCH="1",
                   M3_TPU_RACEWATCH_OUT=str(tmp_path),
                   M3_TPU_LOCKDEP_OUT=str(tmp_path), PYTHONPATH=str(ROOT))
        proc = subprocess.run([sys.executable, "-c", _ARMED_CODE],
                              capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1])["observed"] > 0
        dumps = list(tmp_path.glob("racewatch-*.json"))
        assert len(dumps) == 1
        payload = json.loads(dumps[0].read_text())
        assert payload["observed"] > 0
        idents = {a["attr"] for a in payload["attrs"]}
        assert {"SeriesRegistry._index", "SeriesRegistry._ids",
                "Elem._buckets"} <= idents
        by_attr = {a["attr"]: a for a in payload["attrs"]}
        # cross-thread accesses seen (a finished thread's id may be reused)
        assert by_attr["SeriesRegistry._index"]["threads"] >= 2
        # Elem._degraded is lock-protected: its cross-thread accesses all
        # hold Elem._lock, so the witness finds no racy pair on it.
        if "Elem._degraded" in by_attr:
            assert by_attr["Elem._degraded"]["racy"] == []
        (ldump,) = tmp_path.glob("lockdep-*.json")
        assert json.loads(ldump.read_text())["cycles"] == []
