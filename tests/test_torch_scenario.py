"""The port's harnesses (m3_tpu_torch/testing/{loadgen,scenario}.py) on the
CPU: parity with the reference's (m3_tpu/testing) from the same seeds
(load schedules, ledger allocations, the churn and kill draws, the kill
drill's config), the mirrored drills of tests/test_overload.py,
tests/test_dtest_scenarios.py, tests/test_compute_faults.py,
tests/test_diskfault.py and tests/test_durability.py, each held to its own
verify on device="cpu", and one drill across packages: the reference's
bootstrap reads the port's drill directory back to every acked point.

The reference's kill-restart drills fail on the reference itself (its
cold child takes its first write after the seeded kill), so they are no
oracle here; the port's drill is held to its WriteLedger."""

import json
import os
import random

import numpy as np
import pytest
import yaml

from m3_tpu.testing import loadgen as jloadgen
from m3_tpu.testing import scenario as jscenario
from m3_tpu_torch.testing import loadgen, scenario
from m3_tpu_torch.testing.scenario import (
    ChurnScenario,
    ChurnScenarioOptions,
    ComputeFaultChurnOptions,
    ComputeFaultChurnScenario,
    DiskFaultScenario,
    DiskFaultScenarioOptions,
    KillRestartOptions,
    KillRestartScenario,
    WriteLedger,
)

CPU = "cpu"

# ------------------------------------------------------------- schedules

_PLANS = {
    "steady": dict(base_rate=100.0),
    "spike": dict(base_rate=200.0,
                  phases=(("base", 0.5, 1.0), ("spike", 0.5, 3.0)),
                  kinds=(("q", 3.0), ("w", 1.0))),
    "churn": dict(base_rate=60.0, phases=(("churn", 4.0, 1.0),),
                  kinds=(("write", 5.0), ("write_bulk", 2.0), ("read", 4.0),
                         ("critical", 2.0))),
    "drill": dict(base_rate=150.0, phases=(("drill", 1.2, 1.0),),
                  kinds=(("write", 1.0),)),
    "ramp": dict(base_rate=37.0,
                 phases=(("a", 0.3, 0.5), ("b", 0.7, 2.5), ("c", 0.2, 0.0),
                         ("d", 1.1, 1.3)),
                 kinds=(("x", 0.1), ("y", 0.2), ("z", 0.7))),
}


def _schedule(mod, seed, plan):
    kw = dict(_PLANS[plan])
    if "phases" in kw:
        kw["phases"] = tuple(mod.Phase(*p) for p in kw["phases"])
    return mod.LoadSchedule(seed=seed, **kw)


@pytest.mark.parametrize("plan", sorted(_PLANS))
@pytest.mark.parametrize("seed", [0, 3, 7, 13])
def test_arrivals_equal_reference(seed, plan):
    got = _schedule(loadgen, seed, plan)
    want = _schedule(jloadgen, seed, plan)
    assert got.arrivals() == want.arrivals()
    assert got.total_duration_s == want.total_duration_s


class TestLoadGen:
    def test_schedule_is_pure_function_of_seed(self):
        kw = dict(base_rate=200,
                  phases=(loadgen.Phase("base", 0.5, 1.0),
                          loadgen.Phase("spike", 0.5, 3.0)),
                  kinds=(("q", 3.0), ("w", 1.0)))
        a = loadgen.LoadSchedule(seed=7, **kw)
        assert a.arrivals() == loadgen.LoadSchedule(seed=7, **kw).arrivals()
        assert a.arrivals() != loadgen.LoadSchedule(seed=8, **kw).arrivals()

    def test_phase_counts_exact_and_sorted(self):
        sched = loadgen.LoadSchedule(
            seed=3, base_rate=100,
            phases=(loadgen.Phase("base", 0.5, 1.0),
                    loadgen.Phase("spike", 0.5, 3.0)))
        arr = sched.arrivals()
        times = [t for t, _, _ in arr]
        assert times == sorted(times)
        assert sum(1 for _, _, ph in arr if ph == "base") == 50
        assert sum(1 for _, _, ph in arr if ph == "spike") == 150
        assert all(0 <= t < 1.0 for t in times)

    def test_open_loop_records_every_arrival(self):
        sched = loadgen.LoadSchedule(
            seed=5, base_rate=100, phases=(loadgen.Phase("p", 0.3, 1.0),),
            kinds=(("ok", 3.0), ("boom", 1.0)))

        def fn(kind):
            if kind == "boom":
                raise ValueError("injected")

        report = loadgen.LoadGen(sched).run(fn)
        assert len(report.records) == 30
        out = report.outcomes()
        assert out.get("ok", 0) + out.get("ValueError", 0) == 30
        assert out.get("ValueError", 0) > 0
        assert report.throughput("p") == pytest.approx(
            out.get("ok", 0) / 0.3)

    def test_report_quantiles_equal_reference(self):
        """The same records give the same selections, quantiles and
        throughputs in both packages' reports."""
        rng = random.Random(11)
        rows = [(i * 0.01, rng.choice("ab"), rng.choice(["p", "q"]),
                 rng.random(), rng.choice(["ok", "ok", "ValueError"]))
                for i in range(200)]
        durs = {"p": 0.7, "q": 1.3}
        got = loadgen.LoadReport([loadgen.Record(*r) for r in rows], durs)
        want = jloadgen.LoadReport([jloadgen.Record(*r) for r in rows], durs)
        for kw in ({}, {"phase": "p"}, {"kind": "a"},
                   {"phase": "q", "kind": "b"}):
            assert got.outcomes(**kw) == want.outcomes(**kw)
            for q in (0.5, 0.9, 0.99, 1.0):
                assert got.quantile_latency(q, **kw) == \
                    want.quantile_latency(q, **kw)
        for ph in ("p", "q", "none"):
            assert got.throughput(ph) == want.throughput(ph)
            assert got.throughput(ph, kind="a") == want.throughput(
                ph, kind="a")


# ---------------------------------------------------------------- ledger


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ledger_allocations_equal_reference(seed):
    """The same attempts and acks give the same (t_ns, value) allocations
    and the same acked view."""
    rng = random.Random(seed)
    base = 1_600_000_000_000_000_000 + seed
    got, want = WriteLedger(base), jscenario.WriteLedger(base)
    for _ in range(200):
        sid = b"s%d" % rng.randrange(7)
        a, b = got.next_write(sid), want.next_write(sid)
        assert a == b
        if rng.random() < 0.6:
            got.ack(sid, *a)
            want.ack(sid, *b)
    assert got.acked() == want.acked()
    assert got.total_acked() == want.total_acked()


# ------------------------------------------------------------ churn draws


def test_churn_draws_equal_reference():
    """The churn drill's seeded draws are the reference's: the load
    schedule, the op list and the victim stream (`_rng`), on small
    clusters of both packages."""
    kw = dict(seed=13, n_nodes=4, num_shards=4, n_series=8)
    got = ChurnScenario(ChurnScenarioOptions(device=CPU, **kw))
    want = jscenario.ChurnScenario(jscenario.ChurnScenarioOptions(**kw))
    try:
        assert got._schedule().arrivals() == want._schedule().arrivals()
        assert got.opts.churn_ops == want.opts.churn_ops
        assert got.ids == want.ids
        nodes = sorted(got.cluster.nodes)
        assert nodes == sorted(want.cluster.nodes)
        assert [got._rng.choice(nodes) for _ in range(16)] == [
            want._rng.choice(nodes) for _ in range(16)]
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("seed", [3, 7, 11, 19, 23])
def test_kill_at_equals_reference(tmp_path, seed):
    """The SIGKILL lands at the reference's seeded moment, and the drill's
    later draws (the torn tail's junk) follow the same stream."""
    o = dict(seed=seed, data_dir=str(tmp_path))
    got = KillRestartScenario(KillRestartOptions(device=CPU, **o))
    want = jscenario.KillRestartScenario(jscenario.KillRestartOptions(**o))
    try:
        lo, hi = want.opts.kill_window
        want_at = want.opts.load_duration_s * (
            lo + (hi - lo) * want._rng.random())
        assert got._kill_at() == want_at
        assert [got._rng.getrandbits(8) for _ in range(24)] == [
            want._rng.getrandbits(8) for _ in range(24)]
        assert got.ids == want.ids
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize("variant", ["base", "migration", "backfill"])
def test_drill_config_equals_reference(tmp_path, variant):
    """The child's config is the reference's document for the same
    options: written as JSON, equal as a dict to the reference's YAML."""
    o = dict(seed=7, variant=variant, data_dir=str(tmp_path))
    got = KillRestartScenario(KillRestartOptions(device=CPU, **o))
    want = jscenario.KillRestartScenario(jscenario.KillRestartOptions(**o))
    try:
        with open(got._cfg_path) as f:
            port_cfg = json.load(f)
        with open(want._cfg_path) as f:
            ref_cfg = yaml.safe_load(f)
        assert port_cfg == ref_cfg
        assert port_cfg == scenario.drill_config(str(tmp_path), got.opts)
        assert scenario._window_strs(got.opts) == want._window_strs()
        argv = got.argv()
        assert argv[1:4] == ["-m", "m3_tpu_torch.services", "dbnode"]
        assert argv[-2:] == ["--device", CPU]
    finally:
        got.close()
        want.close()


def test_drill_child_env_drops_jax_and_adds_options(tmp_path, monkeypatch):
    """The child's environment has no JAX_* variable, and the options'
    extra variables (the witnesses' gates) reach it."""
    seen = {}

    class _Stop(Exception):
        pass

    def fake_popen(argv, cwd, env, **kw):
        seen.update(argv=argv, cwd=cwd, env=env)
        raise _Stop

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(scenario.subprocess, "Popen", fake_popen)
    sc = KillRestartScenario(KillRestartOptions(
        device=CPU, data_dir=str(tmp_path),
        child_env=(("M3_TPU_LOCKDEP", "1"), ("M3_TPU_LOCKDEP_OUT", "x"))))
    try:
        with pytest.raises(_Stop):
            sc._spawn()
    finally:
        sc.close()
    assert not [k for k in seen["env"] if k.startswith("JAX_")]
    assert seen["env"]["M3_TPU_LOCKDEP"] == "1"
    assert seen["env"]["M3_TPU_LOCKDEP_OUT"] == "x"
    assert os.path.isfile(os.path.join(seen["cwd"], "m3_tpu_torch",
                                       "services", "__main__.py"))
    assert seen["argv"] == sc.argv()


# ---------------------------------------------------------------- drills


class TestSLOsUnderChurn:
    def test_macro_scenario(self):
        """Seeded open-loop mixed-priority load + seeded faultnet chaos +
        live placement churn (add/remove/replace + repair) on an RF=3
        cluster, then hard SLO verification — zero lost acked writes,
        zero shed CRITICAL, bounded p99/queues, AVAILABLE placement,
        replica-consistent checksums."""
        sc = ChurnScenario(ChurnScenarioOptions(
            seed=13, duration_s=1.2, base_rate=40, n_series=32,
            num_shards=8, device=CPU))
        try:
            result = sc.verify(sc.run())
        finally:
            sc.close()
        # The run did real work end to end: churn ops all executed,
        # acked writes were verified, blocks compared replica-wide.
        assert len(result.churn_log) == len(sc.opts.churn_ops)
        assert result.verified_points > 0
        assert result.checksum_blocks_checked > 0
        assert result.report.select(kind="critical", outcome="ok")

    def test_point_held_by_a_removed_and_a_replaced_node_survives(self):
        """A MAJORITY ack held by two replicas only (the third failed its
        write), the first of them removed and the second replaced before
        the final seal: the leaver hands its unsealed points to its
        shards' receivers, so the point is still served after
        convergence."""
        sc = ChurnScenario(ChurnScenarioOptions(
            seed=13, n_series=4, num_shards=4, device=CPU))
        try:
            sc._seed_and_seal()
            c = sc.cluster
            sid = sc.ids[0]
            shard = c.nodes["node0"].db.shard_set.lookup(sid)
            owners = sorted(h.id for h in c.topology.get().route_shard(shard))
            assert len(owners) == 3
            t_ns, value = sc.ledger.next_write(sid)
            for host_id in owners[:2]:
                c.nodes[host_id].db.write(sc.NS, sid, t_ns, value)
            victims = iter(owners[:2])
            sc._rng.choice = lambda seq: next(victims)
            sc._churn_op("remove")
            sc._churn_op("replace")
            assert sc.churn_log == [f"remove {owners[0]}",
                                    f"replace {owners[1]} -> node3r"]
            c.clock.advance(4 * 3600 * 10**9 + 11 * 60 * 10**9)
            c.tick_all()
            for host_id in sorted(c.nodes):
                sc._run_repair(host_id)
            t, v = sc.session.fetch(sc.NS, sid, 0, c.clock.now_ns + 1)
            assert dict(zip(t.tolist(), v.tolist())).get(t_ns) == value
        finally:
            sc.close()

    def test_ledger_unique_allocations(self):
        led = WriteLedger(1000)
        seen = set()
        for _ in range(100):
            t, v = led.next_write(b"s")
            assert (t, v) not in seen
            seen.add((t, v))
        led.ack(b"s", *led.next_write(b"s"))
        assert led.total_acked() == 1
        assert set(led.acked()) == {b"s"}


class TestComputeFaultChurn:
    def test_scenario(self):
        """ChurnScenario with the compute seam armed over the SLO'd
        window: seeded device faults on every guarded dispatch, each
        ending as its decisions say (the port raises typed, it has no
        fallback), zero acked-write loss, zero shed CRITICAL, and the
        decision log replayable from the plan."""
        sc = ComputeFaultChurnScenario(ComputeFaultChurnOptions(
            seed=19, duration_s=1.0, base_rate=30, n_series=24,
            num_shards=8, device=CPU))
        try:
            result = sc.verify(sc.run())
        finally:
            sc.close()
        assert result.verified_points > 0
        assert sc.compute_seam.faults_injected > 0
        assert result.report.select(kind="critical", outcome="ok")
        assert sc.audit.calls and sc.audit.unexplained() == []


def _disk_drill(seed):
    sc = DiskFaultScenario(DiskFaultScenarioOptions(seed=seed, device=CPU))
    try:
        return sc.verify(sc.run())
    finally:
        sc.close()


class TestDiskFaultScenario:
    @pytest.mark.parametrize("seed", [7, 11])
    def test_zero_loss_zero_fabrication(self, seed):
        res = _disk_drill(seed)
        assert res.verified_points > 0
        assert res.quarantined_after_faults >= 1
        assert res.scrub_stats.blocks_repaired >= 1
        assert res.health_tripped and res.recovered

    @pytest.mark.slow
    @pytest.mark.parametrize("seed", [23, 42, 1234])
    def test_more_seeds(self, seed):
        res = _disk_drill(seed)
        assert res.verified_points > 0


def _kill_drill(opts):
    sc = KillRestartScenario(opts)
    try:
        return sc.verify(sc.run())
    finally:
        sc.close()


class TestKillRestartDrill:
    @pytest.mark.parametrize("seed", [7, 19])
    def test_base_drill_zero_acked_loss(self, seed):
        res = _kill_drill(KillRestartOptions(seed=seed, device=CPU))
        assert res.verified_points == res.acked_points > 0
        assert res.torn_tail_bytes > 0  # torn tail was present AND dropped

    def test_namespace_migration_variant(self):
        res = _kill_drill(KillRestartOptions(seed=11, variant="migration",
                                             device=CPU))
        assert res.verified_points == res.acked_points > 0

    @pytest.mark.slow
    @pytest.mark.parametrize("seed", [3, 23])
    def test_more_seeds(self, seed):
        res = _kill_drill(KillRestartOptions(seed=seed, device=CPU))
        assert res.verified_points == res.acked_points > 0

    @pytest.mark.slow
    def test_backfill_variant_rides_same_start_merge(self):
        res = _kill_drill(KillRestartOptions(seed=5, variant="backfill",
                                             device=CPU))
        assert res.backfill_points > 0
        assert res.verified_points == res.acked_points > 0
        # three generations: initial + restart + post-backfill restart
        assert len(res.restart_walls_s) == 3


def test_reference_bootstraps_the_ports_drill_dir(tmp_path):
    """After the port's base drill (the restarted child stopped with
    SIGTERM), the reference's BootstrapProcess over the same data dir
    (filesets, commit log) serves every acked point, and nothing else."""
    from m3_tpu.parallel.sharding import ShardSet as JShardSet
    from m3_tpu.persist.fs import PersistManager as JPersistManager
    from m3_tpu.services.config import load_dict as jload_dict
    from m3_tpu.storage.bootstrap import BootstrapContext as JContext
    from m3_tpu.storage.bootstrap import BootstrapProcess as JBootstrap
    from m3_tpu.storage.database import Database as JDatabase
    from m3_tpu.storage.namespace import NamespaceOptions as JNsOpts

    data = tmp_path / "drill"
    data.mkdir()
    sc = KillRestartScenario(KillRestartOptions(seed=7, device=CPU,
                                                data_dir=str(data)))
    try:
        res = sc.verify(sc.run())
        launches = sc.stop_child()
    finally:
        sc.close()
    assert res.verified_points == res.acked_points > 0
    # The restarted child closed cleanly and counted its launches (none
    # on the CPU: the plain versions ran).
    assert launches == {"pack": 0, "decode": 0, "hash": 0, "window": 0}

    cfg = jload_dict(scenario.drill_config(str(data), sc.opts), "dbnode")
    db = JDatabase(JShardSet(cfg.num_shards))
    for ns_cfg in cfg.namespaces:
        db.ensure_namespace(ns_cfg.name.encode(), JNsOpts(
            retention_ns=ns_cfg.retention_ns,
            block_size_ns=ns_cfg.block_size_ns,
            buffer_past_ns=ns_cfg.buffer_past_ns,
            buffer_future_ns=ns_cfg.buffer_future_ns,
            index_enabled=ns_cfg.index_enabled))
    JBootstrap(chain=("filesystem", "commitlog", "uninitialized_topology"),
               ctx=JContext(persist=JPersistManager(str(data / "data")),
                            commitlog_dir=str(data / "commitlog"),
                            shard_lookup=db.shard_set.lookup)).run(db)
    end = sc.ledger.base_t_ns + 3600 * 10**9
    n = 0
    for sid, points in sorted(sc.ledger.acked().items()):
        t, v = db.read(b"default", sid, 0, end)
        got = dict(zip(np.asarray(t).tolist(), np.asarray(v).tolist()))
        for t_ns, value in points:
            assert got.get(t_ns) == value, (sid, t_ns)
            n += 1
        for t_ns, value in got.items():
            assert sc._attempted[(b"default", sid, int(t_ns))] == value
    assert n == res.acked_points


def test_node_start_up_warms_its_paths_without_a_trace(tmp_path):
    """run_dbnode dispatches the write, seal and read routes once on a
    scratch database before it listens (a drill's first write must not
    wait behind first uses), and the node's own namespaces, commit log
    and files hold nothing of it."""
    from m3_tpu_torch.parallel import guard
    from m3_tpu_torch.services import load_dict, run_dbnode

    def primaries():
        return {r: v["counts"].get("primary", 0)
                for r, v in guard.debug_snapshot().items()}

    data = tmp_path / "node"
    data.mkdir()
    before = primaries()
    h = run_dbnode(load_dict(scenario.drill_config(
        str(data), KillRestartOptions()), "dbnode"), device=CPU)
    try:
        after = primaries()
        for route in ("codec.hash", "codec.encode", "codec.decode"):
            assert after.get(route, 0) > before.get(route, 0), route
        assert set(h.db.namespaces) == {b"default"}
        assert all(sh.num_series() == 0
                   for sh in h.db.namespace(b"default").shards.values())
    finally:
        h.close()
    found = [os.path.join(d, f) for d, _, fs in os.walk(data) for f in fs]
    assert not [p for p in found if "warm" in os.path.relpath(p, data)]
    wal = [p for p in found if os.sep + "commitlog" + os.sep in p]
    assert all(b"warm" not in open(p, "rb").read() for p in wal)
