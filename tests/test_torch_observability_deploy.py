"""Port of tests/test_observability_deploy.py on m3_tpu_torch: the same
cases on the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Instrumentation, httpjson mirror, and staged deploy tests (reference:
tally scopes + httpjson node server + aggregator/tools/deploy)."""

import json
import urllib.request

import pytest

from m3_tpu_torch.aggregator.deploy import DeployError, Deployer, InstanceInfo
from m3_tpu_torch.utils.instrument import Scope
from test_torch_cpu_default import cpu_default  # noqa: F401


class TestInstrument:
    def test_counters_gauges_histograms(self):
        root = Scope()
        s = root.sub_scope("dbnode", host="a")
        s.counter("writes").inc(5)
        s.gauge("open_blocks").update(7)
        with s.timer("tick_s"):
            pass
        snap = root.snapshot()
        assert snap["dbnode.writes{host=a}"] == 5
        assert snap["dbnode.open_blocks{host=a}"] == 7.0
        assert snap["dbnode.tick_s{host=a}"]["count"] == 1

    def test_same_metric_shared(self):
        root = Scope()
        root.sub_scope("x").counter("c").inc()
        root.sub_scope("x").counter("c").inc()
        assert root.snapshot()["x.c"] == 2

    def test_engine_and_ingest_report(self):
        from m3_tpu_torch.query import Engine
        from m3_tpu_torch.utils.instrument import ROOT
        from tests.test_query_engine import MemStorage

        before = ROOT.snapshot().get("query.executed", 0)
        eng = Engine(MemStorage())
        eng.execute_range("vector(1)", 0, 60_000_000_000, 30_000_000_000)
        assert ROOT.snapshot()["query.executed"] == before + 1


class TestHTTPJSON:
    def test_mirror_write_fetch(self):
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.rpc.httpjson import HTTPJSONServer
        from m3_tpu_torch.rpc.node_server import NodeService
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        T0 = 1_600_000_000_000_000_000
        now = {"t": T0}
        db = Database(ShardSet(4), clock=lambda: now["t"])
        db.create_namespace(b"default", NamespaceOptions(index_enabled=False))
        srv = HTTPJSONServer(NodeService(db)).start()
        try:
            def call(method, body):
                req = urllib.request.Request(
                    f"{srv.endpoint}/{method}",
                    data=json.dumps(body).encode(), method="POST")
                try:
                    with urllib.request.urlopen(req) as resp:
                        return json.loads(resp.read())
                except urllib.error.HTTPError as e:
                    return json.loads(e.read())

            out = call("health", {})
            assert out["ok"]
            out = call("write", {"ns": "default", "id": "http.series",
                                 "t_ns": T0, "value": 4.5})
            assert out["ok"], out
            out = call("fetch", {"ns": "default", "id": "http.series",
                                 "start_ns": 0, "end_ns": T0 + 10})
            assert out["ok"]
            assert out["r"]["v"] == [4.5]
            out = call("bogus", {})
            assert not out["ok"]
        finally:
            srv.close()


class TestDeployer:
    def _fleet(self):
        # Two shard sets, RF=2: one leader + one follower each.
        state = {
            "a0": InstanceInfo("a0", "ss0", is_leader=True),
            "a1": InstanceInfo("a1", "ss0", is_leader=False),
            "b0": InstanceInfo("b0", "ss1", is_leader=True),
            "b1": InstanceInfo("b1", "ss1", is_leader=False),
        }
        deployed = []

        def resign(iid):
            info = state[iid]
            state[iid] = InstanceInfo(iid, info.shard_set_id, False)
            # Its replica takes over.
            other = [i for i in state.values()
                     if i.shard_set_id == info.shard_set_id and i.instance_id != iid][0]
            state[other.instance_id] = InstanceInfo(
                other.instance_id, other.shard_set_id, True)

        return state, deployed, resign

    def test_plan_followers_first_one_per_shard_set(self):
        state, deployed, resign = self._fleet()
        d = Deployer(lambda i: state[i], deployed.append, resign)
        stages = d.plan(["a0", "a1", "b0", "b1"])
        # Stage 1: both followers (different shard sets); then both leaders.
        assert stages[0] == ["a1", "b1"]
        assert stages[1] == ["a0", "b0"]

    def test_execute_resigns_leaders_before_deploy(self):
        state, deployed, resign = self._fleet()
        order = []

        def deploy_one(iid):
            # At deploy time the target must NOT be a leader.
            assert not state[iid].is_leader, f"deployed live leader {iid}"
            order.append(iid)

        d = Deployer(lambda i: state[i], deploy_one, resign,
                     health_timeout_s=2)
        d.execute(["a0", "a1", "b0", "b1"])
        assert set(order) == {"a0", "a1", "b0", "b1"}
        # Followers deployed before the original leaders.
        assert order.index("a1") < order.index("a0")
        assert order.index("b1") < order.index("b0")

    def test_unhealthy_stage_aborts(self):
        state, deployed, resign = self._fleet()

        def deploy_bad(iid):
            state[iid] = InstanceInfo(iid, state[iid].shard_set_id,
                                      False, healthy=False)

        d = Deployer(lambda i: state[i], deploy_bad, resign,
                     health_timeout_s=0.3)
        with pytest.raises(DeployError):
            d.execute(["a1", "b1"])
        # Aborted on the first stage: later stages never ran.
        assert d.stages_executed == []
