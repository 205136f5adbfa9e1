"""The port's HTTP/JSON mirror of the node RPC (m3_tpu_torch.rpc.httpjson),
its instrument scopes and the aggregator fleet's staged deploy
(m3_tpu_torch.aggregator.deploy) against the reference's, on the CPU: a
write, a columnar write_batch (ids as base64 bytes) and fetches through
POST answer as the reference's server answers the same requests; unknown
methods and bad bodies answer 400 and a held admission gate 429; the
/debug surface (vars with the compute guard's snapshot, traces, thread
stacks, a bad parameter's 400); the server runs on its service's device;
deploy plans follow followers first, one replica of a shard set a stage,
and leaders resign before they are deployed. Servers are real localhost
listeners, closed in `finally`."""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from m3_tpu.aggregator import deploy as jdeploy
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.rpc.httpjson import HTTPJSONServer as JHTTPJSONServer
from m3_tpu.rpc.node_server import NodeService as JNodeService
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.namespace import NamespaceOptions as JNamespaceOptions
from m3_tpu_torch.aggregator.deploy import DeployError, Deployer, InstanceInfo
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.rpc import HTTPJSONServer
from m3_tpu_torch.rpc.node_server import NodeService
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.storage.namespace import NamespaceOptions
from m3_tpu_torch.utils.health import AdmissionGate
from m3_tpu_torch.utils.instrument import Scope

T0 = 1_600_000_000_000_000_000


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


def _call(endpoint, method, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"{endpoint}/{method}", data=data,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(endpoint, path):
    try:
        with urllib.request.urlopen(endpoint + path, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _b64(x: bytes) -> dict:
    return {"b64": base64.b64encode(x).decode()}


def _port_server(gate=None):
    now = {"t": T0}
    db = Database(ShardSet(4), clock=lambda: now["t"], device="cpu")
    db.create_namespace(b"default", NamespaceOptions(index_enabled=False))
    svc = NodeService(db, gate=gate, device="cpu")
    return HTTPJSONServer(svc).start(), db


def _ref_server():
    now = {"t": T0}
    db = JDatabase(JShardSet(4), clock=lambda: now["t"])
    db.create_namespace(b"default", JNamespaceOptions(index_enabled=False))
    return JHTTPJSONServer(JNodeService(db)).start(), db


class TestHTTPJSON:
    def test_mirror_write_fetch(self):
        srv, _ = _port_server()
        try:
            code, out = _call(srv.endpoint, "health", {})
            assert code == 200 and out["ok"]
            code, out = _call(srv.endpoint, "write", {
                "ns": "default", "id": "http.series", "t_ns": T0, "value": 4.5})
            assert out["ok"], out
            code, out = _call(srv.endpoint, "fetch", {
                "ns": "default", "id": "http.series", "start_ns": 0,
                "end_ns": T0 + 10})
            assert out["ok"] and out["r"]["v"] == [4.5]
            assert _call(srv.endpoint, "bogus", {}) == (
                400, {"ok": False, "err": "unknown method 'bogus'"})
        finally:
            srv.close()

    def test_answers_equal_reference(self):
        """The same requests to both packages' servers: the same status
        and JSON (the node's uptime aside)."""
        rng = np.random.default_rng(3)
        ids = [b"s.%d" % i for i in range(20)]
        ts = (T0 + np.arange(20, dtype=np.int64) * 10**9).tolist()
        vals = rng.standard_normal(20).tolist()
        vals[3] = -0.0
        reqs = [
            ("health", {}),
            ("write", {"ns": "default", "id": "one", "t_ns": T0, "value": 1.5,
                       "tags": {"a": "b"}}),
            ("write_batch", {"ns": "default", "ids": [_b64(i) for i in ids],
                             "ts": ts, "vals": vals}),
            ("fetch", {"ns": "default", "id": "s.3", "start_ns": 0,
                       "end_ns": T0 + 10**12}),
            ("fetch", {"ns": "default", "id": _b64(b"s.7"), "start_ns": 0,
                       "end_ns": T0 + 10**12}),
            ("fetch", {"ns": "nope", "id": "x", "start_ns": 0, "end_ns": 1}),
            ("write", {"ns": "default"}),
            ("bogus", {}),
            ("fetch", b"{not json"),
        ]
        answers = []
        for make in (_port_server, _ref_server):
            srv, _ = make()
            try:
                got = []
                for method, body in reqs:
                    code, out = _call(srv.endpoint, method, body)
                    if method == "health":
                        out["r"].pop("uptime_ns")
                    got.append((code, out))
                answers.append(got)
            finally:
                srv.close()
        assert answers[0] == answers[1]
        assert answers[0][2] == (200, {"ok": True, "r": 20})
        assert answers[0][4][1]["r"]["v"] == [vals[7]]

    def test_write_batch_fetches_back_bit_for_bit(self):
        srv, db = _port_server()
        try:
            rng = np.random.default_rng(11)
            ids = [b"bulk.%d" % (i % 50) for i in range(500)]
            ts = (T0 + (np.arange(500, dtype=np.int64) // 50) * 10**9).tolist()
            vals = rng.standard_normal(500).tolist()
            code, out = _call(srv.endpoint, "write_batch", {
                "ns": "default", "ids": [_b64(i) for i in ids], "ts": ts,
                "vals": vals})
            assert (code, out) == (200, {"ok": True, "r": 500})
            for k in range(50):
                code, out = _call(srv.endpoint, "fetch", {
                    "ns": "default", "id": "bulk.%d" % k, "start_ns": 0,
                    "end_ns": T0 + 10**12})
                want = vals[k::50]
                assert np.array(out["r"]["v"]).view(np.uint64).tolist() == \
                    np.array(want).view(np.uint64).tolist()
                assert out["r"]["t"] == ts[k::50]
        finally:
            srv.close()

    def test_held_gate_answers_429(self):
        gate = AdmissionGate(capacity=2, name="test.httpjson")
        srv, _ = _port_server(gate)
        try:
            gate.admit(2)
            code, out = _call(srv.endpoint, "write", {
                "ns": "default", "id": "x", "t_ns": T0, "value": 1.0})
            assert code == 429 and out["kind"] == "resource_exhausted"
            gate.release(2)
            assert _call(srv.endpoint, "write", {
                "ns": "default", "id": "x", "t_ns": T0, "value": 1.0})[0] == 200
        finally:
            srv.close()

    def test_debug_surface(self):
        srv, _ = _port_server()
        try:
            code, ctype, body = _get(srv.endpoint, "/debug/vars")
            out = json.loads(body)
            assert code == 200 and ctype == "application/json"
            assert set(out) == {"metrics", "compute"}
            assert isinstance(out["compute"], dict)
            code, _, body = _get(srv.endpoint, "/debug/traces")
            assert code == 200 and isinstance(json.loads(body), dict)
            code, ctype, body = _get(srv.endpoint, "/debug/pprof/threads")
            assert code == 200 and ctype.startswith("text/plain")
            assert b"Thread" in body or b"thread" in body
            code, _, body = _get(srv.endpoint,
                                 "/debug/pprof/profile?seconds=abc")
            assert code == 400 and not json.loads(body)["ok"]
            assert _get(srv.endpoint, "/debug/nope")[0] == 404
        finally:
            srv.close()

    def test_server_runs_on_its_service_device(self):
        srv, db = _port_server()
        try:
            assert srv.device == db.device == torch.device("cpu")
        finally:
            srv.close()


class TestDeployer:
    def _fleet(self, mod):
        state = {
            "a0": mod.InstanceInfo("a0", "ss0", is_leader=True),
            "a1": mod.InstanceInfo("a1", "ss0", is_leader=False),
            "b0": mod.InstanceInfo("b0", "ss1", is_leader=True),
            "b1": mod.InstanceInfo("b1", "ss1", is_leader=False),
        }

        def resign(iid):
            info = state[iid]
            state[iid] = mod.InstanceInfo(iid, info.shard_set_id, False)
            other = [i for i in state.values()
                     if i.shard_set_id == info.shard_set_id
                     and i.instance_id != iid][0]
            state[other.instance_id] = mod.InstanceInfo(
                other.instance_id, other.shard_set_id, True)

        return state, resign

    def test_plan_followers_first_one_per_shard_set(self):
        state, resign = self._fleet(jdeploy)
        d = Deployer(lambda i: state[i], lambda i: None, resign)
        stages = d.plan(["a0", "a1", "b0", "b1"])
        assert stages == [["a1", "b1"], ["a0", "b0"]]

    @pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
    def test_plans_equal_reference(self, fraction):
        ids = [f"i{k}" for k in range(9)]
        infos = {i: InstanceInfo(i, f"ss{k % 3}", is_leader=k < 3)
                 for k, i in enumerate(ids)}
        jinfos = {i: jdeploy.InstanceInfo(i, f"ss{k % 3}", is_leader=k < 3)
                  for k, i in enumerate(ids)}
        got = Deployer(infos.__getitem__, None, None,
                       max_stage_fraction=fraction).plan(ids)
        want = jdeploy.Deployer(jinfos.__getitem__, None, None,
                                max_stage_fraction=fraction).plan(ids)
        assert got == want

    def test_execute_resigns_leaders_before_deploy(self):
        state, resign = self._fleet(jdeploy)
        order = []

        def deploy_one(iid):
            assert not state[iid].is_leader, f"deployed live leader {iid}"
            order.append(iid)

        d = Deployer(lambda i: state[i], deploy_one, resign,
                     health_timeout_s=2, poll_interval_s=0.01)
        d.execute(["a0", "a1", "b0", "b1"])
        assert set(order) == {"a0", "a1", "b0", "b1"}
        assert order.index("a1") < order.index("a0")
        assert order.index("b1") < order.index("b0")
        assert d.stages_executed == [["a1", "b1"], ["a0", "b0"]]

    def test_unhealthy_stage_aborts(self):
        state, resign = self._fleet(jdeploy)

        def deploy_bad(iid):
            state[iid] = InstanceInfo(iid, state[iid].shard_set_id,
                                      False, healthy=False)

        d = Deployer(lambda i: state[i], deploy_bad, resign,
                     health_timeout_s=0.3, poll_interval_s=0.01)
        with pytest.raises(DeployError):
            d.execute(["a1", "b1"])
        assert d.stages_executed == []
