"""The port's operators (m3_tpu_torch/em.py, nsch.py, tools/write_bench.py)
against the reference's (m3_tpu/em.py, nsch.py, tools/write_bench.py), on
the CPU.

Mirrors tests/test_services_tools.py's TestNsch, TestWriteBench and
TestEMCluster (slow, as the reference's is) and the four cases of
tests/test_em_remote.py. The spawned children are port processes
(`python -m m3_tpu_torch.services ... --device cpu`, an agent
`python -m m3_tpu_torch.em`); nsch's writes for one workload and clock
equal the reference's. Every process is stopped in a finally or a
fixture and every wait has a deadline."""

import hashlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from m3_tpu import nsch as jnsch
from m3_tpu.tools import write_bench as jwrite_bench
from m3_tpu_torch import em, nsch
from m3_tpu_torch.em import EMCluster, ProcessSpec, RemoteOperator
from m3_tpu_torch.rpc import wire
from m3_tpu_torch.testing.cluster import SettableClock
from m3_tpu_torch.tools import write_bench

S = 1_000_000_000
T0 = 1_600_000_000 * S
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _await(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _health(endpoint):
    host, _, port = endpoint.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=10) as sock:
        sock.settimeout(10)
        wire.write_frame(sock, {"m": "health", "a": {}, "id": 1})
        return wire.read_frame(sock)


def _cmdline(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().split(b"\0")


# --------------------------------------------------------------- nsch


class TestNsch:
    @pytest.mark.parametrize("datum", ["counter", "sawtooth", "sine"])
    def test_agent_bounded_run_equals_reference(self, datum):
        got = {}
        for name, mod in (("ref", jnsch), ("port", nsch)):
            d = {"counter": lambda: mod.CounterDatum(rate=5.0),
                 "sawtooth": lambda: mod.SawtoothDatum(period=7),
                 "sine": lambda: mod.SineDatum(period=11)}[datum]()
            w = mod.Workload(cardinality=10, ingress_qps=100000, datum=d,
                             tagged=True)
            writes = []
            agent = mod.Agent(w, lambda ns, sid, tags, t, v: writes.append(
                (ns, sid, tags, t, v)), clock=lambda: T0)
            agent.run_for(25)
            assert agent.written == 25 and agent.errors == 0
            got[name] = (writes, agent.status())
        assert got["port"] == got["ref"]

    def test_agent_counter_datum(self):
        writes = []
        w = nsch.Workload(cardinality=10, ingress_qps=100000,
                          datum=nsch.CounterDatum(rate=5.0))
        agent = nsch.Agent(w, lambda ns, sid, tags, t, v:
                           writes.append((sid, v)), clock=lambda: T0)
        agent.run_for(25)
        assert agent.written == 25
        s0 = [v for sid, v in writes if sid == w.series_id(0)]
        assert s0 == [0.0, 5.0, 10.0]

    def test_write_errors_counted(self):
        def fail(*_a):
            raise ConnectionError("down")

        agent = nsch.Agent(nsch.Workload(cardinality=3), fail)
        agent.run_for(4)
        assert (agent.written, agent.errors) == (0, 4)

    def test_coordinator_fleet(self):
        sink = []
        coord = nsch.NschCoordinator()
        w = nsch.Workload(cardinality=5, ingress_qps=50000)
        coord.init(w, [lambda ns, sid, tags, t, v: sink.append(sid)
                       for _ in range(3)])
        coord.start()
        try:
            assert _await(lambda: coord.status()["total_written"] > 300)
        finally:
            coord.stop()
        st = coord.status()
        assert st["total_errors"] == 0
        assert len(st["agents"]) == 3
        coord.modify(ingress_qps=1)
        assert all(a.workload.ingress_qps == 1 for a in coord._agents)


# --------------------------------------------------------------- write bench


class TestWriteBench:
    def test_bench_against_embedded_coordinator(self):
        from m3_tpu_torch.coordinator import run_embedded
        from m3_tpu_torch.index.namespace_index import NamespaceIndex
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.storage.database import Database
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        clock = SettableClock(T0)
        db = Database(ShardSet(8), clock=clock, device="cpu")
        db.create_namespace(b"default", NamespaceOptions(),
                            index=NamespaceIndex(clock=clock))
        c = run_embedded(db, clock=clock, device="cpu")
        try:
            out = write_bench.run_write_bench(
                c.endpoint, cardinality=20, n_agents=2, duration_s=1.0,
                clock=clock)
            assert out["errors"] == 0
            assert out["writes"] > 50
            assert out["writes_per_sec"] > 50
        finally:
            c.close()
            db.close()

    def test_http_write_fn_body_equals_reference(self):
        """One nsch write through each package's http_write_fn lands the
        same JSON body on the same endpoint."""
        import http.server
        import threading

        bodies = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                bodies.append((self.path, self.headers["Content-Type"],
                               self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            url = "http://%s:%d" % srv.server_address
            for mod in (jwrite_bench, write_bench):
                mod.http_write_fn(url)(b"default", b"m.1",
                                       {b"__name__": b"m", b"idx": b"1"},
                                       T0, 2.5)
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
        assert len(bodies) == 2 and bodies[0] == bodies[1]
        assert bodies[0][0] == "/api/v1/json/write"


# --------------------------------------------------------------- em


def _port_node_yaml(workdir):
    return em._default_dbnode_yaml(workdir)


class TestOperator:
    def test_spawns_the_ports_service_with_its_device(self, tmp_path):
        op = em.Operator(str(tmp_path / "n"))
        op.setup(ProcessSpec("dbnode", _port_node_yaml(str(tmp_path / "n")),
                             str(tmp_path / "n"), device="cpu"))
        assert op.argv()[1:4] == ["-m", "m3_tpu_torch.services", "dbnode"]
        assert op.argv()[-2:] == ["--device", "cpu"]
        try:
            ep = op.start(timeout_s=60)
            assert op.heartbeat() and ep.count(":") == 1
            cmd = _cmdline(op.pid)
            assert b"m3_tpu_torch.services" in cmd and b"m3_tpu.services" \
                not in cmd
            assert _health(ep)["ok"]
            assert op.output[0].strip() == "m3_tpu_torch dbnode device cpu"
        finally:
            op.teardown()
        assert not op.heartbeat()

    def test_sigterm_exits_clean(self, tmp_path):
        op = em.Operator(str(tmp_path / "n"))
        op.setup(ProcessSpec("dbnode", _port_node_yaml(str(tmp_path / "n")),
                             str(tmp_path / "n"), device="cpu"))
        op.start(timeout_s=60)
        proc = op._proc
        op.stop(grace_s=30)
        assert proc.returncode == 0
        # The stop waits for the reader: the child's last line is there.
        assert op.output[-1].startswith(
            "m3_tpu_torch dbnode kernel launches {")

    def test_child_failures_raise_with_their_output(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        op = em.Operator(str(tmp_path / "n"))
        op.setup(ProcessSpec("dbnode", "bogus_key: 1\n", str(tmp_path / "n"),
                             device="cpu"))
        with pytest.raises(RuntimeError, match="bogus_key"):
            op.start(timeout_s=60)
        op.setup(ProcessSpec("dbnode", _port_node_yaml(str(tmp_path / "n")),
                             str(tmp_path / "n")))  # the card: none here
        with pytest.raises(RuntimeError, match="rc=1.*no CUDA device"):
            op.start(timeout_s=60)
        assert not op.heartbeat()
        assert not os.path.exists(tmp_path / "n" / "data")


@pytest.mark.slow
class TestEMCluster:
    def test_real_process_lifecycle(self, tmp_path):
        cluster = EMCluster(str(tmp_path))
        try:
            cluster.add_node("node0", device="cpu")
            endpoints = cluster.start_all()
            assert "node0" in endpoints and ":" in endpoints["node0"]
            assert cluster.alive()["node0"]
            assert _health(endpoints["node0"])["ok"]
            cluster.operators["node0"].kill()
            assert not cluster.alive()["node0"]
        finally:
            cluster.teardown()


@pytest.fixture
def agent(tmp_path):
    """A REAL port agent subprocess, as m3em deploys per host."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "m3_tpu_torch.em", "--workdir",
         str(tmp_path / "w")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        line = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if "em agent listening on" in line or not line:
                break
        if "em agent listening on" not in line:
            raise TimeoutError(f"agent did not start: {line!r}")
        yield line.rsplit(" ", 1)[-1].strip(), tmp_path
    finally:
        proc.kill()
        proc.wait(timeout=10)


class TestRemoteOperator:
    def test_push_artifact_checksum_verified(self, agent):
        endpoint, tmp_path = agent
        op = RemoteOperator(endpoint)
        try:
            path = op.push_artifact("rules.yml", b"mapping: []\n")
            assert os.path.basename(path) == "rules.yml"
            with pytest.raises(RuntimeError, match="checksum"):
                op._request({"op": "push", "name": "bad.bin", "data": b"xyz",
                             "sha256": hashlib.sha256(b"other").hexdigest()})
            assert not os.path.exists(tmp_path / "w" / "bad.bin")
        finally:
            op.teardown()

    def test_full_lifecycle_through_agent(self, agent):
        endpoint, tmp_path = agent
        op = RemoteOperator(endpoint)
        workdir = str(tmp_path / "node")
        cfg = (
            "listen_address: 127.0.0.1:0\n"
            f"data_dir: {workdir}/data\n"
            "num_shards: 8\n"
            "coordinator:\n  namespace: default\n"
        )
        try:
            digest = op.setup(ProcessSpec("dbnode", cfg, workdir,
                                          device="cpu"))
            assert digest == hashlib.sha256(cfg.encode()).hexdigest()
            assert not op.heartbeat()
            ep = op.start(timeout_s=60)
            assert op.heartbeat()
            assert ep.count(":") == 1 and _health(ep)["ok"]
            op.kill()
            assert not op.heartbeat()
        finally:
            op.teardown()

    def test_emcluster_with_remote_node(self, agent, tmp_path):
        endpoint, agent_tmp = agent
        cluster = EMCluster(str(tmp_path / "em"))
        cluster.add_remote_node("node0", endpoint, device="cpu")
        try:
            eps = cluster.start_all()
            assert "node0" in eps
            assert cluster.alive() == {"node0": True}
        finally:
            cluster.teardown()
        assert cluster.operators == {}
        assert os.path.exists(agent_tmp / "w" / "config.yml")
        assert not os.path.exists(tmp_path / "em" / "node0")

    def test_teardown_best_effort_past_unreachable_agent(self, tmp_path):
        """One dead agent must not leak the remaining nodes' processes."""
        cluster = EMCluster(str(tmp_path / "em"))
        cluster.operators["dead"] = RemoteOperator("127.0.0.1:1", timeout=0.5)
        local = cluster.add_node("local0", device="cpu")
        try:
            local.start(timeout_s=60)
            assert local.heartbeat()
            with pytest.raises(RuntimeError, match="dead"):
                cluster.teardown()
        finally:
            local.teardown()
        assert cluster.operators == {}
        assert not local.heartbeat()


def test_default_config_text_equals_reference():
    from m3_tpu import em as jem

    assert em._default_dbnode_yaml("/w") == jem._default_dbnode_yaml("/w")
    assert em.checksum(__file__) == jem.checksum(__file__)
    assert np.array_equal(
        [f.name for f in em.dataclasses.fields(ProcessSpec)][:3],
        [f.name for f in jem.dataclasses.fields(jem.ProcessSpec)])
