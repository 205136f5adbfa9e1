"""Environment manager: real-process cluster orchestration for dtests
(port of m3_tpu/em.py; reference: src/m3em — gRPC Operator agents doing
build/config push with checksummed transfer, process lifecycle,
heartbeating; m3em/cluster/cluster.go placement-aware setup/teardown).

Agents here manage local subprocesses of the port's service CLIs
(`python -m m3_tpu_torch.services ...`, run from the root of the checkout
that holds this package); the same Operator surface
(setup/start/stop/teardown/heartbeat) applies to a remote-agent transport.
A `ProcessSpec.device` (None: the CUDA card) is passed to the service as
`--device`; the agent's setup requests carry it. An operator reads its
child's output on a thread, so a start waits no longer than its timeout
and a chatty child never blocks on a full pipe; a stop or a kill waits for
the reader, so `output` then holds every line the child printed."""

from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

# The root of the checkout: the services run from here, so `-m` finds this
# package whatever the caller's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checksum(path: str) -> str:
    """m3em/checksum: verify pushed artifacts."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass
class ProcessSpec:
    """m3em/build + os process abstraction: what to run and with what
    config."""

    service: str                 # dbnode | aggregator
    config_yaml: str             # config file contents
    workdir: str
    device: Optional[str] = None  # --device of the service; None: the card


class Operator:
    """One host's agent (m3em/agent agent.go): setup pushes config (with
    checksum verification), start/stop manage the process, heartbeat
    reports liveness."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self._spec: Optional[ProcessSpec] = None
        self._proc: Optional[subprocess.Popen] = None
        self._drainer: Optional[threading.Thread] = None
        self._config_path: Optional[str] = None
        self.endpoint: Optional[str] = None
        self.output: List[str] = []   # the child's lines, as it prints them

    def setup(self, spec: ProcessSpec) -> str:
        """Push config; returns its checksum (agent Setup RPC)."""
        os.makedirs(spec.workdir, exist_ok=True)
        self._spec = spec
        self._config_path = os.path.join(spec.workdir, "config.yml")
        with open(self._config_path, "w") as f:
            f.write(spec.config_yaml)
        return checksum(self._config_path)

    def argv(self) -> List[str]:
        """The service's command line."""
        assert self._spec is not None, "setup first"
        argv = [sys.executable, "-m", "m3_tpu_torch.services",
                self._spec.service, "-f", self._config_path]
        if self._spec.device is not None:
            argv += ["--device", self._spec.device]
        return argv

    def start(self, timeout_s: float = 30.0):
        """Start the service and wait for its listen line (agent Start)."""
        self._proc = subprocess.Popen(
            self.argv(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=_ROOT, text=True)
        # Each child's drainer appends to its own list: a drainer of an
        # earlier child that outlived its join never writes into this one.
        self.output = out = []
        lines: "queue.Queue" = queue.Queue()
        self._drainer = threading.Thread(
            target=self._drain, args=(self._proc.stdout, lines, out),
            daemon=True)
        self._drainer.start()
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self.stop()
                raise TimeoutError("service did not report a listen address: "
                                   + "".join(self.output[-20:]))
            if line is None:
                rc = self._proc.wait(timeout=10)
                self._reap()
                raise RuntimeError(
                    f"service exited rc={rc}: {''.join(self.output[-20:])}")
            if "listening on" in line:
                self.endpoint = line.rsplit(" ", 1)[-1].strip()
                return self.endpoint

    @staticmethod
    def _drain(stream, lines: "queue.Queue", out: List[str]):
        """Every line of the child's output onto `out` (its `output`) and
        the queue start() waits on, until the child closes it."""
        for line in stream:
            out.append(line)
            lines.put(line)
        lines.put(None)

    def heartbeat(self) -> bool:
        """agent heartbeat.go: is the process alive."""
        return self._proc is not None and self._proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def stop(self, grace_s: float = 5.0):
        if self._proc is None:
            return
        self._proc.send_signal(signal.SIGTERM)
        try:
            self._proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=grace_s)
        self._reap()

    def _reap(self):
        """After the child's exit: its last lines read, the process gone."""
        if self._drainer is not None:
            self._drainer.join(timeout=10)
            self._drainer = None
        self._proc = None

    def kill(self):
        """Hard-kill for fault injection (dtest kill scenarios)."""
        if self._proc is not None:
            self._proc.kill()
            self._proc.wait(timeout=10)
            self._reap()

    def teardown(self):
        self.stop()
        self._spec = None


class EMCluster:
    """m3em/cluster: placement-aware multi-node setup/teardown over
    operators."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.operators: Dict[str, Operator] = {}

    def add_node(self, node_id: str, service: str = "dbnode",
                 config_yaml: str = "", device: Optional[str] = None
                 ) -> Operator:
        workdir = os.path.join(self.base_dir, node_id)
        op = Operator(workdir)
        op.setup(ProcessSpec(service, config_yaml or _default_dbnode_yaml(workdir),
                             workdir, device))
        self.operators[node_id] = op
        return op

    def add_remote_node(self, node_id: str, agent_endpoint: str,
                        service: str = "dbnode",
                        config_yaml: str = "",
                        device: Optional[str] = None) -> "RemoteOperator":
        """Attach a node managed by a remote agent process (m3em's
        deployment shape: one agent per host, the harness drives them all
        over the operator RPC). Paths are resolved agent-side: the config
        may reference ``{workdir}``, which the agent expands to its own
        managed directory — harness-local paths never cross the wire."""
        op = RemoteOperator(agent_endpoint)
        op.setup(ProcessSpec(
            service, config_yaml or _default_dbnode_yaml("{workdir}"), "",
            device))
        self.operators[node_id] = op
        return op

    def start_all(self) -> Dict[str, str]:
        return {nid: op.start() for nid, op in self.operators.items()}

    def alive(self) -> Dict[str, bool]:
        return {nid: op.heartbeat() for nid, op in self.operators.items()}

    def teardown(self):
        # Best-effort across all nodes: one unreachable agent must not
        # leave the remaining operators' processes running.
        errs = []
        for nid, op in self.operators.items():
            try:
                op.teardown()
            except Exception as e:  # noqa: BLE001 - must reach every node
                errs.append(f"{nid}: {e!r}")
        self.operators.clear()
        if errs:
            raise RuntimeError("teardown failed for: " + "; ".join(errs))


def _default_dbnode_yaml(workdir: str) -> str:
    return (
        "listen_address: 127.0.0.1:0\n"
        f"data_dir: {workdir}/data\n"
        "num_shards: 8\n"
        "namespaces:\n"
        "  - name: default\n"
        "    retention: 2h\n"
    )


# ---------------------------------------------------------------------------
# remote operator transport (reference: src/m3em/generated/proto/m3em.proto
# Operator service — Setup/Start/Stop/Teardown/PushFile/Heartbeat RPCs that
# the test harness drives against a per-host agent process;
# src/m3em/agent/agent.go)
# ---------------------------------------------------------------------------


class AgentServer:
    """Per-host agent process serving the Operator surface over the framed
    wire (m3em/agent). One agent manages one service process; artifact
    pushes are checksum-verified like the reference's chunked transfers."""

    def __init__(self, workdir: str, host: str = "127.0.0.1", port: int = 0):
        import socketserver

        from .rpc import wire

        self.workdir = workdir
        self._op = Operator(workdir)
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        req = wire.read_dict_frame(self.request)
                        wire.write_frame(self.request, outer._handle(req))
                except (ConnectionError, OSError, EOFError, ValueError):
                    # ValueError = malformed frame (wire.decode normalizes
                    # every corrupt-buffer case): stream desync, drop conn
                    pass

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        try:
            if op == "setup":
                workdir = req.get("workdir") or self.workdir
                # Expand agent-side path placeholders so the harness never
                # has to know this host's filesystem layout.
                cfg = req["config_yaml"].replace("{workdir}", workdir)
                digest = self._op.setup(ProcessSpec(
                    req["service"], cfg, workdir, req.get("device")))
                return {"ok": True, "checksum": digest}
            if op == "push":
                # m3em transfer.go: write artifact, verify digest.
                path = os.path.join(self.workdir, os.path.basename(req["name"]))
                os.makedirs(self.workdir, exist_ok=True)
                with open(path, "wb") as f:
                    f.write(req["data"])
                digest = checksum(path)
                if digest != req["sha256"]:
                    os.remove(path)
                    return {"ok": False,
                            "err": f"checksum mismatch: {digest}"}
                return {"ok": True, "path": path, "checksum": digest}
            if op == "start":
                return {"ok": True,
                        "endpoint": self._op.start(req.get("timeout_s", 30.0))}
            if op == "heartbeat":
                return {"ok": True, "alive": self._op.heartbeat()}
            if op == "stop":
                self._op.stop(req.get("grace_s", 5.0))
                return {"ok": True}
            if op == "kill":
                self._op.kill()
                return {"ok": True}
            if op == "teardown":
                self._op.teardown()
                return {"ok": True}
            return {"ok": False, "err": f"unknown op {op!r}"}
        except Exception as e:  # noqa: BLE001 - agent must survive bad ops
            return {"ok": False, "err": repr(e)}

    @property
    def endpoint(self) -> str:
        h, p = self._server.server_address
        return f"{h}:{p}"

    def serve_forever(self):
        self._server.serve_forever()

    def start(self) -> "AgentServer":
        import threading

        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def close(self):
        self._op.teardown()
        self._server.shutdown()
        self._server.server_close()


class RemoteOperator:
    """Drop-in for Operator that drives a remote AgentServer — the m3em
    harness side of the operator RPC (m3em/operator.go)."""

    def __init__(self, endpoint: str, timeout: float = 60.0):
        self._endpoint = endpoint
        self._timeout = timeout
        self._sock = None
        self.endpoint: Optional[str] = None  # service endpoint after start

    # Ops safe to re-execute if the reply frame was lost: everything but
    # "start", which spawns a process per call.
    _IDEMPOTENT_OPS = frozenset(
        {"setup", "push", "heartbeat", "stop", "kill", "teardown"})

    def _connect(self):
        import socket

        host, _, port = self._endpoint.rpartition(":")
        self._sock = socket.create_connection(
            (host, int(port)), timeout=self._timeout)

    def _close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _request(self, req: dict) -> dict:
        from .rpc import wire

        # A write failure on a pooled socket means the agent never saw the
        # request, so one resend on a fresh connection is always safe. A
        # failure after the write (reply lost mid-read) may mean the agent
        # already executed the op — only idempotent ops retry past that.
        for attempt in range(2):
            wrote = False
            try:
                if self._sock is None:
                    self._connect()
                # "start" legitimately blocks agent-side for up to its own
                # timeout; widen the read deadline to cover it.
                self._sock.settimeout(
                    self._timeout + float(req.get("timeout_s", 0.0)))
                wire.write_frame(self._sock, req)
                wrote = True
                try:
                    resp = wire.read_dict_frame(self._sock)
                except ValueError as e:
                    raise ConnectionError(f"agent reply desync: {e}")
                break
            except (ConnectionError, OSError, EOFError):
                self._close()
                if attempt == 1 or (
                        wrote and req.get("op") not in self._IDEMPOTENT_OPS):
                    raise
        if not resp.get("ok"):
            raise RuntimeError(resp.get("err", "agent error"))
        return resp

    def setup(self, spec: ProcessSpec) -> str:
        return self._request({"op": "setup", "service": spec.service,
                              "config_yaml": spec.config_yaml,
                              "workdir": spec.workdir,
                              "device": spec.device})["checksum"]

    def push_artifact(self, name: str, data: bytes) -> str:
        """Checksum-verified file push (m3em build/config transfer)."""
        return self._request({
            "op": "push", "name": name, "data": data,
            "sha256": hashlib.sha256(data).hexdigest()})["path"]

    def start(self, timeout_s: float = 30.0) -> str:
        self.endpoint = self._request(
            {"op": "start", "timeout_s": timeout_s})["endpoint"]
        return self.endpoint

    def heartbeat(self) -> bool:
        try:
            return self._request({"op": "heartbeat"})["alive"]
        except (OSError, RuntimeError):
            return False  # unreachable agent == dead node (m3em heartbeat)

    def stop(self, grace_s: float = 5.0):
        self._request({"op": "stop", "grace_s": grace_s})

    def kill(self):
        self._request({"op": "kill"})

    def teardown(self):
        try:
            self._request({"op": "teardown"})
        finally:
            self._close()


def _agent_main(argv=None):
    """`python -m m3_tpu_torch.em --workdir DIR [--listen H:P]` — run an
    agent."""
    import argparse

    parser = argparse.ArgumentParser(prog="m3_tpu_torch.em")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--listen", default="127.0.0.1:0")
    args = parser.parse_args(argv)
    host, _, port = args.listen.rpartition(":")
    srv = AgentServer(args.workdir, host or "127.0.0.1", int(port or 0))
    print(f"m3_tpu_torch em agent listening on {srv.endpoint}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    _agent_main()
