"""The churn drill's step split (m3_tpu_torch/testing/scenario.py), on the
CPU: each churn op is timed by step (the joiner's add: the new node, the
peer metadata and tile streams, the bootstrap around them, the hand-off
and the cut-over), and each read of the window carries where its seconds
went (the fanout pool, the quorum-completing call's storage read on CPU
and off it, the rest of the handler, the host pool, socket and proxy,
and the wake-up), which chip_smoke.py --churn-witness prints per step.
A drill records reads only when asked (`trace_reads`), and a Session opens
its pools and fanout workers as it is built (the C2 repair)."""

import time

import pytest

from m3_tpu_torch.client.session import Session, SessionOptions
from m3_tpu_torch.cluster.placement import Instance, initial_placement
from m3_tpu_torch.cluster.topology import StaticTopology
from m3_tpu_torch.testing import scenario
from m3_tpu_torch.testing.cluster import ClusterHarness
from m3_tpu_torch.testing.scenario import (ChurnScenario, ChurnScenarioOptions,
                                           ReadCall, ReadTrace)
from m3_tpu_torch.utils import tracing

ADD_STEPS = ("new node", "peer metadata", "peer tiles", "peer stream",
             "bootstrap", "hand-off", "mark available")


@pytest.fixture(scope="module")
def drill():
    d = ChurnScenario(ChurnScenarioOptions(device="cpu", trace_reads=True))
    real_open = d._window_open

    def window_open():
        # The serving session's pools as the SLO'd window opens.
        d.pools_at_open = {h: len(c._free)
                           for h, c in d.session._clients.items()}
        d.workers_at_open = len(d.session._pool._threads)
        real_open()

    d._window_open = window_open
    try:
        d.result = d.run()
        yield d
    finally:
        d.close()


def test_joiner_add_records_every_step(drill):
    steps = [s for s in drill.op_steps if s.op == "add joiner1"]
    assert {s.step for s in steps} == set(ADD_STEPS)
    shards = [s for s in steps if s.step == "peer stream"]
    assert len(shards) >= 1 and all(s.seconds >= 0 for s in steps)
    # The op's steps nest: each shard's stream inside the bootstrap, the
    # metadata and tiles inside their shard's stream.
    boot, = [s for s in steps if s.step == "bootstrap"]
    for s in steps:
        if s.step in ("peer metadata", "peer tiles", "peer stream"):
            assert boot.start <= s.start
            assert s.start + s.seconds <= boot.start + boot.seconds + 1e-6
    streamed = sum(s.seconds for s in shards)
    assert streamed <= boot.seconds + 1e-6
    assert sum(s.seconds for s in steps if s.step != "peer stream"
               and s.step.startswith("peer")) <= streamed + 1e-6
    new, = [s for s in steps if s.step == "new node"]
    assert new.start + new.seconds <= boot.start + 1e-6


def test_every_op_and_the_convergence_are_split(drill):
    ops = {s.op.split()[0] for s in drill.op_steps}
    assert {"add", "repair", "remove", "replace", "converge"} <= ops
    assert [s.step for s in drill.op_steps if s.op.startswith("repair")][-1] \
        == "repair"


def test_reads_carry_their_waits(drill):
    reads = [r for r in drill.read_traces if r.outcome == "ok"]
    assert len(reads) == len(drill.result.report.select(kind="read",
                                                        outcome="ok"))
    served = [c for r in reads for c in r.calls if c.handler_s is not None]
    assert served and all(c.read_s is not None and c.read_cpu_s is not None
                          for c in served)
    for r in reads:
        waits = r.waits()
        assert set(waits) == {"fanout pool", "read cpu", "read not running",
                              "handler rest", "host pool, socket, proxy",
                              "after quorum"}
        assert all(v >= 0 for v in waits.values())
        assert sum(waits.values()) <= r.end - r.start + 1e-6


def test_waits_follow_the_quorum_completing_call():
    calls = [ReadCall("a", 1.0, 1.5, 16, handler_s=0.4, read_s=0.3,
                      read_cpu_s=0.1),
             ReadCall("b", 1.1, 2.0, 16, handler_s=0.5, read_s=0.45,
                      read_cpu_s=0.05),
             ReadCall("c", 1.2, 3.0, 0)]
    waits = ReadTrace(0.9, 2.1, 2, calls, "ok").waits()
    assert waits == pytest.approx({
        "fanout pool": 0.1, "read cpu": 0.05, "read not running": 0.4,
        "handler rest": 0.05, "host pool, socket, proxy": 0.4,
        "after quorum": 0.1})
    assert ReadTrace(0.0, 1.0, 2, [], "ok").waits() == {
        "no replica call": 1.0}


def test_the_window_opens_with_full_pools(drill):
    """The C2 repair: the serving session's connection pools and fanout
    workers are open before the SLO'd window, so its first burst dials
    nothing and starts no thread (a lazy pool holds only the one or two
    connections the seed writes used)."""
    assert len(drill.pools_at_open) == drill.opts.n_nodes
    assert all(n == drill.session.opts.pool_size
               for n in drill.pools_at_open.values())
    assert drill.workers_at_open == drill.session.opts.fanout_workers


def test_a_new_session_opens_every_host_pool(tmp_path):
    h = ClusterHarness(n_nodes=3, num_shards=4, data_root=str(tmp_path),
                       device="cpu")
    s = Session(h.topology, SessionOptions(pool_size=4, fanout_workers=6),
                device="cpu")
    try:
        clients = list(s._clients.values())
        assert len(clients) == 3 and all(len(c._free) == 4 for c in clients)
        assert len(s._pool._threads) == 6
        s.write_batch(b"default", [b"a"], [h.clock()], [1.0])
        t, v = s.fetch(b"default", b"a", 0, h.clock() + 1)
        assert list(v) == [1.0]
        # The calls took open connections and gave them back (a quorum
        # read returns before its last replica does): none was dialed.
        deadline = time.monotonic() + 10
        while any(len(c._free) != 4 for c in clients) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert all(len(c._free) == 4 for c in clients)
        assert len(s._pool._threads) == 6
    finally:
        s.close()
        h.close()


def test_a_refusing_host_keeps_a_lazy_pool(tmp_path):
    """A host that refuses as the session opens costs the session nothing
    but that host's pool: the session opens, the others fill."""
    h = ClusterHarness(n_nodes=3, num_shards=4, data_root=str(tmp_path),
                       device="cpu")
    gone = h.nodes["node2"].endpoint
    h.nodes["node2"].server.close()
    topo = StaticTopology(initial_placement(
        [Instance(id=hid, endpoint=n.endpoint)
         for hid, n in sorted(h.nodes.items())], num_shards=4,
        replica_factor=3))
    s = Session(topo, SessionOptions(pool_size=3, fanout_workers=4),
                device="cpu")
    try:
        free = {c.endpoint: len(c._free) for c in s._clients.values()}
        assert free.pop(gone) == 0
        assert list(free.values()) == [3, 3]
    finally:
        s.close()
        h.close()


def test_an_untraced_drill_installs_no_read_tracing():
    """By default the SLO'd window pays for no read tracing: the serving
    session files no replica call and no node's fetch is wrapped."""
    d = ChurnScenario(ChurnScenarioOptions(device="cpu"))
    try:
        assert type(d.session) is Session
        assert all("rpc_fetch" not in vars(n.server.service)
                   for n in d.cluster.nodes.values())
        d._fire("read")
        assert d.read_traces == []
    finally:
        d.close()


def test_a_straggling_replica_call_is_not_filed(tmp_path):
    """A replica that answers after its read's quorum (its fetch's span
    finished) files nothing, so the calls kept cannot grow."""
    h = ClusterHarness(n_nodes=3, num_shards=4, data_root=str(tmp_path),
                       device="cpu")
    s = scenario._ReadTraceSession(h.topology, SessionOptions(),
                                   device="cpu")
    try:
        client = next(iter(s._clients.values()))
        with tracing.TRACER.activate(None):
            sp = tracing.Span("client.fetch", tracing.TRACER, None)
        s._traced_call(sp, client, "health")
        assert [c.endpoint for c in s.pop_calls(sp)] == [client.endpoint]
        sp.end_ns = time.perf_counter_ns()
        s._traced_call(sp, client, "health")
        assert s.calls_by_span == {}
    finally:
        s.close()
        h.close()
