"""The port's replicating client and node server (m3_tpu_torch.client,
m3_tpu_torch.rpc) against the reference's, on the CPU.

A port ClusterHarness(device="cpu") and a reference ClusterHarness (3
nodes, replication factor 3, 16 shards, as tests/test_rpc_client.py:145-149)
get the same writes through their own Session: 32 tagged series x 12
points into one block that a tick seals, conflicting values written
straight into each replica's storage at one timestamp of the sealed
block and one of the buffer, then 2 more points into the buffers. Fetch,
fetch_tagged (sealed tiles through the decode kernel's plain version,
plus the buffer sidecar), aggregate, query_ids, the peer metadata and
tile streams, and the replica merge under all four conflict strategies
give equal results. The packages also talk to each other: a port Session
against reference NodeServers, and a reference Session against port
NodeServers. Quorum with a node taken away by its FaultProxy, and a
replica whose kernel raises, count as failed replicas under the
consistency rule."""

import json

import numpy as np
import pytest
import torch

from m3_tpu.client import (ConflictStrategy as JConflictStrategy,
                           ConsistencyError as JConsistencyError,
                           Session as JSession,
                           SessionOptions as JSessionOptions)
from m3_tpu.client.decode import merge_replica_points as jmerge
from m3_tpu.cluster import placement as jpl
from m3_tpu.cluster import topology as jtopo
from m3_tpu.index import query as jiq
from m3_tpu.testing import ClusterHarness as JClusterHarness
from m3_tpu.testing import FaultPlan as JFaultPlan
from m3_tpu.utils.retry import RetryOptions as JRetryOptions
from m3_tpu_torch.client import (ConflictStrategy, ConsistencyError,
                                 RemoteError, Session, SessionOptions)
from m3_tpu_torch.client.decode import merge_replica_points
from m3_tpu_torch.cluster import placement as pl
from m3_tpu_torch.cluster import topology as topo
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.parallel import guard
from m3_tpu_torch.rpc import NodeService
from m3_tpu_torch.testing.cluster import ClusterHarness, make_node_server
from m3_tpu_torch.testing.faultnet import FaultPlan
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.retry import RetryOptions

NS = b"default"
BLOCK = 2 * xtime.HOUR
T0 = (1_600_000_000 * xtime.SECOND // BLOCK) * BLOCK
START = T0 + 12 * 10 * xtime.SECOND
N_SERIES = 32
CONFLICT = [5.0, 5.0, 3.0]  # node0..node2: a 2-1 majority
STRATEGIES = ("LAST_PUSHED", "HIGHEST_VALUE", "LOWEST_VALUE",
              "HIGHEST_FREQUENCY_VALUE")

PORT = dict(Harness=lambda **k: ClusterHarness(device="cpu", **k),
            Session=lambda topology, opts: Session(topology, opts,
                                                   device="cpu"),
            Opts=SessionOptions, Strategy=ConflictStrategy, iq=iq,
            topo=topo, pl=pl, ConsistencyError=ConsistencyError,
            FaultPlan=FaultPlan, RetryOptions=RetryOptions)
REF = dict(Harness=JClusterHarness, Session=JSession, Opts=JSessionOptions,
           Strategy=JConflictStrategy, iq=jiq, topo=jtopo, pl=jpl,
           ConsistencyError=JConsistencyError, FaultPlan=JFaultPlan,
           RetryOptions=JRetryOptions)


def _ids():
    return [b"sess.%03d" % i for i in range(N_SERIES)]


def _tags(i):
    return {b"__name__": b"sess", b"i": b"%d" % i, b"grp": b"g%d" % (i % 4)}


def _seed(pkg, root):
    """Build one package's cluster and write the module's data through
    its own Session. Returns (harness, session)."""
    h = pkg["Harness"](n_nodes=3, replica_factor=3, num_shards=16,
                       start_ns=START, data_root=root)
    # Writes at ALL: every replica holds every point before the tick (a
    # MAJORITY write may still be in the third replica's queue).
    s = pkg["Session"](h.topology, pkg["Opts"](
        timeout_s=10, write_consistency=pkg["topo"].ConsistencyLevel.ALL))
    ids = _ids()
    rng = np.random.default_rng(41)
    vals = np.cumsum(rng.poisson(5.0, (12, N_SERIES)), axis=0).astype(float)
    for k in range(12):
        s.write_batch(NS, ids, np.full(N_SERIES, T0 + k * 10 * xtime.SECOND),
                      vals[k], [_tags(i) for i in range(N_SERIES)])
    # Replicas diverge at one sealed timestamp of two series.
    for node, v in zip(h.nodes.values(), CONFLICT):
        for sid in ids[:2]:
            node.db.write(NS, sid, T0 + 5 * xtime.SECOND, v)
    h.clock.advance(BLOCK + 11 * xtime.MINUTE)
    h.tick_all()
    now = h.clock.now_ns
    for k in range(2):
        s.write_batch(NS, ids, np.full(N_SERIES, now - k * xtime.SECOND),
                      -np.arange(N_SERIES, dtype=float) - k,
                      [_tags(i) for i in range(N_SERIES)])
    # ... and at one buffered timestamp of the same series.
    for node, v in zip(h.nodes.values(), CONFLICT):
        for sid in ids[:2]:
            node.db.write(NS, sid, now - 5 * xtime.SECOND, v + 100)
    return h, s


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    port = _seed(PORT, str(tmp_path_factory.mktemp("port")))
    ref = _seed(REF, str(tmp_path_factory.mktemp("ref")))
    yield port, ref
    for h, s in (port, ref):
        s.close()
        h.close()


def _session(pkg, topology, **kw):
    return pkg["Session"](topology, pkg["Opts"](timeout_s=10, **kw))


def _same_series(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for sid, e in want.items():
        g = got[sid]
        assert g["tags"] == e["tags"], sid
        assert np.asarray(g["t"]).tobytes() == np.asarray(e["t"]).tobytes()
        assert np.asarray(g["v"], np.float64).tobytes() == \
            np.asarray(e["v"], np.float64).tobytes(), sid


def _queries(m):
    return [m.TermQuery(b"__name__", b"sess"),
            m.ConjunctionQuery((m.TermQuery(b"grp", b"g1"),
                                m.RegexpQuery(b"i", b"1.*"))),
            m.NegationQuery(m.TermQuery(b"grp", b"g0"))]


def _all_read(pkg, strategy):
    rc = pkg["topo"].ReadConsistencyLevel.ALL
    return dict(read_consistency=rc,
                conflict_strategy=pkg["Strategy"][strategy])


@pytest.mark.parametrize("k", range(3))
def test_fetch_tagged_equals_the_reference(clusters, k):
    (h, s), (jh, js) = clusters
    end = h.clock.now_ns + 1
    got = s.fetch_tagged(NS, _queries(iq)[k], 0, end)
    want = js.fetch_tagged(NS, _queries(jiq)[k], 0, end)
    assert got and len(got) == len(want)
    _same_series({sid: e for sid, e in got.items() if sid not in _ids()[:2]},
                 {sid: e for sid, e in want.items()
                  if sid not in _ids()[:2]})
    for sid, e in got.items():
        assert len(e["t"]) == (16 if sid in _ids()[:2] else 14)


def test_fetch_equals_the_reference(clusters):
    (h, s), (jh, js) = clusters
    end = h.clock.now_ns + 1
    for sid in _ids()[2::5]:
        t, v = s.fetch(NS, sid, 0, end)
        jt, jv = js.fetch(NS, sid, 0, end)
        assert t.tobytes() == jt.tobytes() and v.tobytes() == jv.tobytes()
        assert len(t) == 14


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_replica_merge_equals_the_reference(clusters, strategy):
    """Every replica read (consistency ALL), the conflicting timestamps
    (one in a sealed tile, one in the buffer) resolved per strategy.
    fetch merges all replicas at once: every strategy but LAST_PUSHED
    equals the reference's and picks the expected value. fetch_tagged
    folds the replicas in pairwise as they answer, so under LAST_PUSHED
    and HIGHEST_FREQUENCY_VALUE its pick depends on the arrival order, in
    the reference too: there both packages pick one of the replicas'
    values, and every other cell is equal."""
    (h, _), (jh, _) = clusters
    end = h.clock.now_ns + 1
    s = _session(PORT, h.topology, **_all_read(PORT, strategy))
    js = _session(REF, jh.topology, **_all_read(REF, strategy))
    pick = {"HIGHEST_VALUE": 5.0, "LOWEST_VALUE": 3.0,
            "HIGHEST_FREQUENCY_VALUE": 5.0}.get(strategy)
    try:
        got = s.fetch_tagged(NS, iq.TermQuery(b"__name__", b"sess"), 0, end)
        want = js.fetch_tagged(NS, jiq.TermQuery(b"__name__", b"sess"),
                               0, end)
        for sid in _ids()[:2]:
            t, v = s.fetch(NS, sid, 0, end)
            jt, jv = js.fetch(NS, sid, 0, end)
            for tt in (t, jt, got[sid]["t"]):
                assert tt.tobytes() == want[sid]["t"].tobytes()
            conflicted = np.isin(t, [T0 + 5 * xtime.SECOND,
                                     h.clock.now_ns - 5 * xtime.SECOND])
            assert conflicted.sum() == 2
            order_free = [(v, jv)]
            if strategy in ("HIGHEST_VALUE", "LOWEST_VALUE"):
                order_free.append((got[sid]["v"], want[sid]["v"]))
            for a, b in order_free:
                if pick is None:
                    assert set(a[conflicted] % 100) <= set(CONFLICT)
                else:
                    assert a.tobytes() == b.tobytes()
                    assert (a[conflicted] % 100 == pick).all()
            for a in (got[sid]["v"], want[sid]["v"], v, jv):
                assert set(a[conflicted] % 100) <= set(CONFLICT)
                assert a[~conflicted].tobytes() == \
                    want[sid]["v"][~conflicted].tobytes()
        _same_series({k: v for k, v in got.items() if k not in _ids()[:2]},
                     {k: v for k, v in want.items()
                      if k not in _ids()[:2]})
    finally:
        s.close()
        js.close()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_replica_points_equals_the_reference(strategy):
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    for _ in range(20):
        parts = []
        for _r in range(int(rng.integers(1, 4))):
            n = int(rng.integers(0, 12))
            parts.append((np.sort(rng.integers(0, 10, n)).astype(np.int64),
                          rng.integers(0, 3, n).astype(np.float64)))
        ts, vs = [p[0] for p in parts], [p[1] for p in parts]
        t, v = merge_replica_points(ts, vs, ConflictStrategy[strategy])
        jt, jv = jmerge(ts, vs, JConflictStrategy[strategy])
        assert t.tobytes() == jt.tobytes() and v.tobytes() == jv.tobytes()


def test_aggregate_query_ids_and_peer_streams_equal_the_reference(clusters):
    (h, s), (jh, js) = clusters
    end = h.clock.now_ns + 1
    q, jq = iq.TermQuery(b"__name__", b"sess"), jiq.TermQuery(
        b"__name__", b"sess")
    assert s.aggregate(NS, q, 0, end) == js.aggregate(NS, jq, 0, end)
    assert s.aggregate(NS, q, 0, end, name_only=True, term_limit=2) == \
        js.aggregate(NS, jq, 0, end, name_only=True, term_limit=2)
    assert s.query_ids(NS, q, 0, end) == js.query_ids(NS, jq, 0, end)
    shard = h.nodes["node0"].db.shard_set.lookup(_ids()[5])
    meta = s.fetch_block_metadata_tiles_from_peers(NS, shard, 0, end)
    jmeta = js.fetch_block_metadata_tiles_from_peers(NS, shard, 0, end)
    assert sorted(meta) == sorted(jmeta) == ["node0", "node1", "node2"]
    for host in meta:
        assert meta[host]["ids"] == jmeta[host]["ids"]
        assert meta[host]["tags"] == jmeta[host]["tags"]
        for b, jb in zip(meta[host]["blocks"], jmeta[host]["blocks"]):
            assert b["bs"] == jb["bs"] and (b["pos"] == jb["pos"]).all()
            assert (b["sums"] == jb["sums"]).all()
    got = s.fetch_bootstrap_blocks_from_peers(NS, shard, 0, end,
                                              exclude_host="node0")
    want = js.fetch_bootstrap_blocks_from_peers(NS, shard, 0, end,
                                                exclude_host="node0")
    assert sorted(got) == sorted(want) and got
    for sid in want:
        for b, jb in zip(got[sid]["blocks"], want[sid]["blocks"]):
            assert np.asarray(b["words"]).tobytes() == \
                np.asarray(jb["words"]).tobytes()
            assert (b["bs"], b["nbits"], b["npoints"], b["window"],
                    b["time_unit"]) == (jb["bs"], jb["nbits"], jb["npoints"],
                                        jb["window"], jb["time_unit"])


def _topology_of(pkg, placement):
    """A StaticTopology of `pkg` over the other package's placement, moved
    through its JSON."""
    p = pkg["pl"].Placement.from_json(json.loads(json.dumps(
        placement.to_json())), placement.version)
    return pkg["topo"].StaticTopology(p)


@pytest.mark.parametrize("direction", ["port-session-ref-nodes",
                                       "ref-session-port-nodes"])
def test_sessions_talk_across_packages(clusters, direction):
    """A Session of one package against the NodeServers of the other reads
    what that package's own Session reads, and writes what it reads back."""
    (h, s), (jh, js) = clusters
    if direction == "port-session-ref-nodes":
        client, own, nodes = PORT, js, jh
    else:
        client, own, nodes = REF, s, h
    m = client["iq"]
    other = iq if client is REF else jiq
    cross = _session(client, _topology_of(client, nodes.placement_svc.get()))
    try:
        end = nodes.clock.now_ns + 1
        q = m.TermQuery(b"__name__", b"sess")
        got = cross.fetch_tagged(NS, q, 0, end)
        want = own.fetch_tagged(NS, other.TermQuery(b"__name__", b"sess"),
                                0, end)
        keep = [sid for sid in want if sid not in _ids()[:2]]
        _same_series({k: got[k] for k in keep}, {k: want[k] for k in keep})
        sid = b"cross.%s" % direction.encode()
        ts = nodes.clock.now_ns - np.arange(3) * xtime.SECOND
        cross.write_batch(NS, [sid] * 3, ts, [1.5, 2.5, 3.5],
                          [{b"__name__": b"cross"}] * 3)
        t, v = own.fetch(NS, sid, 0, end)
        assert t.tolist() == sorted(ts.tolist()) and v.tolist() == \
            [3.5, 2.5, 1.5]
        tiles = cross.fetch_block_tiles_from_host(
            "node1", NS, nodes.nodes["node1"].db.shard_set.lookup(keep[0]),
            [{"bs": T0, "ids": [keep[0]]}])
        assert tiles["blocks"][0]["ids"] == [keep[0]]
    finally:
        cross.close()


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_quorum_with_a_node_taken_away(pkg, tmp_path):
    """One node's FaultProxy refuses new connections and resets live ones:
    majority writes still acknowledge and majority reads give the written
    values; a read or a write at ALL raises ConsistencyError."""
    h = pkg["Harness"](n_nodes=3, replica_factor=3, num_shards=4,
                       start_ns=START, data_root=str(tmp_path),
                       fault_plan=pkg["FaultPlan"]())
    fast = dict(retry=pkg["RetryOptions"](max_attempts=1), timeout_s=3)
    s = pkg["Session"](h.topology, pkg["Opts"](**fast))
    try:
        now = h.clock.now_ns
        s.write(NS, b"q.a", now - xtime.SECOND, 1.0, {b"__name__": b"q"})
        h.nodes["node2"].proxy.plan = pkg["FaultPlan"](refuse=1.0, reset=1.0)
        s.write(NS, b"q.a", now, 2.0, {b"__name__": b"q"})
        t, v = s.fetch(NS, b"q.a", 0, now + 1)
        assert v.tolist() == [1.0, 2.0]
        res = s.fetch_tagged(NS, pkg["iq"].TermQuery(b"__name__", b"q"),
                             0, now + 1)
        assert res[b"q.a"]["v"].tolist() == [1.0, 2.0]
        rc = pkg["topo"].ReadConsistencyLevel.ALL
        wc = pkg["topo"].ConsistencyLevel.ALL
        strict = pkg["Session"](h.topology, pkg["Opts"](
            read_consistency=rc, write_consistency=wc, **fast))
        try:
            with pytest.raises(pkg["ConsistencyError"]):
                strict.fetch(NS, b"q.a", 0, now + 1)
            with pytest.raises(pkg["ConsistencyError"]):
                strict.fetch_tagged(
                    NS, pkg["iq"].TermQuery(b"__name__", b"q"), 0, now + 1)
            with pytest.raises(pkg["ConsistencyError"]):
                strict.write(NS, b"q.a", now + xtime.SECOND, 3.0)
        finally:
            strict.close()
    finally:
        s.close()
        h.close()


def test_a_replica_whose_kernel_raises_is_a_failed_replica(tmp_path,
                                                           monkeypatch):
    """A node whose device work raises answers with a typed error frame
    (RemoteError on the client, which keeps the connection) and counts
    as a failed replica: a majority write still acknowledges, a write at
    ALL raises ConsistencyError naming the fault. Nothing re-runs on the
    host."""
    h = ClusterHarness(n_nodes=3, replica_factor=3, num_shards=4,
                       start_ns=START, data_root=str(tmp_path), device="cpu")
    bad = h.nodes["node1"].db
    calls = []

    def faulty(*a, **k):
        calls.append(1)
        raise guard.KernelFault("codec.hash", "injected fault")

    monkeypatch.setattr(bad, "write_batch", faulty)
    s = Session(h.topology, SessionOptions(timeout_s=5), device="cpu")
    strict = Session(h.topology, SessionOptions(
        timeout_s=5, write_consistency=topo.ConsistencyLevel.ALL),
        device="cpu")
    try:
        now = h.clock.now_ns
        s.write(NS, b"k.a", now, 1.0)
        with pytest.raises(ConsistencyError, match="KernelFault"):
            strict.write(NS, b"k.a", now + 1, 2.0)
        assert calls and bad.namespace(NS).shards[
            bad.shard_set.lookup(b"k.a")].registry.get(b"k.a") is None
        client = s._client(h.topology.get().hosts["node1"])
        with pytest.raises(RemoteError, match="KernelFault"):
            client.call("write_batch", ns=NS, ids=[b"k.b"],
                        ts=np.array([now]), vals=np.array([1.0]))
        assert client.breaker.state == "closed"
    finally:
        s.close()
        strict.close()
        h.close()


def test_node_service_runs_on_its_database_device(monkeypatch):
    srv = make_node_server(2, device="cpu")
    try:
        assert srv.service.device.type == "cpu"
        with pytest.raises(ValueError, match="database runs on cpu"):
            NodeService(srv.service.db, device="meta")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NodeService(srv.service.db)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(topo.StaticTopology(pl.initial_placement(
                [pl.Instance("a", srv.endpoint)], 2, 1)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterHarness(n_nodes=1, replica_factor=1, num_shards=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_node_server(2)
    finally:
        srv.close()
