"""PromQL over the replicated cluster, on the CPU: Engine over the port's
SessionStorage, FanoutStorage and RemoteStorage (m3_tpu_torch.query) equal
to Engine over one node's LocalStorage, and to the reference's Engine over
its own SessionStorage.

A port ClusterHarness(device="cpu") and a reference ClusterHarness (3
nodes, replication factor 3, 2 shards) get bench_promql_plan_agg's corpus
cut to 48 series on 4 hosts x 60 points at 10 s (seed 17) through their
own Session (with tags), sealed by a tick. The port's answers over the
session (compiled route and interpreter), a fan-out of the session and a
node, and a RemoteStorageServer in front of the session (compiled route)
must equal the LocalStorage answers exactly (the same fetched points);
against the reference's interpreter they are held to rtol 1e-5, atol 1e-8
with NaN at the same cells (tests/test_torch_index.py's bound). The
node-local reads hit the block cache after their first decode (admitted
at first touch), which keeps the decode kernel's plain version (a Python
loop over the window) to one run a block there."""

import numpy as np
import pytest

from m3_tpu.client import Session as JSession, SessionOptions as JSessionOptions
from m3_tpu.cluster.topology import ConsistencyLevel as JConsistencyLevel
from m3_tpu.query import Engine as JEngine
from m3_tpu.query import model as jmodel
from m3_tpu.query.remote import RemoteStorage as JRemoteStorage
from m3_tpu.query.storage import SessionStorage as JSessionStorage
from m3_tpu.testing import ClusterHarness as JClusterHarness
from m3_tpu_torch.client import Session, SessionOptions
from m3_tpu_torch.cluster.topology import ConsistencyLevel
from m3_tpu_torch.query import plan
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.query.model import Matcher, MatchType
from m3_tpu_torch.query.remote import RemoteStorage, RemoteStorageServer
from m3_tpu_torch.query.storage import (FanoutStorage, LocalStorage,
                                        SessionStorage, _store_complete_tags)
from m3_tpu_torch.storage import block_cache
from m3_tpu_torch.testing import DictStorage, promql_corpus
from m3_tpu_torch.testing.cluster import ClusterHarness
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hbm import HBMBudget

NS = b"default"
S = xtime.SECOND
POINTS = 60
QUERIES = ("rate(bench_requests[5m])",
           "sum by (host) (rate(bench_requests[5m]))",
           "avg_over_time(bench_requests[5m])",
           "max_over_time(bench_requests[2m])",
           'bench_requests{host="host-001"}',
           "sum by (host) (increase(bench_requests[3m]))")


def _corpus():
    series, t = promql_corpus(48, 17, hosts=4, metric=b"bench_requests")
    t = t[:POINTS]
    for e in series.values():
        e["t"], e["v"] = t, e["v"][:POINTS]
    return series, t


def _seed(harness, session_cls, opts, root, series, t):
    h = harness(n_nodes=3, replica_factor=3, num_shards=2,
                start_ns=int(t[0]), data_root=root)
    s = session_cls(h.topology, opts)
    sids = list(series)
    tags = [series[sid]["tags"] for sid in sids]
    vals = np.stack([series[sid]["v"] for sid in sids], axis=1)
    for k in range(len(t)):
        h.clock.now_ns = int(t[k])  # every point inside the buffer window
        s.write_batch(NS, sids, np.full(len(sids), t[k]), vals[k], tags)
    h.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
    h.tick_all()
    return h, s


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    saved = block_cache._CACHE
    block_cache._CACHE = block_cache.DeviceBlockCache(
        budget=HBMBudget(256 << 20), admit_after=1)
    series, t = _corpus()
    port = _seed(lambda **k: ClusterHarness(device="cpu", **k),
                 lambda topology, opts: Session(topology, opts,
                                                device="cpu"),
                 SessionOptions(timeout_s=10,
                                write_consistency=ConsistencyLevel.ALL),
                 str(tmp_path_factory.mktemp("port")), series, t)
    ref = _seed(JClusterHarness, JSession,
                JSessionOptions(timeout_s=10,
                                write_consistency=JConsistencyLevel.ALL),
                str(tmp_path_factory.mktemp("ref")), series, t)
    server = RemoteStorageServer(SessionStorage(port[1], NS)).start()
    yield port, ref, server, series, t
    server.close()
    for h, s in (port, ref):
        s.close()
        h.close()
    block_cache._CACHE = saved


def _same(got, want, what, exact=True):
    assert [x.id() for x in got.series_tags] == [
        x.id() for x in want.series_tags], what
    g, w = np.asarray(got.values), np.asarray(want.values)
    assert g.shape == w.shape and np.isfinite(g).any(), what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    if exact:
        assert g.tobytes() == w.tobytes(), what
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-8,
                                   equal_nan=True, err_msg=what)


@pytest.fixture
def plan_floor(monkeypatch):
    """The compiled route at this test's small grids."""
    monkeypatch.setattr(plan, "PLAN_MIN_CELLS", 1)


@pytest.mark.parametrize("q", QUERIES)
def test_session_fanout_and_remote_storage_equal_local_storage(
        stores, q, plan_floor):
    (h, s), _, server, series, t = stores
    start, end, step = int(t[30]), int(t[-1]), 30 * S
    local = LocalStorage(h.nodes["node0"].db, NS)
    remote = RemoteStorage(server.endpoint, timeout_s=10)
    try:
        want = Engine(local, device="cpu").execute_range(q, start, end, step)
        _same(want, Engine(DictStorage(series), device="cpu").execute_range(
            q, start, end, step), q)
        for name, store in (
                ("session", SessionStorage(s, NS)),
                ("fanout", FanoutStorage([SessionStorage(s, NS), local])),
                ("remote", remote)):
            eng = Engine(store, device="cpu")
            _same(eng.execute_range(q, start, end, step), want,
                  f"{q} over {name}")
            assert eng.last_route()["route"] == "compiled"
        _same(Engine(SessionStorage(s, NS), device="cpu").execute_range_ref(
            q, start, end, step), Engine(local, device="cpu")
            .execute_range_ref(q, start, end, step), q)
    finally:
        remote.close()


@pytest.mark.parametrize("q", QUERIES)
def test_session_storage_equals_the_reference(stores, q):
    (h, s), (jh, js), _, _, t = stores
    start, end, step = int(t[30]), int(t[-1]), 30 * S
    got = Engine(SessionStorage(s, NS), device="cpu").execute_range_ref(
        q, start, end, step)
    want = JEngine(JSessionStorage(js, NS), mesh=None).execute_range_ref(
        q, start, end, step)
    _same(got, want, q, exact=False)


def test_fetch_raw_and_complete_tags_cross_the_wire(stores):
    """The port's RemoteStorageServer answers a reference RemoteStorage
    with the same columns the port's client reads; writes go through the
    server into the cluster; complete_tags over every store equals the
    node's index."""
    (h, s), _, server, series, t = stores
    lo, hi = int(t[0]), int(t[-1]) + 1
    ms = [Matcher(MatchType.REGEXP, b"host", b"host-00[12]")]
    jms = [jmodel.Matcher(jmodel.MatchType.REGEXP, b"host", b"host-00[12]")]
    remote = RemoteStorage(server.endpoint, timeout_s=10)
    jremote = JRemoteStorage(server.endpoint, timeout_s=10)
    try:
        got = remote.fetch_raw(ms, lo, hi)
        want = jremote.fetch_raw(jms, lo, hi)
        local = LocalStorage(h.nodes["node2"].db, NS).fetch_raw(ms, lo, hi)
        assert sorted(got) == sorted(want) == sorted(local) and len(got) == 24
        for sid, e in local.items():
            for other in (got[sid], want[sid]):
                assert other["tags"] == e["tags"]
                assert other["t"].tobytes() == e["t"].tobytes()
                assert other["v"].tobytes() == e["v"].tobytes()
        now = h.clock.now_ns
        remote.write(b"remote.w", {b"__name__": b"remote_w"}, now, 7.5)
        jremote.write(b"remote.w", {b"__name__": b"remote_w"}, now + S, 8.5)
        t_w, v_w = s.fetch(NS, b"remote.w", now - S, now + 2 * S)
        assert t_w.tolist() == [now, now + S] and v_w.tolist() == [7.5, 8.5]
        want_tags = LocalStorage(h.nodes["node1"].db, NS).complete_tags(
            ms, lo, hi)
        for store in (SessionStorage(s, NS), FanoutStorage(
                [SessionStorage(s, NS), remote]), remote):
            assert _store_complete_tags(store, ms, lo, hi, False, ()) == \
                want_tags
        assert SessionStorage(s, NS).complete_tags(
            ms, lo, hi, name_only=True) == {k: set() for k in want_tags}
    finally:
        remote.close()
        jremote.close()
