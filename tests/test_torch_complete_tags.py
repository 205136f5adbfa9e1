"""Port of tests/test_complete_tags.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Complete-tags / aggregate path tests (reference test model:
src/query/api/v1/handler/prometheus/native/complete_tags_test.go and
src/dbnode/network/server/tchannelthrift/node/service_test.go Aggregate
cases): the tags-only aggregate RPC on the node, session fanout merge,
storage CompleteTags, and the coordinator /api/v1/search endpoint."""

import pytest

from m3_tpu_torch.client import Session, SessionOptions
from m3_tpu_torch.coordinator.http_api import HTTPApi, HTTPError, Request
from m3_tpu_torch.index import query as iq
from m3_tpu_torch.query import Engine
from m3_tpu_torch.query.model import Matcher, MatchType
from m3_tpu_torch.query.storage import (FanoutStorage, LocalStorage, SessionStorage,
                                  _store_complete_tags)
from m3_tpu_torch.testing import ClusterHarness
from m3_tpu_torch.utils import xtime
from test_torch_cpu_default import cpu_default  # noqa: F401

NS = b"default"


@pytest.fixture(scope="module")
def cluster():
    h = ClusterHarness(n_nodes=2, replica_factor=2, num_shards=8)
    now = h.clock.now_ns
    sess = Session(h.topology, SessionOptions(timeout_s=10))
    for i, (host, dc) in enumerate([(b"web01", b"east"), (b"web02", b"east"),
                                    (b"db01", b"west")]):
        tags = {b"__name__": b"cpu", b"host": host, b"dc": dc}
        sess.write_tagged(NS, b"cpu|" + host, tags,
                          now - i * xtime.SECOND, float(i))
    sess.write_tagged(NS, b"mem|web01",
                      {b"__name__": b"mem", b"host": b"web01"},
                      now, 5.0)
    yield h, sess, now
    sess.close()
    h.close()


def test_session_aggregate_all(cluster):
    h, sess, now = cluster
    fields = sess.aggregate(NS, iq.AllQuery(), 0, now + xtime.MINUTE)
    assert fields[b"host"] == {b"web01", b"web02", b"db01"}
    assert fields[b"dc"] == {b"east", b"west"}
    assert fields[b"__name__"] == {b"cpu", b"mem"}


def test_session_aggregate_matcher_name_only_and_filter(cluster):
    h, sess, now = cluster
    q = iq.new_term(b"dc", b"east")
    fields = sess.aggregate(NS, q, 0, now + xtime.MINUTE)
    assert fields[b"host"] == {b"web01", b"web02"}
    assert fields[b"dc"] == {b"east"}

    names = sess.aggregate(NS, iq.AllQuery(), 0, now + xtime.MINUTE,
                           name_only=True)
    assert set(names) == {b"__name__", b"host", b"dc"}
    assert all(v == set() for v in names.values())

    only_host = sess.aggregate(NS, iq.AllQuery(), 0, now + xtime.MINUTE,
                               field_filter=[b"host"])
    assert set(only_host) == {b"host"}

    limited = sess.aggregate(NS, iq.AllQuery(), 0, now + xtime.MINUTE,
                             term_limit=2)
    assert len(limited[b"host"]) == 2


def test_storage_complete_tags_variants(cluster):
    h, sess, now = cluster
    end = now + xtime.MINUTE
    session_store = SessionStorage(sess, NS)
    node = next(iter(h.nodes.values()))
    local_store = LocalStorage(node.db, NS)
    matchers = (Matcher(MatchType.EQUAL, b"__name__", b"cpu"),)
    for store in (session_store, local_store):
        fields = store.complete_tags(matchers, 0, end)
        assert fields[b"host"] == {b"web01", b"web02", b"db01"}
        assert b"mem" not in fields[b"__name__"]
    # Fanout merges across stores; the generic helper also covers stores
    # with no native complete_tags (falls back to fetch_raw).
    fan = FanoutStorage([session_store, local_store])
    fields = fan.complete_tags((), 0, end)
    assert fields[b"__name__"] == {b"cpu", b"mem"}

    class RawOnly:
        def fetch_raw(self, matchers, s, e):
            return {b"x": {"tags": {b"extra": b"1"}, "t": [], "v": []}}

    assert _store_complete_tags(RawOnly(), (), 0, end, False, ()) == \
        {b"extra": {b"1"}}


def _end(now_ns):
    return str(now_ns / 1e9 + 60)


def _req(params=None, path_params=None, method="GET"):
    r = Request(method, "/api/v1/search",
                {k: [v] if isinstance(v, str) else v
                 for k, v in (params or {}).items()}, b"")
    r.path_params = path_params or {}
    return r


@pytest.fixture(scope="module")
def api(cluster):
    h, sess, now = cluster
    return HTTPApi(Engine(SessionStorage(sess, NS))), now


def test_http_complete_tags_default(api):
    api_, now = api
    out = api_.complete_tags(_req({"query": "cpu", "end": _end(now)}))
    tags = {t["key"]: set(t["values"]) for t in out["tags"]}
    assert out["hits"] == len(tags)
    assert tags["host"] == {"web01", "web02", "db01"}
    assert tags["dc"] == {"east", "west"}


def test_http_complete_tags_names_only_and_filter(api):
    api_, now = api
    out = api_.complete_tags(_req({"result": "tagNamesOnly",
                                   "end": _end(now)}))
    assert out == {"status": "success", "data": ["__name__", "dc", "host"]}
    out = api_.complete_tags(_req({"filterNameTags": ["dc"],
                                   "end": _end(now)}))
    assert [t["key"] for t in out["tags"]] == ["dc"]
    with pytest.raises(HTTPError):
        api_.complete_tags(_req({"result": "bogus"}))


def test_http_labels_and_label_values_via_index(api):
    api_, now = api
    out = api_.labels(_req({"end": _end(now)}))
    assert out["data"] == ["__name__", "dc", "host"]
    out = api_.label_values(_req({"end": _end(now)},
                                 path_params={"name": "host"}))
    assert out["data"] == ["db01", "web01", "web02"]
    # match[] narrows completion to matching series only.
    out = api_.label_values(_req({"end": _end(now),
                                  "match[]": ['{dc="west"}']},
                                 path_params={"name": "host"}))
    assert out["data"] == ["db01"]
    # Repeated match[] selectors UNION (Prometheus API contract), they are
    # not ANDed into one impossible conjunction.
    out = api_.label_values(_req({"end": _end(now),
                                  "match[]": ['{dc="west"}', '{dc="east"}']},
                                 path_params={"name": "host"}))
    assert out["data"] == ["db01", "web01", "web02"]


def test_openapi_reflects_routes(api):
    api_, now = api
    spec = api_.openapi(_req())
    assert spec["openapi"] == "3.0.0"
    assert "get" in spec["paths"]["/api/v1/search"]
    assert "get" in spec["paths"]["/api/v1/label/{name}/values"]
    assert spec["paths"]["/api/v1/query_range"]["post"]["operationId"] == \
        "query_range"
