"""The port's reverse index and PromQL over stored data, on the CPU:
m3_tpu_torch.index against m3_tpu.index on the same documents, and a
Database with its namespace index enabled holding the reference
benchmark's PromQL corpus (written through write_batch with tags, then
sealed), queried through query_ids, aggregate_tags and
Engine(LocalStorage(db), device="cpu").execute_range_ref against
m3_tpu.query.Engine(LocalStorage(ref_db), mesh=None).execute_range_ref
over the same writes (each package's interpreter: these queries take the
compiled route by default, which tests/test_torch_plan_compile.py holds).

Index answers (id lists, tag sets) must be identical. Query answers must
give the same series tags in the same order, NaN at the same cells, and
values within rtol 1e-5, atol 1e-8 (the oracle tolerance of bench.py's
compiled-vs-interpreter check, as tests/test_torch_query.py uses).
mesh=None keeps the reference on one device.

The port's block cache for this module admits a block at its first touch
(admit_after=1): every read here is a whole-block decode and then hits,
which keeps the decode kernel's plain version (a Python loop over the
512-point window) to one run a block. The cold one-row path has its own
tests in tests/test_torch_storage.py and tests/test_torch_block_cache.py."""

import numpy as np
import pytest

from m3_tpu.index import query as jq
from m3_tpu.index.namespace_index import NamespaceIndex as JNamespaceIndex
from m3_tpu.parallel.sharding import ShardSet as JShardSet
from m3_tpu.query import Engine as JEngine
from m3_tpu.query.storage import LocalStorage as JLocalStorage
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu_torch.index import query as pq
from m3_tpu_torch.index.namespace_index import NamespaceIndex
from m3_tpu_torch.parallel.sharding import ShardSet
from m3_tpu_torch.query.executor import Engine
from m3_tpu_torch.query.model import MatchType, Matcher, matchers_to_index_query
from m3_tpu_torch.query.storage import LocalStorage
from m3_tpu_torch.storage import block_cache
from m3_tpu_torch.storage.database import Database
from m3_tpu_torch.testing import DictStorage, promql_corpus, write_corpus
from m3_tpu_torch.utils import xtime
from m3_tpu_torch.utils.hbm import HBMBudget
from test_torch_query import AGG_QUERIES, MORE_QUERIES, PHASE_QUERIES

S = 1_000_000_000
NS = b"default"


def _q(mod, kind, *args):
    """One query built by either package's constructors."""
    if kind == "all":
        return mod.AllQuery()
    if kind == "term":
        return mod.new_term(*args)
    if kind == "re":
        return mod.new_regexp(*args)
    if kind == "not":
        return mod.new_negation(_q(mod, *args[0]))
    if kind == "and":
        return mod.new_conjunction(*(_q(mod, *a) for a in args))
    return mod.new_disjunction(*(_q(mod, *a) for a in args))


INDEX_QUERIES = [
    ("all",),
    ("term", b"__name__", b"bench_requests"),
    ("term", b"host", b"host-003"),
    ("term", b"host", b"nope"),
    ("re", b"i", b"1.*"),
    ("re", b"host", b"host-00[0-2]"),
    ("not", ("term", b"__name__", b"bench_metric")),
    ("and", ("term", b"__name__", b"bench_requests"),
     ("not", ("re", b"host", b"host-00[01]"))),
    ("or", ("term", b"i", b"7"), ("re", b"host", b"host-005")),
]


@pytest.fixture(scope="module")
def corpus():
    series, t = promql_corpus(36, 11)
    series.update(promql_corpus(36, 17, hosts=6, metric=b"bench_requests")[0])
    return series, t


@pytest.fixture(scope="module", autouse=True)
def admit_at_first_touch():
    saved = block_cache._CACHE
    block_cache._CACHE = block_cache.DeviceBlockCache(
        budget=HBMBudget(256 << 20), admit_after=1)
    yield block_cache._CACHE
    block_cache._CACHE = saved


@pytest.fixture(scope="module")
def dbs(corpus):
    """The same writes into the port's Database (device="cpu") and the
    reference's: 4 shards, namespace index on, 6 grid steps (1 minute) a
    write_batch, then a tick past the block end + buffer_past seals."""
    series, t = corpus
    now = {"t": int(t[0])}
    db = Database(ShardSet(4), clock=lambda: now["t"], device="cpu")
    jdb = JDatabase(JShardSet(4), clock=lambda: now["t"])
    for d in (db, jdb):
        d.ensure_namespace(NS)
        now["t"] = int(t[0])
        write_corpus(d, NS, series, t, now, steps_per_batch=6)
    now["t"] = int(t[-1]) - int(t[-1]) % (2 * xtime.HOUR) \
        + 2 * xtime.HOUR + 11 * xtime.MINUTE
    assert db.tick() == jdb.tick() == {"sealed": 4, "expired": 0}
    return db, jdb


@pytest.mark.parametrize("spec", INDEX_QUERIES, ids=str)
def test_namespace_index_matches_reference(spec, corpus):
    series, t = corpus
    idx = NamespaceIndex(clock=lambda: int(t[0]))
    jidx = JNamespaceIndex(clock=lambda: int(t[0]))
    items = [(sid, e["tags"]) for sid, e in series.items()]
    idx.insert_many(items[:40])
    jidx.insert_many(items[:40])
    for sid, tags in items[40:]:
        idx.insert(sid, tags, int(t[-1]) + 5 * xtime.HOUR)
        jidx.insert(sid, tags, int(t[-1]) + 5 * xtime.HOUR)
    for lo, hi, limit in ((0, 2**63 - 1, 0), (int(t[0]), int(t[-1]), 0),
                          (0, 2**63 - 1, 5)):
        got = idx.query(_q(pq, *spec), lo, hi, limit=limit)
        want = jidx.query(_q(jq, *spec), lo, hi, limit=limit)
        assert got == want
    assert idx.fields() == jidx.fields()
    for f in idx.fields():
        assert idx.aggregate_terms(f) == jidx.aggregate_terms(f)


def test_matchers_compile_to_the_same_queries():
    ms = [Matcher(MatchType.EQUAL, b"__name__", b"bench_requests"),
          Matcher(MatchType.NOT_EQUAL, b"host", b"host-001"),
          Matcher(MatchType.REGEXP, b"i", b"1.*"),
          Matcher(MatchType.NOT_REGEXP, b"i", b"12")]
    from m3_tpu.query import model as jmodel

    for k in range(len(ms) + 1):
        jms = [jmodel.Matcher(jmodel.MatchType(int(m.type)), m.name, m.value)
               for m in ms[:k]]
        assert repr(matchers_to_index_query(ms[:k])) == repr(
            jmodel.matchers_to_index_query(jms))


@pytest.mark.parametrize("spec", INDEX_QUERIES, ids=str)
def test_query_ids_and_aggregate_tags_match_reference(spec, dbs, corpus):
    db, jdb = dbs
    _, t = corpus
    lo, hi = int(t[0]), int(t[-1])
    assert db.query_ids(NS, _q(pq, *spec), lo, hi) == \
        jdb.query_ids(NS, _q(jq, *spec), lo, hi)
    for name_only in (False, True):
        assert db.aggregate_tags(NS, _q(pq, *spec), lo, hi,
                                 name_only=name_only) == \
            jdb.aggregate_tags(NS, _q(jq, *spec), lo, hi, name_only=name_only)
    assert db.aggregate_tags(NS, _q(pq, *spec), lo, hi,
                             filter_names=[b"host"]) == \
        jdb.aggregate_tags(NS, _q(jq, *spec), lo, hi, filter_names=[b"host"])


def test_stored_series_read_back_exactly(dbs, corpus, admit_at_first_touch):
    """Every series written reads back from its sealed block bit for bit,
    each block decoded once."""
    db, _ = dbs
    series, t = corpus
    got = LocalStorage(db, NS).fetch_raw([], int(t[0]), int(t[-1]) + 1)
    assert sorted(got) == sorted(series)
    for sid, e in series.items():
        np.testing.assert_array_equal(got[sid]["t"], t)
        assert (got[sid]["v"].view(np.uint64) == e["v"].view(np.uint64)).all()
        assert got[sid]["tags"] == e["tags"]
    assert admit_at_first_touch.stats()["admitted"] == 4


def _same(got, ref, what):
    assert [x.id() for x in got.series_tags] == [
        x.id() for x in ref.series_tags], what
    g, r = np.asarray(got.values), np.asarray(ref.values)
    assert g.shape == r.shape, what
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=what)
    np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-8, equal_nan=True,
                               err_msg=what)


@pytest.mark.parametrize("q", PHASE_QUERIES + list(AGG_QUERIES)
                         + list(MORE_QUERIES))
def test_local_storage_queries_match_reference(q, dbs, corpus):
    """Engine(LocalStorage(db)) against the reference's interpreter over
    its own LocalStorage, and against the port over DictStorage of the
    written corpus (the engine fetches [start - lookback, end + 1), so
    the stored data's time filter changes no answer)."""
    db, jdb = dbs
    series, t = corpus
    start, end, step = int(t[30]), int(t[-1]), 30 * S
    got = Engine(LocalStorage(db, NS), device="cpu").execute_range_ref(
        q, start, end, step)
    ref = JEngine(JLocalStorage(jdb, NS), mesh=None).execute_range_ref(
        q, start, end, step)
    _same(got, ref, q)
    _same(got, Engine(DictStorage(series), device="cpu").execute_range(
        q, start, end, step), q)


def test_complete_tags_through_local_storage(dbs, corpus):
    db, jdb = dbs
    _, t = corpus
    ms = [Matcher(MatchType.EQUAL, b"__name__", b"bench_requests")]
    from m3_tpu.query import model as jmodel

    jms = [jmodel.Matcher(jmodel.MatchType.EQUAL, b"__name__",
                          b"bench_requests")]
    for name_only in (False, True):
        assert LocalStorage(db, NS).complete_tags(
            ms, int(t[0]), int(t[-1]), name_only=name_only) == \
            JLocalStorage(jdb, NS).complete_tags(
                jms, int(t[0]), int(t[-1]), name_only=name_only)
