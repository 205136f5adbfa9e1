"""The port's rule matching (m3_tpu_torch/metrics/{id,filters,rules,
batch_matcher,matcher}.py) against the reference's (m3_tpu/metrics), on
the CPU: the same ids, filters and rule sets give equal answers in both
packages.

Rule sets are built once, in the reference, and moved to the port
through `ruleset_to_json`/`ruleset_from_json` (the KV form the matcher
watches), so every case also holds the JSON round trip. Seeded corpora:
tests/test_batch_matcher.py's random rule sets and batches, and the
downsample benchmark's (bench.py _rules_corpus) at 2,000 metrics against
80 mapping and 20 rollup rules over 80 services. Results are compared
through `canon`, a plain-tuple form of the packages' dataclasses (class
name and fields), so equality is exact: no tolerance applies anywhere in
this file."""

import dataclasses
import enum
import json
import math
import random

import pytest

import bench
from m3_tpu.cluster import kv as jkv
from m3_tpu.metrics import batch_matcher as jbm
from m3_tpu.metrics import filters as jfilters
from m3_tpu.metrics import id as jid
from m3_tpu.metrics import matcher as jmatcher
from m3_tpu.metrics import rules as jrules
from m3_tpu.metrics.pipeline import Op as JOp
from m3_tpu.metrics.pipeline import Pipeline as JPipeline
from m3_tpu.metrics.policy import StoragePolicy as JStoragePolicy
from m3_tpu_torch.cluster import kv as tkv
from m3_tpu_torch.metrics import batch_matcher as tbm
from m3_tpu_torch.metrics import filters as tfilters
from m3_tpu_torch.metrics import id as tid
from m3_tpu_torch.metrics import matcher as tmatcher
from m3_tpu_torch.testing import rules_corpus
from test_batch_matcher import T0, _encode, _rand_batch, _rand_ruleset


def canon(x):
    """A package-free form of a value: dataclasses and named tuples as
    (class name, fields...), enums as (class name, value), TagsFilter as
    its pattern dict, containers element-wise, NaN as "nan"."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            canon(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if type(x).__name__ == "TagsFilter":
        return ("TagsFilter", canon(x.patterns))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple(canon(v) for v in x)
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def to_port(rs):
    """A reference RuleSet moved into the port through the KV JSON."""
    return tmatcher.ruleset_from_json(
        json.loads(json.dumps(jmatcher.ruleset_to_json(rs))))


def _tags(rng, n):
    out = []
    for _ in range(n):
        tags = {b"k%d" % rng.randrange(6): b"v%d;x" % rng.randrange(9)
                for _ in range(rng.randrange(0, 5))}
        tags = {k: v.replace(b";", b"") for k, v in tags.items()}
        out.append((b"m%d" % rng.randrange(50), tags))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_id_codec_equals_reference(seed):
    rng = random.Random(seed)
    for name, tags in _tags(rng, 200):
        mid = jid.encode(name, tags)
        assert tid.encode(name, tags) == mid
        assert tid.decode(mid) == jid.decode(mid)
        keep = [b"k%d" % k for k in range(0, 6, 2)]
        rid = jid.rollup_id(name + b".r", tags, keep)
        assert tid.rollup_id(name + b".r", tags, keep) == rid
        assert tid.is_rollup_id(rid) and jid.is_rollup_id(rid)
        assert tid.is_rollup_id(mid) == jid.is_rollup_id(mid)


GLOBS = ["foo*", "*.bar", "f?o", "[a-c]x", "{ab,cd}e", "!prod", "*", "a.b",
         "x+y", "(p)", "svc*_lat", "!*stage*", "h?", "{a,b,c}*"]
VALUES = [b"foobar", b"barfoo", b"x.bar", b"foo", b"bx", b"dx", b"cde",
          b"abe,cde", b"dev", b"prod", b"", b"a.b", b"axb", b"x+y", b"(p)",
          b"svc1_lat", b"svc_lat", b"prestage1", b"h1", b"h12", b"bzz"]


@pytest.mark.parametrize("pattern", GLOBS)
def test_filter_glob_equals_reference(pattern):
    """tests/test_metrics_model.py test_filters_glob's patterns and more:
    every value matches alike in both packages."""
    jf, tf = jfilters.Filter(pattern), tfilters.Filter(pattern)
    assert [tf.matches(v) for v in VALUES] == [jf.matches(v) for v in VALUES]


@pytest.mark.parametrize("bad", ["!", "[ab", "{a,b", "{a,[b]}"])
def test_filter_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        jfilters.Filter(bad)
    with pytest.raises(ValueError) as terr:
        tfilters.Filter(bad)
    assert str(terr.value) == str(jerr.value)


def test_tags_filter_equals_reference():
    """tests/test_metrics_model.py test_tags_filter, in both packages."""
    spec = {"__name__": "requests*", "env": "prod", "dc": "!east"}
    jf, tf = jfilters.TagsFilter(spec), tfilters.TagsFilter(spec)
    cases = [("requests.count", dict(env="prod", dc="west"), True),
             ("latency", dict(env="prod", dc="west"), False),
             ("requests.count", dict(env="dev", dc="west"), False),
             ("requests.count", dict(env="prod", dc="east"), False),
             ("requests.count", dict(dc="west"), False),
             ("requests.count", dict(env="prod"), True)]
    for name, tags, want in cases:
        mid = jid.encode(name.encode(),
                         {k.encode(): v.encode() for k, v in tags.items()})
        assert jf.matches(mid) is want and tf.matches(mid) is want
    assert tf.to_json() == jf.to_json()


def _cutover_rulesets():
    p1 = (JStoragePolicy.parse("10s:2d"),)
    p2 = (JStoragePolicy.parse("1m:40d"),)
    mapping = jrules.Rule([
        jrules.MappingRuleSnapshot("r1", 100, jfilters.TagsFilter(
            {"env": "prod"}), storage_policies=p1),
        jrules.MappingRuleSnapshot("r1", 200, jfilters.TagsFilter(
            {"env": "prod"}), storage_policies=p2),
        jrules.MappingRuleSnapshot("r1", 300, jfilters.TagsFilter(
            {"env": "prod"}), tombstoned=True)])
    target = jrules.RollupTarget(
        JPipeline((JOp.roll(b"requests.by_dc", [b"dc"]),)), p2)
    rollup = jrules.Rule([jrules.RollupRuleSnapshot(
        "roll", 0, jfilters.TagsFilter({"__name__": "requests*"}),
        (target,))])
    return jrules.RuleSet(b"default", 3, [mapping], [rollup])


@pytest.mark.parametrize("rng_", [(150, 180), (150, 250), (0, 400),
                                  (250, 350), (10, 20)])
def test_forward_match_with_cutovers_equals_reference(rng_):
    """tests/test_metrics_model.py's cutover and rollup cases over one
    rule set: stages at each cutover, a tombstone, a rollup's new id."""
    rs = _cutover_rulesets()
    ja, ta = rs.active_set(), to_port(rs).active_set()
    for name, tags in [("m", dict(env="prod")), ("m", dict(env="dev")),
                       ("requests.count", dict(dc="west", host="h1",
                                               env="prod"))]:
        mid = jid.encode(name.encode(),
                         {k.encode(): v.encode() for k, v in tags.items()})
        want = ja.forward_match(mid, *rng_)
        assert canon(ta.forward_match(mid, *rng_)) == canon(want)


@pytest.mark.parametrize("seed", range(6))
def test_batch_matcher_equals_reference(seed):
    """tests/test_batch_matcher.py's random rule sets and batches: the
    port's compiled batch match equals the reference's, and equals the
    port's own per-metric forward_match."""
    rng = random.Random(seed)
    rs = _rand_ruleset(rng)
    mids = [_encode(t) for t in _rand_batch(rng, 300)]
    want = jbm.match_batch(jbm.CompiledRuleSet(rs.active_set(), T0), mids,
                           T0)
    ta = to_port(rs).active_set()
    got = tbm.match_batch(tbm.CompiledRuleSet(ta, T0), mids, T0)
    assert canon(got) == canon(want)
    assert canon(got) == canon([ta.forward_match(m, T0, T0 + 1)
                                for m in mids])
    assert any(r.for_new_rollup_ids for r in got)


def test_filter_to_query_equals_reference():
    rng = random.Random(5)
    for rule in _rand_ruleset(rng, n_mapping=30).mapping_rules:
        for snap in rule.snapshots:
            tf = tfilters.TagsFilter(snap.filter.patterns)
            assert repr(tbm.filter_to_query(tf)) == repr(
                jbm.filter_to_query(snap.filter))


def _bench_pair(n, n_mapping, n_rollup):
    jrs, jsamples = bench._rules_corpus(n, n_mapping, n_rollup,
                                        n_services=n_mapping)
    trs, tsamples = rules_corpus(n, n_mapping, n_rollup, n_services=n_mapping)
    return jrs, jsamples, trs, tsamples


def test_rules_corpus_equals_the_benchmarks():
    """testing.rules_corpus (what the card's smoke run drives) is the
    reference benchmark's corpus: equal rule-set JSON and samples."""
    jrs, jsamples, trs, tsamples = _bench_pair(2000, 80, 20)
    assert tmatcher.ruleset_to_json(trs) == jmatcher.ruleset_to_json(jrs)
    assert canon(tsamples) == canon(jsamples)


def _matchers(jrs, trs, clock):
    js = jmatcher.RuleSetStore(jkv.MemStore())
    js.publish(jrs)
    ts = tmatcher.RuleSetStore(tkv.MemStore())
    ts.publish(trs)
    return (jmatcher.Matcher(js, b"default", clock=clock),
            tmatcher.Matcher(ts, b"default", clock=clock), js, ts)


def test_matcher_on_the_bench_corpus_equals_reference():
    """The downsample benchmark's corpus at 2,000 metrics and 100 rules:
    Matcher.match_batch (cold, then warm: all hits) and Matcher.match in
    the port equal the reference's."""
    jrs, jsamples, trs, _ = _bench_pair(2000, 80, 20)
    t0 = jsamples[0][1]
    jm, tm, _, _ = _matchers(jrs, trs, lambda: t0)
    mids = [_encode(tags) for tags, *_ in jsamples]
    want = jm.match_batch(mids)
    got = tm.match_batch(mids)
    assert canon(got) == canon(want)
    assert canon(tm.match_batch(mids)) == canon(want)
    assert (tm.hits, tm.misses) == (len(mids), len(mids))
    for mid in mids[::37]:
        assert canon(tm.match(mid)) == canon(jm.match(mid))


def test_matcher_kv_churn_equals_reference():
    """A rule-set publish mid-stream bumps the generation in both
    packages: the next batch matches the new version's rules."""
    rng = random.Random(7)
    rs1 = _rand_ruleset(rng, version=1)
    now = {"t": T0}
    jm, tm, js, ts = _matchers(rs1, to_port(rs1), lambda: now["t"])
    batch = [_encode(t) for t in _rand_batch(rng, 150)]
    assert canon(tm.match_batch(batch)) == canon(jm.match_batch(batch))
    rs2 = _rand_ruleset(random.Random(99), version=2)
    js.publish(rs2)
    ts.publish(to_port(rs2))
    got, want = tm.match_batch(batch), jm.match_batch(batch)
    assert canon(got) == canon(want)
    assert all(r.version == 2 for r in got)


def test_pipeline_and_ruleset_json_round_trip():
    """pipeline_to_json/from_json and ruleset_to_json/from_json: the
    port's JSON of a rule set equals the reference's, and each package
    reads the other's back to the same JSON."""
    for rs in (_cutover_rulesets(), _rand_ruleset(random.Random(3)),
               bench._rules_corpus(50, 40, 10)[0]):
        jjs = jmatcher.ruleset_to_json(rs)
        trs = tmatcher.ruleset_from_json(jjs)
        assert tmatcher.ruleset_to_json(trs) == jjs
        assert jmatcher.ruleset_to_json(
            jmatcher.ruleset_from_json(tmatcher.ruleset_to_json(trs))) == jjs
        for jr, tr in zip(rs.rollup_rules, trs.rollup_rules):
            for js_, ts_ in zip(jr.snapshots, tr.snapshots):
                for jt, tt in zip(js_.targets, ts_.targets):
                    pj = jmatcher.pipeline_to_json(jt.pipeline)
                    assert tmatcher.pipeline_to_json(tt.pipeline) == pj
                    assert canon(tmatcher.pipeline_from_json(pj)) == \
                        canon(jmatcher.pipeline_from_json(pj))
