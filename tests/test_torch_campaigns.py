"""The port's robustness tier (m3_tpu_torch/scripts) on the CPU, held to
the reference's campaigns (scripts/fuzz_*.py, imported by path):

  * the same seed draws the same workloads: the codec campaign's
    adversarial rounds, the index documents and query trees, the
    durability corruption schedule and the cluster op walk (both packages'
    chaos rounds driven over one in-memory stand-in cluster);
  * one round of the index and durability campaigns passes in both
    packages (the codec and cluster rounds: test_torch_campaigns_verdicts.py,
    a file of their own for the reference's compiles);
  * the port's copy of the scalar oracle (ops/ref_codec.py) gives the
    reference's words and nbits bit for bit, NaN payloads and signed
    zeros included;
  * a seeded defect, patched in here only, fails the port's campaign on
    its named invariant;
  * a 3 s soak of each service child on --device cpu;
  * every entry point of m3_tpu_torch.scripts runs on the card by default
    and raises without one.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from m3_tpu_torch.ops import codec_kernels as ck
from m3_tpu_torch.ops import ref_codec
from m3_tpu_torch.scripts import (check_all, fuzz_cluster, fuzz_codec,
                                  fuzz_durability, fuzz_index,
                                  integration_smoke, soak, soak_aggregator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SEED = 7


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    return types.SimpleNamespace(**{n: _reference(n) for n in (
        "fuzz_codec", "fuzz_index", "fuzz_durability", "fuzz_cluster")})


def _same_state(a, b) -> bool:
    return a.bit_generator.state == b.bit_generator.state


# --------------------------------------------------------- workload parity


@pytest.mark.parametrize("n,w", fuzz_codec.SHAPES)
def test_codec_round_draws_equal_reference(ref, n, w):
    assert fuzz_codec.SHAPES == ref.fuzz_codec.SHAPES
    ra, rb = np.random.default_rng(SEED + w), np.random.default_rng(SEED + w)
    ts, vals, npoints = fuzz_codec.draw_round(ra, n, w)
    jts, jvals = ref.fuzz_codec.make_adversarial(rb, n, w)
    jnp = rb.integers(1, w, n).astype(np.int32)
    jnp[: n // 4] = w
    assert np.array_equal(ts, jts)
    assert np.array_equal(vals.view(np.uint64), jvals.view(np.uint64))
    assert np.array_equal(npoints, jnp)
    assert _same_state(ra, rb)


def _query_shape(q):
    kids = getattr(q, "queries", None)
    if kids is None and hasattr(q, "query"):
        kids = [q.query]
    return (type(q).__name__, getattr(q, "field", None),
            getattr(q, "value", None), getattr(q, "pattern", None),
            tuple(_query_shape(k) for k in kids or ()))


def test_index_docs_and_query_trees_equal_reference(ref):
    ra, rb = np.random.default_rng(SEED), np.random.default_rng(SEED)
    assert fuzz_index.rand_docs(ra, 300) == ref.fuzz_index.rand_docs(rb, 300)
    for _ in range(60):
        assert _query_shape(fuzz_index.rand_query(ra)) == \
            _query_shape(ref.fuzz_index.rand_query(rb))
    assert _same_state(ra, rb)


def test_durability_corruption_schedule_equals_reference(ref, tmp_path):
    ra, rb = np.random.default_rng(SEED), np.random.default_rng(SEED)
    for i in range(12):
        data = bytes(np.random.default_rng(i).integers(
            0, 256, 200 + 37 * i, dtype=np.uint8))
        a, b = tmp_path / f"a{i}", tmp_path / f"b{i}"
        a.write_bytes(data)
        b.write_bytes(data)
        assert fuzz_durability.corrupt(str(a), ra) == \
            ref.fuzz_durability._corrupt(str(b), rb)
        assert a.read_bytes() == b.read_bytes()
    assert _same_state(ra, rb)
    # A whole round of each kind draws what the reference's draws.
    seq_a = fuzz_durability.commitlog_round(ra, 0)
    seq_b = ref.fuzz_durability.commitlog_round(rb, 0)
    assert seq_a == seq_b and _same_state(ra, rb)
    fuzz_durability.fileset_round(ra, torch.device(CPU))
    ref.fuzz_durability.fileset_round(rb)
    assert _same_state(ra, rb)
    assert fuzz_durability.region_round(ra, "data", torch.device(CPU)) == \
        ref.fuzz_durability.region_round(rb, "data")
    assert _same_state(ra, rb)


class _Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, d):
        self.now += d


class _StandInCluster:
    """An in-memory stand-in for both packages' ClusterHarness: nodes by
    name, a clock and a point store every session shares; no placement
    ever holds an INITIALIZING shard, so the chaos rounds' settle has
    nothing to bootstrap and the walk is the draws alone."""

    def __init__(self, **kw):
        from m3_tpu_torch.storage.namespace import NamespaceOptions

        self.clock = _Clock(1_600_000_000_000_000_000)
        self.ns_opts = NamespaceOptions()
        self.nodes = {f"node{i}": types.SimpleNamespace(
            host_id=f"node{i}", endpoint=f"n{i}") for i in range(4)}
        self.topology = types.SimpleNamespace(store={})
        self.placement_svc = types.SimpleNamespace(
            get=lambda: types.SimpleNamespace(instances={}),
            replace_instance=lambda victim, inst: None,
            mark_instance_available=lambda iid: None)

    def _make_node(self, host_id):
        return types.SimpleNamespace(host_id=host_id, endpoint=host_id)

    def add_node(self, host_id):
        self.nodes[host_id] = node = self._make_node(host_id)
        return node

    def remove_node(self, host_id):
        del self.nodes[host_id]

    def stop_node(self, host_id):
        pass

    def tick_all(self):
        pass

    def close(self):
        pass


class _StandInSession:
    def __init__(self, topology, opts=None, device=None):
        self.store = topology.store

    def write_batch(self, ns, ids, ts, vs):
        for sid, t, v in zip(ids, ts, vs):
            self.store.setdefault(sid, {})[int(t)] = float(v)

    def fetch(self, ns, sid, start, end):
        pts = sorted(self.store.get(sid, {}).items())
        return (np.array([t for t, _ in pts], np.int64),
                np.array([v for _, v in pts], np.float64))

    def close(self):
        pass


def test_cluster_op_walk_equals_reference(ref, monkeypatch):
    for mod in (fuzz_cluster, ref.fuzz_cluster):
        monkeypatch.setattr(mod, "ClusterHarness", _StandInCluster)
        monkeypatch.setattr(mod, "Session", _StandInSession)
    tags = []
    monkeypatch.setattr(ref.fuzz_cluster.Chaos, "verify",
                        lambda self, tag: tags.append(tag.split(":", 1)[-1]))
    ra, rb = np.random.default_rng(SEED), np.random.default_rng(SEED)
    out = fuzz_cluster.run_round(ra, 12, CPU, log=lambda s: None)
    points = ref.fuzz_cluster.run_round(rb, 12)
    assert out["ops"] == tags[1:] and out["points"] == points
    assert {"add", "remove", "replace"} <= {t.split()[0] for t in out["ops"]}
    assert _same_state(ra, rb)


# ----------------------------------------------------------- verdict parity


def test_index_round_passes_in_both_packages(ref, tmp_path):
    ra, rb = np.random.default_rng(SEED), np.random.default_rng(SEED)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert fuzz_index.run_round(ra, str(tmp_path / "a")) == \
        ref.fuzz_index.run_round(rb, str(tmp_path / "b"))


def test_durability_round_passes_in_both_packages(ref):
    out = fuzz_durability.run(1, SEED, CPU, log=lambda s: None)
    rb = np.random.default_rng(SEED)
    assert ref.fuzz_durability.commitlog_round(rb, 0) == out["wal_records"]
    ref.fuzz_durability.fileset_round(rb)
    got = ref.fuzz_durability.region_round(rb, ref.fuzz_durability.REGIONS[0])
    assert out["regions"][got] == 1
    assert sum(out["filesets_detected"].values()) == 1


# -------------------------------------------------------------- the oracle


def test_oracle_copy_equals_reference_bit_for_bit():
    from m3_tpu.ops import ref_codec as jref

    rng = np.random.default_rng(SEED)
    for w in (1, 2, 16, 60, 241):
        ts = 1_700_000_000 + np.cumsum(rng.integers(1, 30, w)).astype(
            np.int64)
        for vals in (np.round(rng.normal(100, 5, w), 2),
                     np.cumsum(rng.poisson(5.0, w)).astype(np.float64),
                     np.choose(rng.integers(0, 4, w),
                               [0.0, -0.0, 5e-324, -5e-324]),
                     rng.integers(0, 2**64, w, dtype=np.uint64).view(
                         np.float64),
                     np.where(rng.random(w) < 0.3, np.nan, 1.5)):
            a, b = ref_codec.encode(ts, vals), jref.encode(ts, vals)
            assert a.nbits == b.nbits
            assert np.array_equal(a.words, b.words)
            (at, av), (bt, bv) = ref_codec.decode(a), jref.decode(b)
            assert np.array_equal(at, bt)
            assert np.array_equal(av.view(np.uint64), bv.view(np.uint64))
            assert np.array_equal(av.view(np.uint64), vals.view(np.uint64))


# ------------------------------------------------------------ non-vacuity


def test_flipped_pack_bit_fails_the_round_trip(monkeypatch):
    real = ck.pack_chunks_plain

    def flipped(*args):
        out = real(*args).clone()
        out[0, 0] ^= 1 << 20
        return out

    monkeypatch.setattr(ck, "pack_chunks_plain", flipped)
    n, w = fuzz_codec.SHAPES[0]
    with pytest.raises(AssertionError, match="^round trip: "):
        fuzz_codec.run_round(np.random.default_rng(SEED), n, w, CPU)


def test_reader_skipping_verification_fails_detection(monkeypatch):
    class Unverified(fuzz_durability.FilesetReader):
        def __init__(self, path, verify=True, **kwargs):
            super().__init__(path, verify=False, **kwargs)

    monkeypatch.setattr(fuzz_durability, "FilesetReader", Unverified)
    rng = np.random.default_rng(SEED)
    with pytest.raises(AssertionError, match="^fileset detection: "):
        for _ in range(10):
            fuzz_durability.fileset_round(rng, torch.device(CPU))


def test_index_path_dropping_a_document_fails(monkeypatch, tmp_path):
    from m3_tpu_torch.index.segment import (Document, ImmutableSegment,
                                            MutableSegment)

    real = fuzz_index.ipersist.read_segment

    def drops_one(*args, **kwargs):
        seg = real(*args, **kwargs)
        out = MutableSegment()
        for p in range(1, len(seg)):
            d = seg.doc(p)
            out.insert(Document(d.id, d.fields))
        return ImmutableSegment.from_mutable(out)

    monkeypatch.setattr(fuzz_index.ipersist, "read_segment", drops_one)
    rng = np.random.default_rng(SEED)
    with pytest.raises(AssertionError, match="^persisted: "):
        for _ in range(10):
            fuzz_index.run_round(rng, str(tmp_path))


def test_read_routed_to_a_dataless_owner_fails(monkeypatch):
    def settle_without_bootstrap(self):
        for iid in self.h.placement_svc.get().instances:
            self.h.placement_svc.mark_instance_available(iid)

    monkeypatch.setattr(fuzz_cluster.Chaos, "_settle",
                        settle_without_bootstrap)
    with pytest.raises(AssertionError, match="^read-back: "):
        fuzz_cluster.run_round(np.random.default_rng(SEED), 3, CPU,
                               log=lambda s: None)


# ------------------------------------------------------------ short soaks


def test_dbnode_soak_for_3_seconds_on_cpu():
    out = soak.run(3.0, 256.0, CPU, log=lambda s: None)
    assert out["writes"] > 0 and out["queries"] > 0
    assert out["write_errs"] == out["query_errs"] == 0
    assert out["subquery_route"] in ("interpreter", "compiled")
    assert set(out["launches"]) == {"pack", "decode", "hash", "window"}


def test_aggregator_soak_for_3_seconds_on_cpu(monkeypatch):
    # One-second windows, so that three seconds close whole windows.
    monkeypatch.setattr(soak_aggregator, "RESOLUTION_S", 1)
    monkeypatch.setattr(soak_aggregator, "RESOLUTION_NS", 10**9)
    monkeypatch.setattr(soak_aggregator, "POLICY", "1s:2d")
    monkeypatch.setattr(soak_aggregator, "FLUSH_WAIT_S", 3.0)
    out = soak_aggregator.run(3.0, 192.0, CPU, log=lambda s: None)
    assert out["checked"] > 0 and out["flushed"] > 0


# ------------------------------------------- device default and isolation


@pytest.mark.parametrize("module", [
    fuzz_codec, fuzz_index, fuzz_durability, fuzz_cluster, soak,
    soak_aggregator, integration_smoke, check_all],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_defaults_to_the_card_and_raises_without_one(
        module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SOAK_SECONDS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
