"""The port's cluster layer (m3_tpu_torch.cluster) against the reference's
(m3_tpu.cluster), on the CPU: seeded random instance sets give equal
placement JSON through the initial placement, add, remove, replace, mark
available and the mirrored forms; equal deployment plans; equal
consistency arithmetic; a DynamicTopology that follows a placement change
in the KV store; and the KV store's watches, the file store, service
discovery, heartbeats and the composed cluster client behaving as the
reference's do."""

import json
import random

import pytest

from m3_tpu.cluster import kv as jkv
from m3_tpu.cluster import placement as jpl
from m3_tpu.cluster import services as jsvc
from m3_tpu.cluster import topology as jtopo
from m3_tpu.cluster.client import ClusterClient as JClusterClient
from m3_tpu_torch.cluster import kv, placement as pl, services as svc
from m3_tpu_torch.cluster import topology as topo
from m3_tpu_torch.cluster.client import ClusterClient, PrefixStore
from m3_tpu_torch.cluster.kv_service import KVServer

RF = 3


def _insts(mod, ids, rng, mirrored=False):
    out = []
    for k, iid in enumerate(ids):
        out.append(mod.Instance(
            iid, f"h{iid}:{9000 + k}", isolation_group=f"g{k % 3}",
            weight=1 + rng.randrange(3), zone=f"z{k % 2}",
            shard_set_id=f"ss{k // RF}" if mirrored else ""))
    return out


def _json(p) -> str:
    return json.dumps(p.to_json(), sort_keys=True)


def _apply(mod, p, op, arg):
    if op == "add":
        return mod.add_instance(p, arg)
    if op == "remove":
        return mod.remove_instance(p, arg)
    if op == "replace":
        return mod.replace_instance(p, arg[0], arg[1])
    inst, shard = arg
    return mod.mark_shard_available(p, inst, shard)


@pytest.mark.parametrize("seed", [1, 7, 23, 99])
def test_placement_churn_json_equals_the_reference(seed):
    """Initial, then 30 seeded add/remove/replace/mark-available steps in
    both packages: after every step (a refusal included) the placement
    JSON is equal, and so are the deployment plans."""
    rng = random.Random(seed)
    n0 = rng.randrange(RF, 8)
    shards = rng.choice([8, 16, 30, 64])
    ids = [f"i{k}" for k in range(n0)]
    p = pl.initial_placement(_insts(pl, ids, random.Random(seed)), shards, RF)
    jp = jpl.initial_placement(_insts(jpl, ids, random.Random(seed)),
                               shards, RF)
    assert _json(p) == _json(jp)
    next_id = n0
    for _step in range(30):
        op = rng.choice(["add", "remove", "replace", "mark", "mark"])
        if op == "add":
            args = [m.Instance(f"i{next_id}", f"h:{next_id}")
                    for m in (pl, jpl)]
            next_id += 1
        elif op == "remove":
            victim = rng.choice(sorted(p.instances))
            args = [victim, victim]
        elif op == "replace":
            victim = rng.choice(sorted(p.instances))
            args = [(victim, m.Instance(f"i{next_id}", f"h:{next_id}"))
                    for m in (pl, jpl)]
            next_id += 1
        else:
            init = sorted((iid, s) for iid, inst in p.instances.items()
                          for s, a in inst.shards.items()
                          if a.state == pl.ShardState.INITIALIZING)
            if not init:
                continue
            pick = rng.choice(init)
            args = [pick, pick]
        outs = []
        for mod, cur, arg in ((pl, p, args[0]), (jpl, jp, args[1])):
            try:
                outs.append(_apply(mod, cur, op, arg))
            except (ValueError, KeyError) as e:
                outs.append(type(e).__name__)
        if isinstance(outs[0], str) or isinstance(outs[1], str):
            assert outs[0] == outs[1], (op, outs)
            continue
        p, jp = outs
        assert _json(p) == _json(jp), (op, args[1])
    for step in (0, 2):
        steps = pl.plan_deployment(p, step)
        assert steps == jpl.plan_deployment(jp, step)
        try:
            pl.validate_deployment_plan(p, steps)
            ok = "ok"
        except ValueError as e:
            ok = str(e)
        try:
            jpl.validate_deployment_plan(jp, steps)
            jok = "ok"
        except ValueError as e:
            jok = str(e)
        assert ok == jok
    back = pl.Placement.from_json(json.loads(_json(jp)), 5)
    assert _json(back) == _json(jp) and back.version == 5


@pytest.mark.parametrize("seed", [3, 11])
def test_mirrored_placements_equal_the_reference(seed):
    """Mirrored shard sets: the initial placement, a set joining, its
    cut-over, a set leaving and its cut-over give equal JSON, and both
    packages validate (or refuse) alike."""
    rng = random.Random(seed)
    n_sets = rng.randrange(2, 4)
    ids = [f"m{k}" for k in range(n_sets * RF)]
    p = pl.mirrored_initial_placement(
        _insts(pl, ids, random.Random(seed), mirrored=True), 24, RF)
    jp = jpl.mirrored_initial_placement(
        _insts(jpl, ids, random.Random(seed), mirrored=True), 24, RF)
    assert _json(p) == _json(jp)
    new = [f"n{k}" for k in range(RF)]
    p = pl.mirrored_add_shard_set(p, [pl.Instance(i, f"{i}:1", shard_set_id="new")
                                      for i in new])
    jp = jpl.mirrored_add_shard_set(
        jp, [jpl.Instance(i, f"{i}:1", shard_set_id="new") for i in new])
    assert _json(p) == _json(jp)
    p, jp = (pl.mirrored_mark_available(p, "new"),
             jpl.mirrored_mark_available(jp, "new"))
    assert _json(p) == _json(jp)
    p.validate_mirrored()
    p, jp = (pl.mirrored_remove_shard_set(p, "ss0"),
             jpl.mirrored_remove_shard_set(jp, "ss0"))
    assert _json(p) == _json(jp)
    for ssid in sorted(p.shard_sets()):
        if ssid != "ss0":
            p = pl.mirrored_mark_available(p, ssid)
            jp = jpl.mirrored_mark_available(jp, ssid)
    assert _json(p) == _json(jp) and "ss0" not in p.shard_sets()
    p.validate_mirrored()
    assert pl.plan_deployment(p) == jpl.plan_deployment(jp)
    with pytest.raises(ValueError, match="members"):
        pl.mirrored_initial_placement(
            _insts(pl, ["a", "b"], rng, mirrored=True), 8, RF)


def test_consistency_arithmetic_equals_the_reference():
    for replicas in range(1, 8):
        assert topo.majority(replicas) == jtopo.majority(replicas)
        for level in topo.ConsistencyLevel:
            assert topo.required_acks(level, replicas) == jtopo.required_acks(
                jtopo.ConsistencyLevel(level.value), replicas)
        for level in topo.ReadConsistencyLevel:
            assert topo.required_reads(level, replicas) == \
                jtopo.required_reads(jtopo.ReadConsistencyLevel(level.value),
                                     replicas)
    assert [lv.value for lv in topo.ConsistencyLevel] == \
        [lv.value for lv in jtopo.ConsistencyLevel]
    assert [lv.value for lv in topo.ReadConsistencyLevel] == \
        [lv.value for lv in jtopo.ReadConsistencyLevel]


def _routes(m, shards):
    return [([h.id for h in m.route_shard(s)],
             [h.id for h in m.route_shard_readable(s)]) for s in range(shards)]


def test_dynamic_topology_follows_a_placement_change():
    """A DynamicTopology over a PlacementService in the KV store rebuilds
    its map on every placement write: an instance joining shows up as an
    initializing (write-only) owner, then as a readable one once marked
    available; the routes equal the reference's at every version."""
    maps = []
    store, jstore = kv.MemStore(), jkv.MemStore()
    ps = pl.PlacementService(store)
    jps = jpl.PlacementService(jstore)
    ps.init([pl.Instance(f"i{k}", f"h{k}:1") for k in range(3)], 12, RF)
    jps.init([jpl.Instance(f"i{k}", f"h{k}:1") for k in range(3)], 12, RF)
    dyn = topo.DynamicTopology(ps)
    jdyn = jtopo.DynamicTopology(jps)
    dyn.subscribe(maps.append)
    assert len(maps) == 1 and maps[0].replica_factor == RF
    assert _routes(dyn.get(), 12) == _routes(jdyn.get(), 12)
    ps.add_instance(pl.Instance("i3", "h3:1"))
    jps.add_instance(jpl.Instance("i3", "h3:1"))
    assert len(maps) == 2 and dyn.get() is maps[-1]
    got = _routes(dyn.get(), 12)
    assert got == _routes(jdyn.get(), 12)
    joined = dyn.get().shards_for_host("i3")
    assert joined and all("i3" in got[s][0] and "i3" not in got[s][1]
                          for s in joined)
    ps.mark_instance_available("i3")
    jps.mark_instance_available("i3")
    got = _routes(dyn.get(), 12)
    assert got == _routes(jdyn.get(), 12)
    assert all("i3" in got[s][1] for s in joined)
    assert len(maps) == 3 and ps.get().version == jps.get().version == 3
    static = topo.StaticTopology(ps.get())
    assert _routes(static.get(), 12) == got
    assert static.get().majority_replicas() == 2


def test_kv_watches_file_store_and_services(tmp_path):
    for mod in (kv, jkv):
        s = mod.MemStore()
        w = s.watch("key")
        assert not w.wait(0.01)
        assert mod.set_json(s, "key", {"a": 1}) == 1
        assert w.wait(0.5) and mod.get_json(s, "key") == ({"a": 1}, 1)
        seen = []
        s.on_change("key", lambda k, v: seen.append(v.data))
        s.set("key", b"b")
        assert seen == [b'{"a": 1}', b"b"]
        with pytest.raises(KeyError):
            s.set_if_not_exists("key", b"x")
        assert s.keys("k") == ["key"] and s.delete("key").data == b"b"
        s.unwatch("key", w)
        path = str(tmp_path / f"{mod.__name__}.json")
        f1 = mod.FileStore(path)
        f1.set_many({"a": b"1", "b": b"2"})
        assert mod.FileStore(path).get("b").data == b"2"
    assert open(str(tmp_path / f"{kv.__name__}.json")).read() == \
        open(str(tmp_path / f"{jkv.__name__}.json")).read()
    now = {"t": 0}
    for mod in (svc, jsvc):
        store = (kv if mod is svc else jkv).MemStore()
        hb = mod.HeartbeatService(store, ttl_ns=100, clock=lambda: now["t"])
        s = mod.Services(store, hb)
        s.advertise("db", mod.ServiceInstance("a", "h1:1"))
        s.advertise("db", mod.ServiceInstance("b", "h2:1", zone="z"))
        assert hb.alive_instances("db") == ["a", "b"]
        now["t"] = 150
        hb.beat("db", "b")
        assert hb.alive_instances("db") == ["b"] and not hb.alive("db", "a")
        s.unadvertise("db", "a")
        assert [i.instance_id for i in s.instances("db")] == ["b"]
        now["t"] = 0


def test_cluster_client_scopes_like_the_reference():
    store, jstore = kv.MemStore(), jkv.MemStore()
    c = ClusterClient(store=store, zone="z1", env="prod")
    jc = JClusterClient(store=jstore, zone="z1", env="prod")
    for cl, m in ((c, pl), (jc, jpl)):
        cl.placement_service().init(
            [m.Instance(f"i{k}", f"h{k}:1") for k in range(3)], 4, RF)
        cl.store("ns").set("x", b"1")
        cl.kv().set("y", b"2")
        cl.services().advertise("svc", (svc if m is pl else jsvc)
                                .ServiceInstance("a", "h:1"))
        assert cl.leader_service("e", "me").campaign()
    assert store.keys() == jstore.keys()
    for k in store.keys():
        assert store.get(k).data == jstore.get(k).data or k.startswith(
            ("z1/prod/_hb/", "z1/prod/_leader/"))
    seen = []
    p = PrefixStore(store, "z1/prod")
    p.on_change("y", lambda k, v: seen.append(k))
    p.set("y", b"3")
    p.off_change("y", seen.append)
    assert seen == ["y", "y"]
    # The endpoint form: the same calls through a KV service give the
    # same keys and values as the injected store.
    srv = KVServer().start()
    try:
        rc = ClusterClient(endpoint=srv.endpoint, zone="z1", env="prod")
        rc.placement_service().init(
            [pl.Instance(f"i{k}", f"h{k}:1") for k in range(3)], 4, RF)
        rc.store("ns").set("x", b"1")
        rc.kv().set("y", b"2")
        rc.services().advertise("svc", svc.ServiceInstance("a", "h:1"))
        assert rc.leader_service("e", "me").campaign()
        assert srv.store.keys() == jstore.keys()
        for k in srv.store.keys():
            assert srv.store.get(k).data == jstore.get(k).data or k.startswith(
                ("z1/prod/_hb/", "z1/prod/_leader/"))
        rc.close()
    finally:
        srv.close()
    with pytest.raises(ValueError):
        ClusterClient()
    with pytest.raises(ValueError):
        ClusterClient(endpoint="127.0.0.1:1", store=store)
    c.close()
