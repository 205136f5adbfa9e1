"""Randomized cluster chaos campaign on the port: the dtest scenarios with
the op order drawn (counterpart of scripts/fuzz_cluster.py).

One round: a live 4-node, RF=3 cluster of the port's NodeServers on
localhost (testing/cluster.ClusterHarness, a shared KV, quorum sessions;
every node's Database on the campaign's device: the hash kernel routes
each write batch, the pack kernel seals, the decode kernel serves the
peers' tiles and the reads), seeded with sealed data, then a random walk
of settled operations (the reference campaign's draws for the same seed):

  write burst     quorum writes (at ALL) to random series at "now";
  seal            a clock advance past the block and a tick;
  add_node        a placement add, the peers bootstrap of the new node's
                  INITIALIZING shards, then marked available;
  remove_up_node  a placement remove; the new owners bootstrap from the
                  surviving replicas, then are marked available;
  replace_down    a node stopped, a placement replace, the replacement
                  peer-bootstrapped.

After every op every series reads back exactly (timestamps and values)
through fresh sessions at read consistency ONE and MAJORITY: a lost point,
a torn merge or a read routed to a data-less owner fails the campaign
("read-back" invariant). Each op's seconds are printed on its line.

Usage:  python -m m3_tpu_torch.scripts.fuzz_cluster --rounds 3 --ops 12
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np

from ..client.session import Session, SessionOptions
from ..cluster.placement import Instance, ShardState
from ..cluster.topology import ConsistencyLevel, ReadConsistencyLevel
from ..device import resolve
from ..ops import kernel_launches
from ..storage.bootstrap import BootstrapContext, BootstrapProcess
from ..storage.namespace import NamespaceOptions
from ..testing.cluster import ClusterHarness
from ..utils import xtime
from . import device_arg, launches_since, sync

NS = b"default"


class Chaos:
    def __init__(self, rng, device, root: str, n_series: int = 16):
        self.rng = rng
        self.device = device
        self.h = ClusterHarness(n_nodes=4, replica_factor=3, num_shards=16,
                                ns_opts=NamespaceOptions(index_enabled=False),
                                data_root=root, device=device)
        # Writes at ALL: the invariant is that consistency-ONE reads are
        # complete, which holds only once every replica holds the point
        # (a majority ack can leave a third replica's queued write to be
        # sealed away by the 2 h clock jump: consistency, not loss).
        self.session = Session(self.h.topology, SessionOptions(
            timeout_s=10, write_consistency=ConsistencyLevel.ALL),
            device=device)
        self.ids = [b"chaos.%d" % i for i in range(n_series)]
        self.expected = {sid: {} for sid in self.ids}  # sid -> {t: v}
        self.next_node = 100
        self.write_burst()
        self.seal()

    # -- operations --------------------------------------------------------

    def write_burst(self):
        now = self.h.clock()
        for sid in self.ids:
            if self.rng.random() < 0.7:
                k = int(self.rng.integers(1, 6))
                ts = [now - int(i) * xtime.SECOND for i in range(k)]
                vs = [float(self.rng.integers(0, 1000)) for _ in range(k)]
                self.session.write_batch(NS, [sid] * k, ts, vs)
                for t, v in zip(ts, vs):
                    self.expected[sid][t] = v

    def seal(self):
        self.h.clock.advance(2 * xtime.HOUR + 11 * xtime.MINUTE)
        self.h.tick_all()

    def _settle(self):
        """Peer-bootstrap every instance's INITIALIZING shards, then mark
        it available: the operator flow every placement change needs
        before the next one."""
        p = self.h.placement_svc.get()
        for iid, inst in p.instances.items():
            init = [a.shard for a in inst.shards.values()
                    if a.state == ShardState.INITIALIZING]
            if not init:
                continue
            node = self.h.nodes[iid]
            proc = BootstrapProcess(
                chain=("peers", "uninitialized_topology"),
                ctx=BootstrapContext(session=self.session, placement=p,
                                     host_id=iid))
            res = proc.run(node.db, shard_ids=init)[NS]
            if not res.unfulfilled.is_empty():
                raise AssertionError(f"settle: {iid} could not bootstrap "
                                     f"{init}: {res.unfulfilled}")
            self.h.placement_svc.mark_instance_available(iid)

    def add_node(self):
        if len(self.h.nodes) >= 6:
            return "skip-add"
        node = self.h.add_node(f"node{self.next_node}")
        self.next_node += 1
        self._settle()
        return f"add {node.host_id}"

    def remove_up_node(self):
        if len(self.h.nodes) <= 4:
            return "skip-remove"
        victim = str(self.rng.choice(sorted(self.h.nodes)))
        self.h.remove_node(victim)
        self._settle()
        return f"remove {victim}"

    def replace_down(self):
        victim = str(self.rng.choice(sorted(self.h.nodes)))
        self.h.stop_node(victim)
        replacement = self.h._make_node(f"node{self.next_node}")
        self.next_node += 1
        self.h.placement_svc.replace_instance(
            victim, Instance(id=replacement.host_id,
                             endpoint=replacement.endpoint))
        del self.h.nodes[victim]
        self.h.nodes[replacement.host_id] = replacement
        self._settle()
        return f"replace {victim} -> {replacement.host_id}"

    # -- invariant ---------------------------------------------------------

    def verify(self, tag):
        # Retention: a long walk pushes the clock past the namespace's
        # retention and the tick expires old blocks; they leave the
        # expectation rather than count as lost.
        now = self.h.clock()
        opts = self.h.ns_opts
        bsz = opts.block_size_ns
        horizon = now - opts.retention_ns
        for sid in self.ids:
            self.expected[sid] = {
                t: v for t, v in self.expected[sid].items()
                if (t - t % bsz) + bsz > horizon}
        for level in (ReadConsistencyLevel.ONE,
                      ReadConsistencyLevel.MAJORITY):
            sess = Session(self.h.topology, SessionOptions(
                timeout_s=10, read_consistency=level), device=self.device)
            try:
                for sid in self.ids:
                    want = self.expected[sid]
                    t, v = sess.fetch(NS, sid, 0, self.h.clock() + 1)
                    got = dict(zip(t.tolist(), v.tolist()))
                    if got != want:
                        raise AssertionError(
                            f"read-back: [{tag} @ {level.name}] {sid!r}: "
                            f"missing={sorted(set(want) - set(got))[:3]} "
                            f"extra={sorted(set(got) - set(want))[:3]} "
                            f"({len(got)}/{len(want)} points)")
            finally:
                sess.close()

    def close(self):
        self.session.close()
        self.h.close()


def run_round(rng, ops, device, log=print) -> dict:
    root = tempfile.mkdtemp(prefix="m3-fuzz-cluster-")
    c = None
    try:
        c = Chaos(rng, device, root)
        c.verify("seeded")
        choices = [c.add_node, c.remove_up_node, c.replace_down]
        tags = []
        for i in range(ops):
            # data churn between disruptions, always sealed before one
            c.write_burst()
            c.seal()
            op = choices[int(rng.integers(len(choices)))]
            t0 = time.monotonic()
            tag = op()
            secs = time.monotonic() - t0
            c.verify(f"op{i}:{tag}")
            log(f"  op {i}: {tag} in {secs:.3f}s, read back at ONE and "
                f"MAJORITY in {time.monotonic() - t0 - secs:.3f}s")
            tags.append(tag)
        return {"points": sum(len(m) for m in c.expected.values()),
                "ops": tags}
    finally:
        if c is not None:
            c.close()
        shutil.rmtree(root, ignore_errors=True)


def run(rounds: int, ops: int, seed: int, device=None, log=print) -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    before = kernel_launches()
    t0 = time.time()
    pts = 0
    walks = []
    for r in range(rounds):
        out = run_round(rng, ops, dev, log)
        pts += out["points"]
        walks.append(out["ops"])
        log(f"  round {r + 1}/{rounds} ok ({pts} expected points verified "
            f"x2 levels, {time.time() - t0:.0f}s)")
    sync(dev)
    return {"rounds": rounds, "ops": ops, "points": pts, "walks": walks,
            "launches": launches_since(before), "device": str(dev),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ops", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.rounds, args.ops, args.seed, args.device,
              log=lambda s: print(s, flush=True))
    print(f"CLUSTER CHAOS PASS: {out['rounds']} rounds x {out['ops']} ops, "
          f"{out['points']} points read back x2 levels after every op, "
          f"walks {out['walks']}, seed {args.seed}, {out['seconds']:.0f}s")
    print(f"fuzz_cluster kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
