"""In-process multi-node cluster harness (port of
m3_tpu/testing/cluster.py).

The reference spins up multiple real dbnodes in one process with fake
in-memory cluster services replacing etcd
(src/dbnode/integration/setup.go:118, integration/fake/cluster_services.go:115)
and controllable clocks (setup.go:348). Same here: N real NodeServers on
localhost ports, one shared MemStore standing in for etcd, a
placement-derived DynamicTopology, and a shared settable clock. Every
node's Database runs on the harness's device (None: the CUDA card,
raising without one)."""

from __future__ import annotations

import tempfile
from typing import Dict, List, Optional

from ..cluster.kv import MemStore
from ..device import resolve
from ..cluster.placement import Instance, PlacementService
from ..cluster.topology import DynamicTopology
from ..index.namespace_index import NamespaceIndex
from ..parallel.sharding import ShardSet
from ..persist.commitlog import CommitLog
from ..persist.fs import PersistManager
from ..rpc import NodeServer, NodeService
from ..storage.database import Database
from ..storage.namespace import NamespaceOptions
from .faultnet import FaultPlan, FaultProxy


class SettableClock:
    """Controllable time source (integration setup's clock override)."""

    def __init__(self, now_ns: int):
        self.now_ns = now_ns

    def __call__(self) -> int:
        return self.now_ns

    def advance(self, delta_ns: int):
        self.now_ns += delta_ns


def make_node_server(num_shards: int = 2, port: int = 0, *,
                     device=None) -> NodeServer:
    """One bootstrapped in-memory dbnode server on `device` (None: the
    CUDA card) — the shared fixture of the reference's chaos suites."""
    db = Database(ShardSet(num_shards), clock=lambda: 0, device=device)
    db.mark_bootstrapped()
    return NodeServer(NodeService(db, device=db.device), port=port).start()


class ClusterNode:
    def __init__(self, host_id: str, db: Database, server: NodeServer,
                 persist: PersistManager, data_dir: str,
                 proxy: Optional[FaultProxy] = None):
        self.host_id = host_id
        self.db = db
        self.server = server
        self.persist = persist
        self.data_dir = data_dir
        # Optional faultnet proxy fronting this node: the placement
        # advertises the PROXY endpoint, so every client/session/peer
        # stream crosses the chaos layer.
        self.proxy = proxy

    @property
    def endpoint(self) -> str:
        return self.proxy.endpoint if self.proxy is not None \
            else self.server.endpoint

    def stop(self):
        self.server.close()
        if self.proxy is not None:
            self.proxy.close()


class ClusterHarness:
    """N-node localhost cluster over a shared in-memory KV."""

    def __init__(self, n_nodes: int = 3, replica_factor: int = 3,
                 num_shards: int = 64,
                 ns_opts: Optional[NamespaceOptions] = None,
                 namespaces: List[bytes] = (b"default",),
                 start_ns: int = 1_600_000_000_000_000_000,
                 data_root: Optional[str] = None,
                 with_commitlog: bool = False,
                 fault_plan: Optional[FaultPlan] = None, *,
                 device=None):
        self.device = resolve(device)
        self.kv = MemStore()
        self.clock = SettableClock(start_ns)
        self.num_shards = num_shards
        self.ns_opts = ns_opts or NamespaceOptions()
        self.namespaces = list(namespaces)
        self.nodes: Dict[str, ClusterNode] = {}
        self.data_root = data_root or tempfile.mkdtemp(prefix="m3tpu-cluster-")
        self.with_commitlog = with_commitlog
        # Seeded chaos: when set, every node (including later add/replace
        # joiners) is fronted by a faultnet proxy speaking this plan and
        # the placement advertises the proxy endpoints. set_fault_plan()
        # swaps plans live (e.g. to quiesce before convergence checks).
        self.fault_plan = fault_plan

        # Start servers first so endpoints exist for the placement.
        self._pending: List[ClusterNode] = []
        for i in range(n_nodes):
            self._pending.append(self._make_node(f"node{i}"))
        self.placement_svc = PlacementService(self.kv)
        self.placement_svc.init(
            [Instance(id=n.host_id, endpoint=n.endpoint) for n in self._pending],
            num_shards=num_shards, replica_factor=min(replica_factor, n_nodes),
        )
        for n in self._pending:
            self.placement_svc.mark_instance_available(n.host_id)
            n.db.mark_bootstrapped()
            self.nodes[n.host_id] = n
        self.topology = DynamicTopology(self.placement_svc)

    def _make_node(self, host_id: str) -> ClusterNode:
        import os

        data_dir = os.path.join(self.data_root, host_id)
        os.makedirs(data_dir, exist_ok=True)
        commitlog = None
        if self.with_commitlog:
            commitlog = CommitLog(os.path.join(data_dir, "commitlog"))
        db = Database(ShardSet(self.num_shards), commitlog=commitlog,
                      clock=self.clock, device=self.device)
        for ns in self.namespaces:
            index = NamespaceIndex(self.ns_opts.index_block_size_ns, clock=self.clock) \
                if self.ns_opts.index_enabled else None
            db.create_namespace(ns, self.ns_opts, index=index)
        server = NodeServer(NodeService(db, device=self.device)).start()
        proxy = None
        if self.fault_plan is not None:
            proxy = FaultProxy(server.endpoint, self.fault_plan).start()
        return ClusterNode(host_id, db, server, PersistManager(os.path.join(data_dir, "data")),
                           data_dir, proxy=proxy)

    # ----------------------------------------------------------------- admin

    def add_node(self, host_id: Optional[str] = None) -> ClusterNode:
        host_id = host_id or f"node{len(self.nodes)}"
        node = self._make_node(host_id)
        self.placement_svc.add_instance(Instance(id=host_id, endpoint=node.endpoint))
        self.nodes[host_id] = node
        return node

    def stop_node(self, host_id: str):
        self.nodes[host_id].stop()

    def remove_node(self, host_id: str):
        # Placement first: a replica-safety refusal (ValueError) must not
        # leave a healthy node stopped.
        self.placement_svc.remove_instance(host_id)
        self.stop_node(host_id)
        del self.nodes[host_id]

    def replace_node(self, host_id: str,
                     new_id: Optional[str] = None) -> ClusterNode:
        """replace_down_node shape: kill the victim, stand up a
        replacement inheriting its shards (INITIALIZING until
        peer-bootstrapped + marked available)."""
        new_id = new_id or f"node{len(self.nodes)}r"
        self.stop_node(host_id)
        node = self._make_node(new_id)
        self.placement_svc.replace_instance(
            host_id, Instance(id=new_id, endpoint=node.endpoint))
        del self.nodes[host_id]
        self.nodes[new_id] = node
        return node

    def set_fault_plan(self, plan: FaultPlan):
        """Swap the live fault schedule on every proxy (new frames pick
        it up immediately); a benign FaultPlan() quiesces the chaos."""
        self.fault_plan = plan
        for n in self.nodes.values():
            if n.proxy is not None:
                n.proxy.plan = plan

    def tick_all(self):
        for n in self.nodes.values():
            n.db.tick()

    def close(self):
        for n in self.nodes.values():
            n.stop()
