"""Service assembly + lifecycle (port of m3_tpu/services/run.py;
reference: src/dbnode/server/server.go:122 Run, src/query/server/
server.go:115 Run, m3aggregator/main, m3collector — each binary is a thin
main() over a library run function; here each run_* returns a handle
with .close()).

An embedded coordinator inside the dbnode mirrors the reference's
`m3dbnode -f cfg` with a coordinator section (main.go:69).

Each run_* that reaches a device takes `device=None` (the CUDA card; it
raises without one unless given "cpu") and resolves it before it opens a
file, a lock or a listener. Objects built over an object that already
has a device take that object's: the node's service, HTTP JSON server,
namespace watch and embedded coordinator run on the database's device,
a coordinator over a session on the session's. run_kv and run_collector
are host only, as in the reference."""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

from ..aggregator import Aggregator, ElectionManager, FlushTimesManager
from ..aggregator.server import RawTCPServer, TCPTransport
from ..cluster import kv as cluster_kv
from ..cluster import kv_service
from ..cluster.placement import PlacementService
from ..cluster.services import LeaderService
from ..device import resolve
from ..parallel.sharding import ShardSet
from ..persist.commitlog import CommitLog
from ..ops import reset_kernel_launches
from ..persist.fs import PersistManager
from ..query.promql import parse_duration_ns
from ..rpc.node_server import NodeServer, NodeService
from ..storage.database import Database, warm_up
from ..storage.namespace import NamespaceOptions
from .config import (
    AggregatorConfig,
    CollectorConfig,
    CoordinatorConfig,
    DBNodeConfig,
)


def _kv_store(path: str, endpoint: str = "") -> cluster_kv.MemStore:
    if endpoint:
        return kv_service.RemoteStore(endpoint)
    if path:
        return cluster_kv.FileStore(path)
    return cluster_kv.MemStore()


@dataclasses.dataclass
class KVHandle:
    server: kv_service.KVServer

    @property
    def endpoint(self) -> str:
        return self.server.endpoint

    @property
    def store(self):
        return self.server.store

    def close(self):
        self.server.close()


def run_kv(cfg) -> KVHandle:
    """The cluster-metadata KV service process (etcd-analog): one per
    cluster, serving placements/namespaces/elections/flush-times to every
    other service over the framed wire with watch push."""
    host, port = _host_port(cfg.listen_address)
    store = cluster_kv.FileStore(cfg.kv_path) if cfg.kv_path else None
    server = kv_service.KVServer(store, host=host, port=port).start()
    return KVHandle(server)


def _host_port(addr: str):
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port or 0)


@dataclasses.dataclass
class DBNodeHandle:
    db: Database
    server: NodeServer
    persist: PersistManager
    coordinator: Optional[object] = None
    kv: Optional[cluster_kv.MemStore] = None
    lock: Optional[object] = None
    httpjson: Optional[object] = None
    ns_watch: Optional[object] = None
    mediator: Optional[object] = None
    bootstrap_results: Optional[dict] = None
    scrubber: Optional[object] = None

    @property
    def endpoint(self) -> str:
        return self.server.endpoint

    def close(self):
        if self.scrubber is not None:
            self.scrubber.stop()
        if self.mediator is not None:
            # Stop the background flush/snapshot loop BEFORE teardown so
            # a mid-close tick never races the listeners going away.
            self.mediator.stop()
        if self.ns_watch is not None:
            self.ns_watch.stop()
        if self.coordinator is not None:
            self.coordinator.close()
        if self.httpjson is not None:
            self.httpjson.close()
        self.server.close()
        # Drain every shard's insert queue AFTER the listeners stop
        # accepting writes — queued async inserts are never stranded by
        # teardown (shard_insert_queue.go Stop during server Close).
        self.db.close()
        if self.kv is not None and hasattr(self.kv, "close"):
            self.kv.close()  # RemoteStore: stops watch threads + socket
        if self.lock is not None:
            self.lock.release()


def run_dbnode(cfg: DBNodeConfig, clock=None, *, device=None) -> DBNodeHandle:
    """dbnode/server/server.go Run: config -> db -> bootstrap ->
    listeners. With bootstrap_enabled the node replays its own data dir
    (filesystem filesets -> commitlog snapshots + WAL) BEFORE the
    listeners open — the cold-restart path; serving-ready is printed with
    the bootstrap wall time. `device` (None: the card) is resolved before
    the data dir is touched."""
    dev = resolve(device)
    os.makedirs(cfg.data_dir, exist_ok=True)
    # One process per data dir (x/lockfile; server.go takes it on startup).
    from ..utils.lockfile import Lockfile

    lock = Lockfile(os.path.join(cfg.data_dir, "node.lock")).acquire()
    commitlog_dir = os.path.join(cfg.data_dir, "commitlog")
    commitlog = None
    if cfg.commitlog_enabled:
        from ..persist.commitlog import Strategy

        commitlog = CommitLog(
            commitlog_dir, strategy=Strategy(cfg.commitlog_strategy))
    db = Database(ShardSet(cfg.num_shards), commitlog=commitlog, clock=clock,
                  device=dev)
    for ns_cfg in cfg.namespaces:
        db.ensure_namespace(
            ns_cfg.name.encode(),
            NamespaceOptions(retention_ns=ns_cfg.retention_ns,
                             block_size_ns=ns_cfg.block_size_ns,
                             buffer_past_ns=ns_cfg.buffer_past_ns,
                             buffer_future_ns=ns_cfg.buffer_future_ns,
                             index_enabled=ns_cfg.index_enabled))
    persist = PersistManager(os.path.join(cfg.data_dir, "data"))
    boot_results = None
    if cfg.bootstrap_enabled:
        from ..storage.bootstrap import BootstrapContext, BootstrapProcess

        t0 = time.perf_counter()
        proc = BootstrapProcess(
            chain=("filesystem", "commitlog", "uninitialized_topology"),
            ctx=BootstrapContext(
                persist=persist,
                commitlog_dir=commitlog_dir if cfg.commitlog_enabled else None,
                shard_lookup=db.shard_set.lookup))
        boot_results = proc.run(db)
        n_series = sum(
            sh.num_series()
            for ns in db.namespaces.values() for sh in ns.shards.values())
        notes = [n for r in boot_results.values() for n in r.notes]
        print(f"dbnode serving-ready bootstrap_s="
              f"{time.perf_counter() - t0:.3f} series={n_series} "
              f"notes={len(notes)}", flush=True)
        for note in notes:
            print(f"dbnode bootstrap note: {note}", flush=True)
    else:
        db.mark_bootstrapped()
    # Nothing cold for a client's first write (warm_up). Its launches are
    # start-up work: the node's counts start at the listen line.
    warm_up(db.device, next(iter(db.namespaces.values())).opts
            if db.namespaces else None)
    reset_kernel_launches()
    host, port = _host_port(cfg.listen_address)
    service = NodeService(db, device=db.device)
    server = NodeServer(service, host=host, port=port).start()
    httpjson = None
    if cfg.http_listen_address:
        from ..rpc.httpjson import HTTPJSONServer

        hhost, hport = _host_port(cfg.http_listen_address)
        httpjson = HTTPJSONServer(service, host=hhost, port=hport).start()
    kv = _kv_store(cfg.kv_path, cfg.kv_endpoint)
    # KV-watched namespace registry: namespaces added to KV (by admins or
    # peers) bootstrap and serve without restart (namespace_watch.go).
    from ..storage.namespace_watch import NamespaceWatch

    ns_watch = NamespaceWatch(db, kv).start()
    coordinator = None
    if cfg.coordinator is not None:
        from ..coordinator import run_embedded

        coordinator = run_embedded(
            db, namespace=cfg.coordinator.namespace.encode(), kv_store=kv,
            rules_namespace=cfg.coordinator.rules_namespace.encode(),
            clock=db.clock, listen=_host_port(cfg.coordinator.listen_address),
            create_namespace=lambda name, retention_ns:
                ns_watch.add(name, retention_ns),
            self_scrape_interval_s=cfg.coordinator.self_scrape_interval_s,
            device=db.device)
    mediator = None
    if cfg.tick_interval:
        from ..storage.mediator import Mediator

        mediator = Mediator(db, persist).start(
            interval_s=parse_duration_ns(cfg.tick_interval) / 1e9)
    # Durable-write health feeds the process tracker: persistent WAL or
    # flush failures degrade the exported /health state alongside the
    # read-only write posture the database itself enforces.
    from ..utils.health import TRACKER

    TRACKER.register(f"disk.{cfg.host_id}", db.disk_health.saturation)
    scrubber = None
    if cfg.scrub_interval:
        from ..storage.scrub import DatabaseScrubber, ScrubOptions

        # No peer session at this assembly level: the scrubber runs in
        # quarantine-only mode (detect + isolate); cluster harnesses
        # construct it with a ShardRepairer for the full repair loop.
        scrubber = DatabaseScrubber(
            db, persist, opts=ScrubOptions(
                interval_s=parse_duration_ns(cfg.scrub_interval) / 1e9)
        ).start()
    return DBNodeHandle(db, server, persist, coordinator, kv, lock, httpjson,
                        ns_watch, mediator, boot_results, scrubber)


@dataclasses.dataclass
class AggregatorHandle:
    aggregator: Aggregator
    server: RawTCPServer
    flush_thread: Optional[threading.Thread]
    kv: cluster_kv.MemStore
    admin: Optional[object] = None   # HTTPAdminServer when configured
    flush_handler: Optional[object] = None  # closed with the handle
    _stop: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def endpoint(self) -> str:
        return self.server.endpoint

    @property
    def admin_endpoint(self) -> str:
        return self.admin.endpoint if self.admin is not None else ""

    def close(self):
        self._stop.set()
        if self.admin is not None:
            self.admin.close()
        self.server.close()
        closer = getattr(self.flush_handler, "close", None)
        if closer is not None:
            closer()


def run_aggregator(cfg: AggregatorConfig, flush_handler=None,
                   clock=None, on_placement=None, *,
                   device=None) -> AggregatorHandle:
    """m3aggregator assembly: rawtcp server + election-managed flush loop.

    With a placement_key configured, the instance watches the aggregator
    placement in KV (aggregator.go:307 placement watch): shard ownership
    follows placement changes without restart, and forwarded-pipeline
    routing targets the peers named by the placement's endpoints.
    `device` (None: the card) is resolved before any store or listener
    opens."""
    dev = resolve(device)
    kv = _kv_store(cfg.kv_path, cfg.kv_endpoint)
    clock = clock or time.time_ns
    owned_handler = None
    if flush_handler is None and cfg.flush_log:
        from ..aggregator.handler import FileHandler

        flush_handler = owned_handler = FileHandler(cfg.flush_log)
    leader = LeaderService(kv, cfg.election_id, cfg.instance_id, clock=clock,
                           lease_ttl_ns=parse_duration_ns(cfg.election_ttl))
    election = ElectionManager(leader)
    flush_times = FlushTimesManager(kv, cfg.shard_set_id)
    agg = Aggregator(num_shards=cfg.num_shards, clock=clock,
                     flush_handler=flush_handler, election=election,
                     flush_times=flush_times, device=dev)
    host, port = _host_port(cfg.listen_address)
    server = RawTCPServer(agg, host=host, port=port).start()

    if cfg.placement_key:
        transports = {}
        latest = {"p": None}  # watch-updated cache; forwards must not hit KV

        def _on_placement(_key, value):
            # Parse the pushed value itself — a re-fetch through KV could
            # fail transiently and lose the (coalesced) watch event.
            import json as _json

            from ..cluster.placement import Placement

            p = Placement.from_json(_json.loads(value.data.decode()),
                                    value.version)
            latest["p"] = p
            inst = p.instances.get(cfg.instance_id)
            shards = inst.shard_ids() if inst else []
            agg.assign_shards(shards)
            peers = {}
            for iid, i in p.instances.items():
                if iid == cfg.instance_id:
                    continue
                tr = transports.get(iid)
                if tr is not None and tr._endpoint != i.endpoint:
                    tr.close()  # endpoint moved: drop the stale socket
                    tr = None
                if tr is None:
                    tr = transports[iid] = TCPTransport(i.endpoint)
                # the transport OBJECT: ForwardedWriter batches a flush
                # round's forwards into one fbatch frame per destination
                peers[iid] = tr
            for iid in set(transports) - set(p.instances):
                transports.pop(iid).close()  # instance left the placement
            agg.set_forward_routing(lambda: latest["p"], peers, cfg.instance_id)
            if on_placement is not None:
                on_placement(shards)

        kv.on_change(cfg.placement_key, _on_placement)

    admin = None
    if cfg.admin_address:
        from ..aggregator.server import HTTPAdminServer

        try:
            ah, ap = _host_port(cfg.admin_address)
            admin = HTTPAdminServer(agg, host=ah, port=ap).start()
        except Exception:
            # Don't leak the already-bound ingest server/threads when the
            # admin port can't bind — the caller gets no handle to close.
            server.close()
            raise
    handle = AggregatorHandle(agg, server, None, kv, admin, owned_handler)
    interval_s = parse_duration_ns(cfg.flush_interval) / 1e9

    def flush_loop():
        while not handle._stop.wait(interval_s):
            try:
                agg.flush()
            except Exception:  # noqa: BLE001 - keep the loop alive
                pass

    handle.flush_thread = threading.Thread(target=flush_loop, daemon=True)
    handle.flush_thread.start()
    return handle


def run_coordinator(cfg: CoordinatorConfig, session=None, db=None,
                    kv_store=None, clock=None, *, device=None):
    """Standalone coordinator over a client session (or an in-process db
    for tests); returns the Coordinator handle with HTTP serving. It runs
    on the db's or the session's device; a different `device` raises."""
    from ..coordinator import run_clustered, run_embedded
    from ..coordinator.carbon_ingest import CarbonServer
    from ..query.remote import RemoteStorage
    from ..query.storage import FanoutStorage

    if (session is None) == (db is None):
        raise ValueError("exactly one of session/db required")
    owner = db if db is not None else session
    if device is not None and resolve(device) != owner.device:
        raise ValueError(f"the {'database' if db is not None else 'session'} "
                         f"runs on {owner.device}, not on {resolve(device)}")
    listen = _host_port(cfg.listen_address)
    scrape_s = cfg.self_scrape_interval_s
    if db is not None:
        coord = run_embedded(db, namespace=cfg.namespace.encode(),
                             kv_store=kv_store,
                             rules_namespace=cfg.rules_namespace.encode(),
                             clock=clock, listen=listen,
                             self_scrape_interval_s=scrape_s,
                             device=owner.device)
    else:
        coord = run_clustered(session, namespace=cfg.namespace.encode(),
                              kv_store=kv_store,
                              rules_namespace=cfg.rules_namespace.encode(),
                              clock=clock, listen=listen,
                              self_scrape_interval_s=scrape_s,
                              device=owner.device)
    if cfg.remotes:
        stores = [coord.engine.storage] + [RemoteStorage(r) for r in cfg.remotes]
        coord.engine.storage = FanoutStorage(stores)
    if cfg.carbon_listen_address:
        host, port = _host_port(cfg.carbon_listen_address)
        carbon = CarbonServer(coord.writer, host=host, port=port).start()
        coord.carbon = carbon  # attach for lifecycle
    return coord


def run_coordinator_standalone(cfg: CoordinatorConfig, clock=None, *,
                               device=None):
    """Standalone coordinator process: discovers the dbnode cluster through
    the networked KV service (placement-watched topology) and serves the
    query/write HTTP API over a replicating client session — the reference's
    m3query/m3coordinator deployment shape (src/query/server/server.go:115
    with an etcd cluster client). The session decodes on `device` (None:
    the card)."""
    from ..client.session import Session, SessionOptions
    from ..cluster.topology import DynamicTopology

    dev = resolve(device)
    if not cfg.kv_endpoint:
        raise ValueError("standalone coordinator requires kv_endpoint")
    kv = kv_service.RemoteStore(cfg.kv_endpoint)
    topo = DynamicTopology(PlacementService(kv, cfg.placement_key))
    if topo.get() is None:
        raise RuntimeError(
            f"no placement at {cfg.placement_key!r} in KV {cfg.kv_endpoint}")
    session = Session(topo, SessionOptions(), device=dev)
    return run_coordinator(cfg, session=session, kv_store=kv, clock=clock)


def run_collector(cfg: CollectorConfig, placement_getter, transports,
                  clock=None):
    """m3collector: matcher + shard-aware aggregator client + reporter."""
    from ..aggregator.client import AggregatorClient
    from ..collector import Reporter
    from ..metrics.matcher import Matcher, RuleSetStore

    kv = _kv_store(cfg.kv_path, cfg.kv_endpoint)
    matcher = Matcher(RuleSetStore(kv), cfg.rules_namespace.encode(),
                      clock=clock)
    client = AggregatorClient(cfg.num_shards, placement_getter, transports)
    return Reporter(matcher, client), kv
