"""Coordinator server assembly (reference: src/query/server/server.go:115
Run — wires storage backend, downsampler, engine, and the HTTP handler).

run_embedded() builds the whole read+write coordinator over an in-process
database (the m3dbnode embedded-coordinator mode, cmd/services/m3dbnode/
main.go:69); run_clustered() goes through the replicating client session.

Port of m3_tpu/coordinator/server.py. `run_embedded` and `run_clustered`
take `device=None` (the card, as every port entry point; they raise
without one unless given `device="cpu"`) and pass it to the Engine, the
Downsampler's Aggregator and the rules engine."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..cluster import kv as cluster_kv
from ..metrics.matcher import Matcher, RuleSetStore
from ..metrics.policy import StoragePolicy
from ..query import Engine, LocalStorage, SessionStorage
from .admin import AdminAPI
from .downsample import Downsampler
from .http_api import HTTPApi
from .ingest import DownsamplerAndWriter
from .rules_engine import RulesEngine
from .selfscrape import SelfScraper


@dataclasses.dataclass
class Coordinator:
    engine: Engine
    writer: DownsamplerAndWriter
    api: HTTPApi
    downsampler: Optional[Downsampler]
    admin: AdminAPI
    # Self-scrape loop (instrument snapshot -> own ingest path) when the
    # deployment enables it; tests/smokes drive scrape_once() directly.
    self_scraper: Optional[SelfScraper] = None
    clock: Optional[object] = None

    @property
    def endpoint(self) -> str:
        return self.api.endpoint

    def flush_downsampler(self, now_nanos: Optional[int] = None) -> int:
        return self.downsampler.flush(now_nanos) if self.downsampler else 0

    def rules_engine(self, **kw) -> RulesEngine:
        """Standing recording/alert rules over this coordinator: PromQL
        evaluates through the shared engine (plan cache included) and
        outputs write back through the downsample-and-write path, so
        recorded series are rule-matched AND queryable over HTTP. The
        rules' compares run on the engine's device (the reference's
        precision split, coordinator/rules_engine.py)."""
        kw.setdefault("clock", self.clock)
        return RulesEngine(self.engine, self.writer.write_batch, **kw)

    def close(self):
        if self.self_scraper is not None:
            self.self_scraper.stop()
        self.api.close()


def _build(storage, aggregated_storages: Dict[StoragePolicy, object],
           kv_store: Optional[cluster_kv.MemStore],
           rules_namespace: bytes, clock, create_namespace,
           listen=("127.0.0.1", 0),
           self_scrape_interval_s: Optional[float] = None,
           device=None) -> Coordinator:
    # Resolved first: without a card nothing is built, not even the
    # listener.
    engine = Engine(storage, device=device)
    downsampler = None
    if kv_store is not None:
        matcher = Matcher(RuleSetStore(kv_store), rules_namespace, clock=clock)

        def write_aggregated(mid, tags, t_ns, value, policy):
            target = aggregated_storages.get(policy, storage)
            target.write(mid, tags, t_ns, value)

        def write_aggregated_batch(rows):
            # one storage write_batch per policy group of the columnar
            # flush (rows: (mid, tags, t_ns, value, policy))
            by_policy: Dict[object, list] = {}
            for row in rows:
                by_policy.setdefault(row[4], []).append(row)
            for policy, group in by_policy.items():
                target = aggregated_storages.get(policy, storage)
                batch_write = getattr(target, "write_batch", None)
                if batch_write is not None:
                    batch_write([r[0] for r in group], [r[1] for r in group],
                                [r[2] for r in group], [r[3] for r in group])
                else:
                    for mid, tags, t_ns, value, _pol in group:
                        target.write(mid, tags, t_ns, value)

        downsampler = Downsampler(matcher, write_aggregated, clock=clock,
                                  write_aggregated_batch=write_aggregated_batch,
                                  device=engine.device)
    writer = DownsamplerAndWriter(storage, downsampler)
    admin = AdminAPI(kv_store if kv_store is not None else cluster_kv.MemStore(),
                     create_namespace=create_namespace)
    api = HTTPApi(engine, writer, admin=admin).serve(*listen)
    scraper = None
    if self_scrape_interval_s is not None:
        # Dogfooding like the reference: the coordinator's own instrument
        # registry scraped back through its ingest path.
        scraper = SelfScraper(writer, clock=clock,
                              interval_s=self_scrape_interval_s).start()
    return Coordinator(engine, writer, api, downsampler, admin, scraper,
                       clock=clock)


def run_embedded(db, namespace: bytes = b"default",
                 kv_store: Optional[cluster_kv.MemStore] = None,
                 rules_namespace: bytes = b"default",
                 aggregated_namespaces: Optional[Dict[StoragePolicy, bytes]] = None,
                 clock=None, listen=("127.0.0.1", 0),
                 create_namespace=None,
                 self_scrape_interval_s: Optional[float] = None,
                 device=None) -> Coordinator:
    storage = LocalStorage(db, namespace)
    agg = {
        policy: LocalStorage(db, ns)
        for policy, ns in (aggregated_namespaces or {}).items()
    }

    if create_namespace is None:
        def create_namespace(name: bytes, retention_ns: int):
            from ..storage.namespace import NamespaceOptions

            db.ensure_namespace(
                name, NamespaceOptions(retention_ns=retention_ns))

    return _build(storage, agg, kv_store, rules_namespace, clock,
                  create_namespace, listen,
                  self_scrape_interval_s=self_scrape_interval_s,
                  device=device)


def run_clustered(session, namespace: bytes = b"default",
                  kv_store: Optional[cluster_kv.MemStore] = None,
                  rules_namespace: bytes = b"default",
                  aggregated_namespaces: Optional[Dict[StoragePolicy, bytes]] = None,
                  clock=None, listen=("127.0.0.1", 0),
                  self_scrape_interval_s: Optional[float] = None,
                  device=None) -> Coordinator:
    storage = SessionStorage(session, namespace)
    agg = {
        policy: SessionStorage(session, ns)
        for policy, ns in (aggregated_namespaces or {}).items()
    }
    return _build(storage, agg, kv_store, rules_namespace, clock, None,
                  listen, self_scrape_interval_s=self_scrape_interval_s,
                  device=device)
