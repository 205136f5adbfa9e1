"""Service configuration (host copy of m3_tpu/services/config.py;
reference: each binary takes a single '-f config.yml' flag parsed into
validated structs via m3x/config, src/cmd/services/m3dbnode/config/
config.go etc.).

Configs are plain dataclasses hydrated from YAML with unknown-key
validation, mirroring the reference's strict unmarshal. The defaults are
the reference's, so one file means the same deployment to both packages.

PyYAML is imported only inside `load_file`: `load_dict` and every `run_*`
work without it. Where PyYAML is missing, `load_file` reads the file as
JSON (every JSON document is YAML, so the reference reads the same file
to the same dict) and refuses anything else with a `ConfigError` naming
PyYAML."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from ..query.promql import parse_duration_ns


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class NamespaceConfig:
    name: str = "default"
    retention: str = "48h"
    block_size: str = "2h"
    index_enabled: bool = True
    # Mutable-buffer acceptance window (bufferPast/bufferFuture in the
    # reference's namespace options); small values let integration
    # drills seal blocks in seconds instead of hours.
    buffer_past: str = "10m"
    buffer_future: str = "2m"

    @property
    def retention_ns(self) -> int:
        return parse_duration_ns(self.retention)

    @property
    def block_size_ns(self) -> int:
        return parse_duration_ns(self.block_size)

    @property
    def buffer_past_ns(self) -> int:
        return parse_duration_ns(self.buffer_past)

    @property
    def buffer_future_ns(self) -> int:
        return parse_duration_ns(self.buffer_future)


@dataclasses.dataclass
class DBNodeConfig:
    host_id: str = "m3db_local"
    listen_address: str = "127.0.0.1:0"
    http_listen_address: str = ""
    data_dir: str = "/tmp/m3_tpu_data"
    num_shards: int = 64
    replication_factor: int = 1
    namespaces: List[NamespaceConfig] = dataclasses.field(
        default_factory=lambda: [NamespaceConfig()])
    commitlog_enabled: bool = True
    # "write_behind" (flush-interval durability) or "write_wait" (every
    # write fsynced before its ack — the zero-acked-loss contract;
    # commit_log.go:241 strategies).
    commitlog_strategy: str = "write_behind"
    # Run the bootstrap chain (filesystem -> commitlog) over data_dir on
    # startup instead of starting empty: the cold-restart path. Off by
    # default to preserve the fresh-start embedded uses.
    bootstrap_enabled: bool = False
    # Background mediator cadence (tick -> flush -> snapshot -> cleanup,
    # mediator.go ongoingTick); empty disables the background thread.
    tick_interval: str = ""
    # Background fileset scrub cadence (storage/scrub.py: cold-data row
    # checksum verification + quarantine + repair routing); empty
    # disables the scrubber thread.
    scrub_interval: str = ""
    kv_path: str = ""          # FileStore path; empty = in-memory
    kv_endpoint: str = ""      # networked KV service; overrides kv_path
    coordinator: Optional["CoordinatorConfig"] = None  # embedded mode


@dataclasses.dataclass
class CoordinatorConfig:
    listen_address: str = "127.0.0.1:0"
    namespace: str = "default"
    rules_namespace: str = "default"
    carbon_listen_address: str = ""    # empty = disabled
    remotes: List[str] = dataclasses.field(default_factory=list)
    lookback: str = "5m"
    kv_endpoint: str = ""              # standalone mode: cluster KV service
    placement_key: str = "_placement"  # dbnode placement watched for routing
    # Self-scrape interval (e.g. "10s"): the coordinator's instrument
    # registry written back through its own ingest path each interval
    # (tally-self-reporting analog). Empty disables.
    self_scrape_interval: str = ""

    @property
    def self_scrape_interval_s(self) -> Optional[float]:
        if not self.self_scrape_interval:
            return None
        return parse_duration_ns(self.self_scrape_interval) / 1e9


@dataclasses.dataclass
class AggregatorConfig:
    instance_id: str = "agg_local"
    listen_address: str = "127.0.0.1:0"
    # HTTP admin sidecar (health/status/resign); empty disables it.
    admin_address: str = ""
    num_shards: int = 64
    shard_set_id: str = "shardset-0"
    election_id: str = "agg-election"
    flush_interval: str = "1s"
    kv_path: str = ""
    kv_endpoint: str = ""
    placement_key: str = ""    # empty = static: own all shards
    topic: str = "aggregated_metrics"
    # Durable per-datapoint flush sink (handler.FileHandler); empty
    # disables.
    flush_log: str = ""
    # Leader lease TTL: a dead leader's lease expires after this long and a
    # follower's campaign wins (services/leader etcd-session TTL analog).
    election_ttl: str = "10s"


@dataclasses.dataclass
class CollectorConfig:
    num_shards: int = 64
    rules_namespace: str = "default"
    kv_path: str = ""
    kv_endpoint: str = ""


@dataclasses.dataclass
class KVConfig:
    """Standalone cluster-metadata KV service (the etcd-analog process)."""

    listen_address: str = "127.0.0.1:0"
    kv_path: str = ""          # FileStore durability; empty = in-memory


_SERVICES = {
    "dbnode": DBNodeConfig,
    "coordinator": CoordinatorConfig,
    "aggregator": AggregatorConfig,
    "collector": CollectorConfig,
    "kv": KVConfig,
}


def _hydrate(cls, obj: Dict[str, Any]):
    if obj is None:
        obj = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(obj) - set(fields)
    if unknown:
        raise ConfigError(
            f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in obj.items():
        if name == "namespaces":
            kwargs[name] = [_hydrate(NamespaceConfig, v) for v in value]
        elif name == "coordinator" and value is not None:
            kwargs[name] = _hydrate(CoordinatorConfig, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _parse(text: str, path: str):
    """The file's document: YAML through PyYAML where it is installed,
    else JSON."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text) if text.strip() else None
        except ValueError as err:
            raise ConfigError(
                f"{path}: PyYAML is not installed, so the config must be "
                f"JSON (every JSON document is YAML): {err}") from None
    return yaml.safe_load(text)


def load_file(path: str, service: str):
    """xconfig.LoadFile equivalent: YAML -> validated config dataclass.
    The file may either be the service config directly or contain a
    top-level key per service (the reference's m3dbnode config embeds a
    'coordinator' section the same way)."""
    with open(path) as f:
        raw = _parse(f.read(), path) or {}
    return load_dict(raw, service)


def load_dict(raw: Dict[str, Any], service: str):
    cls = _SERVICES.get(service)
    if cls is None:
        raise ConfigError(f"unknown service {service!r}")
    if service in raw and isinstance(raw[service], dict):
        raw = raw[service]
    return _hydrate(cls, raw)
