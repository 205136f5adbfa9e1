"""Service binaries (port of m3_tpu/services; reference: src/cmd/services
— yaml-config-driven mains over library run functions). The run_*
functions that reach a device take `device=None`: the CUDA card."""

from .config import (
    AggregatorConfig,
    CollectorConfig,
    ConfigError,
    CoordinatorConfig,
    DBNodeConfig,
    NamespaceConfig,
    load_dict,
    load_file,
)
from .run import (
    AggregatorHandle,
    DBNodeHandle,
    run_aggregator,
    run_collector,
    run_coordinator,
    run_dbnode,
)

__all__ = [
    "AggregatorConfig", "AggregatorHandle", "CollectorConfig", "ConfigError",
    "CoordinatorConfig", "DBNodeConfig", "DBNodeHandle", "NamespaceConfig",
    "load_dict", "load_file", "run_aggregator", "run_collector",
    "run_coordinator", "run_dbnode",
]
