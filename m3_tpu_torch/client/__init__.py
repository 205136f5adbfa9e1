"""Smart replicating client (port of m3_tpu/client; reference:
src/dbnode/client)."""

from .decode import ConflictStrategy, decode_segment_groups, merge_replica_points
from .session import (
    ConsistencyError,
    HostClient,
    RemoteError,
    Session,
    SessionOptions,
)

__all__ = [
    "ConflictStrategy",
    "ConsistencyError",
    "HostClient",
    "RemoteError",
    "Session",
    "SessionOptions",
    "decode_segment_groups",
    "merge_replica_points",
]
