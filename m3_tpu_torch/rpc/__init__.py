"""RPC transport layer (port of m3_tpu/rpc; reference:
src/dbnode/network/server/tchannelthrift).

Length-prefixed binary frames over TCP; node service method parity with
the thrift `Node` service IDL (src/dbnode/generated/thrift/rpc.thrift)."""

from .node_server import NodeServer, NodeService, RPCError
from .wire import (
    WireTruncated,
    decode,
    deadline_from_frame,
    encode,
    query_from_wire,
    query_to_wire,
    read_frame,
    write_frame,
)

__all__ = [
    "NodeServer",
    "NodeService",
    "RPCError",
    "WireTruncated",
    "deadline_from_frame",
    "decode",
    "encode",
    "query_from_wire",
    "query_to_wire",
    "read_frame",
    "write_frame",
]
