"""Query engine: PromQL parse -> plan -> batched block execution (port of
m3_tpu/query; reference: src/query — the coordinator's engine, storage
adapters, and API surface)."""

from .block import Block, BlockMeta, block_from_series, consolidate
from .executor import Engine, QueryError, QueryParams
from .model import Matcher, MatchType, METRIC_NAME, Tags, matchers_to_index_query
from .promql import parse, ParseError
from .storage import FanoutStorage, LocalStorage, SessionStorage

__all__ = [
    "Block", "BlockMeta", "Engine", "FanoutStorage", "LocalStorage",
    "Matcher", "MatchType", "METRIC_NAME", "ParseError", "QueryError",
    "QueryParams", "SessionStorage", "Tags", "block_from_series",
    "consolidate", "matchers_to_index_query", "parse",
]
