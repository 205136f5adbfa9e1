"""Operation pipelines (reference: src/metrics/pipeline/type.go and
pipeline/applied): ordered aggregate -> transform -> rollup stages that a
matched metric flows through, possibly hopping aggregator tiers.

Host copy of m3_tpu/metrics/pipeline.py."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from .aggregation import AggType
from .transformation import TransformType


class OpType(enum.IntEnum):
    """Pipeline operation kinds (pipeline/type.go OpType)."""

    UNKNOWN = 0
    AGGREGATION = 1
    TRANSFORMATION = 2
    ROLLUP = 3


@dataclasses.dataclass(frozen=True)
class RollupOp:
    """Roll up into a new metric keeping `tags` dimensions, aggregated with
    `aggregation_id` (pipeline/type.go RollupOp)."""

    new_name: bytes
    tags: Tuple[bytes, ...]
    aggregation_id: int = 0


@dataclasses.dataclass(frozen=True)
class Op:
    type: OpType
    aggregation: Optional[AggType] = None
    transformation: Optional[TransformType] = None
    rollup: Optional[RollupOp] = None

    @staticmethod
    def aggregate(t: AggType) -> "Op":
        return Op(OpType.AGGREGATION, aggregation=t)

    @staticmethod
    def transform(t: TransformType) -> "Op":
        return Op(OpType.TRANSFORMATION, transformation=t)

    @staticmethod
    def roll(new_name: bytes, tags, aggregation_id: int = 0) -> "Op":
        return Op(OpType.ROLLUP, rollup=RollupOp(new_name, tuple(tags), aggregation_id))


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """Ordered list of ops (pipeline/type.go Pipeline)."""

    ops: Tuple[Op, ...] = ()

    def at(self, i: int) -> Op:
        return self.ops[i]

    def __len__(self):
        return len(self.ops)

    def is_empty(self) -> bool:
        return not self.ops

    def sub(self, start: int, end: Optional[int] = None) -> "Pipeline":
        return Pipeline(self.ops[start:end])


EMPTY_PIPELINE = Pipeline()
