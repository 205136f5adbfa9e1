"""Metric metadata binding matched metrics to pipelines + storage policies
(reference: src/metrics/metadata/metadata.go).

Host copy of m3_tpu/metrics/metadata.py."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .pipeline import EMPTY_PIPELINE, Pipeline
from .policy import StoragePolicy


@dataclasses.dataclass(frozen=True)
class PipelineMetadata:
    """One pipeline a metric must flow through: aggregation-types bitmask,
    storage policies for its output, and remaining pipeline ops."""

    aggregation_id: int = 0
    storage_policies: Tuple[StoragePolicy, ...] = ()
    pipeline: Pipeline = EMPTY_PIPELINE
    drop_policy: int = 0

    def is_default(self) -> bool:
        return (
            self.aggregation_id == 0
            and not self.storage_policies
            and self.pipeline.is_empty()
            and self.drop_policy == 0
        )


@dataclasses.dataclass(frozen=True)
class Metadata:
    pipelines: Tuple[PipelineMetadata, ...] = ()


@dataclasses.dataclass(frozen=True)
class StagedMetadata:
    """Metadata active from a cutover time (metadata.go StagedMetadata)."""

    cutover_nanos: int = 0
    tombstoned: bool = False
    metadata: Metadata = Metadata()

    def is_default(self) -> bool:
        return self.cutover_nanos == 0 and not self.tombstoned and not self.metadata.pipelines


@dataclasses.dataclass(frozen=True)
class ForwardMetadata:
    """Metadata for a forwarded (multi-stage pipeline) metric
    (metadata.go ForwardMetadata)."""

    aggregation_id: int
    storage_policy: StoragePolicy
    pipeline: Pipeline
    source_id: bytes
    num_forwarded_times: int


DEFAULT_STAGED_METADATA = StagedMetadata()


@dataclasses.dataclass(frozen=True)
class IDWithMetadatas:
    id: bytes
    metadatas: Tuple[StagedMetadata, ...]
