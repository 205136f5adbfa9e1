"""Datapoint transformations (reference: src/metrics/transformation).

Scalar forms mirror the reference exactly for host-side pipeline
execution; the `*_batch` forms are torch ops over whole windows, on the
tensors' own device (port of the jnp forms of
m3_tpu/metrics/transformation.py)."""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch

NANOS_PER_SECOND = 1_000_000_000


class TransformType(enum.IntEnum):
    """transformation/type.go: Absolute (unary), PerSecond (binary)."""

    UNKNOWN = 0
    ABSOLUTE = 1
    PERSECOND = 2

    def is_unary(self) -> bool:
        return self == TransformType.ABSOLUTE

    def is_binary(self) -> bool:
        return self == TransformType.PERSECOND


@dataclasses.dataclass(frozen=True)
class Datapoint:
    time_nanos: int
    value: float


EMPTY_DATAPOINT = Datapoint(0, math.nan)


def absolute(dp: Datapoint) -> Datapoint:
    """transformation/unary.go:24."""
    return Datapoint(dp.time_nanos, abs(dp.value))


def per_second(prev: Datapoint, curr: Datapoint) -> Datapoint:
    """transformation/binary.go:36 perSecond: non-negative rate between
    consecutive datapoints; empty on NaN/non-increasing time/negative diff."""
    if prev.time_nanos >= curr.time_nanos or math.isnan(prev.value) or math.isnan(curr.value):
        return EMPTY_DATAPOINT
    diff = curr.value - prev.value
    if diff < 0:
        return EMPTY_DATAPOINT
    rate = diff * NANOS_PER_SECOND / (curr.time_nanos - prev.time_nanos)
    return Datapoint(curr.time_nanos, rate)


def apply(t: TransformType, prev: Optional[Datapoint], curr: Datapoint) -> Datapoint:
    if t == TransformType.ABSOLUTE:
        return absolute(curr)
    if t == TransformType.PERSECOND:
        if prev is None:
            return EMPTY_DATAPOINT
        return per_second(prev, curr)
    raise ValueError(f"unknown transformation {t}")


def absolute_batch(values: torch.Tensor) -> torch.Tensor:
    return torch.abs(values)


def per_second_batch(time_nanos: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """Vectorized perSecond over a [..., W] window (integer times, float
    values); index 0 and invalid steps (dt <= 0, dv < 0, NaN dv) produce
    NaN (the reference's empty datapoint). The rate keeps the values'
    dtype."""
    dt = torch.diff(time_nanos, dim=-1)
    dv = torch.diff(values, dim=-1)
    rate = dv * NANOS_PER_SECOND / torch.clamp(dt, min=1)
    bad = (dt <= 0) | (dv < 0) | torch.isnan(dv)
    rate = torch.where(bad, torch.full_like(rate, math.nan), rate)
    pad = torch.full(values.shape[:-1] + (1,), math.nan, dtype=values.dtype,
                     device=values.device)
    return torch.cat([pad, rate], dim=-1)
