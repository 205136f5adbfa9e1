"""Collector: rule-matched metric forwarding agent (port of
m3_tpu/collector; reference: src/collector — alpha per
collector/README.md, reporter + aggregator client). Host code with no
device."""

from .reporter import Reporter

__all__ = ["Reporter"]
