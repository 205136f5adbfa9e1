"""Collector reporter: match each metric against KV-watched rules, forward
matched policies to the aggregator (host copy of
m3_tpu/collector/reporter.py, no device; reference:
src/collector/reporter/m3aggregator/reporter.go — ReportCounter/
ReportBatchTimer/ReportGauge match via metrics/matcher and write through
src/aggregator/client).

Rollup rule matches also emit the rolled-up ID with its own metadatas, the
same shape the coordinator downsampler's metrics_appender produces."""

from __future__ import annotations

from typing import Optional, Sequence

from ..aggregator.client import AggregatorClient
from ..metrics.matcher import Matcher
from ..metrics.metric import MetricUnion
from ..metrics.policy import DropPolicy


class Reporter:
    def __init__(self, matcher: Matcher, client: AggregatorClient):
        self._matcher = matcher
        self._client = client
        self.reported = 0
        self.dropped_by_rule = 0
        self.unmatched = 0

    def _report(self, mu: MetricUnion) -> bool:
        result = self._matcher.match(mu.id)
        if result is None:
            self.unmatched += 1
            return False
        metadatas = result.for_existing_id
        if _dropped(metadatas):
            self.dropped_by_rule += 1
            return True
        ok = self._client.write_untimed(mu, metadatas)
        for idm in result.for_new_rollup_ids:
            rolled = _with_id(mu, idm.id)
            ok = self._client.write_untimed(rolled, idm.metadatas) and ok
        if ok:
            self.reported += 1
        return ok

    def report_counter(self, metric_id: bytes, value: int) -> bool:
        return self._report(MetricUnion.counter(metric_id, value))

    def report_batch_timer(self, metric_id: bytes, values: Sequence[float]) -> bool:
        return self._report(MetricUnion.batch_timer(metric_id, values))

    def report_gauge(self, metric_id: bytes, value: float) -> bool:
        return self._report(MetricUnion.gauge(metric_id, value))

    def flush(self):
        """The reference reporter flushes its aggregator-client buffers
        (reporter.go Flush); the in-process client writes through, so this
        is a no-op hook for symmetry."""


def _dropped(metadatas) -> bool:
    """True when the active stage's every pipeline is a must-drop
    (rules/active_ruleset.go applies drop policies before emitting)."""
    for sm in metadatas:
        pipes = sm.metadata.pipelines
        if pipes and all(p.drop_policy == DropPolicy.DROP_MUST for p in pipes):
            return True
    return False


def _with_id(mu: MetricUnion, new_id: bytes) -> MetricUnion:
    import dataclasses

    return dataclasses.replace(mu, id=new_id)
