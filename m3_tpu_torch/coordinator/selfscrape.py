"""Self-scrape: the platform monitors itself with itself (reference: the
reference reports its own tally scopes back through M3 — m3 famously
dogfoods its metrics pipeline; `utils/instrument.py`'s docstring promised
the same and nothing implemented it until now).

`SelfScraper` converts `instrument.ROOT.snapshot()` into real metric
writes through the coordinator ingest path (`DownsamplerAndWriter`) into
the platform's own storage, so every internal counter — gate depths,
shed tallies, cache hit rates, jit compiles, health state — is queryable
back through the PromQL surface like any customer series:

    health_state
    admission_rpc_node_depth
    rate(coordinator_ingest_written[1m])
    telemetry_jit_compiles

Mechanics (vs tally's CachedReporter — DIVERGENCES.md):

  * names sanitize to the prom charset (dots -> underscores); the
    instrument key's `{k=v,...}` tag suffix becomes real labels, plus
    constant `role`/`instance` labels identifying the scraped process.
  * counters/gauges emit their CURRENT value (prom cumulative-counter
    semantics: `rate()` does the delta) — but only when the value CHANGED
    since the previous scrape ("snapshot-delta" scraping), so an idle
    process writes ~nothing instead of re-writing every flat series each
    interval.
  * histograms emit `<name>_sum`, `<name>_count`, and cumulative
    `<name>_bucket{le=...}` series (histogram_quantile-compatible).
  * writes go through the SAME admission gates as customer traffic at
    NORMAL priority: an overloaded coordinator sheds its own telemetry
    before customer data, and a shed scrape just retries next interval
    (the write is levels, not deltas, so nothing is lost).

The loop is a daemon thread on `interval_s`; `scrape_once()` is the
deterministic entry tests and the obs smoke drive directly.

Port of m3_tpu/coordinator/selfscrape.py."""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

from ..utils.instrument import ROOT, Scope

_NAME_RE = re.compile(rb"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> bytes:
    out = _NAME_RE.sub(b"_", name.encode())
    if out and out[0:1].isdigit():
        out = b"_" + out
    return out


def _split_key(key: str) -> Tuple[str, Dict[bytes, bytes]]:
    """instrument snapshot key -> (bare name, label dict): the registry
    formats tagged metrics as `prefix.name{k=v,k2=v2}`."""
    name, brace, rest = key.partition("{")
    if not brace:
        return name, {}
    labels = {}
    for pair in rest.rstrip("}").split(","):
        k, eq, v = pair.partition("=")
        if eq:
            labels[_sanitize(k)] = v.encode()
    return name, labels


class SelfScraper:
    """Periodic instrument -> ingest bridge for one process."""

    def __init__(self, writer, clock=None, interval_s: float = 10.0,
                 scope: Optional[Scope] = None, role: str = "coordinator",
                 instance: str = "", prefix: str = ""):
        """writer: DownsamplerAndWriter (or anything with
        .write(tags, t_ns, value)); clock: ns clock for sample
        timestamps (defaults to wall time — these are DATA timestamps,
        not latency measurements)."""
        import time as _time

        self._writer = writer
        self._clock = clock or _time.time_ns
        self.interval_s = interval_s
        self._scope = scope if scope is not None else ROOT
        self._const = {b"role": role.encode()}
        if instance:
            self._const[b"instance"] = instance.encode()
        self._prefix = prefix
        self._prev: Dict[str, object] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scrapes = 0
        self.samples_written = 0
        self.errors = 0

    # ----------------------------------------------------------- one pass

    def _emit(self, name: bytes, labels: Dict[bytes, bytes], t_ns: int,
              value: float) -> bool:
        tags = {b"__name__": name, **self._const, **labels}
        try:
            self._writer.write(tags, t_ns, float(value))
        except Exception:  # noqa: BLE001 — a shed/failed sample must not
            self.errors += 1   # kill the scrape; levels re-emit next pass
            return False
        self.samples_written += 1
        return True

    def scrape_once(self, now_ns: Optional[int] = None) -> int:
        """One snapshot -> ingest pass; returns samples written. Values
        unchanged since the last pass are skipped (snapshot-delta), so
        steady state writes only what moved."""
        from ..utils.health import TRACKER

        # Refresh the health gauges so the scraped snapshot carries the
        # CURRENT state machine verdict, not the last /health probe's.
        TRACKER.evaluate()
        t_ns = now_ns if now_ns is not None else self._clock()
        snap = self._scope.snapshot()
        written = 0
        for key, val in snap.items():
            prev = self._prev.get(key)
            if isinstance(val, dict):
                if prev == val:
                    continue
                name, labels = _split_key(key)
                base = _sanitize(self._prefix + name)
                landed = [self._emit(base + b"_sum", labels, t_ns,
                                     val.get("sum", 0.0)),
                          self._emit(base + b"_count", labels, t_ns,
                                     val.get("count", 0))]
                cum = 0
                for le, n in val.get("buckets", {}).items():
                    cum += n
                    landed.append(self._emit(
                        base + b"_bucket", {**labels, b"le": le.encode()},
                        t_ns, cum))
                written += sum(landed)
                # Mark done ONLY when every series landed: a shed write
                # of a value that then stays flat must re-emit next pass
                # (the "levels, nothing is lost" contract).
                if all(landed):
                    self._prev[key] = dict(val)
            else:
                if prev == val:
                    continue
                name, labels = _split_key(key)
                if self._emit(_sanitize(self._prefix + name), labels,
                              t_ns, val):
                    written += 1
                    self._prev[key] = val
        self.scrapes += 1
        return written

    # ------------------------------------------------------------- lifecycle

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — the scrape loop must
                self.errors += 1   # outlive transient storage errors

    def start(self) -> "SelfScraper":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="self-scraper", daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
