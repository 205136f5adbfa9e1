"""Transfer-aware query placement: card or host, per evaluation (port of
m3_tpu/query/placement.py).

A range-function evaluation produces a [series x steps] f32 result plane
that must reach the host. The engine contains the host path as a subset
(the same torch functions with device="cpu") and routes each evaluation
by a measured cost model:

    host_cost  = cells / host_rate
    accel_cost = rtt + result_bytes / d2h_bw + cells / accel_rate

d2h_bw and rtt come from a probe of the real link (refreshed every
PROBE_REFRESH_S): the second launch of a tiny kernel with its result
copied back for the RTT, the copy of a 1 MB tensor back for the
bandwidth; host_rate and accel_rate are EWMAs of observed evaluations.

Placement is an opt-in: an Engine places only when it is given a
QueryPlacement (Engine(..., placement=QueryPlacement(device))); without
one, every evaluation runs on the engine's device. The reference's
"host" mode is Engine(..., device="cpu") here, and its "device" mode is
an engine without a placement. Only an engine on `cuda` has anything to
place: its host device is torch.device("cpu"). An engine on the CPU
always stays there. A failed probe is not swallowed: a CUDA error raises
typed through parallel/guard.classify, and a host placement is always a
counted routing decision, never a reaction to a failure.

Reference analog: the coordinator's fanout storage picks local against
remote per query (src/query/storage/fanout/storage.go)."""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from ..parallel import guard

PROBE_REFRESH_S = 60.0
_PROBE_BYTES = 1 << 20

# Priors until the first observation or probe replaces them: the host at
# 150M grid cells/s, the card at 5G cells/s (the reference's priors).
_HOST_RATE_PRIOR = 150e6
_ACCEL_RATE_PRIOR = 5e9


def _ewma(old: Optional[float], new: float, alpha: float = 0.3) -> float:
    return new if old is None else (1 - alpha) * old + alpha * new


class QueryPlacement:
    """Per-engine placement chooser and online cost model (the
    reference's "auto" mode) for an engine on `device`."""

    def __init__(self, device):
        self._lock = threading.Lock()
        self.device = torch.device(device)
        self._host_rate: Optional[float] = None
        self._accel_rate: Optional[float] = None
        self._d2h_bw: Optional[float] = None   # bytes/s
        self._rtt: Optional[float] = None      # seconds
        self._probed_at: Optional[float] = None
        self._decisions = {"host": 0, "device": 0}

    # -- devices -----------------------------------------------------------

    def _host_device(self) -> Optional[torch.device]:
        """torch.device("cpu") for an engine on `cuda`; None when the
        engine already runs on the host (nothing to place)."""
        if self.device.type == "cuda":
            return torch.device("cpu")
        return None

    # -- link probe --------------------------------------------------------

    def _claim_probe(self, now: float) -> bool:
        """Freshness guard, check-and-set under the lock: concurrent first
        queries must not each fire a probe and split the link. None (never
        probed) always probes."""
        with self._lock:
            if (self._probed_at is not None
                    and now - self._probed_at < PROBE_REFRESH_S):
                return False
            self._probed_at = now
            return True

    def _measure(self):
        """(rtt seconds, D2H bytes/s) on the engine's device. The first
        tiny launch warms the device and the allocator; the second one,
        copied back, is the RTT."""
        tiny = torch.arange(8, device=self.device)
        (tiny + 1).cpu()
        t0 = time.perf_counter()
        (tiny + 1).cpu()
        rtt = time.perf_counter() - t0
        buf = torch.zeros(_PROBE_BYTES // 4, dtype=torch.float32,
                          device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        buf.cpu()
        return rtt, _PROBE_BYTES / max(time.perf_counter() - t0, 1e-6)

    def _probe_link(self) -> None:
        """Measure the link, at most once per PROBE_REFRESH_S. A device
        fault raises typed (guard.classify); any other error propagates."""
        if not self._claim_probe(time.monotonic()):
            return
        try:
            rtt, bw = self._measure()
        except Exception as exc:  # noqa: BLE001 — classified or re-raised
            err = guard.classify(exc, "query.placement")
            if err is None:
                raise
            raise err from exc
        with self._lock:
            self._rtt = _ewma(self._rtt, rtt)
            self._d2h_bw = _ewma(self._d2h_bw, bw)

    # -- decision ----------------------------------------------------------

    def choose(self, cells: int, result_bytes: int) -> Optional[torch.device]:
        """Where to run this evaluation: None = the engine's device, or
        torch.device("cpu") for the host. Each call is one counted
        decision."""
        placed = self._decide(cells, result_bytes)
        with self._lock:
            self._decisions["host" if placed is not None else "device"] += 1
        return placed

    def _decide(self, cells: int, result_bytes: int):
        host_dev = self._host_device()
        if host_dev is None:
            return None
        self._probe_link()
        with self._lock:
            host_rate = self._host_rate or _HOST_RATE_PRIOR
            accel_rate = self._accel_rate or _ACCEL_RATE_PRIOR
            bw = self._d2h_bw
            rtt = self._rtt or 0.003
        if bw is None:
            # No probe measured yet: the card is taken as healthy and
            # local until measured otherwise.
            return None
        host_cost = cells / host_rate
        accel_cost = rtt + result_bytes / bw + cells / accel_rate
        return host_dev if host_cost < accel_cost else None

    # -- model updates -----------------------------------------------------

    def observe(self, device, cells: int, result_bytes: int,
                seconds: float) -> None:
        """Fold an observed evaluation (dispatch -> result on the host) into
        the rate model of the path that served it."""
        if seconds <= 0 or cells <= 0:
            return
        with self._lock:
            if device is not None:  # host-placed
                self._host_rate = _ewma(self._host_rate, cells / seconds)
            else:
                bw = self._d2h_bw
                transfer = (result_bytes / bw) if bw else 0.0
                if transfer >= 0.8 * seconds:
                    # The modelled transfer swallows the observation: the
                    # decomposition is unreliable, wait for the probe.
                    return
                compute = max(seconds - transfer - (self._rtt or 0.0), 1e-5)
                self._accel_rate = _ewma(self._accel_rate, cells / compute)

    def snapshot(self) -> dict:
        """The live model, and the decisions made so far by side."""
        with self._lock:
            return {
                "host_rate_cells_s": self._host_rate,
                "accel_rate_cells_s": self._accel_rate,
                "d2h_bw_mb_s": (self._d2h_bw / 2**20
                                if self._d2h_bw else None),
                "rtt_ms": (self._rtt * 1e3 if self._rtt else None),
                "placed_host": self._decisions["host"],
                "placed_device": self._decisions["device"],
            }
