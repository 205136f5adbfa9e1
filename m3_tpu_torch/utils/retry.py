"""Unified resilience primitives for every networked layer (reference:
src/x/retry/retry.go — exponential backoff with jitter, retryable-error
classification, per-attempt hooks — plus the connection-pool health
checking in src/dbnode/client/connection_pool.go and the host breaker
shape the reference gets from hailocab/go-hostpool).

Three cooperating pieces, shared by client/session, msg/producer,
query/remote and cluster/kv_service:

  Retrier   exponential backoff with decorrelating jitter, max attempts
            and max cumulative duration, pluggable retryable-error
            classification, and an on_retry hook for instrumentation.
  Breaker   closed -> open on failure-rate trip over a sliding outcome
            window; open -> half-open after a cooldown; a bounded number
            of half-open probes either close it again or re-open it.
            Stops retry storms from hammering a dead endpoint.
  Deadline  a remaining-time budget that rides RPC request frames as a
            nanosecond budget (not an absolute timestamp, so clock skew
            between hosts cannot corrupt it) and is re-anchored against
            the receiver's monotonic clock on arrival.

Everything takes an injectable clock/sleep/rng so the chaos suite
(tests/test_resilience.py) runs deterministic schedules.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

__all__ = [
    "RetryableError", "NonRetryableError", "DeadlineExceeded",
    "RetryOptions", "Retrier",
    "BreakerOptions", "Breaker", "BreakerOpen",
    "Deadline", "HostHealth", "default_is_retryable",
]


class RetryableError(Exception):
    """Marker base: raising (a subclass of) this tells every Retrier the
    operation is safe to re-attempt regardless of its concrete type."""


class NonRetryableError(Exception):
    """Marker base: never re-attempted even if a subclass also inherits
    from a retryable family (classification checks this first)."""


class DeadlineExceeded(Exception):
    """The operation's time budget ran out (client-observed or relayed
    from a server's typed deadline error frame). Never retried: the
    budget that expired is the caller's whole budget."""


class BreakerOpen(ConnectionError):
    """Raised instead of attempting I/O while a breaker is open. A
    ConnectionError subclass so quorum fanout / host-failure paths treat
    the endpoint exactly like a connect failure — just without paying
    for the socket."""


def default_is_retryable(e: BaseException) -> bool:
    """x/retry's classification adapted to this wire stack: transport
    errors retry, application/typed errors don't.

    Retryable: RetryableError, ConnectionError (covers WireTruncated),
    OSError (connect failures, socket timeouts). Not retryable:
    NonRetryableError, DeadlineExceeded (the budget is gone), BreakerOpen
    (the breaker's cooldown far exceeds any sane backoff, so re-asking
    the SAME breaker is guaranteed-futile sleeping — retrying a different
    host belongs to the quorum/fanout layer above), and everything else
    (server-side application errors relayed over the wire, protocol
    desyncs surfaced as ValueError — retrying a desynced exchange
    re-sends into garbage)."""
    if isinstance(e, (NonRetryableError, DeadlineExceeded, BreakerOpen)):
        return False
    return isinstance(e, (RetryableError, ConnectionError, OSError))


# ---------------------------------------------------------------- deadline


_NS = 1_000_000_000


class Deadline:
    """Monotonic time budget. Created from seconds (or a wire budget in
    ns), carried across RPC hops as `remaining_ns`, re-anchored on the
    receiving side's own clock."""

    __slots__ = ("_t_end", "_clock")

    def __init__(self, t_end: float, clock: Callable[[], float] = time.monotonic):
        self._t_end = t_end
        self._clock = clock

    @classmethod
    def after(cls, seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + seconds, clock)

    @classmethod
    def from_wire(cls, budget_ns: Optional[int],
                  clock: Callable[[], float] = time.monotonic
                  ) -> Optional["Deadline"]:
        """None passes through: requests without a deadline stay unbounded."""
        if budget_ns is None:
            return None
        return cls(clock() + budget_ns / _NS, clock)

    def to_wire(self) -> int:
        """Remaining budget in ns (>= 0) to ride a request frame."""
        return max(0, int(self.remaining() * _NS))

    def remaining(self) -> float:
        return self._t_end - self._clock()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "operation") -> None:
        """Raise if the budget is spent. The raised error is tagged
        `pre_io=True`: a check() fires BEFORE work starts (lock waits,
        queueing, backoff), so breakers must not blame the endpoint for
        it — deadline expiry DURING I/O surfaces as a socket timeout or
        a server-relayed deadline frame instead."""
        rem = self.remaining()
        if rem <= 0:
            e = DeadlineExceeded(f"{what}: deadline exceeded "
                                 f"({-rem * 1e3:.1f}ms past)")
            e.pre_io = True
            raise e

    def min_timeout(self, timeout_s: float) -> float:
        """Socket timeout capped by the remaining budget (never <= 0 —
        callers check() first, so a tiny positive floor only bounds the
        final read instead of disabling timeouts)."""
        return max(1e-3, min(timeout_s, self.remaining()))


# ----------------------------------------------------------------- retrier


@dataclasses.dataclass(frozen=True)
class RetryOptions:
    """x/retry options.go equivalent. Defaults here are an order of
    magnitude tighter than the reference's (see DIVERGENCES.md): this
    stack's RPCs are LAN-or-localhost with sub-ms service times, and the
    chaos suite needs trip/recovery cycles to fit in test wall-time."""

    initial_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0
    max_attempts: int = 3          # total tries, not extra retries
    max_duration_s: float = 0.0    # 0 = unbounded (bounded by attempts)
    jitter: bool = True
    forever: bool = False          # retry until deadline/duration instead
    seed: Optional[int] = None     # deterministic jitter for tests


class Retrier:
    """Run an operation with classified retries and backoff
    (x/retry retrier.go Attempt/AttemptWhile).

    `is_retryable` overrides the default classification; `on_retry` fires
    before every sleep with (attempt_number, delay_s, exception) — the
    instrumentation hook the reference exposes as retry metrics scope."""

    def __init__(self, opts: RetryOptions = RetryOptions(),
                 is_retryable: Optional[Callable[[BaseException], bool]] = None,
                 on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.opts = opts
        self._is_retryable = is_retryable or default_is_retryable
        self._on_retry = on_retry
        self._sleep = sleep
        self._clock = clock
        self._rng = random.Random(opts.seed) if opts.seed is not None else random
        self.attempts = 0   # lifetime attempt counter (instrumentation)
        self.retries = 0    # lifetime retry (re-attempt) counter

    def backoff_for(self, attempt: int) -> float:
        """Delay before re-attempt number `attempt` (1-based: the delay
        after the first failure is backoff_for(1)). x/retry retry.go
        BackoffNanos: base = initial * factor^(attempt-1) capped at max;
        with jitter the delay is uniform in [base/2, base] (half fixed,
        half random — the reference's jitter shape)."""
        o = self.opts
        # iterate instead of `factor ** (attempt-1)`: unbounded attempt
        # counters (per-message send attempts, watch reconnect failures)
        # would overflow float's 2**1024 ceiling long before the cap —
        # grow until the cap bites, never exponentiate blind
        base = min(o.initial_backoff_s, o.max_backoff_s)
        for _ in range(max(0, attempt - 1)):
            nxt = min(base * o.backoff_factor, o.max_backoff_s)
            if nxt <= base:
                break  # cap reached (or non-growing factor): stop early
            base = nxt
        if o.jitter and base > 0:
            half = base / 2.0
            return half + self._rng.uniform(0, half)
        return base

    def schedule(self, n: int) -> List[float]:
        """First n backoff delays (deterministic when seeded) — what the
        chaos suite asserts bounded-latency against."""
        return [self.backoff_for(i) for i in range(1, n + 1)]

    def attempt(self, fn: Callable, *args,
                deadline: Optional[Deadline] = None, **kwargs):
        """Call fn until it succeeds, the classification says stop, the
        attempt/duration budget is spent, or the deadline expires."""
        o = self.opts
        started = self._clock()
        attempt = 0
        while True:
            if deadline is not None:
                deadline.check("retry")
            attempt += 1
            self.attempts += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self._is_retryable(e):
                    raise
                out_of_attempts = (not o.forever
                                   and attempt >= max(1, o.max_attempts))
                delay = self.backoff_for(attempt)
                elapsed = self._clock() - started
                out_of_time = (o.max_duration_s > 0
                               and elapsed + delay > o.max_duration_s)
                dead = (deadline is not None
                        and deadline.remaining() <= delay)
                if out_of_attempts or out_of_time or dead:
                    if dead:
                        raise DeadlineExceeded(
                            f"retry: next backoff ({delay * 1e3:.0f}ms) "
                            "exceeds remaining deadline") from e
                    # x/retry parity: the caller gets the LAST error with
                    # its own type (quorum fanout, health checks and tests
                    # all classify on concrete exception types).
                    raise
                self.retries += 1
                if self._on_retry is not None:
                    self._on_retry(attempt, delay, e)
                self._sleep(delay)


# ----------------------------------------------------------------- breaker


@dataclasses.dataclass(frozen=True)
class BreakerOptions:
    """Failure-rate trip over a sliding window of outcomes, cooldown to
    half-open, bounded concurrent probes, successes required to close."""

    window: int = 16               # outcomes remembered
    failure_ratio: float = 0.5     # trip when failures/window >= ratio...
    min_samples: int = 4           # ...and at least this many outcomes seen
    cooldown_s: float = 0.5        # open -> half-open
    half_open_probes: int = 1      # concurrent probes allowed half-open
    success_to_close: int = 1      # half-open successes that close it


class Breaker:
    """closed / open / half-open circuit breaker. Thread-safe; every
    state transition is appended to `.transitions` (old, new, monotonic
    time) so tests and instrumentation can assert the lifecycle."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, opts: BreakerOptions = BreakerOptions(),
                 clock: Callable[[], float] = time.monotonic,
                 name: str = ""):
        self.opts = opts
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: Deque[bool] = deque(maxlen=max(1, opts.window))
        self._opened_at = 0.0
        self._probes_inflight = 0
        self._half_open_successes = 0
        self.transitions: List[Tuple[str, str, float]] = []

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _transition_locked(self, new: str):
        if new != self._state:
            self.transitions.append((self._state, new, self._clock()))
            self._state = new

    def _maybe_half_open_locked(self):
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.opts.cooldown_s):
            self._transition_locked(self.HALF_OPEN)
            self._probes_inflight = 0
            self._half_open_successes = 0

    def allow(self) -> bool:
        """May a request proceed right now? Half-open admits at most
        `half_open_probes` in-flight probes; callers that got True MUST
        report record_success/record_failure or the probe slot leaks."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                return False
            if self._probes_inflight >= self.opts.half_open_probes:
                return False
            self._probes_inflight += 1
            return True

    def record_success(self):
        with self._lock:
            self._outcomes.append(True)
            if self._state == self.HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._half_open_successes += 1
                if self._half_open_successes >= self.opts.success_to_close:
                    self._transition_locked(self.CLOSED)
                    self._outcomes.clear()

    def cancel(self):
        """Release an allow() grant WITHOUT recording an outcome: the
        operation was abandoned before any I/O touched the endpoint
        (client-side deadline expiry, local queueing). Required so a
        granted half-open probe slot cannot leak — an unreleased slot
        wedges the breaker half-open forever."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)

    def record_failure(self):
        with self._lock:
            self._outcomes.append(False)
            if self._state == self.HALF_OPEN:
                # a failed probe re-opens immediately (probe recovery)
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._transition_locked(self.OPEN)
                self._opened_at = self._clock()
                return
            if self._state != self.CLOSED:
                return
            n = len(self._outcomes)
            fails = sum(1 for ok in self._outcomes if not ok)
            if (n >= self.opts.min_samples
                    and fails / n >= self.opts.failure_ratio):
                self._transition_locked(self.OPEN)
                self._opened_at = self._clock()

    def call(self, fn: Callable, *args, **kwargs):
        """Guarded call: BreakerOpen without I/O when open, outcome
        recorded otherwise. DeadlineExceeded counts as a failure (the
        endpoint burned the whole budget); server-relayed application
        errors should be recorded as success by callers that can tell —
        this convenience wrapper treats any exception as failure."""
        if not self.allow():
            raise BreakerOpen(
                f"breaker {self.name or id(self):} open: endpoint shed")
        try:
            result = fn(*args, **kwargs)
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


# ------------------------------------------------------------- host health


class HostHealth:
    """Per-endpoint breaker + outcome counters shared by a client's host
    pool (connection_pool.go health check + go-hostpool shape). One
    HostHealth serves a whole Session/Producer; breakers are created
    lazily per endpoint and share options/clock."""

    def __init__(self, opts: BreakerOptions = BreakerOptions(),
                 clock: Callable[[], float] = time.monotonic):
        self.opts = opts
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict[str, Breaker] = {}
        self._stats: Dict[str, Dict[str, int]] = {}

    def breaker(self, endpoint: str) -> Breaker:
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is None:
                b = Breaker(self.opts, clock=self._clock, name=endpoint)
                self._breakers[endpoint] = b
                self._stats[endpoint] = {"success": 0, "failure": 0}
            return b

    def count(self, endpoint: str, ok: bool):
        """Outcome counter only — for callers that drive the (shared)
        breaker themselves, like HostClient."""
        self.breaker(endpoint)  # ensure registered
        with self._lock:
            self._stats[endpoint]["success" if ok else "failure"] += 1

    def record(self, endpoint: str, ok: bool):
        b = self.breaker(endpoint)
        self.count(endpoint, ok)
        if ok:
            b.record_success()
        else:
            b.record_failure()

    def healthy(self, endpoint: str) -> bool:
        return self.breaker(endpoint).state != Breaker.OPEN

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                ep: {"state": self._breakers[ep].state, **self._stats[ep]}
                for ep in self._breakers
            }
