"""Query limits: per-second sliding windows + global concurrent budgets
(reference: src/dbnode/storage/limits/query_limits.go — docs-matched /
series / bytes-read lookback limits backed by x/cost, each with a
per-second global window — and src/x/cost/enforcer.go's parent/child
chain so one query cannot starve the process).

Two mechanisms per resource kind, composed in one `QueryLimits`
registry:

  sliding window   a rate limit over the trailing second (bucketized —
                   see DIVERGENCES.md vs the reference's reset ticker).
                   Window charges are never released; they expire.
  concurrent       an in-flight budget backed by cost.Enforcer. Charged
                   only through a QueryScope (per-query child enforcer
                   chained to the global parent) so every admit has a
                   matching release at scope exit — budget charged
                   outside any scope hits the window only, because
                   nothing would ever credit it back.

Exceeding either raises `ResourceExhausted`, a RetryableError: the
server sheds THIS request, but the condition is transient (windows
expire, scopes release), so clients classify it retryable-with-backoff
— unlike DeadlineExceeded, where the budget that expired was the
caller's whole budget. `Backpressure` is the ingest-side subclass
raised by admission gates (utils/health.py) past their watermarks.

Charge sites (index postings evaluation, storage reads, RPC fan-ins)
call the module-level `charge(kind, n)`, which routes to the innermost
thread-local QueryScope when one is installed (query executor, node
RPC dispatch) and to the global registry otherwise.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

from .cost import CostLimitExceeded, Enforcer
from .instrument import ROOT
from .retry import RetryableError

__all__ = [
    "ResourceExhausted", "Backpressure", "LimitOptions", "SlidingWindow",
    "QueryLimits", "QueryScope", "KINDS", "tenant_of",
    "charge", "get_global", "set_global", "last_scope_totals",
]


def tenant_of(metric_id: bytes) -> bytes:
    """Tenant extracted from a metric id: the first dot-delimited segment
    of the NAME component ('tenantA.requests;host=x' -> b'tenantA').
    Frames/requests may override with an explicit hint; this is the
    fallback the aggregator/server charge sites use. An id without a dot
    is its own tenant (single-tenant deployments degrade to the global
    behavior: one tenant, full share)."""
    name = metric_id.split(b";", 1)[0]
    return name.split(b".", 1)[0]

# Resource kinds, matching the reference's query limit trio plus the
# datapoint budget the query engine already meters:
#   docs_matched        postings matched during index evaluation, charged
#                       BEFORE materialization (a regexp that matches the
#                       world is rejected before it allocates the world)
#   series_fetched      series ids materialized for a read
#   datapoints_decoded  decoded datapoints handed to the query layer
#   bytes_read          encoded block/buffer bytes touched by a fetch
KINDS = ("docs_matched", "series_fetched", "datapoints_decoded", "bytes_read")

_scope_metrics = ROOT.sub_scope("limits")


class ResourceExhausted(RetryableError):
    """A query/ingest limit rejected this request. Retryable: the limit
    is a per-second window or an in-flight budget, both of which clear
    on their own — clients should back off and re-attempt, not fail the
    caller outright (distinct from DeadlineExceeded, which never
    retries)."""


class Backpressure(ResourceExhausted):
    """An ingest admission gate shed this write: the bounded work queue
    is past its watermark for this priority class. Producers back off
    (the Retrier classifies it retryable) instead of retrying hot."""


@dataclasses.dataclass(frozen=True)
class LimitOptions:
    """Per-kind limit knobs. None disables that mechanism.

    per_second     sliding-window rate cap over the trailing `window_s`
    concurrent     global in-flight budget (enforcer parent limit)
    per_query      per-scope child enforcer limit (defaults to the global
                   concurrent budget when unset, i.e. one query may use
                   the whole budget if nothing else is in flight)
    tenant_fair    weighted per-tenant fair-share over the sliding
                   window (DAGOR-style): a tenant's charges are capped at
                   weight/(Σ active weights + one reserve share) of the
                   window limit, so one noisy tenant saturates its OWN
                   share and never the whole window — a quiet tenant
                   arriving mid-burst always finds budget. Charges
                   without a tenant, or marked critical, bypass the
                   tenant cap (never the global window).
    tenant_weights tenant id -> weight (unlisted tenants weigh 1.0)
    """

    per_second: Optional[float] = None
    concurrent: Optional[float] = None
    per_query: Optional[float] = None
    tenant_fair: bool = False
    tenant_weights: Optional[Tuple[Tuple[bytes, float], ...]] = None

    def weight(self, tenant: bytes) -> float:
        if self.tenant_weights:
            for t, w in self.tenant_weights:
                if t == tenant:
                    return w
        return 1.0


class SlidingWindow:
    """Bucketized trailing-window rate limit. The reference resets a
    global counter on a per-second ticker (query_limits.go started
    lookback ticker); here the trailing second is `buckets` sub-second
    buckets that expire individually, so saturation decays smoothly and
    an idle `window_s` always empties it exactly (property-tested)."""

    def __init__(self, limit: float, window_s: float = 1.0, buckets: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        if limit <= 0:
            raise ValueError(f"window limit must be positive, got {limit}")
        self.limit = limit
        self.window_s = window_s
        self._bucket_s = window_s / max(1, buckets)
        self._nbuckets = max(1, buckets)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Deque[Tuple[int, float]] = deque()  # (bucket idx, n)
        self._total = 0.0

    def _expire_locked(self, now_bucket: int):
        floor = now_bucket - self._nbuckets + 1
        while self._buckets and self._buckets[0][0] < floor:
            _, n = self._buckets.popleft()
            self._total -= n

    def try_charge(self, n: float) -> bool:
        """Admit-and-count, or refuse without counting. A refused charge
        does not consume window budget: the work was never done, so the
        next second must not inherit phantom load from rejections."""
        now_bucket = int(self._clock() / self._bucket_s)
        with self._lock:
            self._expire_locked(now_bucket)
            if self._total + n > self.limit:
                return False
            if self._buckets and self._buckets[-1][0] == now_bucket:
                idx, cur = self._buckets[-1]
                self._buckets[-1] = (idx, cur + n)
            else:
                self._buckets.append((now_bucket, float(n)))
            self._total += n
            return True

    def current(self) -> float:
        now_bucket = int(self._clock() / self._bucket_s)
        with self._lock:
            self._expire_locked(now_bucket)
            return self._total


class _Limit:
    """One resource kind: optional sliding window + optional global
    concurrent enforcer + optional per-tenant weighted fair-share over
    the window."""

    def __init__(self, kind: str, opts: LimitOptions,
                 clock: Callable[[], float]):
        self.kind = kind
        self.opts = opts
        self.window = (SlidingWindow(opts.per_second, clock=clock)
                       if opts.per_second is not None else None)
        self.enforcer = Enforcer(limit=opts.concurrent, name=kind)
        self._fair = bool(opts.tenant_fair) and self.window is not None
        self._clock = clock
        self._tenant_lock = threading.Lock()
        # tenant -> usage window (limit inf: a pure per-tenant usage
        # recorder; the SHARE check below is what rejects). Pruned of
        # idle tenants on every share computation, so it is bounded by
        # the tenants active within one trailing window.
        self._tenant_use: Dict[bytes, SlidingWindow] = {}

    def _tenant_share_locked(self, tenant: bytes) -> Tuple[float, SlidingWindow]:
        """This tenant's fair share of the window limit, DAGOR-style:
        limit * w_t / (Σ active weights + w_t + one reserve share). The
        reserve keeps a lone noisy tenant capped BELOW the full window,
        so a quiet tenant arriving mid-burst always finds budget ("its
        own share, never the whole window"). _tenant_lock held."""
        w = self.opts.weight(tenant)
        tw = self._tenant_use.get(tenant)
        if tw is None:
            tw = self._tenant_use[tenant] = SlidingWindow(
                float("inf"), clock=self._clock)
        active = 0.0
        dead = []
        for t, win in self._tenant_use.items():
            if t == tenant:
                continue
            if win.current() > 0:
                active += self.opts.weight(t)
            else:
                dead.append(t)
        for t in dead:
            del self._tenant_use[t]
        return self.window.limit * w / (active + w + 1.0), tw

    def charge_window(self, n: float, tenant: Optional[bytes] = None,
                      critical: bool = False):
        if self.window is None:
            return
        if self._fair and tenant is not None and not critical:
            # Share check, window charge, and usage recording are ONE
            # atomic step under the tenant lock: two racing charges of
            # the same tenant can't both read the pre-charge usage and
            # blow through the fair share. The global window has its own
            # inner lock; nothing ever takes the tenant lock after it,
            # so the nesting can't invert.
            with self._tenant_lock:
                share, tw = self._tenant_share_locked(tenant)
                if tw.current() + n > share:
                    _scope_metrics.counter(
                        f"{self.kind}.tenant_exceeded").inc()
                    raise ResourceExhausted(
                        f"{self.kind}: tenant {tenant!r} charge {n:g} "
                        f"would exceed its fair share {share:g} of the "
                        f"per-second limit {self.window.limit:g} "
                        f"(tenant current {tw.current():g})")
                if not self.window.try_charge(n):
                    _scope_metrics.counter(f"{self.kind}.exceeded").inc()
                    raise ResourceExhausted(
                        f"{self.kind}: {n:g} would exceed per-second "
                        f"limit {self.window.limit:g} "
                        f"(current {self.window.current():g})")
                # usage recorded only for ADMITTED work (the try_charge
                # invariant: a rejection leaves nothing charged anywhere)
                tw.try_charge(n)
            return
        if not self.window.try_charge(n):
            _scope_metrics.counter(f"{self.kind}.exceeded").inc()
            raise ResourceExhausted(
                f"{self.kind}: {n:g} would exceed per-second limit "
                f"{self.window.limit:g} (current {self.window.current():g})")

    def tenant_usage(self, tenant: bytes) -> float:
        with self._tenant_lock:
            tw = self._tenant_use.get(tenant)
        return tw.current() if tw is not None else 0.0

    def saturation(self) -> float:
        """In-flight concurrent usage as a fraction of the budget (0 when
        unlimited) — the health tracker's input signal."""
        limit = self.opts.concurrent
        if not limit:
            return 0.0
        return max(0.0, min(1.0, self.enforcer.current() / limit))


class QueryScope:
    """Per-query child enforcers chained to the registry's global
    parents (x/cost child enforcer). Context manager: entering installs
    it thread-local so storage/index charge sites inside the query
    route through it; exiting releases every child's full charge back
    up the chain (relying on Enforcer.release(None) crediting the
    parent) and restores the previous scope."""

    def __init__(self, limits: "QueryLimits", name: str,
                 tenant: Optional[bytes] = None):
        self.name = name
        self.tenant = tenant
        self._limits = limits
        # Cumulative per-kind charges for THIS scope's lifetime (the
        # enforcers only know in-flight): the span/slow-query cost
        # attribution — what did this request actually touch.
        self.totals: Dict[str, float] = {}
        self._children: Dict[str, Enforcer] = {
            kind: lim.enforcer.child(
                lim.opts.per_query
                if lim.opts.per_query is not None else lim.opts.concurrent,
                name=f"{name}.{kind}")
            for kind, lim in limits._limits.items()
        }
        self._prev = None

    def charge(self, kind: str, n: float):
        # Enforcer first (a rejected add rolls back at every level), THEN
        # the window — and an enforcer charge whose window refuses is
        # released again. Either rejection leaves NOTHING charged, so a
        # retry storm of rejected queries cannot poison the next second
        # with phantom window load (try_charge's documented invariant).
        lim = self._limits._limits[kind]
        try:
            self._children[kind].add(n)
        except CostLimitExceeded as e:
            _scope_metrics.counter(f"{kind}.exceeded").inc()
            raise ResourceExhausted(str(e)) from e
        try:
            lim.charge_window(n, tenant=self.tenant)
        except ResourceExhausted:
            self._children[kind].release(n)
            raise
        self.totals[kind] = self.totals.get(kind, 0) + n
        _scope_metrics.counter(f"{kind}.charged").inc(int(n))

    def current(self, kind: str) -> float:
        return self._children[kind].current()

    def release_all(self):
        for child in self._children.values():
            child.release(None)

    def __enter__(self) -> "QueryScope":
        self._prev = getattr(_TLS, "scope", None)
        _TLS.scope = self
        return self

    def __exit__(self, *exc):
        _TLS.scope = self._prev
        # Cost attribution on the way out: tag the active span with this
        # scope's cumulative charges (per-span docs/bytes/datapoints) and
        # stash them thread-local so the slow-query log can attribute
        # costs even for UNSAMPLED requests (outermost scope wins — it
        # exits last).
        if self.totals:
            from . import tracing

            sp = tracing.TRACER.current()
            if sp is not None:
                for kind, n in self.totals.items():
                    sp.add_cost(kind, n)
        _TLS.last_totals = self.totals
        self.release_all()
        return False


class QueryLimits:
    """Registry of per-kind limits. Default-constructed, every kind is
    unlimited (charges are no-ops beyond counters) so wiring it through
    hot paths costs nothing until a deployment configures budgets."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 **kinds: LimitOptions):
        unknown = set(kinds) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown limit kinds: {sorted(unknown)}")
        self._limits: Dict[str, _Limit] = {
            kind: _Limit(kind, kinds.get(kind, LimitOptions()), clock)
            for kind in KINDS
        }

    def charge(self, kind: str, n: float, tenant: Optional[bytes] = None,
               critical: bool = False):
        """Global (scope-less) charge: sliding window only — concurrent
        budgets need a release point, which only scopes have. With a
        `tenant` (and the kind configured tenant_fair), the charge is
        additionally capped at the tenant's weighted fair share;
        `critical` work bypasses the tenant cap (never the global
        window)."""
        self._limits[kind].charge_window(n, tenant=tenant,
                                         critical=critical)
        _scope_metrics.counter(f"{kind}.charged").inc(int(n))

    def scope(self, name: str = "query",
              tenant: Optional[bytes] = None) -> QueryScope:
        return QueryScope(self, name, tenant=tenant)

    def tenant_usage(self, kind: str, tenant: bytes) -> float:
        """This tenant's trailing-window usage for one kind (tests,
        /debug introspection)."""
        return self._limits[kind].tenant_usage(tenant)

    def enforcer(self, kind: str) -> Enforcer:
        return self._limits[kind].enforcer

    def saturation(self) -> float:
        """Max in-flight saturation across kinds — feeds HealthTracker."""
        return max(lim.saturation() for lim in self._limits.values())

    def stats(self) -> Dict[str, dict]:
        out = {}
        for kind, lim in self._limits.items():
            out[kind] = {
                "in_flight": lim.enforcer.current(),
                "concurrent_limit": lim.opts.concurrent,
                "window_current": (lim.window.current()
                                   if lim.window is not None else None),
                "per_second": lim.opts.per_second,
            }
        return out


# ------------------------------------------------- thread-local scope routing

_TLS = threading.local()
_GLOBAL = QueryLimits()
_GLOBAL_LOCK = threading.Lock()


def get_global() -> QueryLimits:
    return _GLOBAL


def set_global(limits: QueryLimits) -> QueryLimits:
    """Swap the process-global registry (service startup / tests);
    returns the previous one so tests can restore it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, limits
    return prev


def current_scope() -> Optional[QueryScope]:
    return getattr(_TLS, "scope", None)


def last_scope_totals() -> Dict[str, float]:
    """Cumulative charges of the most recently EXITED scope on this
    thread — the slow-query log's cost source (a dispatch reads it right
    after its scope closes, before any other scope runs on the thread)."""
    return getattr(_TLS, "last_totals", None) or {}


def reset_last_totals():
    """Clear this thread's last-scope totals. Dispatchers call it BEFORE
    admission/scope entry so a request shed before its scope ever runs
    (admission gate full) attributes EMPTY costs, not the previous
    request's — serving threads are reused."""
    _TLS.last_totals = None


def charge(kind: str, n: float, tenant: Optional[bytes] = None,
           critical: bool = False):
    """Charge-site entry point: the innermost thread-local QueryScope
    when one is installed (query executor / node RPC dispatch), else the
    global registry's window. Raises ResourceExhausted on rejection.
    `tenant`/`critical` feed the per-tenant fair-share cap on scope-less
    charges (a scope carries its own tenant from construction)."""
    if n <= 0:
        return
    scope = getattr(_TLS, "scope", None)
    if scope is not None:
        scope.charge(kind, n)
    else:
        _GLOBAL.charge(kind, n, tenant=tenant, critical=critical)
