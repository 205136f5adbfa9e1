"""Tracing + profiling (reference: the x/instrument + net/http/pprof
surface the reference exposes on every service — opentracing spans via
instrument.Options tracing, goroutine/profile dumps on /debug/pprof).

Spans: context-manager tree with wall-clock timings, thread-local current
span, trace/span ids, and a ring buffer of recent finished roots for
/debug/traces. Cross-process propagation rides request frames as a
compact `"tr"` context (rpc/wire.py TRACE_KEY) exactly like the deadline
`"d"` and priority `"pri"` hints; the server side opens a remote-parented
span and, on success, returns its finished tree in the response frame so
the CLIENT grafts it as a child — one request yields ONE span tree even
when its storage work ran three processes away (the in-process analog of
jaeger's collector assembling spans by trace id; DIVERGENCES.md).

Sampling: root spans are sampled at `M3_TPU_TRACE_SAMPLE` (default 1.0);
an unsampled root is the shared no-op span, children of no span are
no-ops too (`child_span`), and unsampled requests never attach a wire
context — so the hot path's cost when tracing is off is one thread-local
read (proven <3% on the write/index benches by
scripts/obs_overhead_guard.py even with tracing ON).

Slow queries: a bounded ring of {name, duration, typed reason, costs}
entries (`SLOW_QUERIES`) — reasons are `limit-shed` (ResourceExhausted),
`deadline` (DeadlineExceeded), `cold-cache` (the span's cost tags show
block/grid-cache misses), or plain `slow` past the threshold
(`M3_TPU_SLOW_QUERY_MS`, default 500).

Profiling: a sampling profiler (the statistical CPU profile analog of
/debug/pprof/profile) that samples every thread's Python stack at a fixed
interval and aggregates flattened stack counts, plus an all-threads stack
dump (the goroutine-dump analog of /debug/pprof/goroutine?debug=2).
`PROFILER` runs the sampling loop on ONE shared background thread with a
hard seconds cap (`M3_TPU_PROFILE_MAX_S`) so a /debug/pprof/profile
request can neither stall a serving thread past its deadline nor stack N
concurrent sampling loops."""

from __future__ import annotations

import collections
import contextlib
import os
import random as _random
import sys
import threading
import time
import traceback
from typing import Dict, List, NamedTuple, Optional

# ---------------------------------------------------------------- spans


class SpanContext(NamedTuple):
    """Wire-portable span identity. Only SAMPLED spans ever produce one
    (context presence implies sampled), so the two ids are the whole
    context — the compact `"tr"` frame field."""

    trace_id: int
    span_id: int

    def to_wire(self) -> dict:
        return {"t": self.trace_id, "s": self.span_id}

    @classmethod
    def from_wire(cls, d) -> Optional["SpanContext"]:
        """Parse a frame's trace field; malformed metadata is treated as
        absent — tracing must never be the thing that kills an
        otherwise-valid request (same contract as deadline_from_frame)."""
        if not isinstance(d, dict):
            return None
        t, s = d.get("t"), d.get("s")
        if isinstance(t, bool) or isinstance(s, bool) or \
                not isinstance(t, int) or not isinstance(s, int):
            return None
        return cls(t, s)


_ID_LOCK = threading.Lock()
_ID_RNG = _random.Random()


def _new_id() -> int:
    with _ID_LOCK:
        return _ID_RNG.getrandbits(63) or 1


class Span:
    __slots__ = ("name", "tags", "start_ns", "end_ns", "children", "costs",
                 "trace_id", "span_id", "remote_parent", "_tracer", "_parent")

    sampled = True  # real spans exist only when sampled

    def __init__(self, name: str, tracer: "Tracer", parent: Optional["Span"],
                 tags: Optional[dict] = None,
                 remote: Optional[SpanContext] = None):
        self.name = name
        self.tags = dict(tags or {})
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.children: List = []  # Span or grafted remote dicts
        self.costs: Dict[str, float] = {}
        if parent is not None:
            self.trace_id = parent.trace_id
        elif remote is not None:
            self.trace_id = remote.trace_id
        else:
            self.trace_id = _new_id()
        self.span_id = _new_id()
        self.remote_parent = remote.span_id if remote is not None else None
        self._tracer = tracer
        self._parent = parent

    @property
    def duration_ns(self) -> int:
        return (self.end_ns or time.perf_counter_ns()) - self.start_ns

    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def add_cost(self, kind: str, n: float = 1) -> "Span":
        """Accumulate one QueryScope-style cost tally onto this span
        (docs_matched / bytes_read / block_cache_hit / ...)."""
        self.costs[kind] = self.costs.get(kind, 0) + n
        return self

    def attach(self, child: dict):
        """Graft a REMOTE span tree (a finished to_dict from another
        process, returned in a response frame) as a child. list.append is
        GIL-atomic, so fanout worker threads may attach concurrently."""
        self.children.append(child)

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        if exc_type is not None:
            self.tags["error"] = repr(exc)
        self._tracer._pop(self)
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_us": round(self.duration_ns / 1000, 1),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            **({"remote_parent": self.remote_parent}
               if self.remote_parent is not None else {}),
            **({"tags": self.tags} if self.tags else {}),
            **({"costs": self.costs} if self.costs else {}),
            **({"children": [c if isinstance(c, dict) else c.to_dict()
                             for c in self.children]}
               if self.children else {}),
        }


class _NoopSpan:
    """Shared do-nothing span for unsampled work: every mutator is a
    no-op, so hot paths hold one object test instead of branches."""

    __slots__ = ()
    sampled = False
    name = ""
    tags: dict = {}
    costs: dict = {}
    children: tuple = ()
    trace_id = 0
    span_id = 0

    def set_tag(self, key, value):
        return self

    def add_cost(self, kind, n=1):
        return self

    def attach(self, child):
        pass

    def context(self) -> Optional[SpanContext]:
        return None

    @property
    def duration_ns(self) -> int:
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def to_dict(self) -> dict:
        return {"name": "", "noop": True}


NOOP_SPAN = _NoopSpan()


def _env_rate() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get("M3_TPU_TRACE_SAMPLE", "1"))))
    except ValueError:
        return 1.0


class Tracer:
    """Per-process tracer; thread-local span stacks, bounded root history,
    head-based root sampling."""

    def __init__(self, max_traces: int = 128,
                 sample_rate: Optional[float] = None):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._recent = collections.deque(maxlen=max_traces)
        self.sample_rate = _env_rate() if sample_rate is None else sample_rate

    def set_sample_rate(self, rate: float):
        self.sample_rate = min(1.0, max(0.0, float(rate)))

    def span(self, name: str, **tags):
        """New span: child of the current span when one is active, else a
        sampling-gated new root. Entry points (query execute, session
        calls, rpc dispatch) use this; internals use child_span."""
        parent = getattr(self._local, "current", None)
        if parent is None:
            rate = self.sample_rate
            if rate <= 0.0 or (rate < 1.0 and _random.random() >= rate):
                return NOOP_SPAN
            return Span(name, self, None, tags)
        return Span(name, self, parent, tags)

    def child_span(self, name: str, **tags):
        """A span ONLY when sampled work is already in flight — the
        hot-path-safe form for storage/index internals: with no active
        span (benchmarks, bare calls) the cost is one thread-local read."""
        parent = getattr(self._local, "current", None)
        if parent is None:
            return NOOP_SPAN
        return Span(name, self, parent, tags)

    def span_from(self, ctx: Optional[SpanContext], name: str, **tags):
        """Remote-parented root for a propagated wire context (rpc
        dispatch, msg consume, kv ops); NOOP when the request carried no
        context (the caller was unsampled or untraced)."""
        if ctx is None:
            return NOOP_SPAN
        return Span(name, self, None, tags, remote=ctx)

    def current(self) -> Optional[Span]:
        return getattr(self._local, "current", None)

    @contextlib.contextmanager
    def activate(self, span):
        """Install `span` as this THREAD's current span (restoring the
        previous on exit) without opening a new one — explicit
        propagation into pool workers, where thread-local stacks don't
        follow the submitting thread."""
        prev = getattr(self._local, "current", None)
        self._local.current = span if isinstance(span, Span) else None
        try:
            yield span
        finally:
            self._local.current = prev

    def _push(self, span: Span):
        if span._parent is not None:
            span._parent.children.append(span)
        self._local.current = span

    def _pop(self, span: Span):
        self._local.current = span._parent
        if span._parent is None:
            with self._lock:
                self._recent.append(span)

    def recent_traces(self, trace_id: Optional[int] = None) -> List[dict]:
        with self._lock:
            roots = list(self._recent)
        out = [s.to_dict() for s in roots]
        if trace_id is not None:
            out = [d for d in out if d.get("trace_id") == trace_id]
        return out


TRACER = Tracer()  # process default, like the global opentracing tracer


def span(name: str, **tags):
    return TRACER.span(name, **tags)


def child_span(name: str, **tags):
    return TRACER.child_span(name, **tags)


def count_cost(kind: str, n: float = 1):
    """Tally a cost/cache event onto the active span, if any — the
    charge-site hook block/grid caches and QueryScope exits use. One
    thread-local read when no span is active."""
    cur = getattr(TRACER._local, "current", None)
    if cur is not None:
        cur.add_cost(kind, n)


def collect_costs(span) -> Dict[str, float]:
    """Sum cost tallies over a whole span SUBTREE (local Span children
    and grafted remote dicts alike). Cache events accrue on the
    innermost span that saw them — storage.read's child, or a remote
    dbnode span grafted from the response frame — so a root-level
    consumer (the slow-query log's cold-cache classification) must roll
    the subtree up, not read the root's own costs."""
    out: Dict[str, float] = {}

    def walk(node):
        costs = node.get("costs") if isinstance(node, dict) else node.costs
        if costs:
            for k, v in costs.items():
                out[k] = out.get(k, 0) + v
        kids = (node.get("children") or ()) if isinstance(node, dict) \
            else node.children
        for c in kids:
            walk(c)

    walk(span)
    return out


# ---------------------------------------------------------- slow queries


class SlowQueryLog:
    """Bounded ring of slow/shed query records with typed reasons and
    per-query cost attribution (the dbnode slow-query-log analog).

    `limit-shed` and `deadline` entries record regardless of duration —
    they ARE the interesting events; threshold gating applies only to
    completed work ("slow" / "cold-cache")."""

    REASONS = ("limit-shed", "deadline", "cold-cache", "slow")
    _COLD_KEYS = ("block_cache_miss", "grid_cache_miss")

    def __init__(self, threshold_ms: Optional[float] = None,
                 maxlen: int = 128):
        if threshold_ms is None:
            try:
                threshold_ms = float(
                    os.environ.get("M3_TPU_SLOW_QUERY_MS", "500"))
            except ValueError:
                threshold_ms = 500.0
        self.threshold_ns = int(threshold_ms * 1e6)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=maxlen)

    def record(self, kind: str, name: str, duration_ns: int, reason: str,
               costs: Optional[dict] = None, trace_id: Optional[int] = None,
               route: Optional[dict] = None):
        entry = {
            "kind": kind,
            "name": name,
            "duration_ms": round(duration_ns / 1e6, 3),
            "reason": reason,
            "costs": dict(costs) if costs else {},
        }
        if trace_id:
            entry["trace_id"] = trace_id
        if route:
            # The executor's route record: a slow INTERPRETED query's
            # entry says WHY it missed the compiled path (typed
            # plan.FallbackReason value), not just that it was slow.
            entry["route"] = route.get("route")
            if route.get("fallback_reason"):
                entry["plan_fallback"] = route["fallback_reason"]
        with self._lock:
            self._ring.append(entry)

    def maybe(self, kind: str, name: str, duration_ns: int,
              costs=None, trace_id: Optional[int] = None,
              reason: Optional[str] = None, route: Optional[dict] = None):
        """Record when `reason` is a typed failure (always) or the
        duration crosses the threshold (reason inferred: cold-cache when
        the costs show cache misses, else slow). `costs` may be a dict
        or a zero-arg callable — callables are only evaluated once the
        entry WILL record, so hot fast queries never pay a subtree
        cost rollup."""
        if reason is None and duration_ns < self.threshold_ns:
            return
        if callable(costs):
            costs = costs()
        if reason is None:
            reason = "cold-cache" if costs and any(
                costs.get(k) for k in self._COLD_KEYS) else "slow"
        self.record(kind, name, duration_ns, reason, costs, trace_id,
                    route=route)

    def entries(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()


SLOW_QUERIES = SlowQueryLog()


# ---------------------------------------------------------------- profiling


def thread_stacks() -> str:
    """All-threads stack dump (goroutine-dump analog)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(l.rstrip("\n") for l in traceback.format_stack(frame))
    return "\n".join(out)


def profile(seconds: float = 1.0, hz: int = 100,
            top: int = 40) -> List[dict]:
    """Statistical CPU profile: sample every thread's stack at `hz` for
    `seconds`, aggregate by flattened stack. Returns the hottest stacks
    with sample counts (the /debug/pprof/profile analog; sampling has the
    same bias/overhead profile as pprof's SIGPROF sampling). BLOCKS the
    calling thread for the window — serving endpoints go through
    `PROFILER.run` instead, which runs this on one shared capped
    background thread."""
    counts: Dict[tuple, int] = collections.Counter()
    me = threading.get_ident()
    interval = 1.0 / hz
    deadline = time.perf_counter() + seconds
    total = 0
    while time.perf_counter() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            counts[tuple(reversed(stack))] += 1
            total += 1
        time.sleep(interval)
    out = []
    for stack, n in sorted(counts.items(), key=lambda kv: -kv[1])[:top]:
        out.append({"samples": n,
                    "fraction": round(n / max(total, 1), 4),
                    "stack": list(stack)})
    return out


class _ProfileJob:
    __slots__ = ("seconds", "hz", "top", "done", "result")

    def __init__(self, seconds: float, hz: int, top: int):
        self.seconds = seconds
        self.hz = hz
        self.top = top
        self.done = threading.Event()
        self.result: Optional[List[dict]] = None


class ProfileRunner:
    """Background-thread profile driver for the /debug/pprof/profile
    endpoint: the sampling loop runs on ONE daemon thread with a hard
    per-request seconds cap (`M3_TPU_PROFILE_MAX_S`, default 5), and
    concurrent requests SHARE the in-flight window instead of stacking N
    sys._current_frames() loops. The serving thread waits on the result
    with a bounded timeout, so a profile request can never stall it past
    the cap (the pre-fix tracing.profile() blocked for an arbitrary
    caller-chosen window)."""

    def __init__(self, max_seconds: Optional[float] = None):
        if max_seconds is None:
            try:
                max_seconds = float(
                    os.environ.get("M3_TPU_PROFILE_MAX_S", "5"))
            except ValueError:
                max_seconds = 5.0
        self.max_seconds = max(0.05, max_seconds)
        self._lock = threading.Lock()
        self._job: Optional[_ProfileJob] = None
        self.shared = 0  # requests that joined an in-flight window

    def _run_job(self, job: _ProfileJob):
        try:
            job.result = profile(job.seconds, job.hz, job.top)
        except Exception:  # noqa: BLE001 — a failed sample pass must
            job.result = []    # never wedge waiters past their timeout
        finally:
            job.done.set()

    def run(self, seconds: float = 1.0, hz: int = 100,
            top: int = 40) -> List[dict]:
        seconds = min(max(float(seconds), 0.05), self.max_seconds)
        with self._lock:
            job = self._job
            if job is None or job.done.is_set():
                job = self._job = _ProfileJob(seconds, hz, top)
                threading.Thread(target=self._run_job, args=(job,),
                                 name="profile-runner", daemon=True).start()
            else:
                self.shared += 1
        # Bounded wait: cap + slack. A hung sampler yields an empty
        # profile, not a hung serving thread.
        job.done.wait(timeout=self.max_seconds + 2.0)
        return job.result if job.result is not None else []


PROFILER = ProfileRunner()


# ------------------------------------------------- debug endpoint payloads
#
# ONE definition of the /debug response shapes: the coordinator HTTP API
# and the dbnode httpjson server both serve these, and two hand-rolled
# copies would drift (params, keys) the first time either grows a field.


def debug_traces_payload(trace_id: Optional[int] = None) -> dict:
    """/debug/traces body: recent span trees (optionally one trace) +
    the slow-query ring."""
    return {"traces": TRACER.recent_traces(trace_id=trace_id),
            "slow": SLOW_QUERIES.entries()}


def debug_profile_payload(seconds: float) -> dict:
    """/debug/pprof/profile body: the shared capped background sampler's
    hottest stacks, plus the cap actually applied to the request."""
    return {"profile": PROFILER.run(seconds=seconds),
            "capped_seconds": min(max(float(seconds), 0.05),
                                  PROFILER.max_seconds)}
