"""Query-corpus recorder (port of m3_tpu/query/corpus.py, host only): an
opt-in sampler that appends one record per served query — (normalized
query SHAPE, route taken, typed fallback reason, series count, latency) —
to a bounded on-disk JSONL corpus, so the compiled-path coverage of real
traffic is measured instead of hand-picked test queries. `coverage()`
replays a corpus through the lowering and returns the coverage number +
per-reason fallback counts.

Normalization (`normalize`): the recorded shape is the query with label
matcher VALUES stripped (matcher names and operators survive — they
don't change routing; values are unbounded user data), numeric literals
canonicalized to 1 and @-timestamps to 0 (routing depends on plan
STRUCTURE, never on the literal value), and string literals emptied.
Durations (ranges, subquery resolutions, offsets) are kept — they are
part of the physical shape (W/stride geometry). A normalized shape
re-parses as valid PromQL and lowers to the same route as the original,
so a corpus replays without the original data or label values.

Versus the upstream: m3/Prometheus ship ALWAYS-ON query logging (the
dbnode query log / prom's active query log). Here recording is opt-in
(`M3_TPU_QUERY_CORPUS=<path>`), sampled (`M3_TPU_CORPUS_SAMPLE`,
default 0.01) and bounded (`M3_TPU_CORPUS_MAX` records, drops counted)
— a corpus is a measurement instrument, not an audit trail."""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

from . import promql
from .model import MatchType

_OP = {MatchType.EQUAL: "=", MatchType.NOT_EQUAL: "!=",
       MatchType.REGEXP: "=~", MatchType.NOT_REGEXP: "!~"}


def _dur(ns: int) -> str:
    """Exact-round-trip duration literal (seconds when whole, else ms;
    sub-ms remainders floor to ms — shape-preserving for any grid the
    engine serves)."""
    if ns < 0:
        return "-" + _dur(-ns)
    if ns % 1_000_000_000 == 0:
        return f"{ns // 1_000_000_000}s"
    return f"{max(ns // 1_000_000, 1)}ms"


def _at(at_ns) -> str:
    if at_ns == "start":
        return " @ start()"
    if at_ns == "end":
        return " @ end()"
    return " @ 0"  # numeric pins normalize: the timestamp is user data


def _selector(node: promql.VectorSelector) -> str:
    name = node.name.decode(errors="replace") if node.name else ""
    if node.matchers:
        body = ",".join(
            f'{m.name.decode(errors="replace")}{_OP[m.type]}""'
            for m in node.matchers)
        name += "{" + body + "}"
    elif not node.name:
        name = "{}"
    if node.range_ns:
        name += f"[{_dur(node.range_ns)}]"
    if node.offset_ns:
        name += f" offset {_dur(node.offset_ns)}"
    if node.at_ns is not None:
        name += _at(node.at_ns)
    return name


def _matching(m: Optional[promql.VectorMatching]) -> str:
    if m is None:
        return ""
    labels = ",".join(l.decode(errors="replace") for l in m.labels)
    out = f" {'on' if m.on else 'ignoring'}({labels})"
    if m.group_left or m.group_right:
        inc = ",".join(l.decode(errors="replace") for l in m.include)
        out += f" {'group_left' if m.group_left else 'group_right'}({inc})"
    return out


def _render(node: promql.Node) -> str:
    if isinstance(node, promql.NumberLiteral):
        return "1"
    if isinstance(node, promql.StringLiteral):
        return '""'
    if isinstance(node, promql.VectorSelector):
        return _selector(node)
    if isinstance(node, promql.Subquery):
        res = _dur(node.step_ns) if node.step_ns else ""
        out = f"({_render(node.expr)})[{_dur(node.range_ns)}:{res}]"
        if node.offset_ns:
            out += f" offset {_dur(node.offset_ns)}"
        if node.at_ns is not None:
            out += _at(node.at_ns)
        return out
    if isinstance(node, promql.Unary):
        return f"{node.op}({_render(node.expr)})"
    if isinstance(node, promql.Call):
        return f"{node.func}({', '.join(_render(a) for a in node.args)})"
    if isinstance(node, promql.Aggregation):
        head = node.op
        if node.grouping or node.without:
            labels = ",".join(g.decode(errors="replace")
                              for g in node.grouping)
            head += f" {'without' if node.without else 'by'} ({labels})"
        args = ([_render(node.param)] if node.param is not None else []) + \
            [_render(node.expr)]
        return f"{head} ({', '.join(args)})"
    if isinstance(node, promql.BinaryOp):
        op = node.op + (" bool" if node.bool_mode else "")
        return (f"({_render(node.lhs)}) {op}{_matching(node.matching)} "
                f"({_render(node.rhs)})")
    raise ValueError(f"unrenderable node {type(node).__name__}")


def normalize(query: str) -> str:
    """Normalized shape of one query string (see module docstring);
    raises promql.ParseError/ValueError on unparseable input — callers
    on the serving path catch and count."""
    return _render(promql.parse(query))


# ----------------------------------------------------------------- recorder


class CorpusRecorder:
    """Appends sampled query records to one JSONL file, bounded by
    `max_records` (existing lines count against the bound, so a restart
    can't grow the corpus past it; drops are counted, never silent)."""

    def __init__(self, path: str, sample: float = 1.0,
                 max_records: int = 50000):
        self.path = path
        self.sample = min(1.0, max(0.0, float(sample)))
        self.max_records = int(max_records)
        self._lock = threading.Lock()
        self._rng = random.Random()
        self.dropped = 0
        self.errors = 0
        self.written = 0
        self._count = 0
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    self._count = sum(1 for _ in f)
            except OSError:
                self.errors += 1

    def want(self) -> bool:
        """Consume one sampling draw: True when the next record should
        be written. Callers that need work BETWEEN the sampling decision
        and the append (the executor materializes the lazy result so
        recorded latency includes the d2h transfer) draw here and pass
        presampled=True to record()."""
        return self.sample >= 1.0 or self._rng.random() < self.sample

    def record(self, query: str, route: Optional[str] = None,
               reason: Optional[str] = None, series: int = 0,
               latency_ns: int = 0, step_ns: int = 0,
               presampled: bool = False) -> bool:
        if not presampled and not self.want():
            return False
        try:
            shape = normalize(query)
        except Exception:  # noqa: BLE001 — a recorder parse failure
            self.errors += 1   # must never surface on the serving path
            return False
        entry = {"shape": shape, "route": route, "reason": reason,
                 "series": int(series),
                 "latency_ms": round(latency_ns / 1e6, 3),
                 "step_ns": int(step_ns)}
        line = json.dumps(entry, sort_keys=True) + "\n"
        with self._lock:
            if self._count >= self.max_records:
                self.dropped += 1
                return False
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
            except OSError:
                self.errors += 1
                return False
            self._count += 1
            self.written += 1
        return True


# ------------------------------------------------------- process-level hook

_STATE_LOCK = threading.Lock()
_RECORDER: Optional[CorpusRecorder] = None
_RESOLVED = False


def install(recorder: Optional[CorpusRecorder]):
    """Install (or clear, with None) the process recorder explicitly —
    tests and the smoke drive use this; production opts in via env."""
    global _RECORDER, _RESOLVED
    with _STATE_LOCK:
        _RECORDER = recorder
        _RESOLVED = True


def _resolve() -> Optional[CorpusRecorder]:
    global _RECORDER, _RESOLVED
    with _STATE_LOCK:
        if not _RESOLVED:
            path = os.environ.get("M3_TPU_QUERY_CORPUS", "")
            if path:
                try:
                    sample = float(
                        os.environ.get("M3_TPU_CORPUS_SAMPLE", "0.01"))
                except ValueError:
                    sample = 0.01
                _RECORDER = CorpusRecorder(
                    path, sample=sample,
                    max_records=int(
                        os.environ.get("M3_TPU_CORPUS_MAX", "50000")))
            _RESOLVED = True
        return _RECORDER


def maybe_record(query: str, route_info: Optional[dict], result,
                 t0_ns: int, step_ns: int):
    """The executor's per-query hook: one module-global read when no
    recorder is configured (the default). For a SAMPLED query the lazy
    result materializes first, so recorded latency includes the d2h
    result transfer — without this, compiled queries (lazy fetch) would
    systematically under-report against the eagerly-evaluated
    interpreter and bias the coverage report's cost picture."""
    rec = _RECORDER
    if rec is None:
        if _RESOLVED:
            return
        rec = _resolve()
        if rec is None:
            return
    if not rec.want():
        return
    try:
        result.values  # LazyBlock caches; a plain Block is a no-op read
    except Exception:  # noqa: BLE001 — a failed late materialization
        pass               # must not kill the served response
    latency_ns = time.perf_counter_ns() - t0_ns
    route = reason = None
    if route_info:
        route = route_info.get("route")
        reason = route_info.get("fallback_reason")
    rec.record(query, route=route, reason=reason,
               series=len(result.series_tags), latency_ns=latency_ns,
               step_ns=step_ns, presampled=True)


# ----------------------------------------------------------------- coverage


def read_corpus(path: str) -> List[dict]:
    """Records from one corpus file; corrupt lines are skipped (a torn
    tail from a dying process must not void the rest)."""
    out: List[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "shape" in rec:
                out.append(rec)
    return out


def coverage(records: List[dict]) -> dict:
    """Compiled-path coverage over a recorded corpus: the RECORDED
    routes (what actually happened, below-floor included) plus a
    STRUCTURAL replay — each unique shape re-lowered through
    query/plan.py — so the report separates "not compilable" from
    "compilable but the data was too small". Recorded per-reason
    fallback counts + the compiled count always sum to the total."""
    from . import plan as qplan
    from .executor import DEFAULT_LOOKBACK_NS, QueryParams

    total = len(records)
    compiled = 0
    fallbacks: Dict[str, int] = {}
    runtime_fallbacks: Dict[str, int] = {}
    structural_compiled = 0
    structural_fallbacks: Dict[str, int] = {}
    shape_route: Dict[tuple, tuple] = {}
    for rec in records:
        if rec.get("route") == "compiled":
            compiled += 1
        else:
            reason = rec.get("reason") or "unknown"
            fallbacks[reason] = fallbacks.get(reason, 0) + 1
            # The recorded-route split telemetry carries as the `scope`
            # tag: a runtime miss (below-floor/disabled/backend-gap) is
            # not a lowering gap, so the structural replay below can
            # legitimately disagree with it on small-series corpora.
            if reason in qplan.RUNTIME_REASONS:
                runtime_fallbacks[reason] = \
                    runtime_fallbacks.get(reason, 0) + 1
        step_ns = int(rec.get("step_ns") or 30_000_000_000)
        key = (rec["shape"], step_ns)
        hit = shape_route.get(key)
        if hit is None:
            try:
                ast = promql.parse(rec["shape"])
                params = QueryParams(0, 119 * step_ns, step_ns)
                plan, err, _ = qplan.lower_and_collect(
                    ast, params, DEFAULT_LOOKBACK_NS)
                hit = ("compiled", None) if plan is not None \
                    else ("interpreter", err.reason.value)
            except Exception:  # noqa: BLE001 — an unreplayable shape
                hit = ("interpreter", "unreplayable")
            shape_route[key] = hit
        if hit[0] == "compiled":
            structural_compiled += 1
        else:
            structural_fallbacks[hit[1]] = \
                structural_fallbacks.get(hit[1], 0) + 1
    runtime_total = sum(runtime_fallbacks.values())
    return {
        "total": total,
        "shapes": len(shape_route),
        "compiled": compiled,
        "coverage": compiled / total if total else 0.0,
        "fallbacks": dict(sorted(fallbacks.items())),
        # Recorded fallbacks split by telemetry scope: runtime reasons
        # (data size / kill switches) vs structural lowering gaps.
        "runtime_fallbacks": dict(sorted(runtime_fallbacks.items())),
        "runtime_fallback_total": runtime_total,
        "structural_compiled": structural_compiled,
        "structural_coverage": structural_compiled / total if total else 0.0,
        "structural_fallbacks": dict(sorted(structural_fallbacks.items())),
    }
