"""Standing compiled rule pipelines: PromQL recording rules + alert rules
evaluated incrementally per window (reference: the rule manager the
coordinator fronts in a Prometheus deployment — rules/manager.go Group
evaluation — expressed over this repo's compiled query plane).

Recording rules compile ONCE through the plan route: every evaluation
round calls Engine.execute_range (the compiled plan by default), so after
the first round the plan cache serves a structure hit and the round
replays the captured program over the new window only (state — the last
evaluated window end and alert firing streaks — threads across rounds).
Alert rules ride the same windows as vectorized comparisons: rules
grouped per (expr, op) evaluate their PromQL ONCE and compare every rule
threshold against every series in one select, emitting typed
firing/resolved transitions on state edges.

Outputs go to a sink that receives one batch of (tags, time_nanos, value)
rows per round (`write_output`; a caller writes them into a Database, as
the reference's coordinator wires its downsampler's write_batch).

Port of m3_tpu/coordinator/rules_engine.py over any port Engine. The
compare follows the reference's precision split: at 4,096 cells or more
it runs on the engine's device in f32 (the reference's jitted compare,
without x64), below that on the host in f64."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..query.model import METRIC_NAME

_OPS = {
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


@dataclasses.dataclass(frozen=True)
class RecordingRule:
    """record: the output metric name; labels: extra tags stamped on every
    output series (rules/recording.go)."""

    record: bytes
    expr: str
    labels: Tuple[Tuple[bytes, bytes], ...] = ()


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """Fires when `expr <op> threshold` holds for `for_steps` consecutive
    evaluated steps (rules/alerting.go `for` duration, in engine steps)."""

    name: bytes
    expr: str
    op: str
    threshold: float
    for_steps: int = 1

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown alert op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class Transition:
    """One alert state edge (rules/alerting.go firing/inactive)."""

    rule: bytes
    series: bytes  # canonical Tags.id()
    kind: str  # "firing" | "resolved"
    time_nanos: int
    value: float


@dataclasses.dataclass
class RoundResult:
    steps: int
    exprs_evaluated: int
    recorded_rows: int
    transitions: List[Transition]


# The reference's jitted compare takes over at this many cells
# (values.size * thresholds.size); below it the host compares in f64.
DEVICE_COMPARE_MIN_CELLS = 4096

_TORCH_OPS = {
    ">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le,
    "==": torch.eq, "!=": torch.ne,
}


def _compile_compare(op: str, device: torch.device):
    """Vectorized threshold comparison for one (expr, op) class:
    [n_series, k] values against [n_rules] thresholds ->
    [n_rules, n_series, k] condition matrix; NaN (a missing step) never
    satisfies it. At DEVICE_COMPARE_MIN_CELLS or more, torch ops on
    `device` over f32 values and thresholds (the reference's jit compares
    in f32); below, an exact f64 host compare."""
    npop = _OPS[op]
    top = _TORCH_OPS[op]

    def _host(values, thresholds):
        cond = npop(values[None, :, :], thresholds[:, None, None])
        return np.where(np.isnan(values)[None, :, :], False, cond)

    def compare(values: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
        if values.size * thresholds.size < DEVICE_COMPARE_MIN_CELLS:
            return _host(values, thresholds)
        v = torch.from_numpy(values.astype(np.float32)).to(device)
        th = torch.from_numpy(thresholds.astype(np.float32)).to(device)
        cond = top(v[None, :, :], th[:, None, None]) & ~torch.isnan(v)[None]
        return cond.cpu().numpy()

    return compare


class RulesEngine:
    """One coordinator's standing rule set, evaluated incrementally.

    All rules share one evaluation step (rules/manager.go group interval).
    evaluate(now) advances every rule from its last evaluated window end
    to the current step boundary — each DISTINCT expr runs one
    execute_range over exactly the new steps, recording outputs sink as
    one batch, and alert streak counters update per evaluated step so a
    delayed round misses no transition. Comparisons at scale run on the
    engine's device (`engine.device`)."""

    def __init__(self, engine, write_output: Callable,
                 step_ns: int = 10_000_000_000,
                 clock: Optional[Callable[[], int]] = None,
                 max_steps_per_round: int = 64):
        import time as _time

        self._engine = engine
        self._write_output = write_output  # (rows: [(tags, t_ns, value)])
        self.step_ns = step_ns
        self._clock = clock or _time.time_ns
        self._max_steps = max_steps_per_round
        self._recording: List[RecordingRule] = []
        self._alerts: List[AlertRule] = []
        # threaded round state
        self._last_end_ns: Optional[int] = None
        self._streak: Dict[Tuple[bytes, bytes], int] = {}
        self._firing: Dict[Tuple[bytes, bytes], bool] = {}
        # per (expr, op, rules) class: (series ids, prev firing array) —
        # standing rule sets against a stable series set update state as
        # ONE array op per round, no per-(rule, series) dict traffic
        self._class_prev: Dict[tuple, tuple] = {}
        self._compare_cache: Dict[str, Callable] = {}
        self.rounds = 0
        self.transitions_emitted = 0

    # -- registration ------------------------------------------------------

    def add_recording(self, rule: RecordingRule):
        self._recording.append(rule)

    def add_alert(self, rule: AlertRule):
        self._alerts.append(rule)

    def firing(self) -> List[Tuple[bytes, bytes]]:
        """Currently-firing (rule, series) pairs."""
        return sorted(k for k, on in self._firing.items() if on)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, now_nanos: Optional[int] = None) -> RoundResult:
        now = self._clock() if now_nanos is None else now_nanos
        step = self.step_ns
        end = now // step * step
        if self._last_end_ns is None:
            start = end  # first round: just the current boundary
        else:
            start = self._last_end_ns + step
        if start > end:
            return RoundResult(0, 0, 0, [])
        # Bound catch-up after a stall: evaluate the most recent window,
        # never an unbounded backlog.
        n_steps = (end - start) // step + 1
        if n_steps > self._max_steps:
            start = end - (self._max_steps - 1) * step
            n_steps = self._max_steps
        blocks: Dict[str, object] = {}

        def block_for(expr: str):
            blk = blocks.get(expr)
            if blk is None:
                # the default plan route: the plan cache serves a
                # structure hit after round one — the standing program
                blk = blocks[expr] = self._engine.execute_range(
                    expr, start, end, step)
            return blk

        rows: List[tuple] = []
        for rule in self._recording:
            blk = block_for(rule.expr)
            self._record_rows(rule, blk, rows)
        if rows:
            self._write_output(rows)
        transitions: List[Transition] = []
        by_class: Dict[Tuple[str, str], List[AlertRule]] = {}
        for rule in self._alerts:
            by_class.setdefault((rule.expr, rule.op), []).append(rule)
        for (expr, op), rules in by_class.items():
            blk = block_for(expr)
            self._eval_alert_class(op, rules, blk, transitions)
        self._last_end_ns = end
        self.rounds += 1
        self.transitions_emitted += len(transitions)
        return RoundResult(n_steps, len(blocks), len(rows), transitions)

    def _record_rows(self, rule: RecordingRule, blk, rows: List[tuple]):
        values = np.asarray(blk.values)
        times = blk.meta.times()
        extra = dict(rule.labels)
        for si, tags in enumerate(blk.series_tags):
            out_tags = {**tags.as_dict(), **extra, METRIC_NAME: rule.record}
            row = values[si]
            for ti in np.flatnonzero(~np.isnan(row)):
                rows.append((out_tags, int(times[ti]), float(row[ti])))

    def _eval_alert_class(self, op: str, rules: Sequence[AlertRule], blk,
                          transitions: List[Transition]):
        """One vectorized compare for every rule in an (expr, op) class,
        then per-step streak updates against the threaded firing state.

        for_steps == 1 rules (the common class) stay fully columnar:
        state edges detect as one shifted-compare over the whole
        [n_rules, n_series, steps] condition matrix and Python touches
        only the (rule, series, step) cells that actually transitioned —
        a quiet round over 100k standing rules is pure array ops."""
        values = np.asarray(blk.values, dtype=np.float64)
        if values.size == 0:
            return
        compare = self._compare_cache.get(op)
        if compare is None:
            compare = self._compare_cache[op] = _compile_compare(
                op, self._engine.device)
        fast = [r for r in rules if r.for_steps == 1]
        slow = [r for r in rules if r.for_steps > 1]
        times = blk.meta.times()
        sids = [tags.id() for tags in blk.series_tags]
        if fast:
            thresholds = np.asarray([r.threshold for r in fast], np.float64)
            cond = np.asarray(compare(values, thresholds))
            self._edges_columnar(fast, sids, cond, values, times,
                                 transitions)
        if slow:
            thresholds = np.asarray([r.threshold for r in slow], np.float64)
            cond = np.asarray(compare(values, thresholds))
            self._edges_streak(slow, sids, cond, values, times, transitions)

    def _edges_columnar(self, rules, sids, cond, values, times,
                        transitions):
        key = (id(self._engine), rules[0].op,
               tuple(r.name for r in rules), rules[0].expr)
        cached = self._class_prev.get(key)
        if cached is not None and cached[0] == sids:
            prev = cached[1]
        else:
            firing = self._firing
            prev = np.asarray(
                [[firing.get((r.name, sid), False) for sid in sids]
                 for r in rules], bool)
        shifted = np.concatenate([prev[:, :, None], cond[:, :, :-1]], axis=2)
        edges = cond != shifted
        if edges.any():
            firing = self._firing
            for ri, si, ti in zip(*np.nonzero(edges)):
                on = bool(cond[ri, si, ti])
                transitions.append(Transition(
                    rules[ri].name, sids[si],
                    "firing" if on else "resolved",
                    int(times[ti]), float(values[si, ti])))
                firing[(rules[ri].name, sids[si])] = on
        self._class_prev[key] = (sids, cond[:, :, -1])

    def _edges_streak(self, rules, sids, cond, values, times, transitions):
        streak = self._streak
        firing = self._firing
        for ri, rule in enumerate(rules):
            need = rule.for_steps
            for si, sid in enumerate(sids):
                key = (rule.name, sid)
                run = streak.get(key, 0)
                on = firing.get(key, False)
                for ti in range(len(times)):
                    run = run + 1 if cond[ri, si, ti] else 0
                    now_on = run >= need
                    if now_on != on:
                        transitions.append(Transition(
                            rule.name, sid,
                            "firing" if now_on else "resolved",
                            int(times[ti]), float(values[si, ti])))
                        on = now_on
                streak[key] = run
                firing[key] = on
