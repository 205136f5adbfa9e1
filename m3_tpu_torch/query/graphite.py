"""Graphite query language: expression parser + function evaluator over
blocks (reference: src/query/graphite — lexer/compiler in graphite/native,
~100 builtin functions in native/builtin_functions.go, storage adapter in
graphite/storage).

Path globs compile to per-component matchers on the __gN__ tags written by
carbon ingestion (m3_tpu_torch.metrics.carbon.path_to_tags). Series math
runs on the same dense [series x steps] blocks as PromQL; functions are a
curated core of the reference's builtins, organized for easy widening.

Counterpart of m3_tpu/query/graphite.py. The host code stays numpy, as in
the reference; the only device work is the window functions of
ops/temporal (movingMedian through quantile_over_time, the other moving*
and stdev through over_time, which runs the window kernel), on the
engine's device: the CUDA card unless the caller passes device="cpu"."""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve
from ..metrics.carbon import GRAPHITE_TAG_FMT, tags_to_path
from ..ops import temporal
from .block import Block, BlockMeta
from .executor import QueryParams
from .model import Matcher, MatchType, Tags

S = 1_000_000_000


# ---------------------------------------------------------------- parsing

_TOKEN = re.compile(r"""
    (?P<WS>\s+)
  | (?P<NUMBER>-?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)
  | (?P<STRING>"[^"]*"|'[^']*')
  | (?P<NAME>[a-zA-Z_][a-zA-Z0-9_]*(?=\s*\())
  | (?P<PATH>(?:[a-zA-Z0-9_*?.:\[\]\-$%+]|\{[^}]*\})+)
  | (?P<LPAREN>\()|(?P<RPAREN>\))|(?P<COMMA>,)
""", re.VERBOSE)


class GraphiteParseError(ValueError):
    pass


def _lex(s: str):
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m:
            raise GraphiteParseError(f"bad character {s[i]!r} at {i}")
        if m.lastgroup != "WS":
            out.append((m.lastgroup, m.group()))
        i = m.end()
    out.append(("EOF", ""))
    return out


class _Expr:
    pass


class PathExpr(_Expr):
    def __init__(self, path: str):
        self.path = path


class CallExpr(_Expr):
    def __init__(self, func: str, args: List):
        self.func = func
        self.args = args


class Literal(_Expr):
    def __init__(self, value):
        self.value = value


def parse_target(s: str) -> _Expr:
    """graphite/native/compiler.go: one render target expression."""
    toks = _lex(s)
    pos = [0]

    def peek():
        return toks[pos[0]]

    def nxt():
        t = toks[pos[0]]
        pos[0] += 1
        return t

    def expr():
        kind, text = peek()
        if kind == "NAME":
            nxt()
            if nxt()[0] != "LPAREN":
                raise GraphiteParseError("expected (")
            args = []
            while peek()[0] != "RPAREN":
                args.append(expr())
                if peek()[0] == "COMMA":
                    nxt()
            nxt()
            return CallExpr(text, args)
        if kind == "NUMBER":
            nxt()
            return Literal(float(text))
        if kind == "STRING":
            nxt()
            return Literal(text[1:-1])
        if kind == "PATH":
            nxt()
            # bare boolean literals (compiler.go: true/false args, e.g.
            # summarize(..., alignToFrom))
            if text in ("true", "True"):
                return Literal(True)
            if text in ("false", "False"):
                return Literal(False)
            return PathExpr(text)
        raise GraphiteParseError(f"unexpected {text!r}")

    node = expr()
    if peek()[0] != "EOF":
        raise GraphiteParseError(f"trailing input {peek()[1]!r}")
    return node


def path_to_matchers(path: str) -> Tuple[Matcher, ...]:
    """Glob path -> per-component __gN__ matchers (graphite/storage/
    converter.go equivalent): literal components match exactly, glob
    components compile to regexes."""
    out = []
    parts = path.split(".")
    for i, part in enumerate(parts):
        name = GRAPHITE_TAG_FMT % i
        if any(c in part for c in "*?{["):
            out.append(Matcher(MatchType.REGEXP, name, _glob_regex(part).encode()))
        else:
            out.append(Matcher(MatchType.EQUAL, name, part.encode()))
    # Exact depth: the next component must not exist.
    out.append(Matcher(MatchType.NOT_REGEXP, GRAPHITE_TAG_FMT % len(parts),
                       b".+"))
    return tuple(out)


def _glob_regex(part: str) -> str:
    out = []
    i = 0
    while i < len(part):
        c = part[i]
        if c == "*":
            out.append("[^.]*")
        elif c == "?":
            out.append("[^.]")
        elif c == "{":
            j = part.find("}", i)
            if j < 0:
                raise GraphiteParseError(f"unterminated {{ in {part!r}")
            alts = part[i + 1:j].split(",")
            out.append("(?:" + "|".join(re.escape(a) for a in alts) + ")")
            i = j
        elif c == "[":
            j = part.find("]", i)
            out.append(part[i:j + 1])
            i = j
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


# ---------------------------------------------------------------- engine

class GraphiteEngine:
    """Evaluate render targets (graphite/native/engine.go).

    device: where the window functions run; None (the default) is the CUDA
    card and raises without one, "cpu" runs their plain versions."""

    def __init__(self, storage, step_ns: int = 10 * S, device=None):
        self.storage = storage
        self.step_ns = step_ns
        self.device = resolve(device)

    def render(self, target: str, start_ns: int, end_ns: int,
               step_ns: Optional[int] = None) -> Block:
        params = QueryParams(start_ns, end_ns, step_ns or self.step_ns)
        return self._eval(parse_target(target), params)

    # -- evaluation -------------------------------------------------------

    def _eval(self, node: _Expr, params: QueryParams) -> Block:
        if isinstance(node, PathExpr):
            return self._fetch(node.path, params)
        if isinstance(node, CallExpr):
            fn = _FUNCTIONS.get(node.func)
            if fn is None:
                raise GraphiteParseError(f"unknown function {node.func!r}")
            return fn(self, node.args, params)
        raise GraphiteParseError("bare literal is not a series")

    def _eval_arg(self, node, params):
        if isinstance(node, Literal):
            return node.value
        return self._eval(node, params)

    def _fetch(self, path: str, params: QueryParams) -> Block:
        from .block import consolidate

        series = self.storage.fetch_raw(
            path_to_matchers(path), params.start_ns - params.step_ns,
            params.end_ns + 1)
        meta = params.meta()
        tags_list, rows = [], []
        for sid, entry in sorted(series.items()):
            tags_list.append(Tags.of(dict(entry["tags"])))
            rows.append(consolidate(
                np.asarray(entry["t"], np.int64), np.asarray(entry["v"]),
                meta, params.step_ns))
        vals = np.stack(rows) if rows else np.zeros((0, meta.steps))
        return Block(meta, tags_list, vals)


def series_name(tags: Tags) -> bytes:
    """Render name for output: the dotted path (or the alias tag)."""
    alias = tags.get(b"__alias__")
    if alias is not None:
        return alias
    return tags_to_path(tags.as_dict())


# ---------------------------------------------------------------- functions

_FUNCTIONS: Dict[str, Callable] = {}


def _register(*names):
    def deco(fn):
        for n in names:
            _FUNCTIONS[n] = fn
        return fn

    return deco


def _combine(eng, args, params, reducer, name):
    blocks = [eng._eval(a, params) for a in args]
    vals = np.concatenate([b.values for b in blocks]) if blocks else \
        np.zeros((0, params.steps))
    meta = blocks[0].meta if blocks else params.meta()
    with np.errstate(invalid="ignore"):
        row = reducer(vals)
    # Columns where every input is missing stay missing (graphite's safe*
    # combiners return None there; np.nansum/nanprod would fabricate 0/1).
    if vals.shape[0]:
        row = np.where(np.isfinite(vals).any(axis=0), row, np.nan)
    tags = Tags.of({b"__alias__": name.encode()})
    return Block(meta, [tags], row[None, :])


@_register("sumSeries", "sum")
def _sum_series(eng, args, params):
    return _combine(eng, args, params, lambda v: np.nansum(v, axis=0),
                    "sumSeries")


@_register("averageSeries", "avg")
def _avg_series(eng, args, params):
    return _combine(eng, args, params, lambda v: np.nanmean(v, axis=0),
                    "averageSeries")


@_register("maxSeries")
def _max_series(eng, args, params):
    return _combine(eng, args, params, lambda v: np.nanmax(v, axis=0), "maxSeries")


@_register("minSeries")
def _min_series(eng, args, params):
    return _combine(eng, args, params, lambda v: np.nanmin(v, axis=0), "minSeries")


@_register("scale")
def _scale(eng, args, params):
    block = eng._eval(args[0], params)
    factor = args[1].value
    return block.with_values(block.values * factor)


@_register("offset")
def _offset(eng, args, params):
    block = eng._eval(args[0], params)
    return block.with_values(block.values + args[1].value)


@_register("absolute")
def _absolute(eng, args, params):
    block = eng._eval(args[0], params)
    return block.with_values(np.abs(block.values))


@_register("alias")
def _alias(eng, args, params):
    block = eng._eval(args[0], params)
    name = args[1].value.encode()
    return block.with_values(
        block.values, [t.with_tag(b"__alias__", name) for t in block.series_tags])


@_register("aliasByNode")
def _alias_by_node(eng, args, params):
    block = eng._eval(args[0], params)
    nodes = [int(a.value) for a in args[1:]]
    tags = []
    for t in block.series_tags:
        parts = tags_to_path(t.as_dict()).split(b".")
        picked = b".".join(parts[n] for n in nodes if -len(parts) <= n < len(parts))
        tags.append(t.with_tag(b"__alias__", picked))
    return block.with_values(block.values, tags)


@_register("derivative")
def _derivative(eng, args, params):
    block = eng._eval(args[0], params)
    v = block.values
    out = np.full_like(v, np.nan)
    out[:, 1:] = v[:, 1:] - v[:, :-1]
    return block.with_values(out)


@_register("perSecond")
def _per_second(eng, args, params):
    block = eng._eval(args[0], params)
    v = block.values
    d = np.full_like(v, np.nan)
    d[:, 1:] = (v[:, 1:] - v[:, :-1]) / (params.step_ns / S)
    d[d < 0] = np.nan  # counter wrap guard (builtin_functions.go perSecond)
    return block.with_values(d)


@_register("nonNegativeDerivative")
def _non_negative_derivative(eng, args, params):
    block = eng._eval(args[0], params)
    v = block.values
    d = np.full_like(v, np.nan)
    d[:, 1:] = v[:, 1:] - v[:, :-1]
    d[d < 0] = np.nan
    return block.with_values(d)


@_register("movingAverage")
def _moving_average(eng, args, params):
    # Shares _moving's lookback-exclusive window (the reference's
    # movingAverage walks the W points BEFORE each output step,
    # builtin_functions.go:620-666), reduced via the batched temporal
    # kernel.
    return _moving(eng, args, params, "avg")


@_register("keepLastValue")
def _keep_last_value(eng, args, params):
    block = eng._eval(args[0], params)
    v = block.values.copy()
    for row in v:
        finite = np.isfinite(row)
        if not finite.any():
            continue
        idx = np.where(finite, np.arange(row.size), -1)
        run = np.maximum.accumulate(idx)
        valid = run >= 0
        row[valid] = row[run[valid]]
    return block.with_values(v)


@_register("sortByName")
def _sort_by_name(eng, args, params):
    block = eng._eval(args[0], params)
    order = np.argsort([series_name(t) for t in block.series_tags], kind="stable")
    return block.with_values(block.values[order],
                             [block.series_tags[i] for i in order])


@_register("limit")
def _limit(eng, args, params):
    block = eng._eval(args[0], params)
    n = int(args[1].value)
    return block.with_values(block.values[:n], block.series_tags[:n])


@_register("exclude")
def _exclude(eng, args, params):
    block = eng._eval(args[0], params)
    pat = re.compile(args[1].value.encode())
    keep = [i for i, t in enumerate(block.series_tags)
            if not pat.search(series_name(t))]
    return block.with_values(block.values[keep],
                             [block.series_tags[i] for i in keep])


@_register("grep")
def _grep(eng, args, params):
    block = eng._eval(args[0], params)
    pat = re.compile(args[1].value.encode())
    keep = [i for i, t in enumerate(block.series_tags)
            if pat.search(series_name(t))]
    return block.with_values(block.values[keep],
                             [block.series_tags[i] for i in keep])


@_register("highestCurrent")
def _highest_current(eng, args, params):
    return _top_by(eng, args, params, "current", highest=True)


@_register("averageAbove")
def _average_above(eng, args, params):
    return _filter_by(eng, args, params, "average", lambda s, t: s > t)


_GROUP_REDUCERS = {
    "sum": np.nansum, "avg": np.nanmean, "average": np.nanmean,
    "max": np.nanmax, "min": np.nanmin,
    "median": lambda v, axis: np.nanmedian(v, axis=axis),
}


def _grouped_reduce(block: Block, key_fn, agg: str) -> Block:
    """Group series by key_fn(series name parts) and reduce each group;
    shared by groupByNode/groupByNodes/*SeriesWithWildcards."""
    reducer = _GROUP_REDUCERS.get(agg)
    if reducer is None:
        raise GraphiteParseError(f"unknown aggregator {agg!r}")
    groups: Dict[bytes, List[int]] = {}
    for i, t in enumerate(block.series_tags):
        groups.setdefault(key_fn(series_name(t).split(b".")), []).append(i)
    tags_out, rows = [], []
    for key, idxs in sorted(groups.items()):
        sub = block.values[idxs]
        with np.errstate(invalid="ignore"):
            row = reducer(sub, axis=0)
        row = np.where(np.isfinite(sub).any(axis=0), row, np.nan)
        rows.append(row)
        tags_out.append(Tags.of({b"__alias__": key}))
    vals = np.stack(rows) if rows else np.zeros((0, block.meta.steps))
    return Block(block.meta, tags_out, vals)


@_register("groupByNode")
def _group_by_node(eng, args, params):
    block = eng._eval(args[0], params)
    node = int(args[1].value)
    agg = args[2].value if len(args) > 2 else "sum"
    key = lambda parts: (parts[node]
                         if -len(parts) <= node < len(parts) else b"")
    return _grouped_reduce(block, key, agg)


@_register("summarize")
def _summarize(eng, args, params):
    """Reference semantics (native/summarize.go): by default buckets are
    aligned to EPOCH multiples of the interval — the output grid starts
    at floor(start, interval) and runs through newEnd = floor(end,
    interval) + interval, where end is the series' EXCLUSIVE end time
    (summarizeTimeSeries sizes NumSteps from newEnd, so an end already
    on an interval boundary gains one trailing empty bucket) — and each
    point lands in the bucket floor(ts, interval). With alignToFrom=true
    buckets count from the series start and NumSteps is
    ceil((end-start)/interval). Empty buckets emit NaN."""
    from .promql import parse_duration_ns

    # Argument validation FIRST: an invalid interval/func must reject
    # before paying the (potentially wide) series fetch.
    bucket_ns = parse_duration_ns(args[1].value)
    agg = (args[2].value or "sum") if len(args) > 2 else "sum"
    align_to_from = _bool_arg(args[3].value) if len(args) > 3 else False
    if bucket_ns <= 0:
        raise GraphiteParseError(f"invalid summarize interval {args[1].value!r}")
    reducers = {"sum": np.nansum, "avg": np.nanmean, "max": np.nanmax,
                "min": np.nanmin, "last": None}  # last: per-row gather below
    if agg not in reducers:
        raise GraphiteParseError(f"invalid summarize func {agg!r}")
    reduce = reducers[agg]
    block = eng._eval(args[0], params)
    times = block.meta.times()
    start = block.meta.start_ns
    if align_to_from:
        new_start = start
        bucket_of = (times - start) // bucket_ns
    else:
        new_start = start - start % bucket_ns
        bucket_of = (times - new_start) // bucket_ns
    # Grid sizing from the block's EXCLUSIVE end (start + steps*step),
    # matching summarize.go's newEnd/NumSteps — never from the last data
    # timestamp, which silently drops the reference's trailing bucket
    # whenever the query end extends past the last gridded point.
    end = start + block.meta.steps * block.meta.step_ns
    if align_to_from:
        steps = max(1, int(-(-(end - new_start) // bucket_ns)))  # ceil
    else:
        steps = int(((end // bucket_ns) * bucket_ns + bucket_ns
                     - new_start) // bucket_ns)
    # Dashboard-typical fast path: the interval divides the step grid
    # and the epoch-aligned start lands ON the grid, so every bucket has
    # the same width — one reshape + one masked reduce, no Python loop.
    # (bucket_ns > 0 was enforced above, so divisibility implies
    # factor >= 1.) `data_steps` buckets hold data; the epoch-aligned
    # path then carries `steps - data_steps` (0 or 1) trailing NaN
    # buckets from the newEnd sizing above.
    factor = bucket_ns // block.meta.step_ns
    data_steps = times.size // factor if factor else 0
    if (agg != "last" and bucket_ns % block.meta.step_ns == 0
            and (start - new_start) % bucket_ns == 0
            and times.size == data_steps * factor
            and times.size > 0
            and steps in (data_steps, data_steps + 1)):
        v = block.values.reshape(block.n_series, data_steps, factor)
        # NaN is the ONLY missing marker — inf is a real sample and must
        # propagate through every aggregate exactly as in the general
        # path (graphite None vs a value).
        present = ~np.isnan(v)
        have = present.any(axis=2)
        # Identity-filled reduces (never the warning-prone all-NaN
        # nan-reducers): sum/avg from masked sums, min/max from
        # +/-inf fills; `have` masks empty buckets to NaN either way.
        if agg == "sum":
            red = np.where(present, v, 0.0).sum(axis=2)
        elif agg == "avg":
            red = (np.where(present, v, 0.0).sum(axis=2)
                   / np.maximum(present.sum(axis=2), 1))
        elif agg == "max":
            red = np.where(present, v, -np.inf).max(axis=2)
        else:  # min
            red = np.where(present, v, np.inf).min(axis=2)
        out = np.where(have, red, np.nan)
        if steps > data_steps:
            out = np.concatenate(
                [out, np.full((block.n_series, steps - data_steps), np.nan)],
                axis=1)
        return Block(BlockMeta(int(new_start), bucket_ns, steps),
                     block.series_tags, out)
    out = np.full((block.n_series, steps), np.nan)
    # General path: the time grid is regular, so each bucket's columns
    # are one CONTIGUOUS slice: one searchsorted gives every boundary,
    # and each bucket reduces as a whole [n_series, width] tile (no
    # per-series Python loop).
    bounds = np.searchsorted(bucket_of, np.arange(steps + 1))
    with np.errstate(invalid="ignore"):
        for b in range(steps):
            lo, hi = bounds[b], bounds[b + 1]
            if lo == hi:
                continue
            seg = block.values[:, lo:hi]
            present = ~np.isnan(seg)  # inf is a real sample, NaN missing
            have = present.any(axis=1)
            if agg == "last":
                idx = np.where(present, np.arange(hi - lo), -1).max(axis=1)
                vals = seg[np.arange(seg.shape[0]), np.maximum(idx, 0)]
                out[:, b] = np.where(have, vals, np.nan)
            else:
                # reduce only the rows with data: the nan-reducers warn
                # on all-NaN rows, and `have` masks them anyway
                out[have, b] = reduce(seg[have], axis=1)
    meta = BlockMeta(int(new_start), bucket_ns, steps)
    return Block(meta, block.series_tags, out)


# ------------------------------------------------------- function appendix
# Broader builtin coverage (reference:
# src/query/graphite/native/builtin_functions.go). Helpers keep the whole
# block batched: every transform is a vectorized [n_series, steps] op.


def _pick_rows(block: Block, keep) -> Block:
    keep = list(keep)
    vals = block.values[keep] if len(keep) else np.zeros((0, block.meta.steps))
    return block.with_values(vals, [block.series_tags[i] for i in keep])


def _series_stat(block: Block, stat: str) -> np.ndarray:
    """Per-series scalar used by filters/sorts; NaN-aware."""
    v = block.values
    with np.errstate(invalid="ignore", divide="ignore"):
        if stat == "average":
            return np.nanmean(v, axis=1) if v.size else np.zeros(0)
        if stat == "total":
            return np.nansum(v, axis=1) if v.size else np.zeros(0)
        if stat == "max":
            return np.nanmax(v, axis=1) if v.size else np.zeros(0)
        if stat == "min":
            return np.nanmin(v, axis=1) if v.size else np.zeros(0)
        if stat == "current":
            cur = np.full(v.shape[0], np.nan)
            for i in range(v.shape[0]):
                finite = np.flatnonzero(np.isfinite(v[i]))
                if finite.size:
                    cur[i] = v[i][finite[-1]]
            return cur
    raise GraphiteParseError(f"unknown series stat {stat!r}")


def _filter_by(eng, args, params, stat, op, default_thresh=None):
    block = eng._eval(args[0], params)
    thresh = args[1].value if len(args) > 1 else default_thresh
    s = _series_stat(block, stat)
    with np.errstate(invalid="ignore"):
        keep = np.flatnonzero(op(s, thresh))
    return _pick_rows(block, keep)


def _top_by(eng, args, params, stat, highest: bool):
    block = eng._eval(args[0], params)
    n = int(args[1].value) if len(args) > 1 else 1
    s = _series_stat(block, stat)
    s = np.where(np.isfinite(s), s, -np.inf if highest else np.inf)
    order = np.argsort(-s if highest else s, kind="stable")[:n]
    return _pick_rows(block, order)


@_register("aliasSub")
def _alias_sub(eng, args, params):
    block = eng._eval(args[0], params)
    pat = re.compile(args[1].value.encode())
    repl = args[2].value.encode()
    tags = [t.with_tag(b"__alias__", pat.sub(repl, series_name(t)))
            for t in block.series_tags]
    return block.with_values(block.values, tags)


@_register("aliasByMetric")
def _alias_by_metric(eng, args, params):
    block = eng._eval(args[0], params)
    tags = [t.with_tag(b"__alias__",
                       series_name(t).split(b".")[-1].split(b",")[0])
            for t in block.series_tags]
    return block.with_values(block.values, tags)


@_register("substr")
def _substr(eng, args, params):
    block = eng._eval(args[0], params)
    start = int(args[1].value) if len(args) > 1 else 0
    stop = int(args[2].value) if len(args) > 2 else 0
    tags = []
    for t in block.series_tags:
        parts = series_name(t).split(b".")
        picked = parts[start: stop if stop else len(parts)]
        tags.append(t.with_tag(b"__alias__", b".".join(picked)))
    return block.with_values(block.values, tags)


@_register("scaleToSeconds")
def _scale_to_seconds(eng, args, params):
    block = eng._eval(args[0], params)
    seconds = args[1].value
    return block.with_values(block.values * (seconds / (params.step_ns / S)))


@_register("invert")
def _invert(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(block.values != 0, 1.0 / block.values, np.nan)
    return block.with_values(v)


@_register("logarithm", "log")
def _logarithm(eng, args, params):
    block = eng._eval(args[0], params)
    base = args[1].value if len(args) > 1 else 10
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(block.values > 0,
                     np.log(block.values) / np.log(base), np.nan)
    return block.with_values(v)


@_register("pow")
def _pow(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(invalid="ignore"):
        return block.with_values(np.power(block.values, args[1].value))


@_register("squareRoot")
def _square_root(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(invalid="ignore"):
        v = np.where(block.values >= 0, np.sqrt(block.values), np.nan)
    return block.with_values(v)


@_register("timeShift")
def _time_shift(eng, args, params):
    """Render data from `shift` ago at the requested timestamps
    (builtin_functions.go timeShift: positive shifts look back)."""
    from .promql import parse_duration_ns

    spec = str(args[1].value)
    sign = -1
    if spec.startswith("+"):
        sign, spec = 1, spec[1:]
    elif spec.startswith("-"):
        spec = spec[1:]
    delta = sign * parse_duration_ns(spec)
    shifted = QueryParams(params.start_ns + delta, params.end_ns + delta,
                          params.step_ns)
    block = eng._eval(args[0], shifted)
    return Block(params.meta(), block.series_tags, block.values)


@_register("timeSlice")
def _time_slice(eng, args, params):
    block = eng._eval(args[0], params)
    t0 = _parse_graphite_time(args[1].value, params.start_ns)
    t1 = (_parse_graphite_time(args[2].value, params.end_ns)
          if len(args) > 2 else params.end_ns)
    times = block.meta.times()
    # end-INCLUSIVE per graphite-web timeSlice (points outside
    # [start, end] become None; the boundary point survives)
    keep = ((times >= t0) & (times <= t1))[None, :]
    return block.with_values(np.where(keep, block.values, np.nan))


def _parse_graphite_time(spec, default_ns):
    from .promql import parse_duration_ns

    if isinstance(spec, (int, float)):
        return int(spec * S)
    s = str(spec)
    if s in ("now", ""):
        return default_ns
    if s.startswith("-"):
        return default_ns - parse_duration_ns(s[1:])
    return int(float(s) * S)


@_register("transformNull")
def _transform_null(eng, args, params):
    block = eng._eval(args[0], params)
    default = args[1].value if len(args) > 1 else 0.0
    return block.with_values(
        np.where(np.isfinite(block.values), block.values, default))


@_register("isNonNull")
def _is_non_null(eng, args, params):
    block = eng._eval(args[0], params)
    return block.with_values(np.isfinite(block.values).astype(np.float64))


@_register("removeAboveValue")
def _remove_above_value(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(invalid="ignore"):
        v = np.where(block.values > args[1].value, np.nan, block.values)
    return block.with_values(v)


@_register("removeBelowValue")
def _remove_below_value(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(invalid="ignore"):
        v = np.where(block.values < args[1].value, np.nan, block.values)
    return block.with_values(v)


def _get_percentile(finite: np.ndarray, p: float,
                    interpolate: bool = False) -> float:
    """The reference's rank-based percentile, NOT numpy's linear default
    (common/percentiles.go:75 GetPercentile): rank = ceil(p/100 * n),
    value = sorted[rank-1]; with interpolate, blend with sorted[rank-2]
    by the fractional rank. NB: the reference's formula multiplies by
    len(series) — not graphite-web's (len+1) — and interpolates BACKWARD
    (percentiles.go:82-97); M3 is the conformance target, verbatim."""
    s = np.sort(finite)
    n = s.size
    if n == 0:
        return np.nan
    frac = (p / 100.0) * n
    rank = int(np.ceil(frac))
    if rank <= 1:
        return float(s[0])
    rank = min(rank, n)
    out = float(s[rank - 1])
    if interpolate:
        prev = float(s[rank - 2])
        out = prev + (frac - (rank - 1)) * (out - prev)
    return out


def _bool_arg(v) -> bool:
    """Boolean function argument: bare true/false parse as literals, but
    real clients also send the QUOTED strings "true"/"false" — Python
    truthiness would read "false" as True and silently flip the option.
    Anything else ("1", a typo) is a hard error, not a silent False."""
    if isinstance(v, str):
        s = v.strip().lower()
        if s == "true":
            return True
        if s == "false":
            return False
        raise GraphiteParseError(f"invalid boolean argument {v!r}")
    return bool(v)


def _row_percentile(v: np.ndarray, n: float,
                    interpolate: bool = False) -> np.ndarray:
    out = np.full(v.shape[0], np.nan)
    for i in range(v.shape[0]):
        finite = v[i][np.isfinite(v[i])]
        if finite.size:
            out[i] = _get_percentile(finite, n, interpolate)
    return out


@_register("removeAbovePercentile")
def _remove_above_percentile(eng, args, params):
    block = eng._eval(args[0], params)
    p = _row_percentile(block.values, args[1].value)
    with np.errstate(invalid="ignore"):
        v = np.where(block.values > p[:, None], np.nan, block.values)
    return block.with_values(v)


@_register("removeBelowPercentile")
def _remove_below_percentile(eng, args, params):
    block = eng._eval(args[0], params)
    p = _row_percentile(block.values, args[1].value)
    with np.errstate(invalid="ignore"):
        v = np.where(block.values < p[:, None], np.nan, block.values)
    return block.with_values(v)


@_register("integral")
def _integral(eng, args, params):
    block = eng._eval(args[0], params)
    v = np.where(np.isfinite(block.values), block.values, 0.0)
    out = np.cumsum(v, axis=1)
    out[~np.isfinite(block.values)] = np.nan
    return block.with_values(out)


@_register("offsetToZero")
def _offset_to_zero(eng, args, params):
    block = eng._eval(args[0], params)
    with np.errstate(invalid="ignore"):
        mn = np.nanmin(block.values, axis=1, keepdims=True) \
            if block.values.size else np.zeros((0, 1))
    return block.with_values(block.values - mn)


@_register("changed")
def _changed(eng, args, params):
    """1 where the value differs from the previous REAL value; gaps emit
    0 and do not count as changes (graphite-web changed())."""
    block = eng._eval(args[0], params)
    v = block.values
    out = np.zeros_like(v)
    idx = np.arange(v.shape[1])
    for i in range(v.shape[0]):
        finite = np.isfinite(v[i])
        run = np.maximum.accumulate(np.where(finite, idx, -1))
        prev_run = np.concatenate([[-1], run[:-1]])
        cmp_ok = finite & (prev_run >= 0)
        prev_vals = v[i][np.maximum(prev_run, 0)]
        out[i] = np.where(cmp_ok & (v[i] != prev_vals), 1.0, 0.0)
    return block.with_values(out)


@_register("delay")
def _delay(eng, args, params):
    block = eng._eval(args[0], params)
    steps = int(args[1].value)
    v = np.full_like(block.values, np.nan)
    if steps >= 0:
        if steps < v.shape[1]:
            v[:, steps:] = block.values[:, : v.shape[1] - steps]
    else:
        if -steps < v.shape[1]:
            v[:, :steps] = block.values[:, -steps:]
    return block.with_values(v)


@_register("minimumAbove")
def _minimum_above(eng, args, params):
    return _filter_by(eng, args, params, "min", lambda s, t: s > t)


@_register("minimumBelow")
def _minimum_below(eng, args, params):
    return _filter_by(eng, args, params, "min", lambda s, t: s <= t)


@_register("maximumAbove")
def _maximum_above(eng, args, params):
    return _filter_by(eng, args, params, "max", lambda s, t: s > t)


@_register("maximumBelow")
def _maximum_below(eng, args, params):
    return _filter_by(eng, args, params, "max", lambda s, t: s <= t)


@_register("currentAbove")
def _current_above(eng, args, params):
    return _filter_by(eng, args, params, "current", lambda s, t: s > t)


@_register("currentBelow")
def _current_below(eng, args, params):
    return _filter_by(eng, args, params, "current", lambda s, t: s <= t)


@_register("averageBelow")
def _average_below(eng, args, params):
    return _filter_by(eng, args, params, "average", lambda s, t: s <= t)


@_register("highestAverage")
def _highest_average(eng, args, params):
    return _top_by(eng, args, params, "average", highest=True)


@_register("lowestAverage")
def _lowest_average(eng, args, params):
    return _top_by(eng, args, params, "average", highest=False)


@_register("highestMax")
def _highest_max(eng, args, params):
    return _top_by(eng, args, params, "max", highest=True)


@_register("lowestCurrent")
def _lowest_current(eng, args, params):
    return _top_by(eng, args, params, "current", highest=False)


@_register("sortByTotal")
def _sort_by_total(eng, args, params):
    block = eng._eval(args[0], params)
    s = _series_stat(block, "total")
    return _pick_rows(block, np.argsort(-np.nan_to_num(s), kind="stable"))


@_register("sortByMaxima")
def _sort_by_maxima(eng, args, params):
    block = eng._eval(args[0], params)
    s = _series_stat(block, "max")
    return _pick_rows(block, np.argsort(-np.nan_to_num(s, nan=-np.inf),
                                        kind="stable"))


@_register("sortByMinima")
def _sort_by_minima(eng, args, params):
    block = eng._eval(args[0], params)
    s = _series_stat(block, "min")
    return _pick_rows(block, np.argsort(np.nan_to_num(s, nan=np.inf),
                                        kind="stable"))


@_register("nPercentile")
def _n_percentile(eng, args, params):
    """Per-series flat line at that series' n-th percentile."""
    block = eng._eval(args[0], params)
    p = _row_percentile(block.values, args[1].value)
    return block.with_values(np.broadcast_to(
        p[:, None], block.values.shape).copy())


@_register("percentileOfSeries")
def _percentile_of_series(eng, args, params):
    block = eng._eval(args[0], params)
    n = args[1].value
    interpolate = _bool_arg(args[2].value) if len(args) > 2 else False
    out = np.full(block.meta.steps, np.nan)
    v = block.values
    for j in range(v.shape[1]):
        finite = v[:, j][np.isfinite(v[:, j])]
        if finite.size:
            out[j] = _get_percentile(finite, n, interpolate)
    tags = Tags.of({b"__alias__": b"percentileOfSeries"})
    return Block(block.meta, [tags], out[None, :])


def _window_steps(w, params) -> int:
    """Window argument (duration string or point count) -> grid steps;
    shared by the moving* family and stdev."""
    if isinstance(w, str):
        from .promql import parse_duration_ns

        return max(1, parse_duration_ns(w) // params.step_ns)
    return max(1, int(w))


def _moving(eng, args, params, kind):
    """moving* window semantics per the reference: output step i reduces
    the W points STRICTLY BEFORE it (builtin_functions.go:620-666
    movingAverage walks bootstrap[i+offset-W .. i+offset-1], i.e. the
    lookback window EXCLUDES the current point; movingMedian likewise).
    So the selector extends W steps back and the trailing-inclusive
    window reduce drops its last column (the window ending AT the
    current step)."""
    W = _window_steps(args[1].value, params)
    ext = QueryParams(params.start_ns - W * params.step_ns,
                      params.end_ns, params.step_ns)
    block = eng._eval(args[0], ext)
    if kind == "median":
        out = temporal.quantile_over_time(block.values, W, 0.5,
                                          device=eng.device)
    else:
        out = temporal.over_time(block.values, W, kind, device=eng.device)
    return Block(params.meta(), block.series_tags, out[:, :-1])


@_register("movingMax")
def _moving_max(eng, args, params):
    return _moving(eng, args, params, "max")


@_register("movingMin")
def _moving_min(eng, args, params):
    return _moving(eng, args, params, "min")


@_register("movingSum")
def _moving_sum(eng, args, params):
    return _moving(eng, args, params, "sum")


@_register("movingMedian")
def _moving_median(eng, args, params):
    return _moving(eng, args, params, "median")


@_register("stdev", "stddev")
def _stdev(eng, args, params):
    """Unlike the moving* family, the reference's stdev window INCLUDES
    the current point (common/transform.go:222-248 folds ValueAt(index)
    in before emitting index) and gates output on windowTolerance: emit
    when validPoints/points >= tolerance — transform.go:250's exact
    condition, which is a MINIMUM valid fraction (default 0.1), not
    graphite-web's maximum-missing fraction."""
    W = _window_steps(args[1].value, params)
    tolerance = float(args[2].value) if len(args) > 2 else 0.1
    ext = QueryParams(params.start_ns - (W - 1) * params.step_ns,
                      params.end_ns, params.step_ns)
    block = eng._eval(args[0], ext)
    # both window passes dispatch before either result is fetched
    fetch_out = temporal.over_time_async(block.values, W, "stddev",
                                         device=eng.device)
    fetch_cnt = temporal.over_time_async(block.values, W, "count",
                                         device=eng.device)
    out, cnt = fetch_out(), fetch_cnt()
    with np.errstate(invalid="ignore"):
        out = np.where(cnt / W >= tolerance, out, np.nan)
    return Block(params.meta(), block.series_tags, out)


@_register("diffSeries")
def _diff_series(eng, args, params):
    blocks = [eng._eval(a, params) for a in args]
    vals = np.concatenate([b.values for b in blocks])
    if not vals.shape[0]:
        return Block(params.meta(), [], np.zeros((0, params.steps)))
    rest = np.where(np.isfinite(vals[1:]), vals[1:], 0.0)
    out = vals[0] - rest.sum(axis=0)
    return Block(blocks[0].meta, [Tags.of({b"__alias__": b"diffSeries"})],
                 out[None, :])


@_register("multiplySeries")
def _multiply_series(eng, args, params):
    return _combine(eng, args, params,
                    lambda v: np.nanprod(v, axis=0), "multiplySeries")


@_register("rangeOfSeries")
def _range_of_series(eng, args, params):
    return _combine(
        eng, args, params,
        lambda v: np.nanmax(v, axis=0) - np.nanmin(v, axis=0),
        "rangeOfSeries")


@_register("stddevSeries")
def _stddev_series(eng, args, params):
    return _combine(eng, args, params,
                    lambda v: np.nanstd(v, axis=0), "stddevSeries")


@_register("countSeries")
def _count_series(eng, args, params):
    """Constant line of the number of series (builtin_functions.go
    countSeries draws len(seriesList), not a per-step finite count)."""
    blocks = [eng._eval(a, params) for a in args]
    n = sum(b.n_series for b in blocks)
    meta = blocks[0].meta if blocks else params.meta()
    return Block(meta, [Tags.of({b"__alias__": b"countSeries"})],
                 np.full((1, meta.steps), float(n)))


@_register("divideSeries")
def _divide_series(eng, args, params):
    dividend = eng._eval(args[0], params)
    divisor = eng._eval(args[1], params)
    if divisor.n_series != 1:
        raise GraphiteParseError(
            f"divideSeries divisor must be one series, got {divisor.n_series}")
    with np.errstate(divide="ignore", invalid="ignore"):
        d = divisor.values[0]
        v = np.where(d != 0, dividend.values / d, np.nan)
    tags = [t.with_tag(b"__alias__",
                       b"divideSeries(%s,%s)" % (series_name(t),
                                                 series_name(divisor.series_tags[0])))
            for t in dividend.series_tags]
    return dividend.with_values(v, tags)


@_register("asPercent")
def _as_percent(eng, args, params):
    block = eng._eval(args[0], params)
    if len(args) > 1 and not isinstance(args[1], Literal):
        total = eng._eval(args[1], params).values
        total = np.nansum(total, axis=0)
    elif len(args) > 1:
        total = np.full(block.meta.steps, float(args[1].value))
    else:
        with np.errstate(invalid="ignore"):
            total = np.nansum(block.values, axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(total != 0, block.values / total * 100.0, np.nan)
    return block.with_values(v)


def _with_wildcards(eng, args, params, agg):
    block = eng._eval(args[0], params)
    positions = {int(a.value) for a in args[1:]}
    key = lambda parts: b".".join(
        p for j, p in enumerate(parts) if j not in positions)
    return _grouped_reduce(block, key, agg)


@_register("sumSeriesWithWildcards")
def _sum_series_with_wildcards(eng, args, params):
    return _with_wildcards(eng, args, params, "sum")


@_register("averageSeriesWithWildcards")
def _average_series_with_wildcards(eng, args, params):
    return _with_wildcards(eng, args, params, "average")


@_register("group")
def _group(eng, args, params):
    blocks = [eng._eval(a, params) for a in args]
    vals = np.concatenate([b.values for b in blocks]) if blocks else \
        np.zeros((0, params.steps))
    tags = [t for b in blocks for t in b.series_tags]
    meta = blocks[0].meta if blocks else params.meta()
    return Block(meta, tags, vals)


@_register("groupByNodes")
def _group_by_nodes(eng, args, params):
    block = eng._eval(args[0], params)
    agg = args[1].value
    nodes = [int(a.value) for a in args[2:]]
    key = lambda parts: b".".join(parts[n] for n in nodes
                                  if -len(parts) <= n < len(parts))
    return _grouped_reduce(block, key, agg)


@_register("constantLine")
def _constant_line(eng, args, params):
    value = float(args[0].value)
    meta = params.meta()
    tags = Tags.of({b"__alias__": str(value).encode()})
    return Block(meta, [tags], np.full((1, meta.steps), value))


@_register("threshold")
def _threshold(eng, args, params):
    value = float(args[0].value)
    label = str(args[1].value) if len(args) > 1 else str(value)
    meta = params.meta()
    return Block(meta, [Tags.of({b"__alias__": label.encode()})],
                 np.full((1, meta.steps), value))


@_register("stacked")
def _stacked(eng, args, params):
    """Cumulative stacking: series i becomes sum of series 0..i; a series'
    own gaps stay gaps."""
    block = eng._eval(args[0], params)
    v = np.where(np.isfinite(block.values), block.values, 0.0)
    out = np.cumsum(v, axis=0)
    out[~np.isfinite(block.values)] = np.nan
    tags = [t.with_tag(b"__alias__", b"stacked(" + series_name(t) + b")")
            for t in block.series_tags]
    return block.with_values(out, tags)


@_register("consolidateBy")
def _consolidate_by(eng, args, params):
    """Annotation only: block consolidation already happens at fetch grid
    resolution; the chosen function is recorded in the alias (render-layer
    consolidation concern, builtin_functions.go consolidateBy)."""
    block = eng._eval(args[0], params)
    return block


@_register("averageOutsidePercentile")
def _average_outside_percentile(eng, args, params):
    block = eng._eval(args[0], params)
    n = args[1].value
    n = max(n, 100 - n)
    means = _series_stat(block, "average")
    finite = means[np.isfinite(means)]
    if not finite.size:
        return block
    hi = _get_percentile(finite, n)
    lo = _get_percentile(finite, 100 - n)
    # graphite-web keeps anything NOT strictly inside (lo, hi), so the
    # boundary series (including n=100/n=0) survive.
    with np.errstate(invalid="ignore"):
        keep = np.flatnonzero(~((means > lo) & (means < hi)))
    return _pick_rows(block, keep)


# --------------------------------------------------- presentation + synthesis

def _rename_all(block: Block, fmt) -> Block:
    tags = [t.with_tag(b"__alias__", fmt(series_name(t)))
            for t in block.series_tags]
    return block.with_values(block.values, tags)


@_register("dashed")
def _dashed(eng, args, params):
    """Presentation-only in this renderer: records the dash request in the
    alias (builtin_functions.go:1786 dashed)."""
    block = eng._eval(args[0], params)
    length = float(args[1].value) if len(args) > 1 else 5.0
    if length <= 0:
        raise GraphiteParseError(f"expected a positive dashLength, got {length}")
    return _rename_all(
        block, lambda n: b"dashed(%s, %.3f)" % (n, length))


@_register("identity", "timeFunction", "time")
def _time_function(eng, args, params):
    """Series whose value at each step is that step's unix time in seconds
    (builtin_functions.go:184 identity, :1767 timeFunction). The optional
    step argument is subsumed by the render grid."""
    name = args[0].value if args else "time"
    meta = params.meta()
    vals = (meta.times() / S).astype(np.float64)
    return Block(meta, [Tags.of({b"__alias__": str(name).encode()})],
                 vals[None, :])


@_register("randomWalkFunction", "randomWalk")
def _random_walk(eng, args, params):
    """Uniform noise in [-0.5, 0.5) (builtin_functions.go:1513 — despite the
    name, the reference emits independent draws, not a cumulative walk).
    Seeded from the series name so renders are reproducible."""
    import zlib

    name = str(args[0].value)
    meta = params.meta()
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    vals = rng.random(meta.steps) - 0.5
    return Block(meta, [Tags.of({b"__alias__": name.encode()})], vals[None, :])


@_register("fallbackSeries")
def _fallback_series(eng, args, params):
    """builtin_functions.go:521: the fallback target renders only when the
    primary returns no series."""
    block = eng._eval(args[0], params)
    if block.n_series:
        return block
    return eng._eval(args[1], params)


@_register("removeEmptySeries")
def _remove_empty_series(eng, args, params):
    block = eng._eval(args[0], params)
    keep = np.flatnonzero(np.isfinite(block.values).any(axis=1)) if \
        block.n_series else []
    return _pick_rows(block, keep)


@_register("mostDeviant")
def _most_deviant(eng, args, params):
    """Top-N series by standard deviation (builtin_functions.go:533)."""
    block = eng._eval(args[0], params)
    n = int(args[1].value)
    with np.errstate(invalid="ignore"):
        s = np.nanstd(block.values, axis=1) if block.n_series else np.zeros(0)
    s = np.where(np.isfinite(s), s, -np.inf)
    return _pick_rows(block, np.argsort(-s, kind="stable")[:n])


_LEGEND_STATS = {"avg": "average", "average": "average", "total": "total",
                 "sum": "total", "min": "min", "max": "max",
                 "last": "current", "current": "current"}


@_register("aggregateLine")
def _aggregate_line(eng, args, params):
    """Horizontal line at f(first series) (builtin_functions.go:1532)."""
    block = eng._eval(args[0], params)
    fname = str(args[1].value) if len(args) > 1 else "avg"
    stat = _LEGEND_STATS.get(fname)
    if stat is None:
        raise GraphiteParseError(f"invalid function {fname!r}")
    if not block.n_series:
        raise GraphiteParseError("aggregateLine: empty series list")
    value = float(_series_stat(block, stat)[0])
    name = b"aggregateLine(%s,%.3f)" % (series_name(block.series_tags[0]),
                                        value)
    meta = params.meta()
    return Block(meta, [Tags.of({b"__alias__": name})],
                 np.full((1, meta.steps), value))


@_register("legendValue")
def _legend_value(eng, args, params):
    """Append '(type: value)' per requested stat to each legend name
    (builtin_functions.go:1635)."""
    block = eng._eval(args[0], params)
    kinds = [str(a.value) for a in args[1:]] or ["avg"]
    stats = []
    for k in kinds:
        stat = _LEGEND_STATS.get(k)
        if stat is None:
            raise GraphiteParseError(f"invalid function {k!r}")
        stats.append((k, _series_stat(block, stat)))
    tags = []
    for i, t in enumerate(block.series_tags):
        suffix = b"".join(b" (%s: %.3f)" % (k.encode(), col[i])
                          for k, col in stats)
        tags.append(t.with_tag(b"__alias__", series_name(t) + suffix))
    return block.with_values(block.values, tags)


@_register("cactiStyle")
def _cacti_style(eng, args, params):
    """Column-aligned 'name Current: Max: Min:' legends
    (builtin_functions.go:1683)."""
    block = eng._eval(args[0], params)
    if not block.n_series:
        return block
    cur = _series_stat(block, "current")
    mx = _series_stat(block, "max")
    mn = _series_stat(block, "min")

    def fmt(v):
        return "nan" if not math.isfinite(v) else "%.2f" % v

    names = [series_name(t).decode(errors="replace")
             for t in block.series_tags]
    name_w = max(len(n) for n in names)
    cur_s, max_s, min_s = ([fmt(v) for v in col] for col in (cur, mx, mn))
    cur_w = max(len(s) for s in cur_s)
    max_w = max(len(s) for s in max_s)
    min_w = max(len(s) for s in min_s)
    tags = []
    for i, t in enumerate(block.series_tags):
        legend = (f"{names[i]:<{name_w}} Current:{cur_s[i]:<{cur_w}} "
                  f"Max:{max_s[i]:<{max_w}} Min:{min_s[i]:<{min_w}} ")
        tags.append(t.with_tag(b"__alias__", legend.encode()))
    return block.with_values(block.values, tags)


# ----------------------------------------------------- interval reductions

@_register("hitcount")
def _hitcount(eng, args, params):
    """Integrate each series over interval buckets: value x seconds per
    bucket, buckets anchored at the window end (builtin_functions.go:1039).
    The render grid is regular, so each step contributes value*step_s to
    the bucket containing its start."""
    from .promql import parse_duration_ns

    block = eng._eval(args[0], params)
    interval_ns = parse_duration_ns(str(args[1].value))
    if interval_ns <= 0 or interval_ns < params.step_ns:
        raise GraphiteParseError(
            f"hitcount interval must be >= step, got {args[1].value!r}")
    n_buckets = max(1, math.ceil((params.end_ns - params.start_ns) / interval_ns))
    new_start = params.end_ns - n_buckets * interval_ns
    # The render grid is end-inclusive; a step starting at/after end_ns lies
    # outside every bucket and is dropped, not folded into the last one.
    bucket_of = (block.meta.times() - new_start) // interval_ns
    bucket_of = np.where(bucket_of >= n_buckets, -1, bucket_of.clip(0))
    step_s = params.step_ns / S
    out = np.zeros((block.n_series, n_buckets))
    v = np.where(np.isfinite(block.values), block.values, 0.0) * step_s
    for b in range(n_buckets):
        cols = bucket_of == b
        if cols.any():
            out[:, b] = v[:, cols].sum(axis=1)
    meta = QueryParams(new_start + interval_ns, params.end_ns,
                       interval_ns).meta()
    tags = [t.with_tag(b"__alias__", b"hitcount(%s, '%s')" % (
        series_name(t), str(args[1].value).encode()))
        for t in block.series_tags]
    return Block(meta, tags, out)


def _sustained(eng, args, params, above: bool):
    """Keep values only once the comparison has held for >= interval
    (builtin_functions.go:401 sustainedCompare); earlier points of each run
    flatten to the zero line threshold -/+ |threshold|."""
    from .promql import parse_duration_ns

    block = eng._eval(args[0], params)
    threshold = float(args[1].value)
    min_steps = max(1, parse_duration_ns(str(args[2].value)) // params.step_ns)
    v = block.values
    with np.errstate(invalid="ignore"):
        ok = (v >= threshold) if above else (v <= threshold)
    ok &= np.isfinite(v)
    # Per-row consecutive-True run lengths, vectorized: within each run the
    # count ascends; a False resets the base.
    idx = np.arange(v.shape[1])
    run = np.zeros_like(v, dtype=np.int64)
    for i in range(v.shape[0]):
        base = np.maximum.accumulate(np.where(~ok[i], idx, -1))
        run[i] = np.where(ok[i], idx - base, 0)
    zero = threshold - abs(threshold) if above else threshold + abs(threshold)
    out = np.where(run >= min_steps, v, zero)
    name = b"sustainedAbove" if above else b"sustainedBelow"
    tags = [t.with_tag(b"__alias__", b"%s(%s, %f, '%s')" % (
        name, series_name(t), threshold, str(args[2].value).encode()))
        for t in block.series_tags]
    return block.with_values(out, tags)


@_register("sustainedAbove")
def _sustained_above(eng, args, params):
    return _sustained(eng, args, params, True)


@_register("sustainedBelow")
def _sustained_below(eng, args, params):
    return _sustained(eng, args, params, False)


@_register("weightedAverage")
def _weighted_average(eng, args, params):
    """sum(value*weight)/sum(weight) over series matched by path node
    (aggregation_functions.go:307)."""
    values = eng._eval(args[0], params)
    weights = eng._eval(args[1], params)
    node = int(args[2].value)

    def keyed(block):
        out = {}
        for i, t in enumerate(block.series_tags):
            parts = tags_to_path(t.as_dict()).split(b".")
            if -len(parts) <= node < len(parts):
                out.setdefault(parts[node], i)
        return out

    vk, wk = keyed(values), keyed(weights)
    top = np.zeros(values.meta.steps)
    bottom = np.zeros(values.meta.steps)
    matched = False
    for key, vi in vk.items():
        wi = wk.get(key)
        if wi is None:
            continue  # no associated weight series
        matched = True
        v = values.values[vi]
        w = weights.values[wi]
        prod = v * w
        top += np.where(np.isfinite(prod), prod, 0.0)
        bottom += np.where(np.isfinite(w), w, 0.0)
    if not matched:
        return Block(values.meta, [], np.zeros((0, values.meta.steps)))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(bottom != 0, top / bottom, np.nan)
    return Block(values.meta, [Tags.of({b"__alias__": b"weightedAverage"})],
                 out[None, :])


# --------------------------------------------------------------- holt-winters

_HW_ALPHA = 0.1    # builtin_functions.go:45-47
_HW_GAMMA = 0.1
_HW_BETA = 0.0035
_HW_BOOTSTRAP_NS = 7 * 24 * 3600 * S   # one week of history seeds the model
_HW_SEASON_NS = 24 * 3600 * S          # daily seasonality


def _holt_winters_analysis(v: np.ndarray, season_steps: int):
    """Triple-exponential analysis, vectorized across series and sequential
    over time (builtin_functions.go:1371 holtWintersAnalysis). Returns
    (predictions, deviations) aligned with the input grid."""
    n, steps = v.shape
    intercepts = np.zeros((n, steps))
    slopes = np.zeros((n, steps))
    seasonals = np.zeros((n, steps))
    predictions = np.zeros((n, steps))
    deviations = np.zeros((n, steps))
    next_pred = np.full(n, np.nan)
    for i in range(steps):
        actual = v[:, i]
        nan = ~np.isfinite(actual)
        last_seasonal = seasonals[:, i - season_steps] if i >= season_steps \
            else np.zeros(n)
        j = i + 1 - season_steps
        next_last_seasonal = seasonals[:, j] if j >= 0 else np.zeros(n)
        last_dev = deviations[:, i - season_steps] if i >= season_steps \
            else np.zeros(n)
        if i == 0:
            last_intercept = actual.copy()
            last_slope = np.zeros(n)
            prediction = actual.copy()
        else:
            last_intercept = intercepts[:, i - 1].copy()
            last_slope = slopes[:, i - 1]
            last_intercept = np.where(np.isfinite(last_intercept),
                                      last_intercept, actual)
            prediction = next_pred
        with np.errstate(invalid="ignore"):
            intercept = (_HW_ALPHA * (actual - last_seasonal)
                         + (1 - _HW_ALPHA) * (last_intercept + last_slope))
            slope = (_HW_BETA * (intercept - last_intercept)
                     + (1 - _HW_BETA) * last_slope)
            seasonal = (_HW_GAMMA * (actual - intercept)
                        + (1 - _HW_GAMMA) * last_seasonal)
            pred_for_dev = np.where(np.isfinite(prediction), prediction, 0.0)
            deviation = (_HW_GAMMA * np.abs(actual - pred_for_dev)
                         + (1 - _HW_GAMMA) * last_dev)
        intercepts[:, i] = np.where(nan, np.nan, intercept)
        slopes[:, i] = np.where(nan, last_slope, slope)
        seasonals[:, i] = np.where(nan, last_seasonal, seasonal)
        predictions[:, i] = prediction
        deviations[:, i] = np.where(nan, 0.0, deviation)
        next_pred = np.where(nan, np.nan,
                             intercept + slope + next_last_seasonal)
    return predictions, deviations


def _hw_forecast_parts(eng, arg, params):
    """Fetch with one week of bootstrap history, run the analysis, trim the
    bootstrap prefix back off (builtin_functions.go:1224 + trimBootstrap)."""
    boot_steps = _HW_BOOTSTRAP_NS // params.step_ns
    season_steps = max(1, int(_HW_SEASON_NS // params.step_ns))
    ext = QueryParams(params.start_ns - boot_steps * params.step_ns,
                      params.end_ns, params.step_ns)
    block = eng._eval(arg, ext)
    pred, dev = _holt_winters_analysis(block.values, season_steps)
    keep = params.meta().steps
    return block, pred[:, -keep:], dev[:, -keep:]


@_register("holtWintersForecast")
def _holt_winters_forecast(eng, args, params):
    block, pred, _ = _hw_forecast_parts(eng, args[0], params)
    tags = [t.with_tag(b"__alias__",
                       b"holtWintersForecast(" + series_name(t) + b")")
            for t in block.series_tags]
    return Block(params.meta(), tags, pred)


@_register("holtWintersConfidenceBands")
def _holt_winters_confidence_bands(eng, args, params):
    delta = float(args[1].value) if len(args) > 1 else 3.0
    block, pred, dev = _hw_forecast_parts(eng, args[0], params)
    scaled = delta * dev
    lower, upper = pred - scaled, pred + scaled
    tags, rows = [], []
    for i, t in enumerate(block.series_tags):
        name = series_name(t)
        tags.append(t.with_tag(b"__alias__",
                               b"holtWintersConfidenceLower(" + name + b")"))
        rows.append(lower[i])
        tags.append(t.with_tag(b"__alias__",
                               b"holtWintersConfidenceUpper(" + name + b")"))
        rows.append(upper[i])
    vals = np.stack(rows) if rows else np.zeros((0, params.meta().steps))
    return Block(params.meta(), tags, vals)


@_register("holtWintersAberration")
def _holt_winters_aberration(eng, args, params):
    """Deviation of the actual outside the confidence bands; 0 inside
    (builtin_functions.go:1298)."""
    delta = float(args[1].value) if len(args) > 1 else 3.0
    block, pred, dev = _hw_forecast_parts(eng, args[0], params)
    keep = params.meta().steps
    actual = block.values[:, -keep:]
    scaled = delta * dev
    lower, upper = pred - scaled, pred + scaled
    with np.errstate(invalid="ignore"):
        out = np.where(np.isfinite(actual) & np.isfinite(upper)
                       & (actual > upper), actual - upper, 0.0)
        out = np.where(np.isfinite(actual) & np.isfinite(lower)
                       & (actual < lower), actual - lower, out)
        out = np.where(np.isfinite(actual), out, 0.0)
    tags = [t.with_tag(b"__alias__",
                       b"holtWintersAberration(" + series_name(t) + b")")
            for t in block.series_tags]
    return Block(params.meta(), tags, out)
