"""Columnar Prometheus result rendering: HTTP response bytes straight
from a Block's value matrix (reference: src/query/api/v1/handler/
prometheus/renderResultsJSON — the reference streams per-series JSON
through a json.NewEncoder; this build renders the whole result from the
COLUMNS, with zero per-series Python dicts on the path).

The per-series path builds one dict per series and one [t, "v"] list
per sample, each value formatted by np.format_float_positional, then
json.dumps the nested structure: on a fat matrix nearly all of the
response time is in that loop. Here the finite mask, per-row sample counts and column indices
come from three vectorized passes over the matrix; time strings render
once for the whole block (every series shares the step grid); values
format through a repr() fast path (CPython's float repr is the same
shortest-round-trip decimal Dragon4 produces — positional-range values
differ from format_float_positional only by the trailing ".0", which is
trimmed; everything else falls back to the exact formatter); and the
response assembles as one bytes join.

Byte identity is a CONTRACT, not a hope: `render_result_ref` is the old
per-series materialization retained verbatim (the established `_ref`
oracle pattern — m3lint's per-series-result-dict rule exempts `_ref`
renderers by name), and tests/test_result_frame.py asserts the columnar
bytes equal `json.dumps(ref_dict).encode()` across the whole
compiled-vs-oracle corpus plus adversarial value grids. The separators
(", ", ": ") reproduce json.dumps defaults.

Port of m3_tpu/query/render.py: host code over the port's numpy
Block.values, so its bytes equal the reference's for the same Block."""

from __future__ import annotations

import json
import math
from typing import Dict, List

import numpy as np

from .block import Block

S = 1_000_000_000

# The C-accelerated ASCII string escaper json.dumps itself uses.
_esc = json.encoder.encode_basestring_ascii


def prom_sample_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    # Go strconv.FormatFloat(v, 'f', -1)-style: shortest POSITIONAL
    # round-trip decimal — no trailing .0 on integers and no scientific
    # notation at any magnitude ("100000000000000000000", "0.0000001") —
    # what prometheus emits and strict clients byte-compare against.
    return np.format_float_positional(float(v), unique=True, trim="-")


def _metric_labels(tags) -> Dict[str, str]:
    return {k.decode(): v.decode() for k, v in tags.pairs}


# ------------------------------------------------------------ ref oracle
#
# The pre-change per-series materialization, retained VERBATIM: one dict
# per series, one [t, "v"] list per sample. `render_result_ref` is the
# byte-identity oracle every columnar response is proven against.


def prom_matrix_ref(block: Block) -> dict:
    times = block.meta.times() / S
    result = []
    for tags, row in zip(block.series_tags, block.values):
        finite = np.isfinite(row)
        if not finite.any():
            continue
        values = [[float(t), prom_sample_value(v)]
                  for t, v, ok in zip(times, row, finite) if ok]
        result.append({"metric": _metric_labels(tags), "values": values})
    return {"status": "success",
            "data": {"resultType": "matrix", "result": result}}


def prom_vector_ref(block: Block) -> dict:
    t = block.meta.times()[-1] / S
    result = []
    for tags, row in zip(block.series_tags, block.values):
        v = row[-1]
        if not math.isfinite(v):
            continue
        result.append({"metric": _metric_labels(tags),
                       "value": [float(t), prom_sample_value(v)]})
    return {"status": "success",
            "data": {"resultType": "vector", "result": result}}


def render_result_ref(block: Block, instant: bool = False) -> bytes:
    """The byte-identity oracle: the retained per-series renderer +
    json.dumps, exactly what the pre-change HTTP layer emitted."""
    out = prom_vector_ref(block) if instant else prom_matrix_ref(block)
    return json.dumps(out).encode()


# ------------------------------------------------------- columnar render


def _format_values(flat: np.ndarray) -> List[str]:
    """Shortest-positional-decimal strings for a flat FINITE f64 column.

    Integer-valued cells below 2^53 (the dashboard bulk: counter
    samples, window counts, increase sums) format as one vectorized
    C-level sprintf — below 2^53 a double's integer digits ARE its
    shortest unique positional form, and the bound excludes the even-
    spaced range where a neighboring odd integer could be the shorter
    Dragon4 pick (negative zero stays on the slow path: "-0", not "0").
    The rest go through repr() — the same shortest-round-trip Dragon4
    digits — whose only positional-range difference from
    np.format_float_positional(unique, trim="-") is the ".0" integer
    suffix; scientific-notation cases fall back to the exact
    formatter."""
    n = flat.shape[0]
    ints = ((flat == np.floor(flat)) & (np.abs(flat) < 2.0 ** 53)
            & ((flat != 0) | ~np.signbit(flat)))
    if ints.all():
        return list(map(str, flat.astype(np.int64).tolist()))
    if not ints.any():
        return _format_floats(flat)
    out: List[str] = [""] * n
    int_pos = np.nonzero(ints)[0]
    int_strs = map(str, flat[int_pos].astype(np.int64).tolist())
    for p, s in zip(int_pos.tolist(), int_strs):
        out[p] = s
    rest_pos = np.nonzero(~ints)[0]
    for p, s in zip(rest_pos.tolist(), _format_floats(flat[rest_pos])):
        out[p] = s
    return out


def _format_floats(rest: np.ndarray) -> List[str]:
    """The non-integer tail: one C-level map(repr, ...) pass, then an
    in-place fix-up (strip the ".0" suffix; route the rare scientific-
    notation magnitudes through the exact positional formatter)."""
    strs = list(map(repr, rest.tolist()))
    fallback = prom_sample_value
    vals = None
    for j, s in enumerate(strs):
        if s[-2:] == ".0":
            strs[j] = s[:-2]
        elif "e" in s:
            if vals is None:
                vals = rest.tolist()
            strs[j] = fallback(vals[j])
    return strs


def _metric_json(tags) -> str:
    """The series' label object, rendered exactly as json.dumps renders
    the ref's insertion-ordered dict — directly from the tag pairs, no
    dict on the path."""
    return ("{" + ", ".join(
        f"{_esc(k.decode())}: {_esc(v.decode())}" for k, v in tags.pairs)
        + "}")


def prom_matrix_bytes(block: Block) -> bytes:
    """One columnar pass over the [series, steps] matrix -> the full
    query_range response bytes, byte-identical to render_result_ref."""
    vals = np.asarray(block.values, dtype=np.float64)
    finite = np.isfinite(vals)
    times = block.meta.times() / S
    # One '[<time>, "' prefix per COLUMN — every series shares the step
    # grid, so each cell costs one concat + its share of one join.
    t_open = [f'[{repr(t)}, "' for t in times.tolist()]
    flat_strs = _format_values(vals[finite])
    col_idx = np.nonzero(finite)[1].tolist()
    counts = finite.sum(axis=1).tolist()
    series_chunks: List[str] = []
    pos = 0
    for r, n in enumerate(counts):
        if n == 0:
            continue
        cells = '"], '.join(
            t_open[c] + s
            for c, s in zip(col_idx[pos:pos + n], flat_strs[pos:pos + n]))
        pos += n
        series_chunks.append(
            '{"metric": ' + _metric_json(block.series_tags[r])
            + ', "values": [' + cells + '"]]}')
    body = ('{"status": "success", "data": {"resultType": "matrix", '
            '"result": [' + ", ".join(series_chunks) + "]}}")
    return body.encode()


def prom_vector_bytes(block: Block) -> bytes:
    """Instant-vector twin: the last column only."""
    vals = np.asarray(block.values, dtype=np.float64)
    t_str = repr(float(block.meta.times()[-1] / S))
    last = vals[:, -1] if vals.size else np.zeros(0)
    finite = np.isfinite(last)
    rows = np.nonzero(finite)[0].tolist()
    val_strs = _format_values(last[finite])
    series_chunks = [
        '{"metric": ' + _metric_json(block.series_tags[r])
        + f', "value": [{t_str}, "{s}"]}}'
        for r, s in zip(rows, val_strs)]
    body = ('{"status": "success", "data": {"resultType": "vector", '
            '"result": [' + ", ".join(series_chunks) + "]}}")
    return body.encode()
