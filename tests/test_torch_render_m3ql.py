"""The port's result renderer (m3_tpu_torch/query/render.py) and M3QL
parser (m3_tpu_torch/query/m3ql.py) against the reference's, on the CPU.

Render: for the same Block (the same tags and the same value matrix,
built in each package), the port's columnar bytes (prom_matrix_bytes,
prom_vector_bytes), the port's per-series oracle (render_result_ref) and
the reference's oracle are one byte string: grids with NaN, +-Inf, +-0,
1e12, 2^53 edges, denormals, f32 planes and seeded magnitudes, and every
answer of the port's Engine(device="cpu") over tests/test_plan_compile.py's
corpus on both query routes. Bytes are compared exactly.

M3QL: every script of tests/test_m3ql.py and more parses to the same
tree in both packages (compared through `canon`), and every bad script
raises M3QLError with the same message."""

import json

import numpy as np
import pytest

from m3_tpu.query import block as jblock
from m3_tpu.query import m3ql as jm3ql
from m3_tpu.query import model as jmodel
from m3_tpu.query import render as jrender
from m3_tpu_torch.query import block as tblock
from m3_tpu_torch.query import m3ql as tm3ql
from m3_tpu_torch.query import model as tmodel
from m3_tpu_torch.query import plan as tplan
from m3_tpu_torch.query import render as trender
from m3_tpu_torch.query.executor import Engine
from test_plan_compile import (COMPILED_QUERIES, END, FALLBACK_QUERIES,
                               START, STEP, make_storage)
from test_torch_metrics_rules import canon

S = 1_000_000_000


def _pair(values, tags, meta=(1_700_000_000 * S, 30 * S, 12)):
    """The same Block in each package: (reference, port)."""
    jb = jblock.Block(jblock.BlockMeta(*meta),
                      [jmodel.Tags.of(t) for t in tags], values)
    tb = tblock.Block(tblock.BlockMeta(*meta),
                      [tmodel.Tags.of(t) for t in tags], values)
    return jb, tb


def _tags(n, extra=None):
    out = []
    for i in range(n):
        d = {b"__name__": b"m", b"host": b"h%d" % (i % 3),
             b"i": str(i).encode()}
        d.update(extra or {})
        out.append(d)
    return out


def assert_same_bytes(jb, tb):
    for instant in (False, True):
        want = jrender.render_result_ref(jb, instant=instant)
        got = (trender.prom_vector_bytes(tb) if instant
               else trender.prom_matrix_bytes(tb))
        assert got == want
        assert trender.render_result_ref(tb, instant=instant) == want
        json.loads(got)


ADVERSARIAL = np.array([
    [0.1, -0.0, 2.0, 1e16, 1e-4, 1e-5, np.nan, np.inf, -1e17, 123.456,
     0.30000000000000004, 2.0 ** 53],
    [2.0 ** 53 - 1, -(2.0 ** 53), 9007199254740994.0, 1.5, -7.0, 0.0,
     -0.0, 1e15, 5e-324, -5e-324, 1.7976931348623157e308, -1e300],
    [1e12, -1e12, 1e12 + 0.5, 1e21, 1e-7, -np.inf, np.inf, 0.0, -0.0,
     1e22, 123456789012.25, np.nan],
    [np.nan] * 12,
])


def test_adversarial_grid_bytes_equal_reference():
    """NaN, +-Inf, +-0, 1e12, 2^53 edges, denormals, the largest double,
    and unicode and quote-bearing labels."""
    tags = _tags(4, {b"u": "ünicodé \"q\"\\".encode()})
    assert_same_bytes(*_pair(ADVERSARIAL, tags))


def test_f32_empty_and_all_nan_bytes_equal_reference():
    rng = np.random.default_rng(3)
    f32 = (1e9 + np.cumsum(rng.poisson(5.0, (6, 12)), axis=1)).astype(
        np.float32)
    assert_same_bytes(*_pair(f32, _tags(6)))
    assert_same_bytes(*_pair(np.zeros((0, 12)), []))
    assert_same_bytes(*_pair(np.full((4, 12), np.nan), _tags(4)))


@pytest.mark.parametrize("seed", range(8))
def test_fuzzed_magnitudes_bytes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 10.0 ** rng.integers(-10, 20), (16, 12))
    vals[rng.random((16, 12)) < 0.25] = np.nan
    if seed % 2:
        vals = np.round(vals)
    assert_same_bytes(*_pair(vals, _tags(16)))


@pytest.mark.parametrize("route", ["compiled", "interpreter"])
def test_engine_answers_render_like_the_reference(route, monkeypatch):
    """Every query of tests/test_plan_compile.py's corpus through the
    port's Engine(device="cpu") (the compiled route with its floor at 1
    cell, or execute_range_ref): the port's columnar bytes equal its
    oracle's and the reference renderer's over the same Block."""
    monkeypatch.setattr(tplan, "PLAN_MIN_CELLS", 1)
    eng = Engine(make_storage(7), device="cpu")
    run = eng.execute_range if route == "compiled" else eng.execute_range_ref
    for q in COMPILED_QUERIES + FALLBACK_QUERIES:
        blk = run(q, START, END, STEP)
        vals = np.asarray(blk.values)
        jb = jblock.Block(jblock.BlockMeta(blk.meta.start_ns,
                                           blk.meta.step_ns, blk.meta.steps),
                          [jmodel.Tags(t.pairs) for t in blk.series_tags],
                          vals)
        assert_same_bytes(jb, blk)


SCRIPTS = [
    "fetch name:cpu.util host:web* | transform perSecond",
    "fetch name:errors | > 0.5",
    'fetch name:x | summarize 1h sum alignToFrom:true | alias "cpu usage"',
    "cpu = fetch name:cpu.util | transform perSecond;\ncpu | moving 5min avg",
    "asPercent (fetch name:used) (fetch name:total)",
    "# top-level comment\nfetch name:x  # trailing\n | head 5",
    "fetch name:inf | filter host:1_000 | keep nan",
    "head 5 | scale -0.5 | shift 1e3",
    'a = fetch name:a; b = a | abs; b | alias "x \\"y\\" z" | <= -.5e2',
    "fetch name:{a,b}.c dc:[ab]* | sum host | == 1 | != 2 | >= 3 | < 4",
    "x = fetch name:q;\n(x | head 2) | tail 1 flag:false other:(x | abs)",
]

BAD = ["fetch name:x |", "(fetch name:x", "m = fetch name:x", "| head",
       'fetch name:"x', "fetch name:x )", "a = ;", "fetch name:x | ;"]


@pytest.mark.parametrize("k", range(len(SCRIPTS)))
def test_m3ql_parse_equals_reference(k):
    assert canon(tm3ql.parse(SCRIPTS[k])) == canon(jm3ql.parse(SCRIPTS[k]))


@pytest.mark.parametrize("k", range(len(BAD)))
def test_m3ql_errors_equal_reference(k):
    with pytest.raises(jm3ql.M3QLError) as jerr:
        jm3ql.parse(BAD[k])
    with pytest.raises(tm3ql.M3QLError) as terr:
        tm3ql.parse(BAD[k])
    assert str(terr.value) == str(jerr.value)
