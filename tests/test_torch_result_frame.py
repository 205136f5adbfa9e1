"""Port of tests/test_result_frame.py on m3_tpu_torch: the same cases on
the port's modules, with device None resolving to the CPU
(tests/test_torch_cpu_default.py).

Columnar result-frame proof: the columnar Prometheus JSON renderer
(query/render.py — zero per-series Python dicts on the path) is
BYTE-identical to the retained per-series oracle `render_result_ref`
across the whole compiled-vs-oracle query corpus, adversarial value
grids (shortest-decimal edge cases, negative zero, 2^53 boundaries,
all-NaN rows, empty results, unicode labels), and the real HTTP
surface (the coordinator serves the columnar bytes verbatim)."""

import json
import urllib.request

import numpy as np
import pytest

from m3_tpu_torch.query import Engine
from m3_tpu_torch.query import plan as qplan
from m3_tpu_torch.query import render
from m3_tpu_torch.query.block import Block, BlockMeta
from m3_tpu_torch.query.model import Tags

from test_plan_compile import (  # noqa: F401 — shared corpus fixture
    COMPILED_QUERIES, FALLBACK_QUERIES, START, END, STEP, make_storage,
)
from test_torch_cpu_default import cpu_default  # noqa: F401

S = 1_000_000_000
META = BlockMeta(1_700_000_000 * S, 30 * S, 12)


def tags_of(i, extra=None):
    d = {b"__name__": b"m", b"host": b"h%d" % (i % 3), b"i": str(i).encode()}
    if extra:
        d.update(extra)
    return Tags.of(d)


def assert_identical(block, instant=False):
    got = (render.prom_vector_bytes(block) if instant
           else render.prom_matrix_bytes(block))
    ref = render.render_result_ref(block, instant=instant)
    assert got == ref, (
        f"columnar frame diverged ({len(got)} vs {len(ref)} bytes); "
        f"first diff at "
        f"{next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), -1)}")
    json.loads(got)  # and it is valid JSON


@pytest.fixture
def no_floor(monkeypatch):
    monkeypatch.setattr(qplan, "PLAN_MIN_CELLS", 1)


class TestValueFormatting:
    def test_adversarial_grid(self):
        vals = np.array([
            [0.1, -0.0, 2.0, 1e16, 1e-4, 1e-5, np.nan, np.inf, -1e17,
             123.456, 0.30000000000000004, 2.0 ** 53],
            [2.0 ** 53 - 1, -(2.0 ** 53), 9007199254740994.0, 1.5, -7.0,
             0.0, -0.0, 1e15, 5e-324, -5e-324, 1.7976931348623157e308,
             -1e300],
            [np.nan] * 12,   # all-NaN row: dropped by both renderers
        ])
        tags = [tags_of(i, {b"u": "ünicodé \"q\"\\".encode()})
                for i in range(3)]
        assert_identical(Block(META, tags, vals))
        assert_identical(Block(META, tags, vals), instant=True)

    def test_f32_planes(self):
        # Compiled-route result planes are f32: the ref casts per value,
        # the columnar path as a matrix — must agree bytewise.
        rng = np.random.default_rng(3)
        vals = (1e9 + np.cumsum(rng.poisson(5.0, (6, 12)),
                                axis=1)).astype(np.float32)
        assert_identical(Block(META, [tags_of(i) for i in range(6)], vals))

    def test_empty_and_all_nan(self):
        assert_identical(Block(META, [], np.zeros((0, 12))))
        assert_identical(Block(META, [], np.zeros((0, 12))), instant=True)
        vals = np.full((4, 12), np.nan)
        assert_identical(Block(META, [tags_of(i) for i in range(4)], vals))

    @pytest.mark.parametrize("seed", range(8))
    def test_fuzzed_magnitudes(self, seed):
        rng = np.random.default_rng(seed)
        scale = 10.0 ** rng.integers(-10, 20)
        vals = rng.normal(0, scale, (16, 12))
        vals[rng.random((16, 12)) < 0.25] = np.nan
        if seed % 2:
            vals = np.round(vals)
        assert_identical(Block(META, [tags_of(i) for i in range(16)], vals))
        assert_identical(Block(META, [tags_of(i) for i in range(16)], vals),
                         instant=True)


class TestCorpusByteIdentity:
    """The satellite property: across the whole compiled-vs-oracle
    corpus, the columnar HTTP JSON is byte-identical to the per-series
    oracle — both for compiled-route (f32, lazily materialized) and
    interpreter-route blocks."""

    @pytest.mark.parametrize("seed", range(3))
    def test_whole_corpus(self, seed, no_floor):
        eng = Engine(make_storage(seed))
        for q in COMPILED_QUERIES + FALLBACK_QUERIES:
            block = eng.execute_range(q, START, END, STEP)
            got = render.prom_matrix_bytes(block)
            assert got == render.render_result_ref(block), q
            got_i = render.prom_vector_bytes(block)
            assert got_i == render.render_result_ref(block, instant=True), q


class TestHTTPServesColumnar:
    def test_query_range_bytes_are_oracle_bytes(self, no_floor):
        from m3_tpu_torch.coordinator.http_api import HTTPApi

        eng = Engine(make_storage(42))
        api = HTTPApi(eng).serve()
        try:
            from urllib.parse import urlencode

            for q in ("sum by (host) (rate(m[5m]))", "topk(3, m)",
                      "max_over_time(rate(m[5m])[10m:1m])", "m and b"):
                params = {"query": q, "start": START / S, "end": END / S,
                          "step": "30"}
                with urllib.request.urlopen(
                        f"{api.endpoint}/api/v1/query_range?"
                        f"{urlencode(params)}") as resp:
                    got = resp.read()
                block = eng.execute_range(q, START, END, STEP)
                assert got == render.render_result_ref(block), q
            # instant vector
            with urllib.request.urlopen(
                    f"{api.endpoint}/api/v1/query?"
                    f"{urlencode({'query': 'sum by (host) (m)', 'time': END / S})}"
            ) as resp:
                got = resp.read()
            block = eng.execute_instant("sum by (host) (m)", END)
            assert got == render.render_result_ref(block, instant=True)
        finally:
            api.close()
