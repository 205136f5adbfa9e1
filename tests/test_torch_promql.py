"""The port's PromQL parser (m3_tpu_torch.query.promql, a host copy)
against the reference's: on every query string that
tests/test_query_engine.py hands to parse, run, execute_range or
execute_instant, the two ASTs must have the same repr (the same node
classes, fields, matchers and durations), or both parsers must refuse the
string with the same message."""

import ast
import os

import pytest

from m3_tpu.query import promql as jpromql
from m3_tpu_torch.query import promql as tpromql

_CALLS = ("parse", "run", "execute_range", "execute_instant")


def _engine_test_queries():
    path = os.path.join(os.path.dirname(__file__), "test_query_engine.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        if name not in _CALLS:
            continue
        for arg in node.args[:2]:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append(arg.value)
    return sorted(set(out))


QUERIES = _engine_test_queries()


def _parse(mod, q):
    try:
        return repr(mod.parse(q)), None
    except mod.ParseError as err:
        return None, str(err)


def test_the_engine_tests_have_queries():
    assert len(QUERIES) > 80


@pytest.mark.parametrize("q", QUERIES)
def test_ast_matches_reference(q):
    got = _parse(tpromql, q)
    assert got == _parse(jpromql, q)
    if got[0] is not None:
        tn, jn = tpromql.parse(q), jpromql.parse(q)
        assert tpromql.is_scalar_node(tn) == jpromql.is_scalar_node(jn)


@pytest.mark.parametrize("q", [
    "rate(x[5m] @ 1700000000)", "sum_over_time(x[5m10s])",
    "max_over_time(rate(x[5m])[30m:1m])", "x offset -5m", "x @ end()",
    'topk(5, sum by (host) (rate(x{a=~"b.*",c!="d"}[5m])))',
    "histogram_quantile(0.9, sum by (le) (rate(h_bucket[5m])))",
    'label_replace(x, "d", "$1", "s", "(.*)")', "1 +", "sum by (", "x[5"])
def test_more_queries_match_reference(q):
    assert _parse(tpromql, q) == _parse(jpromql, q)


def test_selector_matchers_and_durations():
    sel_t = tpromql.parse('x{a="b", c=~"d|e"}[5m]')
    sel_j = jpromql.parse('x{a="b", c=~"d|e"}[5m]')
    assert repr(tpromql.selector_matchers(sel_t)) == repr(
        jpromql.selector_matchers(sel_j))
    for s in ("1h30m", "500ms", "5m10s", "2d", "1y"):
        assert tpromql.parse_duration_ns(s) == jpromql.parse_duration_ns(s)
