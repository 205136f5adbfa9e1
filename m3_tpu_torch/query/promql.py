"""PromQL parser: lexer + Pratt parser producing the query AST (reference:
src/query/parser/promql/parse.go wraps the vendored prometheus promql
parser; this build implements the grammar natively — selectors with label
matchers and range/offset, function calls, aggregations with by/without,
binary operators with precedence, bool modifier and vector matching).

Covers the PromQL surface of the 2018-era engine the reference embeds,
plus the features that postdate it and exist in the upstream engine modern
M3 tracks: subqueries (`expr[range:resolution]`) and @-modifiers
(`expr @ <ts>`, `@ start()`, `@ end()`; end() resolves to the last output
step on the query grid)."""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

from .model import Matcher, MatchType, METRIC_NAME

# ---------------------------------------------------------------- tokens

# ONE duration grammar, shared by the lexer's DURATION token, the
# duration-value parser (_DUR_PART) and the subquery-resolution validator
# (Parser._RESOLUTION_RE) — one edit changes all three.
_DUR_ATOM = r"[0-9]+(?:\.[0-9]+)?(?:ms|[smhdwy])"

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+)
  | (?P<DURATION>@DUR@(?:@DUR@)*)
  | (?P<NUMBER>(?:0x[0-9a-fA-F]+)|(?:[0-9]*\.[0-9]+(?:[eE][+-]?[0-9]+)?)|(?:[0-9]+(?:[eE][+-]?[0-9]+)?)|[iI][nN][fF]|[nN][aA][nN])
  | (?P<IDENT>[a-zA-Z_:][a-zA-Z0-9_:.]*)
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<OP>=~|!~|==|!=|<=|>=|<|>|\+|-|\*|/|%|\^|=|@)
  | (?P<LPAREN>\()|(?P<RPAREN>\))
  | (?P<LBRACE>\{)|(?P<RBRACE>\})
  | (?P<LBRACKET>\[)|(?P<RBRACKET>\])
  | (?P<COMMA>,)
""".replace("@DUR@", _DUR_ATOM), re.VERBOSE)

_UNITS_NS = {"ms": 10**6, "s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9,
             "d": 86400 * 10**9, "w": 7 * 86400 * 10**9, "y": 365 * 86400 * 10**9}
_DUR_PART = re.compile(r"([0-9]+(?:\.[0-9]+)?)(ms|[smhdwy])")  # groups of _DUR_ATOM


def parse_duration_ns(s: str) -> int:
    total = 0
    for num, unit in _DUR_PART.findall(s):
        total += int(float(num) * _UNITS_NS[unit])
    return total


@dataclasses.dataclass
class Token:
    kind: str
    text: str
    pos: int


def lex(s: str) -> List[Token]:
    out, i = [], 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m:
            raise ParseError(f"unexpected character {s[i]!r} at {i}")
        kind = m.lastgroup
        if kind != "WS":
            out.append(Token(kind, m.group(), i))
        i = m.end()
    out.append(Token("EOF", "", len(s)))
    return out


class ParseError(ValueError):
    pass


# ---------------------------------------------------------------- AST

@dataclasses.dataclass(frozen=True)
class Node:
    pass


@dataclasses.dataclass(frozen=True)
class NumberLiteral(Node):
    value: float


@dataclasses.dataclass(frozen=True)
class StringLiteral(Node):
    value: str


@dataclasses.dataclass(frozen=True)
class VectorSelector(Node):
    name: bytes
    matchers: Tuple[Matcher, ...] = ()
    range_ns: int = 0          # 0 = instant vector; >0 = matrix selector
    offset_ns: int = 0
    # @-modifier: None, absolute ns timestamp, or "start"/"end" (resolved
    # against the query range at eval time).
    at_ns: object = None


@dataclasses.dataclass(frozen=True)
class Subquery(Node):
    """`expr[range:resolution]` — evaluate expr as an instant query at
    each resolution-aligned timestamp in the trailing range window,
    producing a range vector for an outer *_over_time/rate-family call.
    step_ns == 0 means "default resolution" (the engine substitutes the
    query step floored at 15s — executor.DEFAULT_SUBQUERY_RES_NS — its
    stand-in for prometheus' eval interval)."""
    expr: Node
    range_ns: int
    step_ns: int = 0
    offset_ns: int = 0
    at_ns: object = None       # see VectorSelector.at_ns


@dataclasses.dataclass(frozen=True)
class Call(Node):
    func: str
    args: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Aggregation(Node):
    op: str
    expr: Node
    param: Optional[Node] = None
    grouping: Tuple[bytes, ...] = ()
    without: bool = False


@dataclasses.dataclass(frozen=True)
class VectorMatching(Node):
    on: bool = False                     # on(...) vs ignoring(...)
    labels: Tuple[bytes, ...] = ()
    group_left: bool = False
    group_right: bool = False
    include: Tuple[bytes, ...] = ()


@dataclasses.dataclass(frozen=True)
class BinaryOp(Node):
    op: str
    lhs: Node
    rhs: Node
    bool_mode: bool = False
    matching: Optional[VectorMatching] = None


@dataclasses.dataclass(frozen=True)
class Unary(Node):
    op: str
    expr: Node


AGG_OPS = {"sum", "min", "max", "avg", "count", "stddev", "stdvar",
           "topk", "bottomk", "quantile", "count_values", "group"}
_PARAM_AGGS = {"topk", "bottomk", "quantile", "count_values"}

# precedence (prom): or < and/unless < comparisons < +- < */% < ^
_PRECEDENCE = {
    "or": 1,
    "and": 2, "unless": 2,
    "==": 3, "!=": 3, "<=": 3, "<": 3, ">=": 3, ">": 3,
    "+": 4, "-": 4,
    "*": 5, "/": 5, "%": 5,
    "^": 6,
}
_RIGHT_ASSOC = {"^"}
SET_OPS = {"and", "or", "unless"}
COMPARISON_OPS = {"==", "!=", "<=", "<", ">=", ">"}


class Parser:
    def __init__(self, s: str):
        self.toks = lex(s)
        self.i = 0

    # -- token helpers ----------------------------------------------------

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ParseError(f"expected {text or kind}, got {t.text!r} at {t.pos}")
        return t

    def accept(self, kind: str, text: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (text is None or t.text == text):
            return self.next()
        return None

    # -- grammar ----------------------------------------------------------

    def parse(self) -> Node:
        node = self.parse_expr(0)
        if self.peek().kind != "EOF":
            t = self.peek()
            raise ParseError(f"unexpected {t.text!r} at {t.pos}")
        return node

    def parse_expr(self, min_prec: int) -> Node:
        lhs = self.parse_unary()
        while True:
            t = self.peek()
            op = t.text if t.kind in ("OP", "IDENT") else None
            if op not in _PRECEDENCE or _PRECEDENCE[op] < min_prec:
                return lhs
            self.next()
            bool_mode = bool(self.accept("IDENT", "bool"))
            matching = self._parse_matching()
            next_min = _PRECEDENCE[op] + (0 if op in _RIGHT_ASSOC else 1)
            rhs = self.parse_expr(next_min)
            lhs = BinaryOp(op, lhs, rhs, bool_mode, matching)

    def _parse_matching(self) -> Optional[VectorMatching]:
        t = self.peek()
        if t.kind != "IDENT" or t.text not in ("on", "ignoring"):
            return None
        on = self.next().text == "on"
        labels = self._parse_label_list()
        group_left = group_right = False
        include: Tuple[bytes, ...] = ()
        t = self.peek()
        if t.kind == "IDENT" and t.text in ("group_left", "group_right"):
            side = self.next().text
            group_left = side == "group_left"
            group_right = side == "group_right"
            if self.peek().kind == "LPAREN":
                include = self._parse_label_list()
        return VectorMatching(on, labels, group_left, group_right, include)

    def _parse_label_list(self) -> Tuple[bytes, ...]:
        self.expect("LPAREN")
        labels = []
        while not self.accept("RPAREN"):
            labels.append(self.expect("IDENT").text.encode())
            if self.peek().kind == "COMMA":
                self.next()
        return tuple(labels)

    def parse_unary(self) -> Node:
        t = self.peek()
        if t.kind == "OP" and t.text in ("+", "-"):
            self.next()
            # Unary operators bind between '^' and '*' (Go/prom spec):
            # -2^2 == -(2^2), -2*3 == (-2)*3.
            expr = self.parse_expr(_PRECEDENCE["^"])
            return expr if t.text == "+" else Unary("-", expr)
        return self.parse_postfix(self.parse_atom())

    def parse_postfix(self, node: Node) -> Node:
        # range selector [5m], subquery [30m:1m] / [30m:], offset modifier;
        # loops so `min_over_time(rate(x[5m])[30m:])[...]`-style chains and
        # an offset AFTER a subquery both parse.
        offset_seen = False
        while True:
            if self.accept("LBRACKET"):
                tok = self.expect("DURATION")
                rng = parse_duration_ns(tok.text)
                if rng == 0:
                    raise ParseError(f"zero range at {tok.pos}")
                res = self._accept_subquery_resolution()
                self.expect("RBRACKET")
                if res is not None:
                    node = Subquery(node, rng, res)
                    offset_seen = False  # the subquery is a new modifier target
                elif (isinstance(node, VectorSelector) and not node.range_ns
                        and not offset_seen):
                    # offset_seen guard: prom requires the range BEFORE any
                    # offset (`c offset 5m [5m]` is a parse error upstream;
                    # silently reordering would mask the user's mistake).
                    node = dataclasses.replace(node, range_ns=rng)
                else:
                    raise ParseError("range selector on non-selector expression")
                continue
            if self.accept("IDENT", "offset"):
                dur = parse_duration_ns(self.expect("DURATION").text)
                if not isinstance(node, (VectorSelector, Subquery)):
                    raise ParseError("offset on non-selector expression")
                if offset_seen:
                    # prom rejects repeated offset modifiers; silently
                    # letting the last win would query the wrong window
                    # (a flag, not a field truthiness check: `offset 0s`
                    # must arm the rejection too).
                    raise ParseError("duplicate offset modifier")
                offset_seen = True
                node = dataclasses.replace(node, offset_ns=dur)
                continue
            if self.accept("OP", "@"):
                if not isinstance(node, (VectorSelector, Subquery)):
                    raise ParseError("@ modifier on non-selector expression")
                if node.at_ns is not None:
                    raise ParseError("duplicate @ modifier")
                node = dataclasses.replace(node, at_ns=self._parse_at())
                continue
            return node

    def _parse_at(self):
        """`@ <unix-seconds>` (possibly negative/float) or `@ start()` /
        `@ end()` — pins the selector's evaluation time."""
        neg = bool(self.accept("OP", "-"))
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            sec = _parse_number(t.text)
            return int((-sec if neg else sec) * 1e9)
        if not neg and t.kind == "IDENT" and t.text in ("start", "end"):
            self.next()
            self.expect("LPAREN")
            self.expect("RPAREN")
            return t.text
        raise ParseError(f"expected timestamp, start() or end() after @ "
                         f"at {t.pos}")

    _RESOLUTION_RE = re.compile(rf"(?:{_DUR_ATOM})+\Z")

    def _accept_subquery_resolution(self) -> Optional[int]:
        """After the range duration inside brackets: ':' or ':<dur>' marks a
        subquery. The lexer folds ':1m' into one IDENT (':' is an ident
        char for recording-rule names), so the resolution is split back out
        here; a bare ':' may also be followed by a separate DURATION token
        (`[1h : 5m]`). Returns resolution ns (0 = default), or None when
        the bracket is a plain range selector."""
        t = self.peek()
        if t.kind != "IDENT" or not t.text.startswith(":"):
            return None
        self.next()
        res_txt = t.text[1:]
        if not res_txt:
            d = self.accept("DURATION")
            res_txt = d.text if d else ""
        if not res_txt:
            return 0
        if not self._RESOLUTION_RE.match(res_txt):
            raise ParseError(
                f"bad subquery resolution {res_txt!r} at {t.pos}")
        ns = parse_duration_ns(res_txt)
        if ns == 0:
            # explicit zero ([5m:0s]) must not alias the bare-':' default
            raise ParseError(f"zero resolution in subquery at {t.pos}")
        return ns

    def parse_atom(self) -> Node:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return NumberLiteral(_parse_number(t.text))
        if t.kind == "STRING":
            self.next()
            return StringLiteral(_unquote(t.text))
        if t.kind == "LPAREN":
            self.next()
            node = self.parse_expr(0)
            self.expect("RPAREN")
            return node
        if t.kind == "LBRACE":
            return VectorSelector(b"", self._parse_matchers())
        if t.kind == "IDENT":
            if t.text in AGG_OPS:
                return self._parse_aggregation()
            return self._parse_ident()
        raise ParseError(f"unexpected {t.text!r} at {t.pos}")

    def _parse_ident(self) -> Node:
        name = self.next().text
        if self.peek().kind == "LPAREN" and name not in ("on", "ignoring"):
            self.next()
            args: List[Node] = []
            while not self.accept("RPAREN"):
                args.append(self.parse_expr(0))
                if self.peek().kind == "COMMA":
                    self.next()
            return Call(name, tuple(args))
        matchers: Tuple[Matcher, ...] = ()
        if self.peek().kind == "LBRACE":
            matchers = self._parse_matchers()
        return VectorSelector(name.encode(), matchers)

    def _parse_aggregation(self) -> Node:
        op = self.next().text
        grouping: Tuple[bytes, ...] = ()
        without = False
        # modifier may precede or follow the parenthesized body
        t = self.peek()
        if t.kind == "IDENT" and t.text in ("by", "without"):
            without = self.next().text == "without"
            grouping = self._parse_label_list()
        self.expect("LPAREN")
        first = self.parse_expr(0)
        param = None
        if self.accept("COMMA"):
            param, first = first, self.parse_expr(0)
        self.expect("RPAREN")
        t = self.peek()
        if t.kind == "IDENT" and t.text in ("by", "without"):
            without = self.next().text == "without"
            grouping = self._parse_label_list()
        if op in _PARAM_AGGS and param is None:
            raise ParseError(f"{op} requires a parameter")
        return Aggregation(op, first, param, grouping, without)

    def _parse_matchers(self) -> Tuple[Matcher, ...]:
        self.expect("LBRACE")
        out: List[Matcher] = []
        while not self.accept("RBRACE"):
            name = self.expect("IDENT").text
            opt = self.expect("OP")
            mt = {"=": MatchType.EQUAL, "!=": MatchType.NOT_EQUAL,
                  "=~": MatchType.REGEXP, "!~": MatchType.NOT_REGEXP}.get(opt.text)
            if mt is None:
                raise ParseError(f"bad matcher operator {opt.text!r} at {opt.pos}")
            value = _unquote(self.expect("STRING").text)
            out.append(Matcher(mt, name.encode(), value.encode()))
            if self.peek().kind == "COMMA":
                self.next()
        return tuple(out)


def _parse_number(s: str) -> float:
    low = s.lower()
    if low == "inf":
        return float("inf")
    if low == "nan":
        return float("nan")
    if low.startswith("0x"):
        return float(int(s, 16))
    return float(s)


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", '"': '"',
            "'": "'", "a": "\a", "b": "\b", "f": "\f", "v": "\v", "/": "/"}
_ESCAPE_RE = re.compile(
    r"\\(x[0-9a-fA-F]{2}|u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|[0-7]{1,3}|.)")


def _unquote(s: str) -> str:
    """Resolve escape sequences without the unicode_escape latin-1 round
    trip (which mojibakes non-ASCII literals)."""

    def sub(m: "re.Match") -> str:
        e = m.group(1)
        if e[0] in "xuU":
            return chr(int(e[1:], 16))
        if e[0] in "01234567":
            return chr(int(e, 8))
        if e in _ESCAPES:
            return _ESCAPES[e]
        raise ParseError(f"unknown escape \\{e}")

    return _ESCAPE_RE.sub(sub, s[1:-1])


def parse(s: str) -> Node:
    """Parse a PromQL expression string into an AST."""
    return Parser(s).parse()


# Functions whose CALL types as scalar (promql/parser functions.go return
# types) — kept next to the AST so the engine and the HTTP layer share one
# definition.
SCALAR_FUNCS = frozenset({"scalar", "time", "pi"})


def is_scalar_node(node: Node) -> bool:
    """Static promql typing of the ROOT expression: scalar literals,
    scalar-returning functions, and arithmetic over scalars type as
    scalar (promql/parser checkAST); anything touching a vector types as
    vector. The prom HTTP API shapes instant results by this."""
    if isinstance(node, NumberLiteral):
        return True
    if isinstance(node, Unary):
        return is_scalar_node(node.expr)
    if isinstance(node, Call):
        return node.func in SCALAR_FUNCS
    if isinstance(node, BinaryOp):
        return (node.op not in SET_OPS
                and is_scalar_node(node.lhs) and is_scalar_node(node.rhs))
    return False


def selector_matchers(sel: VectorSelector) -> Tuple[Matcher, ...]:
    """Full matcher set including the metric name."""
    out = list(sel.matchers)
    if sel.name:
        out.insert(0, Matcher(MatchType.EQUAL, METRIC_NAME, sel.name))
    return tuple(out)
