"""M3QL parser: the reference's third, pipe-based query language
(reference: src/query/parser/m3ql/grammar.peg — a PEG grammar feeding a
scriptBuilder; kept as a parser-level placeholder there, mirrored here at
the same level of integration).

Grammar (grammar.peg):

    Grammar      <- Spacing (MacroDef ';')* Pipeline EOF
    MacroDef     <- Identifier '=' Pipeline
    Pipeline     <- Expression ('|' Expression)*
    Expression   <- FunctionCall / '(' Pipeline ')'
    FunctionCall <- (Identifier / Operator) Argument*
    Argument     <- (Identifier ':')? (Boolean / Number / Pattern
                                       / StringLiteral / '(' Pipeline ')')

Example: ``fetch name:cpu.util host:web* | transform perSecond | > 0.5``.

The parser resolves macro references inside pipelines (a bare identifier
expression whose name matches an earlier macro splices that macro's
pipeline, matching the builder's macro table), and validates structure
only — execution is promql/graphite's job; m3ql scripts translate onto
the same batched Block dataflow when wired to an evaluator.

Host copy of m3_tpu/query/m3ql.py."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple, Union

_OPERATORS = ("<=", "==", "!=", ">=", "<", ">")
_NUMBER = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")

Arg = Union[bool, float, str, "Pipeline"]


class M3QLError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Call:
    """One pipeline stage: function name + positional/keyword arguments."""

    name: str
    args: Tuple[Arg, ...] = ()
    kwargs: Tuple[Tuple[str, Arg], ...] = ()


@dataclasses.dataclass(frozen=True)
class Pipeline:
    stages: Tuple[Call, ...]


@dataclasses.dataclass(frozen=True)
class Script:
    macros: Tuple[Tuple[str, Pipeline], ...]
    pipeline: Pipeline


_TOKEN = re.compile(
    r"""
      (?P<space>[ \t\r\n]+|\#[^\r\n]*)
    | (?P<op><=|==|!=|>=|<|>)
    | (?P<punct>[|;:=()])
    | (?P<string>"(?:[^"\\]|\\.)*")
    | (?P<word>[A-Za-z_][A-Za-z0-9_./\\*?\[\]{},-]*|[^ \t\r\n|;:=()"#]+)
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if m is None:
            raise M3QLError(f"m3ql: cannot tokenize at offset {pos}: "
                            f"{src[pos:pos + 12]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "space":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0
        self.macros: Dict[str, Pipeline] = {}

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def take(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str):
        kind, val = self.take()
        if val != text:
            raise M3QLError(f"m3ql: expected {text!r}, got {val!r}")

    # Grammar <- (MacroDef ';')* Pipeline EOF — a macro def is only
    # distinguishable by the '=' after its identifier, so look ahead.
    def script(self) -> Script:
        macros: List[Tuple[str, Pipeline]] = []
        while (self.peek()[0] == "word"
               and self.toks[self.i + 1][1] == "="):
            name = self.take()[1]
            self.expect("=")
            pipe = self.pipeline()
            self.expect(";")
            self.macros[name] = pipe
            macros.append((name, pipe))
        pipe = self.pipeline()
        if self.peek()[0] != "eof":
            raise M3QLError(f"m3ql: trailing input at {self.peek()[1]!r}")
        return Script(tuple(macros), pipe)

    def pipeline(self) -> Pipeline:
        stages: List[Call] = [*self.expression()]
        while self.peek()[1] == "|":
            self.take()
            stages.extend(self.expression())
        return Pipeline(tuple(stages))

    def expression(self) -> Tuple[Call, ...]:
        kind, val = self.peek()
        if val == "(":
            self.take()
            pipe = self.pipeline()
            self.expect(")")
            return pipe.stages
        if kind not in ("word", "op"):
            raise M3QLError(f"m3ql: expected function, got {val!r}")
        self.take()
        # A bare identifier naming an earlier macro splices its pipeline
        # (scriptBuilder's macro resolution).
        if kind == "word" and val in self.macros and not self._at_argument():
            return self.macros[val].stages
        args: List[Arg] = []
        kwargs: List[Tuple[str, Arg]] = []
        while self._at_argument():
            kw: Optional[str] = None
            if (self.peek()[0] == "word"
                    and self.toks[self.i + 1][1] == ":"):
                kw = self.take()[1]
                self.take()  # ':'
            val_tok = self._argument()
            if kw is None:
                args.append(val_tok)
            else:
                kwargs.append((kw, val_tok))
        return (Call(val, tuple(args), tuple(kwargs)),)

    def _at_argument(self) -> bool:
        kind, val = self.peek()
        return (kind in ("word", "string") or val == "(")

    def _argument(self) -> Arg:
        kind, val = self.take()
        if val == "(":
            pipe = self.pipeline()
            self.expect(")")
            return pipe
        if kind == "string":
            return val[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        if val in ("true", "false"):
            return val == "true"
        # Digit-based number rule like the reference PEG — NOT bare
        # float(), which also accepts "inf"/"nan"/"1_000" and would turn
        # identifier/pattern arguments into numbers.
        if _NUMBER.fullmatch(val):
            return float(val)
        return val  # pattern / identifier argument


def parse(src: str) -> Script:
    """Parse an m3ql script into (macros, pipeline)."""
    return _Parser(_tokenize(src)).script()
