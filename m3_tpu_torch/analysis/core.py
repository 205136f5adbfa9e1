"""m3lint core: AST-based static analysis scaffolding for the PyTorch
port's invariants (m3_tpu_torch/; the counterpart of
m3_tpu/analysis/core.py, which lints the JAX package).

A Rule walks one parsed Module and yields Findings (rule id, severity,
file:line, message). The runner walks a file tree, applies every rule
whose directory scope matches, and filters findings suppressed by
`# m3lint: disable=<rule>` comments:

  x = risky()  # m3lint: disable=rule-id      (this line)
  # m3lint: disable=rule-id                   (next line)
  # m3lint: disable-file=rule-id              (whole file)

Rule ids are comma-separable; `all` disables every rule. Suppressions
are deliberate, reviewed exceptions — each should carry a justification
comment, and the tier-1 gate (tests/test_torch_static_analysis.py) keeps
the port's tree at zero non-suppressed findings.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import tokenize
from io import StringIO
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding", "Module", "Rule", "iter_modules", "run_paths",
    "qualname", "decorator_call_name", "annotation_names",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.severity}] {self.rule}: {self.message}"


# The package whose tree the analyzer scopes by (Module.scope_parts) and
# names modules after (callgraph.module_dotted).
PACKAGE = "m3_tpu_torch"

_DISABLE_RE = re.compile(
    r"#\s*m3lint:\s*disable(?P<scope>-file)?\s*=\s*(?P<rules>[\w\-, ]+)")


class Module:
    """One parsed source file plus everything rules repeatedly need:
    the AST with parent links, per-line suppression sets, and the set of
    top-level import names (for cheap "does this module use torch" scoping)."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.line_suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self._collect_suppressions()
        self.imports = self._collect_imports()

    @classmethod
    def from_source(cls, source: str, relpath: str = "m3_tpu_torch/mod.py") -> "Module":
        return cls(relpath, relpath, source)

    @property
    def parts(self) -> Tuple[str, ...]:
        return pathlib.PurePosixPath(self.relpath.replace("\\", "/")).parts

    @property
    def scope_parts(self) -> Tuple[str, ...]:
        """Path segments used for Rule.dirs scoping: everything after the
        LAST `m3_tpu_torch` segment when the path contains one, so an
        absolute checkout path like /tmp/msg/proj/m3_tpu_torch/query/x.py
        scopes by ('query', 'x.py') — ancestor directory names outside the
        package must not trip directory-scoped rules."""
        parts = self.parts
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == PACKAGE:
                return parts[i + 1:]
        return parts

    def _collect_suppressions(self):
        # tokenize (not line regex) so a disable marker inside a string
        # literal is not honored as a suppression
        try:
            tokens = tokenize.generate_tokens(StringIO(self.source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):
            comments = [(i + 1, line) for i, line in enumerate(self.lines)
                        if "#" in line]
        for lineno, text in comments:
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
            if m.group("scope"):
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(lineno, set()).update(rules)

    def _collect_imports(self) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    names.add(a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        return names

    def suppressed(self, finding: Finding) -> bool:
        for rules in (self.file_suppressions,
                      self.line_suppressions.get(finding.line, ())):
            if rules and ("all" in rules or finding.rule in rules):
                return True
        # a STANDALONE disable comment suppresses the line below it; a
        # trailing comment on a code line must not bleed onto the next
        prev = self.line_suppressions.get(finding.line - 1)
        if prev and ("all" in prev or finding.rule in prev):
            idx = finding.line - 2
            if 0 <= idx < len(self.lines) and \
                    self.lines[idx].lstrip().startswith("#"):
                return True
        return False

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


class Rule:
    """Base rule: subclasses set `id`, `severity`, an optional `dirs`
    scope (directory names any of which must appear in the module path;
    None = every module) and implement check()."""

    id: str = ""
    severity: str = "error"
    dirs: Optional[Tuple[str, ...]] = None
    requires_import: Optional[str] = None  # e.g. "torch"

    def applies(self, mod: Module) -> bool:
        if self.requires_import and self.requires_import not in mod.imports:
            return False
        if self.dirs is None:
            return True
        return any(d in mod.scope_parts for d in self.dirs)

    def check(self, mod: Module) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, mod: Module, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, mod.relpath, getattr(node, "lineno", 1),
                       message, self.severity)


# --------------------------------------------------------------- AST helpers


def qualname(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain ('functools.lru_cache',
    'self._lock'); None for anything that isn't a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def decorator_call_name(dec: ast.AST) -> Optional[str]:
    """Name of a decorator ignoring its call parens: @x.y(...) -> 'x.y'."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    return qualname(dec)


_CACHE_DECORATORS = {
    "functools.lru_cache", "lru_cache", "functools.cache", "cache",
}


def is_cache_decorator(dec: ast.AST) -> bool:
    return decorator_call_name(dec) in _CACHE_DECORATORS


def annotation_names(ann: Optional[ast.AST]) -> Set[str]:
    """Every dotted/plain type name appearing anywhere in an annotation,
    including string annotations and unions/subscripts."""
    if ann is None:
        return set()
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return set()
    names: Set[str] = set()
    for node in ast.walk(ann):
        q = qualname(node)
        if q:
            names.add(q)
            names.add(q.split(".")[-1])
    return names


def func_params(fn: ast.FunctionDef) -> List[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


def index_functions(mod: Module) -> Dict[str, ast.FunctionDef]:
    """All function defs in the module keyed by bare name (nested included;
    outermost wins on collision so module-level defs shadow inner helpers)."""
    out: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


# ------------------------------------------------------------------- runner


def _registry() -> List[Rule]:
    from . import (batch_rules, cache_rules, device_rules, diskio_rules,
                   hbm_rules, lifecycle_rules, lock_rules, numeric_rules,
                   obs_rules, overload_rules, render_rules, replay_rules,
                   retry_rules)

    return [
        *cache_rules.RULES,
        *diskio_rules.RULES,
        *device_rules.RULES,
        *lock_rules.RULES,
        *batch_rules.RULES,
        *retry_rules.RULES,
        *overload_rules.RULES,
        *hbm_rules.RULES,
        *obs_rules.RULES,
        *replay_rules.RULES,
        *render_rules.RULES,
        *lifecycle_rules.RULES,
        *numeric_rules.RULES,
    ]


def all_rules() -> List[Rule]:
    return _registry()


def program_registry() -> List:
    """Whole-program rules: run ONCE per tree walk over the
    ProgramIndex (never per module, never in a --jobs worker)."""
    from . import callgraph, device_rules, race_rules

    return [callgraph.CrossModuleLockOrderRule(),
            device_rules.CapturePurityRule(),
            race_rules.SharedStateRaceRule()]


def _iter_files(paths: Sequence[str]) -> Iterator[Tuple[pathlib.Path, str]]:
    """(path, display-relpath) for every .py under `paths`, deduplicated
    by resolved path so overlapping arguments analyze each file once."""
    seen: Set[str] = set()
    for p in paths:
        root = pathlib.Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            try:
                resolved = f.resolve()
            except OSError:
                resolved = f
            key = str(resolved)
            if key in seen:
                continue
            seen.add(key)
            try:
                rel = resolved.relative_to(pathlib.Path.cwd()).as_posix()
            except ValueError:
                rel = f.as_posix()
            yield f, rel


def iter_modules(paths: Sequence[str]) -> Iterator[Module]:
    for f, rel in _iter_files(paths):
        yield Module(str(f), rel, f.read_text(encoding="utf-8"))


def run_module(mod: Module, rules: Optional[Iterable[Rule]] = None,
               timings: Optional[Dict[str, float]] = None,
               ) -> Tuple[List[Finding], int]:
    """(non-suppressed findings, suppressed count) for one module.
    With `timings`, per-rule wall time accumulates into it keyed by
    rule id (the CLI's --stats source)."""
    import time as _time

    findings: List[Finding] = []
    suppressed = 0
    for rule in (rules if rules is not None else _registry()):
        t0 = _time.perf_counter() if timings is not None else 0.0
        if rule.applies(mod):
            for f in rule.check(mod):
                if mod.suppressed(f):
                    suppressed += 1
                else:
                    findings.append(f)
        if timings is not None:
            timings[rule.id] = timings.get(rule.id, 0.0) + \
                (_time.perf_counter() - t0)
    return findings, suppressed


def run_program(modules: Sequence[Module], program_rules=None,
                timings: Optional[Dict[str, float]] = None,
                ) -> Tuple[List[Finding], int]:
    """(non-suppressed findings, suppressed count) from the whole-program
    rules over an already-parsed module set. Suppressions are honored
    against the module each finding is attributed to. With `timings`,
    per-rule wall time accumulates into it keyed by rule id (the same
    contract as run_module, so --stats covers program rules too)."""
    import time as _time

    from .callgraph import ProgramIndex

    rules = list(program_rules) if program_rules is not None \
        else program_registry()
    if not rules:
        return [], 0
    index = ProgramIndex(modules)
    by_relpath = {m.relpath: m for m in modules}
    findings: List[Finding] = []
    suppressed = 0
    for rule in rules:
        t0 = _time.perf_counter() if timings is not None else 0.0
        for f in rule.check_program(index):
            mod = by_relpath.get(f.path)
            if mod is not None and mod.suppressed(f):
                suppressed += 1
            else:
                findings.append(f)
        if timings is not None:
            timings[rule.id] = timings.get(rule.id, 0.0) + \
                (_time.perf_counter() - t0)
    return findings, suppressed


def run_paths(paths: Sequence[str], rules: Optional[Iterable[Rule]] = None,
              program_rules=None,
              ) -> Tuple[List[Finding], int, int]:
    """(findings, suppressed count, module count) across a file tree:
    every per-module rule on each file, then the whole-program rules
    (cross-module lock graph, cross-module taint) once over the full
    index. Unparseable files surface as a finding (the tree gate must
    not skip them silently)."""
    rules = list(rules) if rules is not None else _registry()
    findings: List[Finding] = []
    modules: List[Module] = []
    suppressed = nmods = 0
    for f, rel in _iter_files(paths):
        try:
            mod = Module(str(f), rel, f.read_text(encoding="utf-8"))
        except SyntaxError as e:
            findings.append(Finding("parse-error", rel, e.lineno or 1,
                                    f"file does not parse: {e.msg}"))
            continue
        except OSError as e:
            findings.append(Finding("parse-error", rel, 1,
                                    f"file not readable: {e}"))
            continue
        nmods += 1
        modules.append(mod)
        got, sup = run_module(mod, rules)
        findings.extend(got)
        suppressed += sup
    got, sup = run_program(modules, program_rules)
    findings.extend(got)
    suppressed += sup
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed, nmods
