"""CLI: python -m m3_tpu_torch.analysis [paths...] [--jobs N] [--stats]

Exit status 0 only when every analyzed file is clean (no non-suppressed
findings); 1 otherwise. `--list-rules` prints the rule catalog.

Scaling knobs (the check_all lint tier's <5s contract on the grown
tree):

  --jobs N     process-parallel per-file analysis (N=0 -> cpu count).
               Per-MODULE rules fan out across workers; the whole-
               program stage (cross-module lock graph, cross-module
               taint) runs once in the parent over an index built once.
  cache        per-file findings cache (.m3lint_torch_cache.json in the
               working directory; the JAX package's analyzer keeps its
               own .m3lint_cache.json), keyed on the file's content hash AND
               a digest of the analyzer's own sources — editing any
               rule invalidates everything, editing one file re-checks
               only that file. Whole-program findings are cached
               against the digest of the full (path, hash) set.
               --no-cache disables both reads and writes.
  --stats      per-rule cumulative timing, slowest first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

from .core import (Finding, Module, _iter_files, all_rules,
                   program_registry, run_module, run_program)

_CACHE_FILE = ".m3lint_torch_cache.json"
_CACHE_VERSION = 1


def _rules_digest() -> str:
    """Digest of the analyzer's own sources AND data files (the
    lock-free ledger is an input to the race family): any rule or
    ledger edit invalidates the cache wholesale."""
    h = hashlib.sha1()
    pkg = pathlib.Path(__file__).parent
    for pat in ("*.py", "*.txt"):
        for p in sorted(pkg.glob(pat)):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _finding_to_row(f: Finding) -> list:
    return [f.rule, f.path, f.line, f.message, f.severity]


def _row_to_finding(row) -> Finding:
    return Finding(*row)


@dataclasses.dataclass
class _FileResult:
    rel: str
    content_hash: str
    findings: List[list]
    suppressed: int
    timings: Dict[str, float]


def _analyze_source(path: str, rel: str, source: str,
                    content_hash: str) -> _FileResult:
    timings: Dict[str, float] = {}
    try:
        mod = Module(path, rel, source)
    except SyntaxError as e:
        return _FileResult(rel, content_hash, [
            ["parse-error", rel, e.lineno or 1,
             f"file does not parse: {e.msg}", "error"]], 0, timings)
    findings, suppressed = run_module(mod, _RULES, timings=timings)
    return _FileResult(rel, content_hash,
                       [_finding_to_row(f) for f in findings],
                       suppressed, timings)


_RULES = None


def _worker_init():
    global _RULES
    _RULES = all_rules()


def _worker_run(args: Tuple[str, str, str, str]) -> _FileResult:
    # the parent already read and hashed the file: analyzing the SAME
    # bytes it indexed keeps the per-file results, the whole-program
    # stage, and the cache entry consistent even if the file changes
    # mid-run (and avoids a second read+hash per file)
    path, rel, source, content_hash = args
    return _analyze_source(path, rel, source, content_hash)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m m3_tpu_torch.analysis",
        description="m3lint: repo-native static analysis")
    ap.add_argument("paths", nargs="*", default=["m3_tpu_torch"],
                    help="files or directories to analyze "
                         "(default: m3_tpu_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="worker processes for per-file analysis "
                         "(0 = cpu count; default 1)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-rule cumulative timing")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the findings cache")
    args = ap.parse_args(argv)

    global _RULES
    _RULES = rules = all_rules()
    if args.list_rules:
        for r in rules:
            doc = ((r.__doc__ or "").strip().splitlines() or [""])[0]
            print(f"{r.id:28s} [{r.severity}] {doc}")
        for r in program_registry():
            doc = ((r.__doc__ or "").strip().splitlines() or [""])[0]
            print(f"{r.id:28s} [{r.severity}] (whole-program) {doc}")
        return 0

    t_start = time.perf_counter()
    files = list(_iter_files(args.paths or ["m3_tpu_torch"]))
    rules_digest = _rules_digest()

    cache: dict = {}
    cache_path = pathlib.Path(_CACHE_FILE)
    if not args.no_cache and cache_path.exists():
        try:
            raw = json.loads(cache_path.read_text(encoding="utf-8"))
            if raw.get("version") == _CACHE_VERSION and \
                    raw.get("rules") == rules_digest:
                cache = raw.get("files", {})
        except (OSError, ValueError):
            cache = {}

    # ---------------------------------------------------- per-file stage
    sources: Dict[str, Tuple[str, str, str]] = {}  # rel -> (path, hash, src)
    results: Dict[str, _FileResult] = {}
    misses: List[Tuple[str, str, str, str]] = []
    hits = 0
    for f, rel in files:
        try:
            source = pathlib.Path(f).read_text(encoding="utf-8")
        except OSError as e:
            results[rel] = _FileResult(rel, "", [
                ["parse-error", rel, 1, f"file not readable: {e}",
                 "error"]], 0, {})
            continue
        h = hashlib.sha1(source.encode("utf-8", "surrogatepass")).hexdigest()
        sources[rel] = (str(f), h, source)
        entry = cache.get(rel)
        if entry is not None and entry.get("hash") == h:
            results[rel] = _FileResult(rel, h, entry["findings"],
                                       entry["suppressed"], {})
            hits += 1
        else:
            misses.append((str(f), rel, source, h))

    jobs = args.jobs if args.jobs > 0 else (os.cpu_count() or 1)
    if misses:
        if jobs > 1 and len(misses) > 1:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=min(jobs, len(misses)),
                    initializer=_worker_init) as ex:
                for res in ex.map(_worker_run, misses,
                                  chunksize=max(1, len(misses) // jobs)):
                    results[res.rel] = res
        else:
            for path_rel in misses:
                res = _worker_run(path_rel)
                results[res.rel] = res

    findings: List[Finding] = []
    suppressed = 0
    timings: Dict[str, float] = {}
    nmods = 0
    for rel in sorted(results):
        res = results[rel]
        if res.content_hash:
            nmods += 1
        findings.extend(_row_to_finding(r) for r in res.findings)
        suppressed += res.suppressed
        for k, v in res.timings.items():
            timings[k] = timings.get(k, 0.0) + v

    # ------------------------------------------------ whole-program stage
    tree_digest = hashlib.sha1(json.dumps(
        sorted((rel, h) for rel, (_p, h, _s) in sources.items())
    ).encode()).hexdigest()
    # digest-keyed map so a subset invocation's program entry does not
    # evict the full-tree one (bounded below)
    prog_cache = cache.get("__program__") \
        if isinstance(cache.get("__program__"), dict) else {}
    entry = prog_cache.pop(tree_digest, None)  # pop: re-inserted LAST
    t_prog = time.perf_counter()               # below, so a hit
    if entry is not None:                      # refreshes recency
        prog_rows = entry["findings"]
        prog_suppressed = entry["suppressed"]
        findings.extend(_row_to_finding(r) for r in prog_rows)
        suppressed += prog_suppressed
    else:
        modules = []
        for rel, (path, _h, source) in sources.items():
            try:
                modules.append(Module(path, rel, source))
            except SyntaxError:
                continue  # already surfaced as parse-error per-file
        prog_findings, prog_suppressed = run_program(modules,
                                                     timings=timings)
        prog_rows = [_finding_to_row(f) for f in prog_findings]
        findings.extend(prog_findings)
        suppressed += prog_suppressed
    timings["(whole-program)"] = time.perf_counter() - t_prog

    if not args.no_cache:
        # MERGE into the loaded cache (same rules digest) rather than
        # replacing it: a targeted single-file invocation must not
        # destroy the full-tree warm cache the check_all tier relies on
        # prune entries whose file is gone (renames/deletes would
        # otherwise accumulate until the next rules-digest reset)
        merged = {rel: entry for rel, entry in cache.items()
                  if rel != "__program__"
                  and (rel in sources or os.path.exists(rel))}
        merged.update({
            rel: {"hash": res.content_hash,
                  "findings": res.findings,
                  "suppressed": res.suppressed}
            for rel, res in results.items() if res.content_hash
        })
        prog_entries = dict(prog_cache)
        prog_entries[tree_digest] = {"findings": prog_rows,
                                     "suppressed": prog_suppressed}
        while len(prog_entries) > 4:  # bound subset-run accumulation
            prog_entries.pop(next(iter(prog_entries)))
        merged["__program__"] = prog_entries
        payload = {
            "version": _CACHE_VERSION,
            "rules": rules_digest,
            "files": merged,
        }
        tmp = cache_path.with_suffix(f".tmp{os.getpid()}")
        try:
            tmp.write_text(json.dumps(payload), encoding="utf-8")
            os.replace(tmp, cache_path)
        except OSError:
            pass  # a read-only tree still lints, just uncached

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    for f in findings:
        print(f.render())
    wall = time.perf_counter() - t_start
    print(f"m3lint: {len(findings)} finding(s), {suppressed} suppressed, "
          f"{nmods} file(s) analyzed ({hits} cached) in {wall:.2f}s "
          f"[jobs={jobs}]")
    if args.stats:
        print("per-rule cumulative time (uncached files only):")
        for k, v in sorted(timings.items(), key=lambda kv: -kv[1]):
            print(f"  {k:30s} {v * 1000:8.1f} ms")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
