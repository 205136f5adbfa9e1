"""The runtime witnesses held to the static model: the port's counterparts
of the reference's scripts/lockdep_check.py, scripts/race_check.py and
scripts/numerics_check.py, with the same contracts and exit codes.

Usage: python -m m3_tpu_torch.analysis.witness {lockdep,race,numerics}
           <dump-dir-or-files...> [--verbose]

lockdep   Loads every `lockdep-*.json` dump (utils/lockdep.py, one per
          witnessed process) and unions the witnessed acquisition-order
          graphs. (1) ZERO witnessed cycles, per process and over the
          union of the dumps (an ABBA split across processes closes only
          there); hierarchy self-edges stay exempt. (2) Every witnessed
          edge is in the STATIC cross-module lock graph
          (analysis/callgraph.py over m3_tpu_torch/, closed transitively:
          the witness records the innermost held lock, the analyzer every
          held pair) or reconciled in analysis/lockdep_reconcile.txt with
          a reason. Exit 0 green; 1 on an unreconciled edge (or no dump);
          2 on a cycle.
race      Loads every `racewatch-*.json` dump (utils/racewatch.py). (1)
          The witness observed shared state, and some attribute from two
          or more threads: a vacuous run is refused. (2) Every witnessed
          cross-thread pair with a write that shares no lock is on the
          lock-free ledger (analysis/lockfree_ledger.txt). (3) A
          lock-protected pair's common locks include the static
          protection model's lock for that attribute
          (race_rules.protection_model). Exit 0 green; 1 on an undeclared
          racy pair or a model mismatch; 2 on a vacuous run.
numerics  Loads every `numerics-*.json` dump (utils/numwatch.py). (1) The
          witness observed result planes (a vacuous pass is refused). (2)
          Every witnessed (site, kind) is in the static pass's accepted
          set (numeric_rules.accepted_witness, derived from the AST of the
          sites' modules). (3) The padding kinds are never accepted. Exit
          0 green; 1 on an unaccepted finding; 2 on a padding-contract
          violation or a vacuous run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional, Set, Tuple

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
RECONCILE = pathlib.Path(__file__).resolve().parent / "lockdep_reconcile.txt"
_PAD_KINDS = ("pad-finite", "pad-nonzero")


def load_dumps(paths, pattern: str) -> List[Tuple[str, dict]]:
    """(file, payload) for every dump file named, or matching `pattern`
    in a directory named."""
    files = []
    for p in paths:
        pp = pathlib.Path(p)
        if pp.is_dir():
            files.extend(sorted(pp.glob(pattern)))
        else:
            files.append(pp)
    dumps = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            dumps.append((str(f), json.load(fh)))
    return dumps


# --------------------------------------------------------------- lockdep


def load_reconcile(path: Optional[pathlib.Path] = None
                   ) -> Dict[Tuple[str, str], str]:
    """{(from, to): reason} from the reconciliation ledger."""
    p = path if path is not None else RECONCILE
    out: Dict[Tuple[str, str], str] = {}
    if not p.exists():
        return out
    for raw in p.read_text(encoding="utf-8").splitlines():
        line = raw.split("#", 1)[0].strip()
        reason = raw.split("#", 1)[1].strip() if "#" in raw else ""
        if not line or "->" not in line:
            continue
        a, b = (s.strip() for s in line.split("->", 1))
        out[(a, b)] = reason
    return out


def static_lock_graph(root=PACKAGE_DIR) -> Tuple[Set[Tuple[str, str]],
                                                 Dict[str, str]]:
    """(transitively closed static lock edges, lock kinds) of the tree at
    `root`."""
    from .callgraph import ProgramIndex
    from .core import iter_modules

    idx = ProgramIndex(list(iter_modules([str(root)])))
    edges = set(idx.lock_edges())
    adj: Dict[str, Set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    closed = set(edges)
    changed = True
    while changed:
        changed = False
        for a in list(adj):
            for b in list(adj.get(a, ())):
                for c in list(adj.get(b, ())):
                    if (a, c) not in closed:
                        closed.add((a, c))
                        adj.setdefault(a, set()).add(c)
                        changed = True
    return closed, idx.lock_kinds()


def union_cycle(witnessed) -> Optional[List[str]]:
    """One cycle over the UNION of the witnessed edges (self-edges
    exempt), or None."""
    adj: Dict[str, Set[str]] = {}
    for a, b in witnessed:
        if a != b:
            adj.setdefault(a, set()).add(b)
    white, grey, black = 0, 1, 2
    color = {n: white for n in adj}

    def dfs(start):
        stack = [(start, iter(sorted(adj.get(start, ()))))]
        path = [start]
        color[start] = grey
        while stack:
            node, it = stack[-1]
            for nxt in it:
                if color.get(nxt, white) == grey:
                    return path[path.index(nxt):] + [nxt]
                if color.get(nxt, white) == white:
                    color[nxt] = grey
                    path.append(nxt)
                    stack.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    break
            else:
                color[node] = black
                path.pop()
                stack.pop()
        return None

    for n in sorted(adj):
        if color[n] == white:
            got = dfs(n)
            if got is not None:
                return got
    return None


def witnessed_edges(dumps) -> Tuple[Dict[Tuple[str, str], dict],
                                    List[Tuple[str, list]], int]:
    """(edge -> {count, blocked, blocked_s, max_s, site}, per-process
    cycles, most nodes in one dump) over every dump; an edge's block
    times come from the dumps' `block_times` (seconds parked on contended
    acquires)."""
    witnessed: Dict[Tuple[str, str], dict] = {}
    cycles: List[Tuple[str, list]] = []
    nodes = 0
    for src, d in dumps:
        nodes = max(nodes, len(d.get("nodes", {})))
        for c in d.get("cycles", []):
            cycles.append((src, c))
        for e in d.get("edges", []):
            cur = witnessed.setdefault(
                (e["from"], e["to"]),
                {"count": 0, "blocked": 0, "blocked_s": 0.0, "max_s": 0.0,
                 "site": e.get("site", "?")})
            cur["count"] += e.get("count", 1)
            cur["blocked"] += e.get("blocked", 0)
        for t in d.get("block_times", []):
            cur = witnessed.get((t["from"], t["to"]))
            if cur is not None:
                cur["blocked_s"] += t["total_s"]
                cur["max_s"] = max(cur["max_s"], t["max_s"])
    return witnessed, cycles, nodes


def block_times(dumps) -> Dict[Tuple[str, str], List[float]]:
    """(held, acquired) -> [parks, seconds, longest park] over every
    dump; "-" as held stands for an acquire that parked holding
    nothing."""
    out: Dict[Tuple[str, str], List[float]] = {}
    for _src, d in dumps:
        for t in d.get("block_times", []):
            cur = out.setdefault((t["from"], t["to"]), [0, 0.0, 0.0])
            cur[0] += t["parks"]
            cur[1] += t["total_s"]
            cur[2] = max(cur[2], t["max_s"])
    return out


def longest_blocked(times, n: int = 5):
    """The n pairs of `block_times` with the most seconds parked, longest
    first: (held, acquired, parks, seconds, longest park)."""
    rows = [(a, b, parks, secs, mx) for (a, b), (parks, secs, mx)
            in times.items()]
    return sorted(rows, key=lambda r: -r[3])[:n]


def lockdep_check(paths, verbose: bool = False, root=PACKAGE_DIR,
                  reconcile_path: Optional[pathlib.Path] = None) -> int:
    dumps = load_dumps(paths, "lockdep-*.json")
    if not dumps:
        print("lockdep: NO dumps found — the witness never ran "
              "(M3_TPU_LOCKDEP not set, or the run crashed before exit)")
        return 1
    witnessed, cycles, nodes = witnessed_edges(dumps)
    print(f"lockdep: {len(dumps)} dump(s), {nodes} witnessed lock(s), "
          f"{len(witnessed)} edge(s), "
          f"{sum(v['blocked'] for v in witnessed.values())} contended "
          "acquisition(s)")
    cyc = union_cycle(witnessed)
    if cyc is not None:
        cycles.append(("union-of-dumps", cyc))
    if cycles:
        print(f"FAIL: {len(cycles)} witnessed lock cycle(s):")
        for src, c in cycles:
            print(f"  {' -> '.join(c)}   [{src}]")
        return 2
    static, _kinds = static_lock_graph(root)
    reconcile = load_reconcile(reconcile_path)
    misses = [(a, b, info) for (a, b), info in sorted(witnessed.items())
              if (a, b) not in static and (a, b) not in reconcile]
    used = [k for k in reconcile if k in witnessed]
    if verbose:
        for (a, b), info in sorted(witnessed.items()):
            mark = "static" if (a, b) in static else \
                "reconciled" if (a, b) in reconcile else "MISS"
            print(f"  {a} -> {b}  x{info['count']} (blocked "
                  f"{info['blocked']}, {info['blocked_s']!r} s, longest "
                  f"{info['max_s']!r} s, {info['site']}) [{mark}]")
    if misses:
        print(f"FAIL: {len(misses)} witnessed edge(s) absent from the "
              "static lock graph and not reconciled — either improve "
              "analysis/callgraph.py's typing or add the edge to "
              "m3_tpu_torch/analysis/lockdep_reconcile.txt with a reason:")
        for a, b, info in misses:
            print(f"  {a} -> {b}   # first seen {info['site']}, "
                  f"x{info['count']}")
        return 1
    print(f"lockdep: GREEN — zero cycles, every witnessed edge in the "
          f"static graph ({len(witnessed) - len(used)}) or reconciled "
          f"({len(used)})")
    return 0


# ------------------------------------------------------------------ race


def race_check(paths, root=PACKAGE_DIR,
               ledger: Optional[Dict[str, str]] = None) -> int:
    from . import race_rules

    dumps = load_dumps(paths, "racewatch-*.json")
    if not dumps:
        print("race: NO witness dumps found — was M3_TPU_RACEWATCH=1 / "
              "M3_TPU_RACEWATCH_OUT set?")
        return 2
    observed = 0
    cross_thread = 0
    entries = []
    for path, payload in dumps:
        n = int(payload.get("observed", 0))
        attrs = payload.get("attrs", [])
        observed += n
        xt = [a for a in attrs if a.get("threads", 0) >= 2]
        cross_thread += len(xt)
        entries.extend(attrs)
        print(f"{path}: observed {n} profile(s) on {len(attrs)} attr(s), "
              f"{len(xt)} attr(s) cross-thread")
    if observed == 0:
        print("race: witness observed ZERO instrumented accesses — the "
              "descriptors never fired (vacuous pass refused)")
        return 2
    if cross_thread == 0:
        print("race: no instrumented attribute was touched from two "
              "threads — the run never exercised shared state (vacuous "
              "pass refused)")
        return 2
    ledger = ledger if ledger is not None else race_rules.load_ledger()
    model = race_rules.protection_model(str(root))
    print(f"ledger: {len(ledger)} declared protocol(s); static protection "
          f"model: {len(model)} attr(s)")
    undeclared = []
    mismatched = []
    for entry in entries:
        ident = entry["attr"]
        for a, b in entry.get("racy", []):
            if ident not in ledger:
                undeclared.append((ident, a, b))
        if ident not in model:
            continue
        inferred = set(model[ident])
        profiles = entry.get("profiles", [])
        for i, a in enumerate(profiles):
            for b in profiles[i + 1:]:
                if a["thread"] == b["thread"] or \
                        not (a["write"] or b["write"]):
                    continue
                common = set(a["locks"]) & set(b["locks"])
                if common and not (common & inferred):
                    mismatched.append((ident, sorted(common),
                                       sorted(inferred)))
    for ident, a, b in undeclared:
        print(f"UNDECLARED RACY PAIR: {ident}: thread {a['thread']} "
              f"(locks {a['locks']}, write={a['write']}) vs thread "
              f"{b['thread']} (locks {b['locks']}, write={b['write']}) "
              "share no lock and the attr is not on "
              "analysis/lockfree_ledger.txt")
    for ident, common, inferred in mismatched:
        print(f"PROTECTION MODEL MISMATCH: {ident}: witnessed common "
              f"lock(s) {common} do not include the statically inferred "
              f"protecting lock(s) {inferred}")
    if undeclared or mismatched:
        return 1
    declared = sorted({e["attr"] for e in entries if e.get("racy")})
    print(f"race: OK — {observed} profile(s) across {len(dumps)} "
          f"process(es), {cross_thread} cross-thread attr observation(s); "
          f"ledger-blessed racy attrs: {declared or 'none'}")
    return 0


# -------------------------------------------------------------- numerics


def numerics_check(paths, root=PACKAGE_DIR) -> int:
    from ..utils import numwatch
    from . import numeric_rules

    dumps = load_dumps(paths, "numerics-*.json")
    if not dumps:
        print("numerics: NO witness dumps found — was M3_TPU_NUMERICS=1 / "
              "M3_TPU_NUMERICS_OUT set?")
        return 2
    observed = 0
    witnessed = []
    for path, payload in dumps:
        n = int(payload.get("observed", 0))
        got = payload.get("findings", [])
        observed += n
        witnessed.extend(got)
        print(f"{path}: observed {n} plane(s), {len(got)} finding kind(s)")
    if observed == 0:
        print("numerics: witness observed ZERO result planes — the hooks "
              "never fired (vacuous pass refused)")
        return 2
    accepted = numeric_rules.accepted_witness(str(root))
    print(f"static accepted set: {sorted(accepted)}")
    hard = [f for f in witnessed if f["kind"] in _PAD_KINDS]
    soft = [f for f in numwatch.unaccepted(witnessed, accepted)
            if f["kind"] not in _PAD_KINDS]
    for f in hard:
        print(f"PADDING CONTRACT VIOLATION: site={f['site']} "
              f"kind={f['kind']} x{f['count']}: {f['detail']}")
    for f in soft:
        print(f"UNACCEPTED: site={f['site']} kind={f['kind']} "
              f"x{f['count']}: {f['detail']} — not in the static pass's "
              "accepted set")
    if hard:
        return 2
    if soft:
        return 1
    kinds = sorted({(f["site"], f["kind"]) for f in witnessed})
    print(f"numerics: OK — {observed} plane(s) observed across "
          f"{len(dumps)} process(es); witnessed kinds {kinds} ⊆ accepted")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m m3_tpu_torch.analysis.witness",
        description="hold the runtime witnesses' dumps to the static model")
    ap.add_argument("check", choices=("lockdep", "race", "numerics"))
    ap.add_argument("paths", nargs="+", help="dump directories or files")
    ap.add_argument("--verbose", action="store_true",
                    help="lockdep: list every witnessed edge")
    args = ap.parse_args(argv)
    if args.check == "lockdep":
        return lockdep_check(args.paths, verbose=args.verbose)
    if args.check == "race":
        return race_check(args.paths)
    return numerics_check(args.paths)


if __name__ == "__main__":
    sys.exit(main())
