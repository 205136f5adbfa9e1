"""Randomized inverted-index campaign on the port: the fuzz tier of
m3_tpu_torch/index (counterpart of scripts/fuzz_index.py).

Each round builds a random document set (wide alphabets, missing fields,
duplicate tag shapes; the reference campaign's draws for the same seed)
and checks every path that serves a boolean query against a brute-force
evaluator over the raw tags:

  mutable     MutableSegment search (the live write path), after a
              re-insert of a sample of its documents (insert's dedup);
  immutable   ImmutableSegment.from_mutable (the sealed read path);
  merged      ImmutableSegment.merge of an OVERLAPPING random split (the
              same document reaches the merge from both parts);
  persisted   index/persist write_segment -> read_segment.

Queries are random trees of term, regexp, conjunction, disjunction and
negation up to depth 3. A failure raises AssertionError naming the path.
The index is host code (numpy): the campaign runs no kernel, but it
resolves its device like every entry point of this package.

Usage:  python -m m3_tpu_torch.scripts.fuzz_index --rounds 300
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
import time

import numpy as np

from ..device import resolve
from ..index import persist as ipersist
from ..index import query as iq
from ..index.segment import Document, ImmutableSegment, MutableSegment, execute
from ..ops import kernel_launches
from . import device_arg, launches_since

FIELDS = [b"a", b"b", b"c", b"host", b"__name__"]
VALUES = [b"x", b"y", b"z", b"xx", b"web-1", b"web-2", b"", b"cpu.total"]
PATTERNS = [b"x|y", b"[yz]", b".*", b"web-.*", b"x+", b"(?:xx|z)", b"cpu\\..*"]
PATHS = ("mutable", "immutable", "merged", "persisted")


def rand_docs(rng, n):
    docs = []
    for i in range(n):
        tags = {}
        for f in FIELDS:
            if rng.random() < 0.6:
                tags[f] = VALUES[rng.integers(len(VALUES))]
        docs.append((b"doc-%d" % i, tags))
    return docs


def rand_query(rng, depth=0):
    kinds = (["term", "term", "regexp", "conj", "disj", "neg", "all"]
             if depth < 3 else ["term", "regexp"])
    kind = kinds[rng.integers(len(kinds))]
    if kind == "all":
        return iq.AllQuery()
    if kind == "term":
        return iq.new_term(FIELDS[rng.integers(len(FIELDS))],
                           VALUES[rng.integers(len(VALUES))])
    if kind == "regexp":
        return iq.new_regexp(FIELDS[rng.integers(len(FIELDS))],
                             PATTERNS[rng.integers(len(PATTERNS))])
    if kind == "neg":
        return iq.new_negation(rand_query(rng, depth + 1))
    parts = [rand_query(rng, depth + 1)
             for _ in range(int(rng.integers(1, 4)))]
    return (iq.new_conjunction(*parts) if kind == "conj"
            else iq.new_disjunction(*parts))


def brute(q, tags) -> bool:
    if isinstance(q, iq.AllQuery):
        return True
    if isinstance(q, iq.TermQuery):
        return tags.get(q.field) == q.value
    if isinstance(q, iq.RegexpQuery):
        v = tags.get(q.field)
        return v is not None and re.fullmatch(q.pattern, v) is not None
    if isinstance(q, iq.ConjunctionQuery):
        return all(brute(p, tags) for p in q.queries)
    if isinstance(q, iq.DisjunctionQuery):
        return any(brute(p, tags) for p in q.queries)
    if isinstance(q, iq.NegationQuery):
        return not brute(q.query, tags)
    raise AssertionError(q)


def _segment(docs) -> MutableSegment:
    seg = MutableSegment()
    for sid, tags in docs:
        seg.insert(Document(sid, tuple(sorted(tags.items()))))
    return seg


def run_round(rng, root, queries_per_round=12) -> int:
    n = int(rng.integers(1, 400))
    docs = rand_docs(rng, n)
    mseg = _segment(docs)
    for sid, tags in docs[: max(1, n // 10)]:
        mseg.insert(Document(sid, tuple(sorted(tags.items()))))
    if len(mseg) != n:
        raise AssertionError("mutable: a duplicate insert changed the doc "
                             "count")
    iseg = ImmutableSegment.from_mutable(mseg)
    # an OVERLAPPING split: the same document reaches the merge twice
    cut = int(rng.integers(0, n + 1))
    overlap = int(rng.integers(0, min(8, n) + 1))
    parts = [ImmutableSegment.from_mutable(ms) for ms in (
        _segment(docs[: min(n, cut + overlap)]), _segment(docs[cut:]))
        if len(ms)]
    merged = (ImmutableSegment.merge(parts) if parts
              else ImmutableSegment.from_mutable(MutableSegment()))
    block = int(rng.integers(0, 1 << 40))
    ipersist.write_segment(root, b"fuzz", block, iseg)
    rseg = ipersist.read_segment(root, b"fuzz", block)
    for _ in range(queries_per_round):
        q = rand_query(rng)
        want = {sid for sid, tags in docs if brute(q, tags)}
        for name, seg in zip(PATHS, (mseg, iseg, merged, rseg)):
            got = {seg.doc(p).id for p in execute(seg, q)}
            if got != want:
                raise AssertionError(
                    f"{name}: segment diverged from the brute force on "
                    f"{q!r}: extra={sorted(got - want)[:3]} "
                    f"missing={sorted(want - got)[:3]}")
    return n * queries_per_round * len(PATHS)


def run(rounds: int, seed: int, device=None, log=print) -> dict:
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    before = kernel_launches()
    t0 = time.time()
    total = 0
    root = tempfile.mkdtemp(prefix="m3-fuzz-index-")
    try:
        for r in range(rounds):
            total += run_round(rng, root)
            if (r + 1) % 25 == 0:
                log(f"  round {r + 1}/{rounds} ({total} doc-query checks, "
                    f"{time.time() - t0:.0f}s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"rounds": rounds, "checks": total, "paths": list(PATHS),
            "launches": launches_since(before), "device": str(dev),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.rounds, args.seed, args.device,
              log=lambda s: print(s, flush=True))
    print(f"INDEX FUZZ PASS: {out['rounds']} rounds, {out['checks']} "
          f"doc-query checks over {len(PATHS)} paths, seed {args.seed}, "
          f"{out['seconds']:.0f}s")
    print(f"fuzz_index kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
