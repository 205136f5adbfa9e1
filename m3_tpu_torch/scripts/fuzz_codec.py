"""Randomized TTSZ codec campaign on the port: the fuzz tier of the
codec's hand-written kernels (counterpart of scripts/fuzz_codec.py).

Each round draws the reference campaign's adversarial workload (the
production mix plus wild f64 bit patterns, wide-header t0/delta0/v0
magnitudes, ragged 1..w point counts, NaN holes; the same draws for the
same seed) and checks, per shape bucket:

  packer parity  the pack kernel (K1, through the guard's codec.encode
                 route, as a seal runs it) equals its plain version word
                 for word, and the nbits agree;
  round trip     the decode (K2) gives back every timestamp and every
                 value's bit pattern (signed zeros and NaN payloads too);
  oracle         a random subsample of series equals the scalar oracle
                 (ops/ref_codec.py) in words and nbits;
  merge          the full-window quarter split into two sealed halves and
                 merged through the eligibility partition (the concat for
                 regular rows, the decode + re-encode for the rest: K2
                 twice, then K1) decodes to the original points, and the
                 int-mode concat rows equal a direct encode of the window.

A failure raises AssertionError naming its invariant. The shapes come
from a fixed bucket set, as in the reference, so rounds vary data.

Usage:  python -m m3_tpu_torch.scripts.fuzz_codec --rounds 150 --seed 1
        python -m m3_tpu_torch.scripts.fuzz_codec --device cpu ...
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import resolve
from ..ops import codec_kernels as ck
from ..ops import kernel_launches
from ..ops import ref_codec as rc
from ..ops import tsz, tsz_concat
from . import device_arg, launches_since, sync

# (n series, window) buckets, the reference campaign's.
SHAPES = [(64, 16), (128, 60), (96, 120), (48, 240)]
INVARIANTS = ("packer parity", "round trip", "oracle", "merge")


def make_adversarial(rng, n, w):
    """The unit-test production mix plus hostile kinds (the reference
    campaign's draws, in its order)."""
    base = np.int64(rng.choice([1_700_000_000, 2**40, -(2**40), 7]))
    step = int(rng.choice([1, 10, 1 << 20]))
    ts = base + np.arange(w, dtype=np.int64)[None, :] * step \
        + rng.integers(0, 2, (n, w))
    ts = np.sort(ts, axis=1)
    kinds = rng.integers(0, 8, n)
    vals = np.empty((n, w), dtype=np.float64)
    for i in range(n):
        k = kinds[i]
        if k == 0:  # counter
            vals[i] = np.cumsum(rng.poisson(5.0, w)).astype(np.float64)
        elif k == 1:  # gauge, 2dp
            vals[i] = np.round(rng.normal(100, 5, w), 2)
        elif k == 2:  # constant
            vals[i] = float(rng.integers(0, 100))
        elif k == 3:  # raw float noise
            vals[i] = rng.normal(0, 1, w)
        elif k == 4:  # sparse NaN gauge
            vals[i] = np.where(rng.random(w) < 0.05, np.nan,
                               np.round(rng.normal(10, 1, w), 3))
        elif k == 5:  # huge integers (wide int-mode headers)
            vals[i] = (float(2**40) + np.cumsum(
                rng.integers(0, 5, w))).astype(np.float64)
        elif k == 6:  # signed zeros and tiny denormals
            picks = rng.integers(0, 4, w)
            vals[i] = np.choose(picks, [0.0, -0.0, 5e-324, -5e-324])
        else:  # wild raw f64 bit patterns (incl. infs, NaN payloads)
            vals[i] = rng.integers(0, 2**64, w, dtype=np.uint64).view(
                np.float64)
    return ts, vals


def draw_round(rng, n, w):
    """One round's inputs: the workload and its ragged point counts (a
    quarter at the full window: the merge's input)."""
    ts, vals = make_adversarial(rng, n, w)
    npoints = rng.integers(1, w, n).astype(np.int32)
    npoints[: n // 4] = w
    return ts, vals, npoints


def _check(invariant: str, cond, msg: str) -> None:
    if not cond:
        raise AssertionError(f"{invariant}: {msg}")


def _same_points(invariant, ts, vals, got_ts, got_vals, npoints, what):
    """Timestamps and value bit patterns equal on every live point."""
    live = np.arange(ts.shape[1])[None, :] < np.asarray(npoints)[:, None]
    bad_t = live & (got_ts != ts)
    bad_v = live & (got_vals.view(np.uint64) != vals.view(np.uint64))
    for name, bad in (("ts", bad_t), ("vals", bad_v)):
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise AssertionError(
                f"{invariant}: {what} {name} differ at series {r}, point "
                f"{c}")


def _half_inputs(inp, ts, lo, hi):
    """One sealed half's encode inputs cut from the full window's
    preparation: the value columns and the int-mode/k decision are the
    window's (both halves and the direct full-window encode agree on the
    value path); only the timestamp head fields are the half's."""
    n = len(ts)
    dt = np.asarray(inp["dt"])[:, lo:hi].copy()
    dt[:, 0] = 0
    delta0 = dt[:, 1].copy() if hi - lo > 1 else np.zeros(n, dt.dtype)
    ts_regular = ((dt[:, 1:] == delta0[:, None]).all(axis=1)
                  if hi - lo > 1 else np.ones(n, bool))
    return dict(dt=dt, t0=ts[:, lo].astype(np.int64),
                v=np.asarray(inp["v"])[:, lo:hi], int_mode=inp["int_mode"],
                k=inp["k"], npoints=np.full(n, hi - lo, np.int32),
                ts_regular=ts_regular, delta0=delta0)


def _merge_check(ts, vals, w, dev) -> int:
    n, half = len(ts), w // 2
    npts = np.full(n, w, np.int32)
    inp = tsz.prepare_encode_inputs(ts, vals, npts)
    int_mode = np.asarray(inp["int_mode"])
    mw_half, mw_full = tsz.max_words_for(half), tsz.max_words_for(w)
    h1 = _half_inputs(inp, ts, 0, half)
    h2 = _half_inputs(inp, ts, half, w)
    w1, nb1 = tsz.encode_batch(**h1, max_words=mw_half, device=dev)
    w2, nb2 = tsz.encode_batch(**h2, max_words=mw_half, device=dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    npts_half = torch.full((n,), half, dtype=torch.int32, device=dev)
    boundary = put((ts[:, half] - ts[:, half - 1]).astype(np.int32))
    meta = tsz.boundary_metadata(h1)
    last_v = put(meta["last_v_bits"].view(np.int64))
    last_vd = put(meta["last_vdelta_bits"].view(np.int64))
    ok = tsz_concat.concat_eligible(
        tsz_concat.parse_header(w1), tsz_concat.parse_header(w2),
        npts_half, npts_half, boundary).cpu().numpy()
    fast, slow = np.flatnonzero(ok), np.flatnonzero(~ok)
    merged_w = torch.zeros((n, mw_full), dtype=torch.int32, device=dev)
    merged_nb = torch.zeros(n, dtype=torch.int32, device=dev)
    if fast.size:
        p = put(fast)
        fw, fnb = tsz_concat.concat_regular_batch(
            w1[p], nb1[p], npts_half[p], w2[p], nb2[p], npts_half[p],
            last_v[p], last_vd[p], max_words=mw_full, device=dev)
        merged_w[p], merged_nb[p] = fw, fnb
    if slow.size:
        p = put(slow)
        sw, snb = tsz_concat._merge_by_recode(
            w1[p], npts_half[p], w2[p], npts_half[p], boundary[p],
            half_window=half, max_words=mw_full)
        merged_w[p], merged_nb[p] = sw, snb
    dts, dv = tsz.decode(merged_w, npts, w, device=dev)
    _same_points("merge", ts, vals, dts.cpu().numpy(), dv.cpu().numpy(),
                 npts, "merged block's")
    int_fast = fast[int_mode[fast]]
    if int_fast.size:
        ref_w, ref_nb = tsz.encode_batch(**inp, max_words=mw_full,
                                         device=dev)
        p = put(int_fast)
        _check("merge", torch.equal(merged_nb[p], ref_nb[p]),
               "concat nbits differ from a direct encode")
        _check("merge", torch.equal(merged_w[p], ref_w[p]),
               "concat words differ from a direct encode")
    return n


def run_round(rng, n, w, device=None, oracle_sample=6) -> dict:
    """One round at bucket (n, w) on `device`; returns the checks made,
    by invariant."""
    dev = resolve(device)
    ts, vals, npoints = draw_round(rng, n, w)
    inp = tsz.prepare_encode_inputs(ts, vals, npoints)
    mw = tsz.max_words_for(w)
    words, nbits = tsz.encode_batch(**inp, max_words=mw, device=dev)
    chunks = tsz.encode_chunks(**inp, device=dev)
    _check("packer parity", torch.equal(
        words, ck.pack_chunks_plain(*chunks, mw)),
        "the pack kernel's words differ from its plain version's")
    _check("packer parity", torch.equal(
        nbits, chunks[3].sum(dim=1, dtype=torch.int32)), "nbits differ")
    t2, v2 = tsz.decode(words, npoints, w, device=dev)
    _same_points("round trip", ts, vals, t2.cpu().numpy(), v2.cpu().numpy(),
                 npoints, "decoded")
    words_np = words.cpu().numpy().view(np.uint32)
    nbits_np = nbits.cpu().numpy()
    picks = rng.choice(n, size=min(oracle_sample, n), replace=False)
    for i in picks:
        blk = rc.encode(ts[i, : npoints[i]], vals[i, : npoints[i]])
        _check("oracle", nbits_np[i] == blk.nbits, f"nbits of series {i}")
        nwords = (blk.nbits + 31) // 32
        _check("oracle", np.array_equal(words_np[i, :nwords], blk.words),
               f"words of series {i}")
    full = np.flatnonzero(npoints == w)
    merged = 0
    if w >= 4 and w % 2 == 0 and full.size:
        merged = _merge_check(ts[full], vals[full], w, dev)
    return {"packer parity": n, "round trip": n, "oracle": len(picks),
            "merge": merged}


def run(rounds: int, seed: int, device=None, log=print) -> dict:
    """The campaign: `rounds` rounds over SHAPES in turn. Returns its
    rounds, series, checks by invariant, launches and seconds."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    before = kernel_launches()
    t0 = time.time()
    total = 0
    checks = dict.fromkeys(INVARIANTS, 0)
    for r in range(rounds):
        n, w = SHAPES[r % len(SHAPES)]
        for k, c in run_round(rng, n, w, dev).items():
            checks[k] += c
        total += n
        if (r + 1) % 10 == 0:
            log(f"  round {r + 1}/{rounds} ({total} series checked, "
                f"{time.time() - t0:.0f}s)")
    sync(dev)
    return {"rounds": rounds, "series": total, "checks": checks,
            "launches": launches_since(before), "device": str(dev),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    device_arg(ap)
    args = ap.parse_args(argv)
    out = run(args.rounds, args.seed, args.device,
              log=lambda s: print(s, flush=True))
    print(f"FUZZ PASS: {out['rounds']} rounds, {out['series']} series, "
          f"device {out['device']}, seed {args.seed}, checks "
          f"{out['checks']}, {out['seconds']:.0f}s")
    print(f"fuzz_codec kernel launches {json.dumps(out['launches'])}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
