#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ingest, read and query paths on one
NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--parent DIR]

Phases (each synchronises the device and fails the run on any error):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the four CUDA kernels from m3_tpu_torch/csrc; beside
              it, one `nvcc -Xptxas=-v` per source prints each kernel's
              registers, spills and shared memory
  3. kernels  hold each codec kernel bit for bit against its plain PyTorch
              version on the card, at the shapes the main path gives it,
              plus hostile codec rows and edge-length IDs; time both.
              The window kernel (K4) against its plain version for all six
              stats at the query path's two grids of bench_promql's
              corpus ([10,000, 119], W 10, stride 1 and [10,000, 358],
              W 31, stride 3) and a hostile shard-sized grid
              ([100,000, 438], W 30, stride 3): count, min, max and last
              bit-identical, sum and m2 within the reorder bound; times
              beside the nearest single PyTorch pooling call. Every kernel
              and library time is taken twice: `call_ms` (CUDA events
              around a Python loop of calls, host enqueue included) and
              `device_ms` (the same calls captured in one CUDA graph, its
              replay timed by CUDA events: device time alone)
  3b. parent  with --parent DIR only: DIR holds the parent commit's
              m3_tpu_torch/ (git archive); its decode and window wrappers
              and kernels, built as a second extension, are timed against
              this checkout's in turns (parent, change, change, parent) at
              the main path's shapes
  4. slice    route 100,000 series IDs to 4096 shards, group the block's
              rows by shard, ingest_step_raw (encode + 1m rollup) on the
              100,000 x 120 block, decode_plane the words back; the round
              trip must be exact, bytes/datapoint 1.429, the aggregates
              must agree with an independent plain computation, and every
              kernel must have launched during this phase
  5. small    the same slice on 512 hostile rows, on the card and with
              the plain versions on the CPU: identical results
  6. query    bench_promql's storage (10,000 counters x 360 points at
              10 s, seed 11) and bench_promql_plan_agg's (10,000 over 200
              hosts, seed 17) through Engine(storage) on the card and
              Engine(storage, device="cpu"): the rate family,
              *_over_time, a 5m10s window, a packed subquery and grouped
              aggregations at step 30 s must agree (same tags and order,
              same NaN cells, rtol 1e-5, atol 1e-8) and the window kernel
              must have launched; then a host-clock breakdown of one
              rate + sum_over_time pair

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N, W, FACTOR, SEED = 100_000, 120, 6, 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
REPLACES = {
    "pack": ("m3_tpu_torch/csrc/pack.cu", "m3_tpu/ops/pallas_codec.py:116"),
    "decode": ("m3_tpu_torch/csrc/decode.cu", "m3_tpu/ops/pallas_codec.py:187"),
    "hash": ("m3_tpu_torch/csrc/hash.cu", "m3_tpu/ops/pallas_codec.py:298"),
    "window": ("m3_tpu_torch/csrc/window.cu", "m3_tpu/ops/pallas_window.py:75"),
}
Q_SERIES, Q_HOSTS = 10_000, 200          # bench_promql(_plan_agg)'s sizes
SHARD_ROWS = 100_000                     # the hostile window grid's rows
STEP_NS = 30_000_000_000
QUERIES = (
    [f"{f}(bench_metric[5m])" for f in ("rate", "increase", "irate", "delta")]
    + [f"{k}_over_time(bench_metric[5m])" for k in (
        "sum", "avg", "min", "max", "count", "last", "stddev", "stdvar",
        "present")]
    + ["sum_over_time(bench_metric[5m10s])",
       "max_over_time(rate(bench_metric[5m])[30m:1m])",
       "sum by (host) (rate(bench_requests[5m]))",
       "max by (host) (rate(bench_requests[5m]))",
       "topk(5, rate(bench_requests[5m]))"])
EPS = 1.2e-7  # 2^-23


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


START = time.perf_counter()


def phase(name: str) -> None:
    print(f"phase t+{time.perf_counter() - START:7.1f}s {name}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over `iters` calls from a Python loop,
    by CUDA events: the call time, host enqueue included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call: `iters` calls captured into one
    CUDA graph, its replay timed by CUDA events. No Python and no enqueue
    is in the time, only the kernels and the gaps between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def kernel_times(fn, iters: int) -> dict:
    """A wrapper's call time (`ms` and `call_ms`, the earlier measure) and
    its device time (`device_ms`)."""
    call = cuda_ms(fn, iters)
    return dict(ms=call, call_ms=call, device_ms=device_ms(fn, iters))


def times_text(r: dict) -> str:
    return f"call {r['call_ms']!r} ms, device {r['device_ms']!r} ms"


def u32_err(a, b) -> int:
    """Largest |a - b| of two int32 bit-pattern tensors read as u32."""
    import torch

    if a.numel() == 0:
        return 0
    return int(((a.to(torch.int64) & 0xFFFFFFFF)
                - (b.to(torch.int64) & 0xFFFFFFFF)).abs().max())


def int_err(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(b.dtype) - b).abs().max())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="a checkout (or archive) of the parent commit: also time its "
             "decode and window wrappers against this checkout's, in turns")
    args = parser.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from m3_tpu_torch.ops import codec_kernels as ck
        from m3_tpu_torch.ops import tsz
        from m3_tpu_torch.parallel import ingest
        from m3_tpu_torch.parallel.sharding import ShardSet
        from m3_tpu_torch.testing import (hostile_block, hostile_residuals,
                                          prometheus_ids, promql_corpus)
        from m3_tpu_torch.utils.hashing import pad_ids
    except ImportError as err:
        print(f"chip_smoke: run from the root of a checkout ({err})",
              file=sys.stderr)
        return 2

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(card_line, flush=True)
    phase(f"device {kind}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    ptxas = _start_ptxas(here)
    try:
        ck.build()
    finally:
        ptxas_text = {src: p.communicate()[0] for src, p in ptxas.items()}
    phase(f"build: {sorted(ck.KERNELS) + ['window']} in "
          f"{time.perf_counter() - t:.1f}s")
    _print_ptxas(ptxas, ptxas_text)

    # -- 3. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(SEED)
    ts_np, vals_np, npts_np = ingest.make_example_raw(N, W, rng)
    ids = prometheus_ids(N, np.random.default_rng(SEED))
    id_lens = np.fromiter(map(len, ids), np.int64, len(ids))
    mw = tsz.max_words_for(W)
    check(mw == 446, f"max_words_for({W}) = {mw}")
    raw = ingest.make_raw_batch(ts_np, vals_np, npts_np)
    prep, ok = tsz.prepare_on_device_math(
        raw.ts, raw.values.view(torch.int64), raw.npoints)
    check(bool(ok), "range_ok false on the example block")
    chunks = tsz.encode_chunks(**prep)
    h_ts, h_vals, h_npts = hostile_block(SEED, 4096, W)
    hostile = tsz.prepare_encode_inputs(h_ts, h_vals, h_npts)
    h_chunks = tsz.encode_chunks(**hostile)
    torch.cuda.synchronize()
    check(chunks[0].shape == (N, 2 * W), f"slot planes {tuple(chunks[0].shape)}")
    phase(f"inputs: block {N}x{W}, {len(ids)} IDs of {id_lens.min()}-"
          f"{id_lens.max()} bytes, 4096 hostile rows")

    results = {}

    # K1 pack
    words = ck.pack_chunks(*chunks, mw)
    words_plain = ck.pack_chunks_plain(*chunks, mw)
    h_words = ck.pack_chunks(*h_chunks, mw)
    torch.cuda.synchronize()
    err = max(u32_err(words, words_plain),
              u32_err(h_words, ck.pack_chunks_plain(*h_chunks, mw)))
    check(err == 0, f"pack kernel differs from its plain version: {err}")
    pack_bytes = 4 * chunks[0].numel() * 4 + words.numel() * 4
    results["pack"] = dict(
        max_abs_err=err, bytes=pack_bytes,
        **kernel_times(lambda: ck.pack_chunks(*chunks, mw), 20),
        plain_ms=cuda_ms(lambda: ck.pack_chunks_plain(*chunks, mw), 3))
    phase(f"pack: bit-identical (kernel {times_text(results['pack'])}, "
          f"plain {results['pack']['plain_ms']!r} ms)")

    # K2 decode
    npts = raw.npoints
    h_npts_t = torch.from_numpy(h_npts).to(dev)
    got = ck.decode_points(words, npts, W)
    want = ck.decode_points_plain(words, npts, W)
    h_got = ck.decode_points(h_words, h_npts_t, W)
    h_want = ck.decode_points_plain(h_words, h_npts_t, W)
    torch.cuda.synchronize()
    err = max(int_err(a, b) for a, b in zip(got + h_got, want + h_want))
    check(all(torch.equal(a, b) for a, b in zip(got + h_got, want + h_want)),
          f"decode kernel differs from its plain version: {err}")
    # The point loop reads each row only up to its stream's end.
    stream_bytes = int(chunks[3].sum()) // 8
    dec_bytes = stream_bytes + npts.numel() * 4 + N * W * (4 + 8 + 8) + N * 4
    results["decode"] = dict(
        max_abs_err=err, bytes=dec_bytes,
        **kernel_times(lambda: ck.decode_points(words, npts, W), 20),
        plain_ms=cuda_ms(lambda: ck.decode_points_plain(words, npts, W), 2))
    phase(f"decode: bit-identical (kernel {times_text(results['decode'])}, "
          f"plain {results['decode']['plain_ms']!r} ms)")

    # K3 hash
    hw_np, hl_np = pad_ids(ids)
    hw = torch.from_numpy(np.ascontiguousarray(hw_np)).to(dev)
    hl = torch.from_numpy(hl_np).to(dev)
    edge = [bytes(range(n)) for n in range(8)] + [b"m" * 2100] + ids[:64]
    ew_np, el_np = pad_ids(edge)
    ew = torch.from_numpy(np.ascontiguousarray(ew_np)).to(dev)
    el = torch.from_numpy(el_np).to(dev)
    err = max(u32_err(ck.hash_words(hw, hl), ck.hash_words_plain(hw, hl)),
              u32_err(ck.hash_words(ew, el), ck.hash_words_plain(ew, el)))
    torch.cuda.synchronize()
    check(err == 0, f"hash kernel differs from its plain version: {err}")
    results["hash"] = dict(
        max_abs_err=err, bytes=int(id_lens.sum()) + hl.numel() * 4 + N * 4,
        **kernel_times(lambda: ck.hash_words(hw, hl), 50),
        plain_ms=cuda_ms(lambda: ck.hash_words_plain(hw, hl), 3))
    phase(f"hash: bit-identical on {hw.shape[1]} cols and edge lengths 0-7, "
          f"2100 (kernel {times_text(results['hash'])}, plain "
          f"{results['hash']['plain_ms']!r} ms)")
    del got, want, h_got, h_want, words_plain, chunks, prep
    torch.cuda.empty_cache()

    # K4 window, at the query path's grids and a hostile shard-sized one
    corpus, t_q = promql_corpus(Q_SERIES, 11)
    window_cases = _query_grids(corpus, t_q)
    window_cases.append((hostile_residuals(SEED, SHARD_ROWS, 438), 30, 3))
    window_rows, results["window"] = _check_window(window_cases, dev)
    for r in window_rows:
        print(f"window {r['shape']} W={r['W']} stride={r['stride']} "
              f"{r['stat']}: kernel {times_text(r)}, plain {r['plain_ms']!r} "
              f"ms, library call {r['library_ms']!r} ms, device "
              f"{r['library_device_ms']!r} ms, bound {r['bound_ms']!r} ms, "
              f"max_abs_err {r['max_abs_err']!r}")
    torch.cuda.empty_cache()
    if args.parent:
        _parent_turns(args.parent, here, words, npts, window_cases, dev)
    del window_cases
    torch.cuda.empty_cache()

    # -- 4. the slice, through the entry points ----------------------------
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    steps = [time.perf_counter()]
    shards = ShardSet().lookup_batch(ids)
    order = torch.argsort(shards, stable=True)
    block = ingest.RawIngestBatch(raw.ts[order], raw.values[order],
                                  raw.npoints[order])
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    words, nbits, roll, blk, qs, range_ok = ingest.ingest_step_raw(
        block, rollup_factor=FACTOR, max_words=mw)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    dts, dvals = tsz.decode_plane(words, block.npoints, window=W)
    torch.cuda.synchronize()
    steps.append(time.perf_counter())
    launches = ck.launch_counts()
    route_s, ingest_s, decode_s = np.diff(steps)
    phase(f"slice: {steps[-1] - steps[0]:.3f}s host clock (route + group "
          f"{route_s:.3f}s, ingest_step_raw {ingest_s:.3f}s, decode_plane "
          f"{decode_s:.3f}s), launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    check(bool(range_ok), "range_ok false")
    check(words.shape == (N, mw) and nbits.shape == (N,), "output shapes")
    check(torch.equal(dts, block.ts), "decoded timestamps differ from the block")
    check(torch.equal(dvals.view(torch.int64), block.values.view(torch.int64)),
          "decoded values differ from the block bit for bit")
    bpd = int(nbits.sum()) / 8.0 / (N * W)
    print(f"bytes_per_datapoint {bpd:.6f}")
    check(round(bpd, 3) == 1.429, f"bytes_per_datapoint {bpd}")
    check(torch.equal(shards.cpu(), ShardSet().lookup_batch(ids, device="cpu")),
          "shard ids differ from the plain hash")
    _check_aggregates(block, roll, blk, qs)
    phase("slice: exact round trip; rollup, block stats and quantiles agree "
          "with the plain computation")

    # -- 5. small input: the card against the plain versions on the CPU ----
    s_ts, s_vals, s_npts = hostile_block(SEED + 1, 512, W)
    for devname in ("cuda", "cpu"):
        sb = ingest.make_raw_batch(s_ts, s_vals, s_npts, device=devname)
        out = ingest.ingest_step_raw(sb, rollup_factor=FACTOR, max_words=mw,
                                     device=devname)
        dec = tsz.decode_plane(out[0], sb.npoints, window=W, with_f32=True,
                               device=devname)
        if devname == "cuda":
            ref = (out, dec)
    for a, b in ((ref[0][0], out[0]), (ref[0][1], out[1]), (ref[0][4], out[4]),
                 (ref[1][0], dec[0]), (ref[1][1].view(torch.int64),
                                       dec[1].view(torch.int64)),
                 (ref[1][2].view(torch.int32), dec[2].view(torch.int32))):
        check(torch.equal(a.cpu(), b), "card and CPU disagree on the small input")
    torch.cuda.synchronize()
    phase("small: card == plain CPU path on 512 hostile rows")

    # -- 6. the query path, through Engine.execute_range --------------------
    plan_corpus, _ = promql_corpus(Q_SERIES, 17, hosts=Q_HOSTS,
                                   metric=b"bench_requests")
    launches["window"] = _query_phase(corpus, plan_corpus, t_q)

    kernels = []
    for name in ("pack", "decode", "hash", "window"):
        r = results[name]
        src, rep = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "call_ms": r["call_ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": r.get("library_ms"),
            "library_device_ms": r.get("library_device_ms")})
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def _query_grids(series, t):
    """The window kernel's inputs on the query path: the centred residual
    grids that [5m] (W 10, stride 1) and [5m10s] (W 31, stride 3)
    selectors give at step 30 s over t[30]..t[359]."""
    from m3_tpu_torch.ops.temporal import center
    from m3_tpu_torch.query.block import BlockMeta, consolidate_series

    start, end = int(t[30]), int(t[-1])
    steps = (end - start) // STEP_NS + 1
    grids = []
    for range_ns in (300_000_000_000, 310_000_000_000):
        wgrid = math.gcd(STEP_NS, range_ns)
        w, stride = range_ns // wgrid, STEP_NS // wgrid
        meta = BlockMeta(start - (w - 1) * wgrid, wgrid,
                         (w - 1) + (steps - 1) * stride + 1)
        grids.append((center(consolidate_series(series, meta, wgrid)[1])[0],
                      w, stride))
    return grids


def _check_window(cases, dev):
    """K4 against its plain version on the card for every stat at each
    (grid, W, stride) of `cases`: the query path's two grids and a hostile
    shard-sized grid. Returns the
    per-(shape, stat) rows and the kernels-line entry (the [5m] grid,
    `sum`, as sum_over_time runs it)."""
    import torch
    import torch.nn.functional as F

    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.testing import window_reorder_bounds

    rows, worst = [], 0.0
    for x_np, w, stride in cases:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        s, k = x.shape
        t_out = (k - w) // stride + 1
        sum_b, m2_b = window_reorder_bounds(x, w, stride)
        finite = torch.isfinite(x)
        premasked = {
            "count": finite.float(), "sum": torch.where(finite, x, 0.0),
            "max": torch.where(finite, x, float("-inf")),
            "min": torch.where(finite, -x, float("-inf"))}
        for stat in wk.STATS:
            got, got_c = wk.window_stat(x, w, stride, stat)
            want, want_c = wk.window_stat_plain(x, w, stride, stat)
            torch.cuda.synchronize()
            check(torch.equal(got_c, want_c),
                  f"window {stat} {s}x{k}: counts differ")
            if stat in ("count", "min", "max", "last"):
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"window {stat} {s}x{k}: not bit-identical")
                err = 0.0
            else:
                diff = (got.double() - want.double()).abs()
                bound = (sum_b if stat == "sum" else m2_b) + 1e-12
                check(bool((diff <= bound).all()),
                      f"window {stat} {s}x{k}: beyond the reorder bound by "
                      f"{float((diff - bound).max())}")
                err = float(diff.max())
            worst = max(worst, err)
            lib = premasked.get(stat)
            pool = F.max_pool1d if stat in ("min", "max") else F.avg_pool1d
            row = dict(
                shape=[s, k], W=w, stride=stride, stat=stat, max_abs_err=err,
                **kernel_times(lambda: wk.window_stat(x, w, stride, stat), 20),
                plain_ms=cuda_ms(
                    lambda: wk.window_stat_plain(x, w, stride, stat), 3),
                library_ms=None, library_device_ms=None,
                bytes=(s * k + 2 * s * t_out) * 4)
            if lib is not None:
                lt = kernel_times(lambda: pool(lib[:, None, :], w, stride), 20)
                row.update(library_ms=lt["call_ms"],
                           library_device_ms=lt["device_ms"])
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            rows.append(row)
        if s == SHARD_ROWS:
            copy = device_ms(lambda: x.clone())
            print(f"window yardstick: clone of the [{s}, {k}] grid, device "
                  f"{copy!r} ms, {2 * x.numel() * 4 / copy / 1e9!r} TB/s")
        del x, sum_b, m2_b, finite, premasked, got, want
        torch.cuda.empty_cache()
    phase(f"window: count/min/max/last bit-identical, sum/m2 within the "
          f"reorder bound at {len(cases)} grids x 6 stats (largest sum/m2 "
          f"difference {worst!r})")
    head = dict(rows[1], max_abs_err=worst)
    return rows, head


def _start_ptxas(here):
    """One `nvcc -Xptxas=-v` per kernel source, started beside the
    extension's build: each kernel's registers, spills and shared memory."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = os.path.join(here, "build", "ptxas")
    os.makedirs(out, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    csrc = os.path.join(here, "m3_tpu_torch", "csrc")
    return {src: subprocess.Popen(
        [nvcc, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas=-v", "-c", os.path.join(csrc, src),
         "-o", os.path.join(out, src + ".o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sorted(os.listdir(csrc)) if src.endswith(".cu")}


def _print_ptxas(procs, texts) -> None:
    for src, proc in procs.items():
        check(proc.returncode == 0, f"nvcc -Xptxas=-v {src}: {texts[src][-2000:]}")
        fn = ""
        for line in texts[src].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                print(f"ptxas {src} {fn}: {line.split(':', 1)[-1].strip()}")


def _load_parent(root, here):
    """The parent checkout's codec and window wrappers, as the package
    m3_tpu_torch_parent, bound to its own kernels built as a second
    extension under build/parent_kernels."""
    import importlib
    import importlib.util

    from torch.utils.cpp_extension import load

    pkg = os.path.join(os.path.abspath(root), "m3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "m3_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    pck = importlib.import_module("m3_tpu_torch_parent.ops.codec_kernels")
    pwk = importlib.import_module("m3_tpu_torch_parent.ops.window_kernels")
    build_dir = os.path.join(here, "build", "parent_kernels")
    os.makedirs(build_dir, exist_ok=True)
    ext = load(name="m3_tpu_torch_parent_kernels",
               sources=[str(pck.CSRC / src) for src in pck.SOURCES],
               extra_cflags=["-O3"],
               extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
               build_directory=build_dir)
    pck.build = pwk.build = lambda: ext
    return pck, pwk


def _parent_turns(root, here, words, npts, window_cases, dev) -> None:
    """The parent's decode and window wrappers against this checkout's at
    the main path's shapes, in turns parent, change, change, parent, each
    turn a call time and a device time (kernel_times); the outputs must
    agree (counts exactly, decode bit for bit)."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk

    t = time.perf_counter()
    pck, pwk = _load_parent(root, here)
    phase(f"parent: built {root} in {time.perf_counter() - t:.1f}s")
    cases = [("decode", f"[{N}, {W}]", (pck, ck),
              lambda m: (lambda: m.decode_points(words, npts, W)))]
    for x_np, w, stride in window_cases:
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        for stat in wk.STATS:
            cases.append((
                "window", f"{list(x.shape)} W={w} stride={stride} {stat}",
                (pwk, wk), lambda m, x=x, w=w, stride=stride, stat=stat: (
                    lambda: m.window_stat(x, w, stride, stat))))
    for name, label, (old, new), make in cases:
        a, b = make(old)(), make(new)()
        torch.cuda.synchronize()
        same = (all(torch.equal(u, v) for u, v in zip(a, b)) if name == "decode"
                else torch.equal(a[1], b[1]))
        check(same, f"parent and change differ: {name} {label}")
        del a, b
        turns = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            turns[side].append(kernel_times(make(
                old if side == "parent" else new), 20))
        print(f"turns {name} {label}: " + "; ".join(
            f"{side} call_ms {[r['call_ms'] for r in rs]!r} device_ms "
            f"{[r['device_ms'] for r in rs]!r}" for side, rs in turns.items()))
    phase(f"parent: {len(cases)} cases timed in turns")


def _query_phase(corpus, plan_corpus, t):
    """The query path on the card against device="cpu", bench_metric
    queries over bench_promql's storage and bench_requests queries over
    bench_promql_plan_agg's, as the reference benchmark keeps them; returns
    the window kernel's launches during the card run."""
    import torch

    from m3_tpu_torch.ops import codec_kernels as ck
    from m3_tpu_torch.ops import window_kernels as wk
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.testing import DictStorage

    storages = {b"bench_metric": DictStorage(corpus),
                b"bench_requests": DictStorage(plan_corpus)}
    engines = {m: (Engine(st), Engine(st, device="cpu"))
               for m, st in storages.items()}

    def engine(q, on_card):
        return engines[b"bench_requests" if "bench_requests" in q
                       else b"bench_metric"][0 if on_card else 1]

    start, end = int(t[30]), int(t[-1])
    ck.reset_launch_counts()
    wk.window_stat.launches = 0
    torch.cuda.synchronize()
    card_out = {}
    t0 = time.perf_counter()
    for q in QUERIES:
        tq = time.perf_counter()
        blk = engine(q, True).execute_range(q, start, end, STEP_NS)
        blk.values
        torch.cuda.synchronize()
        card_out[q] = (blk, time.perf_counter() - tq)
    card_s = time.perf_counter() - t0
    launches = wk.window_stat.launches
    codec = ck.launch_counts()
    want = sum("_over_time" in q for q in QUERIES)
    phase(f"query: {len(QUERIES)} queries on the card in {card_s:.3f}s, "
          f"window launches {launches} (expected {want}), codec {codec}")
    check(launches == want, f"window kernel launched {launches} times, "
          f"expected {want}")
    for q in QUERIES:
        blk, secs = card_out[q]
        tq = time.perf_counter()
        ref = engine(q, False).execute_range(q, start, end, STEP_NS)
        cpu_s = time.perf_counter() - tq
        got, exp = np.asarray(blk.values), np.asarray(ref.values)
        check([x.id() for x in blk.series_tags]
              == [x.id() for x in ref.series_tags], f"{q}: tags differ")
        check(got.shape == exp.shape and bool(
            (np.isnan(got) == np.isnan(exp)).all()), f"{q}: NaN cells differ")
        check(bool(np.allclose(got, exp, rtol=1e-5, atol=1e-8,
                               equal_nan=True)), f"{q}: values differ")
        fin = np.isfinite(exp)
        rel = float((np.abs(got - exp)[fin] / np.maximum(
            np.abs(exp[fin]), 1e-30)).max()) if fin.any() else 0.0
        print(f"query {q!r}: {got.shape}, card {secs:.4f}s, cpu "
              f"{cpu_s:.4f}s, max rel diff {rel!r}")
    phase("query: every query on the card equals its device=\"cpu\" run")
    _breakdown(engines[b"bench_metric"][0], storages[b"bench_metric"], t,
               card_out)
    return launches


def _breakdown(card, storage, t, card_out) -> None:
    """Host clock of one rate + sum_over_time pair, by step, each step
    ending in torch.cuda.synchronize(): fetch + consolidate_series, host
    prep (_host_diff_grid / center), the H2D copy, the device kernels, the
    D2H copy plus finish. The results must equal the Engine's."""
    import torch

    from m3_tpu_torch.ops import temporal as tp
    from m3_tpu_torch.query import promql
    from m3_tpu_torch.query.block import BlockMeta, consolidate_series
    from m3_tpu_torch.query.executor import Engine

    dev = torch.device("cuda")
    start, end = int(t[30]), int(t[-1])
    steps = (end - start) // STEP_NS + 1
    wgrid, w = STEP_NS, 10
    meta = BlockMeta(start - (w - 1) * wgrid, wgrid, (w - 1) + steps)
    split = {}
    for q in ("rate(bench_metric[5m])", "sum_over_time(bench_metric[5m])"):
        sel = promql.parse(q).args[0]
        marks = [time.perf_counter()]
        series = storage.fetch_raw(promql.selector_matchers(sel),
                                   meta.start_ns - wgrid, end + 1)
        grid = consolidate_series(series, meta, wgrid)[1]
        marks.append(time.perf_counter())
        if q.startswith("rate"):
            host = tp.rate_inputs(grid, True)
            marks.append(time.perf_counter())
            args = [tp._put(a, dev) for a in host]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = tp.rate_math(*args, W=w, step_s=wgrid / 1e9, range_s=300.0,
                               is_counter=True, is_rate=True)
        else:
            resid, base = tp.center(grid)
            marks.append(time.perf_counter())
            args = [tp._put(resid, dev), tp._put(base.astype(np.float32), dev)]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = tp.over_time_math(*args, W=w, kind="sum")
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        res = tp._fetch(out)
        marks.append(time.perf_counter())
        check(np.array_equal(res, np.asarray(card_out[q][0].values),
                             equal_nan=True), f"breakdown of {q} differs")
        split[q.split("(")[0]] = np.diff(marks)
    names = ("fetch+consolidate", "host prep", "H2D", "kernels", "D2H+finish")
    for q, d in split.items():
        print(f"breakdown {q}: " + ", ".join(
            f"{n} {x * 1e3:.3f} ms" for n, x in zip(names, d))
            + f"; total {d.sum() * 1e3:.3f} ms")
    for label, eng in (("grid cache warm", card), ("cold", Engine(storage))):
        t0 = time.perf_counter()
        blocks = [eng.execute_range(q, start, end, STEP_NS)
                  for q in ("rate(bench_metric[5m])",
                            "sum_over_time(bench_metric[5m])")]
        for blk in blocks:
            blk.values
        torch.cuda.synchronize()
        print(f"pair through Engine.execute_range, {label}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")


def _check_aggregates(block, roll, blk, qs) -> None:
    """The rollup (factor 6) and block planes against an independent plain
    computation on the card: masked reductions over a reshaped window and
    a sort for the quantiles. count/min/max/last/first and the quantiles
    must be identical. sum, sumsq and m2 are float32 sums in another
    order, held to bench.py's reduction-reorder bound |err| <= 2 n eps L1
    (eps = 2^-23, L1 per plane). The plain m2 centres on the plain mean,
    which may differ from the port's by the sum's reorder bound over n
    plus one rounding of the divide; m2's bound adds the first- and
    second-order effect of that shift, as bench.py does."""
    import torch

    from m3_tpu_torch.ops.bits64 import f64_bits_to_f32

    v = f64_bits_to_f32(block.values.view(torch.int64))
    n, w = v.shape
    mask = torch.arange(w, device=v.device) < block.npoints[:, None]

    def plain(vv, mm):
        cnt = mm.sum(-1)
        idx = torch.arange(vv.shape[-1], device=vv.device)
        last_i = torch.where(mm, idx, -1).amax(-1).clamp(min=0)
        first_i = torch.where(mm, idx, vv.shape[-1]).amin(-1).clamp(
            max=vv.shape[-1] - 1)
        z = torch.where(mm, vv, 0.0)
        mu = z.sum(-1) / cnt.clamp(min=1)
        dev = torch.where(mm, vv - mu[..., None], 0.0)
        return {
            "count": cnt.float(),
            "min": torch.where(mm, vv, float("inf")).amin(-1),
            "max": torch.where(mm, vv, float("-inf")).amax(-1),
            "last": torch.where(cnt > 0, vv.gather(-1, last_i[..., None])[..., 0], 0.0),
            "first": torch.where(cnt > 0, vv.gather(-1, first_i[..., None])[..., 0], 0.0),
            "sum": z.sum(-1), "sumsq": (z * z).sum(-1), "m2": (dev * dev).sum(-1),
        }

    rv = v.reshape(n, w // FACTOR, FACTOR)
    rm = mask.reshape(n, w // FACTOR, FACTOR)
    for got, vv, mm in ((roll, rv, rm), (blk, v, mask)):
        want = plain(vv, mm)
        for key in ("count", "min", "max", "last", "first"):
            check(torch.equal(got[key], want[key]), f"aggregate {key} differs")
        cnt = want["count"].double()
        depth = 2.0 * cnt.clamp(min=1) * EPS
        sumsq = want["sumsq"].double()
        m2 = want["m2"].double()
        bound = {"sum": depth * torch.sqrt(cnt * sumsq), "sumsq": depth * sumsq}
        mu_shift = (bound["sum"] + EPS * want["sum"].double().abs()) / cnt.clamp(min=1)
        bound["m2"] = (depth * m2 + 2.0 * torch.sqrt(cnt * m2) * mu_shift
                       + cnt * mu_shift * mu_shift)
        for key, atol in bound.items():
            err = (got[key].double() - want[key].double()).abs()
            check(bool((err <= atol + 1e-12).all()),
                  f"aggregate {key} beyond the reorder bound: {float(err.max())}")
    srt = torch.sort(torch.where(rm, rv, float("inf")), dim=-1).values
    nq = rm.sum(-1)
    for j, q in enumerate((0.5, 0.99)):
        rank = torch.ceil(q * nq.float()).to(torch.int64)
        idx = (rank.clamp(min=1) - 1).clamp(0, FACTOR - 1)
        want = torch.where(nq > 0, srt.gather(-1, idx[..., None])[..., 0], 0.0)
        check(torch.equal(qs[..., j], want), f"quantile {q} differs")


if __name__ == "__main__":
    sys.exit(main())
