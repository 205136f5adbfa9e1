"""The per-shard ingest step, on one device and over the shard x time mesh
(port of m3_tpu/parallel/ingest.py).

One step is the per-shard hot path of the reference's write + flush loop
(src/dbnode/storage/series/buffer.go Write -> m3tsz encoder, and
src/aggregator/aggregator/generic_elem.go Consume) over a whole shard of
series at once:

  (N series x W points) -> TTSZ bitstreams
                         + 1m rollup moments + block moments + quantiles

Multi-device layout (parallel/mesh, the port's shard_map):
  axis "shard": data-parallel over series (the reference's murmur3
      virtual-shard partitioning, src/dbnode/sharding/shardset.go). No
      cross-series communication.
  axis "time": sequence-parallel over block windows (series/buffer.go's
      rotating block buckets). Each entry encodes its own block, and the
      block-spanning aggregates merge across the time axis with the
      mesh's collectives: psum for the moments, pmin/pmax for the
      extremes, the generalized Chan merge for m2, and first/last from the
      first/last non-empty chunk of an all_gather.

The serving flush's encode (`flush_encode_prepared`, storage/block.py's
seal) splits a block's rows over every entry of the mesh. With one device
attached, `flush_mesh()` is None and every route stays single-device, as
the reference's does on one device. A fault on the mesh route raises a
typed ComputeError (route `flush_encode`); unlike the reference, nothing
falls back to the single-device encode.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from . import guard
from . import mesh as pmesh
from . import telemetry
from ..device import attached, on_attach, resolve
from ..ops import aggregation as agg
from ..ops import bits64 as b64
from ..ops import tsz


class IngestBatch(NamedTuple):
    """Device inputs for one shard x block ingest step, [N, W] / [N].

    The reference's (hi, lo) u32 pairs are single int64 tensors here."""

    dt: torch.Tensor         # int32 [N, W] timestamp deltas, first col 0
    t0: torch.Tensor         # int64 [N] first timestamp
    v: torch.Tensor          # int64 [N, W] value bits (f64 bits or int64 m)
    int_mode: torch.Tensor   # bool [N]
    k: torch.Tensor          # int32 [N] decimal exponent
    npoints: torch.Tensor    # int32 [N] valid points
    ts_regular: torch.Tensor  # bool [N] all deltas equal delta0
    delta0: torch.Tensor     # int32 [N] common scrape interval (ticks)
    values: torch.Tensor     # f32 [N, W] values for aggregation


class RawIngestBatch(NamedTuple):
    """Raw inputs for the fused prep + encode step: the int64 timestamps
    and the f64 values as they are, plus the valid-point counts."""

    ts: torch.Tensor       # int64 [N, W] ticks
    values: torch.Tensor   # float64 [N, W]
    npoints: torch.Tensor  # int32 [N]


def ingest_step(batch: IngestBatch, *, rollup_factor: int, max_words: int,
                quantile_qs=(0.5, 0.99), device=None):
    """Encode one block and roll up / aggregate its window.

    Returns (words int32 [N, max_words] u32 bit patterns, nbits int32 [N],
    rollup stats dict [N, W//factor], block stats dict [N], quantiles
    [N, W//factor, Q])."""
    dev = resolve(device)
    # ingest staging: the batch is the program input the step consumes at
    # once, not resident-cache memory
    batch = IngestBatch(*(t.to(dev) for t in batch))  # m3lint: disable=unbudgeted-device-put
    words, nbits = tsz.encode_batch(
        batch.dt, batch.t0, batch.v, batch.int_mode, batch.k, batch.npoints,
        batch.ts_regular, batch.delta0, max_words=max_words, device=dev)
    w = batch.values.shape[-1]
    mask = torch.arange(w, device=dev) < batch.npoints[..., None]
    roll = agg.rollup_stats(batch.values, mask, rollup_factor)
    blk = agg.window_stats(batch.values, mask)
    qs = agg.rollup_quantiles(batch.values, mask, rollup_factor, quantile_qs)
    return words, nbits, roll, blk, qs


def make_raw_batch(ts: np.ndarray, values: np.ndarray, npoints: np.ndarray,
                   *, device=None) -> RawIngestBatch:
    """Host arrays -> a RawIngestBatch on the device (one copy each; the
    hi/lo split, the f32 values and all prep happen in ingest_step_raw)."""
    dev = resolve(device)
    return RawIngestBatch(
        # ingest staging, as in ingest_step
        torch.from_numpy(np.ascontiguousarray(ts, dtype=np.int64)).to(dev),  # m3lint: disable=unbudgeted-device-put
        torch.from_numpy(np.ascontiguousarray(values, dtype=np.float64)).to(dev),  # m3lint: disable=unbudgeted-device-put
        torch.from_numpy(np.ascontiguousarray(npoints, dtype=np.int32)).to(dev))  # m3lint: disable=unbudgeted-device-put


def ingest_step_raw(raw: RawIngestBatch, *, rollup_factor: int,
                    max_words: int, quantile_qs=(0.5, 0.99), device=None):
    """Fused prep + encode + aggregate from raw inputs on the device.
    Returns ingest_step's outputs plus range_ok, a bool scalar tensor
    (False when a live delta or delta-of-delta leaves int32); callers
    check it once per block."""
    dev = resolve(device)
    # ingest staging, as in ingest_step (a no-op when the batch is already on
    # dev)
    ts = raw.ts.to(dev)  # m3lint: disable=unbudgeted-device-put
    vbits = raw.values.to(dev).contiguous().view(torch.int64)  # m3lint: disable=unbudgeted-device-put
    prep, range_ok = tsz.prepare_on_device_math(ts, vbits, raw.npoints.to(dev))  # m3lint: disable=unbudgeted-device-put
    # f32 aggregation values from the ORIGINAL f64 bits (prep rewrites
    # int-mode rows to their mantissas).
    batch = IngestBatch(values=b64.f64_bits_to_f32(vbits), **prep)
    return (*ingest_step(batch, rollup_factor=rollup_factor,
                         max_words=max_words, quantile_qs=quantile_qs,
                         device=dev), range_ok)


def make_example_raw(n: int, tw: int, rng: np.random.Generator,
                     start=1_600_000_000):
    """Synthetic raw shard data shaped like production metrics: regular 10s
    timestamps (about 5% of series jittered), 40% counters, 40% integer
    gauges, 20% float gauges. Returns (timestamps int64 [n, tw], values
    f64 [n, tw], npoints [n]); the same draws as the reference's."""
    jittered = rng.random((n, 1)) < 0.05
    jitter = np.where(jittered, rng.integers(0, 3, size=(n, tw)), 0)
    ts = np.int64(start) + np.arange(tw, dtype=np.int64)[None, :] * 10 + jitter
    ts = np.maximum.accumulate(ts, axis=1)
    kind = rng.integers(0, 5, size=(n, 1))
    base = rng.integers(0, 1000, size=(n, 1)).astype(np.float64)
    rate = rng.integers(1, 20, size=(n, 1)).astype(np.float64)
    steps = rate + np.where(rng.random((n, tw)) < 0.05,
                            rng.integers(-3, 4, size=(n, tw)), 0)
    counters = base + np.cumsum(steps, axis=1)
    moves = np.where(rng.random((n, tw)) < 0.2,
                     rng.integers(-2, 3, size=(n, tw)), 0)
    gauges = base + np.cumsum(moves, axis=1).astype(np.float64)
    floats = (base + np.cumsum(moves, axis=1) * 0.1
              + rng.standard_normal((n, tw)) * 1e-3)
    values = np.where(kind <= 1, counters, np.where(kind <= 3, gauges, floats))
    return ts, values, np.full(n, tw, np.int32)


def make_batch_from_raw(ts2: np.ndarray, v2: np.ndarray, npoints: np.ndarray,
                        *, device=None) -> IngestBatch:
    """Host prep (tsz.prepare_encode_inputs): raw arrays -> IngestBatch."""
    dev = resolve(device)
    inp = tsz.prepare_encode_inputs(ts2, v2, npoints)
    inp["values"] = np.asarray(v2).astype(np.float32)
    # ingest staging, as in ingest_step
    return IngestBatch(**{f: torch.from_numpy(np.ascontiguousarray(inp[f])).to(dev)  # m3lint: disable=unbudgeted-device-put
                          for f in IngestBatch._fields})


def make_example_batch(n: int, w: int, rng: np.random.Generator, *,
                       chunks: int | None = None,
                       device=None) -> IngestBatch:
    """Synthetic shard batch: make_example_raw + host prep, optionally
    split into `chunks` leading time chunks for the sharded [T, N, W]
    layout (the reference's draws and chunking)."""
    t_chunks = chunks or 1
    ts, values, _ = make_example_raw(n, t_chunks * w, rng)

    def prep(ts2, v2):
        return make_batch_from_raw(
            ts2, v2, np.full(ts2.shape[0], ts2.shape[1], np.int32),
            device=device)

    if chunks is None:
        return prep(ts, values)
    parts = [prep(ts[:, i * w:(i + 1) * w], values[:, i * w:(i + 1) * w])
             for i in range(t_chunks)]
    return IngestBatch(*(torch.stack(cols) for cols in zip(*parts)))


# ------------------------------------------------------------------- mesh


def make_mesh(n_devices: int | None = None, devices=None) -> pmesh.Mesh:
    """The ("shard", "time") mesh over `devices` (default: attached()):
    time axis 2 when the count is 4 or more and even, else every device
    on the shard axis."""
    if devices is None:
        devices = attached()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    t = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    return pmesh.make(devices, (n_devices // t, t), ("shard", "time"))


@functools.lru_cache(maxsize=1)
def flush_mesh() -> pmesh.Mesh | None:
    """The serving flush's shard x time mesh: make_mesh() over every
    attached device when more than one is, else None (one card keeps the
    single-device path). M3_TPU_MESH_FLUSH=0 turns the route off, so
    every seal encodes on one device (the A/B that proves bit-equality
    against the single-device encode: this is the seal's only mesh).
    Cached until `flush_mesh.cache_clear()` or an attach()."""
    if os.environ.get("M3_TPU_MESH_FLUSH", "1") == "0":
        return None
    if len(attached()) <= 1:
        return None
    return make_mesh()


on_attach(flush_mesh.cache_clear)

# The serving flush's encode over the shard x time mesh: a sealed block's
# rows (series) split over BOTH axes.
make_flush_encoder = tsz.encode_over


def flush_encode_prepared(inp: dict, max_words: int, device=None):
    """Prepared encode inputs (ops.tsz.prepare_encode_inputs) through the
    shard x time mesh: (words, nbits) on the mesh's first device,
    bit-identical to the single-device encode. None — the caller runs
    the single-device encode; a routing choice, not a fallback — when no
    mesh is attached, the caller's `device` is of another type than the
    mesh's (mesh.for_device), the row count does not divide the mesh
    (encode_block's power-of-two padding makes most blocks divisible),
    or the tile is below M3_TPU_MESH_FLUSH_MIN_CELLS (default 2048): a
    tiny seal costs more in dispatch than the split saves. A fault on
    the route raises a typed ComputeError and hands back nothing, so the
    caller applies nothing: the seal stays all-or-nothing."""
    mesh = pmesh.for_device(flush_mesh(), device)
    if mesh is None:
        return None
    n, w = np.asarray(inp["dt"]).shape
    ndev = mesh.size
    if n < ndev or n % ndev:
        return None
    if n * w < int(os.environ.get("M3_TPU_MESH_FLUSH_MIN_CELLS", "2048")):
        return None

    def mesh_encode():
        enc = make_flush_encoder(mesh, max_words)
        telemetry.mesh_dispatch("flush_encode", cells=int(n * w))
        return enc(*tsz.prepared_tensors(inp))

    return guard.dispatch("flush_encode", mesh_encode)


CHUNK = ("time", "shard", None)
PER_SERIES = ("time", "shard")
MERGED = ("shard",)


def make_sharded_ingest(mesh: pmesh.Mesh, *, rollup_factor: int,
                        max_words: int, quantile_qs=(0.5, 0.99)):
    """The multi-device ingest step over `mesh`. Its input is a batch
    with a leading time-chunk axis T == the mesh's "time" size ([T, N, W]
    planes, [T, N] per-series headers) split onto the mesh by
    shard_batch. Every entry runs ingest_step on its own block of its
    shard; the whole-window stats merge across the time axis.

    Returns (words [T, N, MW], nbits [T, N], rollup dict [T, N, W//f],
    quantiles [T, N, W//f, Q], whole-window stats dict [N], total_bits):
    the words stay one block per time chunk (the reference's
    per-blockstart fileset layout), all on the mesh's first device."""

    def local_step(batch: IngestBatch):
        return ingest_step(
            IngestBatch(*(a[0] for a in batch)), rollup_factor=rollup_factor,
            max_words=max_words, quantile_qs=quantile_qs,
            device=batch.dt.device)

    def step(parts: np.ndarray):
        outs = pmesh.entry_map(local_step, parts)
        blk = pmesh.pick(outs, 3)
        stat = lambda key: pmesh.entry_map(lambda b: b[key], blk)  # noqa: E731
        whole = {
            "sum": pmesh.psum(stat("sum"), mesh, "time"),
            "sumsq": pmesh.psum(stat("sumsq"), mesh, "time"),
            "count": pmesh.psum(stat("count"), mesh, "time"),
            "min": pmesh.pmin(stat("min"), mesh, "time"),
            "max": pmesh.pmax(stat("max"), mesh, "time"),
        }
        # Centered second moment across chunks (generalized Chan merge):
        # m2_tot = sum_i m2_i + sum_i n_i * (mean_i - mean_tot)^2.
        def m2_term(b, total, count):
            mean_tot = torch.where(count > 0, total / count.clamp(min=1), 0.0)
            dmu = torch.where(b["count"] > 0, agg.mean(b) - mean_tot, 0.0)
            return b["m2"] + b["count"] * dmu * dmu

        whole["m2"] = pmesh.psum(pmesh.entry_map(
            m2_term, blk, whole["sum"], whole["count"]), mesh, "time")
        # first/last come from the first/last chunk holding data.
        lasts = pmesh.all_gather(stat("last"), mesh, "time")     # [T, N_loc]
        firsts = pmesh.all_gather(stat("first"), mesh, "time")
        counts = pmesh.all_gather(stat("count"), mesh, "time")

        def first_last(lst, fst, cnt):
            t_n = lst.shape[0]
            t_idx = torch.arange(t_n, device=lst.device)[:, None]
            last_t = torch.where(cnt > 0, t_idx, -1).amax(dim=0)
            first_t = torch.where(cnt > 0, t_idx, t_n).amin(dim=0)
            last = torch.gather(lst, 0, last_t.clamp(min=0)[None, :])[0]
            first = torch.gather(fst, 0,
                                 first_t.clamp(max=t_n - 1)[None, :])[0]
            return last, first

        fl = pmesh.entry_map(first_last, lasts, firsts, counts)
        whole["last"] = pmesh.pick(fl, 0)
        whole["first"] = pmesh.pick(fl, 1)
        # Compressed-bits total over both axes (bytes/datapoint).
        bits = pmesh.entry_map(lambda nb: nb.to(torch.int64).sum(),
                               pmesh.pick(outs, 1))
        total_bits = pmesh.psum(pmesh.psum(bits, mesh, "time"), mesh, "shard")

        expand = lambda a: a[None]  # noqa: E731
        words = pmesh.gather(pmesh.entry_map(expand, pmesh.pick(outs, 0)),
                             mesh, CHUNK)
        nbits = pmesh.gather(pmesh.entry_map(expand, pmesh.pick(outs, 1)),
                             mesh, PER_SERIES)
        roll = {key: pmesh.gather(pmesh.entry_map(
            lambda r: r[key][None], pmesh.pick(outs, 2)), mesh, CHUNK)
            for key in outs.flat[0][2]}
        qtl = pmesh.gather(pmesh.entry_map(expand, pmesh.pick(outs, 4)),
                           mesh, CHUNK)
        merged = {key: pmesh.gather(v, mesh, MERGED)
                  for key, v in whole.items()}
        return (words, nbits, roll, qtl, merged,
                pmesh.gather(total_bits, mesh, ()))

    return step


_BATCH_SPECS = IngestBatch(dt=CHUNK, t0=PER_SERIES, v=CHUNK,
                           int_mode=PER_SERIES, k=PER_SERIES,
                           npoints=PER_SERIES, ts_regular=PER_SERIES,
                           delta0=PER_SERIES, values=CHUNK)


def shard_batch(batch: IngestBatch, mesh: pmesh.Mesh) -> np.ndarray:
    """A [T, N, ...] batch split onto the mesh by the ingest layout: an
    object array of the mesh's shape, each entry its [1, N/shard, ...]
    IngestBatch placed on its device."""
    per_field = [pmesh.map_slices(lambda a: a, mesh, [a], [spec])
                 for a, spec in zip(batch, _BATCH_SPECS)]
    return pmesh.entry_map(lambda *cols: IngestBatch(*cols), *per_field)
