"""Client-side decode + replica reconciliation (port of
m3_tpu/client/decode.py).

The reference dbnode returns *compressed* segments; the client's
MultiReaderIterator / SeriesIterator decode and k-way merge across
replicas with same-timestamp conflict strategies
(src/dbnode/encoding/series_iterator.go:76,176, iterators.go:60-105).

Instead of a per-series pull iterator, segments from a fetch are
*stacked by window size* and decoded in one batched launch of the decode
kernel (ops.tsz.decode_plane) on `device` (None: the CUDA card), then
merged per series on the host."""

from __future__ import annotations

import enum
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops import tsz
from ..parallel import telemetry
from ..utils import xtime


class ConflictStrategy(enum.Enum):
    """Cross-replica same-timestamp resolution (encoding/iterators.go:60-105).

    4/4 parity with the reference's IterateLastPushed / IterateHighest /
    IterateLowest / IterateHighestFrequencyValue: HIGHEST_FREQUENCY_VALUE
    picks the value the most replicas agree on at a timestamp, and a
    frequency tie falls back to the last-pushed value among the tied
    candidates, matching the reference's tie behavior."""

    LAST_PUSHED = "last_pushed"
    HIGHEST_VALUE = "highest_value"
    LOWEST_VALUE = "lowest_value"
    HIGHEST_FREQUENCY_VALUE = "highest_frequency_value"


def decode_segment_groups(segments: Sequence[dict], *, device=None
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Decode wire segments -> [(t[int64], v[f64])] aligned with input order.

    Groups by (window, words-width) so each distinct block geometry costs
    exactly one batched kernel invocation."""
    out: List = [None] * len(segments)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, seg in enumerate(segments):
        if seg["npoints"] == 0:
            out[i] = (np.zeros(0, np.int64), np.zeros(0, np.float64))
            continue
        key = (int(seg["window"]), int(np.asarray(seg["words"]).shape[-1]),
               int(seg.get("time_unit", int(xtime.Unit.NANOSECOND))))
        groups.setdefault(key, []).append(i)
    for (window, mw, unit), idxs in groups.items():
        # Shape-bucket the batch: pad rows to a power of two so one compiled
        # decode kernel serves every fetch with this block geometry.
        rows = len(idxs)
        rp = 1 << (max(rows, 1) - 1).bit_length()
        words = np.zeros((rp, mw), np.uint32)
        npoints = np.zeros(rp, np.int32)
        for r, i in enumerate(idxs):
            words[r] = np.asarray(segments[i]["words"])
            npoints[r] = segments[i]["npoints"]
        # Shape-bucket telemetry: a first-seen (rows-pow2, width, window)
        # geometry means a fresh decode-kernel compile for this fetch.
        telemetry.record_bucket("client.decode", (rp, mw, window, unit))
        # Unit scaling fuses into the decode program (one launch; no host
        # multiply pass over the plane).
        ts, vs = tsz.decode_plane(words, npoints, window=window,
                                  unit_nanos=xtime.Unit(unit).nanos,
                                  device=device)
        ts, vs = ts.cpu().numpy(), vs.cpu().numpy()
        for row, i in enumerate(idxs):
            n = int(npoints[row])
            out[i] = (ts[row, :n].copy(), vs[row, :n].copy())
    return out


def decode_tile(words, npoints, window: int, time_unit: int, *,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one columnar block tile ([rows, max_words] words +
    per-row npoints) in a single batched kernel launch, rows padded to a
    power of two so one compiled decode serves every tile with this
    geometry (the decode-side twin of encode_block's shape bucketing —
    same bucketing SealedBlock._decode_plane uses).

    Returns dense ([rows, window] ts_ns, [rows, window] vals) planes;
    row i's valid points are the first npoints[i] columns."""
    words = np.asarray(words)
    npoints = np.asarray(npoints, np.int32)
    n = words.shape[0]
    rp = 1 << (max(n, 1) - 1).bit_length()
    if rp != n:
        words = np.concatenate([words, np.repeat(words[:1], rp - n, 0)])
        np_pad = np.concatenate([npoints, np.repeat(npoints[:1], rp - n)])
    else:
        np_pad = npoints
    telemetry.record_bucket("client.decode_tile",
                            (rp, int(words.shape[-1]), int(window)))
    # Fused decode: tick cumsum + time-unit scaling happen inside the one
    # decode program; the host just slices the padded rows back off.
    ts, vs = tsz.decode_plane(words, np_pad, window=window,
                              unit_nanos=xtime.Unit(time_unit).nanos,
                              device=device)
    return ts[:n].cpu().numpy(), vs[:n].cpu().numpy()


def merge_replica_points(
    ts_parts: Sequence[np.ndarray],
    vs_parts: Sequence[np.ndarray],
    strategy: ConflictStrategy = ConflictStrategy.LAST_PUSHED,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge datapoint runs from multiple replicas of one series: sort by
    timestamp, resolve duplicate timestamps per strategy."""
    ts_parts = [t for t in ts_parts if len(t)]
    if not ts_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    vs_parts = [v for v in vs_parts if len(v)]
    t = np.concatenate(ts_parts)
    v = np.concatenate(vs_parts)
    # Stable sort keeps replica arrival order within equal timestamps, so
    # "last occurrence" == last pushed.
    order = np.argsort(t, kind="stable")
    t, v = t[order], v[order]
    if len(t) < 2:
        return t, v
    uniq, inverse = np.unique(t, return_inverse=True)
    if len(uniq) == len(t):
        return t, v
    if strategy == ConflictStrategy.LAST_PUSHED:
        picked = np.zeros(len(uniq), np.float64)
        picked[inverse] = v  # later writes overwrite earlier per slot
    elif strategy == ConflictStrategy.HIGHEST_FREQUENCY_VALUE:
        # Majority vote per timestamp, resolved for ALL slots in one
        # vectorized grouping pass (with full replica overlap EVERY slot
        # is conflicted, so a per-slot Python scan would be quadratic):
        # group points into (slot, value) runs, count each run, then per
        # slot keep the run with the highest count — ties by the run
        # whose last push arrived latest (last-pushed fallback).
        arrival = np.arange(len(v))
        order = np.lexsort((arrival, v, inverse))
        sv, si, sa = v[order], inverse[order], arrival[order]
        new_run = np.empty(len(sv), bool)
        new_run[0] = True
        np.logical_or(si[1:] != si[:-1], sv[1:] != sv[:-1],
                      out=new_run[1:])
        run_starts = np.flatnonzero(new_run)
        run_slot = si[run_starts]
        run_val = sv[run_starts]
        run_count = np.diff(np.append(run_starts, len(sv)))
        run_last_arrival = sa[np.append(run_starts[1:], len(sv)) - 1]
        # Per slot take the lexicographically greatest (count, last
        # arrival) run: sort runs so it lands last within each slot.
        sel = np.lexsort((run_last_arrival, run_count, run_slot))
        slot_sorted = run_slot[sel]
        last_of_slot = np.empty(len(sel), bool)
        np.not_equal(slot_sorted[1:], slot_sorted[:-1],
                     out=last_of_slot[:-1])
        last_of_slot[-1] = True
        picked = np.zeros(len(uniq), np.float64)
        picked[slot_sorted[last_of_slot]] = run_val[sel[last_of_slot]]
    elif strategy == ConflictStrategy.HIGHEST_VALUE:
        picked = np.full(len(uniq), -np.inf)
        np.maximum.at(picked, inverse, v)
    else:
        picked = np.full(len(uniq), np.inf)
        np.minimum.at(picked, inverse, v)
    return uniq, picked

