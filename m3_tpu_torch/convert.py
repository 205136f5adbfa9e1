"""State carried between the JAX package and the port.

The system has no weights: its state is the data and the encoded streams.
The reference keeps 64-bit values as (hi, lo) uint32 pairs and words as
uint32; the port keeps int64 and int32 bit patterns. These helpers move
the reference's host arrays (numpy; JAX arrays convert with np.asarray)
onto a device in the port's layout, and the port's tensors back to numpy
in the reference's dtypes. Sealed blocks cross both ways: a block sealed
by one package reads back identically in the other."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.ingest import IngestBatch, RawIngestBatch
from .storage.block import SealedBlock
from .utils import xtime


def _t(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a).astype(dtype), device=device)


def pair_to_int64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 arrays -> int64 array."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def words_to_torch(words, device) -> torch.Tensor:
    """np.uint32 words [N, MW] -> int32 bit-pattern tensor on `device`."""
    return torch.tensor(np.asarray(words, dtype=np.uint32).view(np.int32),
                        device=device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern words -> np.uint32, as the reference returns
    them. The port's other planes already have the reference's dtypes
    (int64 ticks and value bits, f64 values): `.cpu().numpy()`."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def ingest_batch_to_torch(batch, device) -> IngestBatch:
    """The reference's IngestBatch (t0_hi/t0_lo, vhi/vlo pairs) -> the
    port's IngestBatch on `device`."""
    return IngestBatch(
        dt=_t(batch.dt, np.int32, device),
        t0=_t(pair_to_int64(batch.t0_hi, batch.t0_lo), np.int64, device),
        v=_t(pair_to_int64(batch.vhi, batch.vlo), np.int64, device),
        int_mode=_t(batch.int_mode, bool, device),
        k=_t(batch.k, np.int32, device),
        npoints=_t(batch.npoints, np.int32, device),
        ts_regular=_t(batch.ts_regular, bool, device),
        delta0=_t(batch.delta0, np.int32, device),
        values=_t(batch.values, np.float32, device))


def raw_batch_to_torch(raw, device) -> RawIngestBatch:
    """The reference's RawIngestBatch (u32 [N, W, 2] native-order pair
    views of the int64 timestamps and f64 values) -> the port's."""
    ts = np.ascontiguousarray(np.asarray(raw.ts_pairs, np.uint32)).view(np.int64)[..., 0]
    v = np.ascontiguousarray(np.asarray(raw.v_pairs, np.uint32)).view(np.float64)[..., 0]
    return RawIngestBatch(_t(ts, np.int64, device), _t(v, np.float64, device),
                          _t(raw.npoints, np.int32, device))


def _boundary_copy(boundary):
    if boundary is None:
        return None
    return {k: np.array(v, copy=True) for k, v in boundary.items()}


def sealed_block_to_torch(ref_blk, device) -> SealedBlock:
    """The reference's SealedBlock (numpy words u32 [S, MW], nbits,
    npoints, series_indices, window, time_unit, boundary) -> the port's,
    reading and decoding on `device`. The streams are the same bits: the
    port's blocks keep the reference's host layout."""
    return SealedBlock(
        block_start=int(ref_blk.block_start),
        window=int(ref_blk.window),
        series_indices=np.array(ref_blk.series_indices, np.int32),
        words=np.array(ref_blk.words, np.uint32),
        nbits=np.array(ref_blk.nbits, np.int32),
        npoints=np.array(ref_blk.npoints, np.int32),
        time_unit=xtime.Unit(int(ref_blk.time_unit)),
        checksum=int(ref_blk.checksum),
        boundary=_boundary_copy(ref_blk.boundary),
        device=device)


def sealed_block_to_numpy(blk: SealedBlock) -> dict:
    """The port's SealedBlock -> the keyword arguments of the reference's
    SealedBlock, numpy in its dtypes (time_unit as the unit's integer
    value, which both packages' xtime.Unit share)."""
    return dict(
        block_start=int(blk.block_start),
        window=int(blk.window),
        series_indices=np.array(blk.series_indices, np.int32),
        words=np.array(blk.words, np.uint32),
        nbits=np.array(blk.nbits, np.int32),
        npoints=np.array(blk.npoints, np.int32),
        time_unit=int(blk.time_unit),
        checksum=int(blk.checksum),
        boundary=_boundary_copy(blk.boundary))
