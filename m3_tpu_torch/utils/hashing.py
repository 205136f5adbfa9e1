"""Murmur3-32 hashing for shard assignment (port of m3_tpu/utils/hashing.py;
reference: src/dbnode/sharding/shardset.go, murmur3.Sum32(id) % numShards).

`murmur3_32` is the scalar pure-Python version for control-plane rates
(`murmur3_32_cached` is its bounded memo for hot IDs);
`hash_batch` hashes many IDs at once through the hash kernel
(ops/codec_kernels.hash_words) over a padded little-endian u32 buffer
built on the host, dispatched through the compute-fault guard (route
codec.hash): a fault on the card raises typed."""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..device import resolve
from ..ops import codec_kernels

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit, bit-exact with the reference's murmur3.Sum32."""
    h = seed & _M32
    n = len(data)
    full = n - n % 4
    for i in range(0, full, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = _rotl32((k * _C1) & _M32, 15)
        h ^= (k * _C2) & _M32
        h = (_rotl32(h, 13) * 5 + 0xE6546B64) & _M32
    k = 0
    tail = data[full:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = _rotl32((k * _C1) & _M32, 15)
        h ^= (k * _C2) & _M32
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


# Bounded memo for hot-ID shard routing: the aggregator hashes the same
# metric IDs once per datapoint. Bounded in both dimensions: entry count
# (lru) and key size (oversize IDs skip the cache), because callers hash
# client-supplied IDs before any validation. 64k x <= 256 B is <= ~16 MB.
_MURMUR_CACHE_MAX_KEY = 256
# the public wrapper below normalizes every non-bytes buffer before this
# memo sees it, so the unhashable/mutable-key hazard cannot reach it
_murmur3_32_lru = functools.lru_cache(maxsize=65536)(murmur3_32)  # m3lint: disable=cache-key-buffer


def murmur3_32_cached(data: bytes, seed: int = 0) -> int:
    """murmur3_32 through the bounded memo."""
    if type(data) is not bytes:
        # bytearray/memoryview hash the same bytes but are unhashable (or
        # mutable: a cache key that could change under the memo).
        data = bytes(data)
    if len(data) > _MURMUR_CACHE_MAX_KEY:
        return murmur3_32(data, seed)
    return _murmur3_32_lru(data, seed)


def pad_ids(ids: Sequence[bytes]):
    """The hash buffer: IDs zero-padded into [N, C] little-endian u32 words
    (C = ceil(longest / 4), at least 1), plus the byte lengths [N]."""
    n = len(ids)
    lens = np.fromiter(map(len, ids), np.int64, n)
    maxlen = int(lens.max(initial=1))
    padded = maxlen + (-maxlen) % 4
    buf = np.zeros((n, padded), np.uint8)
    # One concatenated buffer + boolean scatter instead of a frombuffer
    # per id: row-major mask order equals concatenation order.
    joined = b"".join(ids)
    if joined:
        mask = np.arange(padded)[None, :] < lens[:, None]
        buf[mask] = np.frombuffer(joined, np.uint8)
    return buf.view("<i4"), lens.astype(np.int32)


def hash_batch(ids: Sequence[bytes], seed: int = 0, *, device=None) -> torch.Tensor:
    """murmur3-32 of every ID -> int64 [N] tensor of u32 hash values."""
    dev = resolve(device)
    if len(ids) == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    from ..parallel import guard

    words, lens = pad_ids(ids)
    words_dev = torch.from_numpy(np.ascontiguousarray(words)).to(dev)
    lens_dev = torch.from_numpy(lens).to(dev)
    h = guard.dispatch("codec.hash", lambda: codec_kernels.hash_words(
        words_dev, lens_dev, seed))
    return h.to(torch.int64) & _M32
