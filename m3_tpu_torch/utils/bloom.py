"""Bloom filter over series IDs (port of m3_tpu/utils/bloom.py; reference:
m3db/bloom used by fileset seekers, src/dbnode/persist/fs/bloom_filter.go)
— numpy bit array with k murmur3 hashes derived from two base hashes
(Kirsch-Mitzenmacher).

`add_batch` hashes every ID twice through the hash kernel
(utils.hashing.hash_batch) on `device` (None: the CUDA card, raising
without one), brings both hash vectors to the host in one copy and
computes the bit positions there in uint64, exactly as the reference
does, so the filter's bytes equal the reference's. `add` and membership
tests stay on the scalar murmur3."""

from __future__ import annotations

import math

import numpy as np
import torch

from .hashing import hash_batch, murmur3_32

SEED2 = 0x9747B28C


class BloomFilter:
    def __init__(self, m_bits: int, k: int):
        self.m = max(int(m_bits), 8)
        self.k = max(int(k), 1)
        self.bits = np.zeros((self.m + 7) // 8, np.uint8)

    @staticmethod
    def for_capacity(n: int, false_positive_rate: float = 0.02) -> "BloomFilter":
        n = max(n, 1)
        m = int(-n * math.log(false_positive_rate) / (math.log(2) ** 2)) + 1
        k = max(int(round(m / n * math.log(2))), 1)
        return BloomFilter(m, k)

    def _positions(self, item: bytes) -> np.ndarray:
        h1 = murmur3_32(item)
        h2 = murmur3_32(item, seed=SEED2)
        i = np.arange(self.k, dtype=np.uint64)
        return ((h1 + i * h2) % np.uint64(self.m)).astype(np.int64)

    def add(self, item: bytes):
        pos = self._positions(item)
        np.bitwise_or.at(self.bits, pos >> 3, (1 << (pos & 7)).astype(np.uint8))

    def add_batch(self, items, *, device=None):
        if not len(items):
            return
        both = torch.stack([hash_batch(items, device=device),
                            hash_batch(items, seed=SEED2, device=device)])
        h1, h2 = both.cpu().numpy().astype(np.uint64)
        i = np.arange(self.k, dtype=np.uint64)[None, :]
        pos = ((h1[:, None] + i * h2[:, None]) % np.uint64(self.m)).astype(np.int64).ravel()
        np.bitwise_or.at(self.bits, pos >> 3, (1 << (pos & 7)).astype(np.uint8))

    def __contains__(self, item: bytes) -> bool:
        pos = self._positions(item)
        return bool(((self.bits[pos >> 3] >> (pos & 7)) & 1).all())

    def tobytes(self) -> bytes:
        return self.bits.tobytes()

    @classmethod
    def frombytes(cls, data: bytes, m_bits: int, k: int) -> "BloomFilter":
        bf = cls(m_bits, k)
        bf.bits = np.frombuffer(data, np.uint8).copy()
        return bf
