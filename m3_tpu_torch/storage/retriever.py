"""Disk-backed block retrieval on the serving read path (port of
m3_tpu/storage/retriever.py).

The reference serves cold reads through a per-shard seeker manager —
bloom filter -> index lookup -> data-file block read
(src/dbnode/persist/fs/seek.go:159,332 SeekByID) — hooked into storage via
a block retriever (src/dbnode/storage/block/retriever_manager.go), with
retrieved blocks cached in a global byte-bounded LRU, the WiredList
(src/dbnode/storage/block/wired_list.go:77).

Here `BlockRetriever` fronts `persist.fs.Seeker`s for every complete
fileset, returns one decoded series per call, and caches the retrieved
row as a one-row `SealedBlock` through `WiredList` so repeated reads of a
hot cold-series skip both the seek and the device decode launch. Fileset
listings and open seekers are cached and invalidated when a flush lands.

A miss decodes its row on the retriever's `device` (None: the CUDA card,
raising without one): one launch of the decode kernel at N = 1 per
(series, block); the rows are not batched across reads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..device import resolve
from ..persist.diskio import CorruptionError
from ..utils import xtime
from ..utils.instrument import ROOT
from .block import SealedBlock, WiredList

_CORRUPTION = ROOT.sub_scope("storage.corruption")


class BlockRetriever:
    """Serving-path cold reads: fileset seek + WiredList block cache."""

    def __init__(self, persist_manager, wired_list: Optional[WiredList] = None,
                 max_open_seekers: int = 128, *, device=None):
        self.pm = persist_manager
        self.device = resolve(device)
        self.wired = wired_list if wired_list is not None else WiredList()
        self.max_open_seekers = max_open_seekers
        # Reentrant: _seeker holds it across construction (which calls
        # block_starts) so concurrent cold opens of one block build one
        # Seeker, not N.
        self._lock = threading.RLock()
        # (ns, shard) -> {block_start: fileset path}; refreshed on invalidate.
        self._filesets: Dict[Tuple[bytes, int], Dict[int, str]] = {}
        # LRU of open seekers, keyed (ns, shard, block_start) — the seeker
        # manager's bounded pool of open file handles (seek_manager.go).
        self._seekers: "OrderedDict[Tuple[bytes, int, int], object]" = OrderedDict()
        self.stats = {"seeks": 0, "wired_hits": 0, "misses": 0}

    # ------------------------------------------------------------- listings

    def block_starts(self, namespace: bytes, shard: int) -> Dict[int, str]:
        """Complete on-disk filesets for a shard: {block_start: path}."""
        key = (namespace, shard)
        with self._lock:
            got = self._filesets.get(key)
            if got is None:
                got = dict(self.pm.list_filesets(namespace, shard))
                self._filesets[key] = got
            return got

    def invalidate(self, namespace: Optional[bytes] = None, shard: Optional[int] = None):
        """Drop cached listings/seekers/wired blocks after a flush or cleanup
        changes the on-disk fileset population (stale seekers would serve
        deleted files; stale listings would open removed paths)."""
        with self._lock:
            if namespace is None:
                self._filesets.clear()
                self._seekers.clear()
                self.wired.drop(lambda k: True)
                return
            for k in [k for k in self._filesets
                      if k[0] == namespace and (shard is None or k[1] == shard)]:
                del self._filesets[k]
            for k in [k for k in self._seekers
                      if k[0] == namespace and (shard is None or k[1] == shard)]:
                del self._seekers[k]
            self.wired.drop(
                lambda k: k[0] == namespace and (shard is None or k[1] == shard))

    # ------------------------------------------------------------- retrieval

    def _seeker(self, namespace: bytes, shard: int, block_start: int):
        from ..persist.fs import Seeker

        key = (namespace, shard, block_start)
        with self._lock:
            sk = self._seekers.get(key)
            if sk is not None:
                self._seekers.move_to_end(key)
                return sk
            path = self.block_starts(namespace, shard).get(block_start)
            if path is None:
                return None
            sk = Seeker(path)
            self._seekers[key] = sk
            while len(self._seekers) > self.max_open_seekers:
                self._seekers.popitem(last=False)
            return sk

    def retrieve(self, namespace: bytes, shard: int, block_start: int,
                 series_id: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Decoded (timestamps_ns, values) for one series from disk, or None.

        WiredList hit skips the seek and the decode stays off the fileset;
        a miss seeks (bloom -> index binary search -> mmap row) and wires
        the one-row block in.
        """
        key = (namespace, shard, block_start, series_id)
        blk = self.wired.get(key)
        if blk is not None:
            self.stats["wired_hits"] += 1
            return blk.read(0)
        try:
            sk = self._seeker(namespace, shard, block_start)
            if sk is None:
                return None
            self.stats["seeks"] += 1
            got = sk.seek(series_id)
        except CorruptionError as e:
            # Rotten bytes detected (row adler or digest mismatch):
            # quarantine the fileset and serve the window from whatever
            # coverage remains (WAL buffer, peers) instead of crashing
            # the query — the scrubber repairs + un-quarantines later.
            self._quarantine(namespace, shard, block_start, e)
            return None
        except (ValueError, KeyError) as e:
            # Unparseable fileset metadata (corrupt info/digest json) is
            # corruption too — it just dies before a checksum can speak.
            self._quarantine(namespace, shard, block_start, e)
            return None
        if got is None:
            self.stats["misses"] += 1
            return None
        row, nbits, npoints = got
        blk = SealedBlock(
            block_start=block_start,
            window=sk.info["window"],
            series_indices=np.zeros(1, np.int32),
            words=np.ascontiguousarray(row, np.uint32)[None, :],
            nbits=np.array([nbits], np.int32),
            npoints=np.array([npoints], np.int32),
            time_unit=xtime.Unit(sk.info["time_unit"]),
            device=self.device,
        )
        self.wired.put(key, blk)
        return blk.read(0)

    def _quarantine(self, namespace: bytes, shard: int, block_start: int,
                    err: Exception) -> None:
        """Serve-time corruption response: rename the fileset into
        `<shard-dir>/quarantine/` with a sidecar naming the failing rows,
        then drop every cached handle on the shard (listing, seekers,
        wired one-row blocks — whose device-cache generations invalidate
        via WiredList.drop). The window keeps serving from WAL/peer
        coverage; the scrubber's repair pass rebuilds and un-quarantines."""
        from ..persist import fs as pfs

        with self._lock:
            path = self._filesets.get((namespace, shard), {}).get(block_start)
        if path is None:
            try:
                path = dict(self.pm.list_filesets(namespace, shard)
                            ).get(block_start)
            except OSError:
                path = None
        if path is not None:
            pfs.quarantine_fileset(
                path, reason=f"{type(err).__name__}: {err}",
                rows=getattr(err, "rows", ()), ids=getattr(err, "ids", ()))
        self.invalidate(namespace, shard)
        _CORRUPTION.counter("serve_quarantined").inc()
