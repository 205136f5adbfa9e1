"""Seeded disk-fault injection for the persist/ I/O seam (host copy of
m3_tpu/testing/faultfs.py over the port's persist/diskio.py seam: the
same plans draw the same decisions, so a disk-fault run of the port can
be held against the reference's).

`DiskFaultPlan` is frozen and seeded; the fault schedule is a PURE
FUNCTION of (seed, op, path key): each (op, key) pair owns an
independent `random.Random(f"{seed}/{op}/{key}")` stream, and every
intercepted operation makes exactly ONE draw against cumulative
per-op-family thresholds in a FIXED order (read: flip -> short; write:
eio -> enospc; fsync: eio -> lie; replace: torn). `plan.schedule(op,
key, n)` replays the first n decisions without any I/O — tests assert
the injector's recorded decisions equal it verbatim.

`FaultIO` implements the `persist.diskio.DiskIO` surface:

  read    returns bit-flipped or short bytes (memmap reads materialize
          a flipped copy) — serve-time integrity must DETECT, never
          serve, them;
  write   raises EIO / ENOSPC before any byte lands — flush paths must
          classify (DiskWriteError/DiskFullError) and degrade;
  fsync   raises EIO, or LIES (acks without syncing) — `power_cut()`
          truncates every file back to its last honestly-synced size,
          modelling the data loss a lying-fsync power cut causes;
  replace renames but TEARS the destination (checkpoint dropped) and
          raises — the incomplete fileset must never be served.

`path_filter` (substring match) scopes faults to one node's data dir in
multi-node in-process harnesses. Install with `install(plan)` /
`uninstall()` or the `injected(plan)` context manager — they swap the
module-level `_io` in persist/fs.py and persist/commitlog.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
import random
import threading
from typing import Dict, List, Tuple

import numpy as np

from ..persist import commitlog, diskio, fs

__all__ = ["DiskFaultPlan", "FaultIO", "NO_FAULT", "install", "uninstall",
           "injected"]

NO_FAULT = "ok"


@dataclasses.dataclass(frozen=True)
class DiskFaultPlan:
    """Per-operation fault probabilities. All zero = benign passthrough
    (the injector still records decisions, so determinism is testable
    without faults)."""

    seed: int = 0
    read_flip: float = 0.0      # one bit of the returned bytes flipped
    read_short: float = 0.0     # fewer bytes than asked for
    write_eio: float = 0.0      # OSError(EIO) before any byte lands
    write_enospc: float = 0.0   # OSError(ENOSPC) — full disk
    fsync_eio: float = 0.0      # OSError(EIO) from fsync
    fsync_lie: float = 0.0      # fsync acks but does NOT sync
    torn_replace: float = 0.0   # os.replace tears the destination
    path_filter: str = ""       # substring: faults only matching paths

    _FAMILIES = {
        "read": ("flip", "short"),
        "write": ("eio", "enospc"),
        "fsync": ("eio", "lie"),
        "replace": ("torn",),
    }

    def _probs(self, op: str) -> Tuple[Tuple[str, float], ...]:
        if op == "read":
            return (("flip", self.read_flip), ("short", self.read_short))
        if op == "write":
            return (("eio", self.write_eio), ("enospc", self.write_enospc))
        if op == "fsync":
            return (("eio", self.fsync_eio), ("lie", self.fsync_lie))
        if op == "replace":
            return (("torn", self.torn_replace),)
        raise ValueError(f"unknown disk op {op!r}")

    def matches(self, path: str) -> bool:
        return not self.path_filter or self.path_filter in path

    def _rng(self, op: str, key: str) -> random.Random:
        return random.Random(f"{self.seed}/{op}/{key}")

    def decide(self, rng: random.Random, op: str) -> str:
        """ONE draw against cumulative thresholds in fixed order — the
        whole schedule is reproducible from the seed alone."""
        draw = rng.random()
        acc = 0.0
        for name, p in self._probs(op):
            acc += p
            if draw < acc:
                return name
        return NO_FAULT

    def schedule(self, op: str, key: str, n: int) -> List[str]:
        """The first n decisions for (op, key) — a pure function of the
        plan; what the injector WILL do, computable without any I/O."""
        rng = self._rng(op, key)
        return [self.decide(rng, op) for _ in range(n)]


def _path_key(path: str) -> str:
    """Stable per-file stream key: the last two path components
    (`shard-00001/fileset-7200...`, `commitlog/commitlog-00000000.bin`),
    so schedules survive tempdir prefixes differing across runs."""
    parts = os.path.normpath(path).split(os.sep)
    return "/".join(parts[-2:])


class _FaultFile:
    """File-object proxy: read faults mutate returned bytes, write
    faults raise before any byte lands. Everything else delegates."""

    def __init__(self, io: "FaultIO", f, path: str, binary: bool):
        self._ff_io = io
        self._ff_f = f
        self._ff_path = path
        self._ff_binary = binary

    # -------------------------------------------------------------- faulted

    def read(self, n: int = -1):
        data = self._ff_f.read(n)
        if not self._ff_binary or not data:
            return data
        d, pos_rng = self._ff_io._decide("read", self._ff_path)
        if d == "flip":
            buf = bytearray(data)
            i = pos_rng.randrange(len(buf))
            buf[i] ^= 1 << pos_rng.randrange(8)
            return bytes(buf)
        if d == "short":
            return data[: pos_rng.randrange(len(data))]
        return data

    def write(self, b):
        d, _ = self._ff_io._decide("write", self._ff_path)
        if d == "eio":
            raise OSError(errno.EIO, "injected EIO", self._ff_path)
        if d == "enospc":
            raise OSError(errno.ENOSPC, "injected ENOSPC", self._ff_path)
        return self._ff_f.write(b)

    # ------------------------------------------------------------- delegate

    def __getattr__(self, name):
        return getattr(self._ff_f, name)

    def __iter__(self):
        return iter(self._ff_f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ff_f.close()
        return False


class FaultIO(diskio.DiskIO):
    """Seeded fault-injecting DiskIO. Thread-safe; `decisions` and
    `faults_injected` mirror faultnet's observability so scenarios can
    assert the chaos actually happened."""

    def __init__(self, plan: DiskFaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._streams: Dict[Tuple[str, str], random.Random] = {}
        self.decisions: Dict[Tuple[str, str], List[str]] = {}
        self.faults_injected = 0
        # path -> last honestly-synced size (fsync-lie bookkeeping).
        self._durable: Dict[str, int] = {}
        self.fsync_lies = 0

    # ------------------------------------------------------------ decisions

    def _decide(self, op: str, path: str) -> Tuple[str, random.Random]:
        """(decision, position rng). The decision stream makes exactly
        one draw per op (schedule-reproducible); fault positions draw
        from a SEPARATE derived rng so they never perturb the stream."""
        if not self.plan.matches(path):
            return NO_FAULT, random.Random(0)
        key = _path_key(path)
        with self._lock:
            rng = self._streams.get((op, key))
            if rng is None:
                rng = self._streams[(op, key)] = self.plan._rng(op, key)
            d = self.plan.decide(rng, op)
            log = self.decisions.setdefault((op, key), [])
            log.append(d)
            if d != NO_FAULT:
                self.faults_injected += 1
            pos_rng = random.Random(
                f"{self.plan.seed}/pos/{op}/{key}/{len(log)}")
        return d, pos_rng

    # ------------------------------------------------------------ DiskIO

    def open(self, path: str, mode: str = "r", **kw):
        f = open(path, mode, **kw)
        if self.plan.matches(path) and any(c in mode for c in "wax+"):
            # Baseline for power_cut(): what's on disk at open time is
            # (assumed) durable; only honestly-fsynced growth past this
            # survives a simulated power loss.
            try:
                size = os.fstat(f.fileno()).st_size
            except OSError:
                size = 0
            with self._lock:
                self._durable[os.path.abspath(path)] = size
        return _FaultFile(self, f, path, "b" in mode)

    def fsync(self, f) -> None:
        path = getattr(f, "_ff_path", None)
        raw = getattr(f, "_ff_f", f)
        if path is None:
            os.fsync(raw.fileno())
            return
        d, _ = self._decide("fsync", path)
        if d == "eio":
            raise OSError(errno.EIO, "injected fsync EIO", path)
        if d == "lie":
            # Acked but NOT synced: durable size stays stale, so a
            # power_cut() drops everything written since the last
            # honest sync — the lying-firmware failure mode.
            with self._lock:
                self.fsync_lies += 1
            return
        os.fsync(raw.fileno())
        try:
            size = os.fstat(raw.fileno()).st_size
        except OSError:
            return
        with self._lock:
            self._durable[os.path.abspath(path)] = size

    def replace(self, src: str, dst: str) -> None:
        d, _ = self._decide("replace", dst)
        if d == "torn":
            # The rename lands but the destination is TORN (checkpoint
            # gone — what a crash between data rename and checkpoint
            # durability leaves): fileset_complete() must reject it, and
            # the caller sees a typed failure so the flush retries.
            os.replace(src, dst)
            cp = os.path.join(dst, fs.CHECKPOINT_FILE)
            if os.path.isdir(dst) and os.path.exists(cp):
                os.remove(cp)
            raise OSError(errno.EIO, "injected torn replace", dst)
        os.replace(src, dst)

    def memmap(self, path: str, dtype, shape) -> np.ndarray:
        arr = np.memmap(path, dtype=dtype, mode="r", shape=shape)
        d, pos_rng = self._decide("read", path)
        if d == NO_FAULT:
            return arr
        # Any read fault on a mapping materializes a FLIPPED copy (a
        # short mapping isn't representable): one bit of one word.
        out = np.array(arr)
        if out.size:
            flat = out.reshape(-1)
            i = pos_rng.randrange(flat.size)
            flat[i] ^= np.asarray(
                1 << pos_rng.randrange(8 * flat.dtype.itemsize),
                dtype=flat.dtype)
        return out

    # ----------------------------------------------------------- power cut

    def power_cut(self) -> int:
        """Simulate power loss: truncate every tracked file back to its
        last honestly-synced size, dropping bytes a lying fsync acked.
        Returns the number of files truncated."""
        with self._lock:
            items = list(self._durable.items())
        cut = 0
        for path, size in items:
            try:
                if os.path.exists(path) and os.path.getsize(path) > size:
                    with open(path, "rb+") as f:
                        f.truncate(size)
                    cut += 1
            except OSError:
                pass
        return cut


# ------------------------------------------------------------ installation


def install(plan: DiskFaultPlan) -> FaultIO:
    """Swap the persist/ disk seam to a fault injector; returns it."""
    io = FaultIO(plan)
    fs._io = io
    commitlog._io = io
    return io


def uninstall() -> None:
    fs._io = diskio.DEFAULT
    commitlog._io = diskio.DEFAULT


@contextlib.contextmanager
def injected(plan: DiskFaultPlan):
    io = install(plan)
    try:
        yield io
    finally:
        uninstall()
