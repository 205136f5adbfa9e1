"""Disk I/O seam for persist/ (reference: the reference platform's
persist/fs os wrappers, which the dtest disk-fault drills interpose on).

Every file operation persist/fs.py and persist/commitlog.py perform is
routed through a module-level `_io` that defaults to the passthrough
`DiskIO` below — one attribute lookup plus one delegating call when no
injector is installed (zero overhead when off, the faultnet seam
contract). `m3_tpu.testing.faultfs` swaps in a seeded `FaultIO` that
returns bit-flipped/short reads, raises EIO/ENOSPC on writes, lies on
fsync, and tears `os.replace` — the disk leg of the fault trilogy
(network: faultnet, crash: kill -9 drill, disk: this).

Typed error taxonomy (classification the lint tree enforces in
analysis/diskio_rules.py — persist callers must never fold these into a
bare `except Exception`):

  CorruptionError   bytes on disk diverge from their recorded checksum
                    (row adler, digest chain, chunk adler). Subclasses
                    IOError so pre-existing `except (IOError, ...)`
                    handlers keep working, and NonRetryableError so a
                    Retrier never re-reads rotten bytes — corruption is
                    repaired from peers, not retried.
  DiskWriteError    a write/flush/fsync failed (EIO et al). Retryable:
                    transient media errors clear; the flush path retries
                    with backoff and degrades health while they persist.
  DiskFullError     ENOSPC/EDQUOT — DiskWriteError specialization so
                    full-disk shows up typed in health/degradation.
"""

from __future__ import annotations

import errno
import os
from typing import Iterable, Optional, Sequence

import numpy as np

from ..utils.retry import NonRetryableError

__all__ = [
    "CorruptionError", "DiskWriteError", "DiskFullError",
    "classify_write_error", "DiskIO", "DEFAULT",
]


class CorruptionError(IOError, NonRetryableError):
    """On-disk bytes diverge from their recorded checksum. Carries the
    failing path and (when row-granular) the failing rows/ids so the
    quarantine sidecar can name them."""

    def __init__(self, message: str, path: Optional[str] = None,
                 rows: Sequence[int] = (), ids: Iterable[bytes] = ()):
        super().__init__(message)
        self.path = path
        self.rows = [int(r) for r in rows]
        self.ids = [bytes(i) for i in ids]


class DiskWriteError(IOError):
    """A write/flush/fsync to durable storage failed."""

    def __init__(self, message: str, path: Optional[str] = None,
                 errno_: Optional[int] = None):
        super().__init__(message)
        self.path = path
        self.errno = errno_


class DiskFullError(DiskWriteError):
    """ENOSPC/EDQUOT: the device is out of space, not merely flaky."""


_FULL_ERRNOS = {errno.ENOSPC, getattr(errno, "EDQUOT", errno.ENOSPC)}


def classify_write_error(e: OSError, path: Optional[str] = None
                         ) -> DiskWriteError:
    """Fold a raw OSError from a durable write into the typed taxonomy
    (ENOSPC/EDQUOT -> DiskFullError, anything else -> DiskWriteError).
    Already-typed errors pass through unchanged so a double classify is
    idempotent."""
    if isinstance(e, DiskWriteError):
        return e
    num = getattr(e, "errno", None)
    cls = DiskFullError if num in _FULL_ERRNOS else DiskWriteError
    return cls(f"{type(e).__name__}: {e}", path=path, errno_=num)


class DiskIO:
    """Passthrough file operations — the exact set persist/ uses. An
    injector subclasses this; the default is stateless and shared."""

    def open(self, path: str, mode: str = "r", **kw):
        return open(path, mode, **kw)

    def fsync(self, f) -> None:
        os.fsync(f.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def remove(self, path: str) -> None:
        os.remove(path)

    def memmap(self, path: str, dtype, shape) -> np.ndarray:
        return np.memmap(path, dtype=dtype, mode="r", shape=shape)


DEFAULT = DiskIO()
