"""Device selection for the port's entry points, and the process's device
list that the mesh routes split work over.

`None` means the CUDA device. There is no silent fallback: without a card
the caller must ask for the CPU explicitly, which runs the plain PyTorch
versions of the kernels.

`attached()` is the analogue of `jax.devices()`: every CUDA device by
default, so one card (or none) keeps every mesh route off, as the
reference's routes are off on one device. `attach(devices)` replaces the
list for a `with` block, repeats allowed: `[torch.device("cpu")] * 8` is
the CPU tests' stand-in for the reference's eight virtual devices
(`--xla_force_host_platform_device_count=8`), `[cuda:0] * 4` a four-way
split of one card."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence

import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA is
    requested (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "m3_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions")
    return dev


_LOCK = threading.Lock()
_ATTACHED: Optional[List[torch.device]] = None
# cache_clear of every cached mesh (parallel/ingest.flush_mesh,
# query/executor._default_query_mesh), registered by each module as it
# is imported.
_ON_ATTACH: List[Callable[[], None]] = []


def on_attach(clear: Callable[[], None]) -> Callable[[], None]:
    """Register a cached mesh's `cache_clear`: attach() calls it on entry
    and on exit, so no mesh outlives the device list it was built from."""
    _ON_ATTACH.append(clear)
    return clear


def attached() -> List[torch.device]:
    """The process's device list: what attach() set, else every CUDA
    device (empty without a card)."""
    with _LOCK:
        if _ATTACHED is not None:
            return list(_ATTACHED)
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _clear_meshes() -> None:
    for clear in list(_ON_ATTACH):
        clear()


@contextlib.contextmanager
def attach(devices: Sequence):
    """Replace the device list for the block (repeats allowed; each entry
    resolved, so a CUDA entry without a card raises here). Every cached
    mesh is dropped on entry and on exit."""
    global _ATTACHED
    devs = [resolve(d) for d in devices]
    with _LOCK:
        prev = _ATTACHED
        _ATTACHED = devs
    _clear_meshes()
    try:
        yield devs
    finally:
        with _LOCK:
            _ATTACHED = prev
        _clear_meshes()
