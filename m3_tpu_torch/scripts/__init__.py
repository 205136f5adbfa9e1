"""The port's robustness tier: the seeded fuzz campaigns, the soaks, the
multi-process integration smoke and `check_all`, each the counterpart of
the script of the same name under the repository's scripts/ directory.

Each runs as `python -m m3_tpu_torch.scripts.<name>` with that script's
flags, on the CUDA card unless given `--device cpu`, and raises without a
card; `main(argv)` is the entry point and returns the exit code.
"""

import argparse
import re
import time

import torch


def device_arg(ap: argparse.ArgumentParser) -> None:
    """The campaigns' `--device` flag: the CUDA card unless `cpu` is
    asked for (no fallback: without a card the run raises)."""
    ap.add_argument("--device", default=None,
                    help="cpu runs the kernels' plain versions on the host; "
                         "the default is the CUDA card")


def launches_since(before: dict) -> dict:
    """Each kernel's launches since the `ops.kernel_launches()` snapshot
    `before` (card launches only: a CPU run's plain versions count none)."""
    from ..ops import kernel_launches

    return {k: n - before.get(k, 0) for k, n in kernel_launches().items()}


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def await_cond(cond, what: str, timeout: float = 120.0) -> None:
    """Poll `cond()` every 0.1 s until it holds; AssertionError naming
    `what` after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.1)


def await_line(op, pattern: str, what: str, timeout: float = 120.0) -> str:
    """The first line a child (an em.Operator) printed that matches
    `pattern`, waiting for it."""
    rx = re.compile(pattern)
    found = []

    def seen():
        found[:] = [ln for ln in list(op.output) if rx.search(ln)]
        return bool(found)

    await_cond(seen, f"{what} ({pattern!r})", timeout)
    return found[0]
