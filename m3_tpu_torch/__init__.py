"""m3_tpu_torch: the PyTorch/CUDA port of m3_tpu's ingest, codec and
PromQL range-query paths and of its storage node (sealed blocks, the
device block cache, the reverse index), which serves PromQL.

The JAX package `m3_tpu` is the reference this port is held against; the
port imports neither JAX nor anything of `m3_tpu`. Public entry points
run on the CUDA device unless the caller passes `device="cpu"`, which
selects the plain PyTorch versions of the hand-written kernels.
"""

import os as _os

if _os.environ.get("M3_TPU_NUMERICS", "") not in ("", "0"):
    # Runtime numerics witness (utils/numwatch.py): arms the compiled
    # plan's result observation point and the exit dump. Smoke tiers only
    # — observation copies the padded plane to the host. Opt-in — costs
    # one bool read when off.
    from .utils import numwatch as _numwatch

    _numwatch.install()
