"""m3_tpu_torch: the PyTorch/CUDA port of m3_tpu's ingest, codec and
PromQL range-query paths and of its storage node (sealed blocks, the
device block cache, the reverse index), which serves PromQL.

The JAX package `m3_tpu` is the reference this port is held against; the
port imports neither JAX nor anything of `m3_tpu`. Public entry points
run on the CUDA device unless the caller passes `device="cpu"`, which
selects the plain PyTorch versions of the hand-written kernels.
"""

import os as _os

if _os.environ.get("M3_TPU_LOCKDEP", "") not in ("", "0"):
    # Runtime lock-order witness (utils/lockdep.py): must install BEFORE
    # any module of the port allocates a lock, so the package init is the
    # one place early enough. Opt-in — costs nothing when unset.
    from .utils import lockdep as _lockdep

    _lockdep.install()

if _os.environ.get("M3_TPU_NUMERICS", "") not in ("", "0"):
    # Runtime numerics witness (utils/numwatch.py): arms the compiled
    # plan's result observation point and the exit dump. Smoke tiers only
    # — observation copies the padded plane to the host. Opt-in — costs
    # one bool read when off.
    from .utils import numwatch as _numwatch

    _numwatch.install()

if _os.environ.get("M3_TPU_RACEWATCH", "") not in ("", "0"):
    # Runtime race witness (utils/racewatch.py): arms attribute
    # instrumentation on registered shared-state attrs (installing
    # lockdep underneath for held-lock snapshots) and the exit dump. Must
    # install BEFORE the port's modules import so their register() calls
    # instrument at once. Smoke tiers only — a watched attr becomes a
    # descriptor. Opt-in — costs one list append when off.
    from .utils import racewatch as _racewatch

    _racewatch.install()
