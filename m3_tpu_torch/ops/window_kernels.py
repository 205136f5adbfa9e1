"""The query path's hand-written CUDA kernel: strided window moments.

Counterpart of m3_tpu/ops/pallas_window.py. One kernel, in
m3_tpu_torch/csrc/window.cu, built into the extension of
ops/codec_kernels.py:

  window_stat   csrc/window.cu   replaces pallas_window._kernel

On a CUDA tensor the wrapper launches the kernel on the current stream
through the binding, which checks dtype, shape, contiguity and the window
and raises on anything else; there is no fallback. On a CPU tensor the
wrapper makes the same checks in Python and runs the plain PyTorch version
beside it (`window_stat_plain`). It counts its launches in
`window_stat.launches`.
"""

from __future__ import annotations

import torch

from .aggregation import _amax, _amin
from .codec_kernels import _check, build

F32 = torch.float32
STATS = ("count", "sum", "min", "max", "last", "m2")
_STAT_INDEX = {name: i for i, name in enumerate(STATS)}  # csrc/window.cu Stat
# The card's oracles (m3lint's unguarded-kernel-dispatch): the tests that
# hold K4 against window_stat_plain on the card, and the chip_smoke.py
# check that does so at three grids on every run.
_CARD_ORACLE = "tests/test_torch_cuda.py"
_CHIP_SMOKE_PHASE = "def _check_window("


def window_stat_plain(resid, W: int, stride: int, stat: str):
    """The temporal._window_stat twin: masked reductions over the
    [S, T_out, W] unfolded view, m2 in the two-pass form. Empty windows
    give 0 (sum, last, m2), +inf (min) or -inf (max), as the kernel does;
    min and max order -0.0 below +0.0 and `last` is selected, never
    summed, so signed zeros agree with XLA and the kernel."""
    vol = resid.unfold(1, W, stride)                  # [S, T_out, W] view
    mask = torch.isfinite(vol)
    cnt = mask.sum(-1).to(F32)
    if stat == "count":
        out = cnt
    elif stat == "sum":
        out = torch.where(mask, vol, 0.0).sum(-1)
    elif stat == "min":
        out = _amin(torch.where(mask, vol, float("inf")), -1)
    elif stat == "max":
        out = _amax(torch.where(mask, vol, float("-inf")), -1)
    elif stat == "last":
        idx = torch.arange(W, device=resid.device)
        last_i = torch.where(mask, idx, -1).amax(-1).clamp(min=0)
        picked = vol.gather(-1, last_i[..., None])[..., 0]
        out = torch.where(cnt > 0, picked, 0.0)
    elif stat == "m2":
        s = torch.where(mask, vol, 0.0).sum(-1)
        mu = s / cnt.clamp(min=1)
        dev = torch.where(mask, vol - mu[..., None], 0.0)
        out = (dev * dev).sum(-1)
    else:
        raise ValueError(f"unknown window stat {stat!r}")
    return out, cnt


def window_stat(resid, W: int, stride: int, stat: str):
    """(stat [S, T_out] f32, count [S, T_out] f32) over the strided windows
    of `resid` ([S, K] f32, non-finite = missing); window t reads columns
    [t * stride, t * stride + W), T_out = (K - W) // stride + 1. Needs
    K >= W: the caller (temporal._window_stat_strided) returns the empty
    planes itself. On a CUDA tensor the binding checks the input and
    returns both planes as views of one [2, S, T_out] allocation."""
    which = _STAT_INDEX.get(stat)
    if which is None:
        raise ValueError(f"unknown window stat {stat!r}")
    if isinstance(resid, torch.Tensor) and resid.is_cuda:
        out = build().window(resid, int(W), int(stride), which)
        if out.shape[1]:
            window_stat.launches += 1
        return out.unbind(0)
    dev = resid.device
    _check("window_stat", dict(resid=resid), F32, 2, dev)
    W, stride = int(W), int(stride)
    K = resid.shape[1]
    if W < 1 or stride < 1 or K < W:
        raise ValueError(f"window_stat: need 1 <= W <= K and stride >= 1, "
                         f"got W={W}, stride={stride}, K={K}")
    return window_stat_plain(resid, W, stride, stat)


window_stat.launches = 0
