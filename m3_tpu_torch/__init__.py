"""m3_tpu_torch: the PyTorch/CUDA port of m3_tpu's ingest, codec and
PromQL range-query paths and of its storage node (sealed blocks, the
device block cache, the reverse index), which serves PromQL.

The JAX package `m3_tpu` is the reference this port is held against; the
port imports neither JAX nor anything of `m3_tpu`. Public entry points
run on the CUDA device unless the caller passes `device="cpu"`, which
selects the plain PyTorch versions of the hand-written kernels.
"""
