"""One round of the codec and the cluster campaign passes in both
packages at the smallest shape (m3_tpu_torch/scripts against the
reference's scripts/fuzz_*.py, imported by path): the port's campaign on
the CPU, the reference's under its CPU backend. A file of its own: the
reference's rounds pay its compiles (about 40 s on the CPU), so the
tier-1 run can place them beside tests/test_torch_campaigns.py."""

import numpy as np

from m3_tpu_torch.scripts import fuzz_cluster, fuzz_codec

from test_torch_campaigns import CPU, SEED, ref  # noqa: F401 (fixture)


def test_codec_round_passes_in_both_packages(ref):
    n, w = fuzz_codec.SHAPES[0]
    got = fuzz_codec.run_round(np.random.default_rng(SEED), n, w, CPU)
    assert got["round trip"] == n and got["merge"] > 0 and got["oracle"] == 6
    assert ref.fuzz_codec.run_round(np.random.default_rng(SEED), n, w) == n


def test_cluster_round_passes_in_both_packages(ref):
    out = fuzz_cluster.run(1, 1, SEED, CPU, log=lambda s: None)
    assert out["walks"] == [["add node100"]] and out["points"] > 0
    assert ref.fuzz_cluster.run_round(np.random.default_rng(SEED), 1) == \
        out["points"]
