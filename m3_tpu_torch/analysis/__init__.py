"""m3lint on the PyTorch port: repo-native static analysis of
m3_tpu_torch/ (cache-key safety, CUDA-graph capture purity, kernel
dispatch seams, lock discipline and races, batch-loop exception safety),
the counterpart of m3_tpu/analysis/, with its own copies of the ledgers.

Run `python -m m3_tpu_torch.analysis m3_tpu_torch/`: the tier-1 gate in
tests/test_torch_static_analysis.py keeps the tree at zero non-suppressed
findings. `python -m m3_tpu_torch.analysis.witness {lockdep,race,numerics}
DIR` holds the runtime witnesses' dumps to the static model. See
m3_tpu_torch/analysis/README.md for the rule catalog and the
`# m3lint: disable=<rule>` suppression syntax.
"""

from .core import (Finding, Module, Rule, all_rules, run_module,  # noqa: F401
                   run_paths)

__all__ = ["Finding", "Module", "Rule", "all_rules", "run_module",
           "run_paths"]
