"""Device-memory budget discipline: block-sized device uploads on the
storage/query serving path must go through the shared HBM budget
(utils/hbm.py), because a raw host-to-device put pins device memory no
budget sees — enough of them and the resident caches' ceilings are
meaningless (the budget reclaims what it knows about while untracked
tensors OOM the card anyway). The torch counterpart of the reference's
`jax.device_put` rule (m3_tpu/analysis/hbm_rules.py).

Rules:
  unbudgeted-device-put   a raw put inside the storage / query / ops /
                          parallel modules — the layers that move
                          block-sized arrays (sealed blocks, consolidated
                          grids, flush tiles) onto devices: `.cuda()`,
                          `.to(<device>)` (a device-named value,
                          torch.device(...), a "cuda" string or device=),
                          and torch.tensor/as_tensor(..., device=). Route
                          one-shot uploads through `utils.hbm.budgeted_put`
                          (charged for the tensor's lifetime) or a
                          budget-registered cache (ops/temporal.py's
                          upload cache, `_cached_put`), or carry a
                          justified suppression (transient staging a
                          program consumes and frees before it returns,
                          a put whose tensor a charged tenant holds).
"""

from __future__ import annotations

import ast
from typing import Iterator, List

from .core import Finding, Module, Rule
from .device_rules import _is_device_put


class UnbudgetedDevicePutRule(Rule):
    """unbudgeted-device-put: raw host-to-device put on the serving
    path."""

    id = "unbudgeted-device-put"
    severity = "error"
    dirs = ("storage", "query", "ops", "parallel")
    requires_import = "torch"

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and _is_device_put(node):
                yield self.finding(
                    mod, node,
                    "raw host-to-device put pins device memory no budget "
                    "sees; route through utils.hbm.budgeted_put (or a "
                    "budget-registered cache), or suppress with a "
                    "justification for transient staging the program "
                    "frees itself")


RULES: List[Rule] = [UnbudgetedDevicePutRule()]
