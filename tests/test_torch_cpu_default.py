"""`cpu_default`: the fixture the ports of the reference's test files use,
so that the port's entry points, written to run on the card when no device
is given, run their plain PyTorch versions on the CPU, as those files ask
of every call (`device="cpu"`).

Every `m3_tpu_torch` module is imported first, then each module's
`resolve` (every module binds `device.resolve` by that name) is replaced
by one that maps None and "cuda" to the CPU, for the importing test
module's whole run (module scope, autouse: module-scoped fixtures such
as a cluster see it too); the originals come back after it."""

import importlib
import pkgutil
import sys

import pytest
import torch

import m3_tpu_torch
from m3_tpu_torch import device as port_device


def _import_every_module():
    for info in pkgutil.walk_packages(m3_tpu_torch.__path__,
                                      "m3_tpu_torch."):
        if not info.name.endswith("__main__"):
            importlib.import_module(info.name)


@pytest.fixture(scope="module", autouse=True)
def cpu_default():
    """device=None (and "cuda") resolve to the CPU in every port module
    for the module's tests."""
    _import_every_module()
    real = port_device.resolve

    def on_the_cpu(device=None):
        dev = torch.device("cuda" if device is None else device)
        return real("cpu" if dev.type == "cuda" else dev)

    with pytest.MonkeyPatch.context() as mp:
        for mod in list(sys.modules.values()):
            name = getattr(mod, "__name__", "") or ""
            if (name == "m3_tpu_torch" or name.startswith("m3_tpu_torch.")) \
                    and getattr(mod, "resolve", None) is real:
                mp.setattr(mod, "resolve", on_the_cpu)
        yield on_the_cpu


def test_entry_points_resolve_to_the_cpu():
    from m3_tpu_torch.query.executor import Engine
    from m3_tpu_torch.storage.database import Database
    from m3_tpu_torch.parallel.sharding import ShardSet
    from m3_tpu_torch.testing import DictStorage

    assert port_device.resolve(None).type == "cpu"
    assert port_device.resolve("cuda").type == "cpu"
    assert Engine(DictStorage({})).device.type == "cpu"
    assert Database(ShardSet(4)).device.type == "cpu"


def test_every_binding_is_patched():
    real_name = "resolve"
    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "") or ""
        if name.startswith("m3_tpu_torch.") and hasattr(mod, real_name):
            assert getattr(mod, real_name)(None).type == "cpu", name
