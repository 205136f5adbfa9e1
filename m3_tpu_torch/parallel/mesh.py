"""A grid of torch devices with named axes, per-slice programs and explicit
collectives: the port's stand-in for jax.sharding's Mesh, shard_map and
psum/pmin/pmax/all_gather.

A `Mesh` is a numpy object array of `torch.device`s (repeats allowed: a
four-way split of one card is `[cuda:0] * 4`) with one name per axis.
A spec names, per tensor dimension, the mesh axes that dimension is split
over: None (whole), an axis name, or a tuple of names (split over their
product, row-major in the order given), as a PartitionSpec does; mesh
axes a spec leaves out replicate.

`shard_map(fn, mesh, in_specs, out_specs)` runs `fn` once per mesh entry,
in the entries' row-major order, on that entry's slices, each placed on
the entry's device as a tensor of its own (never a view a later slice
could overwrite; on a card charged to the shared utils/hbm budget for its
lifetime), and reassembles the outputs by the out specs on the first
entry's device. There is no in-body collective: a program that reduces
across slices runs its per-slice stage with `map_slices`, combines the
per-entry values with `psum`/`pmin`/`pmax`/`all_gather` (each group moved
to its first entry's device and reduced in slice order, so a result never
depends on timing) and runs its next stage on the replicated result.

On one device, a program over the mesh computes what the single-device
program computes; the slices run one after another on the same stream."""

from __future__ import annotations

import itertools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.aggregation import _maximum, _minimum
from ..utils import hbm

Spec = Tuple  # per dimension: None | axis name | tuple of axis names


class Mesh:
    """Devices [axis sizes...] with axis names. Hashable by its layout,
    so lru_cache keys on a mesh work as the reference's do."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self._key = (self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def entries(self) -> List[Tuple[int, ...]]:
        """Every entry's coordinates, row-major."""
        return list(itertools.product(*(range(n) for n in self.devices.shape)))

    def device_at(self, coords) -> torch.device:
        return self.devices[tuple(coords)]

    @property
    def first(self) -> torch.device:
        return self.devices.flat[0]

    def one_device(self) -> bool:
        """Every entry is the same device (a k-way split of one card)."""
        return len(set(self._key[2])) == 1

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self._key[2])})"


def make(devices: Sequence, shape: Sequence[int],
         axis_names: Sequence[str]) -> Mesh:
    """A mesh of `devices` (row-major) reshaped to `shape`."""
    flat = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        flat[i] = torch.device(d)
    return Mesh(flat.reshape(tuple(shape)), axis_names)


def for_device(mesh: Mesh | None, device) -> Mesh | None:
    """`mesh` for a call on `device`, or None when the caller asked for
    a device of another type than the mesh's: a call for the CPU stays
    off a mesh of cards, and one for a card off a mesh of CPUs. With
    `device` None the caller asked for nothing, and the mesh holds."""
    if mesh is None or device is None:
        return mesh
    return mesh if torch.device(device).type == mesh.first.type else None


def place(t: torch.Tensor, dev: torch.device,
          charge: bool = True) -> torch.Tensor:
    """`t` on `dev` as a tensor of its own. A card's copy is charged to
    the shared HBM budget until it is collected, unless the caller's
    cache charges it (`charge=False`)."""
    if t.device == dev:
        t = t.clone()
    if charge and dev.type == "cuda":
        return hbm.budgeted_put(t, dev)
    # the uncharged branch: a CPU slice, or a transient slice the caller frees
    # before returning
    return t.to(dev)  # m3lint: disable=unbudgeted-device-put


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh: Mesh, coords, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(this entry's index, the count) along the product of `axes`."""
    idx, count = 0, 1
    for a in axes:
        i = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[i] + coords[i]
        count *= mesh.devices.shape[i]
    return idx, count


def local(t: torch.Tensor, mesh: Mesh, coords, spec: Spec) -> torch.Tensor:
    """The block of `t` that the entry at `coords` holds under `spec`
    (same rank as `t`; a view, not yet placed)."""
    for d, entry in enumerate(spec):
        idx, count = _index(mesh, coords, _axes(entry))
        if count == 1:
            continue
        n = t.shape[d]
        if n % count:
            raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                             f"divide over {count} slices")
        size = n // count
        t = t.narrow(d, idx * size, size)
    return t


def split_rows(t: torch.Tensor, mesh: Mesh, axes,
               charge: bool = True) -> List[torch.Tensor]:
    """`t`'s rows split evenly over the product of `axes`, part j placed
    (`place`) on the entry with index j along those axes (0 along the
    others)."""
    axes = _axes(axes)
    _, count = _index(mesh, [0] * mesh.devices.ndim, axes)
    if t.shape[0] % count:
        raise ValueError(f"{t.shape[0]} rows do not divide over {count} "
                         f"slices")
    size = t.shape[0] // count
    out = []
    for j in range(count):
        coords = [0] * mesh.devices.ndim
        rem = j
        for a in reversed(axes):
            i = mesh.axis_names.index(a)
            coords[i] = rem % mesh.devices.shape[i]
            rem //= mesh.devices.shape[i]
        out.append(place(t[j * size:(j + 1) * size], mesh.device_at(coords),
                         charge))
    return out


def concat_rows(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The parts' rows in order, on the first part's device."""
    dev = parts[0].device
    # a sharded root's rows gathered onto the first slice's device, the
    # query's transient result
    return torch.cat([p.to(dev) for p in parts])  # m3lint: disable=unbudgeted-device-put


def map_slices(fn: Callable, mesh: Mesh, args: Sequence,
               in_specs: Sequence[Spec]) -> np.ndarray:
    """fn(*local args) at every mesh entry (row-major); returns the
    outputs as an object array of the mesh's shape."""
    if len(args) != len(in_specs):
        raise ValueError(f"{len(args)} arguments for {len(in_specs)} specs")
    outs = np.empty(mesh.devices.shape, dtype=object)
    for coords in mesh.entries():
        dev = mesh.device_at(coords)
        locs = [place(local(a, mesh, coords, s), dev)
                for a, s in zip(args, in_specs)]
        outs[coords] = fn(*locs)
    return outs


def gather(vals: np.ndarray, mesh: Mesh, spec: Spec) -> torch.Tensor:
    """Reassemble per-entry tensors into one by `spec` on the first
    entry's device: split dimensions concatenate in index order, and the
    entry at 0 along every axis the spec leaves out stands for its
    replicas."""
    def at(assign: dict):
        return vals[tuple(assign.get(a, 0) for a in mesh.axis_names)]

    def build(d: int, assign: dict):
        if d == len(spec):
            return at(assign).to(mesh.first)
        axes = _axes(spec[d])
        if not axes:
            return build(d + 1, assign)
        sizes = [mesh.shape[a] for a in axes]
        parts = []
        for idx in itertools.product(*(range(n) for n in sizes)):
            parts.append(build(d + 1, dict(assign, **dict(zip(axes, idx)))))
        return torch.cat(parts, dim=d)

    return build(0, {})


def shard_map(fn: Callable, mesh: Mesh, in_specs: Sequence[Spec], out_specs):
    """The reference's shard_map for programs without collectives: run
    `fn` per entry on its slices and reassemble the output by its spec,
    or each output of a tuple by its own (`out_specs` a list of specs)."""

    def run(*args):
        outs = map_slices(fn, mesh, args, in_specs)
        if isinstance(out_specs, list):
            return tuple(gather(pick(outs, i), mesh, s)
                         for i, s in enumerate(out_specs))
        return gather(outs, mesh, out_specs)

    return run


def pick(outs: np.ndarray, i) -> np.ndarray:
    """Per-entry element `i` (an index or a dict key) of `map_slices`'
    outputs, as an object array."""
    return entry_map(lambda o: o[i], outs)


# ------------------------------------------------------------ collectives


def _groups(mesh: Mesh, axes: Tuple[str, ...]):
    """Coordinate lists of each group of entries that differ only along
    `axes`, each in index order along them."""
    ax = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in ax]
    shape = mesh.devices.shape
    for fixed in itertools.product(*(range(shape[i]) for i in rest)):
        group = []
        for idx in itertools.product(*(range(shape[i]) for i in ax)):
            coords = [0] * len(shape)
            for i, v in zip(rest, fixed):
                coords[i] = v
            for i, v in zip(ax, idx):
                coords[i] = v
            group.append(tuple(coords))
        yield group


def _collective(vals: np.ndarray, mesh: Mesh, axes, combine) -> np.ndarray:
    out = np.empty(vals.shape, dtype=object)
    for group in _groups(mesh, _axes(axes)):
        head = mesh.device_at(group[0])
        # a collective's group on its head device, transient until the combine
        # returns
        parts = [vals[c].to(head) for c in group]  # m3lint: disable=unbudgeted-device-put
        total = combine(parts)
        for c in group:
            out[c] = total.to(mesh.device_at(c))
    return out


def psum(vals: np.ndarray, mesh: Mesh, axes) -> np.ndarray:
    """Sum over `axes` (a name or a tuple), in slice order on each group's
    first device; the total replicated to every entry of the group."""
    return _collective(vals, mesh, axes,
                       lambda ps: _fold(ps, torch.add))


def pmin(vals: np.ndarray, mesh: Mesh, axes) -> np.ndarray:
    """f32 minimum over `axes`, with NaN propagation and XLA's
    signed-zero order (-0.0 below +0.0)."""
    return _collective(vals, mesh, axes, lambda ps: _fold(ps, _minimum))


def pmax(vals: np.ndarray, mesh: Mesh, axes) -> np.ndarray:
    return _collective(vals, mesh, axes, lambda ps: _fold(ps, _maximum))


def all_gather(vals: np.ndarray, mesh: Mesh, axes) -> np.ndarray:
    """The group's values stacked on a new leading axis, in slice order."""
    return _collective(vals, mesh, axes, torch.stack)


def _fold(parts, op):
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def reduce_list(parts: Sequence[torch.Tensor], how: str) -> torch.Tensor:
    """One group's collective over a plain list of per-slice tensors, on
    the first part's device: "sum", "min" or "max", in list order."""
    dev = parts[0].device
    # a collective's parts on the first part's device, transient until the
    # combine returns
    ps = [p.to(dev) for p in parts]  # m3lint: disable=unbudgeted-device-put
    return _fold(ps, {"sum": torch.add, "min": _minimum, "max": _maximum}[how])


def entry_map(fn, *vals: np.ndarray) -> np.ndarray:
    """fn over the per-entry values of one or more object arrays."""
    out = np.empty(vals[0].shape, dtype=object)
    for coords in itertools.product(*(range(n) for n in vals[0].shape)):
        out[coords] = fn(*(v[coords] for v in vals))
    return out
