"""A device mesh for the fan-out: a grid of devices in one process.

Counterpart of what the JAX package takes from `jax.sharding.Mesh` and
the `lax` collectives for its on-mesh root merge (parallel/fanout.py).
The JAX mesh is single-controller: one process owns every chip and
`shard_map` runs one body per device. The port keeps that shape:

- a `Mesh` is a one-axis ("splits") grid of `torch.device`s; each device
  is a row, one shard of the batch's splits, and its programs run there;
- a collective takes one tensor per shard, in row order, and returns one
  tensor on the mesh's lead device (`devices[0]`): each
  operand is copied there (`Tensor.to(lead, non_blocking=True)`, a
  peer-to-peer copy over NVLink between two cards, which PyTorch orders
  against both devices' current streams) and reduced there in shard
  order, so the result does not depend on timing.

The JAX mesh also has a "docs" axis, which shards dense columns at rest
and computes replicated. The port lays no data out that way (a row keeps
its splits' whole arrays on its device), so its mesh has no docs axis:
devices past the split axis are neither used nor counted.

A device may repeat in the grid. A grid of one card repeated runs the
same code as a grid of distinct cards (the copies become no-ops), which
is how one card checks every mesh shape, as the JAX tests fill their
mesh with forced host devices. No side stream is used.

`pmax`/`pmin` treat NaN as `lax.pmax`/`lax.pmin` do on the JAX CPU
backend: a fold from -inf (+inf) in shard order that takes an operand
only when it compares strictly greater (less), so a NaN operand is
never taken, an all-NaN position gives -inf (+inf), and of two equal
values (-0.0 and +0.0) the earlier shard's stays. `psum` adds onto 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("splits",)


def _canonical(device) -> torch.device:
    """`device` with a card's index filled in (`cuda` names the current
    card), so a grid compares equal to the devices a context resolves."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A one-axis grid of devices, one per row, hashable by its devices in
    row order (a repeated device is part of the identity). `devices` is a
    [rows] object array, as the JAX mesh's is."""

    axis_names = AXIS_NAMES

    def __init__(self, devices: Sequence):
        self.devices = np.empty(len(devices), dtype=object)
        for i, device in enumerate(devices):
            self.devices[i] = _canonical(device)
        self._key = tuple(str(d) for d in self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The device the collectives reduce on: `devices[0]`."""
        return self.devices[0]

    def row_devices(self) -> list:
        """Each row's device, in row order."""
        return list(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}, devices={list(self._key)})"


def visible_devices(device_type: str = "cuda") -> list:
    """Every device of one type this process sees: the cards for `cuda`
    (the counterpart of `jax.devices()`), one device otherwise."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(axis_splits: int, devices: Optional[Sequence] = None) -> Mesh:
    """A ("splits",) mesh of the first `axis_splits` of `devices` (default:
    every visible card). Raises when there are too few; a device may
    repeat."""
    devs = list(devices) if devices is not None else visible_devices()
    if len(devs) < axis_splits:
        raise ValueError(f"need {axis_splits} devices, have {len(devs)}")
    return Mesh(devs[:axis_splits])


# --------------------------------------------------------------------------
# collectives: per-shard operands (row order) -> one tensor on lead

def _gather(parts: Sequence[torch.Tensor], lead) -> list:
    return [t.to(lead, non_blocking=True) for t in parts]


def psum(parts: Sequence[torch.Tensor], lead) -> torch.Tensor:
    """Elementwise sum, added in shard order onto 0, as `lax.psum` does on
    the JAX CPU backend (so -0.0 + -0.0 sums to +0.0)."""
    moved = _gather(parts, lead)
    acc = torch.zeros_like(moved[0])
    for t in moved:
        acc = acc + t
    return acc


def _fold(parts, lead, pick) -> torch.Tensor:
    moved = _gather(parts, lead)
    first = moved[0]
    if first.dtype.is_floating_point:
        init = float("-inf") if pick is torch.gt else float("inf")
    else:
        info = torch.iinfo(first.dtype)
        init = info.min if pick is torch.gt else info.max
    acc = torch.full_like(first, init)
    for t in moved:
        acc = torch.where(pick(t, acc), t, acc)
    return acc


def pmax(parts: Sequence[torch.Tensor], lead) -> torch.Tensor:
    """Elementwise max in `lax.pmax`'s CPU semantics (module docstring)."""
    return _fold(parts, lead, torch.gt)


def pmin(parts: Sequence[torch.Tensor], lead) -> torch.Tensor:
    """Elementwise min in `lax.pmin`'s CPU semantics (module docstring)."""
    return _fold(parts, lead, torch.lt)


def all_gather(parts: Sequence[torch.Tensor], lead,
               axis: int = 0) -> torch.Tensor:
    """`lax.all_gather(..., tiled=True)`: the shards' operands
    concatenated along `axis` in shard order, on the lead device."""
    return torch.cat(_gather(parts, lead), dim=axis)
