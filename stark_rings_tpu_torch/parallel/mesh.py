"""A 1-D mesh of shards (counterpart of ``stark_rings_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of devices, and its data
is one global array laid over them.  Here a :class:`Mesh` is a tuple of
P torch devices and an axis name, and sharded data is a list of P shard
tensors, shard p on ``mesh.devices[p]``.  One device repeated P times is
a mesh of P shards on one card: the counterpart of the reference's
virtual CPU mesh, and how one card runs the P-shard dataflow.  A list of
distinct devices gives one shard each.

:func:`shard` and :func:`gather` move whole arrays in and out (the
reference's numpy storage, or storage tensors), as ``jax.device_put``
with a ``NamedSharding`` and ``np.asarray`` do there;
:func:`check_shards` is the check every sharded entry point makes of
its operands; :func:`replicate` puts one replicated operand on every
shard device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import from_jax_storage, get_device, to_numpy_storage

__all__ = ["Mesh", "make_mesh", "shard", "gather", "check_shards",
           "replicate", "with_index", "ring_on"]


@dataclass(frozen=True)
class Mesh:
    """P shard devices along one named axis."""

    devices: tuple[torch.device, ...]
    axis: str = "x"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "x",
              device="cuda") -> Mesh:
    """1-D mesh of ``n_devices`` shards.

    ``device`` is one device, which then holds every shard (``n_devices``
    defaults to 1), or a sequence of devices, one shard each
    (``n_devices`` defaults to all of them).  The default is the card;
    without CUDA it raises, and ``device="cpu"`` gives CPU shards."""
    if isinstance(device, (list, tuple)):
        devs = tuple(get_device(d) for d in device)
        n = len(devs) if n_devices is None else n_devices
        if not 1 <= n <= len(devs):
            raise ValueError(f"need {n} devices, have {len(devs)}")
        devs = devs[:n]
    else:
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        devs = (with_index(get_device(device)),) * n
    return Mesh(devs, axis)


def with_index(dev: torch.device) -> torch.device:
    """``dev`` with its index: "cuda" is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_on(ring, device):
    """``ring``, or the same ring model on ``device`` (its tables there)."""
    if with_index(ring.device) == with_index(torch.device(device)):
        return ring
    from ..rings.ring import get_ring

    return get_ring(ring.name, device)


def shard(x, mesh: Mesh, axis: int = 0, field=None) -> list:
    """Split ``axis`` of ``x`` into ``mesh.size`` equal blocks, block p on
    ``mesh.devices[p]``: shard p holds the p-th contiguous block, as the
    reference's ``PartitionSpec`` puts it on device p.  ``x`` is a
    storage tensor, or the reference's numpy storage of ``field``
    (``field`` is then required)."""
    P = mesh.size
    if x.shape[axis] % P:
        raise ValueError(f"axis {axis} of length {x.shape[axis]} does not "
                         f"split into {P} shards")
    if isinstance(x, np.ndarray):
        if field is None:
            raise TypeError("shard: numpy storage needs its field")
        return [from_jax_storage(field, part, dev)
                for part, dev in zip(np.split(x, P, axis=axis),
                                     mesh.devices)]
    return [part.to(dev).contiguous()
            for part, dev in zip(x.chunk(P, axis), mesh.devices)]


def gather(shards, axis: int = 0, device=None):
    """The shards joined along ``axis``: the reference's numpy storage,
    or with ``device`` a storage tensor there."""
    dev = torch.device("cpu") if device is None else get_device(device)
    whole = torch.cat([s.to(dev) for s in shards], dim=axis)
    return to_numpy_storage(whole) if device is None else whole


def check_shards(mesh: Mesh, shards, dtype, what: str = "operand") -> list:
    """``shards`` as a list, checked against the mesh: one tensor per
    shard, shard p on ``mesh.devices[p]``, of ``dtype``."""
    shards = list(shards) if isinstance(shards, (list, tuple)) else None
    if shards is None or len(shards) != mesh.size or any(
            not isinstance(s, torch.Tensor) or s.device != d
            or s.dtype != dtype for s, d in zip(shards, mesh.devices)):
        raise ValueError(f"{what}: expected {mesh.size} {dtype} shards on "
                         "the mesh's devices")
    return shards


def replicate(x, mesh: Mesh) -> dict:
    """One replicated operand on each distinct shard device: {device:
    tensor}, one copy a device (none where ``x`` already lies there)."""
    out = {}
    for d in mesh.devices:
        if d not in out:
            out[d] = x.to(d)
    return out
