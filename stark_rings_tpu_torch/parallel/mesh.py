"""A 1-D mesh of shards (counterpart of ``stark_rings_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of devices, and its data
is one global array laid over them.  Here a :class:`Mesh` is a tuple of
P torch devices and an axis name, and sharded data is a list of P shard
tensors, shard p on ``mesh.devices[p]``.  One device repeated P times is
a mesh of P shards on one card: the counterpart of the reference's
virtual CPU mesh, and how one card runs the P-shard dataflow.  A list of
distinct devices gives one shard each.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import get_device

__all__ = ["Mesh", "make_mesh"]


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
        dev = get_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs = (dev,) * n
    return Mesh(devs, axis)
