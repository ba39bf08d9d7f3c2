"""Element-ops adapter: one protocol for 'a vector of THINGS' (counterpart
of ``stark_rings_tpu/linalg/elems.py``).

Only :class:`FieldElems`, the base-field adapter that ``DenseMLE`` takes,
is ported so far; the ring-element adapters come with the ring models.
The adapter carries the device on which it creates tensors: the CUDA
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from ..device import get_device

__all__ = ["FieldElems"]


class FieldElems:
    def __init__(self, field, device="cuda"):
        self.f = field
        self.device = get_device(device)
        self.elem_ndim = 1 if field.limbed else 0
        self.elem_shape = field.limb_shape

    def mul(self, a, b):
        return self.f.mul(a, b)

    def add(self, a, b):
        return self.f.add(a, b)

    def sub(self, a, b):
        return self.f.sub(a, b)

    def neg(self, a):
        return self.f.neg(a)

    def sum(self, x, axis):
        return self.f.sum(x, axis)

    def zeros(self, shape):
        return self.f.zeros(shape, self.device)

    def encode(self, ints):
        return self.f.encode(ints, self.device)

    def decode(self, x):
        return self.f.decode(x)

    def one(self):
        return self.f.ones((), self.device)

    def rand(self, shape, rng):
        """Uniform elements drawn from the numpy Generator ``rng``."""
        return self.f.rand(shape, rng, self.device)
