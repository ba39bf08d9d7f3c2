"""Element-ops adapter: one protocol for 'a vector of THINGS' (counterpart
of ``stark_rings_tpu/linalg/elems.py``).

The same code runs over

* base-field scalars            (``FieldElems(field)``, what ``DenseMLE``
  takes),
* NTT-form ring elements        (``RingElems(ring)``: slot-wise product),
* coeff-form ring elements      (``RingCoeffElems(ring)``: schoolbook).

An adapter carries the device on which it creates tensors: the CUDA card
unless the caller passes ``device="cpu"``; the ring adapters take the
ring's device.
"""

from __future__ import annotations

from ..device import get_device

__all__ = ["FieldElems", "RingElems", "RingCoeffElems"]


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


class RingElems(FieldElems):
    """NTT-form ring elements: shape [..., D(, L)], slot-wise product."""

    def __init__(self, ring):
        super().__init__(ring.field, ring.device)
        self.ring = ring
        self.elem_ndim = 1 + len(ring.field.limb_shape)
        self.elem_shape = (ring.D,) + ring.field.limb_shape

    def mul(self, a, b):
        return self.ring.ntt_mul(a, b)

    def zeros(self, shape):
        return self.ring.zeros(shape)

    def one(self):
        return self.ring.from_scalar_ntt(1)

    def rand(self, shape, rng):
        return self.ring.rand_ntt(shape, rng)


class RingCoeffElems(RingElems):
    """Coefficient-form ring elements: schoolbook product."""

    def mul(self, a, b):
        return self.ring.coeff_mul(a, b)

    def one(self):
        return self.ring.from_scalar_coeff(1)

    def rand(self, shape, rng):
        return self.ring.rand_coeff(shape, rng)
