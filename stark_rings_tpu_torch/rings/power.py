"""Power-of-two negacyclic rings F_q[X]/(X^N + 1) over Goldilocks,
BabyBear and stark_prime (deg 2^1 .. 2^20 and beyond, to the fields'
2-adicity) and frog (deg 2 and 4: its q - 1 has 2-adicity 3)
(counterpart of ``stark_rings_tpu/rings/power.py``).

A :class:`PowerRing` is fully splitting: its NTT form is the N
leaf-order evaluations of ``ops/ntt.py`` (slot field F_q, E = 1).
Elements are storage tensors [..., N] (int64 Goldilocks, int32 BabyBear
Montgomery; stark_prime's [..., N, 8] limbs) on the ring's device, which
is the CUDA card unless the caller passes ``device="cpu"``.
``mxu_ctx()`` is the production-rate multiplier: the digit-GEMM engines
with their hand-written kernels.

``fourstep_ctx()`` is the single-device four-step of
``parallel/ntt.py`` on flat [..., N] tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import get_device
from ..fields import get_field
from ..ops.ntt import NTTContext
from .ring import RingModel

__all__ = ["PowerRing", "get_power_ring", "FourStep"]


class FourStep(NamedTuple):
    """``PowerRing.fourstep_ctx()``: three functions on flat [..., N]
    storage tensors."""

    forward: Callable
    inverse: Callable
    mul: Callable


class PowerRing:
    """Fully-splitting negacyclic ring: NTT form = leaf-order evaluations,
    slot field = F_q (E = 1, N slots = D)."""

    def __init__(self, field_name: str, logN: int, device="cuda"):
        self.field = get_field(field_name)
        two_adicity = ((self.field.q - 1)
                       & -(self.field.q - 1)).bit_length() - 1
        if not 1 <= logN < two_adicity:
            raise ValueError(
                f"{field_name}: logN={logN} is out of range: q - 1 has "
                f"2-adicity {two_adicity} and 2N must divide it, so logN is "
                f"in [1, {two_adicity - 1}]")
        self.device = get_device(device)
        self.name = f"{field_name}_pow2_{logN}"
        self.q = self.field.q
        self.D = 1 << logN
        self.N = self.D
        self.E = 1
        self.ctx = NTTContext(self.field, self.D, negacyclic=True,
                              device=self.device)
        self._mxu = {}
        self._fourstep = None

    # -- conversions ------------------------------------------------------
    def encode_coeffs(self, ints):
        arr = np.asarray(ints, dtype=object)
        if arr.shape[-1] != self.D:
            raise ValueError(f"last axis {arr.shape[-1]} != D = {self.D}")
        return self.field.encode(arr, self.device)

    def decode(self, x):
        return self.field.decode(x)

    def rand_coeff(self, shape, rng: np.random.Generator):
        """Uniform elements [*shape, D] drawn from the numpy Generator."""
        return self.field.rand(tuple(shape) + (self.D,), rng, self.device)

    rand_ntt = rand_coeff

    def zeros(self, shape=()):
        return self.field.zeros(tuple(shape) + (self.D,), self.device)

    def from_scalar_coeff(self, v, shape=()):
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0] = v % self.q
        return self.encode_coeffs(out)

    def from_scalar_ntt(self, v, shape=()):
        return self.field.const(v, self.device).expand(
            tuple(shape) + (self.D,) + self.field.limb_shape).contiguous()

    # -- ring ops ---------------------------------------------------------
    def add(self, a, b):
        return self.field.add(a, b)

    def sub(self, a, b):
        return self.field.sub(a, b)

    def neg(self, a):
        return self.field.neg(a)

    def crt(self, x):
        return self.ctx.forward(x)

    def icrt(self, x):
        return self.ctx.inverse(x)

    def ntt_mul(self, a, b):
        return self.field.mul(a, b)

    mul_unchecked = ntt_mul

    def coeff_mul(self, a, b):
        return self.ctx.mul(a, b)

    def coeff_square(self, a):
        """a*a with one forward transform (``mxu_ctx().square`` is the
        production-rate variant)."""
        return self.ctx.square(a)

    def precompute(self, b):
        """Cached-operand state (leaf-order evaluations) for
        :meth:`coeff_mul_cached` only; the production-rate pair is
        ``mxu_ctx().precompute`` / ``mul_cached``."""
        return self.ctx.forward(b)

    def coeff_mul_cached(self, a, fb):
        """Multiply by a precomputed operand (one forward saved); fb from
        a batch-1 b broadcasts over a's batch."""
        return self.ctx.inverse(self.field.mul(self.ctx.forward(a), fb))

    def mxu_ctx(self, pallas: bool = True):
        """The digit-GEMM multiplier for this degree, built on first use
        (the weight digitization is a one-time host cost).  Coefficients
        in storage form in, coefficients out, bit-equal to
        :meth:`coeff_mul`; operands are [B, D].

        ``pallas=True`` (the reference's name for its kernel path):
        BabyBear gets :class:`~..ops.fold_bb.MxuBBFusedNTT` (K4),
        Goldilocks :class:`~..ops.fold.Mxu2KernelNTT` (K1 untransposed,
        K3 and the pointwise kernel).  ``pallas=False``: the plain
        :class:`~..ops.mxu_bb.MxuBBNTT` / :class:`~..ops.mxu2.Mxu2NTT`.
        stark_prime gets :class:`~..ops.mxu_limb.MxuLimbNTT` either way
        (its folds S3 and products S1 are its only kernels; operands
        [B, D, 8]).  On CPU tensors the kernel wrappers run their plain
        twins.  frog has no digit-GEMM engine (as in the reference): it
        raises."""
        if self.field.name not in ("goldilocks", "babybear", "stark_prime"):
            raise ValueError(f"no digit-GEMM engine over {self.field.name}: "
                             "MXU weights exist for goldilocks, babybear "
                             "and stark_prime")
        if self.field.limbed:
            pallas = True           # one engine: the reference's cache key
        if pallas not in self._mxu:
            if self.field.limbed:
                from ..ops.mxu_limb import MxuLimbNTT as engine
            elif self.field.name == "babybear":
                if pallas:
                    from ..ops.fold_bb import MxuBBFusedNTT as engine
                else:
                    from ..ops.mxu_bb import MxuBBNTT as engine
            elif pallas:
                from ..ops.fold import Mxu2KernelNTT as engine
            else:
                from ..ops.mxu2 import Mxu2NTT as engine
            self._mxu[pallas] = engine(self.D, device=self.device)
        return self._mxu[pallas]

    def fourstep_ctx(self) -> FourStep:
        """The single-device four-step multiplier
        (``ShardedNTT(single_chip=True)``), built on first use:
        (forward, inverse, mul) on flat [..., N] storage tensors.  ``mul``
        is bit-equal to :meth:`coeff_mul`.  forward / inverse are a
        self-consistent evaluation pair whose slot order differs from
        :meth:`crt`'s leaf order: combine slots only from one engine,
        compare coefficients across engines."""
        if self._fourstep is None:
            from ..parallel.ntt import ShardedNTT

            sn = ShardedNTT(self.field.name, self.D, 1, single_chip=True,
                            device=self.device)
            fwd_m, inv_m, mul_m = sn.make_single_chip_fns()
            self._fourstep = FourStep(
                lambda x: sn.from_matrix(fwd_m(sn.to_matrix(x))),
                lambda x: sn.from_matrix(inv_m(sn.to_matrix(x))),
                lambda a, b: sn.from_matrix(mul_m(sn.to_matrix(a),
                                                  sn.to_matrix(b))))
        return self._fourstep

    def ntt_pow(self, a, e: int):
        """Slotwise pow on the NTT form (square and multiply)."""
        if e < 0:
            raise ValueError("negative exponents: invert first")
        if e == 0:
            return self.from_scalar_ntt(1, self.batch_shape(a))
        return self.field.pow_const(a, e)

    def ntt_inv(self, a):
        return self.field.inv(a)

    def rot(self, a):
        """Multiply by X: negacyclic shift."""
        ax, D = self.field.coeff_axis, self.D
        return torch.cat([self.field.neg(a.narrow(ax, D - 1, 1)),
                          a.narrow(ax, 0, D - 1)], dim=ax)

    batch_shape = RingModel.batch_shape
    flatten = RingModel.flatten
    promote = RingModel.promote


_POWER = {}


def get_power_ring(field_name: str, logN: int, device="cuda") -> PowerRing:
    key = (field_name, logN, str(get_device(device)))
    if key not in _POWER:
        _POWER[key] = PowerRing(field_name, logN, device)
    return _POWER[key]
