"""Goldilocks prime-field arithmetic on int64 tensors of u64 bit patterns.

Counterpart of ``stark_rings_tpu/fields/field.py`` (``_Goldilocks`` and
``_mul64_128``), for ``q = 2^64 - 2^32 + 1`` in canonical storage, with
the classic 128-bit reduction (2^64 = 2^32 - 1, 2^96 = -1 mod q).

torch has no unsigned 64-bit arithmetic, so values live in ``int64``:
add, sub and mul wrap mod 2^64 as u64 does, a logical right shift is
an arithmetic shift followed by a mask, and an unsigned compare flips
the sign bit of both sides first.  Constants above 2^63 are written as
their int64 bit patterns (:func:`i64`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, to_numpy_u64, to_torch

__all__ = ["Goldilocks", "GOLDILOCKS", "i64", "shr", "u64_lt"]

MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def i64(v: int) -> int:
    """u64 python int -> the python int with the same int64 bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def u64_lt(a, b) -> torch.Tensor:
    """Unsigned ``a < b`` on int64 bit patterns (tensors or int64 ints)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _mul64_128(a: torch.Tensor, b: torch.Tensor):
    """Full 64x64 -> 128-bit product as a ``(hi, lo)`` pair of u64 words."""
    a0 = a & MASK32
    a1 = shr(a, 32)
    b0 = b & MASK32
    b1 = shr(b, 32)
    ll = a0 * b0
    a1b0 = a1 * b0
    mid = a0 * b1 + shr(ll, 32) + (a1b0 & MASK32)
    hi = a1 * b1 + shr(a1b0, 32) + shr(mid, 32)
    lo = (mid << 32) | (ll & MASK32)
    return hi, lo


class Goldilocks:
    """q = 2^64 - 2^32 + 1, canonical values in [0, q) as int64 bits."""

    name = "goldilocks"
    q = 2**64 - 2**32 + 1
    bits = 64
    dtype = torch.int64
    limb_shape: tuple = ()
    limbed = False

    _Q = i64(q)          # q's int64 bit pattern (= -(2^32 - 1))
    _EPS = MASK32        # 2^64 mod q

    # -- host conversions ---------------------------------------------------
    def encode(self, ints, device="cpu") -> torch.Tensor:
        """python ints / object array -> canonical int64 storage tensor."""
        arr = np.asarray(ints, dtype=object)
        flat = np.array([int(v) % self.q for v in arr.reshape(-1)],
                        dtype=np.uint64)
        return to_torch(flat.reshape(arr.shape), device)

    def decode(self, x: torch.Tensor) -> np.ndarray:
        """storage -> numpy object array of canonical python ints."""
        host = to_numpy_u64(x)
        out = np.empty(host.size, dtype=object)
        out[:] = [int(v) for v in host.reshape(-1)]
        return out.reshape(host.shape)

    def rand(self, shape, rng: np.random.Generator,
             device="cpu") -> torch.Tensor:
        """Uniform canonical elements drawn from ``rng``."""
        return to_torch(rng.integers(0, self.q, size=shape, dtype=np.uint64),
                        get_device(device))

    def const(self, v: int, device="cpu") -> torch.Tensor:
        """One canonical scalar, as a 0-d tensor."""
        return torch.tensor(i64(int(v) % self.q), dtype=torch.int64,
                            device=get_device(device))

    def zeros(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.int64,
                           device=get_device(device))

    def ones(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=torch.int64,
                          device=get_device(device))

    def from_uint(self, x, device="cpu") -> torch.Tensor:
        """numpy unsigned ints below q -> storage on ``device``."""
        return to_torch(np.asarray(x, dtype=np.uint64), device)

    # -- elementwise ops -----------------------------------------------------
    def add(self, a, b):
        s = a + b
        red = u64_lt(s, a) | ~u64_lt(s, self._Q)
        return torch.where(red, s - self._Q, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(u64_lt(a, b), d + self._Q, d)

    def neg(self, a):
        return torch.where(a == 0, a, self._Q - a)

    def _reduce128(self, hi, lo):
        """(hi*2^64 + lo) mod q via 2^64 = 2^32 - 1, 2^96 = -1."""
        hi_hi = shr(hi, 32)
        hi_lo = hi & MASK32
        t0 = lo - hi_hi
        t0 = torch.where(u64_lt(lo, hi_hi), t0 - self._EPS, t0)
        t1 = hi_lo * self._EPS
        t2 = t0 + t1
        t2 = torch.where(u64_lt(t2, t1), t2 + self._EPS, t2)
        return torch.where(u64_lt(t2, self._Q), t2, t2 - self._Q)

    def mul(self, a, b):
        hi, lo = _mul64_128(a, b)
        return self._reduce128(hi, lo)

    # -- reductions and powers -----------------------------------------------
    def sum(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Modular sum over ``axis`` via a halving tree of ``add``s (an odd
        length parks its last entry and adds it at the end).  ``torch.sum``
        wraps mod 2^64 and is not a field sum."""
        axis = axis % x.dim()
        if x.shape[axis] == 0:
            shape = x.shape[:axis] + x.shape[axis + 1:]
            return self.zeros(shape, x.device)
        rem = None
        while x.shape[axis] > 1:
            n = x.shape[axis]
            if n % 2:
                tail = x.narrow(axis, n - 1, 1)
                rem = tail if rem is None else self.add(rem, tail)
                x = x.narrow(axis, 0, n - 1)
                n -= 1
            x = self.add(x.narrow(axis, 0, n // 2),
                         x.narrow(axis, n // 2, n // 2))
        if rem is not None:
            x = self.add(x, rem)
        return x.squeeze(axis)

    def dot(self, a, b, axis: int) -> torch.Tensor:
        """Modular inner product over ``axis``: sum(mul(a, b))."""
        return self.sum(self.mul(a, b), axis)

    def pow_const(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x**e for a static exponent (square and multiply)."""
        if e == 0:
            return torch.ones_like(x)
        acc = None
        base = x
        while e:
            if e & 1:
                acc = base if acc is None else self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse via Fermat (x != 0)."""
        return self.pow_const(x, self.q - 2)


GOLDILOCKS = Goldilocks()
