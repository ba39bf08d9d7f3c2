"""BabyBear arithmetic (q = 15 * 2^27 + 1 = 2013265921) in plain PyTorch
ops, on the program's storage words.

The encoding.  q is the modulus of the upstream stark-rings BabyBear
model (crates/ring/src/cyclotomic_ring/models/babybear/mod.rs, the
31-bit STARK field).  A value v in [0, q) is stored as its Montgomery
residue v * 2^32 mod q (R = 2^32), one word an element: the word is
below q < 2^31, so it is also a non-negative int32.  This is the 32-bit
Montgomery form in which STARK provers keep BabyBear; it is where this
file departs from upstream, whose arkworks field keeps its Montgomery
residue in a 64-bit limb.  The values are the same either way: storage
is a bijection of [0, q), and a sum of residues is the residue of the
sum, so every linear map acts on the words as on the values.

The arithmetic is plain integer arithmetic on int64 tensors: a product
of two words is below 2^62, reduced with ``%``, and the factor 2^-32
that keeps a product in storage form is one more product and ``%``
(no REDC).  ``truncated=True`` drops the high 32 bits of each 62-bit
product before the reduction: the product at half its width, the
control that the benchmark's comparison has to reject.

This file is the benchmark's yardstick: it imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

Q = 15 * (1 << 27) + 1
R = (1 << 32) % Q                 # the storage word of 1
R_INV = pow(1 << 32, -1, Q)       # 2^-32 mod q
M32 = 0xFFFFFFFF


def from_signed(x: torch.Tensor) -> torch.Tensor:
    """Integers of any sign (int64) -> int64 storage words."""
    return torch.remainder(x, Q) * R % Q


def to_values(x: torch.Tensor) -> torch.Tensor:
    """Storage words -> their values in [0, q), int64."""
    return x.to(torch.int64) * R_INV % Q


def _wide(x):
    return x.to(torch.int64)


def add(a, b):
    return (_wide(a) + _wide(b)) % Q


def sub(a, b):
    return (_wide(a) - _wide(b)) % Q


def mul(a, b, truncated: bool = False):
    """The storage word of the product of two stored values."""
    u = _wide(a) * _wide(b)                     # < 2^62
    if truncated:
        u = u & M32
    return u % Q * R_INV % Q


def scale(x, c, truncated: bool = False):
    """The storage word of c times the stored value, for a constant c
    given as a value in [0, q) (a tensor or an int), not a word."""
    u = _wide(x) * c                            # c < q: < 2^62
    if truncated:
        u = u & M32
    return u % Q
