"""Balanced decomposition as fixed-iteration tensor ops (counterpart of
``stark_rings_tpu/decomp/balanced.py``).

The reference's digit loop (balanced_decomposition/mod.rs:62-103) is
data-dependent; here it is the **fixed-k** digit extraction that
:mod:`..spec.decomp` proves equal to it:

    sign = sgn(signed(v));  curr = |signed(v)|
    repeat k times:  m = curr mod b
                     d = m if 2m <= b else m - b
                     curr = (curr - d) / b
    digit_j = sign * d_j

Every branch is a ``torch.where``; the loop is a static Python loop over
``k``.  Magnitudes are below 2^63 (|signed(v)| <= (q - 1) / 2), so the
floor division and remainder by b run on non-negative ``int64`` (int32
for BabyBear) storage words; only the ``u > (q - 1) / 2`` test reads the
u64 bits unsigned.

The limbed stark_prime branches (multi-limb divmod, the compare tree in
``linf_norm``) come with that field, ROADMAP queue 1 step 3.
"""

from __future__ import annotations

import torch

from ..fields.field import u64_lt
from ..spec.decomp import decomposition_max_length

__all__ = [
    "signed_magnitude", "center", "sign", "linf_norm",
    "decompose", "recompose", "decompose_ring", "recompose_ring",
    "gadget_decompose", "gadget_recompose", "decomposition_max_length",
]


def _unlimbed(f):
    assert not f.limbed, (f"{f.name}: limbed fields decompose with the "
                          "stark_prime field, ROADMAP queue 1 step 3")


def signed_magnitude(f, x):
    """(neg_mask, magnitude) of the balanced signed representative.

    Mirrors SignedRepresentative::from (fq_convertible.rs:8-62): values
    above (q-1)/2 are negative.  The magnitude is canonical storage
    (< q, not in Montgomery form), in the field's storage dtype."""
    _unlimbed(f)
    u = f.canon(x)
    half = f.canon_const((f.q - 1) // 2)
    if f.dtype == torch.int64:          # u64 bits: unsigned compare
        neg = u64_lt(half, u)
        mag = torch.where(neg, f._Q - u, u)
    else:
        neg = u > half
        mag = torch.where(neg, f.q - u, u)
    return neg, mag


def center(f, x):
    """Zq::center (ring.rs:159-168): |signed(x)| as a field element."""
    _, mag = signed_magnitude(f, x)
    return f.from_canon(mag)


def sign(f, x):
    """Zq::sign (ring.rs:170-179): 1 if x <= (q-1)/2 else -1 (as field)."""
    neg, _ = signed_magnitude(f, x)
    one = f.ones(neg.shape, neg.device)
    return torch.where(neg, f.neg(one), one)


def linf_norm(f, x, axis=None):
    """max |signed| over ``axis`` (all axes when None), as canonical
    magnitude storage."""
    _, mag = signed_magnitude(f, x)
    return mag.max() if axis is None else torch.amax(mag, dim=axis)


def decompose(f, x, b: int, k: int):
    """Balanced base-b digits of each element, stacked on a new last
    axis: result[..., j] is digit j as a field element (Decompose trait,
    mod.rs:21-28)."""
    assert b % 2 == 0 and b > 1, "decomposition basis must be even"
    neg, cur = signed_magnitude(f, x)
    digits = []
    for _ in range(k):
        quot, m = cur // b, cur % b
        low = 2 * m <= b
        dmag = torch.where(low, m, b - m)
        dpos = f.from_canon(dmag)
        dneg = neg ^ ~low                  # the digit's sign flips when m > b/2
        digits.append(torch.where(dneg & (dmag != 0), f.neg(dpos), dpos))
        cur = torch.where(low, quot, quot + 1)
    return torch.stack(digits, dim=-1)


def recompose(f, digits, b: int):
    """Horner recombination sum_j b^j d_j over the last (digit) axis
    (mod.rs:105-117)."""
    _unlimbed(f)
    bf = f.const(b, digits.device)
    acc = None
    for j in reversed(range(digits.shape[-1])):
        d = digits[..., j]
        acc = d if acc is None else f.add(f.mul(acc, bf), d)
    return acc


def decompose_ring(f, x, b: int, k: int):
    """Ring elements [..., D] -> digits [..., k, D] (coeff_form.rs:588-606:
    digit j of coefficient i -> out[j].coeffs[i])."""
    return torch.movedim(decompose(f, x, b, k), -1, -2)


def recompose_ring(f, digits, b: int):
    """[..., k, D] -> [..., D]."""
    return recompose(f, torch.movedim(digits, -2, -1), b)


def gadget_decompose(f, x, b: int, k: int):
    """&[R]::gadget_decompose (mod.rs:163-175): [..., n, D] -> [..., n*k, D]
    with element i's digits at rows i*k .. i*k + k - 1."""
    dig = decompose_ring(f, x, b, k)     # [..., n, k, D]
    n, kk, D = dig.shape[-3:]
    return dig.reshape(dig.shape[:-3] + (n * kk, D))


def gadget_recompose(f, x, b: int, k: int):
    """[..., n*k, D] -> [..., n, D] (mod.rs:177-190)."""
    nk, D = x.shape[-2:]
    assert nk % k == 0
    return recompose_ring(f, x.reshape(x.shape[:-2] + (nk // k, k, D)), b)
