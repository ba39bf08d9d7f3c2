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

For the 252-bit stark prime the magnitude lives in eight u32 limbs
(int64 words here) and the divmod by b is a short multi-limb long
division (b < 2^32), mirroring the BigInt path of
stark_prime/decomposition.rs:11-64; the digits stack on axis -2, before
the limbs, and ``linf_norm`` reduces with a halving tree of
lexicographic compares.
"""

from __future__ import annotations

import torch

from ..fields.field import MASK32, u64_lt
from ..spec.decomp import decomposition_max_length

__all__ = [
    "signed_magnitude", "center", "sign", "linf_norm",
    "decompose", "recompose", "decompose_ring", "recompose_ring",
    "gadget_decompose", "gadget_recompose", "decomposition_max_length",
]


def signed_magnitude(f, x):
    """(neg_mask, magnitude) of the balanced signed representative.

    Mirrors SignedRepresentative::from (fq_convertible.rs:8-62): values
    above (q-1)/2 are negative.  The magnitude is canonical storage
    (< q, not in Montgomery form), in the field's storage dtype."""
    u = f.canon(x)
    half = f.canon_const((f.q - 1) // 2)
    if f.limbed:
        neg = ~f.geq(half, u)
        mag = f.select(neg, f.sub(f._raw_tensor(f.q, u.device), u), u)
    elif f.dtype == torch.int64:        # u64 bits: unsigned compare
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
    return f.select(neg, f.neg(one), one)


def linf_norm(f, x, axis=None):
    """max |signed| over ``axis`` (all element axes when None), as
    canonical magnitude storage.  Limbed fields reduce with a halving
    tree of lexicographic compares (never along the limb axis)."""
    _, mag = signed_magnitude(f, x)
    if not f.limbed:
        return mag.max() if axis is None else torch.amax(mag, dim=axis)
    if axis is None:
        mag, axis = mag.reshape(-1, mag.shape[-1]), 0
    axis %= mag.dim() - 1

    def larger(a, b):
        return f.select(f.geq(a, b), a, b)

    rem = None
    while mag.shape[axis] > 1:
        n = mag.shape[axis]
        if n % 2:
            tail = mag.narrow(axis, n - 1, 1)
            rem = tail if rem is None else larger(tail, rem)
            mag = mag.narrow(axis, 0, n - 1)
            n -= 1
        mag = larger(mag.narrow(axis, 0, n // 2),
                     mag.narrow(axis, n // 2, n // 2))
    if rem is not None:
        mag = larger(rem, mag)
    return mag.squeeze(axis)


def _divmod_limbs(mag64, b: int):
    """Long division of little-endian limbs (int64 words below 2^32,
    [..., n]) by 0 < b < 2^32: (quotient limbs, remainder).  Each limb
    divides in two 16-bit halves, so every dividend (r * 2^16 + half,
    r < b) stays below 2^48 and int64 division is exact; a whole
    r * 2^32 + limb passes 2^63 for b >= 2^31."""
    assert 1 < b < 2**32
    r = torch.zeros_like(mag64[..., 0])
    quot = []
    for j in reversed(range(mag64.shape[-1])):
        limb = mag64[..., j]
        t = (r << 16) | (limb >> 16)
        q_hi, r = t // b, t % b
        t = (r << 16) | (limb & 0xFFFF)
        q_lo, r = t // b, t % b
        quot.append((q_hi << 16) | q_lo)
    return torch.stack(quot[::-1], dim=-1), r


def _add1_limbs(x64, mask):
    """Add 1 where ``mask`` to little-endian limbs (int64 words)."""
    carry = mask.to(torch.int64)
    out = []
    for j in range(x64.shape[-1]):
        s = x64[..., j] + carry
        out.append(s & MASK32)
        carry = s >> 32
    return torch.stack(out, dim=-1)


def decompose(f, x, b: int, k: int):
    """Balanced base-b digits of each element, stacked on a new axis: the
    last (scalar fields) or the one before the limbs (stark_prime);
    digit j is a field element (Decompose trait, mod.rs:21-28)."""
    assert b % 2 == 0 and b > 1, "decomposition basis must be even"
    neg, mag = signed_magnitude(f, x)
    digits = []
    cur = f.widen(mag) if f.limbed else mag
    for _ in range(k):
        if f.limbed:
            quot, m = _divmod_limbs(cur, b)
        else:
            quot, m = cur // b, cur % b
        low = 2 * m <= b
        dmag = torch.where(low, m, b - m)
        dpos = f.from_uint(dmag) if f.limbed else f.from_canon(dmag)
        dneg = neg ^ ~low                  # the digit's sign flips when m > b/2
        digits.append(f.select(dneg & (dmag != 0), f.neg(dpos), dpos))
        cur = (_add1_limbs(quot, ~low) if f.limbed
               else torch.where(low, quot, quot + 1))
    return torch.stack(digits, dim=-1 - len(f.limb_shape))


def recompose(f, digits, b: int):
    """Horner recombination sum_j b^j d_j over the digit axis
    (mod.rs:105-117)."""
    axis = digits.dim() - 1 - len(f.limb_shape)
    bf = f.const(b, digits.device)
    acc = None
    for j in reversed(range(digits.shape[axis])):
        d = digits.select(axis, j)
        acc = d if acc is None else f.add(f.mul(acc, bf), d)
    return acc


def decompose_ring(f, x, b: int, k: int):
    """Ring elements [..., D(, L)] -> digits [..., k, D(, L)]
    (coeff_form.rs:588-606: digit j of coefficient i -> out[j].coeffs[i])."""
    nd = len(f.limb_shape)
    return torch.movedim(decompose(f, x, b, k), -1 - nd, -2 - nd)


def recompose_ring(f, digits, b: int):
    """[..., k, D(, L)] -> [..., D(, L)]."""
    nd = len(f.limb_shape)
    return recompose(f, torch.movedim(digits, -2 - nd, -1 - nd), b)


def gadget_decompose(f, x, b: int, k: int):
    """&[R]::gadget_decompose (mod.rs:163-175): [..., n, D(, L)] ->
    [..., n*k, D(, L)] with element i's digits at rows i*k .. i*k + k - 1."""
    dig = decompose_ring(f, x, b, k)     # [..., n, k, D(, L)]
    tail = dig.shape[dig.dim() - 1 - len(f.limb_shape):]
    n, kk = dig.shape[dig.dim() - 2 - len(tail):dig.dim() - len(tail)]
    return dig.reshape(dig.shape[:dig.dim() - 2 - len(tail)] + (n * kk,)
                       + tail)


def gadget_recompose(f, x, b: int, k: int):
    """[..., n*k, D(, L)] -> [..., n, D(, L)] (mod.rs:177-190)."""
    tail = x.shape[x.dim() - 1 - len(f.limb_shape):]
    nk = x.shape[x.dim() - 1 - len(tail)]
    assert nk % k == 0
    lead = x.shape[:x.dim() - 1 - len(tail)]
    return recompose_ring(f, x.reshape(lead + (nk // k, k) + tail), b)
