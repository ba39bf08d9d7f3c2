"""Goldilocks arithmetic on (lo, hi) u32 pairs: the plain twins of the
fold kernels' field helpers.

Line-for-line counterparts of the u32-pair helpers of
``stark_rings_tpu/ops/pallas_goldilocks.py`` (``_mul32`` ...
``_mul_q``).  Each u32 word is an int64 tensor holding a value in
[0, 2^32); every sum and difference is masked back to 32 bits, and the
16-bit splits of :func:`_mul32` keep every intermediate below 2^63, so
int64 never overflows and plain signed compares are unsigned compares.

The CUDA kernels (``csrc/goldilocks.cuh``) compute the same functions
on native ``uint64_t`` with ``__umul64hi``: the two are independent
implementations, which is what makes comparing them on the card
meaningful.
"""

from __future__ import annotations

import torch

__all__ = ["split", "join", "_mul32", "_pair_add", "_pair_sub", "_add_q",
           "_sub_q", "_reduce128", "_mul64_128", "_mul_q"]

M32 = 0xFFFFFFFF
_Q_LO = 1
_Q_HI = M32
_EPS = M32  # 2^64 mod q = 2^32 - 1


def split(x: torch.Tensor):
    """int64 u64 bit patterns -> (lo, hi) u32 words."""
    return x & M32, (x >> 32) & M32


def join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) u32 words -> int64 u64 bit patterns."""
    return lo | (hi << 32)


def _lt(a, b) -> torch.Tensor:
    return (a < b).to(torch.int64)


def _mul32(a, b):
    """32x32 -> 64 as (lo, hi) via 16-bit splits."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    ll = a0 * b0
    m1 = a0 * b1
    m2 = a1 * b0
    hh = a1 * b1
    mid = (m1 + m2) & M32
    carry_m = _lt(mid, m1)
    lo = (ll + (mid << 16)) & M32
    carry_lo = _lt(lo, ll)
    hi = (hh + (mid >> 16) + (carry_m << 16) + carry_lo) & M32
    return lo, hi


def _pair_add(alo, ahi, blo, bhi):
    """(a + b) mod 2^64 with carry-out."""
    lo = (alo + blo) & M32
    c0 = _lt(lo, alo)
    hi = (ahi + bhi) & M32
    c1 = _lt(hi, ahi)
    hi2 = (hi + c0) & M32
    c2 = _lt(hi2, hi)
    return lo, hi2, c1 | c2


def _pair_sub(alo, ahi, blo, bhi):
    """(a - b) mod 2^64 with borrow-out."""
    lo = (alo - blo) & M32
    b0 = _lt(alo, blo)
    hi = (ahi - bhi) & M32
    b1 = _lt(ahi, bhi)
    hi2 = (hi - b0) & M32
    b2 = _lt(hi, b0)
    return lo, hi2, b1 | b2


def _add_q(alo, ahi, blo, bhi):
    """(a + b) mod q, canonical inputs/outputs."""
    lo, hi, carry = _pair_add(alo, ahi, blo, bhi)
    ge = (hi > _Q_HI) | ((hi == _Q_HI) & (lo >= _Q_LO))
    red = (carry != 0) | ge
    slo, shi, _ = _pair_sub(lo, hi, _Q_LO, _Q_HI)
    return torch.where(red, slo, lo), torch.where(red, shi, hi)


def _sub_q(alo, ahi, blo, bhi):
    lo, hi, borrow = _pair_sub(alo, ahi, blo, bhi)
    alo2, ahi2, _ = _pair_add(lo, hi, _Q_LO, _Q_HI)
    neg = borrow != 0
    return torch.where(neg, alo2, lo), torch.where(neg, ahi2, hi)


def _reduce128(lo0, lo1, hi0, hi1):
    """(hi1*2^96 + hi0*2^64 + lo1*2^32 + lo0) mod q — Goldilocks fold."""
    # t = lo - hi1 (64-bit), wrap => subtract 2^32-1 once more
    tlo, thi, br = _pair_sub(lo0, lo1, hi1, 0)
    t2lo, t2hi, _ = _pair_sub(tlo, thi, _EPS, 0)
    tlo = torch.where(br != 0, t2lo, tlo)
    thi = torch.where(br != 0, t2hi, thi)
    # t1 = hi0 * (2^32 - 1) = (hi0 << 32) - hi0
    nz = (hi0 != 0).to(torch.int64)
    t1lo = (-hi0) & M32
    t1hi = hi0 - nz
    # t2 = t + t1, wrap => add 2^32-1
    slo, shi, carry = _pair_add(tlo, thi, t1lo, t1hi)
    s2lo, s2hi, _ = _pair_add(slo, shi, _EPS, 0)
    slo = torch.where(carry != 0, s2lo, slo)
    shi = torch.where(carry != 0, s2hi, shi)
    # canonicalize
    ge = (shi > _Q_HI) | ((shi == _Q_HI) & (slo >= _Q_LO))
    clo, chi, _ = _pair_sub(slo, shi, _Q_LO, _Q_HI)
    return torch.where(ge, clo, slo), torch.where(ge, chi, shi)


def _mul64_128(alo, ahi, blo, bhi):
    """Full 64x64 -> 128 product of u32 pairs, as four u32 words
    (lo0, lo1, hi0, hi1) = bits [0:32), [32:64), [64:96), [96:128)."""
    ll_lo, ll_hi = _mul32(alo, blo)
    lh_lo, lh_hi = _mul32(alo, bhi)
    hl_lo, hl_hi = _mul32(ahi, blo)
    hh_lo, hh_hi = _mul32(ahi, bhi)
    # 128-bit accumulate
    s1 = (ll_hi + lh_lo) & M32
    c1 = _lt(s1, ll_hi)
    s2 = (s1 + hl_lo) & M32
    c2 = _lt(s2, s1)
    lo1 = s2
    carry_mid = c1 + c2
    t1 = (lh_hi + hl_hi) & M32
    d1 = _lt(t1, lh_hi)
    t2 = (t1 + hh_lo) & M32
    d2 = _lt(t2, t1)
    t3 = (t2 + carry_mid) & M32
    d3 = _lt(t3, t2)
    hi0 = t3
    hi1 = (hh_hi + d1 + d2 + d3) & M32
    return ll_lo, lo1, hi0, hi1


def _mul_q(alo, ahi, blo, bhi):
    """(a * b) mod q on canonical pairs."""
    lo0, lo1, hi0, hi1 = _mul64_128(alo, ahi, blo, bhi)
    return _reduce128(lo0, lo1, hi0, hi1)
