"""Goldilocks arithmetic (q = 2^64 - 2^32 + 1) in plain PyTorch ops.

Elements are ``torch.int64`` tensors holding the canonical u64 bit
pattern of a value in [0, q).  int64 add, subtract and multiply wrap
mod 2^64 as u64 arithmetic does; every unsigned compare flips the sign
bit first, and every right shift is masked, so no step reads a word as
signed.  The product is the schoolbook 64 x 64 -> 128-bit product of
32-bit halves, reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod q).

``truncated=True`` on :func:`mul` drops the high 64 bits of the 128-bit
product before the reduction: the product computed at half its width,
the control that the benchmark's comparison has to reject.

This file is the benchmark's yardstick: it imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

Q = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def word(v: int) -> int:
    """The int64 bit pattern of a u64 value."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def to_int(w: int) -> int:
    """The u64 value of an int64 bit pattern."""
    return w % (1 << 64)


Q_W = word(Q)


def tensor(values, device) -> torch.Tensor:
    """Python ints (any sign, reduced mod q) -> canonical storage."""
    return torch.tensor([word(v % Q) for v in values], dtype=torch.int64,
                        device=device)


def shr32(x):
    return (x >> 32) & M32


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def canon(x):
    """Any u64 word -> its residue in [0, q) (one subtraction suffices)."""
    return torch.where(ult(x, torch.full_like(x, Q_W)), x, x - Q_W)


def add(a, b):
    s = a + b
    s = torch.where(ult(s, a), s + EPS, s)      # carry out of 2^64
    return canon(s)


def sub(a, b):
    d = a - b
    return torch.where(ult(a, b), d + Q_W, d)


def neg(a):
    return torch.where(a == 0, a, Q_W - a)


def mul_wide(a, b):
    """128-bit product as (hi, lo) u64 words."""
    a0, a1 = a & M32, shr32(a)
    b0, b1 = b & M32, shr32(b)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = shr32(p00) + (p01 & M32) + (p10 & M32)        # < 3 * 2^32
    lo = (p00 & M32) | (mid << 32)
    hi = p11 + shr32(p01) + shr32(p10) + shr32(mid)
    return hi, lo


def reduce128(hi, lo):
    """(hi * 2^64 + lo) mod q, canonical."""
    hh, hl = shr32(hi), hi & M32
    t0 = lo - hh
    t0 = torch.where(ult(lo, hh), t0 - EPS, t0)          # borrow
    t1 = hl * EPS                                        # < 2^64
    t2 = t0 + t1
    t2 = torch.where(ult(t2, t1), t2 + EPS, t2)          # carry
    return canon(t2)


def mul(a, b, truncated: bool = False):
    hi, lo = mul_wide(a, b)
    if truncated:
        hi = torch.zeros_like(hi)
    return reduce128(hi, lo)


def sum_mod(x, dim):
    """Sum mod q along ``dim``: the halves are summed exactly (up to
    2^31 terms) and the 96-bit total is reduced once."""
    n = x.shape[dim]
    if n >= 1 << 31:
        raise ValueError("sum_mod: too many terms for one exact sum")
    s_lo = (x & M32).sum(dim=dim)
    s_hi = shr32(x).sum(dim=dim)
    lo = s_lo + ((s_hi & M32) << 32)
    hi = shr32(s_hi) + ult(lo, s_lo).to(torch.int64)
    return reduce128(hi, lo)


def pow_int(a: int, e: int) -> int:
    return pow(a, e, Q)
