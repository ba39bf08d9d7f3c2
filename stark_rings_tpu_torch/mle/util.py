"""Bit utilities of the poly crate (reference polynomials/util.rs:10-69
and mle/mod.rs swap_bits).  Pure Python: the same code as
``stark_rings_tpu/mle/util.py``."""

from __future__ import annotations

from typing import List

__all__ = ["bit_decompose", "project", "get_index", "get_batched_nv",
           "gen_eval_point_bits", "swap_bits"]


def bit_decompose(value: int, num_var: int) -> List[bool]:
    """Little-endian binary vector (util.rs:10-18)."""
    return [bool((value >> i) & 1) for i in range(num_var)]


def project(bits: List[bool]) -> int:
    """Little-endian binary vector -> integer (util.rs:57-64)."""
    res = 0
    for b in reversed(bits):
        res = (res << 1) | int(b)
    return res


def get_index(i: int, num_vars: int):
    """(x0, x1, sign) per util.rs:44-53."""
    bits = bit_decompose(i, num_vars)
    x0 = project([False] + bits[: num_vars - 1])
    x1 = project([True] + bits[: num_vars - 1])
    return x0, x1, bits[num_vars - 1]


def get_batched_nv(num_var: int, polynomials_len: int) -> int:
    """nv + ceil(log2(len)) (util.rs:32-35; ark log2 = ceil)."""
    return num_var + max((polynomials_len - 1).bit_length(), 0)


def gen_eval_point_bits(index: int, index_len: int) -> List[int]:
    """The bit suffix appended by gen_eval_point (util.rs:22-28); callers
    lift these 0/1 ints into ring elements."""
    return [int(b) for b in bit_decompose(index, index_len)]


def swap_bits(x: int, a: int, b: int, n: int) -> int:
    """Swap bit windows [a, a+n) and [b, b+n) of x (mle/mod.rs helper)."""
    a_bits = (x >> a) & ((1 << n) - 1)
    b_bits = (x >> b) & ((1 << n) - 1)
    local_mask = (1 << n) - 1
    mask = (local_mask << a) | (local_mask << b)
    return (x & ~mask) | (a_bits << b) | (b_bits << a)
