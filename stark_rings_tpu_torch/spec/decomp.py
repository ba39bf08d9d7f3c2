"""Integer-exact spec of balanced decomposition.

Mirrors the reference digit loop bit-for-bit
(crates/ring/src/balanced_decomposition/mod.rs:62-103): remainders are
Rust-style truncated (`%` has the sign of the dividend), the digit is kept
in [-b/2, b/2] with ties keeping the sign of the remainder, and the carry
uses `rounded_div` (round half away from zero, ops.rs:64-80).

Also provides the provably-equal fixed-iteration reformulation used by the
batched kernels (`decompose_balanced_fixed`): digits of -v are the negated
digits of v, and for v >= 0 each step is a single divmod —
``digit = m if 2m <= b else m - b; curr = (curr - digit) / b``.
"""

from __future__ import annotations

from typing import List


def trunc_div(a: int, b: int) -> int:
    """Rust-style integer division (rounds toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def trunc_rem(a: int, b: int) -> int:
    return a - b * trunc_div(a, b)


def rounded_div(a: int, b: int) -> int:
    """Round-half-away-from-zero division (linear_algebra ops.rs:64-80):
    |a|/|b| rounded to nearest, ties away from zero, sign via XOR."""
    s = -1 if (a < 0) != (b < 0) else 1
    return s * ((abs(a) + abs(b) // 2) // abs(b))


def to_signed(x: int, q: int) -> int:
    x %= q
    return x - q if x > (q - 1) // 2 else x


def decompose_balanced_ref(v_signed: int, b: int, k: int) -> List[int]:
    """Direct transcription of decompose_balanced_in_place (mod.rs:62-103)."""
    assert b > 1 and b % 2 == 0, "basis must be even and > 1"
    out = [0] * k
    curr = v_signed
    i = 0
    b_half = b // 2
    while True:
        rem = trunc_rem(curr, b)
        if abs(rem) <= b_half:
            out[i] = rem
            curr = trunc_div(curr, b)
        else:
            out[i] = rem + b if rem < 0 else rem - b
            curr = trunc_div(curr, b) + rounded_div(rem, b)
        i += 1
        if curr == 0:
            break
    assert i <= k, f"padding {k} too small"
    return out


def decompose_balanced_fixed(v_signed: int, b: int, k: int) -> List[int]:
    """Fixed-k, branch-uniform reformulation (the batched kernels'
    algorithm)."""
    sign = -1 if v_signed < 0 else 1
    curr = abs(v_signed)
    out = []
    for _ in range(k):
        m = curr % b
        d = m if 2 * m <= b else m - b
        curr = (curr - d) // b
        out.append(sign * d)
    assert curr == 0, f"padding {k} too small"
    return out


def decomposition_max_length(q: int, b: int) -> int:
    """Smallest k sufficient for every balanced digit expansion of a signed
    representative of Fq (|v| <= (q-1)/2).

    k digits cover exactly |v| <= cap_k = (b/2)(b^k-1)/(b-1) (the all-(b/2)
    expansion; ties at +b/2 make the bound inclusive), so we return the
    smallest k with cap_k >= (q-1)/2."""
    M = (q - 1) // 2
    cap = b // 2
    k = 1
    while cap < M:
        cap = cap * b + b // 2
        k += 1
    return k


def recompose_ints(digits: List[int], b: int) -> int:
    acc = 0
    for d in reversed(digits):
        acc = acc * b + d
    return acc


def decompose_balanced(v_signed: int, b: int,
                       padding_size: int | None = None) -> List[int]:
    """Decompose::decompose with the reference's padding contract
    (mod.rs:21-28 + the doc at mod.rs:48-61): ``padding_size=None``
    returns the element's natural (shortest) digit vector; an int pads
    with zeros to exactly ``k`` (asserting the value fits)."""
    if padding_size is not None:
        return decompose_balanced_fixed(v_signed, b, padding_size)
    # natural length: the reference loop runs until curr == 0 (always at
    # least one digit — decompose_balanced_in_place emits digit 0 first)
    assert b > 1 and b % 2 == 0, "basis must be even and > 1"
    sign = -1 if v_signed < 0 else 1
    curr = abs(v_signed)
    out = []
    while True:
        m = curr % b
        d = m if 2 * m <= b else m - b
        curr = (curr - d) // b
        out.append(sign * d)
        if curr == 0:
            break
    return out


def decompose_to_vec(vals_signed: List[int], b: int,
                     padding_size: int | None = None) -> List[List[int]]:
    """DecomposeToVec (mod.rs:119-161): per-element digit vectors.

    ``padding_size=None`` pads every vector "to the largest decomposition
    length required for v" (the documented None semantics); an int pads
    each to exactly ``k``."""
    nat = [decompose_balanced(v, b, None) for v in vals_signed]
    k = padding_size if padding_size is not None else \
        max((len(d) for d in nat), default=1)
    for v, d in zip(vals_signed, nat):
        assert len(d) <= k, f"padding {k} too small for {v}"
    return [d + [0] * (k - len(d)) for d in nat]
