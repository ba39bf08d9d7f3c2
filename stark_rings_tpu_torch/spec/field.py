"""Arbitrary-precision prime-field helpers (host side, Python ints).

Mirrors the role of arkworks' `MontBackend` in the reference
(crates/ring/src/cyclotomic_ring/models/*/mod.rs) but in canonical (non
Montgomery) representation: every value is an int in ``[0, q)``.
"""

from __future__ import annotations


def modpow(a: int, e: int, q: int) -> int:
    return pow(a % q, e, q)


def modinv(a: int, q: int) -> int:
    """Inverse via Fermat (q prime)."""
    a %= q
    if a == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, q - 2, q)


def to_signed(x: int, q: int) -> int:
    """Balanced (signed) representative in [-(q-1)/2, (q-1)/2].

    Mirrors `SignedRepresentative::from(Fp)` in the reference
    (balanced_decomposition/fq_convertible.rs:23-33): values above
    (q-1)/2 map to negative.
    """
    x %= q
    return x - q if x > (q - 1) // 2 else x


def from_signed(x: int, q: int) -> int:
    return x % q


def center(x: int, q: int) -> int:
    """|signed representative| as a field element — `Zq::center`
    (crates/ring/src/ring.rs:159-168)."""
    s = to_signed(x, q)
    return abs(s) % q


def sign(x: int, q: int) -> int:
    """+1 for values <= (q-1)/2, q-1 (i.e. -1) otherwise — `Zq::sign`
    (crates/ring/src/ring.rs:170-179)."""
    x %= q
    return 1 if x <= (q - 1) // 2 else q - 1
