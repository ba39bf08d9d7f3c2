"""Signed/Unsigned representative newtypes (counterpart of
``stark_rings_tpu/decomp/representatives.py``; reference
balanced_decomposition/representatives.rs:10-383).

Python ints are arbitrary-precision, so the ~30 forwarding impls of the
reference collapse to thin wrappers that exist for API parity: they carry
the *intent* (signed balanced lift vs raw unsigned value) through code
that converts between rings and integers (fq_convertible.rs:8-62,
stark_prime/decomposition.rs:11-64)."""

from __future__ import annotations

from ..spec.field import to_signed

__all__ = ["SignedRepresentative", "UnsignedRepresentative"]


class _IntWrapper:
    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = int(value)

    def __int__(self):
        return self.value

    def __eq__(self, other):
        return self.value == int(other)

    def __hash__(self):
        return hash((type(self).__name__, self.value))

    def __repr__(self):
        return f"{type(self).__name__}({self.value})"

    def _wrap(self, v):
        return type(self)(v)

    def __add__(self, o):
        return self._wrap(self.value + int(o))

    def __sub__(self, o):
        return self._wrap(self.value - int(o))

    def __mul__(self, o):
        return self._wrap(self.value * int(o))

    def __neg__(self):
        return self._wrap(-self.value)

    def __floordiv__(self, o):
        return self._wrap(self.value // int(o))

    def __mod__(self, o):
        return self._wrap(self.value % int(o))

    def __xor__(self, o):
        return self._wrap(self.value ^ int(o))

    def __lt__(self, o):
        return self.value < int(o)

    def __le__(self, o):
        return self.value <= int(o)

    def __abs__(self):
        return self._wrap(abs(self.value))


class SignedRepresentative(_IntWrapper):
    """Balanced signed lift of a field element: |v| <= (q-1)/2."""

    @classmethod
    def from_field(cls, f, x_int: int):
        return cls(to_signed(x_int, f.q))

    def to_field_int(self, f) -> int:
        return self.value % f.q


class UnsignedRepresentative(_IntWrapper):
    """Canonical unsigned value in [0, q)."""
