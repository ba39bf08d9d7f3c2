"""Typed error surface (counterpart of ``stark_rings_tpu/errors.py``; the
reference's error enums consolidated):

* ConversionError  — crates/ring/src/error.rs:3-9
* AlgebraError     — linear_algebra/src/error.rs:4-8 (re-export)
* ArithError       — poly/src/polynomials/errors.rs:13-21 (re-export)
* MonomialError    — monomial.rs:6-12 (re-export)
"""

from .linalg import AlgebraError
from .mle import ArithError
from .rings.monomial import MonomialError

__all__ = ["ConversionError", "AlgebraError", "ArithError", "MonomialError"]


class ConversionError(ValueError):
    """ToInteger / Overflow conversion failures (ring error.rs:3-9)."""
