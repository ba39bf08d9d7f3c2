"""Operator-level ring elements: the reference's `RqPoly` / `RqNTT`
ergonomics on top of the functional batched API (counterpart of
``stark_rings_tpu/rings/element.py``).

``a * b``, ``a + b``, ``-a``, ``a * 3`` and ``a == b`` over one element
or a batch (leading axes), carrying the form ("coeff" / "ntt") so that a
form error is caught at the API instead of giving a wrong slot-wise
product:

    >>> R = get_ring("goldilocks", device="cpu")
    >>> a = Rq.rand(R, (), np.random.default_rng(0))   # coeff form
    >>> b = Rq.from_ints(R, [1] + [0] * (R.D - 1))      # the constant 1
    >>> (a * b) == a
    True
    >>> an = a.crt()                                     # NTT form
    >>> (an * an).icrt() == a * a
    True

The decomposition and norm methods run on the port's decomposition
layer (:mod:`..decomp`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Rq"]


class Rq:
    """One ring element or a batch ([..., D] storage) with a form."""

    __slots__ = ("ring", "form", "data")

    def __init__(self, ring, form: str, data):
        if form not in ("coeff", "ntt"):
            raise ValueError(f"form must be 'coeff' or 'ntt', got {form!r}")
        self.ring = ring
        self.form = form
        self.data = data

    # -- constructors ------------------------------------------------------
    @classmethod
    def coeff(cls, ring, data):
        return cls(ring, "coeff", data)

    @classmethod
    def ntt(cls, ring, data):
        return cls(ring, "ntt", data)

    @classmethod
    def from_ints(cls, ring, ints, form: str = "coeff"):
        """From python ints; coefficient lists longer than D reduce mod
        Phi(X) (From<Vec> semantics, coeff_form.rs:568-578)."""
        if form == "coeff":
            return cls(ring, form, ring.from_coeff_list(list(ints)))
        return cls(ring, form, ring.encode_coeffs(np.asarray(ints,
                                                             dtype=object)))

    @classmethod
    def from_scalar(cls, ring, v: int, form: str = "coeff", shape=()):
        data = (ring.from_scalar_coeff(v, shape) if form == "coeff"
                else ring.from_scalar_ntt(v, shape))
        return cls(ring, form, data)

    @classmethod
    def zero(cls, ring, shape=(), form: str = "coeff"):
        return cls(ring, form, ring.zeros(shape))

    @classmethod
    def one(cls, ring, shape=(), form: str = "coeff"):
        return cls.from_scalar(ring, 1, form, shape)

    @classmethod
    def rand(cls, ring, shape, rng: np.random.Generator, form: str = "coeff"):
        """Uniform elements drawn from the numpy Generator ``rng``."""
        return cls(ring, form, ring.rand_coeff(shape, rng))

    # -- views ---------------------------------------------------------------
    def crt(self) -> "Rq":
        self._need("coeff", "crt()")
        return Rq(self.ring, "ntt", self.ring.crt(self.data))

    def icrt(self) -> "Rq":
        self._need("ntt", "icrt()")
        return Rq(self.ring, "coeff", self.ring.icrt(self.data))

    def decode(self):
        """Canonical python-int coefficients (host)."""
        return self.ring.decode(self.data)

    def coeffs(self):
        """PolyRing::coeffs view: the storage tensor itself."""
        return self.data

    def ct(self):
        """Constant term (CoeffRing::ct), as storage [..., 1(, L)]."""
        self._need("coeff", "ct()")
        return self.data.narrow(self.ring.field.coeff_axis, 0, 1)

    # -- arithmetic ------------------------------------------------------
    def _need(self, form, what):
        if self.form != form:
            raise ValueError(f"{what} needs {form} form, got {self.form}")

    def _like(self, data):
        return Rq(self.ring, self.form, data)

    def _check(self, other):
        if not isinstance(other, Rq) or other.ring is not self.ring:
            raise TypeError("operands must be Rq elements of one ring")
        if other.form != self.form:
            raise ValueError(f"form mismatch: {self.form} vs {other.form}")

    def __add__(self, other):
        self._check(other)
        return self._like(self.ring.add(self.data, other.data))

    def __sub__(self, other):
        self._check(other)
        return self._like(self.ring.sub(self.data, other.data))

    def __neg__(self):
        return self._like(self.ring.neg(self.data))

    def __mul__(self, other):
        if isinstance(other, Rq):
            self._check(other)
            mul = (self.ring.ntt_mul if self.form == "ntt"
                   else self.ring.coeff_mul)
            return self._like(mul(self.data, other.data))
        if isinstance(other, (int, np.integer)):
            s = self.ring.field.const(int(other), self.ring.device)
            return self._like(self.ring.scalar_mul(s, self.data))
        # a base-field scalar in storage form
        return self._like(self.ring.scalar_mul(other, self.data))

    __rmul__ = __mul__

    def square(self) -> "Rq":
        """self * self; in coefficient form through coeff_square where the
        ring has one (PowerRing), which saves a forward transform."""
        if self.form == "ntt":
            return self._like(self.ring.ntt_mul(self.data, self.data))
        sq = getattr(self.ring, "coeff_square", None)
        if sq is not None:
            return self._like(sq(self.data))
        return self._like(self.ring.coeff_mul(self.data, self.data))

    def __pow__(self, e: int):
        """Ring::pow (square and multiply, ring.rs:13-117) on either form:
        a coefficient-form element goes through CRT (the same result,
        one transform round trip)."""
        if e < 0:
            raise ValueError("negative exponents: use inv() then pow")
        if self.form == "coeff":
            n = self.ring.ntt_pow(self.ring.crt(self.data), e)
            return self._like(self.ring.icrt(n))
        return self._like(self.ring.ntt_pow(self.data, e))

    def inv(self):
        self._need("ntt", "inv() (the inverse is slot-wise)")
        return self._like(self.ring.ntt_inv(self.data))

    def rot(self):
        """Multiply by X (Cyclotomic::rot)."""
        self._need("coeff", "rot()")
        return self._like(self.ring.rot(self.data))

    def __eq__(self, other):
        if not isinstance(other, Rq):
            return NotImplemented
        if other.ring is not self.ring or other.form != self.form:
            return False
        return torch.equal(self.data, other.data)

    def __hash__(self):  # storage tensors are unhashable; identity hash
        return id(self)

    # -- decomposition / norms ------------------------------------------
    def decompose(self, b: int, k: int):
        """Balanced digits along a new axis (Decompose trait); coefficient
        form, returns raw digit storage [..., k, D]."""
        from ..decomp import decompose_ring

        self._need("coeff", "decompose()")
        return decompose_ring(self.ring.field, self.data, b, k)

    @classmethod
    def recompose(cls, ring, digits, b: int):
        from ..decomp import recompose_ring

        return cls(ring, "coeff", recompose_ring(ring.field, digits, b))

    def linf_norm(self):
        from ..decomp import linf_norm

        self._need("coeff", "linf_norm()")
        return linf_norm(self.ring.field, self.data)

    def l2_norm_squared_words(self):
        """Exact ||.||_2^2 over ALL coefficients (WithL2Norm,
        traits.rs:6-56) as little-endian base-2^32 words on the device;
        decode with ``decomp.words_to_int``."""
        from ..decomp import l2_norm_squared_words

        self._need("coeff", "l2_norm_squared_words()")
        return l2_norm_squared_words(self.ring.field, self.data)

    def l2_check(self, bound_sq: int):
        """||.||_2^2 <= bound_sq on the device (no host round trip)."""
        from ..decomp import l2_check

        self._need("coeff", "l2_check()")
        return l2_check(self.ring.field, self.data, bound_sq)

    # -- misc ---------------------------------------------------------------
    @property
    def shape(self):
        """Batch shape (the leading axes before the coefficient axis)."""
        return tuple(self.ring.batch_shape(self.data))

    def __repr__(self):
        return f"Rq({self.ring.name}, {self.form}, batch={self.shape})"
