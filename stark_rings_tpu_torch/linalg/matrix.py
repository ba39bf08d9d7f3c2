"""Dense matrix over ring elements (counterpart of
``stark_rings_tpu/linalg/matrix.py``; reference matrix.rs:17-211).

``Matrix`` wraps one tensor ``vals`` of shape ``[nrows, ncols] +
elem_shape`` and an element adapter (:mod:`.elems`).  The reference's
loops over rows (matrix.rs:153) are batched ops: one broadcast multiply
and a modular tree sum.  The tensors live on the adapter's device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Matrix"]


class Matrix:
    def __init__(self, elems, vals):
        self.e = elems
        self.vals = vals

    # -- constructors (matrix.rs: zero/identity/rand) --------------------
    @classmethod
    def zero(cls, elems, nrows, ncols):
        return cls(elems, elems.zeros((nrows, ncols)))

    @classmethod
    def identity(cls, elems, n):
        vals = elems.zeros((n, n))
        idx = torch.arange(n, device=vals.device)
        vals[idx, idx] = elems.one()
        return cls(elems, vals)

    @classmethod
    def rand(cls, elems, nrows, ncols, rng: np.random.Generator):
        """Uniform elements drawn from the numpy Generator ``rng``."""
        return cls(elems, elems.rand((nrows, ncols), rng))

    @classmethod
    def from_ints(cls, elems, ints):
        return cls(elems, elems.encode(np.asarray(ints, dtype=object)))

    # -- shape ------------------------------------------------------------
    @property
    def nrows(self):
        return self.vals.shape[0]

    @property
    def ncols(self):
        return self.vals.shape[1]

    def decode(self):
        return self.e.decode(self.vals)

    # -- structural ops (matrix.rs: pad_rows/pad_cols/hconcat) ----------
    def pad_rows(self, n):
        assert n >= self.nrows
        pad = self.e.zeros((n - self.nrows, self.ncols))
        return Matrix(self.e, torch.cat([self.vals, pad], dim=0))

    def pad_cols(self, n):
        assert n >= self.ncols
        pad = self.e.zeros((self.nrows, n - self.ncols))
        return Matrix(self.e, torch.cat([self.vals, pad], dim=1))

    def hconcat(self, other):
        assert self.nrows == other.nrows
        return Matrix(self.e, torch.cat([self.vals, other.vals], dim=1))

    def vconcat(self, other):
        assert self.ncols == other.ncols
        return Matrix(self.e, torch.cat([self.vals, other.vals], dim=0))

    def transpose(self):
        return Matrix(self.e, torch.swapaxes(self.vals, 0, 1))

    # -- arithmetic (matrix.rs: checked_mul_mat / checked_mul_vec) -------
    def add(self, other):
        return Matrix(self.e, self.e.add(self.vals, other.vals))

    def sub(self, other):
        return Matrix(self.e, self.e.sub(self.vals, other.vals))

    def scalar_mul(self, s):
        """MulAssign<R> (matrix.rs): elementwise multiply by one element."""
        return Matrix(self.e, self.e.mul(self.vals, s))

    def mul_vec(self, v):
        """checked_mul_vec (matrix.rs:148-188): [n,m]+e @ [m]+e -> [n]+e.

        Raises AlgebraError on a dimension mismatch (the reference's
        checked_*/try_* contract, error.rs:4-8)."""
        if v.shape[0] != self.ncols:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: ncols={self.ncols}, len(v)={v.shape[0]}")
        return self.e.sum(self.e.mul(self.vals, v[None]), axis=1)

    # try_* = checked_* here: both report a dimension mismatch through
    # AlgebraError (the reference splits Result-returning try_mul_* from
    # panicking checked_* wrappers, matrix.rs:148-205; Python has one
    # error channel, so the names alias).
    def try_mul_vec(self, v):
        return self.mul_vec(v)

    def try_mul_mat(self, other):
        return self.mul_mat(other)

    def gadget_decompose(self, b: int, k: int):
        """n x m -> n x (k*m) balanced gadget decomposition, column c*k+j
        holding digit j of column c (balanced_decomposition/mod.rs:276-298
        through the per-row slice decompose, mod.rs:163-175).

        For ring-element matrices (trailing D axis) and scalar-element
        matrices alike (Matrix<R: Decompose> covers both)."""
        from ..decomp import decompose, gadget_decompose as gd

        f = self.e.f
        if getattr(self.e, "ring", None) is not None:
            return Matrix(self.e, gd(f, self.vals, b, k))
        dig = decompose(f, self.vals, b, k)   # [n, m, k(, L)]
        return Matrix(self.e, dig.reshape((self.nrows, self.ncols * k)
                                          + f.limb_shape))

    def gadget_recompose(self, b: int, k: int):
        from ..decomp import gadget_recompose as gr, recompose

        f = self.e.f
        if getattr(self.e, "ring", None) is not None:
            return Matrix(self.e, gr(f, self.vals, b, k))
        n, mk = self.nrows, self.ncols
        assert mk % k == 0
        return Matrix(self.e, recompose(
            f, self.vals.reshape((n, mk // k, k) + f.limb_shape), b))

    #: storage words of products materialized per k-block of the blocked
    #: mul_mat (2^25 words = 256 MB), the reference's budget
    _MULMAT_BUDGET_WORDS = 1 << 25

    def mul_mat(self, other, block: int | None = None):
        """checked_mul_mat: [n,k]+e @ [k,m]+e -> [n,m]+e.

        k-blocked: only [n, block, m]+e of products is live at a time;
        each block is widened to base-2^32 words and added into one
        [n, m]+e+words accumulator with integer adds (exact for up to
        2^32 addends), with one fold mod q at the end (reference: a
        triple loop, matrix.rs:148-188).  Bit-equal at any block."""
        if self.ncols != other.nrows:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: {self.ncols} vs {other.nrows}")
        f = self.e.f
        k = self.ncols
        # words a product: the element's storage words, widened (a limbed
        # field's limbs are its words already)
        elem_words = int(np.prod(self.e.elem_shape, dtype=np.int64))
        if not f.limbed:
            elem_words *= f.n_words
        if block is None:
            per_slice = max(1, self.nrows * other.ncols * elem_words)
            block = max(1, min(k, self._MULMAT_BUDGET_WORDS // per_slice))
        if block >= k:
            prod = self.e.mul(self.vals[:, :, None], other.vals[None])
            return Matrix(self.e, self.e.sum(prod, axis=1))
        acc = None
        for s in range(0, k, block):
            a = self.vals[:, s:s + block, None]     # [n, kb, 1]+e
            b = other.vals[None, s:s + block]       # [1, kb, m]+e
            w = f.widen(self.e.mul(a, b)).sum(dim=1)   # [n, m]+e+[W]
            acc = w if acc is None else acc + w
        return Matrix(self.e, f.reduce_words(acc))
