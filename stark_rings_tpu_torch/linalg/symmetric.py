"""Symmetric matrix in packed lower-triangular form (counterpart of
``stark_rings_tpu/linalg/symmetric.py``; reference
symmetric_matrix.rs:15-153) and the G^T M G recomposition
(balanced_decomposition/mod.rs:358-386)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SymmetricMatrix", "recompose_left_right_symmetric_matrix"]


def _tri(i, j):
    a, b = (i, j) if i >= j else (j, i)
    return a * (a + 1) // 2 + b


def _lower(n: int):
    """(i, j) int64 index arrays of the packed lower triangle, row-major."""
    ii, jj = np.tril_indices(n)
    return ii.astype(np.int64), jj.astype(np.int64)


class SymmetricMatrix:
    """Packed lower-triangular storage: vals [n(n+1)/2]+elem; at(i, j)
    swaps its indices (symmetric_matrix.rs at/at_mut)."""

    def __init__(self, elems, n, vals):
        self.e = elems
        self.n = int(n)
        self.vals = vals

    @classmethod
    def zero(cls, elems, n):
        return cls(elems, n, elems.zeros((n * (n + 1) // 2,)))

    @classmethod
    def rand(cls, elems, n, rng: np.random.Generator):
        """Uniform entries drawn from the numpy Generator ``rng``."""
        return cls(elems, n, elems.rand((n * (n + 1) // 2,), rng))

    @classmethod
    def from_rows(cls, elems, rows):
        """rows[i] holds i+1 entries (the reference's Vec<Vec<F>>
        invariant, symmetric_matrix.rs:19)."""
        flat = []
        for i, r in enumerate(rows):
            if len(r) != i + 1:
                raise ValueError(f"row {i} must have {i + 1} entries, "
                                 f"got {len(r)}")
            flat.extend(r)
        vals = (elems.encode(np.array(flat, dtype=object)) if flat
                else elems.zeros((0,)))
        return cls(elems, len(rows), vals)

    @classmethod
    def from_fn(cls, elems, n, func, vectorized=False):
        """Entry (i, j) = ``func(i, j)`` over the packed lower triangle,
        the ``from_par_fn`` constructor (symmetric_matrix.rs:77-89).
        With ``vectorized=True`` func receives the int64 index arrays
        (ii, jj) of shape [n(n+1)/2] and returns the packed storage in
        one call; else it is called per entry and returns a Python int
        (or per-element ints)."""
        ii, jj = _lower(n)
        if vectorized:
            return cls(elems, n, func(ii, jj))
        flat = np.array([func(int(i), int(j)) for i, j in zip(ii, jj)],
                        dtype=object)
        vals = elems.encode(flat) if len(flat) else elems.zeros((0,))
        return cls(elems, n, vals)

    @classmethod
    def from_dense_vals(cls, elems, dense):
        """The lower triangle of a dense [n, n]+elem storage tensor."""
        ii, jj = _lower(dense.shape[0])
        dev = dense.device
        return cls(elems, dense.shape[0],
                   dense[torch.as_tensor(ii, device=dev),
                         torch.as_tensor(jj, device=dev)])

    def size(self):
        return self.n

    def at(self, i, j):
        return self.vals[_tri(i, j)]

    def set_at(self, i, j, v):
        """A new matrix with entry (i, j), and so (j, i), set to v."""
        vals = self.vals.clone()
        vals[_tri(i, j)] = v
        return SymmetricMatrix(self.e, self.n, vals)

    def diag(self):
        idx = torch.as_tensor([_tri(i, i) for i in range(self.n)],
                              dtype=torch.int64, device=self.vals.device)
        return self.vals.index_select(0, idx)

    def to_dense(self):
        """[n, n]+elem storage."""
        i = torch.arange(self.n, device=self.vals.device)
        a, b = torch.maximum(i[:, None], i), torch.minimum(i[:, None], i)
        return self.vals[a * (a + 1) // 2 + b]

    def map_mul(self, s):
        return SymmetricMatrix(self.e, self.n, self.e.mul(self.vals, s))

    def decode(self):
        return self.e.decode(self.vals)


def recompose_left_right_symmetric_matrix(sym: SymmetricMatrix,
                                          powers_of_basis):
    """G^T M G with G = I_n (x) (1, b, ..., b^(d-1))
    (balanced_decomposition/mod.rs:358-386).

    M is (n*d) x (n*d) symmetric; the result is n x n symmetric:
    out[i, j] = sum over k in block i, l in block j of
    M[k, l] pb[k mod d] pb[l mod d]."""
    e = sym.e
    pb = powers_of_basis                          # [d]+elem
    d = pb.shape[0]
    nd = sym.size()
    if nd % d:
        raise ValueError(f"size {nd} is not a multiple of d = {d}")
    n = nd // d
    dense = sym.to_dense()                        # [nd, nd]+elem
    scale = pb.repeat((n,) + (1,) * (pb.dim() - 1))   # [nd]+elem
    w = e.mul(dense, scale[None, :])              # scale the columns
    w = e.mul(w, scale[:, None])                  # scale the rows
    w = w.reshape((n, d, n, d) + tuple(w.shape[2:]))
    s = e.sum(e.sum(w, axis=3), axis=1)
    return SymmetricMatrix.from_dense_vals(e, s)
