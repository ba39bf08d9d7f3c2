"""Dense multilinear extensions over a field (counterpart of
``stark_rings_tpu/mle/dense.py``; reference poly crate mle/dense.rs).

Evaluations over {0,1}^n are one tensor ``evals [2^n]`` with the
reference's little-endian index convention: variable 0 is the least
significant bit, and ``fix_variables`` pairs adjacent entries.  Storage
is always the full 2^n table, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DenseMLE"]


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _lerp(e, left, right, r):
    """left + r*(right - left): binds one variable to r."""
    return e.add(left, e.mul(r, e.sub(right, left)))


class DenseMLE:
    def __init__(self, elems, num_vars: int, evals: torch.Tensor):
        self.e = elems
        self.num_vars = int(num_vars)
        if evals.shape[0] != 1 << self.num_vars:
            raise ValueError(f"DenseMLE: {evals.shape[0]} evaluations for "
                             f"{self.num_vars} variables")
        self.evals = evals

    # -- constructors (dense.rs:35-89) -----------------------------------
    @classmethod
    def from_evaluations(cls, elems, num_vars, evals):
        return cls(elems, num_vars, evals)

    @classmethod
    def from_ints(cls, elems, num_vars, ints):
        arr = np.asarray(ints, dtype=object)
        n = 1 << num_vars
        if arr.shape[0] < n:
            pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], dtype=object)
            arr = np.concatenate([arr, pad], axis=0)
        return cls(elems, num_vars, elems.encode(arr))

    @classmethod
    def from_evaluations_padded(cls, elems, num_vars, evals):
        """from_evaluations_vec_padded (dense.rs:79-89): zero-pad a short
        input, truncate a long one, to exactly 2^num_vars evaluations."""
        n = 1 << num_vars
        if evals.shape[0] > n:
            evals = evals[:n]
        elif evals.shape[0] < n:
            pad = elems.zeros((n - evals.shape[0],)).to(evals.device)
            evals = torch.cat([evals, pad], dim=0)
        return cls(elems, num_vars, evals)

    @classmethod
    def rand(cls, elems, num_vars, rng):
        """Uniform evaluations from the numpy Generator ``rng``."""
        return cls(elems, num_vars, elems.rand((1 << num_vars,), rng))

    @classmethod
    def from_matrix(cls, elems, sparse_mat):
        """MLE of a SparseMatrix, row-major with power-of-two padding
        (dense.rs:117-135): index padded_cols*row + col, num_vars the
        sum of the two padded sizes' logs; entries in one cell add."""
        pr, pc = _pow2(sparse_mat.nrows), _pow2(sparse_mat.ncols)
        ids = sparse_mat.rows.long() * pc + sparse_mat.cols.long()
        nv = pr.bit_length() + pc.bit_length() - 2
        return cls(elems, nv, elems.f.segment_sum(sparse_mat.data, ids,
                                                  pr * pc))

    # -- trait surface (mle/mod.rs:23-76) --------------------------------
    def to_evaluations(self):
        return self.evals

    def decode(self):
        return self.e.decode(self.evals)

    # -- point indexing (dense.rs:397-418) -------------------------------
    def index(self, i: int):
        """``Index<usize>``: an index beyond the table reads zero."""
        if 0 <= i < self.evals.shape[0]:
            return self.evals[i]
        return self.e.zeros(()).to(self.evals.device)

    def set_index(self, i: int, v):
        """``IndexMut<usize>``, functional: a new MLE with evaluation ``i``
        replaced; an index beyond 2^num_vars raises, as the reference
        panics."""
        if not 0 <= i < (1 << self.num_vars):
            raise IndexError("index beyond elen")
        evals = self.evals.clone()
        evals[i] = v
        return DenseMLE(self.e, self.num_vars, evals)

    def fix_variables(self, points):
        """Bind the first len(points) variables, variable 0 first
        (dense.rs:171-199): pairs of adjacent entries."""
        ev = self.evals
        for r in points:
            ev = _lerp(self.e, ev[0::2], ev[1::2], r)
        return DenseMLE(self.e, self.num_vars - len(points), ev)

    def evaluate(self, points):
        if len(points) != self.num_vars:
            raise ValueError(f"evaluate: {len(points)} points for "
                             f"{self.num_vars} variables")
        return self.fix_variables(points).evals[0]

    def fix_last_variables(self, points):
        """Bind the LAST len(points) variables, var nv-1 with points[-1]
        first (multilinear_polynomial.rs:227-286): top and bottom halves."""
        ev = self.evals
        for r in reversed(list(points)):
            half = ev.shape[0] // 2
            ev = _lerp(self.e, ev[:half], ev[half:], r)
        return DenseMLE(self.e, self.num_vars - len(points), ev)

    def relabel(self, a: int, b: int, k: int):
        """Swap variable windows [a,a+k) and [b,b+k) (dense.rs:137-153)."""
        if a > b:
            a, b = b, a
        if a == b or k == 0:
            return self
        if b + k > self.num_vars:
            raise ValueError("invalid relabel argument")
        if a + k > b:
            raise ValueError("overlapped swap window is not allowed")
        nv = self.num_vars
        ev = self.evals
        elem_nd = ev.dim() - 1
        # view as [2]*nv (axis j = bit nv-1-j, C order) + element axes
        view = ev.reshape((2,) * nv + tuple(ev.shape[1:]))
        perm = list(range(nv + elem_nd))
        for t in range(k):
            ax_a = nv - 1 - (a + t)
            ax_b = nv - 1 - (b + t)
            perm[ax_a], perm[ax_b] = perm[ax_b], perm[ax_a]
        return DenseMLE(self.e, nv, view.permute(perm).reshape(ev.shape))

    # -- arithmetic (dense.rs:227-395) -----------------------------------
    def _same_vars(self, other):
        if self.num_vars != other.num_vars:
            raise ValueError(f"num_vars differ: {self.num_vars} vs "
                             f"{other.num_vars}")

    def add(self, other):
        self._same_vars(other)
        return DenseMLE(self.e, self.num_vars,
                        self.e.add(self.evals, other.evals))

    def sub(self, other):
        self._same_vars(other)
        return DenseMLE(self.e, self.num_vars,
                        self.e.sub(self.evals, other.evals))

    def neg(self):
        return DenseMLE(self.e, self.num_vars, self.e.neg(self.evals))

    def scalar_mul(self, r):
        return DenseMLE(self.e, self.num_vars, self.e.mul(self.evals, r))

    def scalar_add(self, r):
        return DenseMLE(self.e, self.num_vars, self.e.add(self.evals, r))

    def axpy(self, r, other):
        """self + r*other (AddAssign<(R, &Self)>, dense.rs:288-317)."""
        self._same_vars(other)
        return DenseMLE(self.e, self.num_vars,
                        self.e.add(self.evals, self.e.mul(r, other.evals)))
