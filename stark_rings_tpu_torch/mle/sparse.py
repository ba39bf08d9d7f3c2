"""Sparse multilinear extensions (counterpart of
``stark_rings_tpu/mle/sparse.py``; reference mle/sparse.rs:24-394).

Index and value tensors with a static nnz (``indices int64 [nnz]``,
``values [nnz]+elem``) on the adapter's device.  Duplicate indices are
allowed and add up ("sum of contributions"), which is the reference's
map semantics for every operation here.

* evaluate: sum_i v_i * eq(bits(idx_i), point), O(nnz * n) batched ops
  (the reference's windowed eq-table precomputation, sparse.rs:170-207,
  is a CPU cache optimization of the same sum).
* fix_variables(k points): each value times eq(its low k bits, points),
  the indices shifted right by k: it stays sparse with the same nnz.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linalg.sparse import _logical_shape
from .dense import DenseMLE, _pow2

__all__ = ["SparseMLE"]


class SparseMLE:
    def __init__(self, elems, num_vars: int, indices, values):
        self.e = elems
        self.num_vars = int(num_vars)
        self.indices = torch.as_tensor(indices, device=values.device).to(
            torch.int64)
        self.values = values

    @property
    def nnz(self):
        return self.indices.shape[0]

    # -- constructors (sparse.rs:33-131) ---------------------------------
    @classmethod
    def from_pairs(cls, elems, num_vars, pairs):
        """pairs: [(index, python-int element)] (from_evaluations)."""
        n = max(len(pairs), 1)
        idx = np.zeros(n, dtype=np.int64)
        vals = np.zeros((n,) + _logical_shape(elems), dtype=object)
        for i, (j, v) in enumerate(pairs):
            idx[i] = j
            vals[i] = v
        return cls(elems, num_vars, idx, elems.encode(vals))

    @classmethod
    def rand_with_config(cls, elems, num_vars, nnz,
                         rng: np.random.Generator):
        """nnz distinct random indices, sorted, with uniform values, from
        the numpy Generator ``rng`` (rand_with_config, sparse.rs:66-93)."""
        idx = np.sort(rng.choice(1 << num_vars, size=nnz, replace=False))
        return cls(elems, num_vars, idx.astype(np.int64),
                   elems.rand((nnz,), rng))

    @classmethod
    def from_matrix(cls, elems, sparse_mat):
        """SparseMatrix -> sparse MLE with power-of-two padding
        (sparse.rs from_matrix): index padded_cols*row + col."""
        pr, pc = _pow2(sparse_mat.nrows), _pow2(sparse_mat.ncols)
        nv = pr.bit_length() + pc.bit_length() - 2
        ids = sparse_mat.rows.long() * pc + sparse_mat.cols.long()
        return cls(elems, nv, ids, sparse_mat.data)

    # -- evaluation ------------------------------------------------------
    def _eq_factors(self, points, bit_offset: int):
        """prod_j (bit_j ? p_j : 1 - p_j) for each stored index."""
        e = self.e
        one = e.one()
        acc = None
        for j, p in enumerate(points):
            bit = (self.indices >> (bit_offset + j)) & 1
            cond = bit.bool().reshape((self.nnz,) + (1,) * p.dim())
            w = torch.where(cond, p[None], e.sub(one, p)[None])
            acc = w if acc is None else e.mul(acc, w)
        return acc

    def evaluate(self, points):
        if len(points) != self.num_vars:
            raise ValueError(f"evaluate: {len(points)} points for "
                             f"{self.num_vars} variables")
        if self.num_vars == 0:
            return self.e.f.sum(self.values, 0)
        prod = self.e.mul(self.values, self._eq_factors(points, 0))
        return self.e.f.sum(prod, 0)

    def fix_variables(self, points):
        """Bind the first k variables (sparse.rs:133-207)."""
        k = len(points)
        if k > self.num_vars:
            raise ValueError(f"fix_variables: {k} points for "
                             f"{self.num_vars} variables")
        if k == 0:
            return self
        vals = self.e.mul(self.values, self._eq_factors(points, 0))
        return SparseMLE(self.e, self.num_vars - k, self.indices >> k, vals)

    def fix_variables_windowed(self, points, window: int | None = None):
        """Windowed fix_variables (sparse.rs:170-207, 381-394): a 2^w eq
        table a window of w variables, built by doubling (2^w products
        shared by all entries), and one gather and product an entry a
        window.  Equal to :meth:`fix_variables`; it wins when
        nnz >> 2^w (the reference picks w = log2(nnz))."""
        k = len(points)
        if k > self.num_vars:
            raise ValueError(f"fix_variables_windowed: {k} points for "
                             f"{self.num_vars} variables")
        if k == 0:
            return self
        e = self.e
        if window is None:
            window = max(int(self.nnz).bit_length() - 1, 1)
        vals, idx, off = self.values, self.indices, 0
        while off < k:
            w = min(window, k - off)
            # table[t] = prod_j (bit_j(t) ? p_j : 1 - p_j)
            table = e.one()[None]
            for j in range(w):
                p = points[off + j]
                table = torch.cat([e.mul(table, e.sub(e.one(), p)[None]),
                                   e.mul(table, p[None])])
            low = (idx >> off) & ((1 << w) - 1)
            vals = e.mul(vals, table.index_select(0, low))
            off += w
        return SparseMLE(e, self.num_vars - k, idx >> k, vals)

    def index(self, i: int):
        """The stored element at hypercube index ``i``, zero if absent
        (the reference's Index impl, sparse.rs:348-366): a binary search
        of a sorted host copy of the indices, built once."""
        cache = getattr(self, "_index_cache", None)
        if cache is None:
            host = self.indices.cpu().numpy()
            order = np.argsort(host, kind="stable")
            cache = self._index_cache = (host[order], order)
        sorted_idx, order = cache
        lo = int(np.searchsorted(sorted_idx, i, side="left"))
        hi = int(np.searchsorted(sorted_idx, i, side="right"))
        if lo == hi:
            return self.e.zeros(_logical_shape(self.e)).to(
                self.values.device)
        acc = None
        for t in range(lo, hi):       # duplicates add (map semantics)
            v = self.values[int(order[t])]
            acc = v if acc is None else self.e.add(acc, v)
        return acc

    def relabel(self, a: int, b: int, k: int):
        """Swap the variable windows [a, a+k) and [b, b+k) (sparse.rs
        relabel): a permutation of the index bits."""
        if a > b:
            a, b = b, a
        if a == b or k == 0:
            return self
        if b + k > self.num_vars or a + k > b:
            raise ValueError(f"relabel: windows [{a}, {a + k}) and "
                             f"[{b}, {b + k}) of {self.num_vars} variables")
        idx = self.indices
        mask = (1 << k) - 1
        abits = (idx >> a) & mask
        bbits = (idx >> b) & mask
        cleared = idx & ~((mask << a) | (mask << b))
        return SparseMLE(self.e, self.num_vars,
                         cleared | (abits << b) | (bbits << a), self.values)

    # -- conversions -----------------------------------------------------
    def to_dense(self):
        v = self.e.f.segment_sum(self.values, self.indices,
                                 1 << self.num_vars)
        return DenseMLE(self.e, self.num_vars, v)

    def decode_dense(self):
        return self.to_dense().decode()

    # -- arithmetic (sparse.rs add/sub/neg/axpy) -------------------------
    def neg(self):
        return SparseMLE(self.e, self.num_vars, self.indices,
                         self.e.neg(self.values))

    def scalar_mul(self, r):
        return SparseMLE(self.e, self.num_vars, self.indices,
                         self.e.mul(self.values, r))

    def add(self, other):
        if self.num_vars != other.num_vars:
            raise ValueError(f"num_vars differ: {self.num_vars} vs "
                             f"{other.num_vars}")
        return SparseMLE(self.e, self.num_vars,
                         torch.cat([self.indices, other.indices]),
                         torch.cat([self.values, other.values]))

    def sub(self, other):
        return self.add(other.neg())
