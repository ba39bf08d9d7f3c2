"""Sparse matrix over ring elements (counterpart of
``stark_rings_tpu/linalg/sparse.py``; reference sparse_matrix.rs:18-307).

COO with a static nnz: ``data [nnz]+elem`` and ``rows`` / ``cols`` int32
[nnz] on the adapter's device.  Padding entries carry zero data (at row
and column 0), which every operation here adds as zero.

* mat-vec (sparse_matrix.rs:202-217): gather, one product, and the
  field's modular ``segment_sum`` (one int64 ``index_add_`` of widened
  words) over the rows.
* sparse x sparse (the reference's merge-join, :219-275): ``mul_sparse``
  joins A's column indices with B's row indices on the host (numpy),
  then runs one gather-multiply and one ``segment_sum`` over the matched
  term pairs: the result stays sparse, and the dense n*m accumulator is
  never built.

The index arrays are checked against the shape once, at construction:
``segment_sum`` and the gathers take them as they are.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SparseMatrix"]


def _logical_shape(elems) -> tuple:
    """The shape of one element before encoding: (D,) for ring adapters,
    () for field scalars (a limbed field's limbs come from encode)."""
    ring = getattr(elems, "ring", None)
    return (ring.D,) if ring is not None else ()


def _index(idx, n: int, what: str, device) -> torch.Tensor:
    """int32 indices on ``device``, each in [0, n)."""
    t = torch.as_tensor(idx, device=device).to(torch.int32)
    if t.numel() and (int(t.min()) < 0 or int(t.max()) >= max(n, 1)):
        raise ValueError(f"SparseMatrix: {what} index outside [0, {n})")
    return t


class SparseMatrix:
    def __init__(self, elems, nrows, ncols, data, rows, cols):
        self.e = elems
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.data = data
        self.rows = _index(rows, self.nrows, "row", data.device)
        self.cols = _index(cols, self.ncols, "column", data.device)
        if not self.rows.shape == self.cols.shape == (data.shape[0],):
            raise ValueError(f"SparseMatrix: {data.shape[0]} entries, "
                             f"{self.rows.shape[0]} rows and "
                             f"{self.cols.shape[0]} columns")

    @property
    def nnz(self):
        return self.data.shape[0]

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_entries(cls, elems, nrows, ncols, entries):
        """entries: list of (row, col, python-int element)."""
        n = max(len(entries), 1)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        vals = np.zeros((n,) + _logical_shape(elems), dtype=object)
        for i, (r, c, v) in enumerate(entries):
            rows[i], cols[i] = r, c
            vals[i] = v
        return cls(elems, nrows, ncols, elems.encode(vals), rows, cols)

    @classmethod
    def identity(cls, elems, n):
        one = elems.one()
        data = one.expand((n,) + tuple(one.shape)).contiguous()
        idx = np.arange(n, dtype=np.int32)
        return cls(elems, n, n, data, idx, idx)

    @classmethod
    def rand(cls, elems, nrows, ncols, sparsity, rng: np.random.Generator):
        """About a ``sparsity`` fraction of nonzero entries (sparse_matrix.rs
        rand), drawn from the numpy Generator ``rng``: a uniform draw a
        cell in row-major order, then the values."""
        rr, cc = np.nonzero(rng.random((nrows, ncols)) < sparsity)
        n = max(len(rr), 1)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        rows[:len(rr)], cols[:len(cc)] = rr, cc
        data = elems.rand((n,), rng)
        if not len(rr):
            data = torch.zeros_like(data)
        return cls(elems, nrows, ncols, data, rows, cols)

    @classmethod
    def from_dense(cls, elems, mat):
        """Dense Matrix -> COO over the entries whose storage is not all
        zero (zero is the all-zero word in every field's storage)."""
        vals = mat.vals
        n_, m_ = vals.shape[:2]
        nz = (vals.reshape(n_, m_, -1) != 0).any(-1)
        rr, cc = torch.nonzero(nz, as_tuple=True)
        data = torch.zeros((max(len(rr), 1),) + tuple(vals.shape[2:]),
                           dtype=vals.dtype, device=vals.device)
        data[:len(rr)] = vals[rr, cc]
        pad = torch.zeros(data.shape[0] - len(rr), dtype=rr.dtype,
                          device=rr.device)
        return cls(elems, mat.nrows, mat.ncols, data, torch.cat([rr, pad]),
                   torch.cat([cc, pad]))

    # -- conversions -----------------------------------------------------
    def to_dense(self):
        from .matrix import Matrix

        flat = self.rows.long() * self.ncols + self.cols.long()
        dense = self.e.f.segment_sum(self.data, flat,
                                     self.nrows * self.ncols)
        return Matrix(self.e, dense.reshape((self.nrows, self.ncols)
                                            + tuple(dense.shape[1:])))

    def decode_dense(self):
        return self.to_dense().decode()

    # -- structural ------------------------------------------------------
    def hconcat(self, other):
        if self.nrows != other.nrows:
            raise ValueError(f"hconcat: {self.nrows} and {other.nrows} rows")
        return SparseMatrix(
            self.e, self.nrows, self.ncols + other.ncols,
            torch.cat([self.data, other.data]),
            torch.cat([self.rows, other.rows]),
            torch.cat([self.cols, other.cols + self.ncols]))

    def vconcat(self, other):
        if self.ncols != other.ncols:
            raise ValueError(f"vconcat: {self.ncols} and {other.ncols} "
                             "columns")
        return SparseMatrix(
            self.e, self.nrows + other.nrows, self.ncols,
            torch.cat([self.data, other.data]),
            torch.cat([self.rows, other.rows + self.nrows]),
            torch.cat([self.cols, other.cols]))

    def pad(self, nrows, ncols):
        if nrows < self.nrows or ncols < self.ncols:
            raise ValueError(f"pad: {nrows} x {ncols} is smaller than "
                             f"{self.nrows} x {self.ncols}")
        return SparseMatrix(self.e, nrows, ncols, self.data, self.rows,
                            self.cols)

    def transpose(self):
        return SparseMatrix(self.e, self.ncols, self.nrows, self.data,
                            self.cols, self.rows)

    def scalar_mul(self, s):
        return SparseMatrix(self.e, self.nrows, self.ncols,
                            self.e.mul(self.data, s), self.rows, self.cols)

    # -- arithmetic ------------------------------------------------------
    def mul_vec(self, v):
        """checked_mul_vec (sparse_matrix.rs:202-217): gather, multiply,
        segment-sum over the rows.  Raises AlgebraError on a dimension
        mismatch."""
        if v.shape[0] != self.ncols:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: ncols={self.ncols}, len(v)={v.shape[0]}")
        prod = self.e.mul(self.data, v.index_select(0, self.cols))
        return self.e.f.segment_sum(prod, self.rows, self.nrows)

    def mul_dense(self, mat_vals):
        """sparse [n, k] @ dense [k, m]+e -> dense [n, m]+e."""
        bg = mat_vals.index_select(0, self.cols)            # [nnz, m]+e
        prod = self.e.mul(self.data[:, None], bg)
        return self.e.f.segment_sum(prod, self.rows, self.nrows)

    # -- gadget decomposition (balanced_decomposition/mod.rs:311-352) ----
    def gadget_decompose(self, b: int, k: int):
        """n x m -> n x (k*m): entry (r, c, v) expands to the k entries
        (r, c*k + j, digit_j(v)); zero digits keep the static nnz*k
        layout (the reference's retain() is a CPU memory optimization)."""
        from ..decomp import decompose, decompose_ring

        ringlike = getattr(self.e, "ring", None) is not None
        dig = (decompose_ring if ringlike else decompose)(
            self.e.f, self.data, b, k)                      # [nnz, k, ...]
        data = dig.reshape((self.nnz * k,) + tuple(dig.shape[2:]))
        rows = self.rows.repeat_interleave(k)
        cols = (self.cols[:, None] * k + torch.arange(
            k, dtype=torch.int32, device=self.cols.device)).reshape(-1)
        return SparseMatrix(self.e, self.nrows, self.ncols * k, data,
                            rows, cols)

    def gadget_recompose(self, b: int, k: int):
        """n x (k*m) -> n x m: entry (r, c, v) becomes (r, c // k,
        v * b^(c mod k)); entries that meet in one cell add."""
        f = self.e.f
        pows = f.encode(np.array([pow(b, j, f.q) for j in range(k)],
                                 dtype=object), self.data.device)
        scale = pows.index_select(0, self.cols.long() % k)  # [nnz(, L)]
        if getattr(self.e, "ring", None) is not None:
            scale = scale.unsqueeze(1)   # over the D axis
        return SparseMatrix(self.e, self.nrows, self.ncols // k,
                            f.mul(self.data, scale), self.rows,
                            torch.div(self.cols, k, rounding_mode="floor"))

    def mul_sparse(self, other):
        """sparse x sparse with a sparse result (sparse_matrix.rs:219-275).

        The merge-join becomes a vectorized host equi-join of A's column
        indices with B's row indices (searchsorted over B's sorted rows;
        O((nnz_a + nnz_b) log nnz_b + matches)), then one gather-multiply
        and one modular segment-sum over the matched term pairs on the
        device.  The result has one entry per distinct (row, col) cell
        touched.  Cells whose sum is zero are kept (static shapes); the
        reference drops them, which to_dense cannot tell apart."""
        if self.ncols != other.nrows:
            from . import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: {self.ncols} vs {other.nrows}")
        ra = self.rows.cpu().numpy().astype(np.int64)
        ka = self.cols.cpu().numpy().astype(np.int64)
        kb = other.rows.cpu().numpy().astype(np.int64)
        cb = other.cols.cpu().numpy().astype(np.int64)
        order = np.argsort(kb, kind="stable")
        kb_sorted = kb[order]
        starts = np.searchsorted(kb_sorted, ka, side="left")
        counts = np.searchsorted(kb_sorted, ka, side="right") - starts
        total = int(counts.sum())
        if total == 0:      # the empty product: one zero padding entry
            data = torch.zeros((1,) + tuple(self.data.shape[1:]),
                               dtype=self.data.dtype,
                               device=self.data.device)
            return SparseMatrix(self.e, self.nrows, other.ncols, data,
                                np.zeros(1, np.int32), np.zeros(1, np.int32))
        ia = np.repeat(np.arange(len(ra), dtype=np.int64), counts)
        # offsets inside each group: a global arange less its start
        grp_start = np.repeat(np.cumsum(counts) - counts, counts)
        ib = order[np.repeat(starts, counts)
                   + (np.arange(total, dtype=np.int64) - grp_start)]
        keys = ra[ia] * np.int64(other.ncols) + cb[ib]
        uniq, seg = np.unique(keys, return_inverse=True)
        dev = self.data.device
        prod = self.e.mul(
            self.data.index_select(0, torch.as_tensor(ia, device=dev)),
            other.data.index_select(0, torch.as_tensor(ib, device=dev)))
        out = self.e.f.segment_sum(prod, seg.reshape(-1), len(uniq))
        return SparseMatrix(self.e, self.nrows, other.ncols, out,
                            (uniq // other.ncols).astype(np.int32),
                            (uniq % other.ncols).astype(np.int32))
