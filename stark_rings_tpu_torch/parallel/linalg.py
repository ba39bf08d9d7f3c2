"""Sharded ring linear algebra: mat-vecs over a mesh of shards
(counterpart of ``stark_rings_tpu/parallel/linalg.py``).

The dense and sparse mat-vecs of :mod:`..linalg` scale out by sharding
the contraction: each shard multiplies its block of terms and sums the
products as widened base-2^32 words (``Field.widen``), the partial word
sums meet in one exact :func:`~.collectives.psum_words`, and one
``reduce_words`` folds the total mod q (the reference's rayon row
loops, sparse_matrix.rs:202-217, across shards).  Everything is torch
ops on the shards' devices; a ring product is ``RingModel.ntt_mul``,
the field products of stark_prime kernel S1 on the card.
"""

from __future__ import annotations

import torch

from .collectives import psum_words
from .mesh import check_shards, replicate, ring_on, shard

__all__ = ["ShardedMatVec", "ShardedSparseMatVec"]


def _elems_on(e, dev):
    """The element adapter ``e`` with its ring's tables on ``dev`` (a
    field adapter's products run on their operands' device)."""
    ring = getattr(e, "ring", None)
    if ring is None:
        return e
    on = ring_on(ring, dev)
    return e if on is ring else type(e)(on)


class ShardedMatVec:
    """Column-sharded dense mat-vec.

    A: [n, m] + elem, its columns sharded (shard p: ``[n, m/P] + elem``);
    v: [m] + elem, sharded alike (``[m/P] + elem``).  The result
    ``[n] + elem`` is one tensor on the mesh's first device."""

    def __init__(self, elems, mesh, axis: str = "x"):
        self.e = elems
        self.mesh = mesh
        self.axis = axis

    def specs(self):
        """(A's, v's, the result's): per axis, the mesh axis it is split
        over or None."""
        tail = (None,) * self.e.elem_ndim
        return ((None, self.axis) + tail, (self.axis,) + tail,
                (None,) + tail)

    def shard(self, A, v, mesh=None):
        """A ``[n, m] + elem`` and v ``[m] + elem`` (numpy storage or
        tensors) -> their shard lists."""
        mesh = mesh or self.mesh
        return (shard(A, mesh, 1, self.e.f), shard(v, mesh, 0, self.e.f))

    def make_matvec_fn(self):
        """(A shards, v shards) -> A @ v on the mesh's first device."""
        f, mesh = self.e.f, self.mesh

        def call(A, v):
            A = check_shards(mesh, A, f.dtype, "A")
            v = check_shards(mesh, v, f.dtype, "v")
            words = []
            for a_blk, v_blk in zip(A, v):
                prod = _elems_on(self.e, a_blk.device).mul(a_blk, v_blk[None])
                words.append(f.widen(prod).sum(dim=1))  # [n, ..., W]
            return f.reduce_words(psum_words(words))
        return call


class ShardedSparseMatVec:
    """nnz-sharded sparse mat-vec (sparse_matrix.rs:202-217 across
    shards).

    The COO entries are sharded: each shard gathers v at its columns,
    multiplies by its data, and adds the widened words into a
    full-height ``[nrows]`` partial with one int64 ``index_add_``; the
    partials meet in one exact :func:`~.collectives.psum_words`.
    Sharding the entries (not the rows) keeps the shards' work equal
    under any sparsity pattern.  v is replicated (one tensor, copied to
    each shard device), the result one tensor on the mesh's first
    device.

    The reference caches its compiled function per ``nrows`` to save a
    compile a call; here a call builds nothing, so there is no cache."""

    def __init__(self, elems, mesh, axis: str = "x"):
        self.e = elems
        self.mesh = mesh
        self.axis = axis

    def shard(self, smat, mesh=None):
        """A ``SparseMatrix``'s COO arrays padded to a multiple of the
        mesh size and split: (data, rows, cols) shard lists.  Padding
        entries carry zero data at row and column 0: they add zero words
        to row 0, which is exact."""
        mesh = mesh or self.mesh
        pad = (-smat.nnz) % mesh.size
        data, rows, cols = smat.data, smat.rows, smat.cols
        if pad:
            data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
            rows = torch.cat([rows, rows.new_zeros(pad)])
            cols = torch.cat([cols, cols.new_zeros(pad)])
        return tuple(shard(x, mesh) for x in (data, rows, cols))

    def make_matvec_fn(self, nrows: int):
        """(data shards, int32 rows shards, int32 cols shards, v) ->
        A @ v ``[nrows] + elem`` on the mesh's first device."""
        f, mesh = self.e.f, self.mesh
        nrows = int(nrows)

        def call(data, rows, cols, v):
            data = check_shards(mesh, data, f.dtype, "data")
            idx = [check_shards(mesh, x, torch.int32, what)
                   for x, what in ((rows, "rows"), (cols, "cols"))]
            vs = replicate(v, mesh)
            words = []
            for d_blk, r_blk, c_blk in zip(data, *idx):
                dev = d_blk.device
                prod = _elems_on(self.e, dev).mul(
                    d_blk, vs[dev].index_select(0, c_blk))
                w = f.widen(prod)                    # [nnz/P, ..., W]
                acc = torch.zeros((nrows,) + tuple(w.shape[1:]),
                                  dtype=torch.int64, device=dev)
                words.append(acc.index_add_(0, r_blk, w))
            return f.reduce_words(psum_words(words))
        return call

    def mul_vec(self, smat, v):
        """One-shot sharded ``smat @ v``, checked as ``mul_vec`` is:
        raises AlgebraError on a dimension mismatch."""
        if v.shape[0] != smat.ncols:
            from ..linalg import AlgebraError

            raise AlgebraError(
                f"DifferentLengths: ncols={smat.ncols}, len(v)={v.shape[0]}")
        return self.make_matvec_fn(smat.nrows)(*self.shard(smat), v)
