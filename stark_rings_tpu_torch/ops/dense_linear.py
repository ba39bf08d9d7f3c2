"""Dense constant modular matrices: the small-D CRT/ICRT as one map
(counterpart of ``stark_rings_tpu/ops/dense_linear.py``).

The reference's per-model CRT kernels are chains of butterfly layers and
slot isomorphisms (goldilocks/ntt.rs:68-127, babybear/ntt.rs:143-317).
The whole chain is one Fq-linear map, so probing the integer spec with
basis vectors once gives its D x D matrix.  :class:`DenseModMat` applies
such a matrix with plain field products and a modular sum; the ring
models apply the same matrices as one digit GEMM (:mod:`.mxu_dense`).

Montgomery storage commutes with Fq-linear maps (y*R = M @ (x*R) mod q),
so the encoded matrix applies directly to storage values.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..device import get_device

__all__ = ["DenseModMat", "probe_dense_matrix"]


def probe_dense_matrix(fn: Callable[[Sequence[int]], Sequence[int]],
                       d_in: int, d_out: int, q: int) -> np.ndarray:
    """Probe a linear function on int lists with basis vectors.

    Returns the [d_out, d_in] object-int matrix M with fn(x) = M @ x."""
    m = np.zeros((d_out, d_in), dtype=object)
    for j in range(d_in):
        e = [0] * d_in
        e[j] = 1
        col = fn(e)
        for i in range(d_out):
            m[i, j] = col[i] % q
    return m


class DenseModMat:
    """Constant [R, C] matrix over Fq applied along the coefficient axis:
    ``x`` [..., C(, L)] storage -> [..., R(, L)] storage, on ``device``
    (the limb axis L of stark_prime trails)."""

    def __init__(self, field, m_ints, device="cuda"):
        self.f = field
        m = np.asarray(m_ints, dtype=object)
        self.R, self.C = m.shape
        self.m = field.encode(m, get_device(device))     # storage [R, C]

    def __call__(self, x):
        f = self.f
        if f.limbed:
            return f.sum(f.mul(self.m, x[..., None, :, :]), axis=-2)
        return f.sum(f.mul(self.m, x[..., None, :]), axis=-1)
