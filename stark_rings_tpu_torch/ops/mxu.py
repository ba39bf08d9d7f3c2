"""Exact Goldilocks matrix products on 7-bit digits, and the deg-2^14
four-step NTT built on them (counterpart of ``stark_rings_tpu/ops/mxu.py``).

* :class:`MxuModMat`: y = M x (mod q) for a constant [R, C] matrix M and
  data x u64 [C, cols].  M and x are cut into ten 7-bit digits held in
  int8 (every digit in [0, 127], so int8 takes them as they are); the
  10 x 10 digit products summed by exponent s = k + l give 19 int32
  buckets, exact because C * 127^2 * 10 < 2^31; the buckets are
  carry-packed into base-2^32 words and folded mod q with 2^64 = 2^32 - 1,
  2^96 = -1, 2^128 = -2^32, 2^192 = 1.  The reference takes the digit
  products as an XLA einsum outside any kernel; here they are one
  ``torch._int_mm`` of the stacked weights [19R, 10C] (bucket row-block s
  holds W_{s-l} at column block l) against the stacked digit planes
  [10C, cols], which gives the buckets directly.  The fold is plain torch,
  as it is XLA in the reference.
* :class:`MatmulNTT`: the negacyclic NTT of size 128 x 128 as two such
  levels (twist, column NTTs as one product, twiddle, transpose, row NTTs
  as one product), in ``NTTContext``'s leaf order: its outputs and inputs
  are interchangeable with the radix engines'.

The tables are built on the host from Python ints as the reference builds
them.  ``ops/mxu_fused.py`` holds the hand-written kernel that computes
``MxuModMat.apply`` in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, to_torch
from ..fields.field import GOLDILOCKS, MASK32, shr, u64_lt
from .mxu2 import _mm
from .ntt import NTTContext, find_primitive_root

__all__ = ["MxuModMat", "MatmulNTT", "DIGITS", "DBITS", "NBUCKETS",
           "digit_planes", "stacked_weights", "data_digits", "fold_buckets",
           "check_bound"]

F = GOLDILOCKS
_Q = F.q
DIGITS = 10          # ceil(64 / 7)
DBITS = 7
NBUCKETS = 2 * DIGITS - 1
_DMASK = (1 << DBITS) - 1


def digit_planes(m_ints) -> np.ndarray:
    """[R, C] ints (reduced mod q) -> int8 [DIGITS, R, C] of 7-bit digits
    (the reference's ``MxuModMat.planes``)."""
    m = np.asarray(m_ints, dtype=object)
    v = F.storage_np(m)
    return np.stack([((v >> np.uint64(DBITS * k)) & np.uint64(_DMASK))
                     .astype(np.int8) for k in range(DIGITS)])


def stacked_weights(planes: np.ndarray) -> np.ndarray:
    """int8 [DIGITS, R, C] -> int8 [NBUCKETS*R, DIGITS*C]: row block s,
    column block l holds plane s - l (zero where s - l is no digit); the
    reference's ``MxuModMatPallas.big_planes``."""
    _, R, C = planes.shape
    big = np.zeros((NBUCKETS * R, DIGITS * C), dtype=np.int8)
    for s in range(NBUCKETS):
        for l in range(DIGITS):
            if 0 <= s - l < DIGITS:
                big[s * R:(s + 1) * R, l * C:(l + 1) * C] = planes[s - l]
    return big


def check_bound(C: int) -> None:
    """The int32 bucket bound C * 127^2 * 10 < 2^31."""
    if C * 127 * 127 * DIGITS >= 2**31:
        raise ValueError(f"C={C}: C * 127^2 * {DIGITS} >= 2^31, the int32 "
                         "buckets could overflow")


def data_digits(x: torch.Tensor) -> torch.Tensor:
    """u64 [C, cols] -> int8 [DIGITS, C, cols] of 7-bit digits."""
    return torch.stack([(shr(x, DBITS * k) if k else x) & _DMASK
                        for k in range(DIGITS)]).to(torch.int8)


def _canon(x):
    """Any u64 -> canonical (one conditional subtract: 2^64 < 2q)."""
    return torch.where(u64_lt(x, F._Q), x, x - F._Q)


def fold_buckets(V: torch.Tensor) -> torch.Tensor:
    """int32 buckets [NBUCKETS, ...] (non-negative) -> canonical u64:
    sum_s V_s 2^(7s) mod q (the reference's ``_fold_buckets``)."""
    n_words = (DBITS * (NBUCKETS - 1) + 31 + 32) // 32 + 1
    zero = torch.zeros(V.shape[1:], dtype=torch.int64, device=V.device)
    words = [zero] * n_words
    for s in range(NBUCKETS):
        j, sh = (DBITS * s) >> 5, (DBITS * s) & 31
        contrib = V[s].to(torch.int64) << sh           # < 2^62
        words[j] = words[j] + (contrib & MASK32)
        words[j + 1] = words[j + 1] + shr(contrib, 32)
    digits, carry = [], zero
    for w in words:
        t = w + carry
        digits.append(t & MASK32)
        carry = shr(t, 32)
    digits.append(carry)
    d = digits + [zero] * (7 - len(digits))
    A = d[0] | (d[1] << 32)
    B = d[2] | (d[3] << 32)
    C = d[4] | (d[5] << 32)
    # A + B (2^32 - 1) - C 2^32 + d6  (mod q)
    b32 = F._reduce128(shr(B, 32), B << 32)
    c32 = F._reduce128(shr(C, 32), C << 32)
    acc = F.add(_canon(A), F.sub(b32, _canon(B)))
    acc = F.sub(acc, c32)
    return F.add(acc, _canon(d[6]))


class MxuModMat:
    """Exact y = M x (mod q), M a constant [R, C] Goldilocks matrix, x
    u64 [C, cols], on ``device``.  ``planes`` (int8 [DIGITS, R, C]) and
    ``big`` (the stacked weights) are numpy, byte-equal to the
    reference's."""

    def __init__(self, m_ints, device="cuda"):
        self.device = get_device(device)
        self.planes = digit_planes(m_ints)
        _, self.R, self.C = self.planes.shape
        check_bound(self.C)
        self.big = stacked_weights(self.planes)
        self._w = torch.from_numpy(self.big).to(self.device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x u64 [C, cols] -> u64 [R, cols]."""
        C, cols = x.shape
        if C != self.C:
            raise ValueError(f"apply: x has {C} rows, the matrix {self.C} "
                             "columns")
        V = _mm(self._w, data_digits(x).reshape(DIGITS * C, cols))
        return fold_buckets(V.view(NBUCKETS, self.R, cols))

    def matrix(self) -> np.ndarray:
        """M as an [R, C] object array of ints, from its digit planes."""
        return sum(p.astype(object) << (DBITS * k)
                   for k, p in enumerate(self.planes))


class MatmulNTT:
    """Negacyclic NTT of size N = 128 * 128 as two digit-product levels,
    each an :class:`MxuModMat`, in ``NTTContext(N)``'s leaf order."""

    N1 = 128

    def __init__(self, N: int = 128 * 128, device="cuda"):
        if N != self.N1 * self.N1:
            raise ValueError(f"MatmulNTT supports N = {self.N1 ** 2} only, "
                             f"got {N}")
        self.device = get_device(device)
        self.N, self.N2 = N, N // self.N1
        N1, N2, q = self.N1, self.N2, _Q
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        omega = pow(psi, 2, q)                       # order N
        k1 = [e // 2 for e in NTTContext(F, N1, False, "cpu").leaf_exps]
        k2 = [e // 2 for e in NTTContext(F, N2, False, "cpu").leaf_exps]
        om1 = pow(omega, N2, q)                      # order N1
        om2 = pow(omega, N1, q)                      # order N2
        W1 = [[pow(om1, ki * n1, q) for n1 in range(N1)] for ki in k1]
        W2 = [[pow(om2, kj * n2, q) for n2 in range(N2)] for kj in k2]
        n1_inv, n2_inv = pow(N1, q - 2, q), pow(N2, q - 2, q)
        W1i = [[pow(om1, (-kj * n1) % N1, q) * n1_inv % q for kj in k1]
               for n1 in range(N1)]
        W2i = [[pow(om2, (-kj * n2) % N2, q) * n2_inv % q for kj in k2]
               for n2 in range(N2)]
        self.col_mat = MxuModMat(W1, device=self.device)
        self.row_mat = MxuModMat(W2, device=self.device)
        self.col_mat_inv = MxuModMat(W1i, device=self.device)
        self.row_mat_inv = MxuModMat(W2i, device=self.device)
        psi_inv, om_inv = pow(psi, q - 2, q), pow(omega, q - 2, q)
        e = np.arange(N).reshape(N1, N2)             # n1 * N2 + n2
        self.twist = F.storage_np(_pows(psi, N)[e])
        self.twist_inv = F.storage_np(_pows(psi_inv, N)[e])
        ek = np.outer(k1, np.arange(N2)) % N         # ki * n2 (omega order N)
        self.twiddle = F.storage_np(_pows(omega, N)[ek])
        self.twiddle_inv = F.storage_np(_pows(om_inv, N)[ek])
        self._t = {k: to_torch(getattr(self, k), self.device)
                   for k in ("twist", "twist_inv", "twiddle", "twiddle_inv")}

    def forward(self, x):
        """x u64 [B, N] -> leaf-order evaluations [B, N]."""
        N1, N2 = self.N1, self.N2
        B = x.shape[0]
        m = F.mul(x.reshape(B, N1, N2), self._t["twist"][None])
        cols = m.permute(1, 2, 0).reshape(N1, N2 * B)
        a = self.col_mat.apply(cols).reshape(N1, N2, B)
        a = F.mul(a, self._t["twiddle"][:, :, None])
        rows = a.permute(1, 0, 2).reshape(N2, N1 * B)
        y = self.row_mat.apply(rows).reshape(N2, N1, B)
        return y.permute(2, 1, 0).reshape(B, self.N)

    def inverse(self, y):
        N1, N2 = self.N1, self.N2
        B = y.shape[0]
        rows = y.reshape(B, N1, N2).permute(2, 1, 0).reshape(N2, N1 * B)
        a = self.row_mat_inv.apply(rows).reshape(N2, N1, B).permute(1, 0, 2)
        a = F.mul(a, self._t["twiddle_inv"][:, :, None])
        m2 = self.col_mat_inv.apply(a.reshape(N1, N2 * B))
        m2 = m2.reshape(N1, N2, B).permute(2, 0, 1)
        return F.mul(m2, self._t["twist_inv"][None]).reshape(B, self.N)

    def mul(self, a, b):
        return self.inverse(F.mul(self.forward(a), self.forward(b)))


def _pows(base: int, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as an object array."""
    out = np.empty(n, dtype=object)
    v = 1
    for i in range(n):
        out[i] = v
        v = v * base % _Q
    return out
