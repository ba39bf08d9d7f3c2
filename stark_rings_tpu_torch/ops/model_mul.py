"""Batch-trailing ("transposed") model-CRT multiply (counterpart of
``stark_rings_tpu/ops/model_mul.py``).

The ring models' default layout is batch-leading: a vector of elements
is ``[B, D]``.  The digit-GEMM cores (``ops/mxu_dense.py``) compute on
``[C, B]`` (batch-trailing) data, and the batch-leading wrappers
transpose on the way in and out.  :class:`TModelMul` keeps the whole
multiply in the ``[D, B]`` layout: the CRT and ICRT GEMMs feed the slot
product directly, every elementwise op has the batch minor-most, and a
chain of multiplies (the folding prover's shape) pays the layout
transposes once, at entry and exit.

Semantics equal ``ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))``,
the reference pipeline crt -> slot-wise extension product -> icrt
(crt.rs:52-77, ntt_form.rs:159-189).  On the card each CRT and ICRT is
one ``torch._int_mm`` and one fold kernel: K3 (``fold_end``) for
goldilocks, K4's ``bb_fold_end`` for babybear, S3 (``limb_fold``) for
stark_prime; frog folds in torch ops.  A ``mul_t`` is three of them.
stark_prime's limb axis trails ([D, *batch, 8]), and its slot product
(E = 1) is the field's Montgomery product, kernel S1 on the card.
"""

from __future__ import annotations

import torch

from ..utils.trace import trace_span
from .mxu_dense import apply_cols

__all__ = ["TModelMul"]


class TModelMul:
    """Fused model multiply in the batch-trailing layout.

    ``to_t(x)``: storage ``[*batch, D(, L)]`` -> ``[D, *batch(, L)]``;
    ``mul_t`` maps two transposed coefficient-form operands to their
    transposed coefficient-form product.  All four models."""

    def __init__(self, ring):
        self.ring = ring
        self.f = ring.field
        self._crt, self._icrt = ring._dense_crt
        if ring.E > 1:
            perm, inv_perm, idx, fac = ring._ext_tables
            self._perm, self._inv_perm = perm, inv_perm
            self._idx_flat = idx.reshape(-1)
            self._fac = fac               # [E, E] storage

    # -- layout ----------------------------------------------------------
    def to_t(self, x):
        """[*batch, D(, L)] -> [D, *batch(, L)] (a view; batch shape
        preserved)."""
        return torch.movedim(x, self.f.coeff_axis, 0)

    def from_t(self, xt):
        """[D, *batch(, L)] -> [*batch, D(, L)] (a view)."""
        return torch.movedim(xt, 0, self.f.coeff_axis)

    # -- stages ----------------------------------------------------------
    def consts(self) -> dict:
        """The digit tables as numpy arrays, as ``ring.mul_consts()``;
        ``ops.mxu2.from_jax_consts`` gives the device tables ``c``."""
        return self.ring.mul_consts()

    def _apply_t(self, m, xt, c, key):
        """m @ xt in the batch-trailing layout: [C, *batch(, L)] ->
        [R, *batch(, L)].  Batch axes beyond the first are flattened for
        the GEMM and restored."""
        w, corr = (m.w, m.w_corr) if c is None else (c[key],
                                                     c.get(key + "_corr"))
        y = apply_cols(m.core, xt.reshape((m.C, -1) + self.f.limb_shape), w,
                       corr)
        return y.reshape((m.R,) + tuple(xt.shape[1:]))

    def crt_t(self, xt, c=None):
        """coeff [D, *batch] -> NTT form [D, *batch]."""
        with trace_span("model.crt"):
            return self._apply_t(self._crt, xt, c, "crt")

    def icrt_t(self, yt, c=None):
        with trace_span("model.icrt"):
            return self._apply_t(self._icrt, yt, c, "icrt")

    def _slot_product(self, a, b):
        """The extension-field product of slot tensors a [N, E, *ba] and
        b [N, E, *bb] (broadcast-compatible batches) -> [N*E, *batch]."""
        f = self.f
        N, E = self.ring.N, self.ring.E
        with trace_span("model.slot_product"):
            a_deg = a[:, self._perm]
            b_deg = b[:, self._perm]
            # bg[n, i, k, ...] = b_deg[n, (k-i) % E, ...]
            bg = b_deg[:, self._idx_flat].reshape((N, E, E) + b.shape[2:])
            fac = self._fac.reshape((1, E, E) + (1,) * (b.dim() - 2))
            prod = f.mul(a_deg[:, :, None], f.mul(fac, bg))
            c = f.sum(prod, axis=1)[:, self._inv_perm]  # sum over i
            return c.reshape((N * E,) + c.shape[2:])

    def ntt_mul_t(self, at, bt):
        """Slot-wise extension product in the batch-trailing layout
        (ring.ntt_mul's math, ntt_form.rs:159-189); the operands are
        [D, *batch] of one batch shape."""
        N, E = self.ring.N, self.ring.E
        if E == 1:
            return self.f.mul(at, bt)
        B = at[0].numel()
        out = self._slot_product(at.reshape(N, E, B), bt.reshape(N, E, B))
        return out.reshape(at.shape)

    def ntt_mul_bt(self, at, bt):
        """ntt_mul_t with broadcastable batch shapes: ``at [D, *ba]``,
        ``bt [D, *bb]`` (right-aligned) -> ``[D, *broadcast(ba, bb)]``."""
        N, E = self.ring.N, self.ring.E
        if E == 1:
            return self.f.mul(at, bt)
        return self._slot_product(at.reshape((N, E) + at.shape[1:]),
                                   bt.reshape((N, E) + bt.shape[1:]))

    def matvec_t(self, At, xt, block: int | None = None):
        """NTT-form mat-vec in the transposed layout.

        ``At [D, n, m(, L)]`` (a matrix of NTT-form ring elements), ``xt
        [D, m(, L)]`` or ``[D, W, m(, L)]`` (batched vectors) -> ``[D, n]``
        / ``[D, W, n]`` (``(, L)``: stark_prime's limbs): c[i] = sum_j
        A[i, j] * x[j] (the reference's checked_mul_vec over RqNTT,
        matrix.rs:148-188).  The contraction axis is placed major.

        ``block``: contraction-blocked exact accumulation; only
        [D, block, W, n] slot products are live at a time, each block is
        widened to base-2^32 words and summed with integer adds (exact:
        words below 2^32, far fewer than 2^32 addends), and one fold mod
        q ends it.  Bit-equal to the unblocked path."""
        f = self.f
        if xt.dim() == 2 + len(f.limb_shape):
            return self.matvec_t(At, xt[:, None], block=block)[:, 0]
        m = At.shape[2]
        Am = At.transpose(1, 2)                       # [D, m, n(, L)]
        xm = xt.transpose(1, 2)                       # [D, m, W(, L)]
        if block is None or block >= m:
            prod = self.ntt_mul_bt(Am[:, :, None, :],        # [D, m, 1, n]
                                   xm[:, :, :, None])        # [D, m, W, 1]
            return f.sum(prod, axis=1)                # [D, W, n]
        acc = None
        for s in range(0, m, block):
            prod = self.ntt_mul_bt(Am[:, s:s + block, None, :],
                                   xm[:, s:s + block, :, None])
            w = f.widen(prod).sum(dim=1)              # [D, W, n, words]
            acc = w if acc is None else acc + w
        return f.reduce_words(acc)

    def mul_t(self, at, bt, c=None):
        """Transposed coefficient-form product: icrt(crt(a) *slot crt(b))."""
        with trace_span("model.mul_t"):
            return self.icrt_t(self.ntt_mul_t(self.crt_t(at, c),
                                              self.crt_t(bt, c)), c)

    def precompute_t(self, bt, c=None):
        """The cached state of a fixed operand for mul_cached_t: its NTT
        form, computed once (one of a multiply's two CRT GEMMs saved)."""
        return self.crt_t(bt, c)

    def mul_cached_t(self, at, fbt, c=None):
        """Fixed-operand transposed multiply; fbt broadcasts over at's
        batch (the batch-1 challenge)."""
        return self.icrt_t(self.ntt_mul_bt(self.crt_t(at, c), fbt), c)

    def square_t(self, at, c=None):
        """a*a with one CRT GEMM."""
        fa = self.crt_t(at, c)
        return self.icrt_t(self.ntt_mul_t(fa, fa), c)

    # -- batch-leading convenience (pays both transposes) -----------------
    def mul(self, a, b, c=None):
        return self.from_t(self.mul_t(self.to_t(a), self.to_t(b), c))
