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
(E = 1) is the field's Montgomery product, kernel S1 on the card, under
the same ``model.slot_product`` span as the other models' products.  The
Goldilocks model's slot products (E = 3) are the kernels of
``ops/slot.py`` on the card: one ``slot_mul`` a product, one
``slot_matvec`` a ``matvec_t``; the BabyBear model's (E = 9) those of
``ops/slot_bb.py``, ``bb_slot_mul`` and ``bb_slot_matvec``; the other
models' run in torch ops (``slot.ext_mul``).
"""

from __future__ import annotations

import math

import torch

from ..utils.trace import trace_span
from .mxu_dense import apply_cols
from .slot import (ext_matvec, ext_mul, ext_tables, slot_kernel_applies,
                   slot_matvec, slot_mul)
from .slot_bb import bb_slot_kernel_applies, bb_slot_matvec, bb_slot_mul

__all__ = ["TModelMul"]


def _broadcast(sa: tuple, sb: tuple) -> tuple:
    """The broadcast of two batch shapes, right-aligned.  (The first
    ``torch.broadcast_shapes`` of a process imports sympy and torch's
    symbolic shapes: seconds of set-up.)"""
    n = max(len(sa), len(sb))
    sa, sb = (1,) * (n - len(sa)) + sa, (1,) * (n - len(sb)) + sb
    if any(x != y and 1 not in (x, y) for x, y in zip(sa, sb)):
        raise ValueError(f"batch shapes {sa} and {sb} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(sa, sb))


class TModelMul:
    """Fused model multiply in the batch-trailing layout.

    ``to_t(x)``: storage ``[*batch, D(, L)]`` -> ``[D, *batch(, L)]``;
    ``mul_t`` maps two transposed coefficient-form operands to their
    transposed coefficient-form product.  All four models."""

    def __init__(self, ring):
        self.ring = ring
        self.f = ring.field
        self._crt, self._icrt = ring._dense_crt
        # (slot product, commit contraction): the slot kernels of this
        # model, chosen once, used on a CUDA device; None: torch ops
        self._slot_pair = None
        if ring.E > 1:
            self._tables = ext_tables(ring)
            perm = self._tables.perm.tolist()
            if slot_kernel_applies(self.f, ring.E, perm):
                self._slot_pair = (slot_mul, slot_matvec)
            elif bb_slot_kernel_applies(self.f, ring.E, perm):
                self._slot_pair = (bb_slot_mul, bb_slot_matvec)

    def _kernels(self, device):
        """The stored slot-kernel pair where ``device`` is a CUDA device,
        else None."""
        return self._slot_pair if torch.device(device).type == "cuda" \
            else None

    def uses_slot_kernel(self, device) -> bool:
        """Whether slot products on ``device`` run on the kernels of
        :mod:`.slot` (Goldilocks, E = 3, identity storage permutation,
        a CUDA device); every other case runs :func:`.slot.ext_mul`."""
        return self._kernels(device) == (slot_mul, slot_matvec)

    def uses_bb_slot_kernel(self, device) -> bool:
        """Whether slot products on ``device`` run on the kernels of
        :mod:`.slot_bb` (BabyBear, E = 9, storage order ``[0, 3, 6, 1, 4,
        7, 2, 5, 8]``, a CUDA device)."""
        return self._kernels(device) == (bb_slot_mul, bb_slot_matvec)

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
        with trace_span("model.slot_product"):
            if self._kernels(a.device) is None:
                return ext_mul(self.f, self._tables, a, b)
            return self._slot_mul(a, b)

    def _slot_mul(self, a, b):
        """The stored slot-product kernel (:func:`.slot.slot_mul`, or
        :func:`.slot_bb.bb_slot_mul`) on a [N, E, *ba] and b [N, E, *bb]:
        the operand whose batch is the broadcast batch first, the other's
        batch that one or 1 (the product commutes); other broadcasts are
        expanded first."""
        kernel = self._slot_pair[0]
        N, E = a.shape[:2]
        batch = _broadcast(tuple(a.shape[2:]), tuple(b.shape[2:]))
        full = math.prod(batch)
        if math.prod(a.shape[2:]) != full:
            a, b = b, a
        if math.prod(a.shape[2:]) != full or \
                math.prod(b.shape[2:]) not in (full, 1):
            a, b = (t.expand((N, E) + batch) for t in (a, b))
        out = kernel(a.contiguous().view(N, E, full),
                     b.contiguous().view(N, E, math.prod(b.shape[2:])),
                     self._tables)
        return out.view((N * E,) + batch)

    def ntt_mul_t(self, at, bt):
        """Slot-wise extension product in the batch-trailing layout
        (ring.ntt_mul's math, ntt_form.rs:159-189); the operands are
        [D, *batch] of one batch shape."""
        N, E = self.ring.N, self.ring.E
        if E == 1:
            with trace_span("model.slot_product"):
                return self.f.mul(at, bt)
        B = at[0].numel()
        out = self._slot_product(at.reshape(N, E, B), bt.reshape(N, E, B))
        return out.reshape(at.shape)

    def ntt_mul_bt(self, at, bt):
        """ntt_mul_t with broadcastable batch shapes: ``at [D, *ba]``,
        ``bt [D, *bb]`` (right-aligned) -> ``[D, *broadcast(ba, bb)]``."""
        N, E = self.ring.N, self.ring.E
        if E == 1:
            with trace_span("model.slot_product"):
                return self.f.mul(at, bt)
        return self._slot_product(at.reshape((N, E) + at.shape[1:]),
                                   bt.reshape((N, E) + bt.shape[1:]))

    def matvec_t(self, At, xt, block: int | None = None):
        """NTT-form mat-vec in the transposed layout.

        ``At [D, n, m(, L)]`` (a matrix of NTT-form ring elements), ``xt
        [D, m(, L)]`` or ``[D, W, m(, L)]`` (batched vectors) -> ``[D, n]``
        / ``[D, W, n]`` (``(, L)``: stark_prime's limbs): c[i] = sum_j
        A[i, j] * x[j] (the reference's checked_mul_vec over RqNTT,
        matrix.rs:148-188), by :func:`.slot.ext_matvec`.

        ``block``: contraction-blocked exact accumulation (see
        :func:`.slot.ext_matvec`), bit-equal to the unblocked path.  Where
        the model has slot kernels on ``At``'s device, the contraction is
        one :func:`.slot.slot_matvec` (:func:`.slot_bb.bb_slot_matvec`)
        launch, exact at every ``block``, which it therefore ignores."""
        f = self.f
        if xt.dim() == 2 + len(f.limb_shape):
            return self.matvec_t(At, xt[:, None], block=block)[:, 0]
        kernels = self._kernels(At.device)
        if kernels is None:
            return ext_matvec(f, self.ntt_mul_bt, At, xt, block)
        N, E = self.ring.N, self.ring.E
        D, n, m = At.shape
        W = xt.shape[1]
        with trace_span("model.slot_product"):
            out = kernels[1](At.contiguous().view(N, E, n, m),
                             xt.contiguous().view(N, E, W, m), self._tables)
        return out.view(D, W, n)

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
