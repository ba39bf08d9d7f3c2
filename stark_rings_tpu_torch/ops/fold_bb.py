"""BabyBear bucket-fold epilogues K4 and the fused BabyBear engine
(counterpart of ``stark_rings_tpu/ops/pallas_fold_bb.py``).

Each kernel has a public wrapper and a plain PyTorch twin:

=====================  =========================  ==========================
wrapper                twin                       reference
=====================  =========================  ==========================
``bb_fold_tw``         ``bb_fold_tw_ref``         ``bb_fold_tw_dma``
``bb_fold_end2_mul``   ``bb_fold_end2_mul_ref``   ``bb_fold_end2_mul_dma``
``bb_fold_end``        ``bb_fold_end_ref``        ``bb_fold_end_dma``
=====================  =========================  ==========================

The wrappers follow ``ops/fold.py``'s rule: a CPU tensor gets the twin's
result, a CUDA tensor a launch of ``csrc/fold_bb.cu`` (or an exception),
and every launch adds one to ``LAUNCHES[<wrapper name>]``.  Values are
u32 Montgomery storage in int32 tensors.  The twins follow the
reference's ``_bb_fold_rows`` and ``_bb_mont_mul`` on int64 words; the
CUDA kernels use native u32/u64 arithmetic with ``__umulhi``.
"""

from __future__ import annotations

import torch

from ..fields import BABYBEAR
from .fold import (Folds, Mxu2FusedNTT, fold_end2_mul_with, fold_end_with,
                   fold_tw_with)
from .mxu2 import Mxu2NTT
from .mxu_bb import MxuBBNTT, bb_fold_rows

__all__ = ["bb_fold_tw", "bb_fold_end2_mul", "bb_fold_end", "bb_fold_tw_ref",
           "bb_fold_end2_mul_ref", "bb_fold_end_ref", "LAUNCHES",
           "reset_launches", "MxuBBFusedNTT"]

LAUNCHES = {"bb_fold_tw": 0, "bb_fold_end2_mul": 0, "bb_fold_end": 0}
BB_FOLDS = Folds("bb_", (4, 5), torch.int32, LAUNCHES)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def bb_fold_end_ref(V, R, *, signed):
    """Plain twin of :func:`bb_fold_end`."""
    return bb_fold_rows(V, R, signed)


def bb_fold_tw_ref(V, tw, R, *, transpose_out=False, signed):
    """Plain twin of :func:`bb_fold_tw`."""
    t = tw.shape[1]
    B = V.shape[1] // t
    y = bb_fold_rows(V, R, signed).view(R, B, t)
    y = BABYBEAR.mont_mul(y, tw[:, None, :])
    if transpose_out:
        return y.permute(2, 1, 0).reshape(t, B * R)
    return y.reshape(R, B * t)


def bb_fold_end2_mul_ref(Va, Vb, R, *, signed):
    """Plain twin of :func:`bb_fold_end2_mul`."""
    if Vb is None:
        cols = Va.shape[1] // 2
        Va, Vb = Va[:, :cols], Va[:, cols:]
    cols, b_cols = Va.shape[1], Vb.shape[1]
    x = bb_fold_rows(Va, R, signed)
    y = bb_fold_rows(Vb, R, signed)
    if b_cols != cols:
        y = y[:, None, :].expand(R, cols // b_cols, b_cols).reshape(R, cols)
    return BABYBEAR.mont_mul(x, y)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def bb_fold_tw(V, tw, R, *, transpose_out=False, signed):
    """K4 fold times the Montgomery mid twiddle, broadcast over the batch.

    V int32 [K*R, B*t] (K = 4 unsigned, 5 signed; columns in (b, t)
    order), tw int32 [R, t] -> int32 [R, B*t], or with ``transpose_out``
    [t, B*R] where ``out[j, b*R + r] = y[r, b*t + j]``."""
    return fold_tw_with(BB_FOLDS, bb_fold_tw_ref, V, tw, R, transpose_out,
                        signed)


def bb_fold_end2_mul(Va, Vb, R, *, signed):
    """K4 fold of both operands and their Montgomery slot product ->
    int32 [R, cols].

    ``Vb=None``: Va holds both operands side by side, [K*R, 2*cols].  A
    Vb with fewer columns than Va (a batch-1 cached operand, [K*R, t]) is
    read at column ``c mod t``."""
    return fold_end2_mul_with(BB_FOLDS, bb_fold_end2_mul_ref, Va, Vb, R,
                              signed)


def bb_fold_end(V, R, *, signed):
    """K4 fold, int32 [K*R, cols] -> canonical u32 storage [R, cols]."""
    return fold_end_with(BB_FOLDS, bb_fold_end_ref, V, R, signed)


# ---------------------------------------------------------------------------
# the fused engine
# ---------------------------------------------------------------------------


class MxuBBFusedNTT(Mxu2FusedNTT, MxuBBNTT):
    """:class:`MxuBBNTT` with its epilogues in the K4 kernels, in the
    fused engine's arrangement (:class:`~.fold.Mxu2FusedNTT`): level 1
    of each transform in ``bb_fold_tw`` with the transpose, forward
    level 2 of both operands and the slot product in one
    ``bb_fold_end2_mul``, inverse level 2 in ``bb_fold_end``.

    Counterpart of the reference's ``MxuBBPallasNTT(N)`` with its
    defaults (``fuse_transpose``, ``fuse_pointwise``, unsigned):
    ``mul``, ``stack_forward`` mul, ``precompute`` (the un-folded level-2
    buckets), ``mul_cached`` (batch-B and batch-1 states) and
    ``square``.  The untransposed level (``staged_mul``'s) folds in
    ``bb_fold_tw``; the slot product outside K4 (``pointwise``) stays the
    field's Montgomery product in torch ops, as the reference keeps it in
    XLA."""

    _k_tw = staticmethod(bb_fold_tw)
    _k_end2 = staticmethod(bb_fold_end2_mul)
    _k_end = staticmethod(bb_fold_end)
    pointwise = Mxu2NTT.pointwise

    def __init__(self, N: int = 1 << 12, n1: int | None = None,
                 unsigned: bool = True, stack_forward: bool = False,
                 device="cuda"):
        super().__init__(N, n1, unsigned, stack_forward, device)
