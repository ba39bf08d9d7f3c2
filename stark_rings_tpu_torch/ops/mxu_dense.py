"""One factory for the ring models' constant modular matrices
(counterpart of ``stark_rings_tpu/ops/mxu_dense.py``).

``prescaled_dense(field, m_ints, device)`` returns a callable
``x [..., C] -> [..., R]`` (storage in, storage out, exact) backed by
the digit-plane GEMM of ``ops/mxu2.py``: the digit planes of the data
times pre-scaled weight digits in one ``torch._int_mm``, then the
bucket fold of each output.  Per field:

* goldilocks: canonical u64 storage, :class:`~.mxu2.PrescaledMat`; the
  fold is K3's kernel (``ops/fold.py`` ``fold_end``);
* babybear: Montgomery u32 storage, :class:`~.mxu_bb.BBPrescaledMat`;
  the fold is K4's ``bb_fold_end`` kernel (``ops/fold_bb.py``);
* frog: Montgomery u64 storage, :class:`Mont64PrescaledMat` (here): the
  weights carry 2^64 and the fold is one 64-bit REDC in torch ops, as
  the reference folds it in XLA, outside any Pallas kernel;
* stark_prime: Montgomery u32 limbs [..., 8],
  :class:`~.mxu_limb.LimbPrescaledMat`; the fold is the S3 kernel
  (``ops/stark.py`` ``limb_fold``).

The kernel wrappers run their plain twins on CPU tensors, so on the CPU
the three folds are plain torch.  This is what makes the model CRT/ICRT
maps (goldilocks/ntt.rs:68-127, babybear/ntt.rs:143-317,
frog_ring/ntt.rs:108-191, stark_prime/ntt.rs:121-234, each composed
into one D x D matrix) one GEMM and one fold.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..device import get_device
from ..fields import BABYBEAR, FROG, GOLDILOCKS
from ..fields.field import MASK32, _mul64_128, shr, u64_lt
from .fold import fold_end
from .fold_bb import bb_fold_end
from .mxu2 import (B_BITS, K_BUCKETS, P_PLANES, PrescaledMat, _round8,
                   digit_table)
from .mxu_bb import BBPrescaledMat
from .mxu_limb import LimbPrescaledMat

__all__ = ["prescaled_dense", "Mont64PrescaledMat", "apply_cols",
           "fold_buckets"]

_Q = FROG._Q
_BIAS = 1 << 26
#: the signed scheme's bucket bias, times 2^-64 (the fold's REDC): the
#: constant subtracted after the fold
BIAS_RED = (sum(_BIAS << (B_BITS * k) for k in range(K_BUCKETS))
            * pow(1 << 64, -1, FROG.q) % FROG.q)


class Mont64PrescaledMat(PrescaledMat):
    """Constant [R, C] matrix over frog (u64 Montgomery storage).

    Plane ``l``'s weights are ``M * 2^(d_bits*l) * 2^64 mod q``, so the
    fold is one 64-bit REDC: the K buckets pack into a value below 2^91,
    hi*2^64 + lo, and REDC(value) = (value + (lo*q' mod 2^64) q) / 2^64
    < 2q.  ``big`` is byte-equal to the reference's
    ``Mont64PrescaledMat.big`` in both schemes (unsigned: 8 data bytes
    times 8 weight bytes; signed: 10 7-bit planes times 9 signed
    digits)."""

    F = FROG
    SCALE = (1 << 64) % FROG.q
    K_S, P_S = K_BUCKETS, P_PLANES

    def fold(self, V: torch.Tensor) -> torch.Tensor:
        """int32 [K*R, cols] bucket planes -> u64 Montgomery storage
        [R, cols].

        value = sum_k b_k 2^(8k), b_k the bucket's u32 bits (plus 2^26,
        wrapping, in the signed scheme), summed as four base-2^32 words
        (each below 2^36), carry-normalized to (hi, lo) u64 halves; then
        t = hi + hi64(m*q) + (lo != 0) with m = lo * q' mod 2^64 (the low
        halves sum to exactly 2^64 when lo != 0), one conditional
        subtract, and in the signed scheme the bias image subtracted mod
        q.  Every step wraps as the reference's u64 arithmetic does."""
        R = self.R
        words = [None] * 4
        for k in range(self.K):
            b = V[k * R:(k + 1) * R].to(torch.int64) & MASK32
            if not self.unsigned:
                b = (b + _BIAS) & MASK32
            pos = B_BITS * k
            j, sh = pos >> 5, pos & 31
            contrib = b << sh
            for i, part in ((j, contrib & MASK32), (j + 1, shr(contrib, 32))):
                words[i] = part if words[i] is None else words[i] + part
        zero = torch.zeros_like(words[0])
        digits = []
        carry = zero
        for w in words:
            t = (zero if w is None else w) + carry
            digits.append(t & MASK32)
            carry = shr(t, 32)
        lo = digits[0] | (digits[1] << 32)
        hi = digits[2] | (digits[3] << 32)
        mq_hi, _ = _mul64_128(lo * FROG._QP, _Q)
        t = hi + mq_hi + (lo != 0).to(torch.int64)
        t = torch.where(u64_lt(t, _Q), t, t - _Q)
        if self.unsigned:
            return t
        return FROG.sub(t, BIAS_RED)


def fold_buckets(core, V: torch.Tensor) -> torch.Tensor:
    """``core``'s bucket fold of V int32 [K*R, cols] -> storage [R, cols]:
    K3's ``fold_end`` for Goldilocks and K4's ``bb_fold_end`` for BabyBear
    (their kernels on the card, their twins on the CPU), frog's REDC in
    torch ops, stark_prime's S3 ``limb_fold`` -> limbs [R, cols, 8]."""
    if core.F is GOLDILOCKS:
        return fold_end(V, core.R, signed=not core.unsigned)
    if core.F is BABYBEAR:
        return bb_fold_end(V, core.R, signed=not core.unsigned)
    return core.fold(V)


def apply_cols(core, x: torch.Tensor, w: torch.Tensor,
               w_corr: torch.Tensor | None) -> torch.Tensor:
    """core @ x mod q in the batch-trailing layout: storage [C, cols] ->
    [R, cols], through ``core.dot`` with the device tables ``w`` /
    ``w_corr`` (:func:`~.mxu2.digit_table`) and :func:`fold_buckets`.

    The columns are zero-padded to a multiple of 8 (the shapes CUDA's
    ``_int_mm`` takes), so the buckets the fold reads are one contiguous
    tensor; the padded columns are dropped after the fold.  A limbed
    core takes [C, cols, 8] -> [R, cols, 8]."""
    if core.F.limbed:
        return core.apply(x, w, w_corr)
    cols = x.shape[1]
    pad = _round8(cols) - cols
    if pad:
        x = TF.pad(x, (0, pad))
    y = fold_buckets(core, core.dot(x, w, w_corr))
    return y[:, :cols] if pad else y


class _Wrap2D:
    """[..., C] <-> [C, B] plumbing around a prescaled core ([..., C, 8]
    <-> [C, B, 8] for stark_prime's limbs), with the core's digit table
    on the device (``w``, ``w_corr``)."""

    def __init__(self, core, device):
        self.core = core
        self.R, self.C = core.R, core.C
        self.w, self.w_corr = digit_table(core.big, device)

    def __call__(self, x, w=None, w_corr=None):
        """``w`` / ``w_corr``: other device tables of the same matrix
        (``from_jax_consts`` of the reference's tables); the wrapper's
        own by default."""
        if w is None:
            w, w_corr = self.w, self.w_corr
        if self.core.F.limbed:      # [..., C, 8] -> [..., R, 8]
            return self.core(x, w, w_corr)
        lead = x.shape[:-1]
        y = apply_cols(self.core, x.reshape(-1, self.C).t(), w, w_corr)
        return y.t().reshape(lead + (self.R,))


_CORES = {"goldilocks": PrescaledMat, "babybear": BBPrescaledMat,
          "frog": Mont64PrescaledMat, "stark_prime": LimbPrescaledMat}


def prescaled_dense(field, m_ints, device="cuda") -> _Wrap2D:
    """The digit-GEMM implementation of ``x -> M @ x mod q`` for this
    field, its tables on ``device``."""
    if field.name not in _CORES:
        raise KeyError(f"no prescaled matrix for field {field.name!r}")
    return _Wrap2D(_CORES[field.name](m_ints), get_device(device))
