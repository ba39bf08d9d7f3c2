"""BabyBear power-of-two negacyclic multiply (BASELINE config 2) on the
digit-GEMM engine of ``ops/mxu2.py`` (counterpart of
``stark_rings_tpu/ops/mxu_bb.py``).

The construction is ``Mxu2NTT``'s, sized for the 31-bit modulus, with
values in u32 Montgomery storage (int32 tensors) end to end:

* unsigned scheme (the default): 4 u8 data planes (the bytes of each
  word) times 4 u8 weight digits, 16 MACs per modular MAC, no bias;
  signed scheme (``unsigned=False``): 5 7-bit planes times 5 signed
  digits, each bucket biased by 2^26 before the fold;
* the weights are pre-multiplied by 2^32 mod q before digitization, so
  the fold's single Montgomery REDC (which divides by 2^32) returns the
  canonical value; the twiddles carry the Montgomery factor, since the
  twiddle and slot products are Montgomery products (``BABYBEAR.mul``);
* the bucket recombination fits one u64 word (below 2^55 unsigned,
  2^59 signed), so the fold is one REDC and one conditional subtract.
"""

from __future__ import annotations

import torch

from ..fields import BABYBEAR
from ..fields.field import MASK32
from .mxu2 import B_BITS, Mxu2NTT, PrescaledMat

__all__ = ["MxuBBNTT", "BBPrescaledMat", "bb_fold_rows", "BIAS_RED"]

_bb = BABYBEAR
_Q = _bb.q
_R32 = (1 << 32) % _Q

P_PLANES = 5    # 7-bit unsigned data digits covering 31 bits
D_BITS = 7
K_BUCKETS = 5   # signed 8-bit weight digits covering [0, 2^32)
P_PLANES_U8 = 4
K_BUCKETS_U8 = 4

_BIAS = 1 << 26
_BIAS_VAL = sum(_BIAS << (B_BITS * k) for k in range(K_BUCKETS))
#: (BIAS * 2^-32) mod q: subtracted after the signed scheme's REDC fold
BIAS_RED = _BIAS_VAL * pow(1 << 32, -1, _Q) % _Q


def bb_fold_rows(V: torch.Tensor, R: int, signed: bool) -> torch.Tensor:
    """int32 bucket planes [K*R, cols] -> u32 storage [R, cols] (int32).

    acc = sum_k b_k 2^(8k) with b_k the bucket's u32 bits (plus 2^26,
    wrapping, in the signed scheme), accumulated mod 2^64; then one REDC
    (the weights carry 2^32) and, signed, the bias image is subtracted
    mod q.  Every step wraps as the reference's u32/u64 arithmetic does
    (``_bb_fold_rows``), so any int32 input gives the reference's bits;
    buckets within their bound give canonical values."""
    K = V.shape[0] // R
    acc = None
    for k in range(K):
        b = V[k * R:(k + 1) * R].to(torch.int64) & MASK32
        if signed:
            b = (b + _BIAS) & MASK32
        c = b << (B_BITS * k)
        acc = c if acc is None else acc + c
    t = _bb._redc(acc)
    if signed:
        t = torch.where(t < BIAS_RED, t + (_Q - BIAS_RED), t - BIAS_RED)
    return t.to(torch.int32)


class BBPrescaledMat(PrescaledMat):
    """Constant [R, C] BabyBear matrix with pre-scaled digit planes;
    ``big`` is byte-equal to the reference's ``BBPrescaledMat.big``."""

    F = _bb
    SCALE = _R32
    K_U8, P_U8 = K_BUCKETS_U8, P_PLANES_U8
    K_S, P_S, D_S = K_BUCKETS, P_PLANES, D_BITS

    def fold(self, V: torch.Tensor) -> torch.Tensor:
        """int32 [K*R, cols] bucket planes -> canonical u32 [R, cols]."""
        return bb_fold_rows(V, self.R, not self.unsigned)


class MxuBBNTT(Mxu2NTT):
    """Negacyclic BabyBear ring multiply for power-of-two N (config 2:
    N = 2^12 = 64 x 64), on Montgomery storage."""

    F = _bb
    MAT = BBPrescaledMat

    def __init__(self, N: int = 1 << 12, n1: int | None = None,
                 unsigned: bool = True, device="cuda"):
        super().__init__(N, n1, unsigned, device)
