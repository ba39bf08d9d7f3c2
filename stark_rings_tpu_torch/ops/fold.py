"""Bucket-fold epilogues K1-K3 and the fused ring-multiply engine
(counterpart of ``stark_rings_tpu/ops/pallas_fold.py``).

Each kernel has a public wrapper and a plain PyTorch twin:

========  ==================  ==================  ============================
kernel    wrapper             twin                reference (pallas_fold.py)
========  ==================  ==================  ============================
K1        ``fold_tw``         ``fold_tw_ref``     ``fold_tw_dma``
K2        ``fold_end2_mul``   ``fold_end2_mul_ref``  ``fold_end2_mul_dma``
K3        ``fold_end``        ``fold_end_ref``    ``fold_end_dma``
========  ==================  ==================  ============================

A wrapper checks its inputs and then dispatches on their device: for CPU
tensors it returns its twin's result; for CUDA tensors it launches the
hand-written kernel of ``csrc/fold.cu`` on the current stream, or raises
(no fallback).  Every launch adds one to ``LAUNCHES[<wrapper name>]``.

The twins follow the reference kernels' u32-pair arithmetic
(``ops/goldilocks.py``); the CUDA kernels use native 64/128-bit words.
"""

from __future__ import annotations

import torch

from . import _build
from .goldilocks import _mul_q, _reduce128, _sub_q, join, split
from .mxu2 import BIAS_MOD_Q, B_BITS, Mxu2NTT

__all__ = ["fold_tw", "fold_end2_mul", "fold_end", "fold_tw_ref",
           "fold_end2_mul_ref", "fold_end_ref", "LAUNCHES",
           "reset_launches", "Mxu2FusedNTT"]

M32 = 0xFFFFFFFF
_BIAS = 1 << 26
_BM_LO, _BM_HI = BIAS_MOD_Q & M32, BIAS_MOD_Q >> 32

LAUNCHES = {"fold_tw": 0, "fold_end2_mul": 0, "fold_end": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _fold_rows_ref(V, R, signed):
    """int32 [K*R, C] -> canonical (lo, hi) u32 words [R, C].

    Signed scheme (K=9): value = sum_k (v_k + 2^26) 2^(8k) - BIAS (mod q),
    the bias added with u32 wraparound on the raw bits.  Unsigned scheme
    (K=8): value = sum_k v_k 2^(8k) (mod q)."""
    K = V.shape[0] // R
    zero = torch.zeros((R, V.shape[1]), dtype=torch.int64, device=V.device)
    w = [zero, zero, zero, zero]
    ov = [zero, zero, zero, zero]
    for k in range(K):
        b = V[k * R:(k + 1) * R].to(torch.int64) & M32
        if signed:
            b = (b + _BIAS) & M32
        r = B_BITS * k
        j, sh = r >> 5, r & 31
        clo = (b << sh) & M32 if sh else b
        t = (w[j] + clo) & M32
        cy = (t < clo).to(torch.int64)
        w[j] = t
        if sh:
            ov[j + 1] = (ov[j + 1] + cy + (b >> (32 - sh))) & M32
        else:
            ov[j + 1] = (ov[j + 1] + cy) & M32
    for j in range(1, 4):
        t = (w[j] + ov[j]) & M32
        w[j] = t
        if j < 3:
            ov[j + 1] = (ov[j + 1] + (t < ov[j]).to(torch.int64)) & M32
    lo, hi = _reduce128(w[0], w[1], w[2], w[3])
    if not signed:
        return lo, hi
    return _sub_q(lo, hi, _BM_LO, _BM_HI)


def fold_end_ref(V, R, *, signed):
    """Plain twin of :func:`fold_end`."""
    return join(*_fold_rows_ref(V, R, signed))


def fold_tw_ref(V, tw, R, *, transpose_out=False, signed):
    """Plain twin of :func:`fold_tw`."""
    t = tw.shape[1]
    B = V.shape[1] // t
    lo, hi = _fold_rows_ref(V, R, signed)
    tlo, thi = split(tw)
    plo, phi = _mul_q(lo.view(R, B, t), hi.view(R, B, t),
                      tlo[:, None, :], thi[:, None, :])
    y = join(plo, phi)
    if transpose_out:
        return y.permute(2, 1, 0).reshape(t, B * R)
    return y.reshape(R, B * t)


def fold_end2_mul_ref(Va, Vb, R, *, signed):
    """Plain twin of :func:`fold_end2_mul`."""
    if Vb is None:
        cols = Va.shape[1] // 2
        Va, Vb = Va[:, :cols], Va[:, cols:]
    cols, b_cols = Va.shape[1], Vb.shape[1]
    alo, ahi = _fold_rows_ref(Va, R, signed)
    blo, bhi = _fold_rows_ref(Vb, R, signed)
    if b_cols != cols:
        reps = cols // b_cols
        blo = blo[:, None, :].expand(R, reps, b_cols).reshape(R, cols)
        bhi = bhi[:, None, :].expand(R, reps, b_cols).reshape(R, cols)
    return join(*_mul_q(alo, ahi, blo, bhi))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_buckets(V, R, signed, name):
    if not isinstance(V, torch.Tensor) or V.dtype != torch.int32 \
            or V.dim() != 2:
        raise TypeError(f"{name}: buckets must be a 2-D int32 tensor")
    if not V.is_contiguous():
        raise ValueError(f"{name}: buckets must be contiguous")
    K = 9 if signed else 8
    if R <= 0 or V.shape[0] != K * R:
        raise ValueError(f"{name}: expected {K}*R = {K * R} bucket rows "
                         f"({'signed' if signed else 'unsigned'} scheme), "
                         f"got {V.shape[0]}")
    if V.shape[1] == 0:
        raise ValueError(f"{name}: no columns")
    if R > 65535 or (V.shape[1] + 255) // 256 >= 2**31:
        raise ValueError(f"{name}: shape {tuple(V.shape)} exceeds the "
                         "kernel's grid")


def _on_cuda(name, *tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def _launch(name, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        msg = _build.kernels().srt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def fold_tw(V, tw, R, *, transpose_out=False, signed):
    """K1: fold(V) times the mid twiddle, broadcast over the batch.

    V int32 [K*R, B*t] (columns in (b, t) order), tw int64 [R, t] ->
    int64 [R, B*t], or with ``transpose_out`` [t, B*R] where
    ``out[j, b*R + r] = y[r, b*t + j]`` (the four-step mid transpose)."""
    _check_buckets(V, R, signed, "fold_tw")
    if tw.dtype != torch.int64 or tw.dim() != 2 or tw.shape[0] != R \
            or not tw.is_contiguous():
        raise ValueError(f"fold_tw: tw must be a contiguous int64 [R={R}, t] "
                         f"tensor, got {tw.dtype} {tuple(tw.shape)}")
    cols, t = V.shape[1], tw.shape[1]
    if cols % t:
        raise ValueError(f"fold_tw: t={t} does not divide cols={cols}")
    if not _on_cuda("fold_tw", V, tw):
        return fold_tw_ref(V, tw, R, transpose_out=transpose_out,
                           signed=signed)
    shape = (t, cols // t * R) if transpose_out else (R, cols)
    out = torch.empty(shape, dtype=torch.int64, device=V.device)
    lib = _build.kernels()
    _launch("fold_tw", lib.srt_fold_tw, V.device, V.data_ptr(), cols,
            tw.data_ptr(), t, out.data_ptr(), R, cols, int(transpose_out),
            int(signed))
    return out


def fold_end2_mul(Va, Vb, R, *, signed):
    """K2: fold(Va) * fold(Vb) mod q -> int64 [R, cols].

    ``Vb=None``: Va holds both operands side by side, [K*R, 2*cols], the
    second at column offset cols.  A Vb with fewer columns than Va (a
    batch-1 cached operand, [K*R, t]) is read at column ``c mod t``."""
    _check_buckets(Va, R, signed, "fold_end2_mul")
    if Vb is None:
        if Va.shape[1] % 2:
            raise ValueError("fold_end2_mul: stacked buckets need an even "
                             "number of columns")
        cols = b_cols = Va.shape[1] // 2
        tensors = (Va,)
    else:
        _check_buckets(Vb, R, signed, "fold_end2_mul")
        cols, b_cols = Va.shape[1], Vb.shape[1]
        if cols % b_cols:
            raise ValueError(f"fold_end2_mul: Vb's {b_cols} columns do not "
                             f"divide Va's {cols}")
        tensors = (Va, Vb)
    if not _on_cuda("fold_end2_mul", *tensors):
        return fold_end2_mul_ref(Va, Vb, R, signed=signed)
    out = torch.empty((R, cols), dtype=torch.int64, device=Va.device)
    lib = _build.kernels()
    if Vb is None:
        lda = ldb = 2 * cols
        b_ptr = Va.data_ptr() + cols * Va.element_size()
    else:
        lda, ldb, b_ptr = cols, b_cols, Vb.data_ptr()
    _launch("fold_end2_mul", lib.srt_fold_end2_mul, Va.device, Va.data_ptr(),
            lda, b_ptr, ldb, b_cols, out.data_ptr(), R, cols, int(signed))
    return out


def fold_end(V, R, *, signed):
    """K3: fold(V), int32 [K*R, cols] -> canonical int64 [R, cols]."""
    _check_buckets(V, R, signed, "fold_end")
    if not _on_cuda("fold_end", V):
        return fold_end_ref(V, R, signed=signed)
    cols = V.shape[1]
    out = torch.empty((R, cols), dtype=torch.int64, device=V.device)
    lib = _build.kernels()
    _launch("fold_end", lib.srt_fold_end, V.device, V.data_ptr(), cols,
            out.data_ptr(), R, cols, int(signed))
    return out


# ---------------------------------------------------------------------------
# the fused engine
# ---------------------------------------------------------------------------


class Mxu2FusedNTT(Mxu2NTT):
    """:class:`Mxu2NTT` with the fold epilogues in the K1-K3 kernels.

    Counterpart of the reference's ``Mxu2PallasNTT(N, dma_folds=True,
    pointwise_pallas=True, fuse_pointwise=True)``: level 1 of each
    transform folds, twiddles and transposes in K1; forward level 2 of
    both operands and the slot product are one K2; inverse level 2 is K3.
    The reference's chunk sizes and other TPU knobs only tiled VMEM and
    have no counterpart.

    ``precompute`` returns the un-folded level-2 buckets [K*R, B*t] of
    the cached operand, so ``mul_cached`` feeds them straight into K2; a
    batch-1 operand ([K*R, t]) is broadcast over the live batch inside
    the kernel.  ``stack_forward`` runs both operands' forward level 1
    and level-2 GEMM as one stacked batch."""

    def __init__(self, N: int = 1 << 16, unsigned: bool = True,
                 stack_forward: bool = False, device="cpu"):
        super().__init__(N, unsigned, device)
        self.stack_forward = stack_forward
        self.signed = not unsigned

    def _fold_end(self, mat, V, B, t):
        return fold_end(V, mat.R, signed=self.signed).view(mat.R, B, t)

    def _lvl_tw_t(self, mat, x, c, key, tw_key):
        """Mid level with the transpose fused into K1."""
        C, B, t = x.shape
        y = fold_tw(self._dot(mat, x, c, key), c[tw_key], mat.R,
                    transpose_out=True, signed=self.signed)
        return y.view(t, B, mat.R)

    def _fwd_buckets(self, x, c):
        """Forward level 1 and the level-2 GEMM, without the end fold:
        int32 buckets [K*R, B*t] for K2."""
        mid = self._lvl_tw_t(self.mat1, self._to_internal(x), c, "w1", "tw")
        C, B, t = mid.shape
        return self._dot(self.mat2, mid, c, "w2"), B, t

    def _tail(self, prod, B, t, c):
        prod = prod.view(self.mat2.R, B, t)
        return self._from_internal(self.inverse_internal(prod, c))

    def precompute(self, b, c=None):
        V, _, _ = self._fwd_buckets(b, self._c(c))
        return V

    def mul_cached(self, a, fb, c=None):
        c = self._c(c)
        Va, B, t = self._fwd_buckets(a, c)
        if fb.shape[1] not in (B * t, t):
            raise ValueError(f"mul_cached: cached state has {fb.shape[1]} "
                             f"columns, expected {B * t} or {t} (batch 1)")
        prod = fold_end2_mul(Va, fb, self.mat2.R, signed=self.signed)
        return self._tail(prod, B, t, c)

    def square(self, a, c=None):
        c = self._c(c)
        Va, B, t = self._fwd_buckets(a, c)
        prod = fold_end2_mul(Va, Va, self.mat2.R, signed=self.signed)
        return self._tail(prod, B, t, c)

    def mul(self, a, b, c=None):
        """Full multiply; the two forward end-folds and the slot product
        are one K2 launch."""
        c = self._c(c)
        if self.stack_forward:
            # column order of the stacked buckets is (b2, t) with operand
            # a at b2 < B, so K2 reads b's half at column offset B*t
            ab = torch.cat([self._to_internal(a), self._to_internal(b)],
                           dim=1)
            mid = self._lvl_tw_t(self.mat1, ab, c, "w1", "tw")  # [t, 2B, R]
            C, B2, t = mid.shape
            B = B2 // 2
            V = self._dot(self.mat2, mid, c, "w2")
            prod = fold_end2_mul(V, None, self.mat2.R, signed=self.signed)
        else:
            Va, B, t = self._fwd_buckets(a, c)
            Vb, _, _ = self._fwd_buckets(b, c)
            prod = fold_end2_mul(Va, Vb, self.mat2.R, signed=self.signed)
        return self._tail(prod, B, t, c)
