"""Goldilocks bucket-fold epilogues K1-K3, the slot-product kernel, and
the ring-multiply engines built on them (counterpart of
``stark_rings_tpu/ops/pallas_fold.py``).

Each kernel has a public wrapper and a plain PyTorch twin:

=========  ===================  =======================  ======================
kernel     wrapper              twin                     reference
=========  ===================  =======================  ======================
K1         ``fold_tw``          ``fold_tw_ref``          ``fold_tw_dma``;
                                                         whole-array ``fold_tw``
K2         ``fold_end2_mul``    ``fold_end2_mul_ref``    ``fold_end2_mul_dma``
K3         ``fold_end``         ``fold_end_ref``         ``fold_end_dma``;
                                                         whole-array ``fold_end``
pointwise  ``pointwise_mul``    ``pointwise_mul_ref``    ``pointwise_mul``;
                                                         K3b ``pointwise_dma``
chain      ``pointwise_chain``  ``pointwise_chain_ref``  ``pointwise_chain``
=========  ===================  =======================  ======================

The reference's whole-array folds compute the same functions as its DMA
folds (they differ only in how they tile VMEM), so K1 and K3 serve both.

A wrapper checks its inputs and then dispatches on their device: for CPU
tensors it returns its twin's result; for CUDA tensors it launches the
hand-written kernel of ``csrc/fold.cu`` on the current stream, or raises
(no fallback).  Every launch adds one to ``LAUNCHES[<wrapper name>]``.

The twins follow the reference kernels' u32-pair arithmetic
(``ops/goldilocks.py``); the CUDA kernels use native 64/128-bit words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.trace import trace_span
from . import _build
from .goldilocks import _mul_q, _reduce128, _sub_q, join, split
from .mxu2 import BIAS_MOD_Q, B_BITS, Mxu2NTT

__all__ = ["fold_tw", "fold_end2_mul", "fold_end", "pointwise_mul",
           "pointwise_chain", "fold_tw_ref", "fold_end2_mul_ref",
           "fold_end_ref", "pointwise_mul_ref", "pointwise_chain_ref",
           "LAUNCHES", "reset_launches",
           "Mxu2FusedNTT", "Mxu2KernelNTT"]

M32 = 0xFFFFFFFF
_BIAS = 1 << 26
_BM_LO, _BM_HI = BIAS_MOD_Q & M32, BIAS_MOD_Q >> 32

LAUNCHES = {"fold_tw": 0, "fold_end2_mul": 0, "fold_end": 0,
            "pointwise_mul": 0, "pointwise_chain": 0}


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


def pointwise_mul_ref(a, b):
    """Plain twin of :func:`pointwise_mul` (b broadcast by torch)."""
    b = b.reshape(b.shape[max(b.dim() - a.dim(), 0):]).expand(a.shape)
    return join(*_mul_q(*split(a), *split(b)))


def pointwise_chain_ref(a, b, depth=16):
    """Plain twin of :func:`pointwise_chain`: ``depth`` slot products."""
    x = a
    for _ in range(depth):
        x = pointwise_mul_ref(x, b)
    return x


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class Folds(NamedTuple):
    """One field's family of fold kernels: the C entry points
    ``srt_<prefix>fold_*``, counted in ``counts["<prefix>fold_*"]``.
    ``ks`` is the buckets per row group (unsigned, signed scheme) and
    ``dtype`` the storage of the twiddles and the outputs."""

    prefix: str
    ks: tuple
    dtype: torch.dtype
    counts: dict


GL_FOLDS = Folds("", (8, 9), torch.int64, LAUNCHES)


def _check_buckets(fam, V, R, signed, name):
    if not isinstance(V, torch.Tensor) or V.dtype != torch.int32 \
            or V.dim() != 2:
        raise TypeError(f"{name}: buckets must be a 2-D int32 tensor")
    if not V.is_contiguous():
        raise ValueError(f"{name}: buckets must be contiguous")
    K = fam.ks[signed]
    if R <= 0 or V.shape[0] != K * R:
        raise ValueError(f"{name}: expected {K}*R = {K * R} bucket rows "
                         f"({'signed' if signed else 'unsigned'} scheme), "
                         f"got {V.shape[0]}")
    if V.shape[1] == 0:
        raise ValueError(f"{name}: no columns")
    if R > 65535 or (V.shape[1] + 255) // 256 >= 2**31:
        raise ValueError(f"{name}: shape {tuple(V.shape)} exceeds the "
                         "kernel's grid")


def _launch(fam, kind, device, *args):
    name = fam.prefix + kind
    _build.launch(fam.counts, name, getattr(_build.kernels(), "srt_" + name),
                  device, *args)


def fold_tw_with(fam, twin, V, tw, R, transpose_out, signed):
    """The fold-times-twiddle wrapper of family ``fam`` (see
    :func:`fold_tw`); ``twin`` answers for CPU tensors."""
    name = fam.prefix + "fold_tw"
    _check_buckets(fam, V, R, signed, name)
    if tw.dtype != fam.dtype or tw.dim() != 2 or tw.shape[0] != R \
            or not tw.is_contiguous():
        want = str(fam.dtype).replace("torch.", "")
        raise ValueError(f"{name}: tw must be a contiguous {want} "
                         f"[R={R}, t] tensor, got {tw.dtype} "
                         f"{tuple(tw.shape)}")
    cols, t = V.shape[1], tw.shape[1]
    if cols % t:
        raise ValueError(f"{name}: t={t} does not divide cols={cols}")
    if not _build.on_cuda(name, V, tw):
        return twin(V, tw, R, transpose_out=transpose_out, signed=signed)
    shape = (t, cols // t * R) if transpose_out else (R, cols)
    out = torch.empty(shape, dtype=fam.dtype, device=V.device)
    _launch(fam, "fold_tw", V.device, V.data_ptr(), cols, tw.data_ptr(), t,
            out.data_ptr(), R, cols, int(transpose_out), int(signed))
    return out


def fold_end2_mul_with(fam, twin, Va, Vb, R, signed):
    """The two-fold slot-product wrapper of family ``fam`` (see
    :func:`fold_end2_mul`)."""
    name = fam.prefix + "fold_end2_mul"
    _check_buckets(fam, Va, R, signed, name)
    if Vb is None:
        if Va.shape[1] % 2:
            raise ValueError(f"{name}: stacked buckets need an even number "
                             "of columns")
        cols = b_cols = Va.shape[1] // 2
        tensors = (Va,)
    else:
        _check_buckets(fam, Vb, R, signed, name)
        cols, b_cols = Va.shape[1], Vb.shape[1]
        if cols % b_cols:
            raise ValueError(f"{name}: Vb's {b_cols} columns do not divide "
                             f"Va's {cols}")
        tensors = (Va, Vb)
    if not _build.on_cuda(name, *tensors):
        return twin(Va, Vb, R, signed=signed)
    out = torch.empty((R, cols), dtype=fam.dtype, device=Va.device)
    if Vb is None:
        lda = ldb = 2 * cols
        b_ptr = Va.data_ptr() + cols * Va.element_size()
    else:
        lda, ldb, b_ptr = cols, b_cols, Vb.data_ptr()
    _launch(fam, "fold_end2_mul", Va.device, Va.data_ptr(), lda, b_ptr, ldb,
            b_cols, out.data_ptr(), R, cols, int(signed))
    return out


def fold_end_with(fam, twin, V, R, signed):
    """The plain fold wrapper of family ``fam`` (see :func:`fold_end`)."""
    name = fam.prefix + "fold_end"
    _check_buckets(fam, V, R, signed, name)
    if not _build.on_cuda(name, V):
        return twin(V, R, signed=signed)
    cols = V.shape[1]
    out = torch.empty((R, cols), dtype=fam.dtype, device=V.device)
    _launch(fam, "fold_end", V.device, V.data_ptr(), cols, out.data_ptr(), R,
            cols, int(signed))
    return out


def fold_tw(V, tw, R, *, transpose_out=False, signed):
    """K1: fold(V) times the mid twiddle, broadcast over the batch.

    V int32 [K*R, B*t] (columns in (b, t) order), tw int64 [R, t] ->
    int64 [R, B*t], or with ``transpose_out`` [t, B*R] where
    ``out[j, b*R + r] = y[r, b*t + j]`` (the four-step mid transpose)."""
    return fold_tw_with(GL_FOLDS, fold_tw_ref, V, tw, R, transpose_out,
                        signed)


def fold_end2_mul(Va, Vb, R, *, signed):
    """K2: fold(Va) * fold(Vb) mod q -> int64 [R, cols].

    ``Vb=None``: Va holds both operands side by side, [K*R, 2*cols], the
    second at column offset cols.  A Vb with fewer columns than Va (a
    batch-1 cached operand, [K*R, t]) is read at column ``c mod t``."""
    return fold_end2_mul_with(GL_FOLDS, fold_end2_mul_ref, Va, Vb, R, signed)


def fold_end(V, R, *, signed):
    """K3: fold(V), int32 [K*R, cols] -> canonical int64 [R, cols]."""
    return fold_end_with(GL_FOLDS, fold_end_ref, V, R, signed)


def _check_slots(name, a, b, broadcast=False):
    """Two contiguous int64 tensors of one shape (unless ``broadcast``),
    within the grid."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor) \
            or a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"{name}: operands must be int64 tensors")
    if not broadcast and a.shape != b.shape:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if (a.numel() + 255) // 256 >= 2**31:
        raise ValueError(f"{name}: {a.numel()} elements exceed the grid")


def _check_broadcast(name, a, b):
    """b's shape, less its leading 1s, is a trailing part of a's: then
    torch's broadcast of b reads flat element i mod b.numel()."""
    tail = list(b.shape)
    while tail and tail[0] == 1:
        tail.pop(0)
    if len(tail) > a.dim() or list(a.shape[a.dim() - len(tail):]) != tail:
        raise ValueError(f"{name}: shape {tuple(b.shape)} does not "
                         f"broadcast over the leading axes of "
                         f"{tuple(a.shape)}")


def pointwise_mul(a, b):
    """Goldilocks slot product a * b mod q of int64 tensors (canonical
    u64 bits), elementwise over a's flat range.  b has a's shape, or
    broadcasts over a's leading axes (a table [N1, C] against
    [B, N1, C], a batch-1 operand [1, R, N2] against [B, R, N2]): the
    kernel reads b at flat index i mod b.numel()."""
    _check_slots("pointwise_mul", a, b, broadcast=True)
    _check_broadcast("pointwise_mul", a, b)
    if not _build.on_cuda("pointwise_mul", a, b):
        return pointwise_mul_ref(a, b)
    out = torch.empty_like(a)
    if a.numel():
        _build.launch(LAUNCHES, "pointwise_mul",
                      _build.kernels().srt_pointwise_mul, a.device,
                      a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                      b.numel())
    return out


def pointwise_chain(a, b, depth=16):
    """x <- x * b mod q, ``depth`` times from x = a, elementwise: a * b^depth
    for two int64 tensors of one shape (canonical u64 bits).  The
    reference's chunk and width only tiled VMEM and have no counterpart."""
    _check_slots("pointwise_chain", a, b)
    if not isinstance(depth, int) or not 0 <= depth < 2**31:
        raise ValueError(f"pointwise_chain: depth must be an int in "
                         f"[0, 2^31), got {depth!r}")
    if not _build.on_cuda("pointwise_chain", a, b):
        return pointwise_chain_ref(a, b, depth)
    out = torch.empty_like(a)
    if a.numel():
        _build.launch(LAUNCHES, "pointwise_chain",
                      _build.kernels().srt_pointwise_chain, a.device,
                      a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                      depth)
    return out


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


class _KernelEpilogues(Mxu2NTT):
    """:class:`Mxu2NTT` with every level epilogue and slot product on a
    kernel: the end fold in ``_k_end`` (K3), the untransposed
    fold-times-twiddle in ``_k_tw`` (K1) and the slot product in
    ``pointwise_mul``.  The base of both Goldilocks kernel engines; the
    three fold wrappers are class attributes, so ``ops/fold_bb.py`` swaps
    in BabyBear's K4."""

    _k_tw = staticmethod(fold_tw)
    _k_end2 = staticmethod(fold_end2_mul)
    _k_end = staticmethod(fold_end)

    def __init__(self, N: int = 1 << 16, n1: int | None = None,
                 unsigned: bool = True, device="cuda"):
        super().__init__(N, n1, unsigned, device)
        self.signed = not unsigned

    def _fold_end(self, mat, V, B, t):
        return self._k_end(V, mat.R, signed=self.signed).view(mat.R, B, t)

    def _fold_tw(self, mat, V, tw, B, t):
        return self._k_tw(V, tw, mat.R, transpose_out=False,
                          signed=self.signed).view(mat.R, B, t)

    def pointwise(self, fa, fb):
        if fb.shape != fa.shape:
            fb = fb.expand(fa.shape)
        return pointwise_mul(fa.contiguous(), fb.contiguous())


class Mxu2FusedNTT(_KernelEpilogues):
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
    and level-2 GEMM as one stacked batch.  The untransposed level
    (``_lvl_tw``) and ``pointwise``, which only ``staged_mul`` reaches,
    run on K1 untransposed and the slot-product kernel, as in the
    reference's ``Mxu2PallasNTT``."""

    def __init__(self, N: int = 1 << 16, n1: int | None = None,
                 unsigned: bool = True, stack_forward: bool = False,
                 device="cuda"):
        super().__init__(N, n1, unsigned, device)
        self.stack_forward = stack_forward

    def _lvl_tw_t(self, mat, x, c, key, tw_key):
        """Mid level with the transpose fused into K1."""
        C, B, t = x.shape
        y = self._k_tw(self._dot(mat, x, c, key), c[tw_key], mat.R,
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
        prod = self._k_end2(Va, fb, self.mat2.R, signed=self.signed)
        return self._tail(prod, B, t, c)

    def square(self, a, c=None):
        c = self._c(c)
        Va, B, t = self._fwd_buckets(a, c)
        prod = self._k_end2(Va, Va, self.mat2.R, signed=self.signed)
        return self._tail(prod, B, t, c)

    def mul(self, a, b, c=None):
        """Full multiply; the two forward end-folds and the slot product
        are one K2 launch."""
        with trace_span("mxu.mul"):
            c = self._c(c)
            if self.stack_forward:
                # column order of the stacked buckets is (b2, t) with
                # operand a at b2 < B, so K2 reads b's half at column
                # offset B*t
                ab = torch.cat([self._to_internal(a), self._to_internal(b)],
                               dim=1)
                mid = self._lvl_tw_t(self.mat1, ab, c, "w1", "tw")
                C, B2, t = mid.shape                       # [t, 2B, R]
                B = B2 // 2
                V = self._dot(self.mat2, mid, c, "w2")
                prod = self._k_end2(V, None, self.mat2.R, signed=self.signed)
            else:
                Va, B, t = self._fwd_buckets(a, c)
                Vb, _, _ = self._fwd_buckets(b, c)
                prod = self._k_end2(Va, Vb, self.mat2.R, signed=self.signed)
            return self._tail(prod, B, t, c)


class Mxu2KernelNTT(_KernelEpilogues):
    """:class:`Mxu2NTT` with its folds in K1 (untransposed) and K3 and
    its slot products in the pointwise kernel: the evaluation-domain
    engine of the Goldilocks power rings.

    Counterpart of the reference's ``Mxu2PallasNTT(N,
    pointwise_pallas=True)`` with ``dma_folds=False``, the engine
    ``PowerRing.mxu_ctx()`` returns: each level folds in its kernel (K1
    with the mid twiddle, K3 at the end), the mid transpose is a torch
    permute, and ``pointwise`` / ``mul`` / ``precompute`` +
    ``mul_cached`` / ``square`` multiply evaluations [k2, B, k1] with
    the pointwise kernel.  The cached state is evaluations, so a caller
    can chain slot products on it (``forward_internal``, ``pointwise``,
    ``inverse_internal``), which the fused engine's bucket state cannot
    do.  A batch-1 cached operand is broadcast over the batch in torch
    before the kernel."""
