"""The fused digit-product kernel for exact Goldilocks matrix products
(counterpart of ``MxuModMatPallas`` in ``stark_rings_tpu/ops/pallas_mxu.py``).

:class:`MxuModMatFused` computes what :class:`.mxu.MxuModMat` computes,
y = M x (mod q) for u64 x [C, cols], in one launch of the kernel of
``csrc/mxu.cu``: the 7-bit digits of x, the 19 int32 bucket sums of the
digit products on the int8 tensor cores (``mma.sync`` m16n8k32, the 100
products W_k x_l into 19 accumulator tiles), their carry-packing into
words and the Goldilocks fold, all inside the kernel, with no library
GEMM and no digit plane or bucket tensor in device memory.  Any number
of columns, rows and matrix columns: the kernel masks the ragged edges,
where the reference padded to its tile.

=================  ======================  ======================
wrapper            twin                    reference
=================  ======================  ======================
``mxu_mod_mat``    ``mxu_mod_mat_ref``     ``MxuModMatPallas.apply``
=================  ======================  ======================

Two weight tables describe M.  ``w`` (:func:`kernel_weights`, int8
[R, C, 16]: the ten digits of M[r, c] at bytes 0..9) is what the wrapper
and the twin take.  The kernel reads :func:`tc_weights` of it, int8
[10, Rp, Cp]: digit plane k as rows of bytes, the A operand's layout,
zero-padded to the kernel's 64-row block and 32-column chunk.
:class:`MxuModMatFused` builds both once; :func:`mxu_mod_mat` given only
``w`` builds the plane table on each call.

The twin repeats the reference kernel's arithmetic in plain torch: the
digit products as int64 broadcasts, summed by bucket, and the word
packing and fold on u32 pairs (``_word_accumulate``, ``_word_finalize``),
with the u32-pair helpers of ``ops/goldilocks.py``.  It holds [R, C,
cols] int64 products at a time, so it is for small column counts; the
kernel also equals ``MxuModMat.apply`` (``torch._int_mm`` and the u64
fold) at any size.

The reference's ``stacked`` and ``tile`` options chose how its MXU tiles
were shaped; both compute the same function, and ``big_planes`` (the
stacked weights) is kept as :attr:`MxuModMatFused.big` so the tests can
hold it byte-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from .goldilocks import M32, _add_q, _pair_sub, _reduce128, _sub_q, join
from .mxu import (DBITS, DIGITS, NBUCKETS, MxuModMat, check_bound,
                  data_digits)

__all__ = ["MxuModMatFused", "mxu_mod_mat", "mxu_mod_mat_ref", "LAUNCHES",
           "reset_launches", "kernel_weights", "tc_weights"]

LAUNCHES = {"mxu_mod_mat": 0}
_N_WORDS = (DBITS * (NBUCKETS - 1) + 31) // 32 + 2
_W_BYTES = 16        # weight digits per (r, c) in ``w``
_BLOCK_ROWS = 64     # the kernel's rows a block (csrc/mxu.cu BR) ...
_BLOCK_COLS = 32     # ... columns a block (BM) ...
_CHUNK = 32          # ... and matrix columns a chunk (KC)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_weights(planes: np.ndarray, device) -> torch.Tensor:
    """int8 [DIGITS, R, C] digit planes -> the kernel's int8 [R, C, 16]
    (digit k of M[r, c] at byte k, bytes DIGITS.. zero)."""
    _, R, C = planes.shape
    w = np.zeros((R, C, _W_BYTES), dtype=np.int8)
    w[:, :, :DIGITS] = planes.transpose(1, 2, 0)
    return torch.from_numpy(w).to(get_device(device))


def tc_weights(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weights [R, C, 16] -> its digit-plane table int8
    [DIGITS, Rp, Cp] on w's device: plane k holds digit k of M, rows
    padded to a multiple of 64 and columns to a multiple of 32 with
    zeros."""
    R, C, _ = w.shape
    wt = torch.zeros(_tc_shape(R, C), dtype=torch.int8,
                     device=w.device)
    wt[:, :R, :C] = w[:, :, :DIGITS].permute(2, 0, 1)
    return wt


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------


def _canon64(lo, hi):
    """u64 pair -> canonical mod q (one conditional subtract)."""
    ge = (hi > M32) | ((hi == M32) & (lo >= 1))
    slo, shi, _ = _pair_sub(lo, hi, 1, M32)
    return torch.where(ge, slo, lo), torch.where(ge, shi, hi)


def _word_accumulate(wlo, whi, s, v):
    """Add bucket s (int64 values in [0, 2^31)) into the words."""
    r = DBITS * s
    j, sh = r >> 5, r & 31
    clo = (v << sh) & M32
    chi = v >> (32 - sh) if sh else torch.zeros_like(v)
    t = (wlo[j] + clo) & M32
    whi[j] = (whi[j] + (t < clo).to(torch.int64)) & M32
    wlo[j] = t
    t2 = (wlo[j + 1] + chi) & M32
    whi[j + 1] = (whi[j + 1] + (t2 < chi).to(torch.int64)) & M32
    wlo[j + 1] = t2


def _word_finalize(wlo, whi):
    """Words -> canonical (lo, hi) mod q."""
    zero = torch.zeros_like(wlo[0])
    d, carry = [], zero
    for j in range(_N_WORDS):
        t = (wlo[j] + carry) & M32
        d.append(t)
        carry = (whi[j] + (t < carry).to(torch.int64)) & M32
    d.append(carry)
    d += [zero] * (7 - len(d))
    b32 = _reduce128(zero, d[2], d[3], zero)        # B * 2^32 mod q
    c32 = _reduce128(zero, d[4], d[5], zero)        # C * 2^32 mod q
    acc = _add_q(*_canon64(d[0], d[1]),
                 *_sub_q(*b32, *_canon64(d[2], d[3])))
    acc = _sub_q(*acc, *c32)
    return _add_q(*acc, *_canon64(d[6], zero))


def mxu_mod_mat_ref(x, w):
    """Plain twin of :func:`mxu_mod_mat`."""
    planes = w[:, :, :DIGITS].permute(2, 0, 1).to(torch.int64)  # [K, R, C]
    xd = data_digits(x).to(torch.int64)                         # [L, C, cols]
    R, cols = planes.shape[1], x.shape[1]
    wlo = [torch.zeros((R, cols), dtype=torch.int64, device=x.device)
           for _ in range(_N_WORDS)]
    whi = list(wlo)
    for s in range(NBUCKETS):
        v = None
        for k in range(max(0, s - DIGITS + 1), min(DIGITS, s + 1)):
            p = (planes[k][:, :, None] * xd[s - k][None]).sum(1)
            v = p if v is None else v + p
        _word_accumulate(wlo, whi, s, v)
    return join(*_word_finalize(wlo, whi))


# ---------------------------------------------------------------------------
# wrapper and engine
# ---------------------------------------------------------------------------


def mxu_mod_mat(x, w, wt=None):
    """y = M x (mod q): x int64 [C, cols] (u64 bits, any value), w the
    kernel weights int8 [R, C, 16] of M (:func:`kernel_weights`) ->
    canonical int64 [R, cols].  ``wt``: :func:`tc_weights` of ``w``
    where the caller keeps it (built here when not given)."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int64 \
            or x.dim() != 2:
        raise TypeError("mxu_mod_mat: x must be a 2-D int64 tensor")
    if not isinstance(w, torch.Tensor) or w.dtype != torch.int8 \
            or w.dim() != 3 or w.shape[2] != _W_BYTES:
        raise TypeError(f"mxu_mod_mat: w must be an int8 [R, C, "
                        f"{_W_BYTES}] tensor")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("mxu_mod_mat: x and w must be contiguous")
    R, C, _ = w.shape
    if x.shape[0] != C:
        raise ValueError(f"mxu_mod_mat: x has {x.shape[0]} rows, the "
                         f"matrix {C} columns")
    check_bound(C)
    cols = x.shape[1]
    if R == 0 or -(-cols // _BLOCK_COLS) >= 2**31 \
            or -(-R // _BLOCK_ROWS) > 65535:
        raise ValueError(f"mxu_mod_mat: R={R}, cols={cols} outside the "
                         "kernel's grid")
    if not _build.on_cuda("mxu_mod_mat", x, w):
        return mxu_mod_mat_ref(x, w)
    if wt is None:
        wt = tc_weights(w)
    elif wt.dtype != torch.int8 or wt.device != w.device \
            or tuple(wt.shape) != tuple(_tc_shape(R, C)) \
            or not wt.is_contiguous():
        raise ValueError(f"mxu_mod_mat: wt must be the contiguous int8 "
                         f"{list(_tc_shape(R, C))} table of w")
    out = torch.empty((R, cols), dtype=torch.int64, device=x.device)
    if cols:
        _build.launch(LAUNCHES, "mxu_mod_mat",
                      _build.kernels().srt_mxu_mod_mat, x.device,
                      x.data_ptr(), wt.data_ptr(), out.data_ptr(), R, C,
                      cols)
    return out


def _tc_shape(R: int, C: int) -> tuple:
    """The shape of :func:`tc_weights` for an [R, C] matrix."""
    return (DIGITS, -(-R // _BLOCK_ROWS) * _BLOCK_ROWS,
            -(-C // _CHUNK) * _CHUNK)


class MxuModMatFused(MxuModMat):
    """y = M x (mod q) for a constant [R, C] Goldilocks matrix M in one
    kernel launch per call (the reference's ``MxuModMatPallas``).

    ``planes`` and ``big`` (the stacked weights, the reference's
    ``big_planes``) are :class:`.mxu.MxuModMat`'s; ``w`` is the
    wrapper's device table and ``wt`` the kernel's digit planes."""

    def __init__(self, m_ints, device="cuda"):
        super().__init__(m_ints, device)
        self.w = kernel_weights(self.planes, self.device)
        self.wt = tc_weights(self.w)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x u64 [C, cols] -> u64 [R, cols]."""
        return mxu_mod_mat(x.contiguous(), self.w, self.wt)
