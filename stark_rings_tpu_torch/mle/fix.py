"""Full evaluation (K5) and fix-last-variables (K6) of a dense Goldilocks
MLE (counterpart of ``stark_rings_tpu/mle/pallas_fix.py``).

K5 ``evaluate_goldilocks`` (twin ``evaluate_goldilocks_ref``) replaces
``evaluate_goldilocks_pallas``; K6 ``fix_last_goldilocks`` (twin
``fix_last_goldilocks_ref``) replaces ``fix_last_goldilocks_pallas``.

A wrapper checks its inputs and dispatches on their device: CPU tensors
get the twin's result, CUDA tensors a launch of the kernels of
``csrc/mle.cu`` (or an exception).  Every launch adds one to
``LAUNCHES[<wrapper name>]``.  K5 takes any nv >= 1 (the reference's
kernel needs nv >= 9 for its 128-lane rows; the tile kernel here binds
1 to 10 variables per block).  K6 keeps the reference's contract,
nv >= 9 and 1 <= k <= nv - 7.

Points are canonical field elements: a 1-D int64 tensor, or a sequence
of 0-d int64 tensors or of python ints.  The twins bind the variables in
the reference kernels' order (the last variable first, top and bottom
halves); the kernels bind them in another order, which gives the same
value because each variable gets its own point.
"""

from __future__ import annotations

import torch

from ..fields.field import GOLDILOCKS as F, i64
from ..ops import _build

__all__ = ["evaluate_goldilocks", "evaluate_goldilocks_ref",
           "fix_last_goldilocks", "fix_last_goldilocks_ref", "as_points",
           "LAUNCHES", "reset_launches"]

LAUNCHES = {"evaluate_goldilocks": 0, "fix_last_goldilocks": 0}

_EVAL_MAX_BITS = 10   # K5: variables bound per launch (one tile per block)
_FIX_MAX_BITS = 5     # K6: variables bound per launch (in registers)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def as_points(points, device, dtype=torch.int64) -> torch.Tensor:
    """Field elements -> a contiguous 1-D tensor [n] of ``dtype`` (the
    field's storage dtype: int64, or int32 for BabyBear) on ``device``.
    Python ints are taken as storage words."""
    if isinstance(points, torch.Tensor):
        if points.dtype != dtype or points.dim() != 1:
            raise ValueError(f"points must be a 1-D {dtype} tensor, got "
                             f"{points.dtype} {tuple(points.shape)}")
        return points.to(device).contiguous()
    # a python int's word, read as the signed integer of the same bits
    word = i64 if dtype == torch.int64 else (
        lambda v: (int(v) + 2**31) % 2**32 - 2**31)
    vals = [r.reshape(()).to(device, dtype)
            if isinstance(r, torch.Tensor)
            else torch.tensor(word(int(r)), dtype=dtype, device=device)
            for r in points]
    if not vals:
        return torch.empty(0, dtype=dtype, device=device)
    return torch.stack(vals)


def _check_table(evals, name) -> int:
    if not isinstance(evals, torch.Tensor) or evals.dtype != torch.int64 \
            or evals.dim() != 1:
        raise TypeError(f"{name}: evals must be a 1-D int64 tensor")
    n = evals.shape[0]
    nv = n.bit_length() - 1
    if n != 1 << nv:
        raise ValueError(f"{name}: table length {n} is not a power of two")
    return nv


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def fix_last_goldilocks_ref(evals, points):
    """Plain twin of :func:`fix_last_goldilocks`: var nv-1 gets
    points[-1] first, as ``DenseMLE.fix_last_variables``."""
    pts = as_points(points, evals.device)
    x = evals
    for j in range(pts.shape[0] - 1, -1, -1):
        h = x.shape[0] // 2
        x = F.add(x[:h], F.mul(pts[j], F.sub(x[h:], x[:h])))
    return x


def evaluate_goldilocks_ref(evals, points):
    """Plain twin of :func:`evaluate_goldilocks`: binds variables
    nv-1 ... 0, each to its own point."""
    return fix_last_goldilocks_ref(evals, points)[0]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def evaluate_goldilocks(evals, points):
    """K5: the multilinear extension of ``evals`` (int64 [2^nv]) at the
    nv ``points``, a 0-d int64 tensor; equals ``DenseMLE.evaluate``.

    On the card each launch binds the low (up to) 10 variables of every
    2^10-entry tile, one tile per block: nv = 20 is two launches."""
    nv = _check_table(evals, "evaluate_goldilocks")
    if len(points) != nv:
        raise ValueError(f"evaluate_goldilocks: {len(points)} points for a "
                         f"table of 2^{nv}")
    if nv < 1:
        raise ValueError("evaluate_goldilocks: needs nv >= 1, got 0")
    pts = as_points(points, evals.device)
    if not _build.on_cuda("evaluate_goldilocks", evals, pts):
        return evaluate_goldilocks_ref(evals, pts)
    if not evals.is_contiguous():
        raise ValueError("evaluate_goldilocks: evals must be contiguous")
    lib = _build.kernels()
    src, n, off = evals, nv, 0
    while n:
        m = min(n, _EVAL_MAX_BITS)
        out = torch.empty(1 << (n - m), dtype=torch.int64,
                          device=evals.device)
        _build.launch(LAUNCHES, "evaluate_goldilocks",
                      lib.srt_mle_eval_tiles, evals.device, src.data_ptr(),
                      out.data_ptr(), 1 << (n - m), m,
                      pts.data_ptr() + 8 * off)
        src, n, off = out, n - m, off + m
    return src[0]


def fix_last_goldilocks(evals, points):
    """K6: bind the last k = len(points) variables of ``evals`` (int64
    [2^nv]), var nv-1 to points[-1]; returns int64 [2^(nv-k)], equal to
    ``DenseMLE.fix_last_variables(points).evals``.

    On the card each launch binds the top (up to) 5 remaining variables:
    every output entry combines its 2^5 strided inputs in registers."""
    nv = _check_table(evals, "fix_last_goldilocks")
    k = len(points)
    if nv < 9 or not 1 <= k <= nv - 7:
        raise ValueError(f"fix_last_goldilocks: needs nv >= 9 and "
                         f"1 <= k <= nv - 7, got nv={nv}, k={k}")
    pts = as_points(points, evals.device)
    if not _build.on_cuda("fix_last_goldilocks", evals, pts):
        return fix_last_goldilocks_ref(evals, pts)
    if not evals.is_contiguous():
        raise ValueError("fix_last_goldilocks: evals must be contiguous")
    lib = _build.kernels()
    src, n, rem = evals, nv, k
    while rem:
        s = min(rem, _FIX_MAX_BITS)
        M = 1 << (n - s)
        out = torch.empty(M, dtype=torch.int64, device=evals.device)
        # the top s variables of the current table are points[rem-s:rem]
        _build.launch(LAUNCHES, "fix_last_goldilocks", lib.srt_mle_fix_top,
                      evals.device, src.data_ptr(), out.data_ptr(), M, s,
                      pts.data_ptr() + 8 * (rem - s))
        src, n, rem = out, n - s, rem - s
    return src
