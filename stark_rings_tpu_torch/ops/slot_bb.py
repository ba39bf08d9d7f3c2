"""The BabyBear ring model's extension-slot product as hand-written CUDA
kernels (``csrc/slot_bb.cu``): the counterparts of :mod:`.slot`'s
Goldilocks pair for F_q[Y]/(Y^9 - nr), q = 15 * 2^27 + 1.

The BabyBear model (D = 72) holds 8 slots of nine u32 Montgomery words
each, ``[N, 9, *batch]`` in the batch-trailing layout of
:class:`..ops.model_mul.TModelMul`, stored in the order
``[0, 3, 6, 1, 4, 7, 2, 5, 8]`` (:data:`PERM9`); the kernels apply that
permutation in registers.

- ``bb_slot_mul``: :func:`bb_slot_mul`, twin :func:`bb_slot_mul_ref`;
  the reference's ``ntt_mul_bt`` (``model_mul.py:158``);
- ``bb_slot_matvec``: :func:`bb_slot_matvec`, twin
  :func:`bb_slot_matvec_ref`; the reference's ``matvec_t`` (``:183``).

Both take the ring's :class:`.slot.ExtTables` (:func:`.slot.ext_tables`)
and read only its ``nr``; the kernels assume the storage order
:data:`PERM9`, which :func:`bb_slot_kernel_applies` checks once for a
model.  A wrapper checks its inputs and then dispatches on their
device: CPU tensors get the twin (:func:`.slot.ext_mul` /
:func:`.slot.ext_matvec` over BabyBear on those tables), CUDA tensors
the kernel, or an exception (no fallback).  The launch plan and the
checks are :mod:`.slot`'s.  Every launch adds one to
``LAUNCHES[<wrapper name>]``, a counter of this module's own.  Both
kernels' sums are exact integer sums reduced mod q once, so they equal
their twins bit for bit.
"""

from __future__ import annotations

import torch

from ..fields.field import BABYBEAR, BabyBear
from . import _build
from .slot import (MUL_THREADS, _GRID_YZ, ExtTables, _check_tables,
                   _check_words, ext_mul, matvec_plan, slot_matvec_twin)

__all__ = ["PERM9", "bb_slot_kernel_applies", "bb_slot_mul", "bb_slot_matvec",
           "bb_slot_mul_ref", "bb_slot_matvec_ref", "LAUNCHES",
           "reset_launches"]

LAUNCHES = {"bb_slot_mul": 0, "bb_slot_matvec": 0}

E9 = 9                    # the kernels' slot degree
PERM9 = [0, 3, 6, 1, 4, 7, 2, 5, 8]   # degree d -> stored row
MUL_VEC = 4               # words a thread of bb_slot_mul, one 16-byte load


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bb_slot_kernel_applies(field, E: int, perm) -> bool:
    """Whether a model's slot products can run on this module's kernels:
    the BabyBear field, E = 9 and the storage order :data:`PERM9`.  The
    kernels take CUDA tensors only."""
    return (isinstance(field, BabyBear) and E == E9
            and [int(p) for p in perm] == PERM9)


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------


def bb_slot_mul_ref(a, b, t: ExtTables):
    """Plain twin of :func:`bb_slot_mul`: :func:`.slot.ext_mul` over
    BabyBear."""
    return ext_mul(BABYBEAR, t, a, b)


def bb_slot_matvec_ref(A, x, t: ExtTables, block: int | None = None):
    """Plain twin of :func:`bb_slot_matvec`: :func:`.slot.ext_matvec`
    over BabyBear (``block`` as there)."""
    return slot_matvec_twin(BABYBEAR, A, x, t, block)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _nr_mont(name, t) -> int:
    """The tables' nr as the Montgomery word nr R mod q the kernels take,
    after checking the tables."""
    _check_tables(name, t, E9, BABYBEAR.q)
    return t.nr * BABYBEAR.R % BABYBEAR.q


def bb_slot_mul(a, b, t: ExtTables):
    """The BabyBear slot product, Y^9 = ``t.nr``: a [N, 9, Ba] times b
    [N, 9, Bb] -> [N*9, Ba], contiguous int32 (canonical u32 Montgomery
    words), with Bb = Ba, or Bb = 1 (one element a slot, broadcast over
    a's batch)."""
    _check_words("bb_slot_mul", a, b, dtype=torch.int32)
    if a.dim() != 3 or a.shape[1] != E9 or b.dim() != 3 \
            or b.shape[:2] != a.shape[:2] or b.shape[2] not in (a.shape[2], 1):
        raise ValueError(f"bb_slot_mul: expected a [N, 9, Ba] and b [N, 9, "
                         f"Ba or 1], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    nr_mont = _nr_mont("bb_slot_mul", t)
    N, _, Ba = a.shape
    if N > _GRID_YZ or -(-Ba // MUL_THREADS) >= 2**31:
        raise ValueError(f"bb_slot_mul: shape {tuple(a.shape)} exceeds the "
                         "kernel's grid")
    if not _build.on_cuda("bb_slot_mul", a, b):
        return bb_slot_mul_ref(a, b, t)
    out = torch.empty((N * E9, Ba), dtype=torch.int32, device=a.device)
    if not a.numel():
        return out
    bcast = b.shape[2] != Ba
    vec = MUL_VEC if Ba % MUL_VEC == 0 and all(
        x.data_ptr() % 16 == 0 for x in ((a, out) if bcast else (a, b, out))
    ) else 1
    _build.launch(LAUNCHES, "bb_slot_mul", _build.kernels().srt_bb_slot_mul,
                  a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), N, Ba,
                  int(bcast), vec, nr_mont)
    return out


def bb_slot_matvec(A, x, t: ExtTables):
    """The BabyBear slot mat-vec, Y^9 = ``t.nr``: A [N, 9, n, m] and x
    [N, 9, W, m] -> out [N*9, W, n], out[s, :, w, i] = sum_j A[s, :, i, j]
    * x[s, :, w, j] (slot products), contiguous int32 (canonical u32
    Montgomery words); m >= 1."""
    _check_words("bb_slot_matvec", A, x, dtype=torch.int32)
    if A.dim() != 4 or A.shape[1] != E9 or x.dim() != 4 \
            or x.shape[:2] != A.shape[:2] or x.shape[3] != A.shape[3]:
        raise ValueError(f"bb_slot_matvec: expected A [N, 9, n, m] and x "
                         f"[N, 9, W, m], got {tuple(A.shape)} and "
                         f"{tuple(x.shape)}")
    N, _, n, m = A.shape
    W = x.shape[2]
    if min(N, n, W, m) < 1:
        raise ValueError(f"bb_slot_matvec: empty shape {tuple(A.shape)} x "
                         f"{tuple(x.shape)}")
    nr_mont = _nr_mont("bb_slot_matvec", t)
    plan = matvec_plan(N, n, W, m, E9, partial_bytes=4)
    if N > _GRID_YZ or plan.tiles > _GRID_YZ or max(n, W) >= 2**31 \
            or plan.chunks >= 2**31:
        raise ValueError(f"bb_slot_matvec: shape {tuple(A.shape)} x "
                         f"{tuple(x.shape)} exceeds the kernel's grid")
    if not _build.on_cuda("bb_slot_matvec", A, x):
        return bb_slot_matvec_ref(A, x, t)
    dev = A.device
    out = torch.empty((N * E9, W, n), dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets, _, partials, _ = _build.work(dev, stream, plan.tickets,
                                          plan.partials)
    _build.launch(LAUNCHES, "bb_slot_matvec",
                  _build.kernels().srt_bb_slot_matvec, dev, A.data_ptr(),
                  x.data_ptr(), out.data_ptr(), N, n, W, m, plan.chunk,
                  plan.chunks, plan.tiles_n, plan.tiles, nr_mont, partials,
                  tickets, stream=stream)
    return out
