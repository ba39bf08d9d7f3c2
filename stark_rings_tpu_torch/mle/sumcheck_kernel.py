"""One-pass k-ary product sumcheck prover, kernel K7 (counterpart of
``stark_rings_tpu/mle/pallas_sumcheck.py``, the Goldilocks field).

``sumcheck_prove_many(tables, challenges)`` proves S = sum_x prod_j
T_j(x) in msb order (challenge i binds variable nv-1-i) for challenges
given up front, and returns ``(msgs [nv, k+1], finals)`` exactly as
``sumcheck_prove_many_with_challenges(F, tables, challenges,
order="msb")`` does: per round p(0..k), and the k fully bound values.
That generic prover is the twin, ``sumcheck_prove_many_ref``.

On CUDA tensors the wrapper launches one ``csrc/mle.cu`` round kernel
per round (messages as per-block partials, and the fold with that
round's challenge into half-size tables in device memory) and one
kernel that reduces every round's partials to the messages: nv + 1
launches, no host synchronisation, for every nv >= 1.  The reference
hands small tables to the generic prover (nv < 12, and the last 10
rounds: its kernel works on rows of 128 lanes); here every round stays
in the round kernel, the small ones as one block each.
Every launch adds one to ``LAUNCHES``.  CPU tensors get the twin.

Only Goldilocks is ported: the reference's BabyBear and frog variants
(``_BbOps``, ``_FrogOps``) wait for those fields.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.field import GOLDILOCKS as F
from ..ops import _build
from .fix import as_points
from .sumcheck import sumcheck_prove_many_with_challenges

__all__ = ["sumcheck_prove_many", "sumcheck_prove_many_goldilocks",
           "sumcheck_prove_goldilocks", "sumcheck_prove_many_ref",
           "LAUNCHES", "reset_launches"]

LAUNCHES = {"sumcheck_prove_many_goldilocks": 0}

_NAME = "sumcheck_prove_many_goldilocks"
_MAX_K = 8              # tables per product in the kernel (registers)
_MAX_BLOCKS = 1024      # partials per round (csrc/mle.cu SC_MAX_BLOCKS)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sumcheck_prove_many_ref(tables, challenges):
    """Plain twin of :func:`sumcheck_prove_many`: the generic msb
    prover."""
    return sumcheck_prove_many_with_challenges(F, tables, challenges,
                                               order="msb")


def sumcheck_prove_many(tables, challenges, field: str = "goldilocks"):
    """k-ary product sumcheck prover, msb order: ``tables`` k int64
    [2^nv] storage tensors, ``challenges`` nv field elements (a 1-D
    int64 tensor, or scalars).  Returns (msgs int64 [nv, k+1], finals: k
    0-d tensors)."""
    if field in ("babybear", "frog"):
        raise NotImplementedError(
            f"sumcheck_prove_many: the {field} field is not ported yet "
            "(ROADMAP Slice C item 9)")
    if field != "goldilocks":
        raise ValueError(f"sumcheck_prove_many: no sumcheck kernel for "
                         f"field {field!r}")
    k, nv = len(tables), len(challenges)
    n = 1 << nv
    if k < 1:
        raise ValueError("sumcheck_prove_many: no tables")
    for T in tables:
        if not isinstance(T, torch.Tensor) or T.dtype != torch.int64 \
                or tuple(T.shape) != (n,):
            raise ValueError(f"sumcheck_prove_many: every table must be "
                             f"int64 [{n}] for {nv} challenges")
    chal = as_points(challenges, tables[0].device)
    if not _build.on_cuda(_NAME, *tables, chal):
        return sumcheck_prove_many_ref(tables, chal)
    if nv < 1:
        raise ValueError("sumcheck_prove_many: the kernel needs at least "
                         "one challenge")
    if k > _MAX_K:
        raise ValueError(f"sumcheck_prove_many: the kernel takes at most "
                         f"{_MAX_K} tables, got {k}")
    if not all(T.is_contiguous() for T in tables):
        raise ValueError("sumcheck_prove_many: tables must be contiguous")
    dev = tables[0].device
    half = n // 2
    scratch = torch.empty((k, half), dtype=torch.int64, device=dev)
    partials = torch.empty((nv, _MAX_BLOCKS, k + 1), dtype=torch.int64,
                           device=dev)
    msgs = torch.empty((nv, k + 1), dtype=torch.int64, device=dev)
    ptrs = ctypes.c_void_p * k
    ins = ptrs(*[T.data_ptr() for T in tables])
    outs = ptrs(*[s.data_ptr() for s in scratch])
    lib = _build.kernels()
    for i in range(nv):
        _build.launch(LAUNCHES, _NAME, lib.srt_sumcheck_round, dev, ins,
                      outs, k, half >> i, chal.data_ptr(), i,
                      partials.data_ptr())
        ins = outs                       # later rounds fold in place
    _build.launch(LAUNCHES, _NAME, lib.srt_sumcheck_reduce, dev,
                  partials.data_ptr(), msgs.data_ptr(), k + 1, nv, half)
    return msgs, list(scratch[:, 0])


def sumcheck_prove_many_goldilocks(tables, challenges):
    return sumcheck_prove_many(tables, challenges, field="goldilocks")


def sumcheck_prove_goldilocks(G, H, challenges):
    """Product-of-two prover (msb order): (msgs [nv, 3], g_final,
    h_final)."""
    msgs, finals = sumcheck_prove_many_goldilocks([G, H], challenges)
    return msgs, finals[0], finals[1]
