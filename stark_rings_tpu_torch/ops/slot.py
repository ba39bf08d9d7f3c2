"""The extension-slot product of the ring models: the torch ops every
model runs, and the Goldilocks kernels of ``csrc/slot.cu``.

A ring model's NTT form holds N slots of F_q[X]/(X^E - nr), E words a
slot, ``[N, E, *batch]`` in the batch-trailing layout of
:class:`..ops.model_mul.TModelMul`.  :func:`ext_mul` multiplies two such
tensors slot by slot in torch ops (gathers, two field products and a
sum tree over the E x E table, for every field, E and storage
permutation), and :func:`ext_matvec` contracts a matrix of ring
elements with vectors of them by those products (the Ajtai commit).

For the Goldilocks model (E = 3, degree order stored as is) the same
two functions are hand-written CUDA kernels:

=========  ===================  ======================  =====================
kernel     wrapper              twin                    reference (XLA code)
=========  ===================  ======================  =====================
slot_mul   :func:`slot_mul`     :func:`slot_mul_ref`    ``ntt_mul_bt``,
                                                        ``model_mul.py:158``
matvec     :func:`slot_matvec`  :func:`slot_matvec_ref`  ``matvec_t``, ``:183``
=========  ===================  ======================  =====================

Both take the ring's :class:`ExtTables` (:func:`ext_tables`).  A
wrapper checks its inputs and then dispatches on their device: CPU
tensors get the twin (:func:`ext_mul` / :func:`ext_matvec` on the
Goldilocks field and those tables), CUDA tensors the kernel, or an
exception (no fallback).  Every launch adds one to ``LAUNCHES[<wrapper name>]``.
Both kernels' sums are exact integer sums folded mod q, so they equal
their twins bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields.field import GOLDILOCKS, Goldilocks
from ..utils.trace import trace_span
from . import _build

__all__ = ["ExtTables", "ext_tables", "ext_mul", "ext_matvec",
           "slot_kernel_applies", "slot_mul", "slot_matvec", "slot_mul_ref",
           "slot_matvec_ref", "slot_matvec_twin", "matvec_plan", "MatvecPlan",
           "LAUNCHES", "reset_launches"]

LAUNCHES = {"slot_mul": 0, "slot_matvec": 0}

E3 = 3                    # the kernels' slot degree
MUL_THREADS = 256         # csrc/slot.cu
MV_TILE_N, MV_TILE_W = 8, 16
MV_THREADS = MV_TILE_N * MV_TILE_W
MV_STEP = 32              # j's a block stages at a time
MV_BLOCKS = 4 * 132       # blocks a launch aims at: four an SM of an H100
MV_MAX_CHUNK = 1 << 28    # j's a block: Goldilocks' 192-bit sums' top word
                          # < 2^32, BabyBear's 2^28 x 9 q^2 + q^2 < 2^94
_GRID_YZ = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the torch ops (every model; the kernels' twins)
# ---------------------------------------------------------------------------


class ExtTables(NamedTuple):
    """Gather/factor tables of the slot product (``ring._ext_tables``):
    the storage permutation and its inverse, the flat [E*E] gather
    index (k - i) mod E, the factors nr^[i > k] as storage [E, E], and
    nr itself (X^E = nr), an int in [0, q)."""

    perm: torch.Tensor
    inv_perm: torch.Tensor
    idx_flat: torch.Tensor
    fac: torch.Tensor
    nr: int


def ext_tables(ring) -> ExtTables:
    """The slot-product tables of a ring model with E > 1, on its
    device."""
    perm, inv_perm, idx, fac = ring._ext_tables
    return ExtTables(perm, inv_perm, idx.reshape(-1), fac,
                     ring.spec.nr % ring.q)


def ext_mul(f, t: ExtTables, a, b):
    """The extension-field product of slot tensors a [N, E, *ba] and
    b [N, E, *bb] (broadcast-compatible batches) -> [N*E, *batch]."""
    N, E = a.shape[0], a.shape[1]
    a_deg = a[:, t.perm]
    b_deg = b[:, t.perm]
    # bg[n, i, k, ...] = b_deg[n, (k-i) % E, ...]
    bg = b_deg[:, t.idx_flat].reshape((N, E, E) + b.shape[2:])
    fac = t.fac.reshape((1, E, E) + (1,) * (b.dim() - 2))
    prod = f.mul(a_deg[:, :, None], f.mul(fac, bg))
    c = f.sum(prod, axis=1)[:, t.inv_perm]  # sum over i
    return c.reshape((N * E,) + c.shape[2:])


def ext_matvec(f, mul_bt, At, xt, block: int | None = None):
    """c[i] = sum_j A[i, j] * x[j] over NTT-form ring elements: ``At
    [D, n, m(, L)]``, ``xt [D, W, m(, L)]`` -> ``[D, W, n(, L)]``, the
    slot products by ``mul_bt(at, bt)`` (``TModelMul.ntt_mul_bt``'s
    broadcasting product on ``[D, *batch]``).  The contraction axis is
    placed major.

    ``block``: contraction-blocked exact accumulation; only
    [D, block, W, n] slot products are live at a time, each block is
    widened to base-2^32 words and summed with integer adds (exact:
    words below 2^32, far fewer than 2^32 addends), and one fold mod q
    ends it.  Bit-equal to the unblocked path.  Each block's widen and
    sum, and the fold, lie in a ``model.commit_acc`` span, beside the
    products' ``model.slot_product``."""
    m = At.shape[2]
    Am = At.transpose(1, 2)                       # [D, m, n(, L)]
    xm = xt.transpose(1, 2)                       # [D, m, W(, L)]
    if block is None or block >= m:
        prod = mul_bt(Am[:, :, None, :],          # [D, m, 1, n]
                      xm[:, :, :, None])          # [D, m, W, 1]
        return f.sum(prod, axis=1)                # [D, W, n]
    acc = None
    for s in range(0, m, block):
        prod = mul_bt(Am[:, s:s + block, None, :],
                      xm[:, s:s + block, :, None])
        with trace_span("model.commit_acc"):
            w = f.widen(prod).sum(dim=1)          # [D, W, n, words]
            acc = w if acc is None else acc + w
    with trace_span("model.commit_acc"):
        return f.reduce_words(acc)


def slot_kernel_applies(field, E: int, perm) -> bool:
    """Whether a model's slot products can run on this module's
    kernels: the Goldilocks field, E = 3 and degree order stored as is
    (the identity permutation).  The kernels take CUDA tensors only."""
    return (isinstance(field, Goldilocks) and E == E3
            and [int(p) for p in perm] == list(range(E3)))


# ---------------------------------------------------------------------------
# the Goldilocks twins
# ---------------------------------------------------------------------------


def slot_mul_ref(a, b, t: ExtTables):
    """Plain twin of :func:`slot_mul`: :func:`ext_mul` over Goldilocks."""
    return ext_mul(GOLDILOCKS, t, a, b)


def slot_matvec_twin(f, A, x, t: ExtTables, block: int | None = None):
    """:func:`ext_matvec` over field ``f`` on a slot mat-vec's operands A
    [N, E, n, m] and x [N, E, W, m] -> [N*E, W, n] (``block`` as
    there): the plain twin of a field's mat-vec kernel."""
    N, E, n, m = A.shape
    W = x.shape[2]

    def mul_bt(at, bt):
        return ext_mul(f, t, at.reshape((N, E) + at.shape[1:]),
                       bt.reshape((N, E) + bt.shape[1:]))

    return ext_matvec(f, mul_bt, A.reshape(N * E, n, m),
                      x.reshape(N * E, W, m), block)


def slot_matvec_ref(A, x, t: ExtTables, block: int | None = None):
    """Plain twin of :func:`slot_matvec`: :func:`ext_matvec` over
    Goldilocks (``block`` as there)."""
    return slot_matvec_twin(GOLDILOCKS, A, x, t, block)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


class MatvecPlan(NamedTuple):
    """One launch of a slot mat-vec kernel (``slot_matvec_kernel``, or
    ``slot_bb.cu``'s ``bb_slot_matvec_kernel``): grid (chunks, tiles, N);
    tile t covers i in [8 (t mod tiles_n), +8) and w in [16 (t // tiles_n),
    +16); chunk c covers j in [c * chunk, (c + 1) * chunk) (a multiple of
    the 32 j's a block stages); ``tickets`` (int32) and ``partials``
    (int64 words) are the scratch it takes (0 with one chunk)."""

    tiles_n: int
    tiles: int
    chunks: int
    chunk: int
    tickets: int
    partials: int


def matvec_plan(N: int, n: int, W: int, m: int, E: int = E3,
                partial_bytes: int = 8) -> MatvecPlan:
    """The launch of a slot mat-vec at [N, E, n, m] x [N, E, W, m]
    (:func:`slot_matvec`'s by default): m split into chunks of 32 j's so
    that about ``MV_BLOCKS`` blocks run (and no block adds more than
    ``MV_MAX_CHUNK`` j's); ``partial_bytes`` is the size of a thread's
    partial of one degree (a u64 word here, a u32 word for BabyBear)."""
    tiles_n = -(-n // MV_TILE_N)
    tiles = tiles_n * -(-W // MV_TILE_W)
    steps = -(-m // MV_STEP)
    want = max(-(-MV_BLOCKS // (N * tiles)),
               -(-steps // (MV_MAX_CHUNK // MV_STEP)))
    per = -(-steps // min(steps, want))           # steps a chunk
    chunks = -(-steps // per)
    many = chunks > 1
    return MatvecPlan(tiles_n, tiles, chunks, per * MV_STEP,
                      N * tiles if many else 0,
                      N * tiles * chunks * E * MV_THREADS * partial_bytes
                      // 8 if many else 0)


def _check_tables(name, t, E: int = E3, q: int = GOLDILOCKS.q):
    """Raise unless ``t`` is the :class:`ExtTables` of an E-word slot
    with nr an int in [0, q)."""
    if not isinstance(t, ExtTables) or len(t.perm) != E:
        raise ValueError(f"{name}: expected the ExtTables of an E = {E} "
                         "ring")
    if not isinstance(t.nr, int) or not 0 <= t.nr < q:
        raise ValueError(f"{name}: nr must be an int in [0, q), got "
                         f"{t.nr!r}")


def _check_words(name, *tensors, dtype=torch.int64):
    """Raise unless every operand is a contiguous ``dtype`` tensor."""
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name}: operands must be "
                            f"{str(dtype).removeprefix('torch.')} tensors")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def slot_mul(a, b, t: ExtTables):
    """The Goldilocks slot product, X^3 = ``t.nr``: a [N, 3, Ba] times b
    [N, 3, Bb] -> [N*3, Ba], contiguous int64 (canonical u64 bits), with
    Bb = Ba, or Bb = 1 (one element a slot, broadcast over a's batch)."""
    _check_words("slot_mul", a, b)
    if a.dim() != 3 or a.shape[1] != E3 or b.dim() != 3 \
            or b.shape[:2] != a.shape[:2] or b.shape[2] not in (a.shape[2], 1):
        raise ValueError(f"slot_mul: expected a [N, 3, Ba] and b [N, 3, Ba "
                         f"or 1], got {tuple(a.shape)} and {tuple(b.shape)}")
    _check_tables("slot_mul", t)
    N, _, Ba = a.shape
    if N > _GRID_YZ or -(-Ba // MUL_THREADS) >= 2**31:
        raise ValueError(f"slot_mul: shape {tuple(a.shape)} exceeds the "
                         "kernel's grid")
    if not _build.on_cuda("slot_mul", a, b):
        return slot_mul_ref(a, b, t)
    out = torch.empty((N * E3, Ba), dtype=torch.int64, device=a.device)
    if not a.numel():
        return out
    bcast = b.shape[2] != Ba
    vec = 2 if Ba % 2 == 0 and all(
        t.data_ptr() % 16 == 0 for t in ((a, out) if bcast else (a, b, out))
    ) else 1
    _build.launch(LAUNCHES, "slot_mul", _build.kernels().srt_slot_mul,
                  a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), N, Ba,
                  int(bcast), vec, t.nr)
    return out


def slot_matvec(A, x, t: ExtTables):
    """The Goldilocks slot mat-vec, X^3 = ``t.nr``: A [N, 3, n, m] and x
    [N, 3, W, m] -> out [N*3, W, n], out[s, :, w, i] = sum_j A[s, :, i, j]
    * x[s, :, w, j] (slot products), contiguous int64 (canonical u64
    bits); m >= 1."""
    _check_words("slot_matvec", A, x)
    if A.dim() != 4 or A.shape[1] != E3 or x.dim() != 4 \
            or x.shape[:2] != A.shape[:2] or x.shape[3] != A.shape[3]:
        raise ValueError(f"slot_matvec: expected A [N, 3, n, m] and x "
                         f"[N, 3, W, m], got {tuple(A.shape)} and "
                         f"{tuple(x.shape)}")
    N, _, n, m = A.shape
    W = x.shape[2]
    if min(N, n, W, m) < 1:
        raise ValueError(f"slot_matvec: empty shape {tuple(A.shape)} x "
                         f"{tuple(x.shape)}")
    _check_tables("slot_matvec", t)
    plan = matvec_plan(N, n, W, m)
    if N > _GRID_YZ or plan.tiles > _GRID_YZ or max(n, W) >= 2**31 \
            or plan.chunks >= 2**31:
        raise ValueError(f"slot_matvec: shape {tuple(A.shape)} x "
                         f"{tuple(x.shape)} exceeds the kernel's grid")
    if not _build.on_cuda("slot_matvec", A, x):
        return slot_matvec_ref(A, x, t)
    dev = A.device
    out = torch.empty((N * E3, W, n), dtype=torch.int64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets, _, partials, _ = _build.work(dev, stream, plan.tickets,
                                          plan.partials)
    _build.launch(LAUNCHES, "slot_matvec", _build.kernels().srt_slot_matvec,
                  dev, A.data_ptr(), x.data_ptr(), out.data_ptr(), N, n, W,
                  m, plan.chunk, plan.chunks, plan.tiles_n, plan.tiles,
                  t.nr, partials, tickets, stream=stream)
    return out
