"""Full evaluation (K5) and fix-last-variables (K6) of a dense Goldilocks
MLE (counterpart of ``stark_rings_tpu/mle/pallas_fix.py``).

K5 ``evaluate_goldilocks`` (twin ``evaluate_goldilocks_ref``) replaces
``evaluate_goldilocks_pallas``; K6 ``fix_last_goldilocks`` (twin
``fix_last_goldilocks_ref``) replaces ``fix_last_goldilocks_pallas``.

A wrapper checks its inputs and dispatches on their device: CPU tensors
get the twin's result, CUDA tensors one launch of a kernel of
``csrc/mle.cu`` (or an exception).  Every launch adds one to
``LAUNCHES[<wrapper name>]``: one a call, at every shape.  K5 takes any
nv >= 1 (the reference's kernel needs nv >= 9 for its 128-lane rows).
K6 keeps the reference's contract, nv >= 9 and 1 <= k <= nv - 7.
:func:`eval_plan` and :func:`fix_plan` give each launch's shape and
scratch; the kernels follow the same rules.

Points are canonical field elements: a 1-D int64 tensor, or a sequence
of 0-d int64 tensors or of python ints.  On the card they reach the
kernel as a table of device addresses and values in the launch
parameters: no copy, no stack.  The twins bind the variables in the
reference kernels' order (the last variable first, top and bottom
halves); the kernels bind them in other orders, or (K6 beyond 5
variables) sum the inputs times their eq weights, which gives the same
value because the multilinear extension is unique.

A launch that combines the values of several blocks keeps their
partials and tickets in a work buffer of the stream it runs on
(``ops._build.work``): its tickets start at 0 and each launch leaves
them at 0, so launches on one stream share it and two streams never do.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple

import torch

from ..fields.field import GOLDILOCKS as F, i64
from ..ops import _build

__all__ = ["evaluate_goldilocks", "evaluate_goldilocks_ref",
           "fix_last_goldilocks", "fix_last_goldilocks_ref", "as_points",
           "eval_plan", "fix_plan", "EvalPlan", "FixPlan", "LAUNCHES",
           "reset_launches"]

LAUNCHES = {"evaluate_goldilocks": 0, "fix_last_goldilocks": 0}

# the constants of csrc/mle.cu that the plans follow
MAX_POINTS = 40          # MLE_MAX_POINTS: the most points a launch takes
_THREADS = 256           # EVAL_THREADS, FIX_THREADS
_EVAL_BITS = 12          # EVAL_BITS: variables a block binds
_EVAL_WARPS = _THREADS // 32
_FIX_TREE_BITS = 5       # FIX_TREE_BITS: k up to this on the tree kernel
_FIX_ROWS = 4            # FIX_ROWS: rows of a block, each its own j's
_FIX_TILE = 128          # FIX_TILE: outputs of a block
_FIX_TARGET_BLOCKS = 256  # fix_layout's bounds on the split of the j's:
_FIX_MAX_CHUNKS = 128     # FIX_TARGET_BLOCKS, FIX_MAX_CHUNKS, FIX_MIN_J
_FIX_MIN_J = 8            # and FIX_MAX_J
_FIX_MAX_J = 256


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
# launch plans
# ---------------------------------------------------------------------------


class EvalPlan(NamedTuple):
    """K5's one launch for a table of 2^nv words."""
    levels: tuple      # variables each level binds (level 0: every block)
    blocks: int        # the grid: level 0's blocks of 256 threads
    tickets: int       # one a group of every later level
    partials: int      # words: the values of every level but the last
    smem: int          # static shared memory a block, bytes
    launches: int = 1


@functools.lru_cache(maxsize=None)
def eval_plan(nv: int) -> EvalPlan:
    """K5's launch at nv (``eval_layout`` in ``csrc/mle.cu``): level 0
    binds min(nv, 12) variables in each of its blocks (2^12 words a
    block, 16 a thread), and each later level up to 12 more in the block
    that draws the last ticket of its group of values."""
    if not 1 <= nv <= MAX_POINTS:
        raise ValueError(f"evaluate_goldilocks: needs 1 <= nv <= "
                         f"{MAX_POINTS}, got {nv}")
    levels = [min(nv, _EVAL_BITS)]
    tickets = partials = 0
    done = levels[0]
    while done < nv:
        b = min(nv - done, _EVAL_BITS)
        partials += 1 << (nv - done)
        tickets += 1 << (nv - done - b)
        levels.append(b)
        done += b
    return EvalPlan(tuple(levels), 1 << (nv - levels[0]), tickets, partials,
                    _EVAL_WARPS * 8 + 4)


class FixPlan(NamedTuple):
    """K6's one launch for k of the nv variables."""
    kernel: str        # "tree" (k <= 5) or "eq" (eq weights)
    blocks: int        # the grid, blocks of 256 threads
    tiles: int         # eq: tiles of 128 outputs (tree: 0)
    chunks: int        # eq: chunks of each output's 2^k j's
    j_row: int         # the j's a thread sums
    tickets: int       # eq with chunks > 1: one a tile
    partials: int      # eq with chunks > 1: chunks * 2^(nv-k) words
    smem: int          # static shared memory a block, bytes
    launches: int = 1


@functools.lru_cache(maxsize=None)
def fix_plan(nv: int, k: int) -> FixPlan:
    """K6's launch (``fix_layout`` in ``csrc/mle.cu``).  k <= 5: one
    thread an output, its 2^k inputs in a register tree.  k > 5: a block
    takes 128 outputs and a chunk of 4J consecutive j's, J a row of 64
    threads; chunks double (J halves) while J > 256, and while the grid
    has fewer than 256 blocks, up to 128 chunks and down to J = 8."""
    if nv < 9 or not 1 <= k <= nv - 7 or nv > MAX_POINTS:
        raise ValueError(f"fix_last_goldilocks: needs 9 <= nv <= "
                         f"{MAX_POINTS} and 1 <= k <= nv - 7, got nv={nv}, "
                         f"k={k}")
    M = 1 << (nv - k)
    if k <= _FIX_TREE_BITS:
        return FixPlan("tree", -(-M // _THREADS), 0, 1, 1 << k, 0, 0, 0)
    tiles = M // _FIX_TILE
    J, chunks = (1 << k) // _FIX_ROWS, 1
    while J > _FIX_MAX_J or (tiles * chunks < _FIX_TARGET_BLOCKS
                             and chunks < _FIX_MAX_CHUNKS
                             and J >= 2 * _FIX_MIN_J):
        chunks, J = 2 * chunks, J // 2
    many = chunks > 1
    smem = (_FIX_ROWS * _FIX_MAX_J + _FIX_ROWS * _FIX_TILE) * 8 + 4
    return FixPlan("eq", tiles * chunks, tiles, chunks, J,
                   tiles if many else 0, chunks * M if many else 0, smem)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_PACK = [struct.Struct(f"{n}Q") for n in range(MAX_POINTS + 1)]
_NO_VALUES = [bytes(8 * n) for n in range(MAX_POINTS + 1)]


def _point_table(name, points, device):
    """The launch's point table: packed device addresses (0 for a point
    given as a value) and values.  A point tensor on ``device`` is read
    in place by the kernel; one on the CPU, or a python int, is passed
    as its word."""
    n = len(points)
    if n > MAX_POINTS:
        raise ValueError(f"{name}: at most {MAX_POINTS} points, got {n}")
    idx = device.index
    if isinstance(points, torch.Tensor):
        if points.dtype != torch.int64 or points.dim() != 1:
            raise ValueError(f"points must be a 1-D {torch.int64} tensor, "
                             f"got {points.dtype} {tuple(points.shape)}")
        if points.get_device() == idx:
            base, step = points.data_ptr(), 8 * points.stride(0)
            return (_PACK[n].pack(*range(base, base + step * n, step))
                    if step else _PACK[n].pack(*[base] * n)), _NO_VALUES[n]
        if not points.is_cpu:
            raise ValueError(f"{name}: inputs on several devices "
                             f"{{{device}, {points.device}}}")
        return _NO_VALUES[n], _PACK[n].pack(*[v % 2**64
                                              for v in points.tolist()])
    ptrs, vals = [0] * n, [0] * n
    for j, r in enumerate(points):
        if not isinstance(r, torch.Tensor):
            vals[j] = int(r) % 2**64
        elif r.get_device() == idx:
            if r.dtype != torch.int64 or r.numel() != 1:
                raise ValueError(f"{name}: a point on the card must be one "
                                 f"int64 word, got {r.dtype} "
                                 f"{tuple(r.shape)}")
            ptrs[j] = r.data_ptr()
        elif r.is_cpu:
            vals[j] = int(r.reshape(())) % 2**64
        else:
            raise ValueError(f"{name}: inputs on several devices "
                             f"{{{device}, {r.device}}}")
    return _PACK[n].pack(*ptrs), _PACK[n].pack(*vals)


def evaluate_goldilocks(evals, points):
    """K5: the multilinear extension of ``evals`` (int64 [2^nv]) at the
    nv ``points``, a 0-d int64 tensor; equals ``DenseMLE.evaluate``.

    On the card: one launch (:func:`eval_plan`)."""
    nv = _check_table(evals, "evaluate_goldilocks")
    if len(points) != nv:
        raise ValueError(f"evaluate_goldilocks: {len(points)} points for a "
                         f"table of 2^{nv}")
    if nv < 1:
        raise ValueError("evaluate_goldilocks: needs nv >= 1, got 0")
    if not (evals.is_cuda or _build.on_cuda("evaluate_goldilocks", evals)):
        return evaluate_goldilocks_ref(evals, points)
    if not evals.is_contiguous():
        raise ValueError("evaluate_goldilocks: evals must be contiguous")
    plan = eval_plan(nv)
    dev = evals.device
    ptrs, vals = _point_table("evaluate_goldilocks", points, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = _build.work(dev, stream, plan.tickets, plan.partials)
    out = torch.empty((), dtype=torch.int64, device=dev)
    _build.launch(LAUNCHES, "evaluate_goldilocks",
                  _build.kernels().srt_mle_eval, dev, evals.data_ptr(), nv,
                  ptrs, vals, *scratch, out.data_ptr(), stream=stream)
    return out


def fix_last_goldilocks(evals, points):
    """K6: bind the last k = len(points) variables of ``evals`` (int64
    [2^nv]), var nv-1 to points[-1]; returns int64 [2^(nv-k)], equal to
    ``DenseMLE.fix_last_variables(points).evals``.

    On the card: one launch (:func:`fix_plan`)."""
    nv = _check_table(evals, "fix_last_goldilocks")
    k = len(points)
    if nv < 9 or not 1 <= k <= nv - 7:
        raise ValueError(f"fix_last_goldilocks: needs nv >= 9 and "
                         f"1 <= k <= nv - 7, got nv={nv}, k={k}")
    if not (evals.is_cuda or _build.on_cuda("fix_last_goldilocks", evals)):
        return fix_last_goldilocks_ref(evals, points)
    if not evals.is_contiguous():
        raise ValueError("fix_last_goldilocks: evals must be contiguous")
    plan = fix_plan(nv, k)
    dev = evals.device
    ptrs, vals = _point_table("fix_last_goldilocks", points, dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    scratch = _build.work(dev, stream, plan.tickets, plan.partials)
    out = torch.empty(1 << (nv - k), dtype=torch.int64, device=dev)
    _build.launch(LAUNCHES, "fix_last_goldilocks",
                  _build.kernels().srt_mle_fix, dev, evals.data_ptr(), nv, k,
                  ptrs, vals, *scratch, out.data_ptr(), stream=stream)
    return out
