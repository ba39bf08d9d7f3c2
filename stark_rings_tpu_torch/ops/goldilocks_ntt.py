"""The radix-2 Goldilocks NTT engine on hand-written CUDA kernels
(counterpart of ``GoldilocksPallasNTT`` in
``stark_rings_tpu/ops/pallas_goldilocks.py``).

:class:`GoldilocksKernelNTT` takes rows [B, N] of any power of two N
with 2N dividing q - 1, and returns what the port's radix
``NTTContext`` returns: evaluations in leaf order with no bit reversal,
canonical u64 bits in int64 storage.

A row of N = 2^16 words (512 KB) does not fit one block's shared memory,
so a transform splits its stages by butterfly span t = N / 2^(s+1):

* the stages with 2t <= 2^LOG_TILE (2^13 words, 64 KB) run in one
  ``ntt_tile`` launch, each aligned tile of a row in one block's
  registers, exchanged through its shared memory between rounds;
* the stages with 2t > 2^LOG_TILE run as ``ntt_stage`` launches, one
  grid-wide pass over device memory each (3 at N = 2^16).

``mul`` is fused: fwd(b) as above, then fwd(a)'s passes, then one tile
launch that finishes fwd(a), multiplies by fwd(b) and starts the
inverse, then the inverse's passes (the last one times 1/N).  When a
row of each operand fits one tile (2N <= 2^LOG_TILE words) the whole
multiply is one launch.  Launches per ``mul``: 1 for N <= 2^12, 2 at
N = 2^13, 5 at N = 2^14, 11 at N = 2^16.

Kernels, wrappers and twins:

===========  ==================  ======================  =================
kernel       wrapper             twin                    reference
===========  ==================  ======================  =================
stage pass   :func:`ntt_stage`   :func:`ntt_stage_ref`   ``_call``
                                                         (``_big_stage``)
tile         :func:`ntt_tile`    :func:`ntt_tile_ref`    ``_call``
                                                         (all stages)
slot product ``pointwise_mul``   ``pointwise_mul_ref``   ``pointwise``
===========  ==================  ======================  =================

A wrapper launches its kernel for CUDA tensors (or raises) and runs its
twin for CPU tensors; launches are counted in ``LAUNCHES``.  The twins
are butterflies on the field's torch ops over whole rows: the same
stages, independent of the tiling, so the engine on the CPU tests the
stage split and the launch sequence against the reference (the tests
lower ``LOG_TILE`` to reach the passes at small N).

Tables: the reference's two [N] arrays in the m + i layout (stage s reads
entries [2^s, 2^(s+1))) and 1/N, built from ``NTTContext.tables()``.  Its
per-small-stage and roll tables, its lo/hi planes and ``rows_per_block``
laid the rows out for the TPU's lanes and have no counterpart.
"""

from __future__ import annotations

import torch

from ..device import get_device
from ..fields.field import GOLDILOCKS
from . import _build
from .fold import pointwise_mul
from .ntt import NTTContext

__all__ = ["GoldilocksKernelNTT", "ntt_stage", "ntt_tile", "ntt_stage_ref",
           "ntt_tile_ref", "LAUNCHES", "reset_launches", "LOG_TILE"]

F = GOLDILOCKS
# The stages a tile launch runs.  The kernel takes tiles up to 2^14 words
# (one block an SM); 2^13-word tiles let two blocks share an SM, and on an
# H100 that made the deg-2^16 mul faster despite one more pass a transform
# (PERF.md §6 has both timings).
LOG_TILE = 13

# mode bits of ntt_tile (csrc/ntt.cu)
_FWD, _PW_GLOBAL, _PW_TILE, _INV = 1, 2, 4, 8
MODES = {"forward": _FWD, "inverse": _INV,
         "mul_eval": _FWD | _PW_GLOBAL | _INV, "mul": _FWD | _PW_TILE | _INV}

LAUNCHES = {"ntt_stage": 0, "ntt_tile": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _stage(x, w, s, inverse):
    """Radix-2 stage s on rows [rows, N] (field ops, a new tensor)."""
    rows, N = x.shape
    m = 1 << s
    v = x.reshape(rows, m, 2, N >> (s + 1))
    a, b = v[:, :, 0], v[:, :, 1]
    tw = w[m:2 * m][None, :, None]
    if inverse:
        y0, y1 = F.add(a, b), F.mul(tw, F.sub(a, b))
    else:
        p = F.mul(tw, b)
        y0, y1 = F.add(a, p), F.sub(a, p)
    return torch.stack([y0, y1], dim=2).reshape(rows, N)


def ntt_stage_ref(x, w, s, *, inverse, ninv=None):
    """Plain twin of :func:`ntt_stage`."""
    y = _stage(x, w, s, inverse)
    return y if ninv is None else F.mul(y, F.const(ninv, x.device))


def ntt_tile_ref(x, wf, wi, ninv, log_tile, mode, other=None):
    """Plain twin of :func:`ntt_tile`: the tile's stages on whole rows."""
    logN = x.shape[1].bit_length() - 1
    stages = range(logN - log_tile, logN)
    bits = MODES[mode]
    if bits & _FWD:
        for s in stages:
            x = _stage(x, wf, s, False)
    if bits & _PW_TILE:
        for s in stages:
            other = _stage(other, wf, s, False)
    if bits & (_PW_GLOBAL | _PW_TILE):
        x = F.mul(x, other)
    if bits & _INV:
        for s in reversed(stages):
            x = _stage(x, wi, s, True)
        if log_tile == logN:
            x = F.mul(x, F.const(ninv, x.device))
    return x


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_rows(name, *xs):
    """Contiguous int64 [rows, N] tensors of one shape, N a power of two,
    within the kernels' grids."""
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int64 \
                or x.dim() != 2:
            raise TypeError(f"{name}: expected 2-D int64 tensors")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if x.shape != xs[0].shape:
            raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                             f"{tuple(xs[0].shape)} differ")
    rows, N = xs[0].shape
    if N < 2 or N & (N - 1):
        raise ValueError(f"{name}: row length {N} is not a power of two "
                         ">= 2")
    if rows * N // 2 >= 2**31 * 256:
        raise ValueError(f"{name}: {rows} rows of {N} exceed the grid")


def _check_table(name, w, N):
    if w.dtype != torch.int64 or w.shape != (N,) or not w.is_contiguous():
        raise ValueError(f"{name}: twiddle table must be a contiguous int64 "
                         f"[{N}] tensor, got {w.dtype} {tuple(w.shape)}")


def ntt_stage(x, w, s, *, inverse=False, ninv=None, inplace=False):
    """One radix-2 stage s over rows x [rows, N], twiddles ``w`` (the
    m + i table of its direction).  With ``ninv`` (an int, the inverse's
    last stage) both outputs are multiplied by it.  Returns a new tensor,
    or x itself, overwritten, with ``inplace``."""
    _check_rows("ntt_stage", x)
    rows, N = x.shape
    _check_table("ntt_stage", w, N)
    logN = N.bit_length() - 1
    if not 0 <= s < logN:
        raise ValueError(f"ntt_stage: stage {s} outside [0, {logN})")
    if not _build.on_cuda("ntt_stage", x, w):
        y = ntt_stage_ref(x, w, s, inverse=inverse, ninv=ninv)
        return x.copy_(y) if inplace else y
    dst = x if inplace else torch.empty_like(x)
    _build.launch(LAUNCHES, "ntt_stage", _build.kernels().srt_ntt_stage,
                  x.device, x.data_ptr(), dst.data_ptr(), w.data_ptr(),
                  0 if ninv is None else int(ninv), int(ninv is not None),
                  logN, s, rows, int(inverse))
    return dst


def ntt_tile(x, wf, wi, ninv, log_tile, mode, other=None, *,
             inplace=False):
    """The stages s >= logN - log_tile of every row x [rows, N], each
    aligned 2^log_tile-word tile in one block (its words in registers,
    exchanged through shared memory between rounds).  ``mode``:

    * ``"forward"``: the forward stages;
    * ``"inverse"``: the inverse stages (and x 1/N when the tile is the
      whole row);
    * ``"mul_eval"``: forward stages, times ``other`` (evaluations of the
      same shape), inverse stages (and x 1/N if whole row);
    * ``"mul"``: the whole fused ring multiply of rows x and ``other``
      (coefficients); needs the tile to be the row, and two rows in a
      tile's registers (2N <= 2^LOG_TILE).

    ``ninv`` is 1/N as an int.  Returns a new tensor, or x itself,
    overwritten, with ``inplace``."""
    if mode not in MODES:
        raise ValueError(f"ntt_tile: unknown mode {mode!r}")
    pw = mode in ("mul_eval", "mul")
    _check_rows("ntt_tile", x, *((other,) if pw else ()))
    rows, N = x.shape
    for w in (wf, wi):
        _check_table("ntt_tile", w, N)
    logN = N.bit_length() - 1
    if not 1 <= log_tile <= min(logN, LOG_TILE):
        raise ValueError(f"ntt_tile: log_tile {log_tile} outside [1, "
                         f"{min(logN, LOG_TILE)}]")
    if mode == "mul" and (log_tile != logN or 2 * N > 1 << LOG_TILE):
        raise ValueError(f"ntt_tile: mode 'mul' needs the whole row of two "
                         f"operands in a tile (2N <= 2^{LOG_TILE}), got "
                         f"N={N}, log_tile={log_tile}")
    if rows << (logN - log_tile) >= 2**31:
        raise ValueError(f"ntt_tile: {rows} rows of {N} exceed the grid")
    tensors = (x, wf, wi) + ((other,) if pw else ())
    if not _build.on_cuda("ntt_tile", *tensors):
        y = ntt_tile_ref(x, wf, wi, ninv, log_tile, mode, other)
        return x.copy_(y) if inplace else y
    dst = x if inplace else torch.empty_like(x)
    _build.launch(LAUNCHES, "ntt_tile", _build.kernels().srt_ntt_tile,
                  x.device, x.data_ptr(),
                  other.data_ptr() if pw else x.data_ptr(), dst.data_ptr(),
                  wf.data_ptr(), wi.data_ptr(), int(ninv), logN, log_tile,
                  rows, MODES[mode])
    return dst


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class GoldilocksKernelNTT:
    """Negacyclic radix-2 NTT of size N over Goldilocks on the CUDA kernels
    of ``csrc/ntt.cu`` (the reference's ``GoldilocksPallasNTT(N)``).

    ``forward``, ``inverse``, ``mul`` (fused), ``pointwise`` and
    ``mul_composite`` take int64 [B, N] (or [N]); every output equals
    ``NTTContext(F, N, negacyclic)``'s.  ``negacyclic=False`` runs the
    same kernels on the cyclic tables: the leaf-order cyclic transforms
    the four-step's local column and row NTTs use, and ``mul`` is then
    the cyclic product, as ``NTTContext.mul`` is."""

    def __init__(self, N: int, device="cuda", negacyclic: bool = True):
        self.device = get_device(device)
        self.ctx = NTTContext(F, N, negacyclic=negacyclic,
                              device=self.device)
        self.N, self.logN = N, self.ctx.logN
        self.log_tile = min(LOG_TILE, self.logN)
        self.passes = self.logN - self.log_tile   # stages in device memory
        fwd, inv, n_inv = self.ctx.tables()
        zero = F.zeros((1,), self.device)
        self.wf = torch.cat([zero, *fwd])
        self.wi = torch.cat([zero, *inv])
        self.ninv = int(F.decode(n_inv))

    def tables(self):
        """(forward table, inverse table) int64 [N] in the m + i layout,
        and 1/N as an int."""
        return self.wf, self.wi, self.ninv

    # -- plane conversion (bit views, no arithmetic) -------------------------
    @staticmethod
    def to_planes(x):
        """int64 storage [...] -> (lo, hi): the low and high u32 halves of
        each word as int32 bit patterns [...] (the port's u32 storage)."""
        v = x.contiguous().unsqueeze(-1).view(torch.int32)   # [..., 2]
        return v[..., 0], v[..., 1]

    @staticmethod
    def from_planes(lo, hi):
        """(lo, hi) int32 halves -> the int64 words they make."""
        return torch.stack([lo, hi], dim=-1).view(torch.int64)[..., 0]

    def _rows(self, x):
        if x.shape[-1] != self.N:
            raise ValueError(f"expected rows of {self.N}, got "
                             f"{tuple(x.shape)}")
        return x.reshape(-1, self.N).contiguous()

    def _tile(self, x, mode, other=None, inplace=False):
        return ntt_tile(x, self.wf, self.wi, self.ninv, self.log_tile, mode,
                        other, inplace=inplace)

    def _fwd_passes(self, x):
        """The forward stages in device memory (passes >= 1); a new
        tensor."""
        y = ntt_stage(x, self.wf, 0)
        for s in range(1, self.passes):
            ntt_stage(y, self.wf, s, inplace=True)
        return y

    def _inv_passes(self, y):
        """The inverse stages in device memory, in place, 1/N on the last."""
        for s in reversed(range(self.passes)):
            ntt_stage(y, self.wi, s, inverse=True,
                      ninv=self.ninv if s == 0 else None, inplace=True)
        return y

    def _forward_rows(self, x):
        if not self.passes:
            return self._tile(x, "forward")
        y = self._fwd_passes(x)
        return self._tile(y, "forward", inplace=True)

    def forward(self, x):
        """Coefficients -> leaf-order evaluations."""
        return self._forward_rows(self._rows(x)).reshape(x.shape)

    def inverse(self, x):
        """Leaf-order evaluations -> coefficients."""
        y = self._tile(self._rows(x), "inverse")
        return self._inv_passes(y).reshape(x.shape)

    def mul(self, a, b):
        """Fused negacyclic ring multiply (one launch when 2N <=
        2^LOG_TILE)."""
        if a.shape != b.shape:
            raise ValueError(f"mul: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)} differ")
        ra, rb = self._rows(a), self._rows(b)
        if not self.passes and 2 * self.N <= 1 << LOG_TILE:
            return self._tile(ra, "mul", rb).reshape(a.shape)
        fb = self._forward_rows(rb)
        if not self.passes:
            return self._tile(ra, "mul_eval", fb).reshape(a.shape)
        y = self._fwd_passes(ra)
        self._tile(y, "mul_eval", fb, inplace=True)
        return self._inv_passes(y).reshape(a.shape)

    def pointwise(self, fa, fb):
        """Slot product of two evaluation tensors of one shape (the
        ``pointwise_mul`` kernel)."""
        return pointwise_mul(fa.contiguous(), fb.contiguous())

    def mul_composite(self, a, b):
        """inverse(pointwise(forward a, forward b)) as separate launches."""
        return self.inverse(self.pointwise(self.forward(a), self.forward(b)))
