"""Norms over signed representatives (counterpart of
``stark_rings_tpu/decomp/norms.py``; reference traits.rs:6-56: WithL2Norm
and WithLinfNorm return BigUint).

The host norms return Python ints.  :func:`l2_norm_squared_words` is the
device L2: the exact (NOT mod q) sum of squared signed magnitudes as
little-endian base-2^32 words, so a witness norm check never goes
through host object arrays.  Squaring is a word convolution of the
base-2^32 magnitude words (every partial product below 2^64 splits into
two terms below 2^32), followed by one carry normalization.

Word tensors are ``int64`` holding u64 bits: a product of two 32-bit
words and a long sum of words may pass 2^63, so every ``>> 32`` is the
logical :func:`~..fields.field.shr` and the sums wrap exactly as the
reference's uint64 sums do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, to_numpy_u64
from ..fields.field import MASK32, shr
from ..spec.field import to_signed

__all__ = [
    "l2_norm_squared", "linf_norm_exact",
    "l2_norm_squared_words", "words_to_int", "int_to_words", "l2_check",
]


def _signed_iter(f, x):
    for v in np.asarray(f.decode(x), dtype=object).reshape(-1):
        yield to_signed(int(v), f.q)


def l2_norm_squared(f, x) -> int:
    """Sum of squared signed representatives (WithL2Norm), on the host."""
    return sum(s * s for s in _signed_iter(f, x))


def linf_norm_exact(f, x) -> int:
    """max |signed representative| (WithLinfNorm), on the host."""
    return max((abs(s) for s in _signed_iter(f, x)), default=0)


def _square_words(w):
    """Exact square of a base-2^32 word vector: int64 [..., W] (words
    < 2^32) -> int64 [..., 2W+1] unnormalized words (each < ~2^37)."""
    W = w.shape[-1]
    acc = [None] * (2 * W + 1)

    def _add(k, v):
        acc[k] = v if acc[k] is None else acc[k] + v

    for i in range(W):
        for j in range(i, W):
            p = w[..., i] * w[..., j]          # < 2^64: exact as u64 bits
            lo, hi = p & MASK32, shr(p, 32)
            for _ in range(1 if j == i else 2):   # 2p would overflow; split
                _add(i + j, lo)
                _add(i + j + 1, hi)
    zero = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
    return torch.stack([a if a is not None else zero for a in acc], dim=-1)


def _normalize_words(words, extra: int = 2):
    """Carry-propagate unnormalized u64 words into base-2^32 little-endian
    digits (each below 2^32), appending ``extra`` overflow words."""
    digits = []
    carry = torch.zeros_like(words[..., 0])
    for j in range(words.shape[-1]):
        s = words[..., j] + carry
        digits.append(s & MASK32)
        carry = shr(s, 32)
    for _ in range(extra):
        digits.append(carry & MASK32)
        carry = shr(carry, 32)
    return torch.stack(digits, dim=-1)


def l2_norm_squared_words(f, x, axis=None, chunk_n=None):
    """Exact sum of squared signed magnitudes on the device.

    Returns normalized little-endian base-2^32 words int64 [..., W_out]
    whose integer value equals :func:`l2_norm_squared` over the reduced
    axes (axis=None reduces every element axis; an int or a tuple keeps
    the others batched, as folding provers need).  Decode on the host
    with :func:`words_to_int`.

    Each unnormalized square word holds at most 2W terms below 2^32, so
    one u64 sum stays exact up to 2^32 / (2W) reduced elements.  Past
    that bound (or past ``chunk_n``, the test hook that forces it) the
    reduction runs in chunks with a carry normalization after each: the
    same integer, so the same words as the reference's."""
    from .balanced import signed_magnitude

    _, mag = signed_magnitude(f, x)
    w = f.widen(mag)                      # int64 [..., elem..., W]
    sq = _square_words(w)                 # [..., elem..., 2W+1]
    if axis is None:
        red = tuple(range(sq.dim() - 1))
    else:
        if isinstance(axis, int):
            axis = (axis,)
        red = tuple(a % (sq.dim() - 1) for a in axis)
    if not red:
        return _normalize_words(sq)
    n_red = 1
    for a in red:
        n_red *= sq.shape[a]
    safe_n = (1 << 32) // (2 * w.shape[-1])   # n * 2W * (2^32 - 1) < 2^64
    if chunk_n is not None:
        safe_n = int(chunk_n)
    if n_red <= safe_n:
        return _normalize_words(sq.sum(dim=red))
    # chunked exact reduction: the reduced axes flattened to the front,
    # each chunk's partial sum normalized before the partials are added
    sq = torch.movedim(sq, red, tuple(range(len(red))))
    sq = sq.reshape((n_red,) + tuple(sq.shape[len(red):]))
    partials = [_normalize_words(sq[s0:s0 + safe_n].sum(dim=0))
                for s0 in range(0, n_red, safe_n)]
    # normalized words are below 2^32 and the chunks far fewer than 2^32,
    # so one more plain sum over the partials is exact
    return _normalize_words(sum(partials[1:], start=partials[0]))


def words_to_int(words) -> int:
    """Host decode: little-endian base-2^32 words -> Python int."""
    w = (to_numpy_u64(words) if isinstance(words, torch.Tensor)
         else np.asarray(words, dtype=np.uint64))
    assert w.ndim == 1, "pass one norm's words (index batched results)"
    return sum(int(d) << (32 * j) for j, d in enumerate(w))


def int_to_words(v: int, n_words: int, device="cuda"):
    """Host encode: Python int -> int64 [n_words] base-2^32 words."""
    assert 0 <= v < 1 << (32 * n_words), (v, n_words)
    return torch.tensor([(v >> (32 * j)) & MASK32 for j in range(n_words)],
                        dtype=torch.int64, device=get_device(device))


def l2_check(f, x, bound_sq: int, axis=None):
    """Device norm check ||x||_2^2 <= bound_sq, elementwise over the
    non-reduced axes: a lexicographic word compare, most significant
    word first, with no host round trip.  A bound too large for the
    norm's word count always holds."""
    words = l2_norm_squared_words(f, x, axis=axis)
    W = words.shape[-1]
    shape = words.shape[:-1]
    if bound_sq >= 1 << (32 * W):
        return torch.ones(shape, dtype=torch.bool, device=words.device)
    le = torch.ones(shape, dtype=torch.bool, device=words.device)
    decided = torch.zeros_like(le)
    for j in reversed(range(W)):
        bj = (bound_sq >> (32 * j)) & MASK32   # words < 2^32: signed compare
        lt = words[..., j] < bj
        gt = words[..., j] > bj
        le = torch.where(~decided & lt, True,
                         torch.where(~decided & gt, False, le))
        decided = decided | lt | gt
    return le
