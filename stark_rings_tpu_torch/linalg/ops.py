"""Transpose / rounded division (counterpart of
``stark_rings_tpu/linalg/ops.py``; reference linear_algebra/src/ops.rs)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["transpose", "rounded_div_torch", "pad_ragged"]


def transpose(vals, elem_ndim: int):
    """Transpose the two leading (row, col) axes of a matrix-of-elements
    tensor (ops.rs:9-62).  Element axes (trailing) are untouched."""
    return torch.swapaxes(vals, 0, 1)


def pad_ragged(rows, elem_shape, dtype):
    """Pad a list of unequal-length per-row element arrays with zeros
    (Transpose for Vec<Vec<R>>, ops.rs:13-34) -> rectangular np array."""
    ncols = max((len(r) for r in rows), default=0)
    out = np.zeros((len(rows), ncols) + tuple(elem_shape), dtype=dtype)
    for i, r in enumerate(rows):
        if len(r):
            out[i, : len(r)] = r
    return out


def rounded_div_torch(a, b):
    """Round-half-away-from-zero signed integer division (ops.rs:64-80);
    the counterpart of the reference's ``rounded_div_jnp``.

    a, b: integer tensors or ints (b may be a scalar)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    abs_a, abs_b = a.abs(), b.abs()
    mag = (abs_a + abs_b // 2) // abs_b
    return torch.where((a < 0) != (b < 0), -mag, mag)
