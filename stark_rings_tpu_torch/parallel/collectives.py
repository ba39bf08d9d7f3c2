"""Exact cross-shard sums of widened words (counterpart of
``stark_rings_tpu/parallel/collectives.py``).

Big modular sums widen storage to base-2^32 words (``Field.widen``),
add them as integers and fold back mod q once (``Field.reduce_words``).
Across shards the partial word sums meet in :func:`psum_words`: one
int64 add per shard, which wraps mod 2^64 exactly as the reference's
``uint64`` words do.  The reference splits each word into four 16-bit
chunks first, because the TPU's all-reduce lowers only 32-bit sums
(its docstring); torch's int64 add has no such limit, so the words are
summed as they are (ROADMAP queue 3, deliberate differences).
"""

from __future__ import annotations

import torch

__all__ = ["psum_words"]


def psum_words(words):
    """Exact sum mod 2^64 of P int64 word tensors of one shape (u64 bits;
    one a shard), as one tensor on the first shard's device.  The
    widened-accumulation invariant keeps the true total below 2^64, so
    the wrapped sum is the total."""
    words = list(words)
    if not words:
        raise ValueError("psum_words: no shards")
    dev, shape = words[0].device, words[0].shape
    for w in words:
        if w.dtype != torch.int64 or w.shape != shape:
            raise ValueError(f"psum_words: expected int64 {list(shape)} "
                             f"words, got {w.dtype} {list(w.shape)}")
    total = words[0]
    for w in words[1:]:
        total = total + w.to(dev)
    return total
