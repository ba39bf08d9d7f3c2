"""Balanced (gadget) decomposition layer of the PyTorch port (counterpart
of ``stark_rings_tpu/decomp/``; reference
crates/ring/src/balanced_decomposition/)."""

from .balanced import (
    center,
    decompose,
    decompose_ring,
    decomposition_max_length,
    gadget_decompose,
    gadget_recompose,
    linf_norm,
    recompose,
    recompose_ring,
    sign,
    signed_magnitude,
)
from .norms import (
    l2_check,
    l2_norm_squared,
    l2_norm_squared_words,
    linf_norm_exact,
    words_to_int,
)

__all__ = [
    "decompose", "recompose", "decompose_ring", "recompose_ring",
    "gadget_decompose", "gadget_recompose", "decomposition_max_length",
    "center", "sign", "signed_magnitude", "linf_norm",
    "l2_norm_squared", "l2_norm_squared_words", "l2_check",
    "words_to_int", "linf_norm_exact",
]
