"""Utilities of the PyTorch port (counterpart of
``stark_rings_tpu/utils``): the arkworks byte layouts, checkpoints of
storage tensors, and tracing spans."""

from .checkpoint import load_tensors, save_tensors
from .serialize import (
    dense_mle_from_bytes,
    dense_mle_to_bytes,
    deserialize_compressed,
    deserialize_compressed_unchecked,
    deserialize_uncompressed,
    deserialize_uncompressed_unchecked,
    elem_nbytes,
    elements_from_bytes,
    elements_to_bytes,
    matrix_from_bytes,
    matrix_to_bytes,
    serialize_compressed,
    serialize_uncompressed,
    sparse_matrix_from_bytes,
    sparse_matrix_to_bytes,
    sparse_mle_from_bytes,
    sparse_mle_to_bytes,
    vec_from_bytes,
    vec_to_bytes,
)
from .trace import trace_span

__all__ = [
    "elem_nbytes", "elements_to_bytes", "elements_from_bytes",
    "vec_to_bytes", "vec_from_bytes", "trace_span",
    "save_tensors", "load_tensors",
    "matrix_to_bytes", "matrix_from_bytes",
    "sparse_matrix_to_bytes", "sparse_matrix_from_bytes",
    "dense_mle_to_bytes", "dense_mle_from_bytes",
    "sparse_mle_to_bytes", "sparse_mle_from_bytes",
    "serialize_compressed", "serialize_uncompressed",
    "deserialize_compressed", "deserialize_compressed_unchecked",
    "deserialize_uncompressed", "deserialize_uncompressed_unchecked",
]
