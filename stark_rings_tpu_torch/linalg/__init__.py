"""Linear-algebra layer of the PyTorch port (counterpart of
``stark_rings_tpu/linalg/``): the element adapters, the dense ring
``Matrix``, transpose and rounded division.  ``SparseMatrix`` and
``SymmetricMatrix`` come with ROADMAP queue 1 step 5."""


class AlgebraError(ValueError):
    """Mirror of AlgebraError::DifferentLengths
    (linear_algebra/src/error.rs:4-8)."""


from .elems import FieldElems, RingCoeffElems, RingElems  # noqa: E402
from .matrix import Matrix  # noqa: E402
from .ops import pad_ragged, rounded_div_torch, transpose  # noqa: E402

__all__ = ["Matrix", "FieldElems", "RingElems", "RingCoeffElems",
           "transpose", "rounded_div_torch", "pad_ragged", "AlgebraError"]
