"""Linear-algebra layer of the PyTorch port (counterpart of
``stark_rings_tpu/linalg/``): the element adapters, the dense ring
``Matrix``, the COO ``SparseMatrix``, the packed ``SymmetricMatrix`` and
its G^T M G recomposition, transpose and rounded division."""


class AlgebraError(ValueError):
    """Mirror of AlgebraError::DifferentLengths
    (linear_algebra/src/error.rs:4-8)."""


from .elems import FieldElems, RingCoeffElems, RingElems  # noqa: E402
from .matrix import Matrix  # noqa: E402
from .ops import pad_ragged, rounded_div_torch, transpose  # noqa: E402
from .sparse import SparseMatrix  # noqa: E402
from .symmetric import (SymmetricMatrix,  # noqa: E402
                        recompose_left_right_symmetric_matrix)

__all__ = ["Matrix", "SparseMatrix", "SymmetricMatrix", "FieldElems",
           "RingElems", "RingCoeffElems", "transpose", "rounded_div_torch",
           "pad_ragged", "recompose_left_right_symmetric_matrix",
           "AlgebraError"]
