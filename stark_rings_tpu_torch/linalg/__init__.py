"""Linear-algebra layer of the PyTorch port: the element adapters so
far."""

from .elems import FieldElems, RingCoeffElems, RingElems

__all__ = ["FieldElems", "RingElems", "RingCoeffElems"]
