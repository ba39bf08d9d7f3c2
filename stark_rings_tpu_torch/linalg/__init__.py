"""Linear-algebra layer of the PyTorch port: the base-field element
adapter so far."""

from .elems import FieldElems

__all__ = ["FieldElems"]
