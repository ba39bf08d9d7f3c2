"""Prime-field layer of the PyTorch port: Goldilocks only so far."""

from .field import GOLDILOCKS, Goldilocks

__all__ = ["GOLDILOCKS", "Goldilocks"]
