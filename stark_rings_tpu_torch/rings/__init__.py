"""Ring layer of the PyTorch port: the Fiat-Shamir transcript so far."""

from .absorb import Transcript, elem_nbytes, elements_to_bytes, to_absorb

__all__ = ["Transcript", "elem_nbytes", "elements_to_bytes", "to_absorb"]
