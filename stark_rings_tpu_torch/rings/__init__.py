"""Ring layer of the PyTorch port: the power-of-two rings and the
Fiat-Shamir transcript so far."""

from .absorb import Transcript, elem_nbytes, elements_to_bytes, to_absorb
from .power import PowerRing, get_power_ring

__all__ = ["Transcript", "elem_nbytes", "elements_to_bytes", "to_absorb",
           "PowerRing", "get_power_ring"]
