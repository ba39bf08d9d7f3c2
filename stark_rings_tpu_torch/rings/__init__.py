"""Ring layer of the PyTorch port: the cyclotomic ring models
(goldilocks, babybear, frog) with ``Rq`` elements, monomial algebra and
sampling, the power-of-two rings, and the Fiat-Shamir transcript."""

from . import absorb, monomial, sampling
from .absorb import Transcript, elem_nbytes, elements_to_bytes, to_absorb
from .element import Rq
from .power import PowerRing, get_power_ring
from .ring import RINGS, RingModel, get_ring

__all__ = ["RingModel", "get_ring", "RINGS", "Rq", "PowerRing",
           "get_power_ring", "monomial", "sampling", "absorb", "Transcript",
           "elem_nbytes", "elements_to_bytes", "to_absorb"]
