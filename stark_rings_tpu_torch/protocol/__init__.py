"""Protocol layer of the PyTorch port (counterpart of
``stark_rings_tpu/protocol/``): the composed folding step and the
folding tree over the ring models.  The reference composes its pieces
(challenge multiply, gadget decomposition, range and norm checks, Ajtai
commitment) into one jitted module a step; here a step is a chain of
torch ops and fold kernels on the ring's device."""

from .folding import FoldingStep, ntt_matvec
from .tree import FoldingTree

__all__ = ["FoldingStep", "FoldingTree", "ntt_matvec"]
