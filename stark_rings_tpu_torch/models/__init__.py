"""Model registry: the alias of :mod:`..rings` (counterpart of
``stark_rings_tpu/models/__init__.py``).

    >>> from stark_rings_tpu_torch.models import goldilocks
    >>> goldilocks.D, goldilocks.N, goldilocks.E
    (24, 8, 3)

The model names resolve on first access, through ``get_ring(name)`` on
the default device, the CUDA card: building a ring at import would need
a card.  ``MODELS`` maps each of the four models' names to its ring.
"""

from ..rings import PowerRing, RingModel, get_power_ring, get_ring

_NAMES = ("goldilocks", "babybear", "frog", "stark_prime")

__all__ = [*_NAMES, "MODELS", "RingModel", "PowerRing", "get_ring",
           "get_power_ring"]


def __getattr__(name):
    if name in _NAMES:
        return get_ring(name)
    if name == "MODELS":
        return {n: get_ring(n) for n in _NAMES}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
