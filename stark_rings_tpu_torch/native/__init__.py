"""Native host code: the JAX-free loader of the C++ oracle (schoolbook
multiplies, the HostGoldilocks / HostRing NTTs), built on first use."""

from .host import HostGoldilocks, HostRing, get_host_lib

__all__ = ["HostGoldilocks", "HostRing", "get_host_lib"]
