"""The sharded layer (counterpart of ``stark_rings_tpu/parallel``): a
mesh of P shards, the sharded four-step NTT and its twiddle-fused
exchange kernel K8.  ``ShardedMLE``, the sharded linear algebra and
model multiply are not ported yet (ROADMAP queue 1 step 6)."""

from .exchange import (EXCHANGE_FIELDS, all_to_all, twiddle_exchange_fwd,
                       twiddle_exchange_fwd_ref, twiddle_exchange_inv,
                       twiddle_exchange_inv_ref)
from .mesh import Mesh, make_mesh
from .ntt import ShardedNTT

__all__ = ["Mesh", "make_mesh", "ShardedNTT", "twiddle_exchange_fwd",
           "twiddle_exchange_inv", "twiddle_exchange_fwd_ref",
           "twiddle_exchange_inv_ref", "all_to_all", "EXCHANGE_FIELDS"]
