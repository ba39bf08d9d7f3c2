"""The sharded layer (counterpart of ``stark_rings_tpu/parallel``): a
mesh of P shards (P shards of one card, or one a card) and, over it,
the sharded four-step NTT with its twiddle-fused exchange kernel K8,
the exact cross-shard word sum ``psum_words``, the sharded dense MLE
and sumcheck (``ShardedMLE``: K5 and K7 per shard on the card), the
column- and nnz-sharded mat-vecs and the batch-sharded model multiply.
Sharded data is a list of P shard tensors; the witness-sharded folding
step and tree are ``FoldingStep.make_sharded_step_fn`` and
``FoldingTree.prove_sharded`` in :mod:`..protocol`."""

from .collectives import psum_words
from .exchange import (EXCHANGE_FIELDS, all_to_all, twiddle_exchange_fwd,
                       twiddle_exchange_fwd_ref, twiddle_exchange_inv,
                       twiddle_exchange_inv_ref)
from .linalg import ShardedMatVec, ShardedSparseMatVec
from .mesh import Mesh, gather, make_mesh, shard
from .mle import ShardedMLE
from .model import ShardedModelMul
from .ntt import ShardedNTT

__all__ = ["make_mesh", "ShardedNTT", "ShardedMLE", "ShardedMatVec",
           "ShardedSparseMatVec", "ShardedModelMul", "psum_words", "Mesh",
           "shard", "gather", "twiddle_exchange_fwd", "twiddle_exchange_inv",
           "twiddle_exchange_fwd_ref", "twiddle_exchange_inv_ref",
           "all_to_all", "EXCHANGE_FIELDS"]
