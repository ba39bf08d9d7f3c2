"""Multilinear extension layer of the PyTorch port (counterpart of
``stark_rings_tpu/mle``): dense and sparse MLEs over any scalar field
or ring elements, the HyperPlonk helpers, the generic sumcheck prover
(``sumcheck``), kernels K5 and K6 for Goldilocks (``fix``), the
one-pass prover K7 over Goldilocks, BabyBear and frog, and its
Goldilocks batch of claims (``sumcheck_kernel``), and the digit-GEMM
evaluation (``mxu_eval``)."""

from .dense import DenseMLE
from .polynomials import (
    evaluate_opt,
    fix_last_variables,
    fix_variables,
    identity_permutation,
    identity_permutation_mles,
    merge_polynomials,
    random_mle_list,
    random_permutation,
    random_permutation_mles,
    random_zero_mle_list,
)
from .sparse import SparseMLE
from .sumcheck import (
    bit_reverse_table,
    sumcheck_prove_many_with_challenges,
)
from .sumcheck_kernel import (
    sumcheck_prove_batch_goldilocks,
    sumcheck_prove_many,
)
from .util import (
    bit_decompose,
    gen_eval_point_bits,
    get_batched_nv,
    get_index,
    project,
    swap_bits,
)

__all__ = [
    "DenseMLE", "SparseMLE", "ArithError",
    "random_mle_list", "random_zero_mle_list",
    "identity_permutation", "identity_permutation_mles",
    "random_permutation", "random_permutation_mles",
    "evaluate_opt", "fix_variables", "fix_last_variables",
    "merge_polynomials",
    "bit_decompose", "project", "get_index", "get_batched_nv",
    "gen_eval_point_bits", "swap_bits",
    "sumcheck_prove_many_with_challenges", "bit_reverse_table",
    "sumcheck_prove_many", "sumcheck_prove_batch_goldilocks",
]


class ArithError(ValueError):
    """Mirror of ArithErrors (polynomials/errors.rs:13-21)."""
