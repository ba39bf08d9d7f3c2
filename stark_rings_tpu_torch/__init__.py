"""stark_rings_tpu_torch: the PyTorch/CUDA port of stark_rings_tpu.

The JAX package ``stark_rings_tpu`` is the reference; this package
mirrors its module layout and imports ``torch`` and numpy, never JAX.
So far it holds the deg-2^16 Goldilocks negacyclic ring multiply and
the Goldilocks MLE and sumcheck path:

    fields/       Goldilocks arithmetic on int64 tensors of u64 bits
    ops/ntt.py    find_primitive_root
    ops/mxu2.py   digit tables, digit GEMM, plain Mxu2NTT
    ops/fold.py   fold kernels K1-K3 (wrappers + plain twins) and the
                  fused engine Mxu2FusedNTT
    ops/_build.py builds and loads csrc/, the wrappers' launch rule
    linalg/       the field-element adapter FieldElems
    mle/          DenseMLE and helpers; the generic sumcheck prover
                  (sumcheck.py); kernels K5 evaluate / K6 fix-last
                  (fix.py) and the one-pass prover K7
                  (sumcheck_kernel.py); digit-GEMM evaluation (mxu_eval)
    rings/        the SHAKE-256 Fiat-Shamir Transcript
    examples/     the sumcheck protocol (prove / verify)
    csrc/         the CUDA kernels (built by nvcc at first use)
    native/       the JAX-free loader of the C++ host oracle

A field element is a ``torch.int64`` tensor holding the u64 bit pattern
(see :mod:`.device`).
"""

from .device import get_device, to_numpy_u64, to_torch
from .fields import GOLDILOCKS
from .ops.fold import Mxu2FusedNTT
from .ops.mxu2 import Mxu2NTT, PrescaledMat, from_jax_consts

__all__ = ["get_device", "to_torch", "to_numpy_u64", "GOLDILOCKS",
           "Mxu2NTT", "Mxu2FusedNTT", "PrescaledMat", "from_jax_consts"]
