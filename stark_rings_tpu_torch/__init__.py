"""stark_rings_tpu_torch: the PyTorch/CUDA port of stark_rings_tpu.

The JAX package ``stark_rings_tpu`` is the reference; this package
mirrors its module layout and imports ``torch`` and numpy, never JAX.
It holds the Goldilocks, BabyBear, frog and 8-limb stark prime fields,
the four cyclotomic ring models over them (``RingModel``, ``Rq``, the
batch-trailing multiply ``TModelMul``), the power-of-two negacyclic
rings (deg 2^16 Goldilocks, deg 2^12 BabyBear and stark_prime on the
main paths; frog at deg 2 and 4), the Goldilocks MLE and
sumcheck path, sumcheck over BabyBear and frog and over batched
claims, the single-device Goldilocks NTT engines (radix-2 and the
deg-2^14 digit-product four-step), the sharded four-step NTT with its
exchange kernel K8 (deg 2^20 on P shards of one card), balanced
decomposition, the dense ring ``Matrix`` and the folding protocol
(``FoldingStep``, ``FoldingTree``):

    spec/         the integer spec of the four ring models (a copy of
                  the reference's pure-Python spec/)
    fields/       Goldilocks (int64 u64 bits), BabyBear (int32 u32
                  Montgomery), frog (int64 u64 Montgomery), stark_prime
                  (int32 [..., 8] u32 Montgomery limbs), get_field
    ops/stages.py, ops/dense_linear.py  the models' CRT as probed stage
                  tables and dense matrices (the oracles)
    ops/mxu_dense.py the models' CRT as one digit GEMM and a fold (K3,
                  K4's bb_fold_end, frog's REDC); Mont64PrescaledMat
    ops/model_mul.py TModelMul, the batch-trailing model multiply
    ops/ntt.py    the radix-2/4 NTTContext, find_primitive_root
    ops/mxu2.py   digit tables, digit GEMM, plain Mxu2NTT
    ops/mxu_bb.py BabyBear digit tables and the plain MxuBBNTT
    ops/stark.py  the stark prime's kernels S1 (CIOS product), S2
                  (add, sub), S3 (limb fold): wrappers + plain twins
    ops/mxu_limb.py LimbPrescaledMat and the four-step MxuLimbNTT
    ops/fold.py   fold kernels K1-K3, the pointwise and chain kernels
                  (wrappers + plain twins), the fused engine Mxu2FusedNTT
                  and the evaluation-domain engine Mxu2KernelNTT
    ops/fold_bb.py BabyBear fold kernels K4 and MxuBBFusedNTT
    ops/goldilocks_ntt.py the radix-2 engine GoldilocksKernelNTT on the
                  NTT tile and pass kernels
    ops/mxu.py    7-bit digit MxuModMat and the deg-2^14 MatmulNTT
    ops/mxu_fused.py the fused mod-mat kernel, MxuModMatFused
    ops/_build.py builds and loads csrc/, the wrappers' launch rule
    decomp/       balanced and gadget decomposition, the exact L2 words
                  and norm checks
    linalg/       the element adapters FieldElems, RingElems,
                  RingCoeffElems; the dense ring Matrix (k-blocked
                  mul_mat), the COO SparseMatrix (mat-vec by the
                  field's segment_sum, sparse x sparse), the packed
                  SymmetricMatrix, transpose, rounded division,
                  AlgebraError
    protocol/     the composed folding step FoldingStep (ntt_matvec, the
                  blocked commit) and the folding tree FoldingTree with
                  its verifier
    mle/          DenseMLE (from_matrix), SparseMLE and helpers,
                  ArithError; the generic sumcheck prover
                  (sumcheck.py); kernels K5 evaluate / K6 fix-last
                  (fix.py) and the one-pass prover K7 over all three
                  fields, one claim or a batch (sumcheck_kernel.py);
                  digit-GEMM evaluation (mxu_eval)
    rings/        RingModel / get_ring, Rq, monomial, sampling;
                  PowerRing / get_power_ring (mxu_ctx, fourstep_ctx); the
                  SHAKE-256 Fiat-Shamir Transcript
    models/       the lazy registry alias of rings
    parallel/     make_mesh (P shards on one card or one per card), the
                  sharded four-step ShardedNTT and K8, the twiddle-fused
                  exchange (wrappers + plain twins)
    utils/        the arkworks byte layouts of vectors, matrices and
                  MLEs; checkpoints of storage tensors (.npz); tracing
                  spans at the layer boundaries, ranges in the
                  profiler's timeline while one records, a shared no-op
                  otherwise
    errors.py     ConversionError and the re-exported error types
    examples/     the sumcheck protocol (prove / verify), the Ajtai
                  commitment, the folding step and tree, the big-ring
                  fold combine
    csrc/         the CUDA kernels (built by nvcc at first use)
    native/       the JAX-free loader of the C++ host oracles (schoolbook
                  multiplies, HostGoldilocks / HostRing NTTs)

Storage is described in :mod:`.device`.  Every entry point runs on the
CUDA card unless the caller passes ``device="cpu"``.
"""

from . import (decomp, fields, linalg, mle, ops, parallel, protocol, rings,
               spec, utils)
from .decomp import (decompose, gadget_decompose, gadget_recompose,
                     recompose)
from .device import (from_jax_storage, get_device, to_numpy_storage,
                     to_numpy_u32, to_numpy_u64, to_torch, to_torch_u32)
from .errors import ConversionError
from .fields import BABYBEAR, FIELDS, FROG, GOLDILOCKS, STARK, get_field
from .linalg import (AlgebraError, FieldElems, Matrix, RingElems,
                     SparseMatrix, SymmetricMatrix)
from .mle import ArithError, DenseMLE, SparseMLE
from .ops.fold import Mxu2FusedNTT, Mxu2KernelNTT
from .ops.fold_bb import MxuBBFusedNTT
from .ops.goldilocks_ntt import GoldilocksKernelNTT
from .ops.mxu import MatmulNTT, MxuModMat
from .ops.mxu_fused import MxuModMatFused
from .ops.mxu2 import Mxu2NTT, PrescaledMat, from_jax_consts
from .ops.mxu_bb import MxuBBNTT
from .ops.mxu_limb import LimbPrescaledMat, MxuLimbNTT
from .ops.model_mul import TModelMul
from .ops.ntt import NTTContext, get_ntt
from .parallel import Mesh, ShardedNTT, make_mesh
from .protocol import FoldingStep, FoldingTree
from .rings import RINGS, RingModel, Rq, get_ring
from .rings.power import PowerRing, get_power_ring

__all__ = ["get_device", "to_torch", "to_numpy_u64", "to_torch_u32",
           "to_numpy_u32", "from_jax_storage", "to_numpy_storage",
           "GOLDILOCKS", "BABYBEAR", "FROG", "STARK", "get_field",
           "Mxu2NTT", "Mxu2FusedNTT", "Mxu2KernelNTT", "MxuBBNTT",
           "MxuBBFusedNTT", "PrescaledMat", "from_jax_consts",
           "LimbPrescaledMat", "MxuLimbNTT",
           "GoldilocksKernelNTT", "MatmulNTT", "MxuModMat", "MxuModMatFused",
           "NTTContext", "get_ntt", "PowerRing", "get_power_ring",
           "Mesh", "make_mesh", "ShardedNTT", "RingModel", "Rq", "get_ring",
           "TModelMul",
           # the reference's top-level names (stark_rings_tpu/__init__.py)
           "fields", "rings", "decomp", "linalg", "mle", "ops", "parallel",
           "protocol", "spec", "utils", "FoldingStep", "FoldingTree",
           "FIELDS", "RINGS", "Matrix", "SparseMatrix", "SymmetricMatrix",
           "FieldElems", "RingElems", "DenseMLE", "SparseMLE", "decompose",
           "recompose", "gadget_decompose", "gadget_recompose",
           "AlgebraError", "ArithError", "ConversionError"]
