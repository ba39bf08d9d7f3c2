#!/usr/bin/env python3
"""Check the PyTorch port on one NVIDIA Hopper card, in three steps.

1. build: nvcc builds the kernels of ``stark_rings_tpu_torch/csrc`` into
   one library; a fresh build prints ptxas's registers and spills, per
   kernel.
2. card tests: the ``cuda``-marked tests of ``tests/test_torch_cuda.py``,
   the port's one suite of on-card checks, in a child process::

       python -m pytest --noconftest -o addopts="" -m cuda \\
           tests/test_torch_cuda.py

   The script fails when they fail.
3. kernel table: one row per launch name of the port's ``LAUNCHES``
   counters.  First each main-path call runs once at its shape, every
   counter set to 0 just before it: the five cells' calls (the
   ``gl-pow16-mul-B80`` multiply, the D = 24 ``mul_t`` at B = 2^18, and
   the D = 24, D = 72 and stark_prime D = 16 folding steps at L = 16,384,
   W = 16) and the calls PERF.md's kernel table names for the kernels no
   cell runs.
   Each call's launches, by name, must be what that table gives; a row's
   ``launches`` is its kernel's count on its path.  Then each kernel
   alone at the shape of its main path: one call through its wrapper,
   its output against its plain twin's word for word, and its time
   against the twin's and against its bound.  The bound is the larger
   of the bytes the call must move (each input read once, each output
   written once) at the card's memory rate and, where a kernel is bound
   by operations, its operations at their rate: the int8 tensor rate for
   ``mxu_mod_mat``'s digit products, the SMs' issue rate for the SASS
   instructions of the others.

Run from the root of a checkout, on a machine with one CUDA card of
compute capability 9.x and ``nvcc``::

    python3 chip_smoke.py

The next to last line is the kernels' JSON record, ``{"kernels": [...]}``:
per kernel its name, route, source, the reference code it replaces, its
launches a main-path call, its largest error against its twin, its time
and its twin's (CUDA-event medians), and its bound.  The last line is ``{"ok":
true, "device": {...}}``.  Without a CUDA card the script fails before
printing any result.  End-to-end numbers are the benchmark's
(``portbench/``, ``BENCHMARK.json``), not this script's.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SEED = 0
REPS = 10               # timed groups a median
TWIN_REPS = 3           # the twins' groups: some take half a second
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor rate, the same
ISSUE_PER_SM_CLOCK = 128    # thread instructions an SM issues per clock:
                            # 4 schedulers, one warp instruction each
                            # (NVIDIA's Hopper architecture white paper)
# SASS instructions of one unit of work, read off the compiled kernels
# (cuobjdump): a Goldilocks modmul (gl::mul, pointwise_chain_kernel's
# loop), an E = 3 / E = 9 extension product of the commit's inner loop,
# a thread of the stark kernels
GL_MUL_INSTRUCTIONS = 29
SLOT_MATVEC_INSTRUCTIONS = 239.75
BB_SLOT_MATVEC_INSTRUCTIONS = 160
STARK_INSTRUCTIONS = {"stark_mul": 604, "stark_add": 208, "stark_sub": 191,
                      "limb_fold": 535}
MXU_DIGIT_PRODUCTS = 100    # int8 products a word product of mxu_mod_mat
CUDA_TESTS = ["-m", "pytest", "--noconftest", "-o", "addopts=", "-m", "cuda",
              "-q", "-p", "no:cacheprovider", "tests/test_torch_cuda.py"]
PALLAS_FOLD = "stark_rings_tpu/ops/pallas_fold.py"
PALLAS_FOLD_BB = "stark_rings_tpu/ops/pallas_fold_bb.py"
PALLAS_SUMCHECK = "stark_rings_tpu/mle/pallas_sumcheck.py"
PALLAS_EXCHANGE = "stark_rings_tpu/parallel/pallas_exchange.py"
STARK_FIELD = "stark_rings_tpu/fields/field.py"
MODEL_MUL = "stark_rings_tpu/ops/model_mul.py"
DIGIT_STAGE = ("stark_rings_tpu/decomp/balanced.py:149, decomp/norms.py:149, "
               "rings/monomial.py:158")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def nbytes(*xs) -> int:
    """Bytes held by the tensors in ``xs`` (lists and tuples searched)."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            total += nbytes(*x)
    return total


def tensors(x) -> list:
    """The tensors of an output, in order (lists and tuples flattened)."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    return [x]


def time_ms(fn, inner=1, reps=REPS):
    """Median ms per call over ``reps`` timed groups of ``inner`` calls,
    after two warm-up calls (CUDA events)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def u64_err(got, want, what) -> int:
    """Largest |got - want| over the stored words, read unsigned (u64
    for int64 tensors, u32 for int32 ones; 0 when bit-equal); raises on
    a shape or dtype mismatch."""
    import torch

    from stark_rings_tpu_torch import to_numpy_u32, to_numpy_u64

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if got.dtype == torch.bool:
        got, want = got.to(torch.int32), want.to(torch.int32)
    g, w = got.reshape(-1), want.reshape(-1)
    bad = (g != w).nonzero().reshape(-1)
    if not bad.numel():
        return 0
    words = to_numpy_u64 if got.dtype == torch.int64 else to_numpy_u32
    return max(abs(x - y) for x, y in zip(words(g[bad]).tolist(),
                                          words(w[bad]).tolist()))


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def issue_rate(dev) -> float:
    """The SMs' issue rate, thread instructions a second: SMs x
    ``ISSUE_PER_SM_CLOCK`` x the top SM clock that nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", str(dev.index or 0)], capture_output=True,
        text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * ISSUE_PER_SM_CLOCK * mhz * 1e6


def kernel_table(dev) -> tuple:
    """(rows, {launch name: the module that counts it}, paths).  One row
    per launch name: (name, source, replaces, path, build); ``build(rng)``
    draws the inputs at the kernel's main-path shape and returns (kernel
    call, twin call, its inputs, its operation bound in seconds or 0).
    ``paths``: {label: (make, launches)}, the main-path calls, each at its
    shape; ``make(rng)`` draws the inputs and returns the call, and
    ``launches`` is every launch the call makes, by name (PERF.md §6's
    "Launches per main-path call").  A row's ``path`` is the label its
    launches are read from, or None where the main-path call is the
    wrapper itself (one launch, and no other)."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import (GOLDILOCKS, ShardedNTT, get_field,
                                       get_power_ring, make_mesh)
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.mle import fix as FX
    from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
    from stark_rings_tpu_torch.ops import digits as DG
    from stark_rings_tpu_torch.ops import fold as K, fold_bb as KB
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.ops import mxu_fused as MF
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.ops.mxu import MatmulNTT
    from stark_rings_tpu_torch.ops import slot as SL, slot_bb as SB
    from stark_rings_tpu_torch.ops import stark as ST
    from stark_rings_tpu_torch.parallel import exchange as EX
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    issue = issue_rate(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def buckets(rows, cols):
        """Unsigned digit-GEMM buckets, up to the bound 2^27 - 1."""
        return torch.randint(0, 1 << 27, (rows, cols), generator=gen,
                             dtype=torch.int32, device=dev)

    def pair(wrapper, twin, make, ops=lambda *args: 0.0):
        """A row whose twin takes the wrapper's arguments; ``make(rng)``
        gives (args, kwargs), ``ops(*args)`` the operation bound (s)."""
        def build(rng):
            args, kw = make(rng)
            return (lambda: wrapper(*args, **kw),
                    lambda: twin(*args, **kw), args, ops(*args))
        return build

    def words(name, shape):
        return lambda rng: get_field(name).rand(shape, rng, dev)

    gl = words("goldilocks", (80, 1 << 16))     # deg 2^16 at batch 80

    def fold_tw(rng):       # mxu_ctx()'s K1 at deg 2^16, B = 80: R = t = 256
        return (buckets(8 * 256, 80 * 256),
                words("goldilocks", (256, 256))(rng), 256), \
            {"transpose_out": False, "signed": False}

    def fold_end2_mul(rng):  # Mxu2FusedNTT's K2 at deg 2^16, B = 80
        return (buckets(8 * 256, 80 * 256), buckets(8 * 256, 80 * 256),
                256), {"signed": False}

    def fold_end(rng):      # the D = 24 model's CRT at B = 262,144
        return (buckets(8 * 24, 1 << 18), 24), {"signed": False}

    def bb_fold_tw(rng):    # MxuBBFusedNTT at deg 2^12, B = 4,096: R = t = 64
        tw = get_field("babybear").rand((64, 64), rng, dev)
        return (buckets(4 * 64, 4096 * 64), tw, 64), {"transpose_out": True,
                                                      "signed": False}

    def bb_fold_end2_mul(rng):
        return (buckets(4 * 64, 4096 * 64), buckets(4 * 64, 4096 * 64),
                64), {"signed": False}

    def bb_fold_end(rng):   # the D = 72 fold's ICRT at W L = 262,144
        return (buckets(4 * 72, 1 << 18), 72), {"signed": False}

    engine = G.GoldilocksKernelNTT(1 << 16, device=dev)
    wf, wi, ninv = engine.tables()

    def ntt_stage(rng):     # the radix mul at deg 2^16, B = 80: stage 0
        return (gl(rng), wf, 0), {"inverse": False}

    def ntt_tile(rng):
        return (gl(rng), wf, wi, ninv, engine.log_tile, "mul_eval",
                gl(rng)), {}

    def tile_ops(x, *args):
        # mul_eval: log_tile forward and inverse stages (half a modmul a
        # word each) and the slot product, B N (log_tile + 1) modmuls
        return x.numel() * (engine.log_tile + 1) * GL_MUL_INSTRUCTIONS / issue

    def mxu_mod_mat(rng):   # a MatmulNTT level at deg 2^14, B = 80
        m = rng.integers(0, GOLDILOCKS.q, (128, 128),
                         dtype=np.uint64).astype(object)
        f = MF.MxuModMatFused(m, device=dev)
        return (words("goldilocks", (128, 10240))(rng), f.w, f.wt), {}

    def mxu_ops(x, w, wt):
        return 2 * MXU_DIGIT_PRODUCTS * 128 * x.numel() / INT8_OPS_PER_S

    def mle(k=None):        # BASELINE config 4: nv = 20
        def make(rng):
            pts = words("goldilocks", (20,))(rng)
            return (words("goldilocks", (1 << 20,))(rng),
                    pts if k is None else pts[:k]), {}
        return make

    def sumcheck(field, W=None):    # nv = 20, k = 2; W claims batched
        shape = (1 << 20,) if W is None else (W, 1 << 20)

        def make(rng):
            tables = [words(field, shape)(rng) for _ in range(2)]
            chal = words(field, (20,))(rng)
            return (tables, chal) + (() if W else (field,)), {}
        return make

    def exchange(field, inverse):   # config 5: deg 2^20 on P = 8, B = 8
        rows, cols = (1024 // 8, 1024) if inverse else (1024, 1024 // 8)

        def make(rng):
            xs = [words(field, (8, rows, cols))(rng) for _ in range(8)]
            tws = [words(field, (rows, cols))(rng) for _ in range(8)]
            return (xs, tws, field), {}
        return make

    # S1-S3 as the stark16 cell's step calls them (n = 8, L = 16,384,
    # W = 16, k = 16: M = 262,144), each name's call that moves the most
    def stark_commit(rng):  # S1: a commit block's A by the digits, 8,192
        A = STARK.rand((16, 8, 8192), rng, dev)     # columns, as views
        x = STARK.rand((16, 16, 8192), rng, dev)
        return (A[:, None], x[:, :, None]), {}

    def stark_fold(rng):    # S2 add: the challenge fold of the witnesses
        return tuple(STARK.rand((16, 16, 16384), rng, dev)
                     for _ in range(2)), {}

    def stark_digits(rng):  # S2 sub: a word less the digits, [16, 16, M]
        return (STARK.rand((), rng, dev),
                STARK.rand((16, 16, 1 << 18), rng, dev)), {}

    def stark_ops(name):
        return lambda a, b: (torch.broadcast_shapes(a.shape, b.shape)
                             .numel() // 8 * STARK_INSTRUCTIONS[name] / issue)

    def limb_fold(rng):     # the digits' CRT: R = 16 over W M columns
        V = torch.randint(-2**31, 2**31, (32 * 16, 16 << 18), generator=gen,
                          dtype=torch.int32, device=dev)
        return (V, 16), {"signed": False}

    def limb_fold_twin(V, R, **kw):     # in slices of 2^18 columns: the
        step = 1 << 18                  # twin holds 0.8 GB a M words out
        return torch.cat([ST.limb_fold_ref(V[:, c:c + step], R, **kw)
                          for c in range(0, V.shape[1], step)], dim=1)

    def limb_ops(V, R):
        return R * V.shape[1] * STARK_INSTRUCTIONS["limb_fold"] / issue

    gl_t = SL.ext_tables(get_ring("goldilocks", device=dev))
    bb_t = SL.ext_tables(get_ring("babybear", device=dev))

    def slot(field, E, a, b, t):
        return lambda rng: ((words(field, (8, E) + a)(rng),
                             words(field, (8, E) + b)(rng), t), {})

    def matvec_ops(per):
        return lambda A, x, t: (A.shape[0] * A.shape[2] * x.shape[2]
                                * A.shape[3] * per / issue)

    def blocked(twin):
        return lambda A, x, t: twin(A, x, t, block=1024)

    def digit_stage(model, k):
        """The fold cells' digit stage: coefficients [D, 16, 16,384], base
        256, psi on; witnesses 0-7 uniform words, 8-15 small values in
        psi's range."""
        def make(rng):
            ring = get_ring(model, device=dev)
            coeff = ring.field.rand((ring.D, 16, 16384), rng, dev)
            coeff[:, 8:] = ring.field.from_uint(
                rng.integers(0, ring.D // 2, (ring.D, 8, 16384)).astype(
                    np.uint64), dev)
            return (ring, coeff, 256, k, 48_000_000), {}
        return make

    def digits_kernel(ring, coeff, base, k, bound):
        dt, ok_l2, fails = DG.step_digits(ring, coeff, base, k, bound, True)
        return dt, ok_l2, DG.check_psi(ring, dt, fails)

    def digits_twin(ring, coeff, base, k, bound):
        dt, ok_l2, _ = DG.step_digits_ref(ring, coeff, base, k, bound)
        return dt, ok_l2, DG.check_psi(ring, dt, None)

    fold_src, bb_src = "csrc/fold.cu", "csrc/fold_bb.cu"
    POW16, FUSED16, RADIX = ("gl-pow16-mul-B80 (mxu_ctx().mul, deg 2^16, "
                             "B = 80)", "Mxu2FusedNTT.mul, deg 2^16, B = 80",
                             "GoldilocksKernelNTT.mul, deg 2^16, B = 80")
    MUL_T = "gl24-mul_t-B262144 (TModelMul.mul_t, B = 262,144)"
    GL_STEP, BB_STEP, STARK_STEP = (
        f"{cell}-L16384-fold-W16 (precompute_challenge and FoldingStep.step)"
        for cell in ("gl24", "bb72", "stark16"))
    BB_MUL = "BabyBear mxu_ctx().mul, deg 2^12, B = 4,096"
    MATMUL = "MatmulNTT.mul on MxuModMatFused levels, deg 2^14, B = 80"
    SHARDED = "ShardedNTT({!r}).mul, deg 2^20, P = 8 shards, B = 8"
    rows = [
        ("fold_tw", fold_src, f"{PALLAS_FOLD}:141", POW16,
         pair(K.fold_tw, K.fold_tw_ref, fold_tw)),
        ("fold_end2_mul", fold_src, f"{PALLAS_FOLD}:467", FUSED16,
         pair(K.fold_end2_mul, K.fold_end2_mul_ref, fold_end2_mul)),
        ("fold_end", fold_src, f"{PALLAS_FOLD}:370", MUL_T,
         pair(K.fold_end, K.fold_end_ref, fold_end)),
        ("pointwise_mul", fold_src, f"{PALLAS_FOLD}:658", POW16,
         pair(K.pointwise_mul, K.pointwise_mul_ref,
              lambda rng: ((gl(rng), gl(rng)), {}))),
        ("pointwise_chain", fold_src, f"{PALLAS_FOLD}:526", None,
         pair(K.pointwise_chain, K.pointwise_chain_ref,
              lambda rng: ((gl(rng), gl(rng), 16), {}),
              lambda a, b, depth: a.numel() * depth * GL_MUL_INSTRUCTIONS
              / issue)),
        ("bb_fold_tw", bb_src, f"{PALLAS_FOLD_BB}:231", BB_MUL,
         pair(KB.bb_fold_tw, KB.bb_fold_tw_ref, bb_fold_tw)),
        ("bb_fold_end2_mul", bb_src, f"{PALLAS_FOLD_BB}:241", BB_MUL,
         pair(KB.bb_fold_end2_mul, KB.bb_fold_end2_mul_ref,
              bb_fold_end2_mul)),
        ("bb_fold_end", bb_src, f"{PALLAS_FOLD_BB}:226", BB_STEP,
         pair(KB.bb_fold_end, KB.bb_fold_end_ref, bb_fold_end)),
        ("ntt_stage", "csrc/ntt.cu",
         "stark_rings_tpu/ops/pallas_goldilocks.py:457", RADIX,
         pair(G.ntt_stage, G.ntt_stage_ref, ntt_stage)),
        ("ntt_tile", "csrc/ntt.cu",
         "stark_rings_tpu/ops/pallas_goldilocks.py:457", RADIX,
         pair(G.ntt_tile, G.ntt_tile_ref, ntt_tile, tile_ops)),
        ("mxu_mod_mat", "csrc/mxu.cu", "stark_rings_tpu/ops/pallas_mxu.py:186",
         MATMUL, pair(MF.mxu_mod_mat,
                      lambda x, w, wt: MF.mxu_mod_mat_ref(x, w),
                      mxu_mod_mat, mxu_ops)),
        ("evaluate_goldilocks", "csrc/mle.cu",
         "stark_rings_tpu/mle/pallas_fix.py:182", None,
         pair(FX.evaluate_goldilocks, FX.evaluate_goldilocks_ref, mle())),
        ("fix_last_goldilocks", "csrc/mle.cu",
         "stark_rings_tpu/mle/pallas_fix.py:139", None,
         pair(FX.fix_last_goldilocks, FX.fix_last_goldilocks_ref, mle(7))),
        *((f"sumcheck_prove_many_{field}", "csrc/mle.cu",
           f"{PALLAS_SUMCHECK}:{line}", None,
           pair(SK.sumcheck_prove_many, SK.sumcheck_prove_many_ref,
                sumcheck(field)))
          for field, line in (("goldilocks", 347), ("babybear", 87),
                              ("frog", 111))),
        ("sumcheck_prove_batch_goldilocks", "csrc/mle.cu",
         f"{PALLAS_SUMCHECK}:428", None,
         pair(SK.sumcheck_prove_batch_goldilocks, SK.sumcheck_prove_batch_ref,
              sumcheck("goldilocks", W=4))),
        *((f"twiddle_exchange_{d}_{field}", "csrc/exchange.cu",
           f"{PALLAS_EXCHANGE}:{line}", SHARDED.format(field),
           pair(getattr(EX, f"twiddle_exchange_{d}"),
                getattr(EX, f"twiddle_exchange_{d}_ref"),
                exchange(field, d == "inv")))
          for field in ("goldilocks", "babybear")
          for d, line in (("fwd", 241), ("inv", 268))),
        *((name, "csrc/stark.cu", f"{STARK_FIELD}:{line}", STARK_STEP,
           pair(getattr(ST, name), getattr(ST, name + "_ref"), make,
                stark_ops(name)))
          for name, line, make in (("stark_mul", 665, stark_commit),
                                   ("stark_add", 624, stark_fold),
                                   ("stark_sub", 638, stark_digits))),
        ("limb_fold", "csrc/stark.cu", "stark_rings_tpu/ops/mxu_limb.py:133",
         STARK_STEP, pair(ST.limb_fold, limb_fold_twin, limb_fold,
                          limb_ops)),
        # the D = 24 model's mul_t at B = 262,144, and the D = 24 fold's
        # commit at n = 8, M = k L = 131,072, W = 16
        ("slot_mul", "csrc/slot.cu", f"{MODEL_MUL}:158", MUL_T,
         pair(SL.slot_mul, SL.slot_mul_ref,
              slot("goldilocks", 3, (1 << 18,), (1 << 18,), gl_t))),
        ("slot_matvec", "csrc/slot.cu", f"{MODEL_MUL}:183", GL_STEP,
         pair(SL.slot_matvec, blocked(SL.slot_matvec_ref),
              slot("goldilocks", 3, (8, 1 << 17), (16, 1 << 17), gl_t),
              matvec_ops(SLOT_MATVEC_INSTRUCTIONS))),
        # the D = 72 fold's challenge ([8, 9, W L] by a batch-1 operand)
        # and commit (n = 8, M = k L = 65,536, W = 16)
        ("bb_slot_mul", "csrc/slot_bb.cu", f"{MODEL_MUL}:158", BB_STEP,
         pair(SB.bb_slot_mul, SB.bb_slot_mul_ref,
              slot("babybear", 9, (1 << 18,), (1,), bb_t))),
        ("bb_slot_matvec", "csrc/slot_bb.cu", f"{MODEL_MUL}:183", BB_STEP,
         pair(SB.bb_slot_matvec, blocked(SB.bb_slot_matvec_ref),
              slot("babybear", 9, (8, 1 << 16), (16, 1 << 16), bb_t),
              matvec_ops(BB_SLOT_MATVEC_INSTRUCTIONS))),
        # the fold cells' decompose, L2 and psi in one pass
        ("step_digits", "csrc/digits.cu", DIGIT_STAGE, GL_STEP,
         pair(digits_kernel, digits_twin, digit_stage("goldilocks", 8))),
        ("bb_step_digits", "csrc/digits.cu", DIGIT_STAGE, BB_STEP,
         pair(digits_kernel, digits_twin, digit_stage("babybear", 4))),
    ]

    # -- the main-path calls ------------------------------------------------
    def power_mul(field, log_n, B):
        def make(rng):
            ctx = get_power_ring(field, log_n, device=dev).mxu_ctx()
            a, b = (words(field, (B, 1 << log_n))(rng) for _ in range(2))
            return lambda: ctx.mul(a, b)
        return make

    def engine_mul(build, log_n):
        def make(rng):
            eng = build()
            a, b = (words("goldilocks", (80, 1 << log_n))(rng)
                    for _ in range(2))
            return lambda: eng.mul(a, b)
        return make

    def mul_t(rng):
        tm = TModelMul(get_ring("goldilocks", device=dev))
        a, b = (words("goldilocks", (24, 1 << 18))(rng) for _ in range(2))
        return lambda: tm.mul_t(a, b)

    def fold_step(model, L, W, **kw):
        """The fold cells' call on random NTT-form inputs: the
        challenge's NTT form and a folding step."""
        def make(rng):
            ring = get_ring(model, device=dev)
            fs = FoldingStep(ring, 8, L, **kw)
            c = fs.init_tables(rng)
            r = ring.rand_coeff((), rng)
            ins = (fs.rand_witness(W, rng), fs.rand_witness(W, rng),
                   *(fs.tm.to_t(ring.rand_ntt((W, 8), rng)).contiguous()
                     for _ in range(2)))
            return lambda: fs.step(c, *ins, fs.precompute_challenge(r))
        return make

    def matmul():
        mn = MatmulNTT(device=dev)
        for key in ("col_mat", "row_mat", "col_mat_inv", "row_mat_inv"):
            setattr(mn, key, MF.MxuModMatFused(getattr(mn, key).matrix(),
                                               device=dev))
        return mn

    def sharded(field):
        def make(rng):
            sn = ShardedNTT(field, 1 << 20, 8, exchange="pallas")
            mesh = make_mesh(8, device=dev)
            spec = sn.shard_specs(1)[0]
            a, b = (sn.shard(sn.to_matrix(words(field, (8, 1 << 20))(rng)),
                             spec, mesh) for _ in range(2))
            mul = sn.make_fns(mesh, batch_ndim=1)[2]
            return lambda: mul(a, b)
        return make

    paths = {
        POW16: (power_mul("goldilocks", 16, 80),
                {"fold_tw": 3, "fold_end": 3, "pointwise_mul": 1}),
        FUSED16: (engine_mul(lambda: K.Mxu2FusedNTT(1 << 16, device=dev), 16),
                  {"fold_tw": 3, "fold_end2_mul": 1, "fold_end": 1}),
        RADIX: (engine_mul(lambda: engine, 16),
                {"ntt_stage": 9, "ntt_tile": 2}),
        MUL_T: (mul_t, {"fold_end": 3, "slot_mul": 1}),
        GL_STEP: (fold_step("goldilocks", 16384, 16, base=256, k=8,
                            l2_bound_sq=16_000_000, psi_check=True),
                  {"fold_end": 3, "slot_mul": 2, "slot_matvec": 1,
                   "step_digits": 1}),
        BB_STEP: (fold_step("babybear", 16384, 16, base=256, k=4,
                            l2_bound_sq=48_000_000, psi_check=True),
                  {"bb_fold_end": 3, "bb_slot_mul": 2, "bb_slot_matvec": 1,
                   "bb_step_digits": 1}),
        BB_MUL: (power_mul("babybear", 12, 4096),
                 {"bb_fold_tw": 3, "bb_fold_end2_mul": 1, "bb_fold_end": 1}),
        MATMUL: (engine_mul(matmul, 14), {"mxu_mod_mat": 6}),
        SHARDED.format("goldilocks"): (sharded("goldilocks"), {
            "twiddle_exchange_fwd_goldilocks": 2,
            "twiddle_exchange_inv_goldilocks": 1,
            "ntt_tile": 48, "pointwise_mul": 32}),
        SHARDED.format("babybear"): (sharded("babybear"), {
            "twiddle_exchange_fwd_babybear": 2,
            "twiddle_exchange_inv_babybear": 1}),
        STARK_STEP: (fold_step("stark_prime", 16384, 16, base=1 << 16, k=16,
                               l2_bound_sq=4_718_592, psi_check=True),
                     {"stark_mul": 64, "stark_add": 11, "stark_sub": 19,
                      "limb_fold": 3}),
    }
    counter = {k: mod for mod in (K, KB, G, MF, FX, SK, EX, ST, SL, SB, DG)
               for k in mod.LAUNCHES}
    if sorted(r[0] for r in rows) != sorted(counter):
        raise AssertionError(f"the kernel table's rows "
                             f"{sorted(r[0] for r in rows)} are not the "
                             f"launch names {sorted(counter)}")
    for name, _, _, path, _ in rows:
        if path is not None and not paths[path][1].get(name):
            raise AssertionError(f"{name}: its path {path!r} launches none")
    return rows, counter, paths


def launches_of(call, counter) -> dict:
    """The launches of one ``call()``, by name, every counter set to 0
    just before it (the names that launched only)."""
    import torch

    torch.cuda.synchronize()
    for mod in set(counter.values()):
        mod.reset_launches()
    out = call()
    torch.cuda.synchronize()
    del out
    return {k: mod.LAUNCHES[k] for k, mod in counter.items()
            if mod.LAUNCHES[k]}


def measure(dev, smi) -> list:
    """The kernel table's records: each main-path call once, its launches
    counted and held to the expected ones; then each row's kernel alone,
    its words against the twin's, and both timed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    rows, counter, paths = kernel_table(dev)
    on_path = {}
    for label, (make, want) in paths.items():
        got = launches_of(make(rng), counter)
        phase("path", f"{label}: {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        on_path[label] = got
        torch.cuda.empty_cache()
    records = []
    for name, source, replaces, path, build in rows:
        kernel, twin, args, ops_s = build(rng)
        got = kernel()
        if launches_of(kernel, counter) != {name: 1}:
            raise AssertionError(f"{name}: its wrapper is not one launch")
        launches = on_path[path][name] if path else 1
        want = twin()
        if len(tensors(got)) != len(tensors(want)):
            raise AssertionError(f"{name}: {len(tensors(got))} outputs, the "
                                 f"twin {len(tensors(want))}")
        err = max(u64_err(g, w, name) for g, w in zip(tensors(got),
                                                      tensors(want)))
        moved = nbytes(args, got)
        del got, want
        ms = time_ms(kernel, inner=10)
        plain_ms = time_ms(twin, reps=TWIN_REPS)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_s * 1e3)
        records.append({
            "name": name, "route": "cuda",
            "source": f"stark_rings_tpu_torch/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s * 1e3 > bytes_ms else "bytes",
            "library_ms": None})
        phase("kernel", f"{name}: {launches} a call of "
              f"{path or 'its wrapper'}; max |err| {err}; kernel {ms:.4f} "
              f"ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({records[-1]['bound_by']}; {moved} B), {bound_ms / ms:.0%} "
              f"of it  ({smi})")
        del args, kernel, twin
        torch.cuda.empty_cache()
    bad = [r["name"] for r in records if r["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels not bit-equal to their twins: {bad}")
    return records


def main() -> None:
    started = time.perf_counter()
    if not (HERE / "stark_rings_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke.py: {HERE} holds no "
                         "stark_rings_tpu_torch package; run it from the "
                         "root of a checkout")
    sys.path.insert(0, str(HERE))

    import torch

    # -- device ---------------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this script checks the card only)")
    cap = torch.cuda.get_device_capability(0)
    if cap[0] != 9:
        raise RuntimeError(f"need a Hopper card (compute capability 9.x), "
                           f"got {cap}")
    dev = torch.device("cuda", 0)
    smi = card_info()
    print(smi)
    phase("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")

    from stark_rings_tpu_torch.ops import _build

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.library_path()
    fresh = not so.exists()
    _build.kernels()
    log = so.with_suffix(".log")
    phase("build", f"{'built' if fresh else 'cached'} {so.name} in "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    if fresh and log.exists():
        # ptxas's registers and spills, per kernel (mangled names)
        for line in log.read_text().splitlines():
            if "Function properties" in line or "registers" in line \
                    or "spill" in line:
                print(f"  {line.strip()}")

    # -- 2. the card tests ----------------------------------------------------
    t0 = time.perf_counter()
    tests = subprocess.run([sys.executable, *CUDA_TESTS], cwd=HERE)
    phase("card tests", f"rc {tests.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if tests.returncode:
        raise SystemExit(f"chip_smoke.py: the card tests failed (rc "
                         f"{tests.returncode})")

    # -- 3. the kernel table --------------------------------------------------
    t0 = time.perf_counter()
    records = measure(dev, smi)
    phase("kernels", f"{len(records)} kernels in "
          f"{time.perf_counter() - t0:.1f} s")
    phase("done", f"every step passed in {time.perf_counter() - started:.1f} "
          "s, build included")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
