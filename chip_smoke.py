#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA Hopper card.

Slice A is the deg-2^16 Goldilocks negacyclic ring multiply at batch 80
through ``stark_rings_tpu_torch.Mxu2FusedNTT``: six digit GEMMs
(``torch._int_mm``) and the hand-written CUDA fold kernels K1
(``fold_tw``), K2 (``fold_end2_mul``) and K3 (``fold_end``).

Slice E is the Goldilocks MLE and sumcheck path at nv = 20 (one scale
point at nv = 24): the Fiat-Shamir sumcheck proof of
``stark_rings_tpu_torch.examples.sumcheck``, the one-pass prover K7
(``sumcheck_prove_many_goldilocks``), full evaluation K5
(``evaluate_goldilocks``) and fix-last-variables K6
(``fix_last_goldilocks``).

Slice B is the power-of-two ring API, ``get_power_ring(...).mxu_ctx()``:
BabyBear deg 2^12 at batch 4096 (BASELINE config 2) through
``MxuBBFusedNTT`` and the K4 folds (``bb_fold_tw``, ``bb_fold_end2_mul``,
``bb_fold_end``), and Goldilocks deg 2^16 at batch 80 (one point at deg
2^18, batch 16) through ``Mxu2KernelNTT``: K1 untransposed, K3 and the
slot-product kernel ``pointwise_mul``.

Slice C (sumcheck fields) is the one-pass prover K7 over BabyBear
(``sumcheck_prove_many_babybear``) and frog
(``sumcheck_prove_many_frog``) at nv = 20, their Fiat-Shamir proofs, and
W = 4 Goldilocks claims in one batched proof
(``sumcheck_prove_batch_goldilocks``).

The NTT engines are the radix-2 ``GoldilocksKernelNTT`` (the tile and
pass kernels ``ntt_tile`` and ``ntt_stage``) at deg 2^16, batch 80, on
Slice A's operands, ``MatmulNTT`` at deg 2^14, batch 80, on ``MxuModMat``
and on the fused mod-mat kernel ``mxu_mod_mat``, and ``pointwise_chain``.

The entry slice is the entry points: the flagship step of
``entry()`` (the Goldilocks model CRT, slot product and ICRT with a
base-256 decompose and recompose; K3 folds its CRT and ICRT),
``dryrun_multichip`` on shards of the card, and the (dp, sp) grid step
at deg 2^20 (the radix tile, ``pointwise_mul`` and K8).

Slice H (sharded) is the four-step NTT of ``parallel/ntt.py`` at deg
2^20 (BASELINE config 5), batch 8: ``ShardedNTT(..., exchange="pallas")``
on a mesh of 8 shards of the one card, whose every exchange is one
launch of the twiddle-fused exchange kernel K8 (``twiddle_exchange_fwd``
and ``twiddle_exchange_inv``, over Goldilocks and BabyBear), and the
single-device ``PowerRing.fourstep_ctx()``.  Its Goldilocks local
transforms are the cyclic radix tile ``ntt_tile`` (one launch a shard's
columns or rows) and its twist, twiddle and slot products
``pointwise_mul`` (tables broadcast over the batch).

The ring models are the batch-trailing model-CRT multiply
``TModelMul.mul_t`` over goldilocks (B = 65,536), babybear (B = 16,384)
and frog (B = 65,536), the reference bench's batches: each CRT and ICRT
is one digit GEMM (``torch._int_mm``) and one bucket fold, K3
(``fold_end``) at R = 24 for goldilocks and K4's ``bb_fold_end`` at R =
72 for babybear (frog folds in torch ops); and the Ajtai commit
``matvec_t`` at n = 8, m = 1,024, W = 16, unblocked and blocked.

The linalg slice is BASELINE config 4's mat-vec into its MLEs: a
``SparseMatrix`` of 2^20 x 2^20 with 4 terms a row over Goldilocks,
``mul_vec`` (a gather, a product and the field's ``segment_sum``), the
MLE of the product through K5 and K6, the nv = 40 ``SparseMLE`` of the
matrix, a ring-element mat-vec and ``DenseMLE.from_matrix``.

The stark slice is BASELINE config 3, the 252-bit stark prime in eight
u32 limbs: ``get_power_ring("stark_prime", 12).mxu_ctx()``
(``MxuLimbNTT``) at B = 256, ``TModelMul.mul_t`` over the D = 16 model
at B = 4,096 and its commit, the limbed ``FoldingStep`` at W = 16 and a
sumcheck at nv = 20 on the generic prover.  Its kernels compute what
the reference runs in XLA: S1 (``stark_mul``, the CIOS Montgomery
product), S2 (``stark_add``, ``stark_sub``) and S3 (``limb_fold``, the
digit GEMM's bucket fold).

The jit slice is the compiled multiplies (``ops/graphed.py``): each
call captured once as a CUDA graph and replayed as one launch, the
port's counterpart of the reference's ``jax.jit``: ``jit_mul``,
``jit_mul_cached`` (batch-B and batch-1 states), ``jit_square`` and
``staged_mul`` in its four granularities on ``Mxu2FusedNTT`` and
``Mxu2KernelNTT`` at config 1 (deg 2^16, B = 80 and B = 1) and on
``MxuBBFusedNTT`` at config 2 (deg 2^12, B = 4,096), and
``MxuLimbNTT.jit_mul`` at config 3 (deg 2^12, B = 256).

Run from the root of a checkout, on a machine with one CUDA card of
compute capability 9.x and ``nvcc``:

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card, its name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from ``stark_rings_tpu_torch/csrc``,
     one process per source, side by side;
  3. kernel parity: each kernel against its plain twin on the card, bit
     for bit, at the main path's shapes, on buckets from the real GEMM,
     at the bucket bound and over the whole int32 range; both digit
     schemes (the signed one at batch 8); the GEMM against an exact
     float64 product; the transposed K1, stored through a tile in shared
     memory, also at R and t off its tile in both schemes (B = 1 at
     deg 2^16; the tw and twi buckets of deg 2^6, 2^10 and 2^13 rings;
     raw 37 x 100 and 1 x 1 twiddle tables);
  4. engine parity at N = 2^16, B = 80: mul, stack_forward mul, square,
     mul_cached (batch-80 and batch-1 operand) and the folding combine
     w' = c*w + v, each bit-equal to the kernel-free Mxu2NTT on the card,
     and for 2 rows to the native schoolbook oracle (C++, O(N^2));
  5. launch counts of phase 4 (each kernel must have run);
  6. timings (CUDA events, median of 10 after warm-up): each kernel
     against its plain twin, the four digit GEMMs, and whole multiplies
     per second on the kernel path and on the plain path;
  7. profile: device busy time of one mul and its top kernels
     (torch.profiler);
  8. mle parity: K5, K6 and K7 against their plain twins on the card, bit
     for bit, on tables of zeros, of q-1 and of random values: K5 at
     nv = 1, 4, 9, 10, 11, 12, 20, 21 and 24, K6 at nv = 20 for k in
     {1, 5, 6, 7, 13} and at nv = 24 for k = 17, K7 (twin: the generic
     msb prover; one cooperative launch a proof) at nv = 4, 11 and 20
     for k = 2 and 3 and at nv = 24 for k = 2;
  9. mle path: the Fiat-Shamir proof at nv = 20 (plain rounds, real
     transcript) verifies with K5 in its final check, a proof with one
     message changed is rejected, K7 on the bit-reversed tables with the
     transcript's challenges reproduces the messages and finals, the
     verifier recurrence holds in Python ints; K5 at nv = 20 and 24
     equals DenseMLE.evaluate and evaluate_goldilocks_mxu, K6 at nv = 20
     (k = 1, 7, 13) and 24 (k = 17) equals DenseMLE.fix_last_variables
     and (nv = 20, k >= 3) fix_last_variables_mxu;
 10. mle oracle: K5 at nv = 20 equals a Python-int evaluation of the same
     table, computed on a host thread;
 11. mle launch counts of phase 9 (K5, K6 and K7 must each have run;
     the path's one K7 proof is one launch, and each K5 evaluation and
     K6 call at nv = 20 and 24 one launch);
 12. mle timings (CUDA events, median of 10 after warm-up): each kernel
     against its twin, proofs/s of K7 (nv = 20, k = 2), evaluations/s at
     nv = 20 through K5, DenseMLE.evaluate and evaluate_goldilocks_mxu;
     K5 at nv = 20 and 24 (warm, and after a 100 MB write that flushes
     the L2) and K6 at nv = 20, k = 1, 7, 13: beside the wall, device
     busy (torch.profiler), the wrapper's host time against the
     one-launch floor (_build.launch of a 1-element kernel), launches a
     call and the byte bound;
 13. mle profile: device busy time against wall time of one K7 proof,
     one K5 evaluation and one Fiat-Shamir prove (torch.profiler); per
     K7 proof its wall time (CUDA events), busy time and launches;
 14. power-ring kernel parity: the K4 kernels against their twins, bit
     for bit, at B = 4096 (unsigned) and B = 256 (signed), on buckets
     from the real GEMM, at the bucket bound and over the whole int32
     range; the tiled transposed bb_fold_tw also at R and t off its
     32 x 64 tile in both schemes (the tw and twi buckets of deg 2^10,
     2^11 and 2^14 rings, deg 2^6's 8 x 8 twiddles, a raw 100 x 72
     table); K1 untransposed and K3 at R = 256 (deg 2^16) and R = 512
     (deg 2^18); the slot-product kernel on [80, 2^16] and on a length
     that is not a multiple of its block;
 15. power-ring path, launches counted: BabyBear mxu_ctx() mul,
     stack_forward mul, square and mul_cached (batch-4096 and batch-1
     operands), each bit-equal to the plain MxuBBNTT and to coeff_mul
     (the radix NTTContext), 2 rows to the C++ schoolbook over q, and
     config 2's invertibility check; Goldilocks mxu_ctx() mul /
     mul_cached / square at deg 2^16 equal to Mxu2FusedNTT (phase 4) and
     the schoolbook rows, and mul at deg 2^18 equal to coeff_mul;
 16. launch counts of phase 15 (each kernel of the path must have run);
 17. timings (CUDA events, median of 10 after warm-up): each kernel of
     the path against its twin and its memory floor, BabyBear mults/s
     on the kernel and plain engines, Goldilocks mxu_ctx() mults/s
     beside Mxu2FusedNTT's, the six digit GEMMs of a BabyBear mul, and
     the host cost of one kernel launch;
 18. profile: device busy time against wall time of one BabyBear mul at
     B = 4096, and its top kernels (torch.profiler);
 19. fields parity: K7 over BabyBear and frog against the generic msb
     prover on the card, bit for bit, at nv = 4 and 11 (random tables)
     and nv = 20 (zeros, q-1, random), k = 2 and 3; the random nv = 20
     proofs hold the sumcheck relations in Python ints over canonical
     values (round 0's p(0) + p(1) is the sum of the products, each
     later round's p(0) + p(1) is the previous p(r), the last p(r) the
     product of the finals); the W = 4, nv = 20, k = 2 Goldilocks batch
     against its twin (the generic prover on the claims at once), and
     three claims of a W = 65,535, nv = 4 batch against theirs; K7's
     card limits: 9 tables at nv = 12 over the three fields and 16 at
     nv = 16 over Goldilocks (the run-time-k kernel, one launch each)
     and nv = 0 (the empty proof, no launch) against the generic
     prover, and a W = 65,536,
     nv = 1 batch (two chunks of claims, one launch each) against its
     twin; the persistent kernel at nv = 20 for k = 1..8 over the three
     fields, one launch each, with its registers, spills, grid and
     resident blocks an SM;
 20. fields path, launches counted: per field an nv = 20 Fiat-Shamir
     proof (real transcript) verified through DenseMLE.evaluate, a
     tampered one rejected, and K7 on the bit-reversed tables
     reproducing it; the W = 4 batch equal to 4 single K7 proofs;
 21. launch counts of phase 20 (each kernel must have run; each proof,
     and the batch, is one launch);
 22. timings (CUDA events, median of 10 after warm-up): K7 over each
     field at nv = 20 for k = 2 (against its twin) and k = 3, proofs/s
     and memory floors; the batch against its twin, and against 4 single
     proofs in turns; K7 beyond 8 tables (Goldilocks, nv = 16, k = 9 and
     16): wall, busy and host time a proof against its bound (bytes, and
     its own loop's modmuls at the card's peak) and the one-launch floor;
 23. profile: device busy time against wall time of one call of each of
     the three kernels (torch.profiler); per field and for the batch the
     proof's wall time (CUDA events), busy time and launches;
 24. engine parity: ntt_stage (both directions, with and without 1/N) and
     ntt_tile (forward, inverse, mul_eval) at N = 2^16, B = 80, and in
     every mode at log_tile 1, 3, 4, 5, 9, 13 (and 14 up to LOG_TILE):
     the whole row at B = 80, and 4 rows of 2^16; the
     one-launch mul at N = 2^10, pointwise_chain (depth 16 and 0, a
     ragged length) and the pointwise kernel against their twins;
     mxu_mod_mat on MatmulNTT's four level matrices (an MxuModMatFused
     built on each) at M = 10,240 and a ragged 10,277 against
     MxuModMat.apply, at M = 1,024 against its twin (data columns
     2^64 - 1, q - 1, 0, 1 included), and at R, C, M off its 64 x 32
     tile (70 x 45 at M = 100, 5 x 9 at M = 33) against both;
 25. engine path, launches counted: the radix forward, inverse, mul and
     mul_composite at N = 2^16, B = 80, bit-equal to NTTContext, mul to
     Mxu2FusedNTT.mul and the schoolbook rows; the radix mul at N = 2^10
     and 2^14 to NTTContext; MatmulNTT.mul at N = 2^14, B = 80 on
     MxuModMat, and with its levels swapped for the fused kernel's, to
     the radix mul and NTTContext;
     the depth-16 chain on [80, 2^16] to its twin;
 26. launch counts of phase 25 (each kernel must have run);
 27. timings (CUDA events, median of 10 after warm-up): the card's
     Goldilocks modmul peak (gl::mul's instructions in the SASS against
     the SMs' issue rate), which bounds every Goldilocks kernel of this
     slice, and the depth-256 chain's sustained rate beside it; each
     kernel against its twin and its bound, the tile in its forward,
     inverse and mul_eval modes each with its bytes, modmuls and bound;
     mxu_mod_mat beside MxuModMat.apply and the stacked _int_mm alone,
     its tensor-core integer MMA instructions counted in the built
     library's SASS (none fails the phase), its registers and shared
     memory; the
     radix mul and Mxu2FusedNTT.mul in turns, NTTContext.mul; MatmulNTT
     (both level kinds) and the radix mul at N = 2^14; the radix mul
     at N = 2^16 and 2^14 at the other tile size the kernel takes
     (log_tile 13 against 14) in turns;
 28. profile: device busy time against wall time of one radix mul, and
     its kernels by name (the stage passes and the tile's two modes);
 29. sharded parity: K8 forward and inverse against their twins, bit for
     bit, over Goldilocks and BabyBear at deg 2^20: 8 shards at B = 8 on
     tables of zeros, of q-1 and of random words, and batchless; 1, 2
     and 4 shards at B = 2; the cyclic radix tile on a shard's columns
     as [8,192, 1,024] rows against NTTContext(negacyclic=False) and its
     twin, and pointwise_mul on a [8, 1,024, 128] shard with b a
     [1,024, 128] table, a batch-1 operand, its own shape and one
     element against its twin;
 30. sharded path, launches counted (K8, ntt_tile, pointwise_mul and
     NTTContext's transforms, zeroed before): on 8 shards at deg 2^20,
     B = 8, the Goldilocks forward, inverse, mul, mul_cached (batch-8
     and batch-1 cached operands) and square with K8, each bit-equal to
     the "xla" route; mul also to fourstep_ctx().mul (run on the path),
     GoldilocksKernelNTT.mul and HostGoldilocks.mul (row 0),
     fourstep_ctx().mul to GoldilocksKernelNTT.mul and HostGoldilocks,
     forward to fourstep_ctx().forward, inverse(forward) = id; the
     BabyBear mul to the "xla" route, fourstep_ctx().mul and
     HostRing.mul (row 0); local="mxu" to local="vpu";
 31. launch counts of phase 30: K8's four instances must each have run,
     3 per mul, 2 per square; per shard a Goldilocks mul 6 ntt_tile and
     4 pointwise_mul launches (fourstep_ctx().mul: 6 and 7), a square 4
     and 3, no ntt_stage and no NTTContext transform; BabyBear 6
     NTTContext transforms a shard (no radix kernel over it);
 32. timings (CUDA events, median of 10 after warm-up): K8 against its
     twin, its bound and the block transpose alone (one permute and
     contiguous on the stacked shards); the four-step's tile and
     broadcast pointwise_mul at its shapes against their twins and
     bounds; the sharded mul with K8 and with the "xla" route;
     fourstep_ctx().mul and GoldilocksKernelNTT.mul in turns;
     make_phase_fns' three phases;
 33. profile: device busy time against wall time of one sharded mul and
     one fourstep_ctx().mul, the hand kernels' share and the rest
     (transpose copies, torch ops).

 34. model parity: K3 at R = 24, B = 65,536 and bb_fold_end at R = 72,
     B = 16,384 against their twins on the model CRT GEMM's buckets, at
     the bucket bound, zero and full-range int32; mul_t of the three
     models at a ragged B = 13 on the card against the CPU twin path;
     slot_mul at [8, 3, 65,536]^2 and slot_matvec at the commit's shape
     against their twins, on random words and on q - 1;
 35. model path, launches counted: mul_t of the three models at their
     batches and the commit (unblocked and block = 128); each mul_t
     equal to the integer spec on 64 rows and to coeff_mul on the card
     over the whole batch, the commit (unblocked and blocked) to
     slot_matvec's twin (torch ops on the card) blocked at 128, and one
     commitment to the spec's slot products summed in Python ints;
 36. launch counts of phase 35 (3 K3 launches and 1 slot_mul a
     goldilocks mul_t, 3 bb_fold_end a babybear one, none for frog, 1
     slot_matvec a commit);
 37. timings (CUDA events, median of 10 after warm-up): K3 and
     bb_fold_end at the model shapes against their twins and memory
     floors, their device-only time (torch.profiler) with the wrapper's
     host time apart; mults/s of each mul_t with the stages of one CRT GEMM
     (planes, _int_mm, offset terms, fold) and the slot product; the
     commit's rate and time per commitment, unblocked and blocked;
     slot_mul at mul_t's shape against its twin and its bound (bytes,
     or the issue rate over its SASS instructions) with its
     device-only time;
 38. profile: device busy time against wall time of one mul_t per
     model, split into the fold kernel (and its time a launch),
     _int_mm, the slot kernel and torch's elementwise kernels, with the
     slot product profiled alone (torch.profiler).

The folding protocol (``FoldingStep``, ``FoldingTree``) at the reference
bench's width, goldilocks n = 8, L = 1,024, base 256 (k = 8, M = 8,192):

 39. protocol path, launches counted: the step over {W = 8, W = 16} x
     {psi on, psi off}, the goldilocks tree (16 leaves, L = 256), the
     frog tree of the example with psi live, one babybear step (n = 8,
     L = 1,024, W = 16);
 40. each step's outputs held to independent paths on the card: s and c
     to the batch-leading ntt_mul with the broadcast challenge, the
     digits to gadget_decompose of ring.icrt(s) over the whole batch; for
     two witnesses the digits recompose in Python ints to the decoded
     ICRT coefficients, ok_l2 equals the exact Python-int norm against
     the bound, cd equals Matrix.mul_vec and row 0 the spec's slot
     products summed in Python ints, ok_psi the host psi check of every
     digit value; cd and the commit at block 1,000 equal slot_matvec's
     twin (torch ops on the card) blocked at 1,000; the trees verify and
     reject a tampered digit commitment;
 41. launch counts of phase 39 (K3 twice, slot_mul twice and
     slot_matvec once a goldilocks step, four times that the 16-leaf
     tree, bb_fold_end twice a babybear step), and K3 / bb_fold_end against
     their twins on a step's digit-CRT buckets, slot_mul at the
     challenge's shapes ([8, 3, 16,384] and [8, 3, 128] x [8, 3, 1]) and
     slot_matvec at the commit's (n = 8, M = 8,192, W = 16) against
     their twins on random words and on q - 1;
 42. timings (CUDA events, median of 10 after warm-up, whole calls):
     slot_matvec at the commit's shape against its twin and its bound
     (the issue rate over the SASS instructions of its inner loop a
     product) with its device-only time; steps/s and witnesses/s of the four grid points and the babybear
     step, leaves/s of the tree, each stage of one W = 16 step alone,
     the peak device memory of a step;
 43. profile: device busy time against wall time of one W = 16 step
     and of one tree prove (with its host time and its torch operator
     calls), with their top kernels.

The stark slice (``slice_stark``):
 44. S1 and S2 against their twins on 2^20 random elements, the pairs
     of six edge values (0, 1, q - 1, R mod q, q's own limbs, 2^256 - 1)
     and broadcast tables (the mid twiddle [64, 64, 8], one element);
     S3 on the deg-2^12 level buckets [2048, 16384] and the model CRT's
     [512, 4096], both digit schemes, both output layouts, and on
     full-range int32 buckets;
 45. the main path with the launch counts zeroed before it and read
     after: mul, mul_cached and square at B = 256 (6 folds and 4
     products a mul), mul_t at B = 4,096, the commit (unblocked and
     block 128), one W = 16 step, one nv = 20 proof, the four-step
     ShardedNTT mul at B = 16 on 4 shards of the card;
 46. the multiplies bit-equal to the radix NTTContext on the card over
     the whole batch, rows 0 and 255 to a Python-int negacyclic product,
     the four-step to mxu_ctx().mul;
 47. mul_t equal to the integer spec on 2 rows, the commit blocked equal
     to unblocked and c[0, 0] to Python ints;
 48. the step held as phase 40 holds it (witnesses 0 and 15 in Python
     ints), the proof's sumcheck relations in Python ints;
 49. timings: each of S1-S3 against its twin with its bound (bytes, or
     the issue rate over the kernel's SASS instructions a thread) and
     its device-only time (torch.profiler) with the wrapper's host time
     apart,
     mults/s of the three multiplies and of mul_t, commits/s,
     witnesses/s, the step's stages and peak memory, proofs/s;
 50. profile: device busy against wall time of one mul and one step.

The linalg slice (``slice_linalg``, BASELINE config 4's mat-vec):
 51. tables: A 2^20 x 2^20 with 4 terms a row (nnz 2^22) and z [2^20]
     over Goldilocks; a 2^16 x 2^16 ring-element matrix (nnz 2^18) over
     the goldilocks model; a 2^12 x 2^12 matrix for an nv = 24 MLE;
 52. the path with K5 and K6 counted from 0: y = A.mul_vec(z),
     DenseMLE(y) (nv = 20) evaluated by K5 and fixed by K6 (k = 10),
     SparseMLE.from_matrix(A) (nv = 40) evaluated at r||c and fixed at
     c, the fixed MLE evaluated by K5, the ring mat-vec,
     DenseMLE.from_matrix (nv = 24) evaluated by K5;
 53. oracles: 64 rows of y in Python ints; K5 and K6 against
     DenseMLE.evaluate / fix_last_variables; fix_variables(c) against
     A.mul_vec(eq(c, .)) and its evaluation at r against the nv = 40
     one; the nv = 24 evaluation against SparseMLE.evaluate; 8 ring rows
     against the spec's slot products in Python ints; a Matrix, a
     SparseMatrix and a SparseMLE serialized to the arkworks golden
     bytes;
 54. launch counts of phase 52 (3 K5 launches, 1 K6);
 55. timings (mat-vecs/s, SparseMLE evaluations/s, K5 / K6, the ring
     mat-vec, from_matrix) and profiles of one mat-vec and one nv = 40
     evaluation.

The parallel slice (``slice_parallel``, the sharded layer on a mesh of 8
shards of the card):
 56. tables: ShardedModelMul over goldilocks B = 65,536, babybear
     B = 16,384 and stark_prime B = 4,096; ShardedMLE tables at nv = 20
     over Goldilocks (three), BabyBear and frog (two each); config 4's A
     (nnz 2^22, phase 51's matrix) for ShardedSparseMatVec; a 8 x 8,192
     goldilocks ring matrix for ShardedMatVec; the step grid (n = 8,
     L = 1,024, base 256, W = 8 and 16, psi on and off) and the 16-leaf
     tree (L = 256), witnesses sharded on axis 1;
 57. the path with every count zeroed before it and read after (K3,
     bb_fold_end, S3, K5, K7 over three fields) and the twins of those
     kernels counted: mul, ntt_mul and the challenge multiply of each
     model, the MLE's evaluation, fix (k = 17), hypercube sum, inner
     product, sumcheck (k = 2 over three fields, k = 3 over Goldilocks),
     the two mat-vecs, the four sharded steps, prove_sharded and the
     distributed prover example;
 58. oracles: every result equal to its unsharded counterpart on the
     card (TModelMul, DenseMLE and K5 on the whole table, the generic
     lsb prover, SparseMatrix.mul_vec, Matrix.mul_vec, FoldingStep.step,
     FoldingTree.prove); 64 rows of each model's products against the
     integer spec, 64 sparse rows and 2 ring mat-vec rows against
     Python-int sums; the sharded tree verified;
 59. launch counts of phase 57: P K5 launches an evaluation, P K7 a
     proof, 3 K3 / bb_fold_end / S3 a shard a multiply (2 a shard and 1
     for the challenge), 2 K3 a shard a step; no twin call;
 60. timings: each sharded call against its unsharded counterpart in
     turns (CUDA-event medians);
 61. profiles of one sharded sumcheck and one sharded step (busy against
     wall, the idle share, torch ops a call).

The entry slice (``slice_entry``, the entry points of
``stark_rings_tpu_torch.entry``):
 62. inputs: entry()'s own at B = 32 and a drawn batch at B = 65,536
     (bench.py:614's goldilocks batch); config 5's deg 2^20, B = 8 on a
     (dp, sp) = (2, 4) grid of shards of the card, for both exchanges;
 63. expected launches: the same calls on CPU shards with the kernels'
     twins counted (the step at both batches, dryrun_multichip(8) and
     (6), the grid step at deg 2^12 with the same grid and batch);
 64. the path with every count zeroed before it and read after (K3,
     ntt_tile, pointwise_mul, K7, K8) and the twins counted: the step
     at both batches, dryrun_multichip(8) (dp 1 x sp 8) and (6) (dp 3 x
     sp 2) on shards of the card, the grid step through the plain
     transpose and through K8; each call's launches equal to its CPU
     twin calls, no twin call on the card;
 65. oracles: the step's difference zero, 64 rows of the B = 65,536
     product against the integer spec; both grid products bit-equal to
     fourstep_ctx().mul on the whole batch, the checksum to one
     reduce_words of the product's widened words (each dry-run section
     holds its own results to their local twins);
 66. timings: the step at both batches (steps/s), the grid step against
     the 1-D P = 8 sharded mul and fourstep_ctx().mul in turns, each dry
     run's seconds and torch ops; profiles of the B = 65,536 step, the
     grid step and the P = 8 mul (busy against wall, torch ops a call);
 67. jit path, every count zeroed before it and read after: each compiled
     call's first result (its capture) bit-equal to the eager call on
     the card and to an oracle (config 1: the native schoolbook rows;
     config 2: NTTContext coeff_mul on the whole batch; config 3:
     NTTContext), a second call on fresh inputs equal to its eager call
     and the first result unchanged after it; each graph's memory;
 68. jit kernels: the graphs one compiled call replays hold the same
     hand kernels, each as often, as its eager call launches (each
     graph's kernel nodes from its DOT dump, ``keep_graph=True``; the
     fused mul K1 x3, K2, K3, the limbed S1 x4, S3 x6);
 69. jit timings: each compiled call against its eager call in turns
     (CUDA-event medians) and both calls' host time;
 70. jit capture: a function that synchronises under capture raises on
     its first CUDA call and returns no eager result (a child process).

The BabyBear slot kernels (phases 71-72, ``slice_slot_bb``,
``csrc/slot_bb.cu``): the E = 9 slot product and the Ajtai commit's
contraction of the D = 72 model at the BabyBear fold's shapes (n = 8,
L = 16,384, base 256, W = 16):

 71. slot parity and launches: ``bb_slot_mul`` at the challenge's [8, 9,
     16 x 16,384] and [8, 9, 16 x 8] by [8, 9, 1] and at a mul_t's
     [8, 9, 16,384]^2, ``bb_slot_matvec`` at the commit's [8, 9, 8,
     65,536] x [8, 9, 16, 65,536], on random words, 0 and q - 1, against
     their twins on the card (the commit's blocked at the step's block);
     one step at that shape and one mul_t counted, the counters set to 0
     just before each: 2 ``bb_slot_mul`` and 1 ``bb_slot_matvec`` a step,
     1 ``bb_slot_mul`` a mul_t, no Goldilocks slot launch; the kernels'
     records hold the step's counts;
 72. slot timings: each kernel against its twin and its bound (bytes at
     the memory rate; for the commit also the issue rate over its inner
     loop's SASS instructions an extension product, which raises where
     the SASS cannot be read), device-only warm
     and after an L2 flush, and the step's device time.

Every check raises on failure, so the exit code is non-zero.  The next
to last line is the kernels' JSON record: per kernel its launches on the
main path, its largest error against its twin, its time and its twin's,
and its bound (the larger of the bytes it must move over the card's
memory rate and its operations over their rate: the int8 tensor rate
for the mod-mat kernel's digit products, and for the Goldilocks
modmuls of this slice's kernels the card's issue rate over one
modmul's instructions, read off the compiled code in the same run).
The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
card the script fails before printing any result.
"""

from __future__ import annotations

import copy
import contextlib
import ctypes
import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent
N = 1 << 16
B = 80
B_SIGNED = 8
SEED = 0
REPS = 10
ORACLE_ROWS = 2
SOURCE = "stark_rings_tpu_torch/csrc/fold.cu"
KERNELS = {  # wrapper -> (reference kernel entry point, file:line)
    "fold_tw": "stark_rings_tpu/ops/pallas_fold.py:377",
    "fold_end2_mul": "stark_rings_tpu/ops/pallas_fold.py:467",
    "fold_end": "stark_rings_tpu/ops/pallas_fold.py:370",
}
NV = 20             # BASELINE config 4: 20-variable MLEs
NV_BIG = 24         # the scale point (a 128 MB table)
NV_SMALL = (4, 11)  # below the reference kernels' cuts (nv >= 9, >= 12)
FIX_KS = (1, 7, 13)
# K5 and K6 held to their twins in phase 8: one tile and below (nv <= 11),
# one ticket level (12, 20, 21) and two (24); K6 on the tree (k <= 5) and
# on eq weights in one chunk and in many, up to k = nv - 7
K5_NVS = (1, 4, 9, 10, 11, 12, NV, 21, NV_BIG)
K6_KS = (1, 5, 6, 7, 13)
MLE_SOURCE = "stark_rings_tpu_torch/csrc/mle.cu"
MLE_KERNELS = {
    "evaluate_goldilocks": "stark_rings_tpu/mle/pallas_fix.py:182",
    "fix_last_goldilocks": "stark_rings_tpu/mle/pallas_fix.py:139",
    "sumcheck_prove_many_goldilocks":
        "stark_rings_tpu/mle/pallas_sumcheck.py:347",
}
BB_LOG = 12         # BASELINE config 2: BabyBear deg 2^12 ...
BB_B = 4096         # ... at the batch the reference measures (bench.py:678)
BB_B_SIGNED = 256
K1_RAGGED = ((6, 512), (10, 64), (13, 16))  # (log deg, B): R, t of 8 to 128
K1_RAW = ((37, 100, 3), (1, 1, 40))  # R, t, B: ragged edges on both axes
BB_RAGGED = ((10, 256), (11, 128), (14, 64))  # (log deg, B): tiles off 64
BB_TABLE_LOG = 6    # an 8 x 8 twiddle table, on random buckets
BB_RAW = (100, 72, 33)  # R, t, B: ragged edges on both axes
GL_BIG_LOG = 18     # the big-degree point of the Goldilocks power ring
GL_BIG_B = 16
BB_SOURCE = "stark_rings_tpu_torch/csrc/fold_bb.cu"
POWER_KERNELS = {  # record name -> (source, reference kernel file:line)
    "bb_fold_tw": (BB_SOURCE, "stark_rings_tpu/ops/pallas_fold_bb.py:231"),
    "bb_fold_end2_mul": (BB_SOURCE,
                         "stark_rings_tpu/ops/pallas_fold_bb.py:241"),
    "bb_fold_end": (BB_SOURCE, "stark_rings_tpu/ops/pallas_fold_bb.py:226"),
    "pointwise_mul": (SOURCE, "stark_rings_tpu/ops/pallas_fold.py:658"),
    # the whole-array folds of mxu_ctx(), served by K1 and K3
    "fold_tw[transpose_out=False]": (SOURCE,
                                     "stark_rings_tpu/ops/pallas_fold.py:141"),
    "fold_end[whole-array]": (SOURCE,
                              "stark_rings_tpu/ops/pallas_fold.py:122"),
}
SC_FIELDS = ("babybear", "frog")
SC_W = 4            # claims of the batched Goldilocks proof
SC_W_MAX = 65535    # the most claims one launch takes ...
SC_NV_MANY = 4      # ... at a small nv
SC_W_OVER = 65536   # one claim more than a launch takes (two chunks)
SC_NV_K9 = 12       # nine tables here: beyond the kernel's eight
SC_NV_WIDE = 16     # the wide kernel's scale point: 16 tables ...
SC_WIDE_TIMED = ((SC_NV_WIDE, 9), (SC_NV_WIDE, 16))  # ... timed as (nv, k)
FIELD_KERNELS = {  # record name -> reference kernel (file:line)
    "sumcheck_prove_many_babybear":
        "stark_rings_tpu/mle/pallas_sumcheck.py:87",     # _BbOps
    "sumcheck_prove_many_frog":
        "stark_rings_tpu/mle/pallas_sumcheck.py:111",    # _FrogOps
    "sumcheck_prove_batch_goldilocks":
        "stark_rings_tpu/mle/pallas_sumcheck.py:428",
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor rate, the same
ISSUE_PER_SM_CLOCK = 128    # thread instructions an SM issues per clock:
                            # 4 schedulers, one warp instruction each
                            # (NVIDIA's Hopper architecture white paper)
LAUNCH_REPS = 1000
NTT_SIZES = (1 << 10, 1 << 14)   # parity points of the radix engine
NTT_TILE_LOGS = (1, 3, 4, 5, 9, 13, 14)  # log_tiles held in every mode
MM_N = 1 << 14      # MatmulNTT's one size (128 x 128)
MM_TWIN_COLS = 1024  # columns at which the mod-mat twin is held
MM_RAGGED = ((70, 45, 100), (5, 9, 33))  # R, C, M off the kernel's tile
CHAIN_DEPTH = 16    # pointwise_chain's default depth in the reference
CHAIN_DEEP = 256    # the depth whose rate is the sustained modmul rate
NTT_SOURCE = "stark_rings_tpu_torch/csrc/ntt.cu"
MXU_SOURCE = "stark_rings_tpu_torch/csrc/mxu.cu"
ENGINE_KERNELS = {  # record name -> (source, reference kernel file:line)
    "pointwise_chain": (SOURCE, "stark_rings_tpu/ops/pallas_fold.py:526"),
    "ntt_stage": (NTT_SOURCE, "stark_rings_tpu/ops/pallas_goldilocks.py:457"),
    "ntt_tile": (NTT_SOURCE, "stark_rings_tpu/ops/pallas_goldilocks.py:457"),
    "pointwise_mul[GoldilocksKernelNTT.pointwise]": (
        SOURCE, "stark_rings_tpu/ops/pallas_goldilocks.py:553"),
    "mxu_mod_mat": (MXU_SOURCE, "stark_rings_tpu/ops/pallas_mxu.py:186"),
}
MM_LEVELS = ("col_mat", "row_mat", "col_mat_inv", "row_mat_inv")
SH_N = 1 << 20      # BASELINE config 5: the deg-2^20 four-step NTT ...
SH_P = 8            # ... on 8 shards (here of one card) ...
SH_B = 8            # ... at the batch bench.py:828 measures
SH_PS = (1, 2, 4)   # the other shard counts K8 is held at
SH_B_SMALL = 2
EXCHANGE_SOURCE = "stark_rings_tpu_torch/csrc/exchange.cu"
EXCHANGE_KERNELS = {  # record name -> reference kernel (file:line)
    f"twiddle_exchange_{d}_{field}":
        f"stark_rings_tpu/parallel/pallas_exchange.py:{line}"
    for field in ("goldilocks", "babybear")
    for d, line in (("fwd", 241), ("inv", 268))}
# the reference bench's model-CRT multiply batches (bench.py:614-617)
MODEL_B = {"goldilocks": 65536, "babybear": 16384, "frog": 65536}
MODEL_SPEC_ROWS = 64    # rows held to the integer spec
MODEL_CHUNK = 4096      # columns a coeff_mul oracle call on the card
MODEL_RAGGED = 13       # a batch that is not a multiple of 8
# the Ajtai commit: n rows, m columns, W vectors, the blocked path's
# block (benchmarks/bench_protocol.py:88-108)
COMMIT = (8, 1024, 16, 128)
# the composed folding step: n rows, witness length L, base
# (benchmarks/bench_protocol.py:416-423), the witness batches of its grid,
# and the witnesses held in Python ints
PROTO = (8, 1024, 256)
PROTO_WS = (8, 16)
PROTO_INT_WITNESSES = 2
PROTO_BLOCK = 1000      # a forced commit block (M = 8,192 is 8 and a tail)
PROTO_TREE = (16, 256)  # leaves and L of the tree (bench_protocol.py:486-487)
PROTO_FROG_TREE = (2, 2, 3, 8)  # t, n, L, base (examples/folding_tree.py)
SLOT_SOURCE = "stark_rings_tpu_torch/csrc/slot.cu"
Q_TOP = (1 << 64) - (1 << 32)   # q - 1: every carry of the slot products
SLOT_MUL_REC = "slot_mul[model goldilocks]"
SLOT_MATVEC_REC = "slot_matvec[folding step commit]"
SLOT_XLA = {  # record -> the reference's XLA code the kernel computes
    SLOT_MUL_REC: "stark_rings_tpu/ops/model_mul.py:158",     # ntt_mul_bt
    SLOT_MATVEC_REC: "stark_rings_tpu/ops/model_mul.py:183",  # matvec_t
}
# the BabyBear fold (portbench's bb72-L16384-fold-W16): n, L, base, W; a
# model multiply's batch (bench.py:614-617)
BB_SLOT_STEP = (8, 16384, 256, 16)
BB_SLOT_MODEL_B = 16384
BB_SLOT_SOURCE = "stark_rings_tpu_torch/csrc/slot_bb.cu"
BB_SLOT_MUL_REC = "bb_slot_mul[folding step challenge babybear]"
BB_SLOT_MATVEC_REC = "bb_slot_matvec[folding step commit babybear]"
BB_SLOT_XLA = {  # record -> the reference's XLA code the kernel computes
    BB_SLOT_MUL_REC: "stark_rings_tpu/ops/model_mul.py:158",     # ntt_mul_bt
    BB_SLOT_MATVEC_REC: "stark_rings_tpu/ops/model_mul.py:183",  # matvec_t
}
PROTO_KERNELS = {  # record -> (source, reference kernel file:line, model)
    "fold_end[folding step goldilocks]": (
        SOURCE, "stark_rings_tpu/ops/pallas_fold.py:370", "goldilocks"),
    "bb_fold_end[folding step babybear]": (
        BB_SOURCE, "stark_rings_tpu/ops/pallas_fold_bb.py:226", "babybear"),
}
# BASELINE config 3, the 252-bit stark prime: the deg-2^12 ring multiply
# at the batch bench.py:726-757 measures, the D = 16 model's multiply at
# bench.py:618's batch, the commit of slice_models, the limbed folding
# step (n, L, base 2^16 of tests/test_protocol.py:28, W), a sumcheck
ST_LOG = 12
ST_B = 256
ST_RANDOM = 1 << 20     # random elements S1 and S2 are held on
ST_MODEL_B = 4096
ST_COMMIT = (8, 1024, 16, 128)
ST_PROTO = (8, 1024, 1 << 16, 16)
ST_NV = 20
ST_SHARDS, ST_SHARD_B = 4, 16   # the four-step at deg 2^12 on 4 shards
FOURSTEP_KERNELS = {  # record -> (source, reference kernel file:line)
    "ntt_tile[fourstep cyclic]": (
        NTT_SOURCE, "stark_rings_tpu/ops/pallas_goldilocks.py:457"),
    "pointwise_mul[fourstep tables]": (
        SOURCE, "stark_rings_tpu/ops/pallas_fold.py:658"),
}
ST_SOURCE = "stark_rings_tpu_torch/csrc/stark.cu"
STARK_KERNELS = {  # record -> the reference's XLA code it computes
    "stark_mul": "stark_rings_tpu/fields/field.py:665",
    "stark_add": "stark_rings_tpu/fields/field.py:624",
    "stark_sub": "stark_rings_tpu/fields/field.py:638",
    "limb_fold": "stark_rings_tpu/ops/mxu_limb.py:133",
}
# BASELINE config 4's mat-vec (BASELINE.md:25): A is 2^20 x 2^20 with 4
# terms a row (nnz 2^22, the shape of an R1CS / CCS matrix) over
# Goldilocks scalars, z of 2^20; its MLEs (nv = 20 dense, nv = 40
# sparse); a ring-element mat-vec over the Goldilocks ring model, and
# DenseMLE.from_matrix of a 2^12 x 2^12 matrix (nv = 24)
LA_LOG, LA_TERMS = 20, 4
LA_ORACLE_ROWS = 64
LA_FIX_K = 10
LA_RING_LOG, LA_RING_ROWS = 16, 8
LA_DM_LOG = 12
# the sharded layer (slice_parallel) on 8 shards of the card, at the
# widths of the slices above: the model multiply at bench.py:614-618's
# batches, config 4's nv = 20 MLEs and its mat-vec, the step's commit
# shape (n = 8 rows, M = 8,192 columns), the step grid and the 16-leaf
# tree of benchmarks/bench_protocol.py:416-423 and :486-487
PAR_P = 8
PAR_MODEL_B = {"goldilocks": 65536, "babybear": 16384, "stark_prime": 4096}
PAR_NV = 20
PAR_FIX_K = 17
PAR_K = 3
PAR_SC_FIELDS = ("goldilocks", "babybear", "frog")
PAR_MV = (8, 8192)
PAR_MV_INT_ROWS = (0, 7)
PAR_SPEC_ROWS = 64
PAR_REPS = 5            # timed groups a median: the sharded calls are long
# the entry points (slice_entry): the step at entry()'s batch and
# at bench.py:614's goldilocks mul_t batch, the dry run's two layouts,
# and config 5 (deg 2^20, B = 8) on a 2 x 4 grid of shards
ENTRY_BIG_B = 65536
ENTRY_SPEC_ROWS = 64
ENTRY_DRYRUNS = (8, 6)
ENTRY_GRID = (2, 4)         # (dp, sp)
ENTRY_COUNT_N = 1 << 12     # the grid's degree in the CPU count
# the compiled multiplies (slice_jit): config 1 at B = 80 (Slice A's
# operands) and B = 1, config 2 at BB_B, config 3 at ST_B
JIT_GRANULARITIES = ("stage", "mixed", "mixed4", "transform")
JIT_WRAPPERS = {  # hand kernel (profiler name) -> the wrapper that counts it
    "fold_tw_kernel": "fold_tw", "fold_tw_t_kernel": "fold_tw",
    "fold_end2_mul_kernel": "fold_end2_mul", "fold_end_kernel": "fold_end",
    "pointwise_mul_kernel": "pointwise_mul", "bb_fold_tw_kernel": "bb_fold_tw",
    "bb_fold_tw_t_kernel": "bb_fold_tw",
    "bb_fold_end2_mul_kernel": "bb_fold_end2_mul",
    "bb_fold_end_kernel": "bb_fold_end", "stark_binary_kernel<0>": "stark_mul",
    "stark_binary_kernel<1>": "stark_add",
    "stark_binary_kernel<2>": "stark_sub", "limb_fold_kernel": "limb_fold"}
JIT_EXPECT = {  # (engine, call) -> its hand launches a call
    ("Mxu2FusedNTT", "jit_mul"): {"fold_tw": 3, "fold_end2_mul": 1,
                                  "fold_end": 1},
    ("MxuLimbNTT", "jit_mul"): {"stark_mul": 4, "limb_fold": 6}}
JIT_HOST_CALLS = 4      # unsynchronised calls a host-time group
JIT_FAILING_CAPTURE = r"""
import torch
from stark_rings_tpu_torch.ops.graphed import graphed

runs = []


def synced(x):
    runs.append(1)
    return x * int(x.sum().item())   # a host sync: refused under capture


g = graphed(synced)
try:
    out = g(torch.ones(8, device="cuda"))
except RuntimeError as err:
    assert len(runs) == 2 and not g.captures, (runs, g.captures)
    print("capture refused:", str(err).splitlines()[0])
else:
    raise SystemExit(f"the capture did not fail: {out}")
"""
MODEL_KERNELS = {  # record -> (source, reference kernel file:line, model)
    "fold_end[model crt goldilocks]": (
        SOURCE, "stark_rings_tpu/ops/pallas_fold.py:370", "goldilocks"),
    "bb_fold_end[model crt babybear]": (
        BB_SOURCE, "stark_rings_tpu/ops/pallas_fold_bb.py:226", "babybear"),
}


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


def record(name, source, replaces, launches, err, ms, plain_ms, moved,
           ops_ms=0.0):
    """One kernel's entry of the JSON line.  ``moved``: the bytes the
    call must move (each input read once, each output written once);
    ``ops_ms``: its operations at the card's rate for their type.  The
    bound is the larger of that and the bytes at the memory rate."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "library_ms": None}


def time_ms(fn, inner=1, before=None, reps=REPS):
    """Median ms per call over ``reps`` timed groups of ``inner`` calls,
    after two warm-up calls (CUDA events).  ``before``, where given, runs
    ahead of each group, outside its events."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def in_turns(first, second, reps=REPS):
    """first, second, second, first: each one's two medians (ms)."""
    t = [time_ms(f, reps=reps) for f in (first, second, second, first)]
    return (t[0], t[3]), (t[1], t[2])


def shape(*ts) -> str:
    return " x ".join(str(list(t.shape)) for t in ts)


def device_profile(fn, n, dev, top, skip=(), rows_out=None):
    """Per call of ``fn`` over ``n`` calls under torch.profiler: (device
    busy ms, wall ms, the ``top`` kernels by device time as text).
    Kernels whose name holds a string of ``skip`` are left out.  A list
    ``rows_out`` receives every kernel's (name, launches a call, ms a
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the window's first kernel goes unrecorded: let it be this one
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted((r for r in prof.key_averages()
                   if not any(s in r.key for s in skip)),
                  key=lambda r: -r.self_device_time_total)
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3 / n
    text = "; ".join(f"{r.key[:48]} x{r.count // n} "
                     f"{r.self_device_time_total / 1e3 / n:.4f} ms"
                     for r in rows[:top])
    if rows_out is not None:
        rows_out.extend((r.key, r.count / n, r.self_device_time_total
                         / 1e3 / n) for r in rows)
    return busy_ms, wall_ms, text


def host_us(fn, n=200):
    """Median µs of host time a call over 5 groups of ``n`` calls, none
    synchronised."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def device_only(fn, dev, bound_ms, flush) -> str:
    """One wrapper call's kernel time on the device alone (torch.profiler
    over 50 calls, torch's own kernels left out), back to back (its
    inputs partly in the 50 MB L2) and after a write of ``flush`` (the
    L2 cold), beside its bound, and the wrapper's host time a call
    apart, as text."""
    skip = ("at::native",)
    warm = device_profile(fn, 50, dev, 0, skip)[0]
    cold = device_profile(lambda: (flush.fill_(1), fn()), 20, dev, 0,
                          skip)[0]

    def share(ms):
        return f"{bound_ms / ms:.0%}" if ms else "not measured"

    return (f"device-only {warm:.4f} ms warm ({share(warm)} of its bound "
            f"{bound_ms:.4f} ms), {cold:.4f} ms after an L2 flush "
            f"({share(cold)}), wrapper host {host_us(fn):.2f} us a call")


def call_costs(counts, name, fn, dev, floor_us, flush=None) -> str:
    """What one call of the wrapper ``fn`` costs beside its wall time,
    as text: its launches (``counts[name]``), its kernels' device busy
    time (torch.profiler), its host time against ``floor_us`` (the
    one-launch floor) and, with ``flush`` (a buffer of twice the L2),
    its wall and busy time when the buffer was written just before (the
    L2 cold; the write's kernel left out of busy)."""
    def ms(x):
        return f"{x:.4f} ms" if x else "not measured"

    before = counts[name]
    fn()
    launches = counts[name] - before
    skip = ("at::native",)   # torch's kernels: the window's opener, flush
    text = (f"{launches} launch(es) a call, busy "
            f"{ms(device_profile(fn, 20, dev, 0, skip)[0])}, host "
            f"{host_us(fn):.2f} us against the one-launch floor "
            f"{floor_us:.2f} us")
    if flush is not None:
        cold = time_ms(fn, before=lambda: flush.fill_(1))
        cold_busy = device_profile(lambda: (flush.fill_(1), fn()), 10, dev,
                                   0, skip)[0]
        text += (f"; after an L2 flush wall {cold:.4f} ms, busy "
                 f"{ms(cold_busy)}")
    return text


def digit_gemms(e, Bx, rng) -> dict:
    """ms of each level's digit GEMM (planes, ``_int_mm`` and offset
    terms) of engine ``e`` at batch ``Bx``, and of the six of one mul."""
    gemm = {}
    for key in ("w1", "w2", "w2i", "w1i"):
        mat = getattr(e, "mat" + key[1:])
        xc = e.F.rand((mat.C, Bx * e.N // mat.C), rng, e.device)
        gemm[key] = time_ms(lambda: mat.dot(xc, e.c[key],
                                            e.c.get(key + "_corr")))
    gemm["six"] = 2 * gemm["w1"] + 2 * gemm["w2"] + gemm["w2i"] + gemm["w1i"]
    return gemm


def time_kernels(mod, timed, smi, tag="time") -> dict:
    """Time each ``(record, kernel, label, args, kwargs)`` of ``timed``
    on ``mod``'s wrapper ``kernel`` and on its twin ``<kernel>_ref``.
    Returns {record: (ms, plain ms, bytes moved)} for the first entry
    of each record."""
    times = {}
    for key, name, label, args, kw in timed:
        kern, twin = getattr(mod, name), getattr(mod, name + "_ref")
        moved = nbytes(args, kern(*args, **kw))
        ms = time_ms(lambda: kern(*args, **kw), inner=10)
        plain_ms = time_ms(lambda: twin(*args, **kw))
        times.setdefault(key, (ms, plain_ms, moved))
        floor = moved / HBM_BYTES_PER_S * 1e3
        phase(tag, f"{name} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, memory floor {floor:.4f} ms ({moved} B; "
              f"{floor / ms:.0%} of the rate)  ({smi})")
    return times


def u64_err(got, want, what) -> int:
    """Largest |got - want| over the stored words, read unsigned (u64
    for int64 tensors, u32 for int32 ones; 0 when bit-equal); raises on
    a shape or dtype mismatch."""
    import torch

    from stark_rings_tpu_torch import to_numpy_u32, to_numpy_u64

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.reshape(-1), want.reshape(-1)
    bad = (g != w).nonzero().reshape(-1)
    if not bad.numel():
        return 0
    words = to_numpy_u64 if got.dtype == torch.int64 else to_numpy_u32
    return max(abs(x - y) for x, y in zip(words(g[bad]).tolist(),
                                          words(w[bad]).tolist()))


def check(max_err, name, got, want, what) -> None:
    """Fail unless ``got`` is bit-equal to ``want``, recording the largest
    error under ``max_err[name]``."""
    err = u64_err(got, want, f"{name} {what}")
    max_err[name] = max(max_err.get(name, 0), err)
    if err:
        raise AssertionError(f"{name} {what}: differs from the plain twin, "
                             f"max |err| {err}")


def kernel_parity(e, Bx, label, mod, prefix, rng, max_err):
    """Engine ``e``'s three fold kernels (``mod``'s wrappers named
    ``<prefix>fold_*``) against their twins at batch ``Bx``, on buckets
    from the real GEMM, at the bucket bound, zero (or -bound) and over
    the whole int32 range; the level-1 GEMM against a float64 product.
    Returns the buckets (V1, V2i, V1i, Va, Vb, Vc) for the timings."""
    import torch

    F, s, R, dev = e.F, e.signed, e.mat1.R, e.device
    x = F.rand((Bx, e.N), rng, dev)
    y = F.rand((e.mat2i.C, Bx, e.N1), rng, dev)   # NTT-domain input
    z = F.rand((e.mat1i.C, Bx, e.N2), rng, dev)
    V1 = e._dot(e.mat1, e._to_internal(x), e.c, "w1")
    V2i = e._dot(e.mat2i, y, e.c, "w2i")
    V1i = e._dot(e.mat1i, z, e.c, "w1i")
    Va, _, _ = e._fwd_buckets(x, e.c)
    Vb, _, _ = e._fwd_buckets(F.rand((Bx, e.N), rng, dev), e.c)
    Vc, _, _ = e._fwd_buckets(F.rand((1, e.N), rng, dev), e.c)
    bound = (1 << 26) - 1 if s else (1 << 27) - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    extreme = {
        "bound": torch.full_like(V1, bound),
        "-bound" if s else "zero": torch.full_like(V1, -bound if s else 0),
        "int32": torch.randint(-2**31, 2**31, V1.shape, generator=gen,
                               dtype=torch.int32, device=dev),
    }
    cases = [("fold_tw", "tw T", (V1, e.c["tw"], R), {"transpose_out": True}),
             ("fold_tw", "twi T", (V2i, e.c["twi"], e.mat2i.R),
              {"transpose_out": True}),
             ("fold_tw", "tw N", (V1, e.c["tw"], R), {"transpose_out": False}),
             ("fold_end", "inverse level 2", (V1i, e.mat1i.R), {}),
             ("fold_end2_mul", "two inputs", (Va, Vb, e.mat2.R), {}),
             ("fold_end2_mul", f"stacked {tuple(Va.shape[:1])}x"
              f"{2 * Va.shape[1]}", (torch.cat([Va, Vb], 1), None, e.mat2.R),
              {}),
             ("fold_end2_mul", f"batch-1 Vb {tuple(Vc.shape)}",
              (Va, Vc, e.mat2.R), {})]
    for key, Vx in extreme.items():
        cases += [("fold_tw", key, (Vx, e.c["tw"], R),
                   {"transpose_out": True}),
                  ("fold_end", key, (Vx, R), {}),
                  ("fold_end2_mul", key, (Vx, Vx.flip(1).contiguous(), R), {})]
    for kind, what, args, kw in cases:
        name = prefix + kind
        got = getattr(mod, name)(*args, signed=s, **kw)
        want = getattr(mod, name + "_ref")(*args, signed=s, **kw)
        torch.cuda.synchronize()
        check(max_err, name, got, want, f"{label} {what}")
    # the digit GEMM against an exact float64 product (sums < 2^53)
    mat = e.mat1
    d = mat.planes(e._to_internal(x).reshape(mat.C, -1))
    big = torch.from_numpy(mat.big).to(dev).double()
    exact = big @ d.double()
    if not torch.equal(V1.double(), exact):
        raise AssertionError(f"{label}: digit GEMM differs from the float64 "
                             "product")
    phase("parity", f"{label}: {len(cases)} kernel cases bit-equal to the "
          f"twins; GEMM {tuple(V1.shape)} exact")
    return V1, V2i, V1i, Va, Vb, Vc


def k1_ragged_parity(engines, dev, rng, max_err) -> None:
    """The transposed K1, whose store goes through a tile in shared
    memory, at R and t off the tile, in both schemes (one engine of
    ``engines`` each), against its twin: B = 1 at the main path's R = t
    = 256; the level-1 (tw) and inverse level-2 (twi) buckets of the
    deg 2^6, 2^10 and 2^13 rings (R, t of 8, 32, 64 and 128) from their
    real GEMMs, at the bucket bound and over the whole int32 range; raw
    37 x 100 and 1 x 1 twiddle tables on full-range buckets."""
    import torch

    from stark_rings_tpu_torch import GOLDILOCKS as F, Mxu2FusedNTT
    from stark_rings_tpu_torch.ops import fold as K

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def full(rows, cols):
        return torch.randint(-2**31, 2**31, (rows, cols), generator=gen,
                             dtype=torch.int32, device=dev)

    cases = []
    for e0 in engines:
        s, K_ = e0.signed, 9 if e0.signed else 8
        V1 = e0._dot(e0.mat1, e0._to_internal(F.rand((1, e0.N), rng, dev)),
                     e0.c, "w1")
        cases.append(("deg 2^16 B=1 tw", V1, e0.c["tw"], e0.mat1.R, s))
        for log, Bx in K1_RAGGED:
            e = Mxu2FusedNTT(1 << log, unsigned=not s, device=dev)
            V1 = e._dot(e.mat1, e._to_internal(F.rand((Bx, e.N), rng, dev)),
                        e.c, "w1")
            V2i = e._dot(e.mat2i, F.rand((e.mat2i.C, Bx, e.N1), rng, dev),
                         e.c, "w2i")
            bound = (1 << 26) - 1 if s else (1 << 27) - 1
            R = e.mat1.R
            cases += [(f"deg 2^{log} tw", V1, e.c["tw"], R, s),
                      (f"deg 2^{log} twi", V2i, e.c["twi"], e.mat2i.R, s),
                      (f"deg 2^{log} bound", torch.full_like(V1, bound),
                       e.c["tw"], R, s),
                      (f"deg 2^{log} int32", full(*V1.shape), e.c["tw"], R,
                       s)]
        for R, t, Bx in K1_RAW:
            cases.append((f"raw R={R} t={t} int32", full(K_ * R, Bx * t),
                          F.rand((R, t), rng, dev), R, s))
    for what, V, tw, R, s in cases:
        kw = {"transpose_out": True, "signed": s}
        check(max_err, "fold_tw", K.fold_tw(V, tw, R, **kw),
              K.fold_tw_ref(V, tw, R, **kw),
              f"{what} {'signed' if s else 'unsigned'}")
    torch.cuda.synchronize()
    phase("parity", f"tiled fold_tw (K1 transposed): {len(cases)} cases off "
          "its tile (B = 1 at deg 2^16; deg 2^6, 2^10, 2^13 GEMM buckets, "
          "bound and int32; raw 37 x 100 and 1 x 1 tables; both schemes) "
          "bit-equal to the twin")


def tw_ragged_parity(dev, rng, max_err) -> None:
    """The tiled transposed ``bb_fold_tw`` (32 x 64 tiles) at R and t off
    the tile, in both schemes, against its twin: the level-1 (tw) and
    inverse level-2 (twi) buckets of BabyBear rings of deg 2^10, 2^11
    and 2^14 from their real GEMMs, at the bucket bound and over the
    whole int32 range; deg 2^6's 8 x 8 twiddles and a raw [100, 72]
    twiddle table on full-range buckets."""
    import torch

    from stark_rings_tpu_torch import BABYBEAR as FB, MxuBBFusedNTT
    from stark_rings_tpu_torch.ops import fold_bb as KB

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def full(rows, cols):
        return torch.randint(-2**31, 2**31, (rows, cols), generator=gen,
                             dtype=torch.int32, device=dev)

    cases = []
    for unsigned in (True, False):
        s, K = not unsigned, 4 if unsigned else 5
        for log, Bx in BB_RAGGED:
            e = MxuBBFusedNTT(1 << log, unsigned=unsigned, device=dev)
            V1 = e._dot(e.mat1, e._to_internal(FB.rand((Bx, e.N), rng, dev)),
                        e.c, "w1")
            V2i = e._dot(e.mat2i, FB.rand((e.mat2i.C, Bx, e.N1), rng, dev),
                         e.c, "w2i")
            bound = (1 << 26) - 1 if s else (1 << 27) - 1
            R = e.mat1.R
            cases += [(f"deg 2^{log} tw", V1, e.c["tw"], R, s),
                      (f"deg 2^{log} twi", V2i, e.c["twi"], e.mat2i.R, s),
                      (f"deg 2^{log} bound", torch.full_like(V1, bound),
                       e.c["tw"], R, s),
                      (f"deg 2^{log} int32", full(*V1.shape), e.c["tw"], R,
                       s)]
        small = MxuBBFusedNTT(1 << BB_TABLE_LOG, unsigned=unsigned,
                              device=dev)
        R, t = small.c["tw"].shape
        cases.append((f"deg 2^{BB_TABLE_LOG} tw int32", full(K * R, 4096 * t),
                      small.c["tw"], R, s))
        R, t, Bx = BB_RAW
        cases.append((f"raw R={R} t={t} int32", full(K * R, Bx * t),
                      FB.rand((R, t), rng, dev), R, s))
    for what, V, tw, R, s in cases:
        kw = {"transpose_out": True, "signed": s}
        check(max_err, "bb_fold_tw", KB.bb_fold_tw(V, tw, R, **kw),
              KB.bb_fold_tw_ref(V, tw, R, **kw),
              f"{what} {'signed' if s else 'unsigned'}")
    torch.cuda.synchronize()
    phase("parity", f"tiled bb_fold_tw: {len(cases)} cases off the 32 x 64 "
          "tile (deg 2^10, 2^11, 2^14 GEMM buckets, bound and int32; deg "
          f"2^{BB_TABLE_LOG}'s 8 x 8 and a raw {BB_RAW[0]} x {BB_RAW[1]} "
          "table; both schemes) bit-equal to the twin")


def py_evaluate(table, points, q) -> int:
    """Multilinear evaluation in Python ints, variable 0 first."""
    vals = table.tolist()
    for r in points:
        vals = [(a + r * (b - a)) % q for a, b in zip(vals[0::2], vals[1::2])]
    return vals[0]


def py_lagrange(ys, x, q) -> int:
    """The polynomial through (i, ys[i]) evaluated at x, mod q."""
    acc = 0
    for i, y in enumerate(ys):
        num, den = 1, 1
        for j in range(len(ys)):
            if j != i:
                num = num * (x - j) % q
                den = den * (i - j) % q
        acc = (acc + y * num * pow(den, q - 2, q)) % q
    return acc


def k7_summary(label, wall_ms, busy_ms, fn, smi) -> None:
    """One line per K7 proof: its wall time (CUDA events), its device
    busy time (torch.profiler), its launches (one call of ``fn``,
    counted) and the cooperative grid."""
    import torch

    from stark_rings_tpu_torch.mle import sumcheck_kernel as SK

    before = sum(SK.LAUNCHES.values())
    fn()
    torch.cuda.synchronize()
    launches = sum(SK.LAUNCHES.values()) - before
    grid = ", ".join(f"{k.removeprefix('sumcheck_prove_')} {g} blocks "
                     f"({b}/SM)" for k, (g, b) in SK.LAST_GRID.items())
    busy = (f"busy {busy_ms:.4f} ms (profiler)" if busy_ms else
            "busy not measured (the profiler recorded no kernel)")
    phase("k7", f"{label} nv={NV} k=2: wall {wall_ms:.4f} ms (CUDA events), "
          f"{busy}, {launches} launch(es) a proof; grids so far: {grid}  "
          f"({smi})")


def slice_e(dev, smi, rng) -> list:
    """Phases 8-13: the Goldilocks MLE and sumcheck path.  Returns the
    kernels' JSON records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import GOLDILOCKS as F, to_numpy_u64, to_torch
    from stark_rings_tpu_torch.examples import sumcheck as example
    from stark_rings_tpu_torch.linalg import FieldElems
    from stark_rings_tpu_torch.mle import DenseMLE
    from stark_rings_tpu_torch.mle import fix as FX
    from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
    from stark_rings_tpu_torch.mle.mxu_eval import (evaluate_goldilocks_mxu,
                                                    fix_last_variables_mxu)
    from stark_rings_tpu_torch.mle.sumcheck import bit_reverse_table
    from stark_rings_tpu_torch.ops import _build
    from stark_rings_tpu_torch.rings import Transcript

    q = F.q
    e = FieldElems(F, dev)

    def table(nv, kind):
        if kind == "zeros":
            return torch.zeros(1 << nv, dtype=torch.int64, device=dev)
        if kind == "q-1":
            return F.encode([q - 1], dev).expand(1 << nv).contiguous()
        return F.rand((1 << nv,), rng, dev)

    # the independent oracle: a Python-int evaluation on a host thread
    T20_np = rng.integers(0, q, 1 << NV, dtype=np.uint64)
    p20_np = rng.integers(0, q, NV, dtype=np.uint64)
    pool = ThreadPoolExecutor(max_workers=1)
    oracle = pool.submit(py_evaluate, T20_np, p20_np.tolist(), q)
    T20, p20 = to_torch(T20_np, dev), to_torch(p20_np, dev)
    T24 = table(NV_BIG, "random")
    p24 = F.rand((NV_BIG,), rng, dev)

    # -- 8. parity against the twins --------------------------------------
    max_err = {name: 0 for name in MLE_KERNELS}

    t0 = time.perf_counter()
    cases = 0
    for nv in sorted({*K5_NVS, *NV_SMALL}):
        pts = F.rand((nv,), rng, dev)
        chal = F.rand((nv,), rng, dev)
        for kind in ("zeros", "q-1", "random"):
            T = table(nv, kind)
            check(max_err, "evaluate_goldilocks",
                  FX.evaluate_goldilocks(T, pts),
                  FX.evaluate_goldilocks_ref(T, pts), f"nv={nv} {kind}")
            cases += 1
            ks = {NV: K6_KS, NV_BIG: (NV_BIG - 7,)}.get(nv, ())
            for k in ks:
                check(max_err, "fix_last_goldilocks",
                      FX.fix_last_goldilocks(T, pts[nv - k:]),
                      FX.fix_last_goldilocks_ref(T, pts[nv - k:]),
                      f"nv={nv} k={k} {kind}")
                cases += 1
            if nv not in (*NV_SMALL, NV, NV_BIG):
                continue
            for k in (2,) if nv == NV_BIG else (2, 3):
                tables = [T] + [table(nv, kind) for _ in range(k - 1)]
                msgs, finals = SK.sumcheck_prove_many_goldilocks(tables,
                                                                 chal)
                want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal)
                what = f"nv={nv} k={k} {kind}"
                check(max_err, "sumcheck_prove_many_goldilocks", msgs,
                      want_m, what)
                check(max_err, "sumcheck_prove_many_goldilocks",
                      torch.stack(finals), torch.stack(want_f), what)
                cases += 1
    torch.cuda.synchronize()
    phase("mle parity", f"{cases} cases of K5/K6/K7 bit-equal to their "
          f"twins (zeros, q-1, random; K5 at nv={K5_NVS}, K6 at nv={NV} "
          f"k={K6_KS} and nv={NV_BIG} k={NV_BIG - 7}, K7 at "
          f"nv={NV_SMALL}, {NV} and {NV_BIG}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 9. the slice's main path, launches counted ------------------------
    torch.cuda.synchronize()
    FX.reset_launches()
    SK.reset_launches()
    t0 = time.perf_counter()
    g, h = DenseMLE.rand(e, NV, rng), DenseMLE.rand(e, NV, rng)
    S, msgs, chals = example.prove(g.evals, h.evals, Transcript(b"smoke"),
                                   NV)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    # K5's and K6's launches per call on the path: one each
    per_call = {"evaluate_goldilocks": [], "fix_last_goldilocks": []}

    def counted(name, fn, calls=1):
        before = FX.LAUNCHES[name]
        out = fn()
        per_call[name].append((FX.LAUNCHES[name] - before) / calls)
        return out

    t1 = time.perf_counter()
    if not counted("evaluate_goldilocks", lambda: example.verify(
            S, msgs, g, h, Transcript(b"smoke")), calls=2):
        raise AssertionError("the honest nv=20 proof was rejected")
    verify_s = time.perf_counter() - t1
    bad = [list(m) for m in msgs]
    bad[NV // 2][1] = F.add(bad[NV // 2][1], F.const(1, dev))
    if example.verify(S, [tuple(m) for m in bad], g, h,
                      Transcript(b"smoke")):
        raise AssertionError("a proof with one message changed by +1 was "
                             "accepted")
    m7, f7 = SK.sumcheck_prove_many_goldilocks(
        [bit_reverse_table(g.evals), bit_reverse_table(h.evals)],
        torch.stack(chals))
    gv = counted("evaluate_goldilocks",
                 lambda: FX.evaluate_goldilocks(g.evals, chals))
    hv = counted("evaluate_goldilocks",
                 lambda: FX.evaluate_goldilocks(h.evals, chals))
    if u64_err(m7, torch.stack([torch.stack(m) for m in msgs]), "K7") \
            or u64_err(torch.stack(f7), torch.stack([gv, hv]), "K7 finals"):
        raise AssertionError("K7 on the bit-reversed tables does not "
                             "reproduce the proof's messages and finals")
    # the verifier recurrence, in Python ints
    claim = int(to_numpy_u64(S))
    for m, r in zip(msgs, chals):
        ys = to_numpy_u64(torch.stack(m)).tolist()
        if (ys[0] + ys[1]) % q != claim:
            raise AssertionError("p(0) + p(1) != claim in Python ints")
        claim = py_lagrange(ys, int(to_numpy_u64(r)), q)
    if claim != int(to_numpy_u64(gv)) * int(to_numpy_u64(hv)) % q:
        raise AssertionError("final claim != g(r) h(r) in Python ints")
    # evaluation and fix-variables against DenseMLE and the digit GEMMs
    for nv, T, pts in ((NV, T20, p20), (NV_BIG, T24, p24)):
        k5 = counted("evaluate_goldilocks",
                     lambda: FX.evaluate_goldilocks(T, pts))
        for what, want in (
                ("DenseMLE.evaluate", DenseMLE(e, nv, T).evaluate(list(pts))),
                ("evaluate_goldilocks_mxu", evaluate_goldilocks_mxu(T, pts))):
            if u64_err(k5, want, what):
                raise AssertionError(f"K5 nv={nv} differs from {what}")
    for nv, T, pts, k in [(NV, T20, p20, k) for k in FIX_KS] + [
            (NV_BIG, T24, p24, NV_BIG - 7)]:
        k6 = counted("fix_last_goldilocks",
                     lambda: FX.fix_last_goldilocks(T, pts[nv - k:]))
        wants = [("DenseMLE.fix_last_variables", DenseMLE(e, nv, T)
                  .fix_last_variables(list(pts[nv - k:])).evals)]
        if k >= 3 and nv == NV:   # its int32 buckets stop below k = 17
            wants.append(("fix_last_variables_mxu",
                          fix_last_variables_mxu(T, pts[nv - k:])))
        for what, want in wants:
            if u64_err(k6, want, what):
                raise AssertionError(f"K6 nv={nv} k={k} differs from "
                                     f"{what}")
    torch.cuda.synchronize()
    launches = {**FX.LAUNCHES, **SK.LAUNCHES}
    phase("mle path", f"nv={NV} proof: prove {prove_s:.3f} s, verify "
          f"{verify_s:.3f} s, accepted; tampered proof rejected; K7 on the "
          f"bit-reversed tables reproduces its {NV}x3 messages and finals; "
          f"verifier recurrence holds in Python ints; K5 (nv={NV}, "
          f"{NV_BIG}) and K6 (nv={NV} k={FIX_KS}, nv={NV_BIG} "
          f"k={NV_BIG - 7}) equal DenseMLE and the digit-GEMM path; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 10. the Python-int oracle -----------------------------------------
    t0 = time.perf_counter()
    want = oracle.result()
    pool.shutdown()
    got = int(to_numpy_u64(FX.evaluate_goldilocks(T20, p20)))
    if got != want:
        raise AssertionError(f"K5 nv={NV}: {got} != Python-int oracle "
                             f"{want}")
    phase("mle oracle", f"K5 at nv={NV} equals the Python-int evaluation "
          f"(waited {time.perf_counter() - t0:.1f} s)")

    # -- 11. launch counts --------------------------------------------------
    phase("mle launches", json.dumps(launches))
    for name in MLE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")
    if launches["sumcheck_prove_many_goldilocks"] != 1:
        raise AssertionError("the path's one K7 proof took other than one "
                             "launch")
    phase("mle launches", "per call: " + json.dumps(per_call))
    for name, counts in per_call.items():
        if any(c != 1 for c in counts) or launches[name] != len(counts) + (
                name == "evaluate_goldilocks"):   # verify's two calls
            raise AssertionError(f"{name}: other than one launch a call at "
                                 f"nv={NV} and {NV_BIG}: {counts}")

    # -- 12. timings --------------------------------------------------------
    G20, H20 = F.rand((1 << NV,), rng, dev), F.rand((1 << NV,), rng, dev)
    c20 = F.rand((NV,), rng, dev)
    def fix_case(k):
        return ("fix_last_goldilocks", f"nv={NV} k={k}",
                lambda: FX.fix_last_goldilocks(T20, p20[NV - k:]),
                lambda: FX.fix_last_goldilocks_ref(T20, p20[NV - k:]),
                (T20, p20[NV - k:]))

    timed = [  # (kernel, label, kernel call, twin call, inputs); the
        # first per kernel is recorded
        ("evaluate_goldilocks", f"nv={NV}",
         lambda: FX.evaluate_goldilocks(T20, p20),
         lambda: FX.evaluate_goldilocks_ref(T20, p20), (T20, p20)),
        fix_case(FIX_KS[1]),
        ("sumcheck_prove_many_goldilocks", f"nv={NV} k=2",
         lambda: SK.sumcheck_prove_many_goldilocks([G20, H20], c20),
         lambda: SK.sumcheck_prove_many_ref([G20, H20], c20),
         (G20, H20, c20)),
        ("evaluate_goldilocks", f"nv={NV_BIG}",
         lambda: FX.evaluate_goldilocks(T24, p24),
         lambda: FX.evaluate_goldilocks_ref(T24, p24), (T24, p24)),
        fix_case(FIX_KS[0]),
        fix_case(FIX_KS[2]),
        ("sumcheck_prove_many_goldilocks", f"nv={NV} k=3",
         lambda: SK.sumcheck_prove_many_goldilocks([G20, H20, T20], c20),
         lambda: SK.sumcheck_prove_many_ref([G20, H20, T20], c20),
         (G20, H20, T20, c20)),
    ]
    # the one-launch floor: _build.launch of a 1-element kernel, timed as
    # phase 17 times it; K5 after a write of twice the 50 MB L2
    one = F.encode([1], dev)
    ptrs = (one.data_ptr(), one.data_ptr(), torch.empty_like(one).data_ptr(),
            1, 1)
    floor_us = 1e3 * time_ms(lambda: _build.launch(
        {"floor": 0}, "floor", _build.kernels().srt_pointwise_mul, dev,
        *ptrs), inner=LAUNCH_REPS)
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for name, label, kern, twin, inputs in timed:
        moved = nbytes(inputs, kern())
        ms = time_ms(kern, inner=10)
        plain_ms = time_ms(twin)
        times.setdefault(name, (ms, plain_ms, moved))
        costs = "" if name not in FX.LAUNCHES else "; " + call_costs(
            FX.LAUNCHES, name, kern, dev, floor_us,
            flush if name == "evaluate_goldilocks" else None)
        phase("mle time", f"{name} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, memory floor "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms ({moved} B){costs}  "
              f"({smi})")
    k7_ms = times["sumcheck_prove_many_goldilocks"][0]
    phase("mle time", f"K7 nv={NV} k=2: {1e3 / k7_ms:.1f} proofs/s; the "
          f"generic msb prover "
          f"{1e3 / times['sumcheck_prove_many_goldilocks'][1]:.1f} "
          f"proofs/s  ({smi})")
    ev_ms = {
        "K5 evaluate_goldilocks": times["evaluate_goldilocks"][0],
        "DenseMLE.evaluate": time_ms(
            lambda: DenseMLE(e, NV, T20).evaluate(list(p20))),
        "evaluate_goldilocks_mxu": time_ms(
            lambda: evaluate_goldilocks_mxu(T20, p20)),
    }
    phase("mle time", f"evaluations/s at nv={NV}: " + ", ".join(
        f"{k} {1e3 / v:.1f} ({v:.4f} ms)" for k, v in ev_ms.items())
        + f"  ({smi})")

    # -- 13. where the device time of the slice's calls goes ----------------
    calls = [
        ("K7 nv=20 k=2", 10,
         lambda: SK.sumcheck_prove_many_goldilocks([G20, H20], c20)),
        ("K5 nv=20", 3, lambda: FX.evaluate_goldilocks(T20, p20)),
        ("prove nv=20", 1, lambda: example.prove(
            G20, H20, Transcript(b"profile"), NV)),
    ]
    for label, n, fn in calls:
        busy_ms, wall_ms, top = device_profile(fn, n, dev, 4)
        phase("mle profile", f"{label}: device busy {busy_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall (profiled), idle share "
              f"{1 - busy_ms / wall_ms:.3f}; {top}  ({smi})")
        if label.startswith("K7"):
            k7_summary("goldilocks", k7_ms, busy_ms, fn, smi)

    return [record(name, MLE_SOURCE, MLE_KERNELS[name], launches[name],
                   max_err[name], *times[name]) for name in MLE_KERNELS]


def slice_b(dev, smi, rng, gl) -> list:
    """Phases 14-18: the power-of-two ring API, ``get_power_ring(...)
    .mxu_ctx()``.  ``gl`` holds Slice A's deg-2^16 operands (``a``,
    ``b``, ``ch``), the fused engine ``eng``, its ``results`` on them
    and the schoolbook rows ``orc``.  Returns the kernels' JSON
    records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import (BABYBEAR as FB, GOLDILOCKS as F,
                                       MxuBBFusedNTT, get_power_ring,
                                       to_numpy_u32, to_numpy_u64)
    from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook_q
    from stark_rings_tpu_torch.ops import _build, fold as K, fold_bb as KB

    t0 = time.perf_counter()
    bb_ring = get_power_ring("babybear", BB_LOG, device=dev)
    bb = bb_ring.mxu_ctx()
    bb_plain = bb_ring.mxu_ctx(pallas=False)
    bb_stacked = MxuBBFusedNTT(bb_ring.D, stack_forward=True, device=dev)
    bb_signed = MxuBBFusedNTT(bb_ring.D, unsigned=False, device=dev)
    ga, gb, gch = gl["a"], gl["b"], gl["ch"]
    GB, GN = ga.shape
    gk = get_power_ring("goldilocks", GN.bit_length() - 1,
                        device=dev).mxu_ctx()
    big_ring = get_power_ring("goldilocks", GL_BIG_LOG, device=dev)
    gk_big = big_ring.mxu_ctx()
    phase("power tables", f"babybear deg {bb_ring.D} ({type(bb).__name__}, "
          f"{type(bb_plain).__name__}, stacked, signed) and goldilocks deg "
          f"{GN} and {big_ring.D} ({type(gk).__name__}) built in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 14. kernel parity at the power rings' shapes -----------------------
    max_err = {}
    t0 = time.perf_counter()
    bbV = kernel_parity(bb, BB_B, f"babybear unsigned B={BB_B}", KB, "bb_",
                        rng, max_err)
    kernel_parity(bb_signed, BB_B_SIGNED, f"babybear signed B={BB_B_SIGNED}",
                  KB, "bb_", rng, max_err)
    tw_ragged_parity(dev, rng, max_err)

    def whole_array_parity(e, Bx):
        """K1 untransposed and K3 as mxu_ctx() runs them, on buckets from
        the real GEMM, at the bucket bound, zero and full-range int32."""
        R = e.mat1.R
        V1 = e._dot(e.mat1, e._to_internal(F.rand((Bx, e.N), rng, dev)),
                    e.c, "w1")
        V2 = e._dot(e.mat2, F.rand((e.mat2.C, Bx, e.N1), rng, dev), e.c,
                    "w2")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cases = {"GEMM": (V1, V2)}
        for what, fill in (("bound", (1 << 27) - 1), ("zero", 0)):
            cases[what] = (torch.full_like(V1, fill),
                           torch.full_like(V2, fill))
        cases["int32"] = tuple(
            torch.randint(-2**31, 2**31, V.shape, generator=gen,
                          dtype=torch.int32, device=dev) for V in (V1, V2))
        for what, (Vt, Ve) in cases.items():
            args = (Vt, e.c["tw"], R)
            kw = {"transpose_out": False, "signed": False}
            check(max_err, "fold_tw[transpose_out=False]",
                  K.fold_tw(*args, **kw), K.fold_tw_ref(*args, **kw),
                  f"R={R} B={Bx} {what}")
            check(max_err, "fold_end[whole-array]",
                  K.fold_end(Ve, e.mat2.R, signed=False),
                  K.fold_end_ref(Ve, e.mat2.R, signed=False),
                  f"R={e.mat2.R} B={Bx} {what}")
        phase("power parity", f"K1 untransposed and K3 at R={R}, B={Bx}: "
              f"{2 * len(cases)} cases bit-equal to the twins")
        return V1, V2

    gV1, gV2 = whole_array_parity(gk, GB)
    whole_array_parity(gk_big, GL_BIG_B)
    q = F.q
    pa, pb = F.rand((GB * GN,), rng, dev), F.rand((GB * GN,), rng, dev)
    pa[:3], pb[:3] = F.encode([q - 1, q - 1, 1], dev), F.encode(
        [q - 1, 0, q - 1], dev)
    for what, x, y in ((f"[{GB}, {GN}]", pa.view(GB, GN), pb.view(GB, GN)),
                       (f"[{GB * GN - 3}]", pa[3:], pb[3:])):
        check(max_err, "pointwise_mul", K.pointwise_mul(x, y),
              K.pointwise_mul_ref(x, y), what)
    torch.cuda.synchronize()
    phase("power parity", f"pointwise_mul on [{GB}, {GN}] and "
          f"[{GB * GN - 3}] bit-equal to its twin; done in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 15. the slice's main path, launches counted ------------------------
    a = FB.rand((BB_B, bb_ring.D), rng, dev)
    b = FB.rand((BB_B, bb_ring.D), rng, dev)
    a_big = F.rand((GL_BIG_B, big_ring.D), rng, dev)
    b_big = F.rand((GL_BIG_B, big_ring.D), rng, dev)

    def counts():
        return {**K.LAUNCHES, **KB.LAUNCHES}

    torch.cuda.synchronize()
    K.reset_launches()
    KB.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "bb mul": lambda: bb.mul(a, b),
        "bb stack_forward": lambda: bb_stacked.mul(a, b),
        "bb square": lambda: bb.square(a),
        "bb mul_cached": lambda: bb.mul_cached(a, bb.precompute(b)),
        "bb mul_cached_batch1": lambda: bb.mul_cached(a, bb.precompute(b[:1])),
        "gl mul": lambda: gk.mul(ga, gb),
        "gl mul_cached": lambda: gk.mul_cached(ga, gk.precompute(gb)),
        "gl mul_cached_batch1": lambda: gk.mul_cached(ga, gk.precompute(gch)),
        "gl square": lambda: gk.square(ga),
        "gl big mul": lambda: gk_big.mul(a_big, b_big),
    }
    results, per_variant = {}, {}
    for name, fn in runs.items():
        before = counts()
        results[name] = fn()
        per_variant[name] = {k: v - before[k] for k, v in counts().items()
                             if v != before[k]}
    # BASELINE config 2's invertibility check, through the ring API
    na = bb_ring.crt(a)
    one = bb_ring.ntt_mul(na, bb_ring.ntt_inv(na))
    torch.cuda.synchronize()
    launches = counts()
    phase("power path", f"{len(runs)} products (babybear deg {bb_ring.D} "
          f"B={BB_B}, goldilocks deg {GN} B={GB} and deg {big_ring.D} "
          f"B={GL_BIG_B}) and one invertibility check in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_variant}")

    t0 = time.perf_counter()
    pre = bb_plain.precompute(b)
    pre1 = bb_plain.precompute(b[:1])
    want = {"bb mul": bb_plain.mul(a, b), "bb square": bb_plain.square(a),
            "bb mul_cached": bb_plain.mul_cached(a, pre),
            "bb mul_cached_batch1": bb_plain.mul_cached(a, pre1)}
    want["bb stack_forward"] = want["bb mul"]
    ntt = {"bb mul": bb_ring.coeff_mul(a, b),
           "bb square": bb_ring.coeff_square(a),
           "bb mul_cached_batch1": bb_ring.coeff_mul(a, b[:1].expand_as(b))}
    ntt["bb stack_forward"] = ntt["bb mul_cached"] = ntt["bb mul"]
    for name, w in want.items():
        got = results[name]
        if got.shape != (BB_B, bb_ring.D) or got.dtype != torch.int32:
            raise AssertionError(f"{name}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        if ((got < 0) | (got >= FB.q)).any():
            raise AssertionError(f"{name}: non-canonical storage")
        if not torch.equal(got, w):
            raise AssertionError(f"{name}: kernel path differs from the "
                                 "plain MxuBBNTT on the card")
        if not torch.equal(got, ntt[name]):
            raise AssertionError(f"{name}: differs from NTTContext "
                                 "coeff_mul on the card")
    # the C++ schoolbook over q on canonical values
    ca, cb = (to_numpy_u32(FB.canon(x[:ORACLE_ROWS])).astype(np.uint64)
              for x in (a, b))
    with ThreadPoolExecutor(max_workers=3 * ORACLE_ROWS) as pool:
        rows = {k: np.stack(list(pool.map(
            lambda xy: negacyclic_mul_schoolbook_q(*xy, FB.q), pairs)))
            for k, pairs in (("ab", zip(ca, cb)), ("aa", zip(ca, ca)),
                             ("ab1", zip(ca, [cb[0]] * ORACLE_ROWS)))}
    for name, key in (("bb mul", "ab"), ("bb stack_forward", "ab"),
                      ("bb mul_cached", "ab"), ("bb square", "aa"),
                      ("bb mul_cached_batch1", "ab1")):
        got = to_numpy_u32(FB.canon(results[name][:ORACLE_ROWS]))
        if not np.array_equal(got.astype(np.uint64), rows[key]):
            raise AssertionError(f"{name}: differs from the schoolbook "
                                 "oracle")
    zeros = int((na == 0).sum())
    if not torch.equal(one, torch.where(na == 0, 0, FB.ones(na.shape, dev))):
        raise AssertionError("config 2: a * a^-1 != 1 in a nonzero slot")
    phase("power path", f"babybear: 5 variants bit-equal to MxuBBNTT and "
          f"to NTTContext coeff_mul on the whole batch, {ORACLE_ROWS} rows "
          f"to the C++ schoolbook over q; a * a^-1 = 1 in all "
          f"{na.numel() - zeros} nonzero slots ({zeros} zero slots) "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    for name, key, orc in (("gl mul", "mul", "ab"),
                           ("gl mul_cached", "mul_cached", "ab"),
                           ("gl mul_cached_batch1", "mul_cached_batch1", "ac"),
                           ("gl square", "square", "aa")):
        if not torch.equal(results[name], gl["results"][key]):
            raise AssertionError(f"{name}: mxu_ctx() differs from "
                                 "Mxu2FusedNTT")
        if not np.array_equal(to_numpy_u64(results[name][:ORACLE_ROWS]),
                              gl["orc"][orc]):
            raise AssertionError(f"{name}: differs from the schoolbook "
                                 "oracle")
    if not torch.equal(results["gl big mul"], big_ring.coeff_mul(a_big,
                                                                 b_big)):
        raise AssertionError(f"goldilocks deg {big_ring.D}: mxu_ctx() mul "
                             "differs from NTTContext coeff_mul")
    phase("power path", f"goldilocks: deg {GN} mul, mul_cached (batch "
          f"{GB} and 1) and square equal Mxu2FusedNTT and {ORACLE_ROWS} "
          f"schoolbook rows; deg {big_ring.D} mul equals NTTContext "
          f"coeff_mul ({time.perf_counter() - t0:.1f} s)")

    # -- 16. launch counts --------------------------------------------------
    phase("power launches", json.dumps(launches))
    rec_launches = {name: launches[name.split("[")[0]]
                    for name in POWER_KERNELS}
    for name, n in rec_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the power "
                                 "rings' path")

    # -- 17. timings ---------------------------------------------------------
    V1, V2i, V1i, Va, Vb, Vc = bbV
    R = bb.mat2.R
    Vs = torch.cat([Va, Vb], 1)
    u = {"signed": False}
    timed = [  # (record, kernel, shapes, args, kwargs)
        ("bb_fold_tw", "bb_fold_tw", shape(V1) + " transposed",
         (V1, bb.c["tw"], R), {"transpose_out": True, **u}),
        ("bb_fold_end2_mul", "bb_fold_end2_mul", shape(Va, Vb), (Va, Vb, R),
         u),
        ("bb_fold_end", "bb_fold_end", shape(V1i), (V1i, R), u),
        ("bb_fold_end2_mul", "bb_fold_end2_mul", "stacked " + shape(Vs),
         (Vs, None, R), u),
        ("bb_fold_end2_mul", "bb_fold_end2_mul", "batch-1 " + shape(Va, Vc),
         (Va, Vc, R), u),
    ]
    times = time_kernels(KB, timed, smi, "power time")
    del Vs
    pa = F.rand((gk.N2, GB, gk.N1), rng, dev)
    pb = F.rand((gk.N2, GB, gk.N1), rng, dev)
    times.update(time_kernels(K, [
        ("pointwise_mul", "pointwise_mul", shape(pa, pb), (pa, pb), {}),
        ("fold_tw[transpose_out=False]", "fold_tw",
         shape(gV1) + " untransposed", (gV1, gk.c["tw"], gk.mat1.R),
         {"transpose_out": False, **u}),
        ("fold_end[whole-array]", "fold_end", shape(gV2),
         (gV2, gk.mat2.R), u),
    ], smi, "power time"))

    plain_ms, kern_ms = in_turns(lambda: bb_plain.mul(a, b),
                                 lambda: bb.mul(a, b))
    phase("power time", f"babybear mul deg {bb_ring.D} B={BB_B}: "
          f"MxuBBFusedNTT (K4) " + ", ".join(
              f"{m:.3f} ms = {BB_B / m * 1e3:.1f} mults/s" for m in kern_ms)
          + "; plain MxuBBNTT " + ", ".join(
              f"{m:.3f} ms = {BB_B / m * 1e3:.1f} mults/s" for m in plain_ms)
          + f"  ({smi})")
    fused_ms, kern_ms = in_turns(lambda: gl["eng"].mul(ga, gb),
                                 lambda: gk.mul(ga, gb))
    phase("power time", f"goldilocks mul deg {GN} B={GB}: mxu_ctx() "
          f"Mxu2KernelNTT " + ", ".join(
              f"{m:.3f} ms = {GB / m * 1e3:.1f} mults/s" for m in kern_ms)
          + "; Mxu2FusedNTT " + ", ".join(
              f"{m:.3f} ms = {GB / m * 1e3:.1f} mults/s" for m in fused_ms)
          + f"  ({smi})")
    gemm = digit_gemms(bb, BB_B, rng)
    phase("power time", f"babybear digit GEMMs (planes, _int_mm "
          f"{shape(bb.c['w1'])} and offset terms) at B={BB_B}: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in gemm.items()) + f"  ({smi})")
    # the host cost of a launch, timed as the kernels are (device clock,
    # groups of back-to-back launches of a 1-element kernel): through the
    # wrapper (checks, allocation, ctypes, launch) and through
    # _build.launch alone (ctypes, launch), which every launch-bound call
    # pays per launch; counted apart from LAUNCHES
    one = F.encode([1], dev)
    out = torch.empty_like(one)
    fn = _build.kernels().srt_pointwise_mul
    ptrs = (one.data_ptr(), one.data_ptr(), out.data_ptr(), 1, 1)
    scratch = {"pointwise_mul": 0}
    launch_us = {
        label: time_ms(call, inner=LAUNCH_REPS) * 1e3 for label, call in (
            ("wrapper", lambda: K.pointwise_mul(one, one)),
            ("_build.launch", lambda: _build.launch(
                scratch, "pointwise_mul", fn, dev, *ptrs)))}
    phase("power time", f"host cost of one launch (pointwise_mul on 1 "
          f"element, median of {REPS} groups of {LAUNCH_REPS}): " + ", ".join(
              f"{k} {v:.2f} us" for k, v in launch_us.items()) + f"  ({smi})")

    # -- 18. where the device time of one BabyBear mul goes -----------------
    busy_ms, wall_ms, top = device_profile(lambda: bb.mul(a, b), 3, dev, 8)
    phase("power profile", f"babybear mul deg {bb_ring.D} B={BB_B}: device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (profiled), idle "
          f"share {1 - busy_ms / wall_ms:.3f}; per mul: {top}  ({smi})")

    return [record(name, src, ref, rec_launches[name], max_err[name],
                   *times[name])
            for name, (src, ref) in POWER_KERNELS.items()]


def py_check_proof(f, tables, chal, msgs, finals, what) -> None:
    """The sumcheck relations in Python ints over canonical values: the
    round-0 claim p(0) + p(1) equals sum_x prod_j T_j(x), every later
    round's p_i(0) + p_i(1) equals p_{i-1}(r_{i-1}), and the last round's
    p(r) equals the product of the finals."""
    import numpy as np

    q = f.q
    prod = None
    for T in tables:
        c = np.asarray(f.decode(T), dtype=object)
        prod = c if prod is None else prod * c % q
    claim = int(np.sum(prod)) % q
    m = f.decode(msgs).tolist()
    rs = f.decode(chal).tolist()
    for i, (ys, r) in enumerate(zip(m, rs)):
        if (ys[0] + ys[1]) % q != claim:
            raise AssertionError(f"{what}: round {i}: p(0) + p(1) != the "
                                 "claim in Python ints")
        claim = py_lagrange(ys, r, q)
    last = 1
    for v in finals:
        last = last * int(f.decode(v)) % q
    if claim != last:
        raise AssertionError(f"{what}: p_last(r) != the product of the "
                             "finals in Python ints")


def slice_c(dev, smi, rng) -> list:
    """Phases 19-23: sumcheck over BabyBear and frog, and over batched
    Goldilocks claims.  Returns the kernels' JSON records."""
    import torch

    from stark_rings_tpu_torch import GOLDILOCKS as F, get_field
    from stark_rings_tpu_torch.examples import sumcheck as example
    from stark_rings_tpu_torch.examples.wrapper_times import wide_times
    from stark_rings_tpu_torch.linalg import FieldElems
    from stark_rings_tpu_torch.mle import DenseMLE
    from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
    from stark_rings_tpu_torch.mle.sumcheck import bit_reverse_table
    from stark_rings_tpu_torch.ops import _build
    from stark_rings_tpu_torch.rings import Transcript

    fields = {name: get_field(name) for name in SC_FIELDS}

    def table(f, nv, kind):
        if kind == "zeros":
            return f.zeros((1 << nv,), dev)
        if kind == "q-1":
            return f.encode([f.q - 1], dev).expand(1 << nv).contiguous()
        return f.rand((1 << nv,), rng, dev)

    # -- 19. parity against the twins, and the relations in Python ints -----
    max_err = {name: 0 for name in FIELD_KERNELS}
    t0 = time.perf_counter()
    cases = 0
    for name, f in fields.items():
        rec = f"sumcheck_prove_many_{name}"
        for nv in (*NV_SMALL, NV):
            chal = f.rand((nv,), rng, dev)
            for kind in ("zeros", "q-1", "random") if nv == NV \
                    else ("random",):
                for k in (2, 3):
                    tables = [table(f, nv, kind) for _ in range(k)]
                    msgs, finals = SK.sumcheck_prove_many(tables, chal,
                                                          field=name)
                    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal,
                                                                name)
                    what = f"nv={nv} k={k} {kind}"
                    check(max_err, rec, msgs, want_m, what)
                    check(max_err, rec, torch.stack(finals),
                          torch.stack(want_f), what)
                    if kind == "random":
                        py_check_proof(f, tables, chal, msgs, finals,
                                       f"{rec} {what}")
                    cases += 1
    Wt = [F.rand((SC_W, 1 << NV), rng, dev) for _ in range(2)]
    wc = F.rand((NV,), rng, dev)
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(Wt, wc)
    batch_twin = SK.sumcheck_prove_batch_ref(Wt, wc)
    rec = "sumcheck_prove_batch_goldilocks"
    check(max_err, rec, msgs, batch_twin[0], f"W={SC_W} nv={NV} k=2")
    check(max_err, rec, torch.stack(finals), torch.stack(batch_twin[1]),
          f"W={SC_W} nv={NV} k=2 finals")
    Mt = [F.rand((SC_W_MAX, 1 << SC_NV_MANY), rng, dev) for _ in range(2)]
    mc = F.rand((SC_NV_MANY,), rng, dev)
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(Mt, mc)
    for w in (0, SC_W_MAX // 2, SC_W_MAX - 1):
        want_m, want_f = SK.sumcheck_prove_many_ref([T[w] for T in Mt], mc)
        what = f"W={SC_W_MAX} nv={SC_NV_MANY} k=2 claim {w}"
        check(max_err, rec, msgs[w], want_m, what)
        check(max_err, rec, torch.stack([x[w] for x in finals]),
              torch.stack(want_f), what + " finals")
    # K7's card limits: k > 8 tables run the run-time-k kernel, one launch
    # a proof, nv = 0 is the empty proof with no launch, and a batch over
    # one launch's claims runs in chunks
    T0 = [F.rand((1,), rng, dev) for _ in range(2)]
    c0 = torch.empty(0, dtype=torch.int64, device=dev)
    limits = [(f"{name} k={k} nv={nv}", name,
               [get_field(name).rand((1 << nv,), rng, dev)
                for _ in range(k)], get_field(name).rand((nv,), rng, dev), 1)
              for name, k, nv in (("goldilocks", 9, SC_NV_K9),
                                  ("goldilocks", 16, SC_NV_WIDE),
                                  ("babybear", 9, SC_NV_K9),
                                  ("frog", 9, SC_NV_K9))]
    limits.append(("goldilocks nv=0", "goldilocks", T0, c0, 0))
    for what, name, tables, chal, want in limits:
        rec_w = f"sumcheck_prove_many_{name}"
        before = SK.LAUNCHES[rec_w]
        m, fs = SK.sumcheck_prove_many(tables, chal, field=name)
        launched = SK.LAUNCHES[rec_w] - before
        wm, wf = SK.sumcheck_prove_many_ref(tables, chal, name)
        check(max_err, rec_w, m, wm, what)
        check(max_err, rec_w, torch.stack(fs), torch.stack(wf),
              what + " finals")
        if not m.is_cuda or launched != want:
            raise AssertionError(f"K7 {what}: {launched} launches on "
                                 f"{m.device}, not {want} on the card")
    Ot = [F.rand((SC_W_OVER, 2), rng, dev) for _ in range(2)]
    oc = F.rand((1,), rng, dev)
    before = SK.LAUNCHES[rec]
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(Ot, oc)
    over = SK.LAUNCHES[rec] - before
    want_m, want_f = SK.sumcheck_prove_batch_ref(Ot, oc)
    what = f"W={SC_W_OVER} nv=1 k=2"
    check(max_err, rec, msgs, want_m, what)
    check(max_err, rec, torch.stack(finals), torch.stack(want_f),
          what + " finals")
    if over != 2:
        raise AssertionError(f"{what}: {over} launches, not 2 chunks of 1")
    torch.cuda.synchronize()
    phase("fields parity", f"K7's card limits: k=9 at nv={SC_NV_K9} over "
          f"the three fields and k=16 at nv={SC_NV_WIDE} over goldilocks on "
          f"the run-time-k kernel (one launch each) and nv=0 (the "
          f"empty proof, no launch) equal the generic prover; the "
          f"W={SC_W_OVER}, nv=1 batch equals its twin in {over} launches "
          f"(2 chunks of one)")
    # every K of the persistent kernel at nv = 20, one launch each: the
    # grid and its resident blocks an SM
    grids = {}
    for name in ("goldilocks", *SC_FIELDS):
        f = get_field(name)
        rec_k = f"sumcheck_prove_many_{name}"
        chal = f.rand((NV,), rng, dev)
        for k in range(1, 9):
            tables = [f.rand((1 << NV,), rng, dev) for _ in range(k)]
            before = SK.LAUNCHES[rec_k]
            msgs, finals = SK.sumcheck_prove_many(tables, chal, field=name)
            launched = SK.LAUNCHES[rec_k] - before
            want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal, name)
            what = f"nv={NV} k={k} random"
            check(max_err, rec_k, msgs, want_m, what)
            check(max_err, rec_k, torch.stack(finals), torch.stack(want_f),
                  what)
            if launched != 1:
                raise AssertionError(f"K7 {name} {what}: {launched} launches")
            grids[(name, k)] = SK.LAST_GRID[rec_k]
            cases += 1
    regs = k7_registers()
    ops = {"goldilocks": "GlOps", "babybear": "BbOps", "frog": "FrogOps"}
    usage = []
    for (name, k), (g, b) in grids.items():
        reg, stack = regs[(ops[name], f"{k:02d}")]
        usage.append(f"{name} {k}: {reg} regs, {stack} B stack, {g} blocks, "
                     f"{b}/SM")
    usage += [f"{o} wide: {reg} regs, {stack} B stack"
              for (o, k), (reg, stack) in sorted(regs.items()) if k == "wide"]
    phase("fields parity", "K7's persistent kernel at nv=20, k=1..8, "
          "bit-equal to the generic prover in one launch each; registers a "
          "thread "
          "(from the built library; stack = spilled bytes), grid and "
          "resident blocks an SM: " + "; ".join(usage))
    phase("fields parity", f"{cases} K7 cases over {'/'.join(SC_FIELDS)} "
          f"(nv={NV_SMALL} random, nv={NV} zeros/q-1/random; k=2, 3) and "
          f"the W={SC_W} Goldilocks batch bit-equal to their twins, and "
          f"claims 0, {SC_W_MAX // 2}, {SC_W_MAX - 1} of a W={SC_W_MAX}, "
          f"nv={SC_NV_MANY} batch to theirs; the "
          f"random nv={NV} proofs hold the sumcheck relations in Python "
          f"ints; {time.perf_counter() - t0:.1f} s")

    # -- 20. the path, launches counted ---------------------------------------
    torch.cuda.synchronize()
    SK.reset_launches()
    t0 = time.perf_counter()
    proofs = {}
    for name, f in fields.items():
        e = FieldElems(f, dev)
        g, h = DenseMLE.rand(e, NV, rng), DenseMLE.rand(e, NV, rng)
        t1 = time.perf_counter()
        S, msgs, chals = example.prove(g.evals, h.evals,
                                       Transcript(b"smoke"), NV, f)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t1
        if not example.verify(S, msgs, g, h, Transcript(b"smoke")):
            raise AssertionError(f"{name}: the honest nv={NV} proof was "
                                 "rejected")
        bad = [list(m) for m in msgs]
        bad[NV // 2][1] = f.add(bad[NV // 2][1], f.const(1, dev))
        if example.verify(S, [tuple(m) for m in bad], g, h,
                          Transcript(b"smoke")):
            raise AssertionError(f"{name}: a proof with one message changed "
                                 "by +1 was accepted")
        chal = torch.stack(chals)
        m7, f7 = SK.sumcheck_prove_many(
            [bit_reverse_table(g.evals), bit_reverse_table(h.evals)], chal,
            field=name)
        if u64_err(m7, torch.stack([torch.stack(m) for m in msgs]), "K7") \
                or u64_err(torch.stack(f7), torch.stack(
                    [g.evaluate(chals), h.evaluate(chals)]), "K7 finals"):
            raise AssertionError(f"{name}: K7 on the bit-reversed tables does "
                                 "not reproduce the proof")
        proofs[name] = prove_s
    batch = SK.sumcheck_prove_batch_goldilocks(Wt, wc)
    singles = [SK.sumcheck_prove_many_goldilocks([T[w] for T in Wt], wc)
               for w in range(SC_W)]
    torch.cuda.synchronize()
    launches = dict(SK.LAUNCHES)
    for w, (m, fs) in enumerate(singles):
        if u64_err(batch[0][w], m, "batch") or u64_err(
                torch.stack([x[w] for x in batch[1]]), torch.stack(fs),
                "batch finals"):
            raise AssertionError(f"batch claim {w} differs from its single "
                                 "K7 proof")
    if u64_err(batch[0], batch_twin[0], "batch twin"):
        raise AssertionError("the batch differs from its twin")
    phase("fields path", f"nv={NV} Fiat-Shamir proofs " + ", ".join(
        f"{n} prove {v:.3f} s" for n, v in proofs.items())
        + "; each verified through DenseMLE.evaluate, a tampered one "
        f"rejected, and reproduced by K7 on the bit-reversed tables; the "
        f"W={SC_W} batch equals {SC_W} single K7 proofs and its twin; "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 21. launch counts ----------------------------------------------------
    phase("fields launches", json.dumps(launches))
    for name in FIELD_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the path")
    for name in FIELD_KERNELS:     # one proof (one batch) each: 1 launch
        if launches[name] != 1:
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 "one proof, not 1")

    # -- 22. timings ----------------------------------------------------------
    times = {}
    timed = []
    for name, f in fields.items():
        for k in (2, 3):
            tables = [f.rand((1 << NV,), rng, dev) for _ in range(k)]
            chal = f.rand((NV,), rng, dev)
            timed.append((f"sumcheck_prove_many_{name}", f"nv={NV} k={k}",
                          lambda t=tables, c=chal, n=name:
                          SK.sumcheck_prove_many(t, c, field=n),
                          lambda t=tables, c=chal, n=name:
                          SK.sumcheck_prove_many_ref(t, c, n),
                          (tables, chal), k == 2))
    timed.append(("sumcheck_prove_batch_goldilocks", f"W={SC_W} nv={NV} k=2",
                  lambda: SK.sumcheck_prove_batch_goldilocks(Wt, wc),
                  lambda: SK.sumcheck_prove_batch_ref(Wt, wc), (Wt, wc),
                  True))
    for name, label, kern, twin, inputs, with_twin in timed:
        moved = nbytes(inputs, kern())
        ms = time_ms(kern, inner=10)
        plain = ""
        if with_twin:      # the recorded case of each kernel
            plain_ms = time_ms(twin)
            times[name] = (ms, plain_ms, moved)
            plain = f", plain {plain_ms:.4f} ms"
        floor = moved / HBM_BYTES_PER_S * 1e3
        unit = "batches" if "batch" in name else "proofs"
        phase("fields time", f"{name} {label}: kernel {ms:.4f} ms = "
              f"{1e3 / ms:.1f} {unit}/s{plain}, memory floor {floor:.4f} ms "
              f"({moved} B)  ({smi})")

    def four_singles():
        for w in range(SC_W):
            SK.sumcheck_prove_many_goldilocks([T[w] for T in Wt], wc)

    t = [time_ms(fn) for fn in (four_singles, timed[-1][2], timed[-1][2],
                                four_singles)]
    phase("fields time", f"W={SC_W} claims at nv={NV}, k=2: one batch "
          f"{t[1]:.4f} / {t[2]:.4f} ms = {SC_W * 1e3 / t[1]:.1f} claims/s; "
          f"{SC_W} single K7 proofs {t[0]:.4f} / {t[3]:.4f} ms = "
          f"{SC_W * 1e3 / t[0]:.1f} claims/s (in turns)  ({smi})")
    # K7 beyond 8 tables, the run-time-k kernel: wall, busy and host time
    # of a proof against its bound (each table read once; the modmuls of
    # its own loop, (k+1)(k-1) products and k folds an entry pair, at the
    # card's peak) and the one-launch floor (_build.launch of a 1-element
    # kernel, as phase 12 times it)
    peak = modmul_peak(dev)[0]
    one = F.encode([1], dev)
    floor_us = 1e3 * time_ms(lambda: _build.launch(
        {"floor": 0}, "floor", _build.kernels().srt_pointwise_mul, dev,
        one.data_ptr(), one.data_ptr(), torch.empty_like(one).data_ptr(), 1,
        1), inner=LAUNCH_REPS)
    for (nv, k), (n, wall, busy, host) in wide_times(
            dev, rng, SC_WIDE_TIMED).items():
        moved = 8 * ((k << nv) + nv * (k + 1) + k)
        modmuls = ((k + 1) * (k - 1) + k) * ((1 << nv) - 1)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = modmuls / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        phase("fields time", f"goldilocks nv={nv} k={k} (run-time-k "
              f"kernel): {n} launch(es) a proof, wall {wall:.4f} ms, busy "
              f"{busy:.4f} ms, host {host:.2f} us against the one-launch "
              f"floor {floor_us:.2f} us; {moved} B ({bytes_ms:.4f} ms), "
              f"{modmuls} modmuls ({ops_ms:.4f} ms at {peak:.4e}/s), bound "
              f"{bound:.4f} ms, {bound / wall:.0%} of the wall  ({smi})")
        if n != 1:
            raise AssertionError(f"K7 nv={nv} k={k}: {n} launches a proof")

    # -- 23. where the device time goes ---------------------------------------
    for name, label, kern, _, _, with_twin in timed:
        if not with_twin:
            continue
        busy_ms, wall_ms, top = device_profile(kern, 10, dev, 2)
        phase("fields profile", f"{name} {label}: device busy {busy_ms:.4f} "
              f"ms of {wall_ms:.4f} ms wall (profiled), idle share "
              f"{1 - busy_ms / wall_ms:.3f}; {top}  ({smi})")
        k7_summary(name.removeprefix("sumcheck_prove_"), times[name][0],
                   busy_ms, kern, smi)

    return [record(name, MLE_SOURCE, ref, launches[name], max_err[name],
                   *times[name]) for name, ref in FIELD_KERNELS.items()]


def slice_ntt(dev, smi, rng, gl) -> list:
    """Phases 24-28: the Goldilocks NTT engines, the radix engine
    ``GoldilocksKernelNTT`` at N = 2^16, B = 80 on Slice A's operands,
    ``MatmulNTT`` at N = 2^14 on ``MxuModMat`` and on the fused mod-mat
    kernel, and ``pointwise_chain``.  ``gl`` holds Slice A's operands,
    its fused engine ``eng``, the engine's ``results`` and the
    schoolbook rows ``orc``.  Returns the kernels' JSON records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import GOLDILOCKS as F, NTTContext, to_numpy_u64
    from stark_rings_tpu_torch.fields.field import u64_lt
    from stark_rings_tpu_torch.ops import fold as K
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.ops import _build
    from stark_rings_tpu_torch.ops import mxu_fused as MF
    from stark_rings_tpu_torch.ops.mxu import (DIGITS, MatmulNTT, MxuModMat,
                                               data_digits)

    a, b = gl["a"], gl["b"]
    Bx, Nx = a.shape
    q = F.q
    t0 = time.perf_counter()
    radix = G.GoldilocksKernelNTT(Nx, device=dev)
    ctx = NTTContext(F, Nx, device=dev)
    small = {n: (G.GoldilocksKernelNTT(n, device=dev),
                 NTTContext(F, n, device=dev)) for n in NTT_SIZES}
    mm = MatmulNTT(MM_N, device=dev)
    # the fused kernel on each of MatmulNTT's four level matrices, and a
    # MatmulNTT whose levels are those
    levels = {k: (getattr(mm, k), MF.MxuModMatFused(getattr(mm, k).matrix(),
                                                    device=dev))
              for k in MM_LEVELS}
    mm_fused = copy.copy(mm)
    for k, (_, fused) in levels.items():
        setattr(mm_fused, k, fused)
    phase("engine tables", f"GoldilocksKernelNTT (N={Nx}, "
          f"{'/'.join(map(str, NTT_SIZES))}; {radix.passes} device-memory "
          f"passes at N={Nx}) and MatmulNTT (N={MM_N}, MxuModMat and fused "
          f"levels) built in {time.perf_counter() - t0:.1f} s")

    # -- 24. kernel parity at the engines' shapes --------------------------
    max_err = {}
    t0 = time.perf_counter()
    cases = 0
    wf, wi, ninv = radix.tables()
    for s in range(radix.passes):
        for inverse, scale in ((False, None), (True, None), (True, ninv)):
            w = wi if inverse else wf
            check(max_err, "ntt_stage",
                  G.ntt_stage(a, w, s, inverse=inverse, ninv=scale),
                  G.ntt_stage_ref(a, w, s, inverse=inverse, ninv=scale),
                  f"N={Nx} B={Bx} s={s} inverse={inverse} "
                  f"scaled={scale is not None}")
            cases += 1
    for mode in ("forward", "inverse", "mul_eval"):
        args = (a, wf, wi, ninv, radix.log_tile, mode, b)
        check(max_err, "ntt_tile", G.ntt_tile(*args), G.ntt_tile_ref(*args),
              f"N={Nx} B={Bx} {mode}")
        cases += 1
    # every mode at several log_tiles: the tile the whole row (mul when
    # 2N <= 2^LOG_TILE), and the tiles of 4 rows of the 2^16 operands
    for L in NTT_TILE_LOGS:
        if L > G.LOG_TILE:
            continue
        wt = G.GoldilocksKernelNTT(1 << L, device=dev).tables()
        xw, ow = (F.rand((Bx, 1 << L), rng, dev) for _ in range(2))
        for mode in G.MODES:
            if mode == "mul" and 2 << L > 1 << G.LOG_TILE:
                continue
            args = (xw, *wt, L, mode, ow)
            check(max_err, "ntt_tile", G.ntt_tile(*args),
                  G.ntt_tile_ref(*args), f"N=2^{L} B={Bx} {mode}")
            cases += 1
        for mode in ("forward", "inverse", "mul_eval"):
            args = (a[:4], wf, wi, ninv, L, mode, b[:4])
            check(max_err, "ntt_tile", G.ntt_tile(*args),
                  G.ntt_tile_ref(*args), f"N={Nx} B=4 log_tile {L} {mode}")
            cases += 1
    e10, _ = small[NTT_SIZES[0]]
    x10 = F.rand((Bx, e10.N), rng, dev)
    y10 = F.rand((Bx, e10.N), rng, dev)
    w10 = e10.tables()
    args = (x10, *w10, e10.log_tile, "mul", y10)
    check(max_err, "ntt_tile", G.ntt_tile(*args), G.ntt_tile_ref(*args),
          f"N={e10.N} B={Bx} mul")
    cases += 1
    n = Bx * Nx
    pa = F.rand((n,), rng, dev)
    pa[:2] = F.encode([q - 1, 0], dev)
    for depth, x, y in ((CHAIN_DEPTH, pa.view(Bx, Nx), b), (0, pa[:n - 3],
                                                            b.view(-1)[3:]),
                        (CHAIN_DEPTH, pa[:n - 3], b.view(-1)[3:])):
        check(max_err, "pointwise_chain", K.pointwise_chain(x, y, depth),
              K.pointwise_chain_ref(x, y, depth),
              f"depth {depth} {tuple(x.shape)}")
        cases += 1
    check(max_err, "pointwise_mul[GoldilocksKernelNTT.pointwise]",
          radix.pointwise(a, b), K.pointwise_mul_ref(a, b), f"[{Bx}, {Nx}]")
    cases += 1
    cols = Bx * mm.N2
    xs = {M: F.rand((mm.N1, M), rng, dev) for M in (cols, cols + 37)}
    edge = F.encode([q - 1, 0, 1], dev)
    for x in xs.values():
        x[:, :3] = edge
        x[:, 3] = -1                    # the word 2^64 - 1
    for key, (plain, fused) in levels.items():
        for M, x in xs.items():
            check(max_err, "mxu_mod_mat", fused.apply(x), plain.apply(x),
                  f"{key} M={M} against MxuModMat")
            cases += 1
        xt = xs[cols][:, :MM_TWIN_COLS].contiguous()
        check(max_err, "mxu_mod_mat", fused.apply(xt),
              MF.mxu_mod_mat_ref(xt, fused.w),
              f"{key} M={MM_TWIN_COLS} against the twin")
        cases += 1
    # R, C and M off the kernel's 64 x 32 tile and 32-column chunk
    for R, C, M in MM_RAGGED:
        rag = MF.MxuModMatFused(
            [[int(v) for v in row] for row in rng.integers(
                0, q, (R, C), dtype=np.uint64)], device=dev)
        xr = F.rand((C, M), rng, dev)
        xr[:, :3] = edge
        xr[:, 3] = -1
        got = rag.apply(xr)
        check(max_err, "mxu_mod_mat", got, MxuModMat(rag.matrix(),
                                                     device=dev).apply(xr),
              f"R={R} C={C} M={M} against MxuModMat")
        check(max_err, "mxu_mod_mat", got, MF.mxu_mod_mat_ref(xr, rag.w),
              f"R={R} C={C} M={M} against the twin")
        cases += 2
    torch.cuda.synchronize()
    phase("engine parity", f"{cases} cases of ntt_stage, ntt_tile, "
          f"pointwise_chain, the pointwise kernel and mxu_mod_mat bit-equal "
          f"to their twins (and mxu_mod_mat to MxuModMat on the four level "
          f"matrices at M={cols} and {cols + 37}); "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 25. the slice's main path, launches counted -----------------------
    mods = (K, G, MF)

    def counts():
        return {**K.LAUNCHES, **G.LAUNCHES, **MF.LAUNCHES}

    a14, b14 = (F.rand((Bx, MM_N), rng, dev) for _ in range(2))
    x10b = F.rand((Bx, e10.N), rng, dev)
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "radix forward": lambda: radix.forward(a),
        "radix inverse": lambda: radix.inverse(a),
        "radix mul": lambda: radix.mul(a, b),
        "radix mul_composite": lambda: radix.mul_composite(a, b),
        f"radix mul N={NTT_SIZES[0]}": lambda: e10.mul(x10, x10b),
        f"radix mul N={MM_N}": lambda: small[MM_N][0].mul(a14, b14),
        "MatmulNTT mul": lambda: mm.mul(a14, b14),
        "MatmulNTT mul (fused levels)": lambda: mm_fused.mul(a14, b14),
        "chain": lambda: K.pointwise_chain(a, b, CHAIN_DEPTH),
    }
    results, per_variant = {}, {}
    for name, fn in runs.items():
        before = counts()
        results[name] = fn()
        per_variant[name] = {k: v - before[k] for k, v in counts().items()
                             if v != before[k]}
    torch.cuda.synchronize()
    launches = counts()
    phase("engine path", f"{len(runs)} calls in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_variant}")

    t0 = time.perf_counter()
    want = {"radix forward": ctx.forward(a), "radix inverse": ctx.inverse(a),
            "radix mul": ctx.mul(a, b)}
    want["radix mul_composite"] = want["radix mul"]
    want[f"radix mul N={NTT_SIZES[0]}"] = small[NTT_SIZES[0]][1].mul(x10,
                                                                     x10b)
    want14 = small[MM_N][1].mul(a14, b14)
    for name in (f"radix mul N={MM_N}", "MatmulNTT mul",
                 "MatmulNTT mul (fused levels)"):
        want[name] = want14
    want["chain"] = K.pointwise_chain_ref(a, b, CHAIN_DEPTH)
    qmax = F.encode([q - 1], dev)
    for name, got in results.items():
        if got.shape != want[name].shape or got.dtype != torch.int64:
            raise AssertionError(f"{name}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        if u64_lt(qmax, got).any():
            raise AssertionError(f"{name}: non-canonical output")
        if not torch.equal(got, want[name]):
            raise AssertionError(f"{name}: differs from its plain reference "
                                 "(NTTContext, or the chain's twin)")
    if not torch.equal(results["radix mul"], gl["results"]["mul"]):
        raise AssertionError("radix mul differs from Mxu2FusedNTT.mul")
    if not torch.equal(results[f"radix mul N={MM_N}"],
                       results["MatmulNTT mul"]):
        raise AssertionError("MatmulNTT.mul differs from the radix mul")
    if not np.array_equal(to_numpy_u64(results["radix mul"][:ORACLE_ROWS]),
                          gl["orc"]["ab"]):
        raise AssertionError("radix mul differs from the schoolbook oracle")
    phase("engine path", f"radix forward / inverse / mul / mul_composite at "
          f"N={Nx}, B={Bx} bit-equal to NTTContext, mul to Mxu2FusedNTT.mul "
          f"and {ORACLE_ROWS} schoolbook rows; mul at N={NTT_SIZES[0]} and "
          f"{MM_N} to NTTContext; MatmulNTT.mul (MxuModMat and fused "
          f"levels) at N={MM_N}, B={Bx} to the radix mul and NTTContext; "
          f"the depth-{CHAIN_DEPTH} chain to its twin "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 26. launch counts ---------------------------------------------------
    phase("engine launches", json.dumps(launches))
    rec_launches = {name: launches[name.split("[")[0]]
                    for name in ENGINE_KERNELS}
    for name, cnt in rec_launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} was never launched on the engines' "
                                 "path")

    # -- 27. timings ---------------------------------------------------------
    times, ops_ms = {}, {}
    rate, per, mix, sms, mhz = modmul_peak(dev)
    phase("engine time", f"modmul peak {rate:.4e} Goldilocks modmuls/s: "
          f"gl::mul is {per} SASS instructions ({json.dumps(mix)}), "
          f"{sms} SMs x {ISSUE_PER_SM_CLOCK} per clock x {mhz:.0f} MHz  "
          f"({smi})")
    deep_ms = time_ms(lambda: K.pointwise_chain(a, b, CHAIN_DEEP))
    chain_rate = CHAIN_DEEP * n / (deep_ms * 1e-3)
    phase("engine time", f"pointwise_chain depth {CHAIN_DEEP} on [{Bx}, "
          f"{Nx}]: {deep_ms:.4f} ms = {chain_rate:.4e} Goldilocks "
          f"modmuls/s (dependent chains, one per thread), "
          f"{chain_rate / rate:.0%} of the peak  ({smi})")

    def timed(key, kern, twin, inputs, modmuls, label):
        moved = nbytes(inputs, kern())
        ms = time_ms(kern, inner=10)
        plain_ms = time_ms(twin)
        times[key] = (ms, plain_ms, moved)
        ops_ms[key] = modmuls / rate * 1e3
        floor = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms[key])
        phase("engine time", f"{key} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; {moved} B, {modmuls} modmuls, bound "
              f"{floor:.4f} ms ({floor / ms:.0%} of it)  ({smi})")

    timed("pointwise_chain", lambda: K.pointwise_chain(a, b, CHAIN_DEPTH),
          lambda: K.pointwise_chain_ref(a, b, CHAIN_DEPTH), (a, b),
          CHAIN_DEPTH * n, f"depth {CHAIN_DEPTH} [{Bx}, {Nx}]")
    # stage s reads twiddles [2^s, 2^(s+1)): one word at s = 0; the tile,
    # stages passes.. logN - 1, reads [2^passes, N) of both tables
    timed("ntt_stage", lambda: G.ntt_stage(a, wf, 0),
          lambda: G.ntt_stage_ref(a, wf, 0, inverse=False), (a, wf[1:2]),
          n // 2, f"forward s=0 [{Bx}, {Nx}]")
    targs = (a, wf, wi, ninv, radix.log_tile, "mul_eval", b)
    lo = 1 << radix.passes
    timed("ntt_tile", lambda: G.ntt_tile(*targs),
          lambda: G.ntt_tile_ref(*targs), (a, b, wf[lo:], wi[lo:]),
          Bx * (radix.log_tile * Nx + Nx), f"mul_eval [{Bx}, {Nx}]")
    # the forward and inverse tiles: one direction's stages, the same
    # modmuls; x, the result and the direction's twiddles [2^passes, N)
    for mode, w in (("forward", wf), ("inverse", wi)):
        dargs = (a, wf, wi, ninv, radix.log_tile, mode)
        timed(f"ntt_tile {mode}", lambda: G.ntt_tile(*dargs),
              lambda: G.ntt_tile_ref(*dargs), (a, w[lo:]),
              Bx * radix.log_tile * Nx // 2, f"[{Bx}, {Nx}]")
    timed("pointwise_mul[GoldilocksKernelNTT.pointwise]",
          lambda: radix.pointwise(a, b), lambda: K.pointwise_mul_ref(a, b),
          (a, b), n, f"[{Bx}, {Nx}]")
    plain, fused = levels["col_mat"]
    x = xs[cols]
    moved = nbytes(x, fused.apply(x)) + fused.planes.size
    macs = DIGITS * DIGITS * fused.R * fused.C * cols
    ms = time_ms(lambda: fused.apply(x), inner=10)
    plain_ms = time_ms(lambda: MF.mxu_mod_mat_ref(x, fused.w))
    times["mxu_mod_mat"] = (ms, plain_ms, moved)
    ops_ms["mxu_mod_mat"] = 2 * macs / INT8_OPS_PER_S * 1e3
    w_big = torch.from_numpy(fused.big).to(dev)
    xcat = data_digits(x).reshape(DIGITS * fused.C, cols)
    xcat_t = xcat.t().contiguous().t()
    # the product alone: a yardstick, not the same function (no digits,
    # no fold), so no library time in the record
    int_mm_ms = time_ms(lambda: torch._int_mm(w_big, xcat_t))
    mm_level_ms = time_ms(lambda: plain.apply(x))
    floor = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms["mxu_mod_mat"])
    phase("engine time", f"mxu_mod_mat [{fused.R}, {fused.C}] x [{fused.C}, "
          f"{cols}]: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
          f"MxuModMat.apply (_int_mm + torch fold) {mm_level_ms:.4f} ms, "
          f"_int_mm {shape(w_big, xcat_t)} alone "
          f"{int_mm_ms:.4f} ms; {moved} B, {macs} int8 MACs, "
          f"bound {floor:.4f} ms ({floor / ms:.0%} of it)  ({smi})")
    imma, ops, usage = mxu_sass()
    phase("engine time", f"mxu_mod_mat_kernel in the built library: {imma} "
          f"tensor-core integer MMA instructions ({ops}); {usage}, "
          f"{_build.kernels().srt_mxu_mod_mat_smem()} B of dynamic shared "
          f"memory")

    mxu_ms, rad_ms = in_turns(lambda: gl["eng"].mul(a, b),
                              lambda: radix.mul(a, b))
    ctx_ms = time_ms(lambda: ctx.mul(a, b))
    mm_ms = {"MatmulNTT": time_ms(lambda: mm.mul(a14, b14)),
             "MatmulNTT fused levels": time_ms(lambda: mm_fused.mul(a14,
                                                                    b14)),
             "radix": time_ms(lambda: small[MM_N][0].mul(a14, b14))}
    mul_moved = nbytes(a, b, a, wf[1:], wi[1:])   # entry 0 is never read
    mul_mm = Bx * (3 * (Nx // 2) * radix.logN + 2 * Nx)
    def rates(ms):
        return ", ".join(f"{m:.4f} ms = {Bx / m * 1e3:.1f} mults/s"
                         for m in ms)

    bound = max(mul_moved / HBM_BYTES_PER_S * 1e3, mul_mm / rate * 1e3)
    phase("engine time", f"mul N={Nx} B={Bx}: GoldilocksKernelNTT "
          f"{rates(rad_ms)}; Mxu2FusedNTT {rates(mxu_ms)} (in turns); "
          f"NTTContext {ctx_ms:.4f} ms; {mul_moved} B, {mul_mm} modmuls, "
          f"bound {bound:.4f} ms  ({smi})")
    # LOG_TILE against the other tile size the kernel takes: a 2^13 tile
    # lets two blocks share an SM, a 2^14 tile saves one pass a transform
    kept = G.LOG_TILE
    alt = 13 if kept == 14 else 14
    try:
        G.LOG_TILE = alt
        alts = {n: G.GoldilocksKernelNTT(n, device=dev) for n in (Nx, MM_N)}
        G.LOG_TILE = max(kept, alt)
        tile_ms = {}
        for e, x, y in ((radix, a, b), (small[MM_N][0], a14, b14)):
            e_alt = alts[e.N]
            if not torch.equal(e_alt.mul(x, y), e.mul(x, y)):
                raise AssertionError(f"radix mul N={e.N} at log_tile {alt} "
                                     "differs")
            tile_ms[e.N] = (e.passes, e_alt.passes,
                            *in_turns(lambda: e.mul(x, y),
                                      lambda: e_alt.mul(x, y)))
    finally:
        G.LOG_TILE = kept
    for n, (passes, alt_passes, kept_ms, alt_ms) in tile_ms.items():
        phase("engine time", f"mul N={n} B={Bx}: log_tile {kept} (LOG_TILE, "
              f"{passes} passes a transform) {rates(kept_ms)}; log_tile "
              f"{alt} ({alt_passes} passes) {rates(alt_ms)} (in turns)  "
              f"({smi})")
    phase("engine time", f"mul N={MM_N} B={Bx}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in mm_ms.items()) + f"  ({smi})")

    # -- 28. where the device time of one radix mul goes --------------------
    busy_ms, wall_ms, top = device_profile(lambda: radix.mul(a, b), 3, dev, 4)
    phase("engine profile", f"radix mul N={Nx} B={Bx}: device busy "
          f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall (profiled), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per mul: {top}  ({smi})")

    return [record(name, src, ref, rec_launches[name], max_err[name],
                   *times[name], ops_ms=ops_ms[name])
            for name, (src, ref) in ENGINE_KERNELS.items()]


def slice_sharded(dev, smi, rng) -> list:
    """Phases 29-33: the sharded four-step NTT at deg 2^20 on 8 shards
    of the card, ``ShardedNTT(exchange="pallas")`` with the exchange
    kernel K8, and ``PowerRing.fourstep_ctx()``.  Returns K8's JSON
    records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import (BABYBEAR as FB, GOLDILOCKS as F,
                                       GoldilocksKernelNTT, NTTContext,
                                       ShardedNTT, get_power_ring, make_mesh,
                                       to_numpy_u32, to_numpy_u64, to_torch)
    from stark_rings_tpu_torch.native.host import HostGoldilocks, HostRing
    from stark_rings_tpu_torch.ops import _build
    from stark_rings_tpu_torch.ops import fold as K
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.parallel import exchange as EX

    fields = {"goldilocks": F, "babybear": FB}
    N1 = N2 = 1 << ((SH_N.bit_length() - 1) // 2)
    a_np = rng.integers(0, F.q, (SH_B, SH_N), dtype=np.uint64)
    b_np = rng.integers(0, F.q, (SH_B, SH_N), dtype=np.uint64)
    a, b = to_torch(a_np, dev), to_torch(b_np, dev)
    abb, bbb = FB.rand((SH_B, SH_N), rng, dev), FB.rand((SH_B, SH_N), rng,
                                                         dev)
    # the host oracles run on threads while the card works
    pool = ThreadPoolExecutor(max_workers=2)
    orc = {"goldilocks": pool.submit(
        lambda: HostGoldilocks(SH_N).mul(a_np[:1], b_np[:1])),
        "babybear": pool.submit(lambda x=abb[:1].cpu(), y=bbb[:1].cpu():
                                HostRing("babybear", SH_N).mul_storage(x, y))}
    t0 = time.perf_counter()
    mesh = make_mesh(SH_P, device=dev)
    sp = {k: ShardedNTT(k, SH_N, SH_P, exchange="pallas") for k in fields}
    sx = {k: ShardedNTT(k, SH_N, SH_P) for k in fields}
    smx = ShardedNTT("goldilocks", SH_N, SH_P, exchange="pallas",
                     local="mxu")
    fs = {k: get_power_ring(k, SH_N.bit_length() - 1, device=dev)
          .fourstep_ctx() for k in fields}
    radix = GoldilocksKernelNTT(SH_N, device=dev)
    phase("sharded tables", f"ShardedNTT deg {SH_N} P={SH_P} (goldilocks and "
          f"babybear, pallas and xla; goldilocks local=mxu), fourstep_ctx "
          f"and GoldilocksKernelNTT built in "
          f"{time.perf_counter() - t0:.1f} s")

    def table(f, shape, kind):
        if kind == "zeros":
            return f.zeros(shape, dev)
        if kind == "q-1":
            return f.encode([f.q - 1], dev).expand(shape).contiguous()
        return f.rand(shape, rng, dev)

    # -- 29. K8 against its twin ------------------------------------------
    max_err = {name: 0 for name in EXCHANGE_KERNELS}
    t0 = time.perf_counter()
    cases = 0
    for field, f in fields.items():
        for P in (SH_P, *SH_PS):
            R1, C = N1 // P, N2 // P
            for inverse in (False, True):
                d = "inv" if inverse else "fwd"
                kern = getattr(EX, f"twiddle_exchange_{d}")
                twin = getattr(EX, f"twiddle_exchange_{d}_ref")
                rows, cols = (R1, N2) if inverse else (N1, C)
                runs = [(SH_B if P == SH_P else SH_B_SMALL, k)
                        for k in (("random", "zeros", "q-1") if P == SH_P
                                  else ("random",))]
                if P == SH_P:
                    runs.append((None, "random"))           # batchless
                for B, kind in runs:
                    lead = () if B is None else (B,)
                    xs = [table(f, lead + (rows, cols), kind)
                          for _ in range(P)]
                    tws = [table(f, (rows, cols), kind) for _ in range(P)]
                    what = f"P={P} B={B} {kind}"
                    for g, w in zip(kern(xs, tws, field),
                                    twin(xs, tws, field)):
                        check(max_err, f"twiddle_exchange_{d}_{field}", g, w,
                              what)
                    cases += 1
    torch.cuda.synchronize()
    phase("sharded parity", f"{cases} K8 cases (forward and inverse, "
          f"goldilocks and babybear, deg {SH_N}: P={SH_P} B={SH_B} on zeros, "
          f"q-1 and random tables and batchless; P={SH_PS} B={SH_B_SMALL}) "
          f"bit-equal to the twins in {time.perf_counter() - t0:.1f} s")

    # the four-step's local kernels at its shapes: the cyclic radix tile
    # on a shard viewed as [B*C, N1] rows, and pointwise_mul with the
    # twist / twiddle table broadcast over the batch
    t0 = time.perf_counter()
    for name in FOURSTEP_KERNELS:
        max_err[name] = 0
    cyc = GoldilocksKernelNTT(N1, device=dev, negacyclic=False)
    ctx_c = NTTContext(F, N1, negacyclic=False, device=dev)
    rows_p = table(F, (SH_B * N2 // SH_P, N1), "random")   # a P = 8 shard
    rows_c = table(F, (SH_B * N2, N1), "random")           # fourstep_ctx()
    tile = "ntt_tile[fourstep cyclic]"
    for rows in (rows_p, rows_c):
        for what, got, want in (
                ("forward", cyc.forward(rows), ctx_c.forward(rows)),
                ("inverse", cyc.inverse(rows), ctx_c.inverse(rows)),
                ("forward twin", cyc.forward(rows), G.ntt_tile_ref(
                    rows, *cyc.tables(), cyc.log_tile, "forward"))):
            check(max_err, tile, got, want, f"{shape(rows)} {what}")
    pw = "pointwise_mul[fourstep tables]"
    xs4 = table(F, (SH_B, N1, N2 // SH_P), "random")
    bcasts = {"table": table(F, (N1, N2 // SH_P), "random"),
              "batch-1": table(F, (1, N1, N2 // SH_P), "random"),
              "same shape": table(F, xs4.shape, "random"),
              "one element": table(F, (1,), "q-1")}
    for what, tb in bcasts.items():
        check(max_err, pw, K.pointwise_mul(xs4, tb),
              K.pointwise_mul_ref(xs4, tb), f"{shape(xs4, tb)} {what}")
    torch.cuda.synchronize()
    phase("sharded parity", f"the cyclic radix tile at {shape(rows_p)} "
          f"and {shape(rows_c)} (forward, inverse) bit-equal to "
          f"NTTContext(negacyclic=False) "
          f"and its twin; pointwise_mul on {shape(xs4)} with b broadcast "
          f"({', '.join(bcasts)}) bit-equal to its twin "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 30. the path, launches counted -----------------------------------
    def fns(sn):
        return (*sn.make_fns(mesh, batch_ndim=1),
                *sn.make_cached_fns(mesh, batch_ndim=1))

    def shards(sn, x):
        return sn.shard(sn.to_matrix(x), sn.shard_specs(1)[0], mesh)

    def whole(sn, xs, spec=0):
        return sn.from_matrix(sn.gather(xs, sn.shard_specs(1)[spec], dev))

    gl, bb = sp["goldilocks"], sp["babybear"]
    fwd, inv, mul, pre, mul_cached, square = fns(gl)
    sa, sb = shards(gl, a), shards(gl, b)
    sab, sbb = shards(bb, abb), shards(bb, bbb)
    sb1 = shards(gl, b[:1])
    torch.cuda.synchronize()
    # NTTContext's transforms, counted on the path: no Goldilocks
    # four-step may run one (BabyBear has no radix kernel, it does)
    ctx_calls = {"n": 0}

    def counted(fn):
        def call(self, x):
            ctx_calls["n"] += 1
            return fn(self, x)
        return call

    orig = {m: getattr(NTTContext, m) for m in ("forward", "inverse")}
    for m, fn in orig.items():
        setattr(NTTContext, m, counted(fn))
    counters = (EX.LAUNCHES, G.LAUNCHES, K.LAUNCHES, ctx_calls)
    EX.reset_launches()
    G.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "gl forward": lambda: fwd(sa),
        "gl inverse": lambda: inv(results["gl forward"]),
        "gl mul": lambda: mul(sa, sb),
        "gl mul_cached": lambda: mul_cached(sa, pre(sb)),
        "gl mul_cached_batch1": lambda: mul_cached(sa, pre(sb1)),
        "gl square": lambda: square(sa),
        "bb mul": lambda: fns(bb)[2](sab, sbb),
        "gl mxu mul": lambda: fns(smx)[2](sa, sb),
        "gl fourstep mul": lambda: fs["goldilocks"].mul(a, b),
    }
    results, per_variant = {}, {}
    try:
        for name, fn in runs.items():
            before = [dict(c) for c in counters]
            results[name] = fn()
            per_variant[name] = {
                ("NTTContext" if k == "n" else k): v - was[k]
                for c, was in zip(counters, before) for k, v in c.items()
                if v != was[k]}
        torch.cuda.synchronize()
    finally:
        for m, fn in orig.items():
            setattr(NTTContext, m, fn)
    launches = {**EX.LAUNCHES, "ntt_tile": G.LAUNCHES["ntt_tile"],
                "pointwise_mul": K.LAUNCHES["pointwise_mul"]}
    path_s = time.perf_counter() - t0
    phase("sharded path", f"{len(runs)} calls at deg {SH_N}, P={SH_P}, "
          f"B={SH_B} in {path_s:.2f} s; launches {per_variant}")

    t0 = time.perf_counter()
    got = {k: whole(gl, v, 1 if k == "gl forward" else 0)
           for k, v in results.items()
           if not k.startswith(("bb", "gl mxu", "gl fourstep"))}
    xf = fns(sx["goldilocks"])
    want = {"gl forward": whole(gl, xf[0](sa), 1),
            "gl mul": whole(gl, xf[2](sa, sb)),
            "gl mul_cached": whole(gl, xf[4](sa, xf[3](sb))),
            "gl mul_cached_batch1": whole(gl, xf[4](sa, xf[3](sb1))),
            "gl square": whole(gl, xf[5](sa))}
    want["gl inverse"] = whole(gl, xf[1](results["gl forward"]))
    for name, w in want.items():
        if u64_err(got[name], w, name):
            raise AssertionError(f"{name}: pallas differs from the xla route")
    if not torch.equal(got["gl inverse"], a):
        raise AssertionError("inverse(forward(a)) != a")
    if not torch.equal(got["gl forward"], fs["goldilocks"].forward(a)):
        raise AssertionError("the sharded forward differs from fourstep_ctx's")
    ab = results["gl fourstep mul"]
    if u64_err(ab, radix.mul(a, b), "fourstep_ctx().mul"):
        raise AssertionError("fourstep_ctx().mul differs from "
                             "GoldilocksKernelNTT.mul")
    others = {"fourstep_ctx().mul": ab, "GoldilocksKernelNTT.mul":
              radix.mul(a, b)}
    for what, w in others.items():
        if u64_err(got["gl mul"], w, what):
            raise AssertionError(f"sharded mul differs from {what}")
    for name, w in (("gl mul_cached", ab), ("gl square", radix.mul(a, a)),
                    ("gl mul_cached_batch1",
                     radix.mul(a, b[:1].expand_as(b).contiguous())),
                    ("gl mxu mul", ab)):
        x = whole(gl, results[name]) if name == "gl mxu mul" else got[name]
        if u64_err(x, w, name):
            raise AssertionError(f"{name} differs from the radix engine's or "
                                 "fourstep_ctx's product")
    bbm = whole(bb, results["bb mul"])
    if u64_err(bbm, whole(bb, fns(sx["babybear"])[2](sab, sbb)), "bb") \
            or u64_err(bbm, fs["babybear"].mul(abb, bbb), "bb fourstep"):
        raise AssertionError("bb mul differs from the xla route or "
                             "fourstep_ctx")
    host_gl = orc["goldilocks"].result()
    host_bb = orc["babybear"].result()
    pool.shutdown()
    if not np.array_equal(to_numpy_u64(got["gl mul"][:1]), host_gl) or \
            not np.array_equal(to_numpy_u64(ab[:1]), host_gl):
        raise AssertionError("sharded mul or fourstep_ctx().mul differs "
                             "from HostGoldilocks.mul")
    if not np.array_equal(to_numpy_u32(FB.canon(bbm[:1])).astype(np.uint64),
                          host_bb):
        raise AssertionError("bb sharded mul differs from HostRing.mul")
    phase("sharded path", f"goldilocks forward / inverse / mul / mul_cached "
          f"(batch {SH_B} and 1) / square bit-equal to the xla route, mul to "
          f"fourstep_ctx().mul, GoldilocksKernelNTT.mul and HostGoldilocks"
          f".mul (row 0; fourstep_ctx().mul too), forward to "
          f"fourstep_ctx().forward, inverse(forward)"
          f" = id; babybear mul to the xla route, fourstep_ctx().mul and "
          f"HostRing.mul (row 0); local=mxu mul to local=vpu "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 31. launch counts ----------------------------------------------------
    phase("sharded launches", json.dumps(launches))
    for name in EXCHANGE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the path")
    for name, n in (("gl mul", 3), ("gl mul_cached", 3), ("gl square", 2),
                    ("bb mul", 3), ("gl mxu mul", 3)):
        k8 = sum(v for k, v in per_variant[name].items()
                 if k.startswith("twiddle_exchange"))
        if k8 != n:
            raise AssertionError(f"{name}: {per_variant[name]}, not {n} K8 "
                                 "launches")
    # a shard's local transforms are one tile launch each (N1 = N2 =
    # 2^10); its products pointwise_mul, the twiddles inside K8
    expect = {  # variant -> (shards, tiles, products, NTTContext calls)
        "gl forward": (SH_P, 2, 1, 0), "gl inverse": (SH_P, 2, 1, 0),
        "gl mul": (SH_P, 6, 4, 0), "gl mul_cached": (SH_P, 6, 4, 0),
        "gl mul_cached_batch1": (SH_P, 6, 4, 0),
        "gl square": (SH_P, 4, 3, 0), "gl mxu mul": (SH_P, 0, 4, 0),
        "bb mul": (SH_P, 0, 0, 6), "gl fourstep mul": (1, 6, 7, 0)}
    for name, (p_, tiles, prods, ctxs) in expect.items():
        got_n = tuple(per_variant[name].get(k, 0) for k in (
            "ntt_tile", "pointwise_mul", "NTTContext", "ntt_stage"))
        if got_n != (p_ * tiles, p_ * prods, p_ * ctxs, 0):
            raise AssertionError(f"{name}: (ntt_tile, pointwise_mul, "
                                 f"NTTContext, ntt_stage) = {got_n}, not "
                                 f"{(p_ * tiles, p_ * prods, p_ * ctxs, 0)}")
    for name in FOURSTEP_KERNELS:
        if launches[name.split("[")[0]] <= 0:
            raise AssertionError(f"{name} was never launched on the path")

    # -- 32. timings ----------------------------------------------------------
    rate = modmul_peak(dev)[0]
    times, ops_ms = {}, {}
    R1, C = N1 // SH_P, N2 // SH_P
    for field, f in fields.items():
        for d, rows, cols in (("fwd", N1, C), ("inv", R1, N2)):
            name = f"twiddle_exchange_{d}_{field}"
            kern = getattr(EX, f"twiddle_exchange_{d}")
            twin = getattr(EX, f"twiddle_exchange_{d}_ref")
            xs = [f.rand((SH_B, rows, cols), rng, dev) for _ in range(SH_P)]
            tws = [f.rand((rows, cols), rng, dev) for _ in range(SH_P)]
            outs = kern(xs, tws, field)
            moved = nbytes(xs, tws, outs)
            # the kernel alone: back-to-back launches of its C entry point
            # on the same pointers (the wrapper's checks, allocation and
            # pointer tables cost more host time than the kernel takes)
            args = [(ctypes.c_void_p * SH_P)(*[t.data_ptr() for t in ts])
                    for ts in (xs, tws, outs)]
            args += [SH_P, SH_B, N1.bit_length() - 1, N2.bit_length() - 1,
                     SH_P.bit_length() - 1, int(d == "inv")]
            entry = getattr(_build.kernels(), f"srt_twiddle_exchange_{field}")
            scratch = {name: 0}
            ms = time_ms(lambda: _build.launch(scratch, name, entry, dev,
                                               *args), inner=10)
            wrap_ms = time_ms(lambda: kern(xs, tws, field), inner=10)
            plain_ms = time_ms(lambda: twin(xs, tws, field))
            # the block transpose alone, one torch call on the stacked
            # shards: a yardstick, not the same function (no twiddle)
            st = torch.stack(xs)
            if d == "fwd":     # [s, B, d, R1, C] -> [d, B, R1, s, C]
                view = st.view(SH_P, SH_B, SH_P, R1, C).permute(2, 1, 3, 0, 4)
            else:              # [s, B, R1, d, C] -> [d, B, s, R1, C]
                view = st.view(SH_P, SH_B, R1, SH_P, C).permute(3, 1, 0, 2, 4)
            tr_ms = time_ms(lambda: view.contiguous(), inner=10)
            del st
            # Goldilocks: one gl::mul per word at the card's modmul peak;
            # BabyBear's Montgomery product (a wide multiply, a multiply,
            # a multiply-high and a conditional subtract) is under a
            # quarter of gl::mul's instructions, so its bound is the bytes
            ops_ms[name] = (SH_B * SH_N / rate * 1e3 if field == "goldilocks"
                            else 0.0)
            times[name] = (ms, plain_ms, moved)
            bound = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms[name])
            phase("sharded time", f"{name} P={SH_P} B={SH_B} deg {SH_N}: "
                  f"kernel {ms:.4f} ms (through the wrapper {wrap_ms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms; {moved} B, "
                  f"bound {bound:.4f} ms ({bound / ms:.0%} of it); the block "
                  f"transpose alone (permute + contiguous) {tr_ms:.4f} ms  "
                  f"({smi})")
    # the four-step's local kernels alone at fourstep_ctx()'s shapes: the
    # cyclic tile on its columns as [B*N2, N1] rows, and the twist table
    # [N1, N2] against its [B, N1, N2] operand
    tile_rec, pw_rec = FOURSTEP_KERNELS
    wf, wi, ninv = cyc.tables()
    lt = cyc.log_tile

    def tile_fn():
        return G.ntt_tile(rows_c, wf, wi, ninv, lt, "forward")

    xs1 = table(F, (SH_B, N1, N2), "random")
    tw1 = table(F, (N1, N2), "random")
    timed4 = {
        tile_rec: (tile_fn, lambda: G.ntt_tile_ref(rows_c, wf, wi, ninv, lt,
                                                   "forward"),
                   (rows_c, wf), rows_c.numel() // 2 * lt),
        pw_rec: (lambda: K.pointwise_mul(xs1, tw1),
                 lambda: K.pointwise_mul_ref(xs1, tw1), (xs1, tw1),
                 xs1.numel())}
    for name, (kern, twin, inputs, modmuls) in timed4.items():
        moved = nbytes(inputs, kern())
        ms = time_ms(kern, inner=10)
        plain_ms = time_ms(twin)
        ops_ms[name] = modmuls / rate * 1e3
        times[name] = (ms, plain_ms, moved)
        bound = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms[name])
        phase("sharded time", f"{name} {shape(*inputs)}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; {moved} B, {modmuls} modmuls "
              f"({ops_ms[name]:.4f} ms at the peak), bound {bound:.4f} ms "
              f"({bound / ms:.0%} of it)  ({smi})")
    mul_x = fns(sx["goldilocks"])[2]
    rates = {"pallas (K8)": time_ms(lambda: mul(sa, sb)),
             "xla": time_ms(lambda: mul_x(sa, sb))}
    phase("sharded time", f"sharded mul deg {SH_N} P={SH_P} B={SH_B}: "
          + ", ".join(f"{k} {v:.3f} ms = {SH_B / v * 1e3:.2f} mults/s"
                      for k, v in rates.items()) + f"  ({smi})")
    fs_ms, rad_ms = in_turns(lambda: fs["goldilocks"].mul(a, b),
                             lambda: radix.mul(a, b))
    phase("sharded time", f"mul deg {SH_N} B={SH_B}: fourstep_ctx() "
          + ", ".join(f"{m:.3f} ms = {SH_B / m * 1e3:.2f} mults/s"
                      for m in fs_ms) + "; GoldilocksKernelNTT "
          + ", ".join(f"{m:.3f} ms = {SH_B / m * 1e3:.2f} mults/s"
                      for m in rad_ms) + f" (in turns)  ({smi})")
    ph = gl.make_phase_fns(mesh, batch_ndim=1)
    pre_out = ph["pre"](sa)
    ex_out = ph["exchange"](pre_out)
    phase_ms = {"pre": time_ms(lambda: ph["pre"](sa)),
                "exchange": time_ms(lambda: ph["exchange"](pre_out)),
                "rows": time_ms(lambda: ph["rows"](ex_out)),
                "forward": time_ms(lambda: ph["forward"](sa))}
    phase("sharded time", f"make_phase_fns deg {SH_N} P={SH_P} B={SH_B}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in phase_ms.items())
          + f"  ({smi})")

    # -- 33. where the device time of one sharded mul goes --------------------
    for label, fn in ((f"sharded mul P={SH_P}", lambda: mul(sa, sb)),
                      ("fourstep_ctx().mul", lambda: fs["goldilocks"].mul(
                          a, b))):
        kerns = []
        busy_ms, wall_ms, top = device_profile(fn, 3, dev, 8, rows_out=kerns)
        mine = sum(t for k, _, t in kerns if "ntt_tile_kernel" in k
                   or "pointwise_mul_kernel" in k or "twiddle_exchange" in k)
        phase("sharded profile", f"{label} deg {SH_N} B={SH_B}: device busy "
              f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall (profiled), idle "
              f"share {1 - busy_ms / wall_ms:.3f}; the hand kernels "
              f"{mine:.3f} ms, the rest (transpose copies, torch ops) "
              f"{busy_ms - mine:.3f} ms ({(busy_ms - mine) / busy_ms:.0%} of "
              f"busy); per mul: {top}  ({smi})")

    return [record(name, EXCHANGE_SOURCE, ref, launches[name], max_err[name],
                   *times[name], ops_ms=ops_ms[name])
            for name, ref in EXCHANGE_KERNELS.items()] + [
        record(name, src, ref, launches[name.split("[")[0]], max_err[name],
               *times[name], ops_ms=ops_ms[name])
        for name, (src, ref) in FOURSTEP_KERNELS.items()]


def slot_words(shape_, rng, dev, fill=None):
    """Goldilocks words (canonical u64 bits in int64) of ``shape_`` on
    ``dev``: uniform below q, or each ``fill``."""
    import numpy as np

    from stark_rings_tpu_torch import to_torch

    q = (1 << 64) - (1 << 32) + 1
    x = (np.full(shape_, fill, dtype=np.uint64) if fill is not None
         else rng.integers(0, q, shape_, dtype=np.uint64))
    return to_torch(x, dev)


def model_stages(tm, at, bt) -> dict:
    """ms of each stage of one ``mul_t`` on [D, B] operands: of one CRT
    GEMM the digit planes, ``_int_mm``, the offset terms and the whole
    ``dot``, then the fold on its buckets; and the slot product (CUDA
    events, as ``time_ms``)."""
    import torch

    from stark_rings_tpu_torch.ops.mxu_dense import fold_buckets

    m = tm._crt
    core = m.core
    s8 = core._planes(at, 0x80).view(torch.int8)
    V = torch._int_mm(m.w, s8)
    KR = core.K * core.R
    Vd = core.dot(at, m.w, m.w_corr)
    fa, fb = tm.crt_t(at), tm.crt_t(bt)

    def offsets():
        Vo = V[:KR].clone()
        Vo += m.w_corr
        Vo += 128 * V[KR]

    return {"planes": time_ms(lambda: core._planes(at, 0x80)),
            "_int_mm": time_ms(lambda: torch._int_mm(m.w, s8)),
            "offsets (with a copy)": time_ms(offsets),
            "dot": time_ms(lambda: core.dot(at, m.w, m.w_corr)),
            "fold": time_ms(lambda: fold_buckets(core, Vd)),
            "slot product": time_ms(lambda: tm.ntt_mul_t(fa, fb))}


def model_profile(tm, at, bt, dev, n=5) -> str:
    """``n`` profiled ``mul_t`` calls split by kernel: the fold kernel (K3
    or bb_fold_end; its device time a launch over the launches the
    window recorded), the ``_int_mm`` GEMM (cutlass), the slot kernel
    (``slot_mul``, Goldilocks on the card), torch's elementwise kernels
    (the digit planes, the offset terms and the other models' slot
    products) and any other kernel; the slot product is also profiled
    alone.  As text, per ``mul_t``."""
    rows = []
    busy_ms, wall_ms, _ = device_profile(lambda: tm.mul_t(at, bt), n, dev,
                                         0, rows_out=rows)
    rows = [(k, c * n, ms) for k, c, ms in rows if ms > 0]   # device rows

    def cls(pred):
        sel = [(c, ms) for key, c, ms in rows if pred(key)]
        return sum(c for c, _ in sel) / n, sum(ms for _, ms in sel)

    parts = {"fold kernel": cls(lambda k: "fold_end" in k),
             "_int_mm": cls(lambda k: "cutlass" in k or "gemm" in k),
             "slot kernel": cls(lambda k: "slot_mul_kernel" in k),
             "torch elementwise": cls(lambda k: "at::native" in k)}
    known = ("fold_end", "cutlass", "gemm", "slot_mul_kernel", "at::native")
    parts["other"] = cls(lambda k: not any(s in k for s in known))
    fa, fb = tm.crt_t(at), tm.crt_t(bt)
    slot_ms = device_profile(lambda: tm.ntt_mul_t(fa, fb), n, dev, 0)[0]
    c, ms = parts["fold kernel"]
    a_launch = f"{ms / c:.4f} ms" if c else "not measured"
    return (f"device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall "
            f"(profiled), idle share {1 - busy_ms / wall_ms:.3f}; per mul_t "
            + ", ".join(f"{k} {ms:.4f} ms in {c:.1f} launches"
                        for k, (c, ms) in parts.items())
            + f"; the fold kernel {a_launch} a launch; the slot product "
            f"profiled alone {slot_ms:.4f} ms")


def slice_models(dev, smi, rng) -> list:
    """Phases 34-38: the ring models' batch-trailing CRT multiply
    ``TModelMul.mul_t`` over goldilocks, babybear and frog at the
    reference bench's batches, and the Ajtai commit ``matvec_t``; the
    Goldilocks slot products on ``slot_mul`` / ``slot_matvec``.
    Returns the kernels' JSON records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch.ops import fold as K, fold_bb as KB
    from stark_rings_tpu_torch.ops import slot as SL
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.rings import get_ring

    t0 = time.perf_counter()
    rings = {n: get_ring(n, device=dev) for n in MODEL_B}
    tms = {n: TModelMul(r) for n, r in rings.items()}
    cpu = {n: TModelMul(get_ring(n, device="cpu")) for n in MODEL_B}
    phase("model tables", "goldilocks (D = 24, N = 8, E = 3), babybear "
          "(72, 8, 9) and frog (16, 4, 4) rings, their CRT/ICRT digit "
          f"tables on the card, built in {time.perf_counter() - t0:.1f} s")
    ops = {}
    for name, Bn in MODEL_B.items():
        f = rings[name].field
        ops[name] = tuple(f.rand((rings[name].D, Bn), rng, dev)
                          for _ in range(2))

    # -- 34. the folds at the models' shapes ---------------------------------
    max_err = {}
    t0 = time.perf_counter()
    folds = {}
    for rec, (_, _, name) in MODEL_KERNELS.items():
        mod, fold = (K, "fold_end") if name == "goldilocks" else (
            KB, "bb_fold_end")
        core, m = tms[name]._crt.core, tms[name]._crt
        at = ops[name][0]
        V = core.dot(at, m.w, m.w_corr)
        folds[rec] = (mod, fold, V, core.R)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for what, Vc in (("GEMM", V), ("bound", torch.full_like(V, (1 << 27)
                                                                 - 1)),
                         ("zero", torch.zeros_like(V)),
                         ("int32", torch.randint(-2**31, 2**31, V.shape,
                                                 generator=gen,
                                                 dtype=torch.int32,
                                                 device=dev))):
            check(max_err, rec, getattr(mod, fold)(Vc, core.R, signed=False),
                  getattr(mod, fold + "_ref")(Vc, core.R, signed=False),
                  f"R={core.R} B={at.shape[1]} {what}")
    for name, tm in tms.items():
        f = rings[name].field
        a, b = (f.rand((rings[name].D, MODEL_RAGGED), rng, dev)
                for _ in range(2))
        got = tm.mul_t(a, b)
        want = cpu[name].mul_t(a.cpu(), b.cpu())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: mul_t at B={MODEL_RAGGED} on the "
                                 "card differs from the CPU twin path")
    # the slot kernels against their twins (torch ops on the card): mul_t's
    # product, and the commit's contraction against the blocked twin
    gtab = tms["goldilocks"]._tables
    Ng, Bg = rings["goldilocks"].N, MODEL_B["goldilocks"]
    n_rows, m_cols, W, block = COMMIT
    for what, fill in (("random", None), ("q - 1", Q_TOP)):
        a, b = (slot_words((Ng, 3, Bg), rng, dev, fill) for _ in range(2))
        check(max_err, SLOT_MUL_REC, SL.slot_mul(a, b, gtab),
              SL.slot_mul_ref(a, b, gtab), f"{shape(a, b)} {what}")
        A = slot_words((Ng, 3, n_rows, m_cols), rng, dev, fill)
        x = slot_words((Ng, 3, W, m_cols), rng, dev, fill)
        check(max_err, "slot_matvec[model commit]", SL.slot_matvec(A, x, gtab),
              SL.slot_matvec_ref(A, x, gtab, block), f"{shape(A, x)} {what}")
    torch.cuda.synchronize()
    phase("model parity", f"K3 at R = 24, B = {MODEL_B['goldilocks']} and "
          f"bb_fold_end at R = 72, B = {MODEL_B['babybear']} bit-equal to "
          "their twins on the CRT GEMM's buckets, at the bound, zero and "
          f"full-range int32; mul_t at a ragged B = {MODEL_RAGGED} on the "
          "card equal to the CPU twin path for the three models; slot_mul "
          f"at [{Ng}, 3, {Bg}]^2 and slot_matvec at n={n_rows}, "
          f"m={m_cols}, W={W} bit-equal to their twins (the mat-vec's "
          f"blocked at {block}) on random words and on q - 1 "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 35. the path, launches counted ---------------------------------------
    gl, gtm = rings["goldilocks"], tms["goldilocks"]
    A = gl.field.rand((gl.D, n_rows, m_cols), rng, dev)
    s = gl.field.rand((gl.D, W, m_cols), rng, dev)

    def counts():
        return {k: {**K.LAUNCHES, **KB.LAUNCHES, **SL.LAUNCHES}[k]
                for k in ("fold_end", "bb_fold_end", "slot_mul",
                          "slot_matvec")}

    torch.cuda.synchronize()
    for mod in (K, KB, SL):
        mod.reset_launches()
    t0 = time.perf_counter()
    results, per_run = {}, {}
    runs = {f"{n} mul_t": (lambda n=n: tms[n].mul_t(*ops[n]))
            for n in MODEL_B}
    runs["commit"] = lambda: gtm.matvec_t(A, s)
    runs["commit blocked"] = lambda: gtm.matvec_t(A, s, block=block)
    for name, fn in runs.items():
        before = counts()
        results[name] = fn()
        per_run[name] = {k: v - before[k] for k, v in counts().items()}
    torch.cuda.synchronize()
    launches = counts()
    phase("model path", f"mul_t at goldilocks B={MODEL_B['goldilocks']}, "
          f"babybear B={MODEL_B['babybear']}, frog B={MODEL_B['frog']} and "
          f"the commit at n={n_rows}, m={m_cols}, W={W} (unblocked and "
          f"block={block}) in {time.perf_counter() - t0:.2f} s; launches "
          f"{per_run}")

    t0 = time.perf_counter()
    for name, (at, bt) in ops.items():
        ring = rings[name]
        got = results[f"{name} mul_t"]
        if got.shape != at.shape or got.dtype != at.dtype:
            raise AssertionError(f"{name} mul_t: {got.dtype} "
                                 f"{tuple(got.shape)}")
        canon = ring.field.canon(got)
        if not bool(ring.field.geq(ring.field.canon_const(-1), canon).all()):
            raise AssertionError(f"{name} mul_t: non-canonical output")
        # the integer spec on the first rows
        ai = ring.decode(at[:, :MODEL_SPEC_ROWS].t())
        bi = ring.decode(bt[:, :MODEL_SPEC_ROWS].t())
        gi = ring.decode(got[:, :MODEL_SPEC_ROWS].t())
        for r in range(MODEL_SPEC_ROWS):
            want = ring.spec.coeff_mul([int(v) for v in ai[r]],
                                       [int(v) for v in bi[r]])
            if [int(v) for v in gi[r]] != want:
                raise AssertionError(f"{name} mul_t row {r} differs from "
                                     "the integer spec")
        # the whole batch against the schoolbook coeff_mul on the card
        for c0 in range(0, at.shape[1], MODEL_CHUNK):
            sl = slice(c0, c0 + MODEL_CHUNK)
            want = ring.coeff_mul(at[:, sl].t(), bt[:, sl].t())
            if not torch.equal(got[:, sl].t(), want):
                raise AssertionError(f"{name} mul_t columns {c0}.. differ "
                                     "from coeff_mul on the card")
    full, blk = results["commit"], results["commit blocked"]
    twin = SL.slot_matvec_ref(A.view(Ng, 3, n_rows, m_cols),
                              s.view(Ng, 3, W, m_cols), gtab,
                              block).view(gl.D, W, n_rows)
    if full.shape != (gl.D, W, n_rows) or not torch.equal(full, twin) \
            or not torch.equal(blk, twin):
        raise AssertionError("commit: matvec_t (unblocked or blocked) "
                             "differs from slot_matvec's twin blocked at "
                             f"{block}")
    # one commitment row in Python ints through the spec's slot product
    Ai, si = gl.decode(A[:, 0].t()), gl.decode(s[:, 0].t())
    acc = [0] * gl.D
    for j in range(m_cols):
        p = gl.spec.ntt_mul([int(v) for v in Ai[j]], [int(v) for v in si[j]])
        acc = [(x + y) % gl.q for x, y in zip(acc, p)]
    if gl.decode(full[:, 0, 0]).tolist() != acc:
        raise AssertionError("commit: c[0, 0] differs from the spec's sum")
    phase("model path", f"mul_t of the three models equals the integer spec "
          f"on {MODEL_SPEC_ROWS} rows and coeff_mul on the card over the "
          f"whole batch (chunks of {MODEL_CHUNK}); the commit, unblocked and "
          "blocked, equals slot_matvec's twin (torch ops) blocked at "
          f"{block} and, for c[0, 0], the spec's slot products summed in "
          f"Python ints ({time.perf_counter() - t0:.1f} s)")

    # -- 36. launch counts ----------------------------------------------------
    phase("model launches", json.dumps(launches))
    none = {"fold_end": 0, "bb_fold_end": 0, "slot_mul": 0, "slot_matvec": 0}
    for name, want in (("goldilocks mul_t", {**none, "fold_end": 3,
                                             "slot_mul": 1}),
                       ("babybear mul_t", {**none, "bb_fold_end": 3}),
                       ("frog mul_t", none),
                       ("commit", {**none, "slot_matvec": 1}),
                       ("commit blocked", {**none, "slot_matvec": 1})):
        if per_run[name] != want:
            raise AssertionError(f"{name} launched {per_run[name]}, "
                                 f"expected {want}")
    rec_launches = {rec: launches[folds[rec][1]] for rec in MODEL_KERNELS}
    for rec, n in rec_launches.items():
        if n <= 0:
            raise AssertionError(f"{rec} was never launched on the model "
                                 "path")

    # -- 37. timings --------------------------------------------------------
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev)  # 2 x L2
    times = {}
    for rec, (mod, fold, V, R) in folds.items():
        kern = getattr(mod, fold)
        twin = getattr(mod, fold + "_ref")
        moved = nbytes(V, kern(V, R, signed=False))
        ms = time_ms(lambda: kern(V, R, signed=False), inner=10)
        plain_ms = time_ms(lambda: twin(V, R, signed=False))
        times[rec] = (ms, plain_ms, moved)
        floor = moved / HBM_BYTES_PER_S * 1e3
        phase("model time", f"{rec} {shape(V)}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, memory floor {floor:.4f} ms ({moved} B; "
              f"{floor / ms:.0%} of the rate); " + device_only(
                  lambda: kern(V, R, signed=False), dev, floor, flush)
              + f"  ({smi})")
    fa, fb = (gtm.crt_t(x).contiguous().view(Ng, 3, Bg)
              for x in ops["goldilocks"])
    moved = nbytes(fa, fb, SL.slot_mul(fa, fb, gtab))
    ms = time_ms(lambda: SL.slot_mul(fa, fb, gtab), inner=10)
    plain_ms = time_ms(lambda: SL.slot_mul_ref(fa, fb, gtab))
    per = sass_instructions(r"(?<![A-Za-z_])slot_mul_kernelILi2ELb0E")
    threads = Ng * Bg // 2                        # two products a thread
    slot_ops_ms = threads * per / issue_rate(dev)[0] * 1e3
    times[SLOT_MUL_REC] = (ms, plain_ms, moved, slot_ops_ms)
    floor = max(moved / HBM_BYTES_PER_S * 1e3, slot_ops_ms)
    phase("model time", f"slot_mul {shape(fa, fb)}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; {moved} B, {threads} threads x {per} "
          f"SASS instructions ({slot_ops_ms:.4f} ms at the issue rate), "
          f"bound {floor:.4f} ms ({floor / ms:.0%} of it); "
          + device_only(lambda: SL.slot_mul(fa, fb, gtab), dev, floor, flush)
          + f"  ({smi})")
    for name, (at, bt) in ops.items():
        tm = tms[name]
        ms = time_ms(lambda: tm.mul_t(at, bt))
        st = model_stages(tm, at, bt)
        phase("model time", f"{name} mul_t B={at.shape[1]}: {ms:.4f} ms = "
              f"{at.shape[1] / ms * 1e3:.1f} mults/s; one CRT GEMM: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in st.items())
              + f"  ({smi})")
    commit_ms = time_ms(lambda: gtm.matvec_t(A, s))
    blocked_ms = time_ms(lambda: gtm.matvec_t(A, s, block=block))
    phase("model time", f"commit matvec_t n={n_rows} m={m_cols} W={W}: "
          f"unblocked {commit_ms:.4f} ms = {W / commit_ms * 1e3:.1f} "
          f"commits/s ({commit_ms / W:.4f} ms a commit); block={block} "
          f"{blocked_ms:.4f} ms = {W / blocked_ms * 1e3:.1f} commits/s "
          f"({blocked_ms / W:.4f} ms a commit)  ({smi})")

    # -- 38. where the device time of one mul_t goes ------------------------
    for name, (at, bt) in ops.items():
        phase("model profile", f"{name} mul_t B={at.shape[1]}: "
              + model_profile(tms[name], at, bt, dev) + f"  ({smi})")

    return [record(rec, src, ref, rec_launches[rec], max_err[rec],
                   *times[rec])
            for rec, (src, ref, _) in MODEL_KERNELS.items()] + [
        record(SLOT_MUL_REC, SLOT_SOURCE, SLOT_XLA[SLOT_MUL_REC],
               launches["slot_mul"], max_err[SLOT_MUL_REC],
               *times[SLOT_MUL_REC][:3], ops_ms=times[SLOT_MUL_REC][3])]


def torch_ops(fn) -> int:
    """The torch operator calls (aten ops as dispatched, each at least
    one launch's worth of host time) one call of ``fn`` makes; the
    hand kernels' ctypes launches are not among them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def step_stages(fs, c, ins) -> dict:
    """ms of each stage of one ``FoldingStep.step`` timed alone, on the
    inputs the stage gets inside the step (CUDA events, as ``time_ms``)."""
    from stark_rings_tpu_torch.decomp import decompose
    from stark_rings_tpu_torch.decomp.norms import l2_check
    from stark_rings_tpu_torch.rings.monomial import psi_range_check_batched

    f, tm = fs.f, fs.tm
    s0, s1, c0, c1, rt = ins
    tmc = c.get("tm")
    st = f.add(s0, tm.ntt_mul_bt(s1, rt))
    coeff = tm.icrt_t(st, tmc)
    D, W = coeff.shape[0], coeff.shape[1]
    dt = decompose(f, coeff, fs.base, fs.k).reshape((D, W, fs.M)
                                                     + f.limb_shape)
    d_ntt = tm.crt_t(dt, tmc)
    return {
        "challenge fold": time_ms(lambda: (f.add(s0, tm.ntt_mul_bt(s1, rt)),
                                           f.add(c0, tm.ntt_mul_bt(c1, rt)))),
        "ICRT": time_ms(lambda: tm.icrt_t(st, tmc)),
        "decompose": time_ms(lambda: decompose(f, coeff, fs.base, fs.k)),
        "L2 check": time_ms(lambda: l2_check(f, dt, fs.l2_bound_sq,
                                             axis=(0, 2))),
        "CRT": time_ms(lambda: tm.crt_t(dt, tmc)),
        "commit": time_ms(lambda: fs.commit(c, d_ntt)),
        "psi": time_ms(lambda: psi_range_check_batched(fs.ring, dt)
                       .all(dim=2).all(dim=0)),
    }


def hold_step(fs, c, ins, out, witnesses) -> str:
    """Raise unless the step's outputs ``out`` equal independent paths on
    the card: s and c the batch-leading ``ntt_mul`` with the broadcast
    challenge, the digits ``gadget_decompose`` of ``ring.icrt(s)`` over
    the whole batch; and for each of ``witnesses``: the digits recompose
    in Python ints to the decoded ICRT coefficients, ``ok_l2`` is the
    exact Python-int norm against the bound, ``cd`` equals
    ``Matrix.mul_vec`` and its row 0 the spec's slot products summed in
    Python ints, ``ok_psi`` the host psi check of the witness's digit
    values.  Returns a summary."""
    import torch

    from stark_rings_tpu_torch.decomp import gadget_decompose
    from stark_rings_tpu_torch.decomp.norms import l2_norm_squared
    from stark_rings_tpu_torch.linalg import Matrix, RingElems
    from stark_rings_tpu_torch.rings.monomial import psi_range_check
    from stark_rings_tpu_torch.spec.decomp import recompose_ints
    from stark_rings_tpu_torch.spec.field import to_signed

    ring, f, tm = fs.ring, fs.f, fs.tm
    s0, s1, c0, c1, rt = (tm.from_t(x) for x in ins)
    W = s0.shape[0]
    r_ntt = rt.reshape((ring.D,) + f.limb_shape)
    for key, x0, x1 in (("s", s0, s1), ("c", c0, c1)):
        want = ring.add(x0, ring.ntt_mul(x1, r_ntt.expand(x1.shape)))
        if not torch.equal(tm.from_t(out[key]), want):
            raise AssertionError(f"step {key}: differs from the "
                                 "batch-leading ntt_mul fold")
    s_lead = tm.from_t(out["s"])
    coeff = ring.icrt(s_lead)                             # [W, L, D]
    dig = tm.from_t(out["digits"])                        # [W, M, D]
    if not torch.equal(dig, gadget_decompose(f, coeff, fs.base, fs.k)):
        raise AssertionError("step digits: differ from gadget_decompose of "
                             "ring.icrt(s) over the batch")
    Ag = Matrix(RingElems(ring), tm.from_t(c["Agt"]))    # [n, M, D(, 8)]
    cd = tm.from_t(out["cd"])
    A0 = ring.decode(Ag.vals[0])                          # [M, D]
    psi_values = {}
    for w in witnesses:
        di = ring.decode(dig[w]).reshape(fs.L, fs.k, ring.D)
        ci = ring.decode(coeff[w])
        for l in range(fs.L):
            for i in range(ring.D):
                v = recompose_ints([to_signed(int(x), ring.q)
                                    for x in di[l, :, i]], fs.base)
                if v % ring.q != int(ci[l, i]):
                    raise AssertionError(f"step digits of witness {w}, "
                                         f"column {l}, coefficient {i}: "
                                         "recompose to another value")
        norm = l2_norm_squared(f, dig[w])
        if bool(out["ok_l2"][w]) != (norm <= fs.l2_bound_sq):
            raise AssertionError(f"step ok_l2[{w}] against the exact norm "
                                 f"{norm} and the bound {fs.l2_bound_sq}")
        dn = ring.crt(dig[w])
        if not torch.equal(cd[w], Ag.mul_vec(dn)):
            raise AssertionError(f"step cd of witness {w}: differs from "
                                 "Matrix.mul_vec")
        dni = ring.decode(dn)
        acc = [0] * ring.D
        for j in range(fs.M):
            p = ring.spec.ntt_mul([int(v) for v in A0[j]],
                                  [int(v) for v in dni[j]])
            acc = [(x + y) % ring.q for x, y in zip(acc, p)]
        if ring.decode(cd[w, 0]).tolist() != acc:
            raise AssertionError(f"step cd[{w}, 0]: differs from the spec's "
                                 "slot products summed in Python ints")
        if "ok_psi" in out:
            vals = set(int(v) for v in ring.decode(dig[w]).reshape(-1))
            for v in vals - psi_values.keys():
                psi_values[v] = psi_range_check(ring, v)
            if bool(out["ok_psi"][w]) != all(psi_values[v] for v in vals):
                raise AssertionError(f"step ok_psi[{w}]: differs from the "
                                     "host psi check of its digit values")
    return (f"W={W}: s, c, digits held over the batch; witnesses "
            f"{list(witnesses)} in Python ints (ok_l2 "
            f"{out['ok_l2'].tolist()}"
            + (f", ok_psi {out['ok_psi'].tolist()}" if "ok_psi" in out
               else "") + ")")


def slice_protocol(dev, smi, rng) -> list:
    """Phases 39-43: the folding protocol, ``FoldingStep`` and
    ``FoldingTree``, at the reference bench's width; over goldilocks its
    slot products on ``slot_mul`` (the challenge) and ``slot_matvec``
    (the commit).  Returns the kernels' JSON records."""
    import torch

    from stark_rings_tpu_torch.ops import fold as K, fold_bb as KB
    from stark_rings_tpu_torch.ops import slot as SL
    from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree
    from stark_rings_tpu_torch.rings import get_ring

    n_rows, L, base = PROTO
    gl, bb = get_ring("goldilocks", device=dev), get_ring("babybear",
                                                          device=dev)
    frog = get_ring("frog", device=dev)
    t0 = time.perf_counter()
    steps = {(W, psi): FoldingStep(gl, n_rows, L, base, psi_check=psi)
             for W in PROTO_WS for psi in (False, True)}
    fs = steps[(PROTO_WS[-1], True)]
    gtab = fs.tm._tables
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(gl.rand_coeff((), rng))
    ins = {}
    for W in PROTO_WS:
        ins[W] = (fs.rand_witness(W, rng), fs.rand_witness(W, rng),
                  *(fs.tm.to_t(gl.rand_ntt((W, n_rows), rng)).contiguous()
                    for _ in range(2)), rt)
    Wt, Lt = PROTO_TREE
    ft = FoldingTree(gl, n_rows, Lt, base=base)
    ct_tables = ft.init_tables(rng)
    wt = ft.rand_witnesses(Wt, rng)
    cw = ft.commit_witnesses(ct_tables, wt)
    rts = ft.precompute_challenges([gl.rand_coeff((), rng)
                                    for _ in range(Wt.bit_length() - 1)])
    tf, nf, Lf, bf = PROTO_FROG_TREE
    fft = FoldingTree(frog, nf, Lf, base=bf)
    fc = fft.init_tables(rng)
    fwt = fft.rand_witnesses(1 << tf, rng)
    fcw = fft.commit_witnesses(fc, fwt)
    frts = fft.precompute_challenges([frog.rand_coeff((), rng)
                                      for _ in range(tf)])
    bfs = FoldingStep(bb, n_rows, L, base)
    bc = bfs.init_tables(rng)
    Wb = PROTO_WS[-1]
    bins = (bfs.rand_witness(Wb, rng), bfs.rand_witness(Wb, rng),
            *(bfs.tm.to_t(bb.rand_ntt((Wb, n_rows), rng)).contiguous()
              for _ in range(2)), bfs.precompute_challenge(
                bb.rand_coeff((), rng)))
    torch.cuda.synchronize()
    phase("protocol tables", f"goldilocks step n={n_rows}, L={L}, base="
          f"{base}: k={fs.k}, M={fs.M}, the default commit block at W=16 "
          f"{fs.commit_block(16)} (>= M: unblocked), babybear's "
          f"{bfs.commit_block(Wb)} of M={bfs.M}; tables, witnesses and "
          f"challenges drawn in {time.perf_counter() - t0:.1f} s")

    # -- 39. the path, launches counted ---------------------------------------
    def counts():
        return {"fold_end": K.LAUNCHES["fold_end"],
                "bb_fold_end": KB.LAUNCHES["bb_fold_end"],
                "slot_mul": SL.LAUNCHES["slot_mul"],
                "slot_matvec": SL.LAUNCHES["slot_matvec"]}

    torch.cuda.synchronize()
    for mod in (K, KB, SL):
        mod.reset_launches()
    t0 = time.perf_counter()
    outs, per_run = {}, {}
    runs = {f"step W={W} psi={psi}": (lambda W=W, psi=psi: steps[(W, psi)]
                                      .step(c, *ins[W]))
            for W, psi in steps}
    runs["tree"] = lambda: ft.prove(ct_tables, wt, cw, rts)
    runs["frog tree"] = lambda: fft.prove(fc, fwt, fcw, frts)
    runs["babybear step"] = lambda: bfs.step(bc, *bins)
    for name, fn in runs.items():
        before = counts()
        outs[name] = fn()
        per_run[name] = {k: v - before[k] for k, v in counts().items()}
    torch.cuda.synchronize()
    launches = counts()
    phase("protocol path", f"{len(steps)} goldilocks steps, the {Wt}-leaf "
          "tree, the frog tree and the babybear step in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_run}")

    # -- 40. each output held to independent paths ----------------------------
    t0 = time.perf_counter()
    for W in PROTO_WS:
        o_off, o_on = (outs[f"step W={W} psi={p}"] for p in (False, True))
        for key in ("s", "c", "digits", "cd", "ok_l2"):
            if not torch.equal(o_off[key], o_on[key]):
                raise AssertionError(f"step W={W} {key}: psi on and off "
                                     "differ")
        text = hold_step(steps[(W, True)], c, ins[W], o_on,
                         (0, W - 1)[:PROTO_INT_WITNESSES])
        d_ntt = fs.tm.crt_t(o_on["digits"]).contiguous()
        twin = SL.slot_matvec_ref(
            c["Agt"].view(gl.N, 3, n_rows, fs.M),
            d_ntt.view(gl.N, 3, W, fs.M), gtab,
            PROTO_BLOCK).view(gl.D, W, n_rows)
        if not torch.equal(twin, o_on["cd"]) or not torch.equal(
                fs.commit(c, d_ntt, block=PROTO_BLOCK), o_on["cd"]):
            raise AssertionError(f"step W={W}: the commit (or the commit "
                                 f"at block={PROTO_BLOCK}) differs from "
                                 "slot_matvec's twin blocked at "
                                 f"{PROTO_BLOCK}")
        phase("protocol check", text + "; cd and the commit at block="
              f"{PROTO_BLOCK} equal to slot_matvec's twin (torch ops) "
              f"blocked at {PROTO_BLOCK}")
    levels, rw, rc = outs["tree"]
    if rw.shape != (gl.D, 1, Lt) or not ft.verify(ct_tables, wt, cw, levels,
                                                  rts):
        raise AssertionError("the goldilocks tree was not accepted")
    flevels, _, _ = outs["frog tree"]
    if not (fft.fs.psi_check and all(bool(o["ok_psi"].all())
                                     for o in flevels)):
        raise AssertionError("the frog tree's psi check is not live or "
                             "failed")
    if not fft.verify(fc, fwt, fcw, flevels, frts):
        raise AssertionError("the frog tree was not accepted")
    for tree, tc, tw, tcw, lv, tr in ((ft, ct_tables, wt, cw, levels, rts),
                                      (fft, fc, fwt, fcw, flevels, frts)):
        bad = [dict(o) for o in lv]
        cd = bad[-1]["cd"].clone()
        f = tree.f
        cd.view(-1)[0] = f.add(cd.view(-1)[:1], f.const(1, dev))[0]
        bad[-1]["cd"] = cd
        if tree.verify(tc, tw, tcw, bad, tr):
            raise AssertionError(f"{tree.ring.name} tree: a tampered digit "
                                 "commitment was accepted")
    text = hold_step(bfs, bc, bins, outs["babybear step"], (0,))
    phase("protocol check", f"trees: goldilocks {Wt} leaves (L={Lt}) and "
          f"frog {1 << tf} leaves (psi live) verified, a tampered digit "
          f"commitment rejected by each; babybear step {text} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 41. launch counts ----------------------------------------------------
    phase("protocol launches", json.dumps(launches))
    levels_n = Wt.bit_length() - 1
    none = {"fold_end": 0, "bb_fold_end": 0, "slot_mul": 0, "slot_matvec": 0}
    gl_step = {**none, "fold_end": 2, "slot_mul": 2, "slot_matvec": 1}
    expect = {name: gl_step for name in runs if name.startswith("step")}
    expect["tree"] = {k: v * levels_n for k, v in gl_step.items()}
    expect["frog tree"] = none
    expect["babybear step"] = {**none, "bb_fold_end": 2}
    if per_run != expect:
        raise AssertionError(f"protocol launches {per_run}, expected "
                             f"{expect}")
    max_err, folds = {}, {}
    for rec, (_, _, name) in PROTO_KERNELS.items():
        sfs, sout = ((fs, outs[f"step W={PROTO_WS[-1]} psi=True"])
                     if name == "goldilocks" else (bfs, outs["babybear step"]))
        mod, fold = (K, "fold_end") if name == "goldilocks" else (
            KB, "bb_fold_end")
        if launches[fold] <= 0:
            raise AssertionError(f"{rec} was never launched on the protocol "
                                 "path")
        m = sfs.tm._crt
        dt = sout["digits"]
        V = m.core.dot(dt.reshape(dt.shape[0], -1), m.w, m.w_corr)
        folds[rec] = (mod, fold, V, m.core.R)
        check(max_err, rec, getattr(mod, fold)(V, m.core.R, signed=False),
              getattr(mod, fold + "_ref")(V, m.core.R, signed=False),
              f"the step's digit CRT buckets {shape(V)}")
    # the slot kernels at the step's shapes against their twins: the
    # challenge's products (s [N, 3, W L] and c [N, 3, W n] by a batch-1
    # challenge) and the commit, blocked twin
    Wl = PROTO_WS[-1]
    for what, fill in (("random", None), ("q - 1", Q_TOP)):
        for Ba in (Wl * L, Wl * n_rows):
            a = slot_words((gl.N, 3, Ba), rng, dev, fill)
            b = slot_words((gl.N, 3, 1), rng, dev, fill)
            check(max_err, "slot_mul[folding step challenge]",
                  SL.slot_mul(a, b, gtab), SL.slot_mul_ref(a, b, gtab),
                  f"{shape(a, b)} {what}")
        A = slot_words((gl.N, 3, n_rows, fs.M), rng, dev, fill)
        x = slot_words((gl.N, 3, Wl, fs.M), rng, dev, fill)
        check(max_err, SLOT_MATVEC_REC, SL.slot_matvec(A, x, gtab),
              SL.slot_matvec_ref(A, x, gtab, PROTO_BLOCK),
              f"{shape(A, x)} {what}")
    phase("protocol parity", f"K3 and bb_fold_end on the steps' digit-CRT "
          f"buckets; slot_mul at [{gl.N}, 3, {Wl * L}] and [{gl.N}, 3, "
          f"{Wl * n_rows}] x [{gl.N}, 3, 1] and slot_matvec at n={n_rows}, "
          f"M={fs.M}, W={Wl} bit-equal to their twins (the mat-vec's "
          f"blocked at {PROTO_BLOCK}) on random words and on q - 1")

    # -- 42. timings ----------------------------------------------------------
    times = {}
    for rec, (mod, fold, V, R) in folds.items():
        kern, twin = getattr(mod, fold), getattr(mod, fold + "_ref")
        moved = nbytes(V, kern(V, R, signed=False))
        ms = time_ms(lambda: kern(V, R, signed=False), inner=10)
        plain_ms = time_ms(lambda: twin(V, R, signed=False))
        times[rec] = (ms, plain_ms, moved)
        floor = moved / HBM_BYTES_PER_S * 1e3
        phase("protocol time", f"{rec} {shape(V)}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, memory floor {floor:.4f} ms "
              f"({moved} B; {floor / ms:.0%} of the rate)  ({smi})")
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev)  # 2 x L2
    A = c["Agt"].view(gl.N, 3, n_rows, fs.M)
    x = fs.tm.crt_t(outs[f"step W={Wl} psi=True"]["digits"]).contiguous() \
        .view(gl.N, 3, Wl, fs.M)
    moved = nbytes(A, x, SL.slot_matvec(A, x, gtab))
    ms = time_ms(lambda: SL.slot_matvec(A, x, gtab), inner=10)
    plain_ms = time_ms(lambda: SL.slot_matvec_ref(A, x, gtab))
    per, mix = slot_matvec_sass()
    products = gl.N * n_rows * Wl * fs.M
    mv_ops_ms = products * per / issue_rate(dev)[0] * 1e3
    times[SLOT_MATVEC_REC] = (ms, plain_ms, moved, mv_ops_ms)
    floor = max(moved / HBM_BYTES_PER_S * 1e3, mv_ops_ms)
    phase("protocol time", f"slot_matvec {shape(A, x)}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; {moved} B, {products} extension "
          f"products x {per:.2f} SASS instructions (its inner loop, {mix}; "
          f"{mv_ops_ms:.4f} ms at the issue rate), bound {floor:.4f} ms "
          f"({floor / ms:.0%} of it); one Goldilocks modmul a product of "
          f"words would be {9 * products / modmul_peak(dev)[0] * 1e3:.4f} "
          "ms; " + device_only(lambda: SL.slot_matvec(A, x, gtab), dev,
                               floor, flush) + f"  ({smi})")
    for (W, psi), sfs in steps.items():
        ms = time_ms(lambda: sfs.step(c, *ins[W]))
        phase("protocol time", f"goldilocks step W={W} psi={psi}: {ms:.4f} "
              f"ms = {1e3 / ms:.2f} steps/s = {W * 1e3 / ms:.1f} "
              f"witnesses/s  ({smi})")
    ms = time_ms(lambda: bfs.step(bc, *bins))
    phase("protocol time", f"babybear step W={Wb} (commit block "
          f"{bfs.commit_block(Wb)}): {ms:.4f} ms = {1e3 / ms:.2f} steps/s "
          f"= {Wb * 1e3 / ms:.1f} witnesses/s  ({smi})")
    ms = time_ms(lambda: ft.prove(ct_tables, wt, cw, rts))
    phase("protocol time", f"goldilocks tree {Wt} leaves L={Lt}: {ms:.4f} "
          f"ms = {Wt * 1e3 / ms:.1f} leaves/s  ({smi})")
    st = step_stages(fs, c, ins[PROTO_WS[-1]])
    total = sum(st.values())
    phase("protocol stages", f"W={PROTO_WS[-1]} psi=True, each stage alone: "
          + ", ".join(f"{k} {v:.4f} ms ({v / total:.1%})"
                      for k, v in st.items())
          + f"; sum {total:.4f} ms  ({smi})")
    for name, sfs, tc, si in (("goldilocks", fs, c, ins[PROTO_WS[-1]]),
                              ("babybear", bfs, bc, bins)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sfs.step(tc, *si)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        phase("protocol memory", f"{name} step W={si[0].shape[1]}: "
              f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB), "
              f"{peak - held} B above the {held} B held before it  ({smi})")

    # -- 43. where the device time of one step goes ---------------------------
    busy_ms, wall_ms, top = device_profile(
        lambda: fs.step(c, *ins[PROTO_WS[-1]]), 3, dev, 6)
    phase("protocol profile", f"step W={PROTO_WS[-1]} psi=True: device busy "
          f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall (profiled), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per step: {top}  ({smi})")
    def prove():
        return ft.prove(ct_tables, wt, cw, rts)

    busy_ms, wall_ms, top = device_profile(prove, 3, dev, 4)
    prove_us = host_us(prove, 5)
    n_ops = torch_ops(prove)
    step_ops = torch_ops(lambda: fs.step(c, *ins[PROTO_WS[-1]]))
    phase("protocol profile", f"tree {Wt} leaves L={Lt}: device busy "
          f"{busy_ms:.4f} ms of {wall_ms:.4f} ms wall (profiled), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; host {prove_us / 1e3:.4f} ms a prove "
          f"unsynchronised, {n_ops} torch ops a prove ("
          f"{prove_us / n_ops:.2f} us an op), {step_ops} a W={PROTO_WS[-1]} "
          f"step; per prove: {top}  ({smi})")

    rec_fold = {rec: folds[rec][1] for rec in PROTO_KERNELS}
    return [record(rec, src, ref, launches[rec_fold[rec]], max_err[rec],
                   *times[rec])
            for rec, (src, ref, _) in PROTO_KERNELS.items()] + [
        record(SLOT_MATVEC_REC, SLOT_SOURCE, SLOT_XLA[SLOT_MATVEC_REC],
               launches["slot_matvec"], max_err[SLOT_MATVEC_REC],
               *times[SLOT_MATVEC_REC][:3], ops_ms=times[SLOT_MATVEC_REC][3])]


def py_negacyclic(a, b, q) -> list:
    """The negacyclic product of two coefficient lists in Python ints, by
    one big-integer product (Kronecker substitution: each coefficient a
    520-bit field of one integer, wide enough for N * q^2)."""
    n = len(a)
    nb = (2 * q.bit_length() + n.bit_length() + 8) // 8

    def pack(v):
        return int.from_bytes(b"".join(int(x).to_bytes(nb, "little")
                                       for x in v), "little")

    c = (pack(a) * pack(b)).to_bytes(2 * n * nb, "little")
    full = [int.from_bytes(c[k * nb:(k + 1) * nb], "little")
            for k in range(2 * n)]
    return [(full[k] - full[k + n]) % q for k in range(n)]


@functools.lru_cache(maxsize=1)
def library_sass() -> list:
    """(mangled name, SASS text) of every kernel in the built library
    (one cuobjdump of the whole library, kept for the run)."""
    from stark_rings_tpu_torch.ops import _build

    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    return re.findall(r"Function : (\S+)(.*?)(?=Function :|\Z)", sass, re.S)


def sass_instructions(pattern) -> int:
    """The SASS instructions of the one kernel whose mangled name matches
    ``pattern`` in the built library (cuobjdump), less the NOPs that pad
    its end: the instructions a thread of a straight-line kernel
    issues."""
    body = [b for name, b in library_sass() if re.search(pattern, name)]
    if len(body) != 1:
        raise RuntimeError(f"expected one kernel matching {pattern!r} in "
                           f"the SASS, found {len(body)}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body[0])
    return sum(1 for op in ops if op.split()[0] != "NOP")


def slice_stark(dev, smi, rng) -> list:
    """Phases 44-50: BASELINE config 3, the 252-bit stark prime.  The
    kernels S1 (``stark_mul``), S2 (``stark_add``, ``stark_sub``) and S3
    (``limb_fold``) against their twins; the deg-2^12 ring multiply of
    ``get_power_ring("stark_prime", 12).mxu_ctx()`` at B = 256, the model
    multiply ``TModelMul.mul_t`` at B = 4,096 and its commit, the limbed
    folding step at W = 16 and a sumcheck at nv = 20 on the generic
    prover, and the four-step on 4 shards of the card.  Returns the
    kernels' JSON records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch.fields import STARK as F
    from stark_rings_tpu_torch.mle.sumcheck_kernel import sumcheck_prove_many
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.ops.dense_linear import probe_dense_matrix
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.ops.mxu2 import digit_table
    from stark_rings_tpu_torch.ops.mxu_limb import LimbPrescaledMat
    from stark_rings_tpu_torch.ops.ntt import NTTContext
    from stark_rings_tpu_torch.parallel import ShardedNTT, make_mesh
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_power_ring, get_ring

    q = F.q
    t0 = time.perf_counter()
    pr = get_power_ring("stark_prime", ST_LOG, device=dev)
    e = pr.mxu_ctx()
    ring = get_ring("stark_prime", device=dev)
    tm = TModelMul(ring)
    n_rows, L, base, W = ST_PROTO
    fs = FoldingStep(ring, n_rows, L, base)
    phase("stark tables", f"MxuLimbNTT (N = {e.N} = {e.N1} x {e.N2}, "
          f"unsigned u8 scheme: 32 data planes x 32 weight digits), the "
          f"D = 16 model's CRT / ICRT and the step (n = {n_rows}, L = {L}, "
          f"base {base}: k = {fs.k}, M = {fs.M}) built in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 44. S1-S3 against their twins -----------------------------------
    max_err = {}
    t0 = time.perf_counter()
    edges = [0, 1, q - 1, (1 << 256) % q, q, (1 << 256) - 1]
    ev = torch.from_numpy(F.limbs_np(edges).view(np.int32)).to(dev)
    ne = len(edges)
    x = F.rand((ST_RANDOM,), rng, dev)
    y = F.rand((ST_RANDOM,), rng, dev)
    x[:ne * ne] = ev.repeat_interleave(ne, 0)
    y[:ne * ne] = ev.repeat(ne, 1)
    a4 = F.rand((4, e.N2, e.N1), rng, dev)
    for op in ("mul", "add", "sub"):
        name = "stark_" + op
        kern, twin = getattr(S, name), getattr(S, name + "_ref")
        check(max_err, name, kern(x, y), twin(x, y),
              f"2^{ST_RANDOM.bit_length() - 1} random elements and the "
              f"{ne} x {ne} edge pairs")
        for b_ in (e.c["tw"], ev[3]):
            check(max_err, name, kern(a4, b_), twin(a4, b_),
                  f"{shape(a4)} against a broadcast {shape(b_)}")
    # the level buckets of the multiply and the model CRT's, both schemes
    a = pr.rand_coeff((ST_B,), rng)
    b = pr.rand_coeff((ST_B,), rng)
    x2 = e._to_internal(a).reshape(-1, e.N1, 8)
    mats = {"level": (e.mat1, x2.transpose(0, 1), e.c["w1"],
                      e.c["w1_corr"])}
    at = F.rand((ring.D, ST_MODEL_B), rng, dev)
    bt = F.rand((ring.D, ST_MODEL_B), rng, dev)
    mats["model crt"] = (tm._crt.core, at, tm._crt.w, tm._crt.w_corr)
    signed = {"level": LimbPrescaledMat(F.rand_ints((e.N1, e.N1), rng),
                                        unsigned=False),
              "model crt": LimbPrescaledMat(probe_dense_matrix(
                  ring.spec.crt, ring.D, ring.D, q), unsigned=False)}
    folds = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for key, (core, xin, w, corr) in mats.items():
        for mat, (ww, cc) in ((core, (w, corr)),
                              (signed[key], digit_table(signed[key].big,
                                                        dev))):
            V = mat.dot(xin, ww, cc)
            sg = not mat.unsigned
            folds.setdefault(key, V)
            rand = torch.randint(-2**31, 2**31, V.shape, generator=gen,
                                 dtype=torch.int32, device=dev)
            for what, Vc in (("GEMM", V), ("int32", rand)):
                for tr in (False, True):
                    check(max_err, "limb_fold",
                          S.limb_fold(Vc, mat.R, signed=sg, transpose_out=tr),
                          S.limb_fold_ref(Vc, mat.R, signed=sg,
                                          transpose_out=tr),
                          f"{key} R={mat.R} {shape(Vc)} "
                          f"{'signed' if sg else 'unsigned'} {what}"
                          + (" transposed" if tr else ""))
    torch.cuda.synchronize()
    phase("stark parity", f"S1, S2 on 2^{ST_RANDOM.bit_length() - 1} "
          f"random elements and {ne} x {ne} edge pairs (0, 1, q - 1, "
          f"R mod q, q's limbs, 2^256 - 1) and against broadcast tables; "
          f"S3 on the level buckets {shape(folds['level'])} and the model "
          f"CRT's {shape(folds['model crt'])} in both schemes, and on "
          f"full-range int32: bit-equal to the twins "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 45. the main path, launches counted -------------------------------
    A = F.rand((ring.D, ST_COMMIT[0], ST_COMMIT[1]), rng, dev)
    sv = F.rand((ring.D, ST_COMMIT[2], ST_COMMIT[1]), rng, dev)
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    ins = (fs.rand_witness(W, rng), fs.rand_witness(W, rng),
           *(tm.to_t(ring.rand_ntt((W, n_rows), rng)).contiguous()
             for _ in range(2)), rt)
    tables = [F.rand((1 << ST_NV,), rng, dev) for _ in range(2)]
    chal = F.rand((ST_NV,), rng, dev)
    sn = ShardedNTT("stark_prime", e.N, ST_SHARDS)
    mesh = make_mesh(ST_SHARDS, device=dev)
    cspec = sn.shard_specs(1)[0]
    sh_a, sh_b = (sn.shard(sn.to_matrix(x[:ST_SHARD_B]), cspec, mesh)
                  for x in (a, b))
    sh_mul = sn.make_fns(mesh, batch_ndim=1)[2]
    torch.cuda.synchronize()
    S.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "mul": lambda: e.mul(a, b),
        "mul_cached": lambda: e.mul_cached(a, e.precompute(b)),
        "square": lambda: e.square(a),
        "mul_t": lambda: tm.mul_t(at, bt),
        "commit": lambda: tm.matvec_t(A, sv),
        "commit blocked": lambda: tm.matvec_t(A, sv, block=ST_COMMIT[3]),
        "step": lambda: fs.step(c, *ins),
        "sumcheck": lambda: sumcheck_prove_many(tables, chal,
                                                field="stark_prime"),
        "four-step": lambda: sh_mul(sh_a, sh_b),
    }
    results, per_run = {}, {}
    for name, fn in runs.items():
        before = dict(S.LAUNCHES)
        results[name] = fn()
        per_run[name] = {k: v - before[k] for k, v in S.LAUNCHES.items()}
    torch.cuda.synchronize()
    launches = dict(S.LAUNCHES)
    phase("stark path", f"mul, mul_cached, square at deg 2^{ST_LOG} "
          f"B={ST_B}; mul_t B={ST_MODEL_B}; the commit n={ST_COMMIT[0]} "
          f"m={ST_COMMIT[1]} W={ST_COMMIT[2]}; the step W={W}; the sumcheck "
          f"nv={ST_NV}; the four-step B={ST_SHARD_B} on {ST_SHARDS} shards "
          f"in {time.perf_counter() - t0:.2f} s; launches "
          f"{json.dumps(per_run)}")
    phase("stark launches", json.dumps(launches))
    for name in STARK_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the stark "
                                 "path")
    if per_run["mul"] != {"stark_mul": 4, "stark_add": 0, "stark_sub": 0,
                          "limb_fold": 6}:
        raise AssertionError(f"MxuLimbNTT.mul launched {per_run['mul']}, "
                             "expected 6 folds and 4 products")

    # -- 46. the multiply against the radix engine and Python ints ---------
    t0 = time.perf_counter()
    ctx = NTTContext(F, e.N, device=dev)
    want = {"mul": ctx.mul(a, b), "square": ctx.mul(a, a)}
    want["mul_cached"] = want["mul"]
    for name, w in want.items():
        got = results[name]
        if got.shape != (ST_B, e.N, 8) or got.dtype != torch.int32:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, w):
            raise AssertionError(f"stark {name}: differs from the radix "
                                 "NTTContext on the card")
    if not bool(F.geq(F.canon_const(-1), results["mul"]).all()):
        raise AssertionError("stark mul: non-canonical output")
    for r in (0, ST_B - 1):
        ai = [int(v) for v in pr.decode(a[r])]
        bi = [int(v) for v in pr.decode(b[r])]
        if [int(v) for v in pr.decode(results["mul"][r])] != \
                py_negacyclic(ai, bi, q):
            raise AssertionError(f"stark mul row {r}: differs from the "
                                 "Python-int negacyclic product")
    four = sn.from_matrix(sn.gather(results["four-step"], cspec, dev))
    if not torch.equal(four, results["mul"][:ST_SHARD_B]):
        raise AssertionError("stark four-step: the sharded mul differs from "
                             "mxu_ctx().mul")
    phase("stark multiply", f"mul, mul_cached and square at B={ST_B} "
          f"bit-equal to NTTContext on the card over the whole batch; rows "
          f"0 and {ST_B - 1} equal the Python-int negacyclic product; the "
          f"four-step on {ST_SHARDS} shards of the card (plain block-"
          f"transpose exchange) equals mxu_ctx().mul on {ST_SHARD_B} rows "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 47. the model multiply and the commit -----------------------------
    t0 = time.perf_counter()
    got = results["mul_t"]
    ai, bi, gi = (ring.decode(v[:, :2].transpose(0, 1))
                  for v in (at, bt, got))
    for r in range(2):
        if [int(v) for v in gi[r]] != ring.spec.coeff_mul(
                [int(v) for v in ai[r]], [int(v) for v in bi[r]]):
            raise AssertionError(f"stark mul_t row {r}: differs from the "
                                 "integer spec")
    full, blk = results["commit"], results["commit blocked"]
    if full.shape != (ring.D, ST_COMMIT[2], ST_COMMIT[0], 8) \
            or not torch.equal(full, blk):
        raise AssertionError("stark commit: blocked and unblocked differ")
    Ai, si = ring.decode(A[:, 0].transpose(0, 1)), ring.decode(
        sv[:, 0].transpose(0, 1))
    acc = [sum(int(Ai[j, d]) * int(si[j, d])
               for j in range(ST_COMMIT[1])) % q for d in range(ring.D)]
    if ring.decode(full[:, 0, 0]).tolist() != acc:
        raise AssertionError("stark commit: c[0, 0] differs from the slot "
                             "products summed in Python ints")
    phase("stark model", f"mul_t B={ST_MODEL_B} equals the integer spec on "
          f"2 rows (bench.py:640-647's gate); the commit blocked "
          f"(block={ST_COMMIT[3]}) equals unblocked and c[0, 0] the slot "
          f"products summed in Python ints "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 48. the step and the sumcheck against independent paths ----------
    t0 = time.perf_counter()
    summary = hold_step(fs, c, ins, results["step"], (0, W - 1))
    msgs, finals = results["sumcheck"]
    if msgs.shape != (ST_NV, 3, 8):
        raise AssertionError(f"stark sumcheck: messages {tuple(msgs.shape)}")
    py_check_proof(F, tables, chal, msgs, finals, "stark sumcheck")
    phase("stark step", f"{summary}; the sumcheck at nv={ST_NV} satisfies "
          f"its relations in Python ints ({time.perf_counter() - t0:.1f} s)")

    # -- 49. timings -------------------------------------------------------
    fa, fb = e.forward(a), e.forward(b)
    Vl = folds["level"]
    rows = fa.numel() // 8
    issue = issue_rate(dev)[0]
    timed = {  # record -> (kernel, twin, inputs, threads, SASS pattern)
        "stark_mul": (lambda: S.stark_mul(fa, fb),
                      lambda: S.stark_mul_ref(fa, fb), (fa, fb), rows,
                      r"stark_binary_kernelILi0E"),
        "stark_add": (lambda: S.stark_add(fa, fb),
                      lambda: S.stark_add_ref(fa, fb), (fa, fb), rows,
                      r"stark_binary_kernelILi1E"),
        "stark_sub": (lambda: S.stark_sub(fa, fb),
                      lambda: S.stark_sub_ref(fa, fb), (fa, fb), rows,
                      r"stark_binary_kernelILi2E"),
        "limb_fold": (lambda: S.limb_fold(Vl, e.N1, signed=False,
                                          transpose_out=True),
                      lambda: S.limb_fold_ref(Vl, e.N1, signed=False,
                                              transpose_out=True),
                      (Vl,), Vl.shape[1] * e.N1, r"limb_fold_kernelILb0E"),
    }
    times, ops_ms = {}, {}
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev)  # 2 x L2
    for name, (kern, twin, inputs, threads, pat) in timed.items():
        moved = nbytes(inputs, kern())
        ms = time_ms(kern, inner=10)
        plain_ms = time_ms(twin)
        per = sass_instructions(pat)
        ops_ms[name] = threads * per / issue * 1e3
        times[name] = (ms, plain_ms, moved)
        floor = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms[name])
        phase("stark time", f"{name} {shape(*inputs)}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; {moved} B, {threads} threads x "
              f"{per} SASS instructions ({ops_ms[name]:.4f} ms at the "
              f"issue rate), bound {floor:.4f} ms ({floor / ms:.0%} of it); "
              + device_only(kern, dev, floor, flush) + f"  ({smi})")
    fbc = e.precompute(b)
    mul_ms = {name: time_ms(fn) for name, fn in (
        ("mul", lambda: e.mul(a, b)),
        ("mul_cached", lambda: e.mul_cached(a, fbc)),
        ("square", lambda: e.square(a)))}
    xl = x2.transpose(0, 1)
    gemm_ms = time_ms(lambda: e.mat1.dot(xl, e.c["w1"], e.c["w1_corr"]))
    ctx_ms = time_ms(lambda: ctx.mul(a, b))
    phase("stark time", f"MxuLimbNTT deg 2^{ST_LOG} B={ST_B}: "
          + ", ".join(f"{k} {v:.4f} ms = {ST_B / v * 1e3:.1f} mults/s"
                      for k, v in mul_ms.items())
          + f"; one level's digit GEMM (planes, _int_mm, offsets) "
          f"{gemm_ms:.4f} ms, its S3 fold {times['limb_fold'][0]:.4f} ms; "
          f"NTTContext mul {ctx_ms:.4f} ms = {ST_B / ctx_ms * 1e3:.1f} "
          f"mults/s  ({smi})")
    mt_ms = time_ms(lambda: tm.mul_t(at, bt))
    cm_ms = time_ms(lambda: tm.matvec_t(A, sv))
    phase("stark time", f"TModelMul.mul_t B={ST_MODEL_B}: {mt_ms:.4f} ms = "
          f"{ST_MODEL_B / mt_ms * 1e3:.1f} mults/s; commit matvec_t "
          f"n={ST_COMMIT[0]} m={ST_COMMIT[1]} W={ST_COMMIT[2]}: "
          f"{cm_ms:.4f} ms = {ST_COMMIT[2] / cm_ms * 1e3:.1f} commits/s  "
          f"({smi})")
    step_ms = time_ms(lambda: fs.step(c, *ins))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    fs.step(c, *ins)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    stages = step_stages(fs, c, ins)
    phase("stark time", f"FoldingStep W={W} (n={n_rows}, L={L}, base "
          f"{base}, commit block {fs.commit_block(W)} of M={fs.M}): "
          f"{step_ms:.3f} ms = {W / step_ms * 1e3:.1f} witnesses/s, "
          f"{peak / 2**30:.2f} GiB above its inputs; stages alone: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
          + f"  ({smi})")
    sc_ms = time_ms(lambda: sumcheck_prove_many(tables, chal,
                                                field="stark_prime"))
    phase("stark time", f"sumcheck nv={ST_NV} k=2 on the generic prover: "
          f"{sc_ms:.3f} ms = {1e3 / sc_ms:.2f} proofs/s  ({smi})")

    # -- 50. where the device time of one multiply goes --------------------
    busy_ms, wall_ms, top = device_profile(lambda: e.mul(a, b), 3, dev, 6)
    phase("stark profile", f"MxuLimbNTT.mul B={ST_B}: device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per mul: {top}  ({smi})")
    busy_ms, wall_ms, top = device_profile(lambda: fs.step(c, *ins), 2, dev,
                                           6)
    phase("stark profile", f"FoldingStep W={W}: device busy {busy_ms:.3f} "
          f"ms of {wall_ms:.3f} ms wall, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per step: {top}  ({smi})")

    return [record(name, ST_SOURCE, ref, launches[name], max_err[name],
                   *times[name], ops_ms=ops_ms[name])
            for name, ref in STARK_KERNELS.items()]


def eq_table(F, pts, dev):
    """eq(pts, x) for every x in {0,1}^n, variable j at bit j: [2^n]."""
    import torch

    one = F.ones((), dev)
    t = F.ones((1,), dev)
    for p in pts:
        t = torch.cat([F.mul(t, F.sub(one, p)), F.mul(t, p)])
    return t


def slice_linalg(dev, smi, rng, keep) -> list:
    """Phases 51-55: BASELINE config 4's mat-vec into its MLEs at full
    width, ``SparseMatrix`` / ``SparseMLE`` / ``DenseMLE.from_matrix``
    over Goldilocks on the card, with K5 and K6 on the path.  No kernel
    of its own (the reference runs sparse linalg in XLA): returns no
    record.  Leaves A and z in ``keep`` for the sharded mat-vec."""
    import struct

    import numpy as np
    import torch

    from stark_rings_tpu_torch import (BABYBEAR, GOLDILOCKS as F, get_ring,
                                       to_torch)
    from stark_rings_tpu_torch import utils as U
    from stark_rings_tpu_torch.linalg import (FieldElems, Matrix, RingElems,
                                              SparseMatrix)
    from stark_rings_tpu_torch.mle import DenseMLE, SparseMLE
    from stark_rings_tpu_torch.mle import fix as FX
    from stark_rings_tpu_torch.spec import get_model

    q = F.q
    n = 1 << LA_LOG
    nnz = n * LA_TERMS

    # -- 51. tables -----------------------------------------------------------
    t0 = time.perf_counter()
    e = FieldElems(F, dev)
    cols_np = rng.integers(0, n, nnz, dtype=np.int64).astype(np.int32)
    data_np = rng.integers(0, q, nnz, dtype=np.uint64)
    z_np = rng.integers(0, q, n, dtype=np.uint64)
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        LA_TERMS)
    A = SparseMatrix(e, n, n, to_torch(data_np, dev), rows,
                     torch.from_numpy(cols_np).to(dev))
    z = to_torch(z_np, dev)
    pts = F.rand((2 * LA_LOG,), rng, dev)       # c (columns), then r (rows)
    c, r = list(pts[:LA_LOG]), list(pts[LA_LOG:])
    ring = get_ring("goldilocks", device=dev)
    er = RingElems(ring)
    rn = 1 << LA_RING_LOG
    rnnz = rn * LA_TERMS
    rcols = rng.integers(0, rn, rnnz, dtype=np.int64)
    AR = SparseMatrix(er, rn, rn, er.rand((rnnz,), rng),
                      torch.arange(rn, device=dev).repeat_interleave(
                          LA_TERMS), torch.from_numpy(rcols).to(dev))
    zr = er.rand((rn,), rng)
    dn = 1 << LA_DM_LOG
    AD = SparseMatrix(e, dn, dn, e.rand((dn * LA_TERMS,), rng),
                      torch.arange(dn, device=dev).repeat_interleave(
                          LA_TERMS),
                      torch.from_numpy(rng.integers(0, dn, dn * LA_TERMS))
                      .to(dev))
    pd = F.rand((2 * LA_DM_LOG,), rng, dev)
    torch.cuda.synchronize()
    phase("linalg tables", f"A {n} x {n}, nnz {nnz} "
          f"({nbytes(A.data, A.rows, A.cols)} B of data and indices), z "
          f"[{n}]; the ring mat-vec {rn} x {rn}, nnz "
          f"{rnnz} over the goldilocks model (D = {ring.D}); the nv = "
          f"{2 * LA_DM_LOG} matrix {dn} x {dn}, nnz {dn * LA_TERMS}; built "
          f"in {time.perf_counter() - t0:.1f} s")

    # -- 52. the path, launches counted ---------------------------------------
    FX.reset_launches()
    t0 = time.perf_counter()
    y = A.mul_vec(z)
    dm = DenseMLE(e, LA_LOG, y)
    y_at = FX.evaluate_goldilocks(dm.evals, r)                 # K5
    y_fix = FX.fix_last_goldilocks(dm.evals, r[LA_LOG - LA_FIX_K:])   # K6
    sm = SparseMLE.from_matrix(e, A)
    full = sm.evaluate(c + r)
    fixed = sm.fix_variables(c)
    fixed_d = fixed.to_dense().evals
    fixed_at = FX.evaluate_goldilocks(fixed_d, r)              # K5
    yr = AR.mul_vec(zr)
    mdd = DenseMLE.from_matrix(e, AD)
    mdd_at = FX.evaluate_goldilocks(mdd.evals, list(pd))       # K5
    torch.cuda.synchronize()
    launches = dict(FX.LAUNCHES)
    phase("linalg path", f"mul_vec, DenseMLE(y) through K5 and K6 (k = "
          f"{LA_FIX_K}), SparseMLE.from_matrix (nv = {sm.num_vars}) "
          f"evaluated and fixed at c, the ring mat-vec, DenseMLE.from_matrix "
          f"(nv = {mdd.num_vars}) through K5 in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 53. oracles ----------------------------------------------------------
    t0 = time.perf_counter()
    if y.shape != (n,) or sm.num_vars != 2 * LA_LOG:
        raise AssertionError(f"y {tuple(y.shape)}, nv {sm.num_vars}")
    pick = rng.choice(n, LA_ORACLE_ROWS, replace=False)
    y_host = y.cpu().numpy().view(np.uint64)
    for i in pick:
        s_ = sum(int(data_np[t]) * int(z_np[cols_np[t]])
                 for t in range(i * LA_TERMS, (i + 1) * LA_TERMS)) % q
        if int(y_host[i]) != s_:
            raise AssertionError(f"mul_vec row {i}: {int(y_host[i])} != "
                                 f"{s_} (Python ints)")
    checks = {
        "K5 at r": (y_at, dm.evaluate(r)),
        "K6 k=10": (y_fix, dm.fix_last_variables(
            r[LA_LOG - LA_FIX_K:]).evals),
        "fix_variables(c)": (fixed_d, A.mul_vec(eq_table(F, c, dev))),
        "fixed at r": (fixed_at, full),
        "from_matrix nv=24": (mdd_at, SparseMLE.from_matrix(e, AD).evaluate(
            list(pd))),
    }
    for what, (got, want) in checks.items():
        if u64_err(got, want, what):
            raise AssertionError(f"{what}: differs")
    model = get_model("goldilocks")
    ring_rows = rng.choice(rn, LA_RING_ROWS, replace=False)
    ents = (ring_rows[:, None] * LA_TERMS
            + np.arange(LA_TERMS)[None, :]).reshape(-1)
    yr_host = ring.decode(yr[torch.from_numpy(ring_rows).to(dev)])
    d_host = ring.decode(AR.data[torch.from_numpy(ents).to(dev)])
    z_host = ring.decode(zr[torch.from_numpy(rcols[ents]).to(dev)])
    for k, i in enumerate(ring_rows):
        acc = [0] * ring.D
        for t in range(k * LA_TERMS, (k + 1) * LA_TERMS):
            prod = model.ntt_mul([int(v) for v in d_host[t]],
                                 [int(v) for v in z_host[t]])
            acc = [(x + y_) % q for x, y_ in zip(acc, prod)]
        if [int(v) for v in yr_host[k]] != acc:
            raise AssertionError(f"ring mul_vec row {i} differs from the "
                                 "spec's slot products")
    eb = FieldElems(BABYBEAR, dev)

    def u64(*v):
        return struct.pack(f"<{len(v)}Q", *v)

    def bb4(*v):
        return b"".join(int(x).to_bytes(4, "little") for x in v)

    golden = {
        "Matrix": (Matrix.from_ints(eb, [[1, 2], [3, 4]]),
                   u64(2, 2) + bb4(1, 2) + u64(2) + bb4(3, 4)),
        "SparseMatrix": (SparseMatrix.from_entries(eb, 2, 3, [(0, 1, 5),
                                                              (1, 2, 7)]),
                         u64(2, 3, 2, 1) + bb4(5) + u64(1, 1) + bb4(7)
                         + u64(2)),
        "SparseMLE": (SparseMLE.from_pairs(eb, 2, [(3, 8), (1, 5)]),
                      u64(2, 1) + bb4(5) + u64(3) + bb4(8) + u64(2)
                      + bb4(0)),
    }
    for what, (obj, want) in golden.items():
        if U.serialize_compressed(obj) != want:
            raise AssertionError(f"{what}: bytes differ from the arkworks "
                                 "layout")
    phase("linalg oracle", f"{LA_ORACLE_ROWS} rows of y equal Python-int "
          f"sums; K5 and K6 equal DenseMLE.evaluate / fix_last_variables; "
          f"SparseMLE.fix_variables(c) equals A.mul_vec(eq(c, .)) and its "
          f"K5 evaluation at r the nv = {sm.num_vars} evaluation at r||c; "
          f"the nv = {mdd.num_vars} DenseMLE.from_matrix through K5 equals "
          f"SparseMLE.evaluate; {LA_RING_ROWS} ring rows equal the spec's "
          f"slot products in Python ints; {', '.join(golden)} serialize to "
          f"the golden bytes ({time.perf_counter() - t0:.1f} s)")

    # -- 54. launch counts ----------------------------------------------------
    phase("linalg launches", json.dumps(launches))
    if launches != {"evaluate_goldilocks": 3, "fix_last_goldilocks": 1}:
        raise AssertionError(f"K5 / K6 launches on the path: {launches}, "
                             "expected 3 and 1")

    # -- 55. timings and profile ----------------------------------------------
    nv_s, nv_d = sm.num_vars, mdd.num_vars
    ms = {
        "mul_vec": time_ms(lambda: A.mul_vec(z)),
        f"SparseMLE.evaluate nv={nv_s}": time_ms(lambda: sm.evaluate(c + r)),
        "SparseMLE.fix_variables(c)": time_ms(lambda: sm.fix_variables(c)),
        f"K5 nv={LA_LOG}": time_ms(lambda: FX.evaluate_goldilocks(y, r),
                                   inner=10),
        f"K6 nv={LA_LOG} k={LA_FIX_K}": time_ms(
            lambda: FX.fix_last_goldilocks(y, r[LA_LOG - LA_FIX_K:]),
            inner=10),
        "ring mul_vec": time_ms(lambda: AR.mul_vec(zr)),
        f"DenseMLE.from_matrix nv={nv_d}": time_ms(
            lambda: DenseMLE.from_matrix(e, AD)),
        f"K5 nv={nv_d}": time_ms(lambda: FX.evaluate_goldilocks(
            mdd.evals, list(pd)), inner=10),
    }
    ev_ms = ms[f"SparseMLE.evaluate nv={nv_s}"]
    phase("linalg time", f"mat-vec {n} x {n} nnz {nnz}: "
          f"{ms['mul_vec']:.4f} ms = {1e3 / ms['mul_vec']:.1f} mat-vecs/s; "
          f"SparseMLE nv={nv_s} {1e3 / ev_ms:.2f} evaluations/s; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"  ({smi})")
    for label, fn in (("mul_vec", lambda: A.mul_vec(z)),
                      (f"SparseMLE.evaluate nv={nv_s}",
                       lambda: sm.evaluate(c + r))):
        busy_ms, wall_ms, top = device_profile(fn, 3, dev, 6)
        phase("linalg profile", f"{label}: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall, idle share "
              f"{1 - busy_ms / wall_ms:.3f}; per call: {top}  ({smi})")
    keep.update(A=A, z=z)
    return []


def count_twins(mods):
    """Wrap each ``(module, twin name)`` of ``mods`` so its calls are
    counted: returns (the counts by twin name, a function that puts the
    twins back)."""
    calls, saved = {}, []
    for mod, name in mods:
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls, restore


def slice_parallel(dev, smi, rng, linalg) -> list:
    """Phases 56-61: the sharded layer (``stark_rings_tpu_torch.parallel``
    and the witness-sharded folding step and tree) on 8 shards of the
    card at the widths the earlier slices run, with K3, ``bb_fold_end``,
    S3, K5 and K7 on its path.  No kernel of its own: returns no
    record."""
    import contextlib
    import io

    import torch

    from stark_rings_tpu_torch import GOLDILOCKS as F, get_field
    from stark_rings_tpu_torch.examples import distributed_prover
    from stark_rings_tpu_torch.linalg import FieldElems, Matrix, RingElems
    from stark_rings_tpu_torch.mle import DenseMLE, bit_reverse_table
    from stark_rings_tpu_torch.mle import fix as FX, sumcheck_kernel as SK
    from stark_rings_tpu_torch.mle.sumcheck import (
        sumcheck_prove_many_with_challenges)
    from stark_rings_tpu_torch.ops import fold as K, fold_bb as KB
    from stark_rings_tpu_torch.ops import stark as ST
    from stark_rings_tpu_torch.parallel import (ShardedMatVec, ShardedMLE,
                                                ShardedModelMul,
                                                ShardedSparseMatVec,
                                                make_mesh, shard)
    from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree
    from stark_rings_tpu_torch.rings import get_ring

    P, nv = PAR_P, PAR_NV

    # -- 56. tables -----------------------------------------------------------
    t0 = time.perf_counter()
    mesh = make_mesh(P, device=dev)
    rings = {n: get_ring(n, device=dev) for n in PAR_MODEL_B}
    smms = {n: ShardedModelMul(r, mesh) for n, r in rings.items()}
    mops, msh = {}, {}
    for n, Bn in PAR_MODEL_B.items():
        r = rings[n]
        a, b = r.rand_coeff((Bn,), rng), r.rand_coeff((Bn,), rng)
        mops[n] = (a, b, r.crt(a), r.crt(b), b[:1].contiguous())
        msh[n] = [smms[n].shard(x) for x in mops[n][:4]]
    fields = {n: get_field(n) for n in PAR_SC_FIELDS}
    sms = {n: ShardedMLE(f, nv, mesh) for n, f in fields.items()}
    mle_t = {n: [f.rand((1 << nv,), rng, dev)
                 for _ in range(PAR_K if n == "goldilocks" else 2)]
             for n, f in fields.items()}
    mle_s = {n: [sms[n].shard(T) for T in ts] for n, ts in mle_t.items()}
    chal = {n: list(f.rand((nv,), rng, dev)) for n, f in fields.items()}
    sm, T0, T1 = sms["goldilocks"], *mle_t["goldilocks"][:2]
    pts = chal["goldilocks"]
    A, z = linalg["A"], linalg["z"]
    ssmv = ShardedSparseMatVec(FieldElems(F, dev), mesh)
    sp = ssmv.shard(A)
    gl = rings["goldilocks"]
    n_mv, m_mv = PAR_MV
    Amv, vmv = gl.rand_ntt((n_mv, m_mv), rng), gl.rand_ntt((m_mv,), rng)
    smv = ShardedMatVec(RingElems(gl), mesh)
    dA, dv = smv.shard(Amv, vmv)
    n_rows, L, base = PROTO
    steps = {(W, psi): FoldingStep(gl, n_rows, L, base, psi_check=psi)
             for W in PROTO_WS for psi in (False, True)}
    fs = steps[(PROTO_WS[-1], True)]
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(gl.rand_coeff((), rng))
    ins, sins = {}, {}
    for W in PROTO_WS:
        ins[W] = (fs.rand_witness(W, rng), fs.rand_witness(W, rng),
                  *(fs.tm.to_t(gl.rand_ntt((W, n_rows), rng)).contiguous()
                    for _ in range(2)))
        sins[W] = [shard(x, mesh, 1) for x in ins[W]]
    sfns = {key: st.make_sharded_step_fn(mesh) for key, st in steps.items()}
    Wt, Lt = PROTO_TREE
    ft = FoldingTree(gl, n_rows, Lt, base=base)
    tc = ft.init_tables(rng)
    wt = ft.rand_witnesses(Wt, rng)
    cw = ft.commit_witnesses(tc, wt)
    rts = ft.precompute_challenges([gl.rand_coeff((), rng)
                                    for _ in range(Wt.bit_length() - 1)])
    torch.cuda.synchronize()
    phase("parallel tables", f"a mesh of {P} shards of {dev}; model batches "
          f"{PAR_MODEL_B}, {P} shards each; nv = {nv} tables over "
          f"{list(fields)} ({P} shards of 2^{nv - sm.logP}); config 4's A "
          f"({A.nrows} x {A.ncols}, nnz {A.nnz}: {sp[0][0].shape[0]} entries "
          f"a shard); the ring mat-vec {n_mv} x {m_mv} ({m_mv // P} columns "
          f"a shard); the step n={n_rows}, L={L}, base={base}, W in "
          f"{list(PROTO_WS)} ({[W // P for W in PROTO_WS]} witnesses a "
          f"shard); the {Wt}-leaf tree L={Lt}; drawn in "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 57. the path, launches and twin calls counted ------------------------
    mods = (K, KB, ST, FX, SK)
    path = ("fold_end", "bb_fold_end", "limb_fold", "evaluate_goldilocks",
            *(f"sumcheck_prove_many_{n}" for n in PAR_SC_FIELDS))

    def counts():
        every = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        return {k: every[k] for k in path}

    fns = {}
    for n, smm in smms.items():
        sa, sb, sna, snb = msh[n]
        fns[f"{n} mul"] = functools.partial(smm.make_mul_fn(), sa, sb)
        fns[f"{n} ntt_mul"] = functools.partial(smm.make_ntt_mul_fn(), sna,
                                                snb)
        fns[f"{n} challenge"] = functools.partial(
            smm.make_challenge_mul_fn(), sa, mops[n][4])
    T0s, T1s = mle_s["goldilocks"][:2]
    fns.update({
        "eval": functools.partial(sm.make_eval_fn(), T0s, *pts),
        f"fix k={PAR_FIX_K}": functools.partial(sm.make_fix_fn(PAR_FIX_K),
                                                T0s, *pts[:PAR_FIX_K]),
        "hypercube sum": functools.partial(sm.make_hypercube_sum_fn(), T0s),
        "inner product": functools.partial(sm.make_inner_product_fn(), T0s,
                                           T1s),
        **{f"sumcheck {n} k=2": functools.partial(
            sms[n].make_sumcheck_fn(), *mle_s[n][:2], *chal[n])
           for n in PAR_SC_FIELDS},
        f"sumcheck goldilocks k={PAR_K}": functools.partial(
            sm.make_sumcheck_many_fn(PAR_K), *mle_s["goldilocks"], *pts),
        "sparse mat-vec": functools.partial(
            ssmv.make_matvec_fn(A.nrows), *sp, z),
        "ring mat-vec": functools.partial(smv.make_matvec_fn(), dA, dv),
        **{f"step W={W} psi={psi}": functools.partial(
            sfns[(W, psi)], c, *sins[W], rt) for W, psi in steps},
        "tree": functools.partial(ft.prove_sharded, mesh, tc, wt, cw, rts),
    })
    text = io.StringIO()

    def example():
        with contextlib.redirect_stdout(text):
            distributed_prover.main(device=dev, P=P)

    fns["distributed prover"] = example
    torch.cuda.synchronize()
    for mod in mods:
        mod.reset_launches()
    twins, restore = count_twins(
        ((K, "fold_end_ref"), (KB, "bb_fold_end_ref"), (ST, "limb_fold_ref"),
         (FX, "evaluate_goldilocks_ref"), (SK, "sumcheck_prove_many_ref")))
    t0 = time.perf_counter()
    outs, per_run = {}, {}
    try:
        for name, fn in fns.items():
            before = counts()
            outs[name] = fn()
            per_run[name] = {k: v - before[k] for k, v in counts().items()
                             if v != before[k]}
        torch.cuda.synchronize()
    finally:
        restore()
    launches = counts()
    phase("parallel path", f"{len(fns)} sharded calls in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_run}; twin "
          f"calls {twins}")
    print(text.getvalue().rstrip())

    # -- 58. oracles ----------------------------------------------------------
    t0 = time.perf_counter()

    def same(what, got, want):
        if u64_err(got, want, what):
            raise AssertionError(f"{what}: differs")

    def cat(xs, dim=0):
        return torch.cat(list(xs), dim=dim)

    for n in PAR_MODEL_B:
        ring, tm = rings[n], smms[n].tm
        a, b, na, nb, ch = mops[n]
        at, bt = tm.to_t(a), tm.to_t(b)
        got, got_c = cat(outs[f"{n} mul"]), cat(outs[f"{n} challenge"])
        same(f"{n} mul", got, tm.from_t(tm.mul_t(at, bt)))
        same(f"{n} ntt_mul", cat(outs[f"{n} ntt_mul"]),
             tm.from_t(tm.ntt_mul_t(tm.to_t(na), tm.to_t(nb))))
        same(f"{n} challenge", got_c, tm.from_t(tm.mul_cached_t(
            at, tm.precompute_t(tm.to_t(ch)))))
        ai, bi, ci = (ring.decode(x) for x in (a[:PAR_SPEC_ROWS],
                                               b[:PAR_SPEC_ROWS], ch))
        gi, gci = (ring.decode(x[:PAR_SPEC_ROWS]) for x in (got, got_c))
        for r in range(PAR_SPEC_ROWS):
            for rhs, res, what in ((bi[r], gi, "mul"), (ci[0], gci,
                                                        "challenge")):
                want = ring.spec.coeff_mul([int(v) for v in ai[r]],
                                           [int(v) for v in rhs])
                if [int(v) for v in res[r]] != want:
                    raise AssertionError(f"{n} sharded {what} row {r} "
                                         "differs from the integer spec")
    e = FieldElems(F, dev)
    dm = DenseMLE(e, nv, T0)
    same("eval", outs["eval"], dm.evaluate(pts))
    same("eval K5 whole", outs["eval"], FX.evaluate_goldilocks(T0, pts))
    same(f"fix k={PAR_FIX_K}", cat(outs[f"fix k={PAR_FIX_K}"]),
         dm.fix_variables(pts[:PAR_FIX_K]).evals)
    same("hypercube sum", outs["hypercube sum"], F.sum(T0, 0))
    ip = outs["inner product"]
    same("inner product", ip, F.sum(F.mul(T0, T1), 0))
    for n in PAR_SC_FIELDS:
        f = fields[n]
        for k in (2, PAR_K) if n == "goldilocks" else (2,):
            got = outs[f"sumcheck {n} k={k}"]
            msgs, finals = (got[0], list(got[1:])) if k == 2 else got
            want_m, want_f = sumcheck_prove_many_with_challenges(
                f, mle_t[n][:k], chal[n])
            same(f"sumcheck {n} k={k} msgs", msgs, want_m)
            for j, (g, w) in enumerate(zip(finals, want_f)):
                same(f"sumcheck {n} k={k} final {j}", g, w)
    m0 = F.decode(outs["sumcheck goldilocks k=2"][0][0])
    if (int(m0[0]) + int(m0[1])) % F.q != int(F.decode(ip)):
        raise AssertionError("sumcheck round 0: p(0) + p(1) is not the "
                             "inner product (Python ints)")
    y = outs["sparse mat-vec"]
    same("sparse mat-vec", y, A.mul_vec(z))
    pick = torch.from_numpy(rng.choice(A.nrows, LA_ORACLE_ROWS,
                                       replace=False)).to(dev)
    for i, yi in zip(pick.tolist(), F.decode(y[pick]).tolist()):
        ent = (A.rows == i).nonzero().reshape(-1)
        s_ = sum(int(d) * int(v) for d, v in zip(
            F.decode(A.data[ent]), F.decode(z[A.cols[ent].long()]))) % F.q
        if int(yi) != s_:
            raise AssertionError(f"sparse mat-vec row {i}: {yi} != {s_} "
                                 "(Python ints)")
    cv = outs["ring mat-vec"]
    same("ring mat-vec", cv, Matrix(RingElems(gl), Amv).mul_vec(vmv))
    vi = gl.decode(vmv)
    for i in PAR_MV_INT_ROWS:
        Ai = gl.decode(Amv[i])
        acc = [0] * gl.D
        for j in range(m_mv):
            prod = gl.spec.ntt_mul([int(v) for v in Ai[j]],
                                   [int(v) for v in vi[j]])
            acc = [(x + y_) % gl.q for x, y_ in zip(acc, prod)]
        if gl.decode(cv[i]).tolist() != acc:
            raise AssertionError(f"ring mat-vec row {i} differs from the "
                                 "spec's slot products in Python ints")
    for (W, psi), st in steps.items():
        got = outs[f"step W={W} psi={psi}"]
        want = st.step(c, *ins[W], rt)
        if sorted(got) != sorted(want):
            raise AssertionError(f"step W={W} psi={psi}: keys {sorted(got)}")
        for key, val in want.items():
            same(f"step W={W} psi={psi} {key}",
                 cat(got[key], 0 if key.startswith("ok_") else 1), val)
    levels, rw, rc = outs["tree"]
    lv_l, rw_l, rc_l = ft.prove(tc, wt, cw, rts)
    same("tree root witness", rw, rw_l)
    same("tree root commitment", rc, rc_l)
    for lvl, (got, want) in enumerate(zip(levels, lv_l)):
        for key, val in want.items():
            same(f"tree level {lvl} {key}", got[key], val)
    if not ft.verify(tc, wt, cw, levels, rts):
        raise AssertionError("the sharded tree was not accepted")
    if "sharded sumcheck verified" not in text.getvalue():
        raise AssertionError("the distributed prover did not verify")
    phase("parallel oracle", f"each sharded result equals its unsharded "
          "counterpart on the card (TModelMul mul_t / ntt_mul_t / "
          "mul_cached_t, DenseMLE.evaluate and K5 on the whole table, "
          "fix_variables, the field's sums, the generic lsb prover, "
          "SparseMatrix.mul_vec, Matrix.mul_vec, FoldingStep.step, "
          f"FoldingTree.prove); {PAR_SPEC_ROWS} rows of each model's mul and "
          f"challenge multiply equal the integer spec, {LA_ORACLE_ROWS} rows "
          "of the sparse mat-vec and rows "
          f"{list(PAR_MV_INT_ROWS)} of the ring mat-vec equal Python-int "
          "sums, round 0's p(0) + p(1) the inner product; the sharded tree "
          "verified; the distributed prover verified "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 59. launch counts ----------------------------------------------------
    phase("parallel launches", json.dumps(launches))
    fold = {"goldilocks": "fold_end", "babybear": "bb_fold_end",
            "stark_prime": "limb_fold"}
    expect = {}
    for n in PAR_MODEL_B:
        expect[f"{n} mul"] = {fold[n]: 3 * P}
        expect[f"{n} ntt_mul"] = {}
        expect[f"{n} challenge"] = {fold[n]: 2 * P + 1}
    expect.update({"eval": {"evaluate_goldilocks": P},
                   f"fix k={PAR_FIX_K}": {}, "hypercube sum": {},
                   "inner product": {}, "sparse mat-vec": {},
                   "ring mat-vec": {}})
    for n in PAR_SC_FIELDS:
        expect[f"sumcheck {n} k=2"] = {f"sumcheck_prove_many_{n}": P}
    expect[f"sumcheck goldilocks k={PAR_K}"] = {
        "sumcheck_prove_many_goldilocks": P}
    for W, psi in steps:
        expect[f"step W={W} psi={psi}"] = {"fold_end": 2 * P}
    sharded_levels = sum(1 for i in range(Wt.bit_length() - 1)
                         if (Wt >> (i + 1)) % P == 0)
    expect["tree"] = {"fold_end": 2 * P * sharded_levels
                      + 2 * (Wt.bit_length() - 1 - sharded_levels)}
    # the example: a sharded mul and two ring.crt calls of the commit, and
    # one sharded proof
    expect["distributed prover"] = {"fold_end": 3 * P + 2,
                                    "sumcheck_prove_many_goldilocks": P}
    if per_run != expect:
        raise AssertionError(f"parallel launches {per_run}, expected "
                             f"{expect}")
    if any(twins.values()):
        raise AssertionError(f"a twin ran on the card: {twins}")
    phase("parallel launches", f"as expected: {P} K5 launches an evaluation, "
          f"{P} K7 launches a proof over each field, 3 K3 / bb_fold_end / S3 "
          "launches a shard a multiply, 2 K3 a shard a step; no twin call")

    # -- 60. timings ----------------------------------------------------------
    tms = {n: smms[n].tm for n in PAR_MODEL_B}
    pairs = {}
    for n in PAR_MODEL_B:
        tm, (a, b, na, nb, ch) = tms[n], mops[n]
        at, bt, nat, nbt, cht = (tm.to_t(x).contiguous()
                                 for x in (a, b, na, nb, ch))
        pairs[f"{n} mul B={a.shape[0]}"] = (fns[f"{n} mul"],
                                           lambda tm=tm, at=at, bt=bt:
                                           tm.mul_t(at, bt))
        pairs[f"{n} ntt_mul"] = (fns[f"{n} ntt_mul"],
                                 lambda tm=tm, x=nat, y=nbt:
                                 tm.ntt_mul_t(x, y))
        pairs[f"{n} challenge"] = (fns[f"{n} challenge"],
                                   lambda tm=tm, at=at, cht=cht:
                                   tm.mul_cached_t(at, tm.precompute_t(cht)))
    rev = {n: [bit_reverse_table(T) for T in ts] for n, ts in mle_t.items()}
    pairs.update({
        f"eval nv={nv} (K5 on the whole table)": (
            fns["eval"], lambda: FX.evaluate_goldilocks(T0, pts)),
        f"fix k={PAR_FIX_K} (DenseMLE.fix_variables)": (
            fns[f"fix k={PAR_FIX_K}"],
            lambda: dm.fix_variables(pts[:PAR_FIX_K])),
        "hypercube sum (F.sum)": (fns["hypercube sum"],
                                  lambda: F.sum(T0, 0)),
        "inner product (F.sum of F.mul)": (
            fns["inner product"], lambda: F.sum(F.mul(T0, T1), 0)),
        **{f"sumcheck {n} k=2 (K7 on the whole bit-reversed tables)": (
            fns[f"sumcheck {n} k=2"], lambda n=n: SK.sumcheck_prove_many(
                rev[n][:2], chal[n], n)) for n in PAR_SC_FIELDS},
        f"sumcheck goldilocks k={PAR_K} (K7 whole)": (
            fns[f"sumcheck goldilocks k={PAR_K}"],
            lambda: SK.sumcheck_prove_many(rev["goldilocks"], pts)),
        "sparse mat-vec (SparseMatrix.mul_vec)": (
            fns["sparse mat-vec"], lambda: A.mul_vec(z)),
        f"ring mat-vec {n_mv} x {m_mv} (Matrix.mul_vec)": (
            fns["ring mat-vec"],
            lambda: Matrix(RingElems(gl), Amv).mul_vec(vmv)),
        **{f"step W={W} psi={psi}": (
            fns[f"step W={W} psi={psi}"],
            lambda key=(W, psi): steps[key].step(c, *ins[key[0]], rt))
           for W, psi in steps},
        f"tree {Wt} leaves L={Lt}": (fns["tree"],
                                     lambda: ft.prove(tc, wt, cw, rts)),
    })
    for label, (sharded, whole) in pairs.items():
        ms_s, ms_w = in_turns(sharded, whole, PAR_REPS)
        phase("parallel time", f"{label}: sharded on {P} shards "
              f"{ms_s[0]:.4f}, {ms_s[1]:.4f} ms; unsharded {ms_w[0]:.4f}, "
              f"{ms_w[1]:.4f} ms (in turns)  ({smi})")
    generic = time_ms(lambda: sumcheck_prove_many_with_challenges(
        F, [T0, T1], pts), reps=PAR_REPS)
    phase("parallel time", f"the generic lsb prover on the whole nv = {nv} "
          f"Goldilocks tables (the oracle): {generic:.4f} ms  ({smi})")

    # -- 61. where the device time goes ---------------------------------------
    for label, fn in (("sumcheck goldilocks k=2", fns["sumcheck goldilocks "
                                                      "k=2"]),
                      (f"step W={PROTO_WS[-1]} psi=True",
                       fns[f"step W={PROTO_WS[-1]} psi=True"])):
        busy_ms, wall_ms, top = device_profile(fn, 3, dev, 5)
        phase("parallel profile", f"sharded {label} on {P} shards: device "
              f"busy {busy_ms:.4f} ms of {wall_ms:.4f} ms wall (profiled), "
              f"idle share {1 - busy_ms / wall_ms:.3f}; {torch_ops(fn)} torch "
              f"ops a call; per call: {top}  ({smi})")
    return []


def slice_entry(dev, smi, rng) -> list:
    """Phases 62-66: the entry points (``stark_rings_tpu_torch.
    entry``) on the card, with K3, ``ntt_tile``, ``pointwise_mul``, K7
    and K8 on their path, each launched as often as the same calls on
    CPU shards call its twin.  No kernel of its own: returns no
    record."""
    import torch

    from stark_rings_tpu_torch import (GOLDILOCKS as F, ShardedNTT,
                                       get_power_ring, make_mesh)
    from stark_rings_tpu_torch import entry as E
    from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
    from stark_rings_tpu_torch.ops import fold as K
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.parallel import exchange as EX
    from stark_rings_tpu_torch.rings import get_ring
    from stark_rings_tpu_torch.spec import get_model

    dp, sp = ENTRY_GRID

    # -- 62. inputs ---------------------------------------------------------
    t0 = time.perf_counter()
    step, (a, b) = E.entry(dev)
    ring = get_ring("goldilocks", dev)
    big = (ring.rand_coeff((ENTRY_BIG_B,), rng),
           ring.rand_coeff((ENTRY_BIG_B,), rng))
    rows = [make_mesh(sp, axis="sp", device=dev)] * dp

    def grid_case(N, device, src=None):
        """{exchange: (sn, rows, a grid, b grid)} at degree N, B = SH_B."""
        on = [make_mesh(sp, axis="sp", device=device)] * dp
        x, y = src if src is not None else (
            F.rand((SH_B, N), rng, device) for _ in range(2))
        out = {}
        for ex in ("xla", "pallas"):
            sn = ShardedNTT("goldilocks", N, sp, axis="sp", exchange=ex)
            out[ex] = (sn, on, *(E.shard_grid(sn, on, sn.to_matrix(v))
                                  for v in (x, y)))
        return out

    ga, gb = (F.rand((SH_B, SH_N), rng, dev) for _ in range(2))
    grids = grid_case(SH_N, dev, (ga, gb))
    fs = get_power_ring("goldilocks", SH_N.bit_length() - 1,
                        device=dev).fourstep_ctx()
    mesh8 = make_mesh(SH_P, device=dev)
    s8 = ShardedNTT("goldilocks", SH_N, SH_P, exchange="pallas")
    mul8 = s8.make_fns(mesh8, batch_ndim=1)[2]
    cspec = s8.shard_specs(1)[0]
    sa8, sb8 = (s8.shard(s8.to_matrix(x), cspec, mesh8) for x in (ga, gb))
    torch.cuda.synchronize()
    phase("entry inputs", f"entry()'s a, b [{a.shape[0]}, {ring.D}] and a "
          f"drawn batch of {ENTRY_BIG_B}; the grid dp={dp} x sp={sp} at deg "
          f"{SH_N}, B={SH_B} ({list(grids['xla'][2][0][0].shape)} a shard), "
          f"both exchanges; fourstep_ctx() and the P={SH_P} sharded mul "
          f"beside it; drawn in {time.perf_counter() - t0:.1f} s")

    # -- 63. the same calls on CPU shards, the twins counted ------------------
    twin_names = ("fold_end_ref", "ntt_tile_ref", "pointwise_mul_ref",
                  "sumcheck_prove_many_ref", "twiddle_exchange_fwd_ref",
                  "twiddle_exchange_inv_ref")
    twin_mods = ((K, "fold_end_ref"), (G, "ntt_tile_ref"),
                 (K, "pointwise_mul_ref"), (SK, "sumcheck_prove_many_ref"),
                 (EX, "twiddle_exchange_fwd_ref"),
                 (EX, "twiddle_exchange_inv_ref"))

    def runs(device, step_fn, ins, gcase):
        out = {f"step B={x.shape[0]}": functools.partial(step_fn, x, y)
               for x, y in ins}
        for n in ENTRY_DRYRUNS:
            out[f"dryrun {n}"] = functools.partial(E.dryrun_multichip, n,
                                                   device)
        for ex, (sn, on, xa, xb) in gcase.items():
            out[f"grid {ex}"] = functools.partial(E.grid_step, sn, on, xa,
                                                  xb)
        return out

    t0 = time.perf_counter()
    cpu_step = E.entry("cpu")[0]
    cpu_runs = runs("cpu", cpu_step, ((a.cpu(), b.cpu()),
                                      tuple(x.cpu() for x in big)),
                    grid_case(ENTRY_COUNT_N, "cpu"))
    expect = {}
    for name, fn in cpu_runs.items():
        calls, restore = count_twins(twin_mods)
        try:
            fn()
        finally:
            restore()
        expect[name] = {k: v for k, v in calls.items() if v}
    phase("entry expect", f"the calls on CPU shards (the grid at deg "
          f"{ENTRY_COUNT_N}) in {time.perf_counter() - t0:.1f} s; twin "
          f"calls {expect}")

    # -- 64. the path, launches counted ---------------------------------------
    def counts():
        return {"fold_end_ref": K.LAUNCHES["fold_end"],
                "ntt_tile_ref": G.LAUNCHES["ntt_tile"],
                "pointwise_mul_ref": K.LAUNCHES["pointwise_mul"],
                "sumcheck_prove_many_ref": SK.LAUNCHES[
                    "sumcheck_prove_many_goldilocks"],
                "twiddle_exchange_fwd_ref": sum(
                    v for k, v in EX.LAUNCHES.items() if "_fwd_" in k),
                "twiddle_exchange_inv_ref": sum(
                    v for k, v in EX.LAUNCHES.items() if "_inv_" in k)}

    fns = runs(dev, step, ((a, b), big), grids)
    torch.cuda.synchronize()
    for mod in (K, G, SK, EX):
        mod.reset_launches()
    twins, restore = count_twins(twin_mods)
    t0 = time.perf_counter()
    outs, per_run, secs = {}, {}, {}
    try:
        for name, fn in fns.items():
            before = counts()
            t1 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t1
            per_run[name] = {k: v - before[k] for k, v in counts().items()
                             if v != before[k]}
    finally:
        restore()
    launches = counts()
    phase("entry path", f"{len(fns)} calls in {time.perf_counter() - t0:.2f}"
          f" s ({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())}); "
          f"launches {per_run}; twin calls {twins}")
    if per_run != expect:
        raise AssertionError(f"entry launches {per_run}, expected the CPU "
                             f"twin calls {expect}")
    if any(twins.values()):
        raise AssertionError(f"a twin ran on the card: {twins}")
    for name in twin_names:
        if launches[name] <= 0:
            raise AssertionError(f"{name[:-4]} was never launched on the "
                                 "entry path")
    phase("entry launches", f"{json.dumps(launches)}: each call's launches "
          "equal its CPU twin calls; no twin call")

    # -- 65. oracles ----------------------------------------------------------
    t0 = time.perf_counter()
    for x, y in ((a, b), big):
        name = f"step B={x.shape[0]}"
        got = outs[name]
        if got.shape != x.shape or got.any():
            raise AssertionError(f"{name}: prod - recompose(decompose(prod)) "
                                 "is not zero")
    spec = get_model("goldilocks")
    n_rows = ENTRY_SPEC_ROWS
    prod = E.step_stages(ring, big[0][:n_rows], big[1][:n_rows])["prod"]
    ai, bi, pi = (ring.decode(v) for v in (big[0][:n_rows], big[1][:n_rows],
                                           prod))
    for r in range(n_rows):
        want = spec.coeff_mul([int(v) for v in ai[r]],
                              [int(v) for v in bi[r]])
        if [int(v) for v in pi[r]] != want:
            raise AssertionError(f"entry step row {r} differs from the "
                                 "integer spec")
    want = fs.mul(ga, gb)
    wsum = F.reduce_words(F.widen(want).reshape(-1, 2).sum(dim=0))
    for ex, (sn, on, _, _) in grids.items():
        gprod, ck = outs[f"grid {ex}"]
        if u64_err(sn.from_matrix(E.gather_grid(sn, gprod, dev)), want,
                   f"grid {ex}"):
            raise AssertionError(f"grid {ex}: the product differs from "
                                 "fourstep_ctx().mul")
        if u64_err(ck, wsum, f"grid {ex} checksum"):
            raise AssertionError(f"grid {ex}: the checksum differs from the "
                                 "sum of the product's entries")
    phase("entry oracle", f"the step's difference is zero at B = 32 and "
          f"{ENTRY_BIG_B}; {n_rows} rows of the B = {ENTRY_BIG_B} product "
          f"equal the integer spec; both grid products equal "
          f"fourstep_ctx().mul on the whole batch and their checksums one "
          f"reduce_words of its words; dryrun_multichip({ENTRY_DRYRUNS[0]}) "
          f"and ({ENTRY_DRYRUNS[1]}) held each section to its local twin "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 66. timings ----------------------------------------------------------
    for x, y in ((a, b), big):
        ms = time_ms(lambda: step(x, y), reps=PAR_REPS)
        phase("entry time", f"step B={x.shape[0]}: {ms:.4f} ms = "
              f"{1e3 / ms:.1f} steps/s = {x.shape[0] / ms * 1e3:.0f} "
              f"elements/s; {torch_ops(lambda: step(x, y))} torch ops a "
              f"step  ({smi})")
    grid_fns = {ex: functools.partial(E.grid_step, *g)
                for ex, g in grids.items()}
    for label, other in ((f"the P={SH_P} sharded mul (K8)",
                          lambda: mul8(sa8, sb8)),
                         ("fourstep_ctx().mul", lambda: fs.mul(ga, gb))):
        ms_g, ms_o = in_turns(grid_fns["pallas"], other, PAR_REPS)
        phase("entry time", f"grid step dp={dp} x sp={sp} (K8) deg {SH_N} "
              f"B={SH_B}: {ms_g[0]:.4f}, {ms_g[1]:.4f} ms; {label} "
              f"{ms_o[0]:.4f}, {ms_o[1]:.4f} ms (in turns)  ({smi})")
    ms_x = time_ms(grid_fns["xla"], reps=PAR_REPS)
    phase("entry time", f"grid step dp={dp} x sp={sp} (plain transpose): "
          f"{ms_x:.4f} ms  ({smi})")
    for label, fn in ((f"step B={ENTRY_BIG_B}", lambda: step(*big)),
                      (f"grid step dp={dp} x sp={sp} (K8)",
                       grid_fns["pallas"]),
                      (f"the P={SH_P} sharded mul (K8)",
                       lambda: mul8(sa8, sb8))):
        busy_ms, wall_ms, top = device_profile(fn, 3, dev, 6)
        phase("entry profile", f"{label}: device busy {busy_ms:.4f} ms of "
              f"{wall_ms:.4f} ms wall (profiled), idle share "
              f"{1 - busy_ms / wall_ms:.3f}; {torch_ops(fn)} torch ops a "
              f"call; per call: {top}  ({smi})")
    for n in ENTRY_DRYRUNS:
        t0 = time.perf_counter()
        E.dryrun_multichip(n, dev)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        ops_n = torch_ops(lambda: E.dryrun_multichip(n, dev))
        phase("entry time", f"dryrun_multichip({n}) on shards of the card: "
              f"{secs[f'dryrun {n}']:.3f} s first, {again:.3f} s again; "
              f"{ops_n} torch ops  ({smi})")
    return []


@contextlib.contextmanager
def kept_graphs(log):
    """While the block runs, every ``torch.cuda.CUDAGraph`` is made with
    ``keep_graph=True`` (its nodes stay readable by ``debug_dump``) and
    appends itself to ``log`` at each replay."""
    import torch

    real = torch.cuda.CUDAGraph

    class Kept(real):
        def __new__(cls):
            return super().__new__(cls, keep_graph=True)

        def __init__(self):
            super().__init__(keep_graph=True)

        def replay(self):
            log.append(self)
            super().replay()

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = real


def _mangled(kernel) -> str:
    """A hand kernel's stem as it is mangled: fold_tw_kernel ->
    14fold_tw_kernel, stark_binary_kernel<0> -> 19stark_binary_kernelILi0E."""
    base, _, arg = kernel.partition("<")
    return f"{len(base)}{base}" + (f"ILi{arg[:-1]}E" if arg else "")


def graph_nodes(graph, cache) -> dict:
    """{wrapper: kernel nodes} of one captured graph, read from its DOT
    dump (one line a node, the kernel's mangled name in it)."""
    import warnings

    if graph not in cache:
        with tempfile.TemporaryDirectory() as tmp, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            path = pathlib.Path(tmp) / "graph.dot"
            graph.debug_dump(str(path))
            if not path.exists():
                raise AssertionError("debug_dump wrote no DOT file: the "
                                     "graph was not kept")
            lines = [ln for ln in path.read_text().splitlines()
                     if "{ID |" in ln]
        out = {}
        for line in lines:
            for kernel, wrapper in JIT_WRAPPERS.items():
                if _mangled(kernel) in line:
                    out[wrapper] = out.get(wrapper, 0) + 1
        cache[graph] = out
    return cache[graph]


def replay_launches(fn, log, cache) -> dict:
    """{wrapper: launches} of the hand kernels that one call of ``fn``
    replays: the kernel nodes of each graph it replays."""
    log.clear()
    fn()
    out = {}
    for graph in log:
        for name, n in graph_nodes(graph, cache).items():
            out[name] = out.get(name, 0) + n
    log.clear()
    return out


def py_launches(fn, mods) -> dict:
    """{wrapper: launches} counted by ``mods``' wrappers over one call."""
    before = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    fn()
    return {k: v - before[k] for mod in mods for k, v in mod.LAUNCHES.items()
            if v != before[k]}


def staged_eager(e, granularity):
    """The eager composition of ``e.staged_mul(granularity)``'s pieces."""
    if granularity != "stage":
        return lambda x, y: e._tail_graph(e._fwd_graph(x), e._fwd_graph(y))
    c = e.c

    def fwd(x):
        y = e._lvl_tw(e.mat1, e._to_internal(x).contiguous(), c, "w1", "tw")
        return e._lvl_end(e.mat2, y.permute(2, 1, 0).contiguous(), c, "w2")

    def mul(x, y):
        z = e._lvl_tw(e.mat2i, e.pointwise(fwd(x), fwd(y)), c, "w2i", "twi")
        return e._from_internal(e._lvl_end(
            e.mat1i, z.permute(2, 1, 0).contiguous(), c, "w1i"))
    return mul


def jit_cases(e, x, y, y1) -> dict:
    """{call: (compiled, eager, args)} of engine ``e`` on [B, N]
    operands x, y and a batch-1 y1."""
    mc, square = e.jit_mul_cached(), e.jit_square()

    def cached(u, v):
        return mc(u, mc.precompute(v))

    def eager_cached(u, v):
        return e.mul_cached(u, e.precompute(v))

    cases = {"jit_mul": (e.jit_mul(), e.mul, (x, y)),
             "jit_mul_cached": (cached, eager_cached, (x, y)),
             "jit_mul_cached_batch1": (cached, eager_cached, (x, y1)),
             "jit_square": (square, e.square, (x,))}
    for g in JIT_GRANULARITIES:
        cases[g] = (e.staged_mul(g), staged_eager(e, g), (x, y))
    return cases


def slice_jit(dev, smi, rng, gl) -> list:
    """Phases 67-70: the compiled multiplies, each call one CUDA graph
    replay (``ops/graphed.py``), against the eager calls.  ``gl`` holds
    Slice A's config-1 operands and schoolbook rows.  No kernel of its
    own: returns no record."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import (BABYBEAR as FB, GOLDILOCKS as F,
                                       get_power_ring, to_numpy_u32,
                                       to_numpy_u64)
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook_q
    from stark_rings_tpu_torch.ops import fold as K, fold_bb as KB
    from stark_rings_tpu_torch.ops import stark as S

    mods = (K, KB, S)
    for mod in mods:
        mod.reset_launches()
    t0 = time.perf_counter()
    a, b, ch, orc = gl["a"], gl["b"], gl["ch"], gl["orc"]
    GB, GN = a.shape
    bb_ring = get_power_ring("babybear", BB_LOG, device=dev)
    st_ring = get_power_ring("stark_prime", ST_LOG, device=dev)
    gk = get_power_ring("goldilocks", GN.bit_length() - 1,
                        device=dev).mxu_ctx()
    ba, bb_ = (FB.rand((BB_B, bb_ring.D), rng, dev) for _ in range(2))
    sa, sb = (STARK.rand((ST_B, st_ring.D), rng, dev) for _ in range(2))
    ca, cb = (to_numpy_u32(FB.canon(x[:ORACLE_ROWS])).astype(np.uint64)
              for x in (ba, bb_))
    bb_rows = np.stack([negacyclic_mul_schoolbook_q(x, y, FB.q)
                        for x, y in zip(ca, cb)])
    # (label, engine, operands x, y, batch-1 y1, oracle of call)
    groups = [
        (f"{type(gl['eng']).__name__} B={GB}", gl["eng"], a, b, ch, "gl"),
        (f"{type(gl['eng']).__name__} B=1", gl["eng"], a[:1], b[:1], ch,
         "gl"),
        (f"{type(gk).__name__} B={GB}", gk, a, b, ch, "gl"),
        (f"{type(gk).__name__} B=1", gk, a[:1], b[:1], ch, "gl"),
        (f"{type(bb_ring.mxu_ctx()).__name__} B={BB_B}", bb_ring.mxu_ctx(),
         ba, bb_, bb_[:1], "bb"),
        (f"{type(st_ring.mxu_ctx()).__name__} B={ST_B}", st_ring.mxu_ctx(),
         sa, sb, None, "stark"),
    ]
    phase("jit inputs", f"{len(groups)} engine groups (config 1 deg {GN} "
          f"at B = {GB} and 1 on Slice A's operands, config 2 deg "
          f"{bb_ring.D} B = {BB_B}, config 3 deg {st_ring.D} B = {ST_B}) "
          f"ready in {time.perf_counter() - t0:.1f} s")

    def oracle(kind, call, x, y, got):
        """Raise unless ``got`` (the first result) passes the group's
        oracle: schoolbook rows (config 1 and 2) or NTTContext."""
        if kind == "gl":
            key = {"jit_square": "aa", "jit_mul_cached_batch1": "ac"}.get(
                call, "ab")
            n = min(ORACLE_ROWS, got.shape[0])
            if not np.array_equal(to_numpy_u64(got[:n]), orc[key][:n]):
                raise AssertionError(f"{call}: differs from the schoolbook "
                                     "oracle")
        elif kind == "bb":
            yy = x if call == "jit_square" else y.expand_as(x)
            if not torch.equal(got, bb_ring.coeff_mul(x, yy)):
                raise AssertionError(f"{call}: differs from NTTContext "
                                     "coeff_mul")
            if call == "jit_mul" and not np.array_equal(to_numpy_u32(
                    FB.canon(got[:ORACLE_ROWS])).astype(np.uint64),
                    bb_rows):
                raise AssertionError(f"{call}: differs from the schoolbook "
                                     "oracle over q")
        elif not torch.equal(got, st_ring.coeff_mul(x, y)):
            raise AssertionError(f"{call}: differs from NTTContext "
                                 "coeff_mul")

    total = {"cases": 0, "replays checked": 0}
    log = []
    with kept_graphs(log):
        for label, e, x, y, y1, kind in groups:
            t1 = time.perf_counter()
            cases = (jit_cases(e, x, y, y1) if kind != "stark" else
                     {"jit_mul": (e.jit_mul(), e.mul, (x, y))})
            # -- 67. the path: first call (the capture), oracle, fresh inputs
            mem = {}
            for call, (jit, eager, args) in cases.items():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                m0 = torch.cuda.memory_allocated()
                r0 = torch.cuda.memory_reserved()
                first = jit(*args)
                torch.cuda.synchronize()
                mem[call] = ((torch.cuda.memory_allocated() - m0
                              - nbytes(first)) / 2**20,
                             (torch.cuda.memory_reserved() - r0) / 2**20)
                kept = first.clone()
                if first.shape != args[0].shape \
                        or first.dtype != args[0].dtype \
                        or not torch.equal(first, eager(*args)):
                    raise AssertionError(f"{label} {call}: the replay differs "
                                         "from the eager call")
                oracle(kind, call, *args[:1], args[-1], first)
                fresh = tuple(v.roll(1, 1) for v in args)
                second = jit(*fresh)
                if not torch.equal(second, eager(*fresh)):
                    raise AssertionError(f"{label} {call}: a replay on fresh "
                                         "inputs differs from the eager call")
                if not torch.equal(first, kept):
                    raise AssertionError(f"{label} {call}: a later call "
                                         "overwrote the first result")
                total["cases"] += 1
            phase("jit path", f"{label}: {len(cases)} compiled calls, each "
                  f"replay bit-equal to its eager call and the {kind} oracle, "
                  f"a second call on rolled inputs right, the first result "
                  f"unchanged; graph memory (MB allocated beside the result, "
                  f"MB reserved): " + ", ".join(
                      f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in mem.items())
                  + f" ({time.perf_counter() - t1:.1f} s)")
            # -- 68. the hand kernels of one call's replays against the eager
            # call: the eager launches counted by the wrappers, the replays'
            # from the kernel nodes of the graphs the call replays
            counts, nodes = {}, {}
            for call, (jit, eager, args) in cases.items():
                want = py_launches(lambda: eager(*args), mods)
                got = replay_launches(lambda: jit(*args), log, nodes)
                if not want or got != want:
                    raise AssertionError(f"{label} {call}: a replay ran "
                                         f"{got}, the eager call {want}")
                expect = JIT_EXPECT.get((type(e).__name__, call), got)
                if got != expect:
                    raise AssertionError(f"{label} {call}: {got} hand "
                                         f"launches, expected {expect}")
                counts[call] = got
                total["replays checked"] += 1
            first_call = next(iter(counts))
            phase("jit kernels", f"{label}: each call's replays run its eager "
                  f"call's hand kernels (the replayed graphs' kernel nodes), "
                  f"e.g. {first_call} {json.dumps(counts[first_call])}; "
                  + "; ".join(f"{k} {sum(v.values())}"
                              for k, v in counts.items()) + " hand launches")
            # -- 69. timings in turns, host time a call
            for call, (jit, eager, args) in cases.items():
                (e1, e2), (g1, g2) = in_turns(lambda: eager(*args),
                                              lambda: jit(*args))
                he = host_us(lambda: eager(*args), JIT_HOST_CALLS)
                hg = host_us(lambda: jit(*args), JIT_HOST_CALLS)
                phase("jit time", f"{label} {call}: eager {e1:.4f}, "
                      f"{e2:.4f} ms (host {he:.1f} us); graph {g1:.4f}, "
                      f"{g2:.4f} ms (host {hg:.1f} us)  ({smi})")
            del cases
            log.clear()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    for name in ("fold_tw", "fold_end2_mul", "fold_end", "pointwise_mul",
                 "bb_fold_tw", "bb_fold_end2_mul", "bb_fold_end",
                 "stark_mul", "limb_fold"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the jit "
                                 "path")
    phase("jit launches", f"{json.dumps(launches)} (Python launches: the "
          f"eager calls, each graph's warm-up and capture; no replay "
          f"counts); {total}")

    # -- 70. a capture that fails raises, in a child process
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", JIT_FAILING_CAPTURE],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode or "capture refused" not in proc.stdout:
        raise AssertionError(f"the failing capture: rc {proc.returncode}, "
                             f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    phase("jit capture", f"{proc.stdout.strip()} (child process, "
          f"{time.perf_counter() - t1:.1f} s): no eager result returned")
    return []


def issue_rate(dev) -> tuple:
    """The SMs' issue rate, thread instructions a second: SMs x
    ``ISSUE_PER_SM_CLOCK`` x the top SM clock that nvidia-smi reports.
    Returns (rate, SMs, MHz)."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "-i", str(dev.index or 0)], capture_output=True,
        text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * ISSUE_PER_SM_CLOCK * mhz * 1e6, sms, mhz


def sass_loop(pattern, keep=lambda mix: True) -> dict:
    """The opcode counts of the body of the one conditional loop (a
    backward branch) of the kernel whose mangled name matches
    ``pattern`` in the built library's SASS (cuobjdump) for which
    ``keep(counts)`` holds, less the loop's own control: the branch, the
    compare that sets its predicate and the uniform-datapath counter
    (opcodes U*).  Raises unless exactly one loop qualifies."""
    body = [b for name, b in library_sass() if re.search(pattern, name)]
    if len(body) != 1:
        raise RuntimeError(f"expected one kernel matching {pattern!r} in "
                           f"the SASS, found {len(body)}")
    ins = [(int(at, 16), op.strip()) for at, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body[0])]
    found = []
    for at, op in ins:
        br = re.fullmatch(r"(?:@!?(P\d)\s+)?BRA\s+(0x[0-9a-f]+)", op)
        if not (br and int(br.group(2), 16) < at):
            continue
        start, pred, mix = int(br.group(2), 16), br.group(1), {}
        for at2, op2 in ins:
            if not start <= at2 < at:
                continue
            words = re.sub(r"^@!?U?P\w+\s+", "", op2).split()  # no guard
            code = words[0]
            if code.startswith("U") or (code.startswith("ISETP")
                                        and words[1] == f"{pred},"):
                continue
            mix[code.split(".")[0]] = mix.get(code.split(".")[0], 0) + 1
        if pred is not None and keep(mix):
            found.append(mix)
    if len(found) != 1:
        raise RuntimeError(f"{pattern}: expected one conditional loop of "
                           f"its kind in the SASS, found {found}")
    return found[0]


def modmul_peak(dev) -> tuple:
    """The card's peak rate of Goldilocks modmuls (``gl::mul``): the SMs'
    issue rate over one ``gl::mul``'s instructions, read off the built
    library's SASS.  ``pointwise_chain_kernel``'s loop runs one
    ``gl::mul`` a trip; its body, less the loop's control
    (:func:`sass_loop`), is the modmul.  Returns (modmuls/s,
    instructions per modmul, their opcode counts, SMs, MHz)."""
    mix = sass_loop(r"pointwise_chain_kernel")
    per = sum(mix.values())
    rate, sms, mhz = issue_rate(dev)
    return rate / per, per, mix, sms, mhz


def bb_slot_matvec_sass() -> tuple:
    """As :func:`slot_matvec_sass` for ``bb_slot_matvec_kernel``: 18 LDS
    an extension product (a slot of A and of x, nine words each).
    Returns (instructions a product, the loop's opcode counts)."""
    mix = sass_loop(r"bb_slot_matvec_kernel",
                    lambda m: "LDS" in m and "STS" not in m
                    and "BAR" not in m)
    if mix["LDS"] % 18:
        raise RuntimeError(f"bb_slot_matvec_kernel's loop: {mix['LDS']} LDS "
                           "is no whole number of products")
    return sum(mix.values()) / (mix["LDS"] // 18), mix


def slice_slot_bb(dev, smi, rng) -> list:
    """Phases 71-72: the BabyBear E = 9 slot kernels ``bb_slot_mul`` and
    ``bb_slot_matvec`` (``csrc/slot_bb.cu``) at the BabyBear fold's
    shapes against their twins on the card, their launches on the step
    and on a mul_t, and their times against their bounds.  Returns the
    kernels' JSON records."""
    import numpy as np
    import torch

    from stark_rings_tpu_torch import BABYBEAR, to_torch_u32
    from stark_rings_tpu_torch.ops import slot as SL, slot_bb as SB
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    q = BABYBEAR.q
    n_rows, L, base, W = BB_SLOT_STEP
    t0 = time.perf_counter()
    ring = get_ring("babybear", device=dev)
    tab = SL.ext_tables(ring)
    fs = FoldingStep(ring, n_rows, L, base)
    block = fs.commit_block(W)
    c = fs.init_tables(rng)
    ins = (fs.rand_witness(W, rng), fs.rand_witness(W, rng),
           *(fs.tm.to_t(ring.rand_ntt((W, n_rows), rng)).contiguous()
             for _ in range(2)),
           fs.precompute_challenge(ring.rand_coeff((), rng)))
    N, M = ring.N, fs.M

    def words(shape_, fill=None):
        x = (np.full(shape_, fill, dtype=np.uint32) if fill is not None
             else rng.integers(0, q, shape_, dtype=np.uint32))
        return to_torch_u32(x, dev)

    torch.cuda.synchronize()
    phase("bb slot tables", f"babybear step n={n_rows}, L={L}, base {base}: "
          f"k={fs.k}, M={M}, the torch-op commit's block at W={W} {block}; "
          f"drawn in {time.perf_counter() - t0:.1f} s")

    # -- 71. parity and launches --------------------------------------------
    max_err = {}
    t0 = time.perf_counter()
    for what, fill in (("random", None), ("0", 0), ("q - 1", q - 1)):
        for Ba, Bb in ((W * L, 1), (W * n_rows, 1),
                       (BB_SLOT_MODEL_B, BB_SLOT_MODEL_B)):
            a, b = words((N, 9, Ba), fill), words((N, 9, Bb), fill)
            check(max_err, BB_SLOT_MUL_REC, SB.bb_slot_mul(a, b, tab),
                  SB.bb_slot_mul_ref(a, b, tab), f"{shape(a, b)} {what}")
        if fill == 0:
            continue
        A, x = words((N, 9, n_rows, M), fill), words((N, 9, W, M), fill)
        check(max_err, BB_SLOT_MATVEC_REC, SB.bb_slot_matvec(A, x, tab),
              SB.bb_slot_matvec_ref(A, x, tab, block),
              f"{shape(A, x)} {what}")
    torch.cuda.synchronize()
    phase("bb slot parity", f"bb_slot_mul at [{N}, 9, {W * L}] and [{N}, 9, "
          f"{W * n_rows}] x [{N}, 9, 1] and [{N}, 9, {BB_SLOT_MODEL_B}]^2, "
          f"bb_slot_matvec at n={n_rows}, M={M}, W={W}: bit-equal to their "
          f"twins (the mat-vec's blocked at {block}) on random words, 0 and "
          f"q - 1 ({time.perf_counter() - t0:.1f} s)")

    def counts():
        return {**SB.LAUNCHES, **SL.LAUNCHES}

    tm = TModelMul(ring)
    at, bt = (ring.field.rand((ring.D, BB_SLOT_MODEL_B), rng, dev)
              for _ in range(2))
    per_run = {}
    for name, fn in (("step", lambda: fs.step(c, *ins)),
                     ("mul_t", lambda: tm.mul_t(at, bt))):
        torch.cuda.synchronize()
        SB.reset_launches()
        SL.reset_launches()
        fn()
        torch.cuda.synchronize()
        per_run[name] = counts()
    none = {"bb_slot_mul": 0, "bb_slot_matvec": 0, "slot_mul": 0,
            "slot_matvec": 0}
    expect = {"step": {**none, "bb_slot_mul": 2, "bb_slot_matvec": 1},
              "mul_t": {**none, "bb_slot_mul": 1}}
    if per_run != expect:
        raise AssertionError(f"bb slot launches {per_run}, expected "
                             f"{expect}")
    launches = {k: per_run["step"][k] for k in SB.LAUNCHES}
    phase("bb slot launches", f"{per_run}; recorded, a step's: {launches}")

    # -- 72. timings ----------------------------------------------------------
    flush = torch.empty(100 << 20, dtype=torch.uint8, device=dev)  # 2 x L2
    times = {}
    a, b = words((N, 9, W * L)), words((N, 9, 1))
    moved = nbytes(a, b, SB.bb_slot_mul(a, b, tab))
    ms = time_ms(lambda: SB.bb_slot_mul(a, b, tab), inner=10)
    plain_ms = time_ms(lambda: SB.bb_slot_mul_ref(a, b, tab))
    floor = moved / HBM_BYTES_PER_S * 1e3
    times[BB_SLOT_MUL_REC] = (ms, plain_ms, moved)
    phase("bb slot time", f"bb_slot_mul {shape(a, b)} (the challenge): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, memory floor "
          f"{floor:.4f} ms ({moved} B; {floor / ms:.0%} of it); "
          + device_only(lambda: SB.bb_slot_mul(a, b, tab), dev, floor, flush)
          + f"  ({smi})")
    A = c["Agt"].view(N, 9, n_rows, M)
    x = fs.tm.crt_t(fs.step(c, *ins)["digits"]).contiguous().view(N, 9, W, M)
    moved = nbytes(A, x, SB.bb_slot_matvec(A, x, tab))
    ms = time_ms(lambda: SB.bb_slot_matvec(A, x, tab), inner=5)
    plain_ms = time_ms(lambda: SB.bb_slot_matvec_ref(A, x, tab, block),
                       reps=2)
    products = N * n_rows * W * M
    per, mix = bb_slot_matvec_sass()
    ops_ms = products * per / issue_rate(dev)[0] * 1e3
    ops = (f"{products} extension products x {per:.2f} SASS instructions "
           f"(its inner loop, {mix}) at the issue rate {ops_ms:.4f} ms")
    times[BB_SLOT_MATVEC_REC] = (ms, plain_ms, moved, ops_ms)
    floor = max(moved / HBM_BYTES_PER_S * 1e3, ops_ms)
    phase("bb slot time", f"bb_slot_matvec {shape(A, x)} (the commit): "
          f"kernel {ms:.4f} ms, plain (blocked at {block}) {plain_ms:.4f} "
          f"ms; {moved} B, {81 * products} products of 32-bit words; "
          f"{ops}; bound {floor:.4f} ms ({floor / ms:.0%} of it); "
          + device_only(lambda: SB.bb_slot_matvec(A, x, tab), dev, floor,
                        flush) + f"  ({smi})")
    ms = time_ms(lambda: fs.step(c, *ins))
    busy_ms, wall_ms, top = device_profile(lambda: fs.step(c, *ins), 3, dev,
                                           6)
    phase("bb slot time", f"babybear step W={W}, L={L}: {ms:.4f} ms = "
          f"{W * 1e3 / ms:.1f} witnesses/s; device busy {busy_ms:.4f} ms of "
          f"{wall_ms:.4f} ms wall (profiled); per step: {top}  ({smi})")
    return [record(name, BB_SLOT_SOURCE, BB_SLOT_XLA[name],
                   launches[name.split("[")[0]], max_err[name], *times[name])
            for name in (BB_SLOT_MUL_REC, BB_SLOT_MATVEC_REC)]


def slot_matvec_sass() -> tuple:
    """The SASS instructions ``slot_matvec_kernel`` issues a thread for
    one extension product: its inner loop (the one that reads shared
    memory, LDS, and writes none and waits at no barrier) over the
    products a trip, 6 LDS each (a slot of A and of x).  Returns
    (instructions a product, the loop's opcode counts)."""
    mix = sass_loop(r"(?<![A-Za-z_])slot_matvec_kernel",  # not bb_slot_...
                    lambda m: "LDS" in m and "STS" not in m
                    and "BAR" not in m)
    if mix["LDS"] % 6:
        raise RuntimeError(f"slot_matvec_kernel's loop: {mix['LDS']} LDS "
                           "is no whole number of products")
    return sum(mix.values()) / (mix["LDS"] // 6), mix


def mxu_sass() -> tuple:
    """The tensor-core integer MMA instructions in ``mxu_mod_mat_kernel``'s
    SASS (``IMMA`` for mma.sync, ``IGMMA`` for wgmma; cuobjdump on the
    built library): (their count, their opcodes, the kernel's registers,
    stack and static shared memory as text).  Raises if there is none."""
    from stark_rings_tpu_torch.ops import _build

    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    lib = str(_build.library_path())
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    fn = re.search(r"Function : \S*mxu_mod_mat_kernel\S*(.*?)"
                   r"(?=Function :|\Z)", sass, re.S)
    if fn is None:
        raise RuntimeError("no mxu_mod_mat_kernel in the library's SASS")
    ops = re.findall(r"\b(I(?:G)?MMA[.\w]*)", fn.group(1))
    if not ops:
        raise AssertionError("mxu_mod_mat_kernel holds no tensor-core "
                             "integer MMA instruction (IMMA / IGMMA)")
    res = subprocess.run([str(tool), "-res-usage", lib], capture_output=True,
                         text=True, check=True).stdout
    use = re.search(r"Function \S*mxu_mod_mat_kernel\S*:\s*REG:(\d+)\s+"
                    r"STACK:(\d+)\s+SHARED:(\d+)", res)
    usage = (f"{use.group(1)} registers a thread, {use.group(2)} B stack, "
             f"{use.group(3)} B static shared memory" if use else
             "registers not found")
    return len(ops), ", ".join(sorted(set(ops))), usage


def k7_registers() -> dict:
    """{(field ops, K or "wide"): (registers, stack bytes)} of K7's
    kernels (the persistent kernel's K = 1..8 and the run-time-k wide
    kernel), from ``cuobjdump -res-usage`` on the built library; ptxas
    places spilled registers on the stack."""
    from stark_rings_tpu_torch.ops import _build

    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-res-usage",
                          str(_build.library_path())],
                         capture_output=True, text=True, check=True).stdout
    regs = {}
    for fn, reg, stack in re.findall(
            r"Function (\S*sumcheck_(?:prove|wide)_kernel\w*):\s*"
            r"REG:(\d+)\s+STACK:(\d+)", out):
        ops = re.search(r"(Gl|Bb|Frog)Ops", fn).group(0)
        k = re.search(r"Li(\d+)E", fn)
        key = (ops, f"{int(k.group(1)):02d}" if k else "wide")
        regs[key] = (int(reg), int(stack))
    if len(regs) != 27:
        raise RuntimeError(f"expected K7's 27 kernels (3 fields x K = 1..8 "
                           f"and wide) in the SASS, found {len(regs)}")
    return regs


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def main() -> None:
    started = time.perf_counter()
    if not all((HERE / s).is_file() for s in (SOURCE, MLE_SOURCE, BB_SOURCE,
                                               NTT_SOURCE, MXU_SOURCE,
                                               EXCHANGE_SOURCE, ST_SOURCE,
                                               SLOT_SOURCE)):
        raise SystemExit(f"chip_smoke.py: {HERE} holds no "
                         "stark_rings_tpu_torch package; run it from the "
                         "root of a checkout")
    sys.path.insert(0, str(HERE))

    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this script measures the card only)")
    cap = torch.cuda.get_device_capability(0)
    if cap[0] != 9:
        raise RuntimeError(f"need a Hopper card (compute capability 9.x), "
                           f"got {cap}")
    dev = torch.device("cuda", 0)
    smi = card_info()
    print(smi)
    phase("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")

    from stark_rings_tpu_torch import (GOLDILOCKS as F, Mxu2FusedNTT,
                                       Mxu2NTT, to_numpy_u64, to_torch)
    from stark_rings_tpu_torch.fields.field import u64_lt
    from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook
    from stark_rings_tpu_torch.ops import _build, fold as K

    # -- 2. build ----------------------------------------------------------
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

    rng = np.random.default_rng(SEED)
    q = F.q
    a_np = rng.integers(0, q, (B, N), dtype=np.uint64)
    b_np = rng.integers(0, q, (B, N), dtype=np.uint64)
    ch_np = rng.integers(0, q, (1, N), dtype=np.uint64)
    v_np = rng.integers(0, q, (B, N), dtype=np.uint64)

    # the independent oracle runs on host threads while the card works
    pool = ThreadPoolExecutor(max_workers=3 * ORACLE_ROWS)
    oracle = {
        name: [pool.submit(negacyclic_mul_schoolbook, x[i], y[i])
               for i in range(ORACLE_ROWS)]
        for name, x, y in (("ab", a_np, b_np), ("aa", a_np, a_np),
                           ("ac", a_np, np.repeat(ch_np, ORACLE_ROWS, 0)))}

    t0 = time.perf_counter()
    eng = Mxu2FusedNTT(N, device=dev)
    eng_stacked = Mxu2FusedNTT(N, stack_forward=True, device=dev)
    plain = Mxu2NTT(N, device=dev)
    eng_signed = Mxu2FusedNTT(N, unsigned=False, device=dev)
    phase("tables", f"4 engines (N={N}) built in "
          f"{time.perf_counter() - t0:.1f} s")
    a, b, ch, v = (to_torch(x, dev) for x in (a_np, b_np, ch_np, v_np))

    # -- 3. kernel parity at the main path's shapes ------------------------
    max_err = {name: 0 for name in KERNELS}

    t0 = time.perf_counter()
    V1, V2i, V1i, Va, Vb, Vc = kernel_parity(eng, B, f"unsigned B={B}", K,
                                             "", rng, max_err)
    kernel_parity(eng_signed, B_SIGNED, f"signed B={B_SIGNED}", K, "", rng,
                  max_err)
    k1_ragged_parity((eng, eng_signed), dev, rng, max_err)
    phase("parity", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 4. engine parity at N = 2^16, B = 80 ------------------------------
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "mul": lambda: eng.mul(a, b),
        "stack_forward": lambda: eng_stacked.mul(a, b),
        "square": lambda: eng.square(a),
        "mul_cached": lambda: eng.mul_cached(a, eng.precompute(b)),
        "mul_cached_batch1": lambda: eng.mul_cached(a, eng.precompute(ch)),
        "combine": lambda: F.add(eng.mul_cached(a, eng.precompute(ch)), v),
    }
    results, per_variant = {}, {}
    for name, fn in runs.items():
        before = dict(K.LAUNCHES)
        results[name] = fn()
        per_variant[name] = {k: K.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    phase("engine", f"6 variants at N={N}, B={B} in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_variant}")

    pc = plain.precompute(ch)
    want = {
        "mul": plain.mul(a, b),
        "square": plain.square(a),
        "mul_cached": plain.mul_cached(a, plain.precompute(b)),
        "mul_cached_batch1": plain.mul_cached(a, pc),
        "combine": F.add(plain.mul_cached(a, pc), v),
    }
    want["stack_forward"] = want["mul"]
    qmax = F.encode([q - 1], dev)
    for name, got in results.items():
        if got.shape != (B, N) or got.dtype != torch.int64:
            raise AssertionError(f"{name}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        if u64_lt(qmax, got).any():
            raise AssertionError(f"{name}: non-canonical output")
        if not torch.equal(got, want[name]):
            raise AssertionError(f"{name}: kernel path differs from the "
                                 "plain path on the card")
    if not torch.equal(want["mul"], plain.mul_cached(a, plain.precompute(
            b))):
        raise AssertionError("plain mul and plain mul_cached differ")
    phase("engine", "kernel path bit-equal to the plain Mxu2NTT path for "
          "all 6 variants, whole batch")

    t0 = time.perf_counter()
    orc = {k: np.stack([f.result() for f in fs]) for k, fs in oracle.items()}
    pool.shutdown()
    comb = np.array([[(int(x) + int(y)) % q for x, y in zip(r, s)]
                     for r, s in zip(orc["ac"], v_np[:ORACLE_ROWS])],
                    dtype=np.uint64)
    expect = {"mul": orc["ab"], "stack_forward": orc["ab"],
              "mul_cached": orc["ab"], "square": orc["aa"],
              "mul_cached_batch1": orc["ac"], "combine": comb}
    for name, rows in expect.items():
        got = to_numpy_u64(results[name][:ORACLE_ROWS])
        if not np.array_equal(got, rows):
            raise AssertionError(f"{name}: differs from the schoolbook "
                                 "oracle")
    phase("oracle", f"{ORACLE_ROWS} rows of every variant equal the native "
          f"schoolbook product (waited {time.perf_counter() - t0:.1f} s)")

    # -- 5. launch counts --------------------------------------------------
    phase("launches", json.dumps(launches))
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")

    # -- 6. timings ---------------------------------------------------------
    Vs = torch.cat([Va, Vb], 1)
    R = eng.mat2.R

    timed = [  # (record, kernel, shapes, args, kwargs)
        ("fold_tw", "fold_tw", shape(V1) + " transposed",
         (V1, eng.c["tw"], R), {"transpose_out": True, "signed": False}),
        ("fold_end2_mul", "fold_end2_mul", shape(Va, Vb), (Va, Vb, R),
         {"signed": False}),
        ("fold_end", "fold_end", shape(V1i), (V1i, R), {"signed": False}),
        ("fold_end2_mul", "fold_end2_mul", "stacked " + shape(Vs),
         (Vs, None, R), {"signed": False}),
        ("fold_end2_mul", "fold_end2_mul", "batch-1 " + shape(Va, Vc),
         (Va, Vc, R), {"signed": False}),
    ]
    times = time_kernels(K, timed, smi)
    gemm = digit_gemms(eng, B, rng)
    xc = F.rand((eng.mat1i.C, B * N // eng.mat1i.C), rng, dev)
    s8 = eng.mat1i._planes(xc, 0x80).view(torch.int8)
    mm_ms = time_ms(lambda: torch._int_mm(eng.c["w1i"], s8))
    six = gemm.pop("six")
    phase("time", f"digit GEMM {shape(eng.c['w1i'], s8)} with digit planes "
          f"and offset terms: " + ", ".join(f"{k} {v:.4f} ms"
                                             for k, v in gemm.items())
          + f"; the six of one mul {six:.4f} ms (_int_mm alone "
          f"{mm_ms:.4f} ms)  ({smi})")
    mul_ms = time_ms(lambda: eng.mul(a, b))
    plain_mul_ms = time_ms(lambda: plain.mul(a, b))
    phase("time", f"mul N={N} B={B}: kernel path {mul_ms:.3f} ms = "
          f"{B / mul_ms * 1e3:.1f} mults/s; plain path {plain_mul_ms:.3f} "
          f"ms = {B / plain_mul_ms * 1e3:.1f} mults/s  ({smi})")

    # -- 7. where the device time of one mul goes ---------------------------
    busy_ms, wall_ms, top = device_profile(lambda: eng.mul(a, b), 3, dev, 8)
    phase("profile", f"mul N={N} B={B}: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (profiled), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per mul: {top}  ({smi})")

    records = [record(name, SOURCE, KERNELS[name], launches[name],
                      max_err[name], *times[name]) for name in KERNELS]
    gl = {"eng": eng, "a": a, "b": b, "ch": ch, "results": results,
          "orc": orc}
    linalg = {}
    seconds = {"slice A": time.perf_counter() - started}
    for name, run in (("slice_e", lambda: slice_e(dev, smi, rng)),
                      ("slice_b", lambda: slice_b(dev, smi, rng, gl)),
                      ("slice_c", lambda: slice_c(dev, smi, rng)),
                      ("slice_ntt", lambda: slice_ntt(dev, smi, rng, gl)),
                      ("slice_sharded", lambda: slice_sharded(dev, smi,
                                                              rng)),
                      ("slice_models", lambda: slice_models(dev, smi, rng)),
                      ("slice_protocol", lambda: slice_protocol(dev, smi,
                                                                rng)),
                      ("slice_stark", lambda: slice_stark(dev, smi, rng)),
                      ("slice_linalg", lambda: slice_linalg(dev, smi, rng,
                                                            linalg)),
                      ("slice_parallel", lambda: slice_parallel(
                          dev, smi, rng, linalg)),
                      ("slice_entry", lambda: slice_entry(dev, smi, rng)),
                      ("slice_jit", lambda: slice_jit(dev, smi, rng, gl)),
                      ("slice_slot_bb", lambda: slice_slot_bb(dev, smi,
                                                              rng))):
        t0 = time.perf_counter()
        records += run()
        seconds[name] = time.perf_counter() - t0
    phase("seconds", ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    phase("done", f"every phase passed in {time.perf_counter() - started:.1f} "
          "s, build included")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
