"""The port's CUDA kernels on the card, against their plain twins: the
fold kernels K1-K3 (the transposed K1 at ragged tiles and at the main
path's shape), the BabyBear folds K4 and the Goldilocks pointwise
kernel, and the engines built on them against the kernel-free engines;
the MLE kernels K5 and K6 (one launch a call, on one stream and on two,
points in every form, unaligned tables), and the sumcheck prover K7
over Goldilocks, BabyBear and frog, for one claim and for a batch; the
radix NTT kernels (the tile kernel in every mode at every log_tile, and
the engine against NTTContext from N = 2 to 2^16), the fused mod-mat
kernel and the chain kernel, and the engines on them; the ring models'
CRT folds (K3 at R = 24, K4's bb_fold_end at R = 72) and TModelMul on
the card against the CPU twin path; the stark prime's kernels S1-S3
against their twins, and MxuLimbNTT, the D = 16 model, the limbed
folding step and tree and the generic sumcheck over it on the card
against the radix engine and the CPU path; the sharded layer on 8
shards of the card (K7 and K5 once a shard, the model folds' launch
counts) against the unsharded functions; the compiled multiplies (CUDA
graph replays) against the eager calls.  Marked ``cuda``:
they skip where no CUDA card is present.  This file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_cuda.py
"""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stark_rings_tpu_torch import (BABYBEAR, GOLDILOCKS, Mxu2FusedNTT,
                                   Mxu2KernelNTT, Mxu2NTT, MxuBBFusedNTT,
                                   MxuBBNTT, NTTContext, from_jax_storage,
                                   get_field, get_power_ring, to_torch,
                                   to_torch_u32)
from stark_rings_tpu_torch.examples import sumcheck as example
from stark_rings_tpu_torch.fields import STARK
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.mle import fix as FX
from stark_rings_tpu_torch.mle import mxu_eval as MX
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook_q
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops import fold_bb as KB
from stark_rings_tpu_torch.ops import slot as SL
from stark_rings_tpu_torch.ops import slot_bb as SB
from stark_rings_tpu_torch.rings import Transcript

pytestmark = pytest.mark.cuda

Q = GOLDILOCKS.q


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _buckets(rng, rows, cols, signed):
    bound = (1 << 26) - 1 if signed else (1 << 27) - 1
    V = rng.integers(-bound if signed else 0, bound + 1, (rows, cols))
    V[:, :8] = bound
    V[:, 8:16] = -bound if signed else 0
    V[:, 16:24] = rng.integers(-2**31, 2**31, (rows, 8))
    return torch.from_numpy(V.astype(np.int32))


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t,B", [(32, 32, 3), (64, 128, 2), (128, 64, 2)])
def test_kernels_match_twins(dev, R, t, B, signed):
    rng = np.random.default_rng(R + t + signed)
    K_ = 9 if signed else 8
    V = _buckets(rng, K_ * R, B * t, signed).to(dev)
    Vb = _buckets(rng, K_ * R, B * t, signed).to(dev)
    tw = to_torch(rng.integers(0, Q, (R, t), dtype=np.uint64), dev)
    cases = [
        (K.fold_tw, K.fold_tw_ref, (V, tw, R), {"transpose_out": True}),
        (K.fold_tw, K.fold_tw_ref, (V, tw, R), {"transpose_out": False}),
        (K.fold_end, K.fold_end_ref, (V, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref, (V, Vb, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref,
         (torch.cat([V, Vb], 1), None, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref,
         (V, Vb[:, :t].contiguous(), R), {}),
    ]
    for kernel, twin, args, kw in cases:
        before = dict(K.LAUNCHES)
        got = kernel(*args, signed=signed, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES[kernel.__name__] == before[kernel.__name__] + 1
        assert torch.equal(got, twin(*args, signed=signed, **kw)), \
            (kernel.__name__, kw)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t,B", [(1, 1, 40), (8, 8, 5), (37, 100, 3),
                                   (65, 130, 2), (3, 200, 2), (32, 64, 4),
                                   (128, 128, 2), (256, 256, 1)])
def test_fold_tw_tiled_matches_twin(dev, R, t, B, signed):
    """The transposed K1 goes through 32 x 32 tiles of u64 words in
    shared memory: R and t below, above and between multiples of the
    tile, whole tiles and B = 1, against the twin (untransposed too)."""
    rng = np.random.default_rng(R * t + B + signed)
    V = _buckets(rng, (9 if signed else 8) * R, B * t, signed).to(dev)
    tw = to_torch(rng.integers(0, Q, (R, t), dtype=np.uint64), dev)
    tw[0, 0] = to_torch(np.array([Q - 1], dtype=np.uint64), dev)[0]
    for transpose_out in (True, False):
        before = K.LAUNCHES["fold_tw"]
        got = K.fold_tw(V, tw, R, transpose_out=transpose_out, signed=signed)
        torch.cuda.synchronize()
        assert K.LAUNCHES["fold_tw"] == before + 1
        want = K.fold_tw_ref(V, tw, R, transpose_out=transpose_out,
                             signed=signed)
        assert torch.equal(got, want), transpose_out


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
def test_fold_tw_tiled_at_the_main_shape(dev, signed):
    """K1 transposed at the deg-2^16 multiply's shape: R = t = 256 and
    B = 80 (unsigned) or 8 (signed), on buckets of the real level-1 GEMM
    and on full-range int32 buckets."""
    N = 1 << 16
    rng = np.random.default_rng(16 + signed)
    e = Mxu2FusedNTT(N, unsigned=not signed, device=dev)
    B = 8 if signed else 80
    x = to_torch(rng.integers(0, Q, (B, N), dtype=np.uint64), dev)
    V = e._dot(e.mat1, e._to_internal(x), e.c, "w1")
    R = e.mat1.R
    gen = torch.Generator(device=dev).manual_seed(1)
    full = torch.randint(-2**31, 2**31, V.shape, generator=gen,
                         dtype=torch.int32, device=dev)
    for buckets in (V, full):
        got = K.fold_tw(buckets, e.c["tw"], R, transpose_out=True,
                        signed=signed)
        want = K.fold_tw_ref(buckets, e.c["tw"], R, transpose_out=True,
                             signed=signed)
        torch.cuda.synchronize()
        assert got.shape == (256, B * R)
        assert torch.equal(got, want)


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_fused_engine_matches_plain_on_card(dev, unsigned):
    N = 1 << 10
    rng = np.random.default_rng(3)
    a = to_torch(rng.integers(0, Q, (4, N), dtype=np.uint64), dev)
    b = to_torch(rng.integers(0, Q, (4, N), dtype=np.uint64), dev)
    fused = Mxu2FusedNTT(N, unsigned=unsigned, device=dev)
    plain = Mxu2NTT(N, unsigned=unsigned, device=dev)
    K.reset_launches()
    got = fused.mul(a, b)
    assert K.LAUNCHES == {"fold_tw": 3, "fold_end2_mul": 1, "fold_end": 1,
                          "pointwise_mul": 0, "pointwise_chain": 0}
    assert torch.equal(got, plain.mul(a, b))
    state = fused.precompute(b[:1])
    assert torch.equal(fused.mul_cached(a, state),
                       plain.mul_cached(a, plain.precompute(b[:1])))
    # row 0 of the product and of the square against the C++ schoolbook
    an, bn = (x[0].cpu().numpy().view(np.uint64) for x in (a, b))
    for prod, x, y in ((got, an, bn), (fused.square(a), an, an)):
        assert np.array_equal(prod[0].cpu().numpy().view(np.uint64),
                              negacyclic_mul_schoolbook_q(x, y, Q))


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t,B", [(32, 32, 3), (32, 64, 2), (64, 64, 5)])
def test_bb_kernels_match_twins(dev, R, t, B, signed):
    """K4 against its twins: bound, zero and full-range int32 buckets."""
    rng = np.random.default_rng(R + t + B + signed)
    K_ = 5 if signed else 4
    V = _buckets(rng, K_ * R, B * t, signed).to(dev)
    Vb = _buckets(rng, K_ * R, B * t, signed).to(dev)
    tw = to_torch_u32(rng.integers(0, BABYBEAR.q, (R, t), dtype=np.uint32),
                      dev)
    cases = [
        (KB.bb_fold_tw, KB.bb_fold_tw_ref, (V, tw, R),
         {"transpose_out": True}),
        (KB.bb_fold_tw, KB.bb_fold_tw_ref, (V, tw, R),
         {"transpose_out": False}),
        (KB.bb_fold_end, KB.bb_fold_end_ref, (V, R), {}),
        (KB.bb_fold_end2_mul, KB.bb_fold_end2_mul_ref, (V, Vb, R), {}),
        (KB.bb_fold_end2_mul, KB.bb_fold_end2_mul_ref,
         (torch.cat([V, Vb], 1), None, R), {}),
        (KB.bb_fold_end2_mul, KB.bb_fold_end2_mul_ref,
         (V, Vb[:, :t].contiguous(), R), {}),
    ]
    for kernel, twin, args, kw in cases:
        before = dict(KB.LAUNCHES)
        got = kernel(*args, signed=signed, **kw)
        torch.cuda.synchronize()
        assert KB.LAUNCHES[kernel.__name__] == before[kernel.__name__] + 1
        assert torch.equal(got, twin(*args, signed=signed, **kw)), \
            (kernel.__name__, kw)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t,B", [(1, 1, 40), (8, 8, 5), (100, 72, 3),
                                   (65, 130, 2), (3, 200, 2), (128, 128, 2),
                                   (64, 64, 4)])
def test_bb_fold_tw_tiled_matches_twin(dev, R, t, B, signed):
    """The transposed bb_fold_tw goes through 32 x 64 tiles in shared
    memory: R and t below, above and between multiples of the tile, and
    whole tiles, against the twin (untransposed too)."""
    rng = np.random.default_rng(R * t + B + signed)
    V = _buckets(rng, (5 if signed else 4) * R, B * t, signed).to(dev)
    tw = to_torch_u32(rng.integers(0, BABYBEAR.q, (R, t), dtype=np.uint32),
                      dev)
    for transpose_out in (True, False):
        before = KB.LAUNCHES["bb_fold_tw"]
        got = KB.bb_fold_tw(V, tw, R, transpose_out=transpose_out,
                            signed=signed)
        torch.cuda.synchronize()
        assert KB.LAUNCHES["bb_fold_tw"] == before + 1
        want = KB.bb_fold_tw_ref(V, tw, R, transpose_out=transpose_out,
                                 signed=signed)
        assert torch.equal(got, want), transpose_out


@pytest.mark.parametrize("n", [1, 255, 256, 3 * 1024 + 7])
def test_pointwise_kernel_matches_twin(dev, n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, Q, n, dtype=np.uint64)
    b = rng.integers(0, Q, n, dtype=np.uint64)
    a[0] = b[0] = Q - 1
    b[-1] = 0
    a, b = to_torch(a, dev), to_torch(b, dev)
    before = K.LAUNCHES["pointwise_mul"]
    got = K.pointwise_mul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pointwise_mul"] == before + 1
    assert torch.equal(got, K.pointwise_mul_ref(a, b))


@pytest.mark.parametrize("N", [1 << 10, 1 << 11])
@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_bb_fused_engine_matches_plain_on_card(dev, unsigned, N):
    rng = np.random.default_rng(N + unsigned)
    a = to_torch_u32(rng.integers(0, BABYBEAR.q, (4, N), dtype=np.uint32),
                     dev)
    b = to_torch_u32(rng.integers(0, BABYBEAR.q, (4, N), dtype=np.uint32),
                     dev)
    fused = MxuBBFusedNTT(N, unsigned=unsigned, device=dev)
    stacked = MxuBBFusedNTT(N, unsigned=unsigned, stack_forward=True,
                            device=dev)
    plain = MxuBBNTT(N, unsigned=unsigned, device=dev)
    KB.reset_launches()
    got = fused.mul(a, b)
    assert KB.LAUNCHES == {"bb_fold_tw": 3, "bb_fold_end2_mul": 1,
                           "bb_fold_end": 1}
    want = plain.mul(a, b)
    assert torch.equal(got, want)
    assert torch.equal(stacked.mul(a, b), want)
    assert torch.equal(fused.square(a), plain.square(a))
    assert torch.equal(fused.mul_cached(a, fused.precompute(b)), want)
    assert torch.equal(fused.mul_cached(a, fused.precompute(b[:1])),
                       plain.mul_cached(a, plain.precompute(b[:1])))


def test_kernel_engine_matches_plain_on_card(dev):
    """Mxu2KernelNTT: K1 untransposed and K3 at every level, the slot
    products in the pointwise kernel."""
    N = 1 << 11
    rng = np.random.default_rng(11)
    a = to_torch(rng.integers(0, Q, (3, N), dtype=np.uint64), dev)
    b = to_torch(rng.integers(0, Q, (3, N), dtype=np.uint64), dev)
    eng = Mxu2KernelNTT(N, device=dev)
    plain = Mxu2NTT(N, device=dev)
    K.reset_launches()
    got = eng.mul(a, b)
    assert K.LAUNCHES == {"fold_tw": 3, "fold_end2_mul": 0, "fold_end": 3,
                          "pointwise_mul": 1, "pointwise_chain": 0}
    assert torch.equal(got, plain.mul(a, b))
    assert torch.equal(eng.square(a), plain.square(a))
    assert torch.equal(eng.mul_cached(a, eng.precompute(b[:1])),
                       plain.mul_cached(a, plain.precompute(b[:1])))


@pytest.mark.parametrize("field,logN", [("babybear", 10),
                                        ("goldilocks", 10)])
def test_power_ring_on_card(dev, field, logN):
    """get_power_ring's mxu_ctx() on the card against coeff_mul (the
    radix NTTContext) and the C++ schoolbook on one row."""
    ring = get_power_ring(field, logN, device=dev)
    rng = np.random.default_rng(logN)
    a, b = ring.rand_coeff((3,), rng), ring.rand_coeff((3,), rng)
    got = ring.mxu_ctx().mul(a, b)
    assert torch.equal(got, ring.coeff_mul(a, b))
    assert torch.equal(got, ring.mxu_ctx(pallas=False).mul(a, b))
    ca, cb = (np.array(ring.decode(x[0]), dtype=np.uint64) for x in (a, b))
    want = negacyclic_mul_schoolbook_q(ca, cb, ring.q)
    assert np.array_equal(np.array(ring.decode(got[0]), dtype=np.uint64),
                          want)
    one = ring.ntt_mul(ring.crt(a), ring.ntt_inv(ring.crt(a)))
    assert all(int(v) == 1 for v in ring.decode(one).reshape(-1))


def test_wrappers_reject_mixed_devices(dev):
    V = torch.zeros((8 * 32, 64), dtype=torch.int32, device=dev)
    tw = torch.zeros((32, 32), dtype=torch.int64)
    with pytest.raises(ValueError, match="several devices"):
        K.fold_tw(V, tw, 32, signed=False)
    with pytest.raises(ValueError, match="several devices"):
        K.fold_end2_mul(V, V.cpu(), 32, signed=False)
    T = torch.zeros(1 << 12, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        SK.sumcheck_prove_many([T, T.cpu()], [1] * 12)


def test_kernels_raise_without_variables(dev):
    """A one-entry table has no variable to bind: on the card K5 raises
    rather than answer without a launch, and K7's wrapper returns the
    empty proof with no launch."""
    T = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="nv >= 1"):
        FX.evaluate_goldilocks(T, [])
    name = "sumcheck_prove_many_goldilocks"
    before = SK.LAUNCHES[name]
    msgs, finals = SK.sumcheck_prove_many(
        [T, T], torch.empty(0, dtype=torch.int64, device=dev))
    assert SK.LAUNCHES[name] == before
    assert msgs.shape == (0, 3) and msgs.device == T.device
    assert [x.item() for x in finals] == [0, 0]


def _tables(rng, nv, kind):
    n = 1 << nv
    if kind == "zeros":
        return np.zeros(n, dtype=np.uint64)
    if kind == "q-1":
        return np.full(n, Q - 1, dtype=np.uint64)
    return rng.integers(0, Q, n, dtype=np.uint64)


def _py_evaluate(values, points, q):
    """Multilinear evaluation in Python ints, variable 0 (the low bit)
    first."""
    vals = list(values)
    for r in points:
        vals = [(a + r * (b - a)) % q for a, b in zip(vals[0::2], vals[1::2])]
    return vals[0]


def _py_lagrange(ys, x, q):
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


def _py_check_proof(f, tables, chal, msgs, finals):
    """The sumcheck relations in Python ints over canonical values: round
    0's p(0) + p(1) is the sum of the tables' products, each later
    round's p(0) + p(1) the previous p(r), the last p(r) the product of
    the finals."""
    q = f.q
    prod = None
    for T in tables:
        c = np.asarray(f.decode(T), dtype=object)
        prod = c if prod is None else prod * c % q
    claim = int(np.sum(prod)) % q
    for i, (ys, r) in enumerate(zip(f.decode(msgs).tolist(),
                                    f.decode(chal).tolist())):
        assert (ys[0] + ys[1]) % q == claim, i
        claim = _py_lagrange(ys, r, q)
    last = 1
    for v in finals:
        last = last * int(f.decode(v)) % q
    assert claim == last


def _py_negacyclic(a, b, q):
    """The negacyclic product of two coefficient lists in Python ints, by
    one big-integer product (Kronecker substitution)."""
    n = len(a)
    nb = (2 * q.bit_length() + n.bit_length() + 8) // 8

    def pack(v):
        return int.from_bytes(b"".join(int(x).to_bytes(nb, "little")
                                       for x in v), "little")

    c = (pack(a) * pack(b)).to_bytes(2 * n * nb, "little")
    full = [int.from_bytes(c[k * nb:(k + 1) * nb], "little")
            for k in range(2 * n)]
    return [(full[k] - full[k + n]) % q for k in range(n)]


@pytest.mark.parametrize("kind", ["random", "zeros", "q-1"])
@pytest.mark.parametrize("nv", [4, 9, 11, 13])
def test_mle_kernels_match_twins(dev, nv, kind):
    """K5 and K6 against their twins, with distinct random points."""
    rng = np.random.default_rng(nv)
    ev = to_torch(_tables(rng, nv, kind), dev)
    pts = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    before = FX.LAUNCHES["evaluate_goldilocks"]
    got = FX.evaluate_goldilocks(ev, pts)
    torch.cuda.synchronize()
    assert FX.LAUNCHES["evaluate_goldilocks"] == before + 1
    assert torch.equal(got, FX.evaluate_goldilocks_ref(ev, pts))
    for k in [k for k in (1, 2, 5, 6) if k <= nv - 7]:
        got = FX.fix_last_goldilocks(ev, pts[:k])
        torch.cuda.synchronize()
        assert torch.equal(got, FX.fix_last_goldilocks_ref(ev, pts[:k])), k


@pytest.mark.parametrize("kind", ["random", "zeros", "q-1"])
@pytest.mark.parametrize("nv", [1, 4, 9, 10, 11, 12, 20, 21, 24])
def test_evaluate_is_one_launch(dev, nv, kind):
    """K5 in one launch at every nv: one tile and below (nv <= 11), one
    ticket level (12, 20, 21) and two (24)."""
    rng = np.random.default_rng(1000 + nv)
    ev = to_torch(_tables(rng, nv, kind), dev)
    pts = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    before = FX.LAUNCHES["evaluate_goldilocks"]
    got = FX.evaluate_goldilocks(ev, pts)
    torch.cuda.synchronize()
    assert FX.LAUNCHES["evaluate_goldilocks"] == before + 1
    assert torch.equal(got, FX.evaluate_goldilocks_ref(ev, pts))


@pytest.mark.parametrize("nv", [11, 20])
def test_evaluate_matches_python_ints(dev, nv):
    """K5 on a random table equals its multilinear evaluation in Python
    ints (an oracle independent of the twin)."""
    rng = np.random.default_rng(3000 + nv)
    T, pts = _tables(rng, nv, "random"), rng.integers(0, Q, nv,
                                                      dtype=np.uint64)
    got = FX.evaluate_goldilocks(to_torch(T, dev), to_torch(pts, dev))
    assert int(got.cpu().numpy().view(np.uint64)) == _py_evaluate(
        T.tolist(), pts.tolist(), Q)


@pytest.mark.parametrize("kind", ["random", "zeros", "q-1"])
@pytest.mark.parametrize("nv,k", [(20, 1), (20, 5), (20, 6), (20, 7),
                                  (20, 13), (9, 2), (12, 5), (13, 6),
                                  (16, 9), (24, 17)])
def test_fix_last_is_one_launch(dev, nv, k, kind):
    """K6 in one launch for every k: the tree (k <= 5), eq weights in one
    chunk or in many with tickets, up to k = nv - 7."""
    rng = np.random.default_rng(2000 + 32 * nv + k)
    ev = to_torch(_tables(rng, nv, kind), dev)
    pts = to_torch(rng.integers(0, Q, k, dtype=np.uint64), dev)
    before = FX.LAUNCHES["fix_last_goldilocks"]
    got = FX.fix_last_goldilocks(ev, pts)
    torch.cuda.synchronize()
    assert FX.LAUNCHES["fix_last_goldilocks"] == before + 1
    assert torch.equal(got, FX.fix_last_goldilocks_ref(ev, pts))


def test_mle_kernels_back_to_back_and_on_two_streams(dev):
    """Every launch leaves its tickets at 0: calls in a row on one
    stream, then on two streams at once (a work buffer each), all
    bit-equal to the twins."""
    rng = np.random.default_rng(3)
    tabs = [to_torch(_tables(rng, nv, "random"), dev)
            for nv in (20, 20, 21, 24)]
    pts = [to_torch(rng.integers(0, Q, T.numel().bit_length() - 1,
                                 dtype=np.uint64), dev) for T in tabs]
    ev_want = [FX.evaluate_goldilocks_ref(T, P) for T, P in zip(tabs, pts)]
    fx_want = [FX.fix_last_goldilocks_ref(T, P[:13])
               for T, P in zip(tabs, pts)]

    def calls():
        return ([FX.evaluate_goldilocks(T, P) for T, P in zip(tabs, pts)],
                [FX.fix_last_goldilocks(T, P[:13]) for T, P in zip(tabs,
                                                                    pts)])

    runs = [calls() for _ in range(4)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                runs.append(calls())
    torch.cuda.synchronize()
    for ev, fx in runs:
        assert all(torch.equal(a, b) for a, b in zip(ev, ev_want))
        assert all(torch.equal(a, b) for a, b in zip(fx, fx_want))
    keys = {key for key in _build.WORK if key[0] == dev.index}
    assert {s.cuda_stream for s in streams} <= {key[1] for key in keys}


def test_mle_points_in_every_form(dev):
    """Points as a tensor (strided too), a list of 0-d tensors on the
    card, python ints, and CPU tensors: one launch a call, the twin's
    value."""
    rng = np.random.default_rng(4)
    nv = 20
    ev = to_torch(_tables(rng, nv, "random"), dev)
    pts = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    forms = [pts, list(pts), [int(v) for v in pts.cpu().numpy().view(
        np.uint64)], pts.cpu(), [p.cpu() for p in pts],
        torch.stack([pts, pts], 1)[:, 1]]
    want_e = FX.evaluate_goldilocks_ref(ev, pts)
    for k in (4, 9):
        want_f = FX.fix_last_goldilocks_ref(ev, pts[:k])
        for form in forms:
            before = dict(FX.LAUNCHES)
            got_e = FX.evaluate_goldilocks(ev, form)
            got_f = FX.fix_last_goldilocks(ev, form[:k])
            torch.cuda.synchronize()
            assert torch.equal(got_e, want_e) and torch.equal(got_f, want_f)
            assert FX.LAUNCHES["evaluate_goldilocks"] == before[
                "evaluate_goldilocks"] + 1
            assert FX.LAUNCHES["fix_last_goldilocks"] == before[
                "fix_last_goldilocks"] + 1
    with pytest.raises(ValueError, match="one int64 word"):
        FX.evaluate_goldilocks(ev, [p.to(torch.int32) for p in pts])


@pytest.mark.parametrize("nv,k", [(4, None), (11, None), (20, None),
                                  (24, None), (20, 1), (20, 7), (20, 13)])
def test_mle_kernels_on_unaligned_tables(dev, nv, k):
    """A table 8 bytes off a 16-byte boundary takes the kernels' 8-byte
    loads."""
    rng = np.random.default_rng(5)
    big = to_torch(rng.integers(0, Q, (1 << nv) + 1, dtype=np.uint64), dev)
    ev = big[1:]
    assert ev.data_ptr() % 16 == 8
    pts = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    if k is None:
        got, want = (FX.evaluate_goldilocks(ev, pts),
                     FX.evaluate_goldilocks_ref(ev, pts))
    else:
        got, want = (FX.fix_last_goldilocks(ev, pts[:k]),
                     FX.fix_last_goldilocks_ref(ev, pts[:k]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["random", "zeros", "q-1"])
@pytest.mark.parametrize("nv", [1, 4, 11, 13])
def test_sumcheck_kernel_matches_generic(dev, nv, k, kind):
    """K7 proves in one launch for every nv >= 1 on the card, small
    tables included (the reference hands nv < 12 to the generic
    prover)."""
    rng = np.random.default_rng(nv * 10 + k)
    tables = [to_torch(_tables(rng, nv, kind), dev) for _ in range(k)]
    chal = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    before = SK.LAUNCHES["sumcheck_prove_many_goldilocks"]
    msgs, finals = SK.sumcheck_prove_many(tables, chal)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["sumcheck_prove_many_goldilocks"] == before + 1
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal)
    assert torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


@pytest.mark.parametrize("nv", [4, 10, 14])
def test_mxu_eval_on_card(dev, nv):
    """torch._int_mm's CUDA shape rules (rows > 16, multiples of 8) on
    the digit GEMMs of every mxu_eval entry point, both digit schemes."""
    rng = np.random.default_rng(nv)
    ev = to_torch(rng.integers(0, Q, 1 << nv, dtype=np.uint64), dev)
    pts = to_torch(rng.integers(0, Q, nv, dtype=np.uint64), dev)
    mle = DenseMLE(FieldElems(GOLDILOCKS, dev), nv, ev)
    assert torch.equal(MX.evaluate_goldilocks_mxu(ev, pts),
                       mle.evaluate(list(pts)))
    for h in sorted({1, 3, nv - 1}):
        assert torch.equal(MX.fix_last_variables_mxu(ev, pts[:h]),
                           mle.fix_last_variables(list(pts[:h])).evals), h
    P = to_torch(rng.integers(0, Q, (4, nv), dtype=np.uint64), dev)
    want = torch.stack([mle.evaluate(list(p)) for p in P])
    assert torch.equal(MX.evaluate_many_goldilocks_mxu(ev, P), want)


@pytest.mark.parametrize("nv", [5, 12])
def test_example_proof_on_card(dev, nv):
    """The Fiat-Shamir proof verifies on the card (final check through
    K5 at every nv), a tampered one is rejected, and K7 on the
    bit-reversed tables reproduces its messages."""
    from stark_rings_tpu_torch.mle.sumcheck import bit_reverse_table

    rng = np.random.default_rng(nv)
    e = FieldElems(GOLDILOCKS, dev)
    g, h = DenseMLE.rand(e, nv, rng), DenseMLE.rand(e, nv, rng)
    S, msgs, chals = example.prove(g.evals, h.evals, Transcript(b"t"), nv)
    before = FX.LAUNCHES["evaluate_goldilocks"]
    assert example.verify(S, msgs, g, h, Transcript(b"t"))
    assert FX.LAUNCHES["evaluate_goldilocks"] == before + 2
    bad = [list(m) for m in msgs]
    bad[3][0] = GOLDILOCKS.add(bad[3][0], GOLDILOCKS.const(1, dev))
    assert not example.verify(S, [tuple(m) for m in bad], g, h,
                              Transcript(b"t"))
    m7, f7 = SK.sumcheck_prove_many(
        [bit_reverse_table(g.evals), bit_reverse_table(h.evals)], chals)
    assert torch.equal(m7, torch.stack([torch.stack(m) for m in msgs]))
    assert torch.equal(f7[0], FX.evaluate_goldilocks(g.evals, chals))
    assert torch.equal(f7[1], FX.evaluate_goldilocks(h.evals, chals))


# -- BASELINE config 4: the sparse mat-vec into its MLEs ----------------------


def _config4_matrix(dev):
    """Config 4's A, a 2^20 x 2^20 SparseMatrix over Goldilocks with 4
    entries a row (nnz 2^22, the shape of an R1CS / CCS matrix), and z
    [2^20], with their numpy storage for the oracles and the generator
    that drew them."""
    from stark_rings_tpu_torch.linalg import SparseMatrix

    rng = np.random.default_rng(51)
    n, terms = 1 << 20, 4
    cols = rng.integers(0, n, n * terms, dtype=np.int64).astype(np.int32)
    data = rng.integers(0, Q, n * terms, dtype=np.uint64)
    z = rng.integers(0, Q, n, dtype=np.uint64)
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(
        terms)
    A = SparseMatrix(FieldElems(GOLDILOCKS, dev), n, n, to_torch(data, dev),
                     rows, torch.from_numpy(cols).to(dev))
    return A, to_torch(z, dev), (data, cols, z), rng


def _eq_table(f, pts, dev):
    """eq(pts, x) for every x in {0,1}^n, variable j at bit j: [2^n]."""
    one, t = f.ones((), dev), f.ones((1,), dev)
    for p in pts:
        t = torch.cat([f.mul(t, f.sub(one, p)), f.mul(t, p)])
    return t


def test_sparse_matvec_into_mles_on_card(dev):
    """Config 4 at full width on the card: y = A z for A 2^20 x 2^20 with
    4 terms a row (64 rows against Python-int sums); DenseMLE(y) through
    K5 and K6 (k = 10) against DenseMLE.evaluate / fix_last_variables;
    the nv = 40 SparseMLE of A: fix_variables(c) against A.mul_vec(eq(c,
    .)), its K5 evaluation at r against the nv = 40 evaluation at r||c;
    a 2^16 x 2^16 ring-element mat-vec over the goldilocks model (8 rows
    against the spec's slot products in Python ints); DenseMLE.from_matrix
    of a 2^12 x 2^12 matrix (nv = 24) through K5 against
    SparseMLE.evaluate.  The path is 3 K5 launches and 1 K6."""
    from stark_rings_tpu_torch.linalg import RingElems, SparseMatrix
    from stark_rings_tpu_torch.mle import SparseMLE
    from stark_rings_tpu_torch.rings import get_ring

    f, log, terms = GOLDILOCKS, 20, 4
    A, z, (data, cols, z_np), rng = _config4_matrix(dev)
    e = FieldElems(f, dev)
    pts = f.rand((2 * log,), rng, dev)
    c, r = list(pts[:log]), list(pts[log:])          # columns, then rows
    ring = get_ring("goldilocks", device=dev)
    er = RingElems(ring)
    rn = 1 << 16
    rcols = rng.integers(0, rn, rn * terms, dtype=np.int64)
    AR = SparseMatrix(er, rn, rn, er.rand((rn * terms,), rng),
                      torch.arange(rn, device=dev).repeat_interleave(terms),
                      torch.from_numpy(rcols).to(dev))
    zr = er.rand((rn,), rng)
    dn = 1 << 12
    AD = SparseMatrix(e, dn, dn, e.rand((dn * terms,), rng),
                      torch.arange(dn, device=dev).repeat_interleave(terms),
                      torch.from_numpy(rng.integers(0, dn, dn * terms))
                      .to(dev))
    pd = list(f.rand((24,), rng, dev))

    torch.cuda.synchronize()
    FX.reset_launches()
    y = A.mul_vec(z)
    dm = DenseMLE(e, log, y)
    y_at = FX.evaluate_goldilocks(dm.evals, r)
    y_fix = FX.fix_last_goldilocks(dm.evals, r[log - 10:])
    sm = SparseMLE.from_matrix(e, A)
    full = sm.evaluate(c + r)
    fixed = sm.fix_variables(c).to_dense().evals
    fixed_at = FX.evaluate_goldilocks(fixed, r)
    yr = AR.mul_vec(zr)
    mdd = DenseMLE.from_matrix(e, AD)
    mdd_at = FX.evaluate_goldilocks(mdd.evals, pd)
    torch.cuda.synchronize()
    assert FX.LAUNCHES == {"evaluate_goldilocks": 3, "fix_last_goldilocks": 1}
    assert y.shape == (1 << log,) and sm.num_vars == 2 * log
    assert mdd.num_vars == 24

    y_host = y.cpu().numpy().view(np.uint64)
    for i in rng.choice(1 << log, 64, replace=False):
        want = sum(int(data[t]) * int(z_np[cols[t]])
                   for t in range(i * terms, (i + 1) * terms)) % Q
        assert int(y_host[i]) == want, i
    assert torch.equal(y_at, dm.evaluate(r))
    assert torch.equal(y_fix, dm.fix_last_variables(r[log - 10:]).evals)
    assert torch.equal(fixed, A.mul_vec(_eq_table(f, c, dev)))
    assert torch.equal(fixed_at, full)
    assert torch.equal(mdd_at, SparseMLE.from_matrix(e, AD).evaluate(pd))
    ring_rows = rng.choice(rn, 8, replace=False)
    ents = (ring_rows[:, None] * terms + np.arange(terms)).reshape(-1)
    yr_i = ring.decode(yr[torch.from_numpy(ring_rows).to(dev)])
    d_i = ring.decode(AR.data[torch.from_numpy(ents).to(dev)])
    z_i = ring.decode(zr[torch.from_numpy(rcols[ents]).to(dev)])
    for k in range(len(ring_rows)):
        acc = [0] * ring.D
        for t in range(k * terms, (k + 1) * terms):
            p_ = ring.spec.ntt_mul([int(v) for v in d_i[t]],
                                   [int(v) for v in z_i[t]])
            acc = [(x + w) % Q for x, w in zip(acc, p_)]
        assert [int(v) for v in yr_i[k]] == acc, k


# -- K7 over BabyBear and frog, and batched claims ---------------------------


def _field_tables(f, rng, shape, kind, dev):
    """Storage of ``f``: zeros, the storage of q-1, or uniform words."""
    if kind == "zeros":
        return f.zeros(shape, dev)
    if kind == "q-1":
        return f.encode(np.full(shape, f.q - 1, dtype=object), dev)
    return f.rand(shape, rng, dev)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["random", "zeros", "q-1"])
@pytest.mark.parametrize("nv", [1, 4, 11, 14])
@pytest.mark.parametrize("field", ["babybear", "frog"])
def test_sumcheck_kernel_fields_match_generic(dev, field, nv, k, kind):
    """K7 over BabyBear (int32 Montgomery storage) and frog (int64
    Montgomery storage) against the generic msb prover on the card."""
    f = get_field(field)
    rng = np.random.default_rng(nv * 10 + k)
    tables = [_field_tables(f, rng, (1 << nv,), kind, dev)
              for _ in range(k)]
    chal = f.rand((nv,), rng, dev)
    name = f"sumcheck_prove_many_{field}"
    before = SK.LAUNCHES[name]
    msgs, finals = SK.sumcheck_prove_many(tables, chal, field=field)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal, field)
    assert msgs.dtype == f.dtype and torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_sumcheck_relations_in_python_ints(dev, field, k):
    """K7's nv = 20 proof on random tables holds the sumcheck relations
    in Python ints (an oracle independent of the generic prover)."""
    f = get_field(field)
    rng = np.random.default_rng(20 * k + len(field))
    tables = [f.rand((1 << 20,), rng, dev) for _ in range(k)]
    chal = f.rand((20,), rng, dev)
    msgs, finals = SK.sumcheck_prove_many(tables, chal, field=field)
    _py_check_proof(f, tables, chal, msgs, finals)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("nv", [1, 2, 11, 12, 20])
@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_sumcheck_persistent_kernel_matches_generic(dev, field, nv, k):
    """One cooperative launch per proof at every k <= 8, around where
    the one-block tail begins (nv = 11, 12 for k = 2) and at nv = 20,
    against the generic prover; the grid fits the card."""
    f = get_field(field)
    rng = np.random.default_rng(nv * 10 + k)
    tables = [f.rand((1 << nv,), rng, dev) for _ in range(k)]
    chal = f.rand((nv,), rng, dev)
    name = f"sumcheck_prove_many_{field}"
    before = SK.LAUNCHES[name]
    msgs, finals = SK.sumcheck_prove_many(tables, chal, field=field)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    grid, per_sm = SK.LAST_GRID[name]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 <= grid <= sms * per_sm
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal, field)
    assert torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


def test_sumcheck_refused_launch_raises(dev, monkeypatch):
    """A cooperative launch the card refuses raises; no per-round kernel
    runs in its place."""
    lib = _build.kernels()

    def refused(*args):
        return 720        # cudaErrorCooperativeLaunchTooLarge

    monkeypatch.setattr(lib, "srt_sumcheck_prove_goldilocks", refused)
    f = get_field("goldilocks")
    rng = np.random.default_rng(720)
    before = dict(SK.LAUNCHES)
    for k in (2, 9):
        tables = [f.rand((1 << 12,), rng, dev) for _ in range(k)]
        with pytest.raises(RuntimeError, match="cooperative"):
            SK.sumcheck_prove_many(tables, f.rand((12,), rng, dev))
    assert SK.LAUNCHES == before


@pytest.mark.parametrize("W", [1, 3, 4])
def test_sumcheck_batch_matches_single_proofs(dev, W):
    """W Goldilocks claims as virtual blocks of one launch, and claim
    w's proof equals a single K7 proof on row w and the twin."""
    f = get_field("goldilocks")
    nv = 11
    rng = np.random.default_rng(W)
    for k in (2, 3):
        tables = [f.rand((W, 1 << nv), rng, dev) for _ in range(k)]
        chal = f.rand((nv,), rng, dev)
        before = SK.LAUNCHES["sumcheck_prove_batch_goldilocks"]
        msgs, finals = SK.sumcheck_prove_batch_goldilocks(tables, chal)
        torch.cuda.synchronize()
        assert SK.LAUNCHES["sumcheck_prove_batch_goldilocks"] == before + 1
        assert msgs.shape == (W, nv, k + 1)
        assert [tuple(x.shape) for x in finals] == [(W,)] * k
        for w in range(W):
            m, fs = SK.sumcheck_prove_many([T[w] for T in tables], chal)
            assert torch.equal(msgs[w], m), (k, w)
            assert all(torch.equal(x[w], y) for x, y in zip(finals, fs))
        want_m, want_f = SK.sumcheck_prove_batch_ref(tables, chal)
        assert torch.equal(msgs, want_m)
        assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


@pytest.mark.parametrize("nv", [1, 4, 12, 20])
def test_sumcheck_partials_hold_only_the_blocks_used(dev, nv):
    """The partials of a proof hold one row per block of each round
    before the tail (a phase's rounds take the blocks of its last round;
    no round pads to the most blocks), W times for W claims: the kernel
    takes the plan's rows and tail round and refuses any other, with no
    launch."""
    f = get_field("goldilocks")
    half = 1 << (nv - 1)
    grid_rounds = [i for i in range(nv) if half >> i > 1024]
    per_claim = sum(min(1024, -(-(half >> min(i // 3 * 3 + 2,
                                              grid_rounds[-1])) // 256))
                    for i in grid_rounds)
    lib = _build.kernels()
    fn = lib.srt_sumcheck_prove_goldilocks
    info = (ctypes.c_int * 2)()
    ins = (ctypes.c_void_p * 2)(0, 0)
    rng = np.random.default_rng(nv)
    for W in (1, 4):
        p = SK.plan(nv, 2, 8, W)
        assert p.rows == per_claim and p.launches == 1
        for tail, rows in ((p.tail, p.rows + 1), (p.tail + 1, p.rows),
                           *(((p.tail, p.rows - 1),) if p.rows else ())):
            err = fn(ins, None, None, 2, W, half, nv, tail, None, rows,
                     None, None, info, None)
            assert err == 1, (tail, rows)      # cudaErrorInvalidValue
        tables = [f.rand((W, 1 << nv), rng, dev) for _ in range(2)]
        chal = f.rand((nv,), rng, dev)
        msgs, finals = SK.sumcheck_prove_batch_goldilocks(tables, chal)
        want_m, want_f = SK.sumcheck_prove_batch_ref(tables, chal)
        assert torch.equal(msgs, want_m)
        assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


def test_sumcheck_batch_many_claims(dev):
    """The most claims one launch takes (65,535) at nv = 4: one launch,
    and sampled claims equal their single K7 proofs."""
    f = get_field("goldilocks")
    W, nv = 65535, 4
    rng = np.random.default_rng(W)
    tables = [f.rand((W, 1 << nv), rng, dev) for _ in range(2)]
    chal = f.rand((nv,), rng, dev)
    before = SK.LAUNCHES["sumcheck_prove_batch_goldilocks"]
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(tables, chal)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["sumcheck_prove_batch_goldilocks"] == before + 1
    for w in (0, 1, 4097, W // 2, W - 1):
        m, fs = SK.sumcheck_prove_many([T[w] for T in tables], chal)
        assert torch.equal(msgs[w], m), w
        assert all(torch.equal(x[w], y) for x, y in zip(finals, fs))
    with pytest.raises(ValueError, match="W >= 1"):
        SK.sumcheck_prove_batch_goldilocks([f.zeros((0, 2), dev)] * 2,
                                           chal[:1])


# -- K7's card limits: the inputs the reference proves ------------------------


@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_sumcheck_nine_tables_on_card(dev, field):
    """k = 9 tables at nv = 12, beyond the register kernel's 8: the
    run-time-k kernel, one launch, equal to the twin."""
    f = get_field(field)
    rng = np.random.default_rng(9)
    tables = [f.rand((1 << 12,), rng, dev) for _ in range(9)]
    chal = f.rand((12,), rng, dev)
    name = f"sumcheck_prove_many_{field}"
    before = SK.LAUNCHES[name]
    msgs, finals = SK.sumcheck_prove_many(tables, chal, field=field)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    grid, per_sm = SK.LAST_GRID[name]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 <= grid <= sms * per_sm
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal, field)
    assert msgs.is_cuda and torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


_WIDE_CASES = [(1, 9, 1), (1, 24, 3), (4, 16, 3), (11, 17, 1), (12, 9, 2),
               (12, 16, 1), (12, 17, 2), (12, 24, 1)]
# nv = 16 (grid rounds of 256 blocks and more) and k = 65, random tables
# only: the twin's generic prover takes seconds a claim there
_WIDE_CASES_16 = [(4, 65, 1, "random"), (16, 9, 3, "random"),
                  (16, 16, 2, "random"), (16, 17, 1, "random"),
                  (16, 24, 1, "random")]


@pytest.mark.parametrize("nv,k,W,kind", [
    (nv, k, W, kind) for nv, k, W in _WIDE_CASES
    for kind in ("random", "zeros", "q-1")] + _WIDE_CASES_16)
@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_sumcheck_wide_kernel_matches_twin(dev, field, nv, k, W, kind):
    """The run-time-k kernel at k = 9, 16, 17 and 24 (two and four groups
    of 8 sums an entry; k + 1 = 17 leaves a group with one sum) and 65
    (table pointers from a device array), nv = 1, 4, 11, 12 and 16, W
    claims as virtual blocks, one launch a proof, against the twin."""
    f = get_field(field)
    rng = np.random.default_rng(nv * 100 + k)
    tables = [_field_tables(f, rng, (W, 1 << nv), kind, dev)
              for _ in range(k)]
    chal = f.rand((nv,), rng, dev)
    name = f"sumcheck_prove_many_{field}"
    before = SK.LAUNCHES[name]
    msgs, finals = _claims(f, tables, chal)
    torch.cuda.synchronize()
    assert SK.LAUNCHES[name] == before + 1
    for w in range(W):
        want_m, want_f = SK.sumcheck_prove_many_ref([T[w] for T in tables],
                                                    chal, field)
        assert torch.equal(msgs[w], want_m), w
        assert all(torch.equal(x[w], y) for x, y in zip(finals, want_f))


@pytest.mark.parametrize("k", [1, 2, 9])
def test_sumcheck_no_variables_on_card(dev, k):
    """nv = 0: the empty proof, equal to the twin, for one claim and a
    batch, with no launch."""
    f = get_field("goldilocks")
    rng = np.random.default_rng(k)
    tables = [f.rand((1,), rng, dev) for _ in range(k)]
    chal = torch.empty(0, dtype=torch.int64, device=dev)
    before = dict(SK.LAUNCHES)
    msgs, finals = SK.sumcheck_prove_many(tables, chal)
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal)
    assert msgs.shape == (0, k + 1) and torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))
    batch = [f.rand((3, 1), rng, dev) for _ in range(k)]
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(batch, chal)
    want_m, want_f = SK.sumcheck_prove_batch_ref(batch, chal)
    assert msgs.shape == (3, 0, k + 1) and torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))
    assert SK.LAUNCHES == before


def test_sumcheck_batch_over_one_launch(dev):
    """W = 65,536 claims at nv = 1, one more than a launch takes: two
    chunks of one launch each, equal to the twin on every claim."""
    f = get_field("goldilocks")
    W, nv = 65536, 1
    rng = np.random.default_rng(W)
    tables = [f.rand((W, 1 << nv), rng, dev) for _ in range(2)]
    chal = f.rand((nv,), rng, dev)
    before = SK.LAUNCHES["sumcheck_prove_batch_goldilocks"]
    msgs, finals = SK.sumcheck_prove_batch_goldilocks(tables, chal)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["sumcheck_prove_batch_goldilocks"] == before + 2
    assert SK.plan(nv, 2, 8, W).chunks == ((0, 65535), (65535, 1))
    want_m, want_f = SK.sumcheck_prove_batch_ref(tables, chal)
    assert msgs.shape == (W, nv, 3) and torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


def _claims(f, tables, r):
    """K7 over field ``f`` on the W rows of [W, 2^nv] tables as W claims,
    through the kernels' claim axis (the public batch is Goldilocks
    only)."""
    W = tables[0].shape[0]
    msgs, finals = SK._prove_on_card(f"sumcheck_prove_many_{f.name}", f,
                                     tables, r, W)
    return msgs, list(finals.unbind(1))


@pytest.mark.parametrize("field", ["goldilocks", "babybear", "frog"])
def test_kernel_field_ops_match_torch_ops(dev, field):
    """The device headers' add, sub and mul against the field's torch ops,
    through K7 on 2^11 one-variable claims: with tables (a0, a1) and
    (b0, b1), p(0) = a0*b0, p(t) multiplies a0 + t*(a1 - a0) by b0 +
    t*(b1 - b0) (k = 2), and the final is a0 + r*(a1 - a0).  Inputs are
    full-range storage words and the words 0, 1, 2, q-2, q-1 and the
    storage of 0, 1 and q-1, each edge paired with every other."""
    f = get_field(field)
    rng = np.random.default_rng(len(field))
    W = 2048
    edge = [0, 1, 2, f.q - 2, f.q - 1]
    edge = np.concatenate([
        np.array(edge, dtype=np.uint64 if f.dtype == torch.int64
                 else np.uint32),
        f.storage_np([0, 1, f.q - 1])])
    E = len(edge)
    a0 = f.rand((W,), rng, dev)
    b0 = f.rand((W,), rng, dev)
    ed = from_jax_storage(f, edge, dev)
    a0[:E * E], b0[:E * E] = ed.repeat_interleave(E), ed.repeat(E)
    a1, b1 = f.rand((W,), rng, dev), f.rand((W,), rng, dev)
    a1[E * E:2 * E * E], b1[E * E:2 * E * E] = ed.repeat(E), \
        ed.repeat_interleave(E)
    r = f.rand((1,), rng, dev)
    r[0] = ed[3]                          # the word q-2
    A, Bt = torch.stack([a0, a1], 1), torch.stack([b0, b1], 1)
    da, db = f.sub(a1, a0), f.sub(b1, b0)
    fold = f.add(a0, f.mul(r, da))

    msgs, finals = _claims(f, [A], r)
    torch.cuda.synchronize()
    assert torch.equal(msgs[:, 0, 0], a0)
    assert torch.equal(msgs[:, 0, 1], f.add(a0, da))
    assert torch.equal(finals[0], fold)

    msgs, finals = _claims(f, [A, Bt], r)
    torch.cuda.synchronize()
    cur_a, cur_b = a0, b0
    for t in range(3):
        assert torch.equal(msgs[:, 0, t], f.mul(cur_a, cur_b)), t
        cur_a, cur_b = f.add(cur_a, da), f.add(cur_b, db)
    assert torch.equal(finals[0], fold)
    assert torch.equal(finals[1], f.add(b0, f.mul(r, db)))


@pytest.mark.parametrize("field", ["babybear", "frog"])
def test_example_proof_on_card_fields(dev, field):
    """The Fiat-Shamir proof over BabyBear and frog verifies on the card
    (final check through DenseMLE.evaluate), a tampered one is rejected,
    and K7 on the bit-reversed tables reproduces it."""
    from stark_rings_tpu_torch.mle.sumcheck import bit_reverse_table

    f, nv = get_field(field), 12
    rng = np.random.default_rng(nv)
    e = FieldElems(f, dev)
    g, h = DenseMLE.rand(e, nv, rng), DenseMLE.rand(e, nv, rng)
    S, msgs, chals = example.prove(g.evals, h.evals, Transcript(b"t"), nv,
                                   f)
    assert example.verify(S, msgs, g, h, Transcript(b"t"))
    bad = [list(m) for m in msgs]
    bad[3][0] = f.add(bad[3][0], f.const(1, dev))
    assert not example.verify(S, [tuple(m) for m in bad], g, h,
                              Transcript(b"t"))
    m7, f7 = SK.sumcheck_prove_many(
        [bit_reverse_table(g.evals), bit_reverse_table(h.evals)],
        torch.stack(chals), field=field)
    assert torch.equal(m7, torch.stack([torch.stack(m) for m in msgs]))
    assert torch.equal(f7[0], g.evaluate(chals))
    assert torch.equal(f7[1], h.evaluate(chals))


# -- the radix NTT engine, the fused mod-mat kernel and the chain kernel -----


@pytest.mark.parametrize("depth", [0, 1, 16])
@pytest.mark.parametrize("n", [1, 255, 3 * 1024 + 7])
def test_pointwise_chain_matches_twin(dev, n, depth):
    rng = np.random.default_rng(n + depth)
    a = rng.integers(0, Q, n, dtype=np.uint64)
    b = rng.integers(0, Q, n, dtype=np.uint64)
    a[0] = b[0] = Q - 1
    b[-1] = 0
    a, b = to_torch(a, dev), to_torch(b, dev)
    before = K.LAUNCHES["pointwise_chain"]
    got = K.pointwise_chain(a, b, depth)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pointwise_chain"] == before + 1
    assert torch.equal(got, K.pointwise_chain_ref(a, b, depth))


@pytest.mark.parametrize("logN,log_tile", [(7, 14), (10, 14), (10, 4),
                                           (13, 14), (14, 14), (15, 14),
                                           (16, 14), (16, 9)])
def test_ntt_kernels_match_twins(dev, logN, log_tile, monkeypatch):
    """Every stage pass and tile mode against its twin, and the engine
    against NTTContext, on 3 rows."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G

    N = 1 << logN
    rng = np.random.default_rng(logN * 16 + log_tile)
    x, o = (to_torch(rng.integers(0, Q, (3, N), dtype=np.uint64), dev)
            for _ in range(2))
    x[0, :3] = to_torch(np.array([Q - 1, 0, 1], dtype=np.uint64), dev)
    monkeypatch.setattr(G, "LOG_TILE", log_tile)
    e = G.GoldilocksKernelNTT(N, device=dev)
    wf, wi, ninv = e.tables()
    for s in (0, logN // 2, logN - 1):
        for inverse, scale in ((False, None), (True, None), (True, ninv)):
            w = wi if inverse else wf
            got = G.ntt_stage(x, w, s, inverse=inverse, ninv=scale)
            want = G.ntt_stage_ref(x, w, s, inverse=inverse, ninv=scale)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (s, inverse, scale)
    lt = e.log_tile
    for mode in G.MODES:
        if mode == "mul" and (lt != logN or N > 1 << 13):
            continue
        got = G.ntt_tile(x, wf, wi, ninv, lt, mode, o)
        torch.cuda.synchronize()
        assert torch.equal(got, G.ntt_tile_ref(x, wf, wi, ninv, lt, mode,
                                               o)), mode
    ctx = NTTContext(GOLDILOCKS, N, device=dev)
    G.reset_launches()
    got = e.mul(x, o)
    torch.cuda.synchronize()
    passes = logN - lt
    tiles = 1 if not passes and N <= 1 << 13 else 2
    assert G.LAUNCHES == {"ntt_stage": 3 * passes, "ntt_tile": tiles}
    assert torch.equal(got, ctx.mul(x, o))
    assert torch.equal(e.mul_composite(x, o), got)
    assert torch.equal(e.forward(x), ctx.forward(x))
    assert torch.equal(e.inverse(x), ctx.inverse(x))


@pytest.mark.parametrize("log_tile", range(1, 15))
def test_ntt_tile_every_log_tile(dev, log_tile, monkeypatch):
    """ntt_tile in all four modes against its twin at every log_tile
    the kernel takes (up to 2^14 words, one above LOG_TILE): the tile the
    whole row (N = 2^log_tile, where the inverse scales by 1/N and mul
    takes both rows when 2N <= 2^14), and four tiles a row (N =
    2^(log_tile + 2), at most 2^16)."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G

    monkeypatch.setattr(G, "LOG_TILE", 14)

    for logN in sorted({log_tile, min(log_tile + 2, 16)}):
        N = 1 << logN
        rng = np.random.default_rng(64 * log_tile + logN)
        x, o = (to_torch(rng.integers(0, Q, (3, N), dtype=np.uint64), dev)
                for _ in range(2))
        x[0, :2] = to_torch(np.array([Q - 1, 0], dtype=np.uint64), dev)
        wf, wi, ninv = G.GoldilocksKernelNTT(N, device=dev).tables()
        for mode in G.MODES:
            if mode == "mul" and (logN != log_tile or 2 * N > 1 << 14):
                continue
            before = G.LAUNCHES["ntt_tile"]
            got = G.ntt_tile(x, wf, wi, ninv, log_tile, mode, o)
            torch.cuda.synchronize()
            assert G.LAUNCHES["ntt_tile"] == before + 1
            want = G.ntt_tile_ref(x, wf, wi, ninv, log_tile, mode, o)
            assert torch.equal(got, want), (logN, mode)


def test_ntt_tile_at_deg_2_16(dev):
    """The three tile modes of the deg-2^16 multiply at log_tile =
    LOG_TILE on B = 80 rows (320 tiles), against the twin, out of place
    and in place."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G

    N, B = 1 << 16, 80
    rng = np.random.default_rng(2)
    x, o = (to_torch(rng.integers(0, Q, (B, N), dtype=np.uint64), dev)
            for _ in range(2))
    e = G.GoldilocksKernelNTT(N, device=dev)
    wf, wi, ninv = e.tables()
    assert e.log_tile == G.LOG_TILE
    for mode in ("forward", "inverse", "mul_eval"):
        want = G.ntt_tile_ref(x, wf, wi, ninv, e.log_tile, mode, o)
        assert torch.equal(G.ntt_tile(x, wf, wi, ninv, e.log_tile, mode, o),
                           want), mode
        y = x.clone()
        G.ntt_tile(y, wf, wi, ninv, e.log_tile, mode, o, inplace=True)
        torch.cuda.synchronize()
        assert torch.equal(y, want), mode


@pytest.mark.parametrize("logN", [1, 3, 10, 14, 16])
def test_radix_engine_matches_ntt_context(dev, logN):
    """GoldilocksKernelNTT's mul, forward and inverse against NTTContext
    from a one-thread tile (N = 2) to the main path's two passes and
    tile (N = 2^16)."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G

    N = 1 << logN
    rng = np.random.default_rng(logN)
    a, b = (to_torch(rng.integers(0, Q, (4, N), dtype=np.uint64), dev)
            for _ in range(2))
    e = G.GoldilocksKernelNTT(N, device=dev)
    ctx = NTTContext(GOLDILOCKS, N, device=dev)
    got = e.mul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ctx.mul(a, b))
    assert torch.equal(e.forward(a), ctx.forward(a))
    assert torch.equal(e.inverse(a), ctx.inverse(a))
    assert torch.equal(e.inverse(e.forward(a)), a)
    if logN <= 14:      # row 0 against the C++ schoolbook, O(N^2)
        an, bn = (x[0].cpu().numpy().view(np.uint64) for x in (a, b))
        assert np.array_equal(got[0].cpu().numpy().view(np.uint64),
                              negacyclic_mul_schoolbook_q(an, bn, Q))


@pytest.mark.parametrize("R,C,M", [(4, 128, 3), (5, 9, 130), (1, 1, 1),
                                   (65, 33, 31), (2, 13314, 5),
                                   (128, 128, 1000), (128, 128, 10240),
                                   (128, 128, 10240 + 37)])
def test_mxu_mod_mat_matches_twin(dev, R, C, M):
    """The tensor-core kernel against its twin (small M) and MxuModMat's
    _int_mm path, with the bound inputs: digits all 127 in a weight row,
    2^64 - 1, q - 1, 0 and 1 as data columns; R, C and M off the 64 x 32
    tile and its 32-column chunk, C at the bucket bound; one launch, with
    the plane table given or built by the wrapper."""
    from stark_rings_tpu_torch.ops import mxu_fused as MF
    from stark_rings_tpu_torch.ops.mxu import MxuModMat

    rng = np.random.default_rng(R * C + M)
    m = rng.integers(0, Q, (R, C), dtype=np.uint64).astype(object)
    m[0] = (1 << 63) - 1
    x = rng.integers(0, Q, (C, M), dtype=np.uint64)
    edge = np.array([2**64 - 1, Q - 1, 0, 1], dtype=np.uint64)[:M]
    x[:, :len(edge)] = edge
    x = to_torch(x, dev)
    f = MF.MxuModMatFused(m, device=dev)
    before = MF.LAUNCHES["mxu_mod_mat"]
    got = f.apply(x)
    torch.cuda.synchronize()
    assert MF.LAUNCHES["mxu_mod_mat"] == before + 1
    assert torch.equal(got, MxuModMat(m, device=dev).apply(x))
    assert torch.equal(MF.mxu_mod_mat(x, f.w), got)
    if M <= 1024:
        assert torch.equal(got, MF.mxu_mod_mat_ref(x, f.w))


def test_matmul_ntt_on_card(dev):
    """MatmulNTT at N = 2^14 on MxuModMat and with its four levels
    swapped for the fused kernel, against the radix engine's mul and
    NTTContext."""
    from stark_rings_tpu_torch.ops import mxu_fused as MF
    from stark_rings_tpu_torch.ops.goldilocks_ntt import GoldilocksKernelNTT
    from stark_rings_tpu_torch.ops.mxu import MatmulNTT

    rng = np.random.default_rng(14)
    a, b = (to_torch(rng.integers(0, Q, (2, 1 << 14), dtype=np.uint64), dev)
            for _ in range(2))
    want = NTTContext(GOLDILOCKS, 1 << 14, device=dev).mul(a, b)
    assert torch.equal(MatmulNTT(device=dev).mul(a, b), want)
    an, bn = (x[0].cpu().numpy().view(np.uint64) for x in (a, b))
    assert np.array_equal(want[0].cpu().numpy().view(np.uint64),
                          negacyclic_mul_schoolbook_q(an, bn, Q))
    mn = MatmulNTT(device=dev)
    for key in ("col_mat", "row_mat", "col_mat_inv", "row_mat_inv"):
        setattr(mn, key, MF.MxuModMatFused(getattr(mn, key).matrix(),
                                           device=dev))
    MF.reset_launches()
    assert torch.equal(mn.mul(a, b), want)
    assert MF.LAUNCHES["mxu_mod_mat"] == 6
    assert torch.equal(GoldilocksKernelNTT(1 << 14, device=dev).mul(a, b),
                       want)


def test_new_wrappers_raise_on_refused_inputs(dev, monkeypatch):
    """A CUDA tensor the kernel does not take raises, and no twin runs."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.ops import mxu_fused as MF

    def no_twin(*args, **kw):
        raise AssertionError("a twin ran on a CUDA tensor")

    for mod, name in ((K, "pointwise_chain_ref"), (G, "ntt_stage_ref"),
                      (G, "ntt_tile_ref"), (MF, "mxu_mod_mat_ref")):
        monkeypatch.setattr(mod, name, no_twin)
    x = torch.zeros((2, 256), dtype=torch.int64, device=dev)
    e = G.GoldilocksKernelNTT(256, device=dev)
    wf, wi, ninv = e.tables()
    f = MF.MxuModMatFused([[1, 2], [3, 4]], device=dev)
    before = (dict(K.LAUNCHES), dict(G.LAUNCHES), dict(MF.LAUNCHES))
    cases = [
        (TypeError, lambda: K.pointwise_chain(x.int(), x.int())),
        (ValueError, lambda: K.pointwise_chain(x.t(), x.t())),
        (ValueError, lambda: K.pointwise_chain(x, x[:1])),
        (TypeError, lambda: G.ntt_stage(x.int(), wf, 0)),
        (ValueError, lambda: G.ntt_stage(x.t(), wf, 0)),
        (ValueError, lambda: G.ntt_stage(x[:, :100].contiguous(), wf, 0)),
        (ValueError, lambda: G.ntt_tile(x, wf, wi, ninv, 15, "forward")),
        (ValueError, lambda: G.ntt_tile(x, wf[:128], wi, ninv, 8,
                                        "forward")),
        (TypeError, lambda: MF.mxu_mod_mat(x[:2, :5].int(), f.w)),
        (ValueError, lambda: MF.mxu_mod_mat(x[:, :4].t(), f.w)),
        (ValueError, lambda: MF.mxu_mod_mat(x[:1, :4].contiguous(), f.w)),
        (ValueError, lambda: MF.mxu_mod_mat(x[:2, :4].contiguous(), f.w,
                                            f.wt[:, :32])),
    ]
    for exc, call in cases:
        with pytest.raises(exc):
            call()
    assert (dict(K.LAUNCHES), dict(G.LAUNCHES), dict(MF.LAUNCHES)) == before


# -- K8, the sharded four-step's exchange, and the sharded NTT ---------------


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_exchange_kernel_matches_twin(dev, field, P, batch):
    """K8 forward and inverse against their twins on P shards of one
    card, batched and batchless, with the words 0 and q-1 among the
    inputs."""
    from stark_rings_tpu_torch.parallel import exchange as EX

    f = get_field(field)
    N1, N2 = 32, 64
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(P)
    edge = f.encode([0, f.q - 1], dev)
    for inverse in (False, True):
        rows, cols = (N1 // P, N2) if inverse else (N1, N2 // P)
        xs = [f.rand(lead + (rows, cols), rng, dev) for _ in range(P)]
        tws = [f.rand((rows, cols), rng, dev) for _ in range(P)]
        xs[0].view(-1)[:2], tws[-1].view(-1)[:2] = edge, edge.flip(0)
        kern = EX.twiddle_exchange_inv if inverse else EX.twiddle_exchange_fwd
        twin = EX.twiddle_exchange_inv_ref if inverse \
            else EX.twiddle_exchange_fwd_ref
        name = f"twiddle_exchange_{'inv' if inverse else 'fwd'}_{field}"
        before = EX.LAUNCHES[name]
        got = kern(xs, tws, field)
        torch.cuda.synchronize()
        assert EX.LAUNCHES[name] == before + 1
        want = twin(xs, tws, field)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), inverse


def test_exchange_kernel_raises_on_refused_shards(dev, monkeypatch):
    """Card shards K8 does not take raise, and no twin runs."""
    from stark_rings_tpu_torch.parallel import exchange as EX

    def no_twin(*args, **kw):
        raise AssertionError("a twin ran on CUDA shards")

    monkeypatch.setattr(EX, "twiddle_exchange_fwd_ref", no_twin)
    f = get_field("goldilocks")
    x = f.zeros((8, 8), dev)
    before = dict(EX.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        EX.twiddle_exchange_fwd([x.t(), x], [x, x], "goldilocks")
    with pytest.raises(ValueError, match="power of two"):
        EX.twiddle_exchange_fwd([f.zeros((12, 8), dev)] * 2,
                                [f.zeros((12, 8), dev)] * 2, "goldilocks")
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        EX.twiddle_exchange_fwd([x, x.cpu()], [x, x], "goldilocks")
    assert dict(EX.LAUNCHES) == before


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_sharded_mul_on_card(dev, field):
    """ShardedNTT(exchange="pallas") on 8 shards of the card: K8 runs 3
    times per mul (2 per mul_cached and square), and every product equals
    the "xla" route, fourstep_ctx and the radix NTTContext."""
    from stark_rings_tpu_torch import ShardedNTT, make_mesh
    from stark_rings_tpu_torch.parallel import exchange as EX

    f = get_field(field)
    N, P = 1 << 12, 8
    mesh = make_mesh(P, device=dev)
    rng = np.random.default_rng(12)
    a, b = f.rand((2, N), rng, dev), f.rand((2, N), rng, dev)
    outs = {}
    for exchange in ("xla", "pallas"):
        sn = ShardedNTT(field, N, P, exchange=exchange)
        cspec, _ = sn.shard_specs(1)
        sa = sn.shard(sn.to_matrix(a), cspec, mesh)
        sb = sn.shard(sn.to_matrix(b), cspec, mesh)
        _, _, mul = sn.make_fns(mesh, batch_ndim=1)
        pre, mul_cached, square = sn.make_cached_fns(mesh, batch_ndim=1)
        EX.reset_launches()
        outs[exchange] = [sn.from_matrix(sn.gather(x, cspec, dev)) for x in (
            mul(sa, sb), mul_cached(sa, pre(sb)), square(sa))]
        torch.cuda.synchronize()
        n = sum(EX.LAUNCHES.values())
        assert n == (0 if exchange == "xla" else 3 + 3 + 2), n
    ring = get_power_ring(field, 12, device=dev)
    want = ring.coeff_mul(a, b)
    assert torch.equal(outs["pallas"][0], want)
    assert torch.equal(ring.fourstep_ctx().mul(a, b), want)
    assert torch.equal(outs["pallas"][2], ring.coeff_square(a))
    for got, ref in zip(outs["pallas"], outs["xla"]):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_model_crt_folds_match_twins(dev, name, signed):
    """K3 (R = 24) and K4's bb_fold_end (R = 72) at the ring models'
    shapes: on buckets from the model CRT's GEMM (a ragged batch padded
    to 16 columns, and 1,000 columns), at the bucket bound, zero and the
    whole int32 range, against their twins."""
    from stark_rings_tpu_torch.ops import mxu_dense
    from stark_rings_tpu_torch.ops.dense_linear import probe_dense_matrix
    from stark_rings_tpu_torch.ops.mxu2 import PrescaledMat, digit_table
    from stark_rings_tpu_torch.ops.mxu_bb import BBPrescaledMat
    from stark_rings_tpu_torch.rings import get_ring

    ring = get_ring(name, device=dev)
    mod, fold = (K, "fold_end") if name == "goldilocks" else (KB,
                                                             "bb_fold_end")
    crt = probe_dense_matrix(ring.spec.crt, ring.D, ring.D, ring.q)
    core = (PrescaledMat if name == "goldilocks" else BBPrescaledMat)(
        crt, unsigned=not signed)
    w, corr = digit_table(core.big, dev)
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(21)
    for cols in (16, 1000):
        x = ring.field.rand((ring.D, cols), rng, dev)
        V = core.dot(x, w, corr)
        assert V.shape == (core.K * ring.D, cols) and V.is_contiguous()
        bound = (1 << 26) - 1 if signed else (1 << 27) - 1
        for Vc in (V, torch.full_like(V, bound), torch.zeros_like(V),
                   torch.randint(-2**31, 2**31, V.shape, generator=gen,
                                 dtype=torch.int32, device=dev)):
            before = mod.LAUNCHES[fold]
            got = getattr(mod, fold)(Vc, ring.D, signed=signed)
            assert mod.LAUNCHES[fold] == before + 1
            assert torch.equal(got, getattr(mod, fold + "_ref")(
                Vc, ring.D, signed=signed))
        assert torch.equal(mxu_dense.fold_buckets(core, V), core.fold(V))


@pytest.mark.parametrize("B", [1, 13, 1000])
@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_model_mul_on_card(dev, name, B):
    """TModelMul.mul_t and RingModel crt / icrt / coeff_mul on the card
    equal the CPU twin path bit for bit, with a ragged batch; K3 or
    bb_fold_end runs 3 times a mul_t, 2 a square_t."""
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.rings import get_ring

    ring, cpu = get_ring(name, device=dev), get_ring(name, device="cpu")
    rng = np.random.default_rng(B)
    a, b = (ring.field.rand((B, ring.D), rng, dev) for _ in range(2))
    tm, tc = TModelMul(ring), TModelMul(cpu)
    counts = {"goldilocks": (K.LAUNCHES, "fold_end"),
              "babybear": (KB.LAUNCHES, "bb_fold_end")}.get(name)
    before = counts[0][counts[1]] if counts else 0
    got = tm.mul_t(tm.to_t(a), tm.to_t(b))
    sq = tm.square_t(tm.to_t(a))
    torch.cuda.synchronize()
    if counts:
        assert counts[0][counts[1]] - before == 5
    want = tc.mul_t(tc.to_t(a.cpu()), tc.to_t(b.cpu()))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert torch.equal(sq.cpu(), tc.square_t(tc.to_t(a.cpu())))
    assert torch.equal(ring.crt(a).cpu(), cpu.crt(a.cpu()))
    assert torch.equal(ring.crt(a).cpu(), cpu.crt_staged(a.cpu()))
    assert torch.equal(ring.icrt(ring.crt(a)), a)
    assert torch.equal(tm.from_t(got).cpu(), cpu.coeff_mul(a.cpu(), b.cpu()))
    f1 = tm.precompute_t(tm.to_t(b[:1]))
    assert torch.equal(tm.mul_cached_t(tm.to_t(a), f1).cpu(),
                       tc.mul_cached_t(tc.to_t(a.cpu()),
                                       tc.precompute_t(tc.to_t(b[:1].cpu()))))
    prod = tm.from_t(got)
    for r in range(min(B, 2)):      # against the integer spec
        assert [int(v) for v in ring.decode(prod[r])] == ring.spec.coeff_mul(
            [int(v) for v in ring.decode(a[r])],
            [int(v) for v in ring.decode(b[r])]), r
    if B >= 13:
        n, m = 3, B
        A = ring.field.rand((ring.D, n, m), rng, dev)
        x = ring.field.rand((ring.D, 2, m), rng, dev)
        full = tm.matvec_t(A, x)
        assert torch.equal(tm.matvec_t(A, x, block=4), full)
        assert torch.equal(full.cpu(), tc.matvec_t(A.cpu(), x.cpu()))
        # c[0, 0]: the spec's slot products summed in Python ints
        Ai, xi = (ring.decode(v[:, 0].transpose(0, 1)) for v in (A, x))
        acc = [0] * ring.D
        for j in range(m):
            p_ = ring.spec.ntt_mul([int(v) for v in Ai[j]],
                                   [int(v) for v in xi[j]])
            acc = [(u + w) % ring.q for u, w in zip(acc, p_)]
        assert [int(v) for v in ring.decode(full[:, 0, 0])] == acc


# -- the Goldilocks slot-product kernels (ops/slot.py) ------------------


def _gl_tables():
    """The Goldilocks ring's slot tables, on the CPU (the kernels read
    only their nr)."""
    from stark_rings_tpu_torch.rings import get_ring

    return SL.ext_tables(get_ring("goldilocks", device="cpu"))


def _slot_words(rng, shape, dev, fill=None):
    x = (np.full(shape, fill, dtype=np.uint64) if fill is not None
         else rng.integers(0, Q, shape, dtype=np.uint64))
    return to_torch(x, dev)


@pytest.mark.parametrize("Ba,Bb", [(65536, 65536), (16 * 1024, 1), (128, 1),
                                   (13, 13), (13, 1), (1, 1)])
@pytest.mark.parametrize("fill", [None, Q - 1], ids=["random", "q-1"])
def test_slot_mul_matches_twin(dev, Ba, Bb, fill):
    """slot_mul at the main path's shapes (mul_t's B = 65,536, the fold
    challenge's [8, 3, 16 x 1,024] and [8, 3, 128] against a batch-1
    operand), ragged ones (V = 1), and at q - 1: one launch, the twin's
    bits."""
    t, rng = _gl_tables(), np.random.default_rng(Ba + Bb)
    a = _slot_words(rng, (8, 3, Ba), dev, fill)
    b = _slot_words(rng, (8, 3, Bb), dev, fill)
    before = SL.LAUNCHES["slot_mul"]
    got = SL.slot_mul(a, b, t)
    torch.cuda.synchronize()
    assert SL.LAUNCHES["slot_mul"] - before == 1
    assert torch.equal(got.cpu(), SL.slot_mul_ref(a.cpu(), b.cpu(), t))


def test_slot_mul_unaligned(dev):
    """Operands 8 bytes off a 16-byte boundary take the one-word path."""
    t, rng = _gl_tables(), np.random.default_rng(3)
    buf = _slot_words(rng, (2, 8 * 3 * 64 + 1), dev)
    a, b = (buf[i, 1:].view(8, 3, 64) for i in range(2))
    assert a.data_ptr() % 16 == 8
    got = SL.slot_mul(a, b, t)
    assert torch.equal(got.cpu(), SL.slot_mul_ref(a.cpu(), b.cpu(), t))


@pytest.mark.parametrize("n,W,m", [(8, 16, 8192), (8, 16, 1), (8, 16, 7),
                                   (8, 16, 8193), (3, 1, 8192), (3, 2, 65536),
                                   (9, 17, 300)])
def test_slot_matvec_matches_twin(dev, n, W, m):
    """slot_matvec at the commit's shape (n = 8, M = 8,192, W = 16), at
    ragged M, n and W and at M = 65,536: one launch, the (blocked) twin's
    bits, the same again on a second call (the tickets left at 0)."""
    t, rng = _gl_tables(), np.random.default_rng(n + W + m)
    A = _slot_words(rng, (8, 3, n, m), dev)
    x = _slot_words(rng, (8, 3, W, m), dev)
    before = SL.LAUNCHES["slot_matvec"]
    got = SL.slot_matvec(A, x, t)
    again = SL.slot_matvec(A, x, t)
    torch.cuda.synchronize()
    assert SL.LAUNCHES["slot_matvec"] - before == 2
    want = SL.slot_matvec_ref(A.cpu(), x.cpu(), t, block=1024)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)


@pytest.mark.parametrize("one_chunk", [False, True], ids=["chunks", "one"])
@pytest.mark.parametrize("m", [8192, 65536])
def test_slot_matvec_q_minus_1(dev, m, one_chunk, monkeypatch):
    """Every operand q - 1 (every product 1 - 2q + q^2, the high words
    and carries at their largest): c = (m + 2m nr, 2m + m nr, 3m) mod q
    in every slot and pair; with one chunk a thread adds 3 x 65,536
    products into each 192-bit sum."""
    if one_chunk:
        monkeypatch.setattr(SL, "MV_BLOCKS", 1)
    t = _gl_tables()
    nr = t.nr
    A = torch.full((8, 3, 8, m), Q - 1 - 2**64, dtype=torch.int64,
                   device=dev)
    x = torch.full((8, 3, 16, m), Q - 1 - 2**64, dtype=torch.int64,
                   device=dev)
    assert SL.matvec_plan(8, 8, 16, m).chunks > 1 or one_chunk
    got = SL.slot_matvec(A, x, t).cpu().view(8, 3, 16, 8)
    want = [(m + 2 * m * nr) % Q, (2 * m + m * nr) % Q, 3 * m % Q]
    for k in range(3):
        assert np.array_equal(got[:, k].numpy().view(np.uint64),
                              np.full((8, 16, 8), want[k], dtype=np.uint64))


def test_slot_launch_counts(dev, monkeypatch):
    """A goldilocks FoldingStep.step is 2 slot_mul launches (the
    challenge's two products) and 1 slot_matvec (the commit), a mul_t 1
    slot_mul, a babybear mul_t none; no twin runs on the card; each
    equals the CPU path."""
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    def refuse(*args, **kw):
        raise AssertionError("a twin ran on the card")

    twins = (SL.slot_mul_ref, SL.slot_matvec_ref)
    for name in ("slot_mul_ref", "slot_matvec_ref"):
        monkeypatch.setattr(SL, name, refuse)
    ring, cpu = get_ring("goldilocks", device=dev), get_ring("goldilocks",
                                                             device="cpu")
    fs = FoldingStep(ring, n_rows=8, wit_len=64)
    fc = FoldingStep(cpu, n_rows=8, wit_len=64)
    c, ins = _step_inputs(fs, np.random.default_rng(9), W=16)
    torch.cuda.synchronize()
    before = dict(SL.LAUNCHES)
    out = fs.step(c, *ins)
    torch.cuda.synchronize()
    assert {k: SL.LAUNCHES[k] - before[k] for k in before} == {
        "slot_mul": 2, "slot_matvec": 1}
    monkeypatch.setattr(SL, "slot_mul_ref", twins[0])
    monkeypatch.setattr(SL, "slot_matvec_ref", twins[1])
    want = fc.step({"Agt": c["Agt"].cpu()}, *(x.cpu() for x in ins))
    for key, val in want.items():
        assert torch.equal(out[key].cpu(), val), key
    for name, launches in (("goldilocks", 1), ("babybear", 0)):
        r = get_ring(name, device=dev)
        tm = TModelMul(r)
        rng = np.random.default_rng(1)
        a, b = (r.field.rand((r.D, 4096), rng, dev) for _ in range(2))
        before = dict(SL.LAUNCHES)
        tm.mul_t(a, b)
        torch.cuda.synchronize()
        assert SL.LAUNCHES["slot_mul"] - before["slot_mul"] == launches
        assert SL.LAUNCHES["slot_matvec"] == before["slot_matvec"]


def _step_inputs(fs, rng, W):
    ring = fs.ring
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    s0, s1 = fs.rand_witness(W, rng), fs.rand_witness(W, rng)
    c0, c1 = (fs.tm.to_t(ring.rand_ntt((W, fs.n), rng)).contiguous()
              for _ in range(2))
    return c, (s0, s1, c0, c1, rt)


# -- the fold step's digit kernels (ops/digits.py) -----------------------


def _digit_coeff(ring, base, W, L, rng):
    """[D, W, L] storage words; witness w of class w mod 4: 0 uniform over
    [0, q) with the edge values 0, 1, b/2, b/2 + 1, (q - 1)/2, (q + 1)/2,
    q - 1 (and their neighbours) planted first; 1 small non-negative
    values in psi's range (one digit at base 256: passes psi); 2 the same
    with one value of D planted (fails psi at base 256); 3 small negative
    values (negative digits, which fail psi on these rings)."""
    D, q, h = ring.D, ring.q, (ring.q - 1) // 2
    vals = np.zeros((D, W, L), dtype=np.uint64)
    edges = np.array([e % q for e in (
        0, 1, q - 1, base // 2, base // 2 + 1, base // 2 - 1, h, h + 1,
        h - 1, q - base // 2, q - base // 2 - 1, q - 2, base, q - base)],
        dtype=np.uint64)
    for w in range(W):
        cls = w % 4
        if cls == 0:
            col = rng.integers(0, q, D * L, dtype=np.uint64)
            col[:len(edges)] = edges[:D * L]
            vals[:, w] = col.reshape(D, L)
        elif cls in (1, 2):
            vals[:, w] = rng.integers(0, D // 2, (D, L))
            if cls == 2:
                vals[D // 2, w, L // 2] = D
        else:
            vals[:, w] = np.uint64(q) - rng.integers(1, 6, (D, L)).astype(
                np.uint64)
    return ring.field.from_uint(vals, "cpu")


def _digits_both(ring, coeff, base, k, bound, psi):
    """(kernel's outputs, twin's outputs) as (dt, ok_l2, ok_psi or None),
    and the kernel's launches."""
    from stark_rings_tpu_torch.ops import digits as DG

    name = ("step_digits" if ring.field.name == "goldilocks"
            else "bb_step_digits")
    torch.cuda.synchronize()
    before = DG.LAUNCHES[name]
    dt, ok_l2, fails = DG.step_digits(ring, coeff, base, k, bound, psi)
    torch.cuda.synchronize()
    launched = DG.LAUNCHES[name] - before
    got = (dt, ok_l2, DG.check_psi(ring, dt, fails) if psi else None)
    rdt, rok, _ = DG.step_digits_ref(ring, coeff, base, k, bound)
    want = (rdt, rok, DG.check_psi(ring, rdt, None) if psi else None)
    return got, want, launched


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("W,L,base", [(1, 300, 256), (16, 1000, 256),
                                      (5, 257, 6), (4, 64, 2)])
@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_step_digits_matches_twin(dev, name, W, L, base, psi):
    """The digit kernel against the twin (decompose, l2_check and
    psi_range_check_batched in torch ops on the card) on every word of
    dt, ok_l2 and ok_psi: the field's edge values, psi failures planted
    and negative, L not a multiple of the block, W = 1 and 16, a base that
    is not a power of two and k not a multiple of a 16-byte store; bounds
    at a witness's exact sum, one below it, and at 2^64 and past it; one
    launch a call."""
    from stark_rings_tpu_torch.decomp.norms import (l2_norm_squared_words,
                                                    words_to_int)
    from stark_rings_tpu_torch.ops import digits as DG
    from stark_rings_tpu_torch.rings import get_ring
    from stark_rings_tpu_torch.spec.decomp import decomposition_max_length

    ring = get_ring(name, device=dev)
    k = decomposition_max_length(ring.q, base)
    coeff = _digit_coeff(ring, base, W, L, np.random.default_rng(W * L)).to(
        dev)
    dt, _, _ = DG.step_digits_ref(ring, coeff, base, k, 0)
    words = l2_norm_squared_words(ring.field, dt, axis=(0, 2)).cpu()
    sums = [words_to_int(words[w]) for w in range(W)]
    for bound in (sums[-1], sums[-1] - 1, 1 << 64, (1 << 64) - 1, 1 << 70):
        got, want, launched = _digits_both(ring, coeff, base, k, bound, psi)
        assert launched == 1
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1]), bound
        assert got[1].tolist() == [s <= bound for s in sums]
        if psi:
            assert torch.equal(got[2], want[2])
            if W >= 4 and base == 256:
                assert got[2].tolist()[:4] == [False, True, False, False]


@pytest.mark.parametrize("name,k", [("goldilocks", 8), ("babybear", 4)])
def test_step_digits_at_the_cells_shape(dev, name, k):
    """At the fold cells' shape ([D, 16, 16,384], base 256, psi on) the
    kernel equals the twin word for word in one launch, and the cell's
    FoldingStep.step launches it once."""
    from stark_rings_tpu_torch.ops import digits as DG
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    ring = get_ring(name, device=dev)
    coeff = _digit_coeff(ring, 256, 16, 16384,
                         np.random.default_rng(k)).to(dev)
    got, want, launched = _digits_both(ring, coeff, 256, k, 48_000_000, True)
    assert launched == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fs = FoldingStep(ring, 8, 16384, 256, k=k, l2_bound_sq=48_000_000,
                     psi_check=True)
    c, ins = _step_inputs(fs, np.random.default_rng(k + 1), W=16)
    torch.cuda.synchronize()
    before = dict(DG.LAUNCHES)
    fs.step(c, *ins)
    torch.cuda.synchronize()
    assert {n: DG.LAUNCHES[n] - before[n] for n in before} == {
        "step_digits": name == "goldilocks",
        "bb_step_digits": name == "babybear"}


def test_step_digits_sums_past_2_63(dev):
    """Goldilocks sums at and past 2^63 (base 2^20: every digit of
    magnitude 2^19 but the top one, 24 x 466,100 coefficients): the u64
    sum is exact and compared unsigned, as the twin's words are."""
    from stark_rings_tpu_torch.rings import get_ring

    ring = get_ring("goldilocks", device=dev)
    base, k, L = 1 << 20, 4, 466_100
    v = (1 << 19) * (1 + (1 << 20) + (1 << 40))
    coeff = torch.full((24, 1, L), v, dtype=torch.int64, device=dev)
    total = 24 * L * 3 * (1 << 38)
    assert (1 << 63) < total < 1 << 64
    for bound, ok in ((total, True), (total - 1, False),
                      ((1 << 63) - 1, False), (1 << 64, True)):
        got, want, launched = _digits_both(ring, coeff, base, k, bound, False)
        assert launched == 1
        assert torch.equal(got[0], want[0])
        assert got[1].tolist() == want[1].tolist() == [ok]


# -- the BabyBear slot-product kernels (ops/slot_bb.py) ------------------


def _bb_tables(dev="cpu"):
    """The BabyBear ring's slot tables (the kernels read only their nr;
    the twins on the card take them on the card)."""
    from stark_rings_tpu_torch.rings import get_ring

    return SL.ext_tables(get_ring("babybear", device=dev))


def _bb_words(rng, shape, dev, fill=None):
    x = (np.full(shape, fill, dtype=np.uint32) if fill is not None
         else rng.integers(0, BABYBEAR.q, shape, dtype=np.uint32))
    return to_torch_u32(x, dev)


@pytest.mark.parametrize("Ba,Bb", [(16 * 16384, 1), (16 * 8, 1),
                                   (16384, 16384), (13, 13), (13, 1), (1, 1),
                                   (6, 6)])
@pytest.mark.parametrize("fill", [None, 0, BABYBEAR.q - 1],
                         ids=["random", "0", "q-1"])
def test_bb_slot_mul_matches_twin(dev, Ba, Bb, fill):
    """bb_slot_mul at the BabyBear fold's challenge shapes (s1 [8, 9, 16 x
    16,384] and c1 [8, 9, 16 x 8] by a batch-1 operand), at a model
    multiply's, at ragged batches (one word a thread), at words 0 and
    q - 1: one launch, the twin's bits."""
    t, tc = _bb_tables(), _bb_tables(dev)
    rng = np.random.default_rng(Ba + Bb)
    a = _bb_words(rng, (8, 9, Ba), dev, fill)
    b = _bb_words(rng, (8, 9, Bb), dev, fill)
    before = SB.LAUNCHES["bb_slot_mul"]
    got = SB.bb_slot_mul(a, b, t)
    torch.cuda.synchronize()
    assert SB.LAUNCHES["bb_slot_mul"] - before == 1
    assert got.dtype == torch.int32 and got.shape == (72, Ba)
    assert torch.equal(got, SB.bb_slot_mul_ref(a, b, tc))


def test_bb_slot_mul_unaligned(dev):
    """Operands 4 bytes off a 16-byte boundary take the one-word path."""
    t, rng = _bb_tables(), np.random.default_rng(3)
    buf = _bb_words(rng, (2, 8 * 9 * 64 + 1), dev)
    a, b = (buf[i, 1:].view(8, 9, 64) for i in range(2))
    assert a.data_ptr() % 16 != 0
    got = SB.bb_slot_mul(a, b, t)
    assert torch.equal(got.cpu(), SB.bb_slot_mul_ref(a.cpu(), b.cpu(), t))


@pytest.mark.parametrize("n,W,m", [(8, 16, 65536), (8, 16, 1), (8, 16, 7),
                                   (8, 16, 1025), (3, 1, 8192),
                                   (3, 2, 65536), (9, 17, 300)])
def test_bb_slot_matvec_matches_twin(dev, n, W, m):
    """bb_slot_matvec at the BabyBear commit's shape (N = 8, n = 8, W =
    16, M = 65,536) and at ragged n, W and m: one launch a call, the
    blocked twin's bits, the same again on a second call (the tickets
    left at 0)."""
    t, tc = _bb_tables(), _bb_tables(dev)
    rng = np.random.default_rng(n + W + m)
    A = _bb_words(rng, (8, 9, n, m), dev)
    x = _bb_words(rng, (8, 9, W, m), dev)
    before = SB.LAUNCHES["bb_slot_matvec"]
    got = SB.bb_slot_matvec(A, x, t)
    again = SB.bb_slot_matvec(A, x, t)
    torch.cuda.synchronize()
    assert SB.LAUNCHES["bb_slot_matvec"] - before == 2
    assert got.dtype == torch.int32 and got.shape == (72, W, n)
    assert torch.equal(got, SB.bb_slot_matvec_ref(A, x, tc, block=1024))
    assert torch.equal(again, got)


@pytest.mark.parametrize("one_chunk", [False, True], ids=["chunks", "one"])
@pytest.mark.parametrize("fills", [(BABYBEAR.q - 1, BABYBEAR.q - 1),
                                   (0, BABYBEAR.q - 1), (0, 0)],
                         ids=["q-1", "0,q-1", "0"])
def test_bb_slot_matvec_extremes(dev, fills, one_chunk, monkeypatch):
    """Every word q - 1 (every u64 group and 96-bit sum at its largest),
    or 0, at the commit's shape: many chunks (two launches in a row, the
    tickets left at 0), or one (a thread adds 65,536 x 81 products into
    its 17 sums); the twin's bits."""
    if one_chunk:
        monkeypatch.setattr(SL, "MV_BLOCKS", 1)
    t, tc = _bb_tables(), _bb_tables(dev)
    m = 65536
    plan = SL.matvec_plan(8, 8, 16, m, 9, partial_bytes=4)
    assert (plan.chunks == 1) == one_chunk
    A = torch.full((8, 9, 8, m), fills[0], dtype=torch.int32, device=dev)
    x = torch.full((8, 9, 16, m), fills[1], dtype=torch.int32, device=dev)
    got = SB.bb_slot_matvec(A, x, t)
    again = SB.bb_slot_matvec(A, x, t)
    want = SB.bb_slot_matvec_ref(A[..., :1].contiguous(),
                                 x[..., :1].contiguous(), tc)
    want = ((want.to(torch.int64) & 0xFFFFFFFF) * m % BABYBEAR.q).to(
        torch.int32)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_bb_slot_launch_counts(dev, monkeypatch):
    """A babybear FoldingStep.step is 2 bb_slot_mul launches (the
    challenge's two products) and 1 bb_slot_matvec (the commit), a
    babybear mul_t 1 bb_slot_mul; no twin and no torch-op slot product
    runs on the card; the Goldilocks kernels launch nothing; each output
    equals the CPU path."""
    from stark_rings_tpu_torch.ops import model_mul as MM
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    def refuse(*args, **kw):
        raise AssertionError("a twin ran on the card")

    ext_mul = MM.ext_mul

    def cpu_only(f, t, a, b):
        assert a.device.type == "cpu", "ext_mul ran on the card"
        return ext_mul(f, t, a, b)

    twins = (SB.bb_slot_mul_ref, SB.bb_slot_matvec_ref)
    for name in ("bb_slot_mul_ref", "bb_slot_matvec_ref"):
        monkeypatch.setattr(SB, name, refuse)
    monkeypatch.setattr(MM, "ext_mul", cpu_only)
    ring, cpu = get_ring("babybear", device=dev), get_ring("babybear",
                                                           device="cpu")
    fs = FoldingStep(ring, n_rows=8, wit_len=64)
    fc = FoldingStep(cpu, n_rows=8, wit_len=64)
    c, ins = _step_inputs(fs, np.random.default_rng(9), W=16)
    torch.cuda.synchronize()
    before, gl = dict(SB.LAUNCHES), dict(SL.LAUNCHES)
    out = fs.step(c, *ins)
    torch.cuda.synchronize()
    assert {k: SB.LAUNCHES[k] - before[k] for k in before} == {
        "bb_slot_mul": 2, "bb_slot_matvec": 1}
    assert SL.LAUNCHES == gl
    monkeypatch.setattr(SB, "bb_slot_mul_ref", twins[0])
    monkeypatch.setattr(SB, "bb_slot_matvec_ref", twins[1])
    want = fc.step({"Agt": c["Agt"].cpu()}, *(x.cpu() for x in ins))
    for key, val in want.items():
        assert torch.equal(out[key].cpu(), val), key
    tm = TModelMul(ring)
    rng = np.random.default_rng(1)
    a, b = (ring.field.rand((ring.D, 4096), rng, dev) for _ in range(2))
    before = dict(SB.LAUNCHES)
    got = tm.mul_t(a, b)
    torch.cuda.synchronize()
    assert SB.LAUNCHES["bb_slot_mul"] - before["bb_slot_mul"] == 1
    assert SB.LAUNCHES["bb_slot_matvec"] == before["bb_slot_matvec"]
    assert torch.equal(got.cpu(), TModelMul(cpu).mul_t(a.cpu(), b.cpu()))


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_folding_step_on_card(dev, name, psi):
    """FoldingStep.step on the card equals the step on the CPU (the fold
    kernels' twins) output by output, at a ragged witness batch and with
    a forced commit block; K3 (goldilocks) or bb_fold_end (babybear) runs
    twice a step: one ICRT of the folded witness, one CRT of the
    digits; witness 0 in Python ints."""
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    ring, cpu = get_ring(name, device=dev), get_ring(name, device="cpu")
    base = 4 if name == "frog" else 256
    fs = FoldingStep(ring, n_rows=3, wit_len=5, base=base, psi_check=psi)
    fc = FoldingStep(cpu, n_rows=3, wit_len=5, base=base, psi_check=psi)
    c, ins = _step_inputs(fs, np.random.default_rng(31), W=3)
    counts = {"goldilocks": (K.LAUNCHES, "fold_end"),
              "babybear": (KB.LAUNCHES, "bb_fold_end")}.get(name)
    torch.cuda.synchronize()
    before = counts[0][counts[1]] if counts else 0
    out = fs.step(c, *ins)
    torch.cuda.synchronize()
    if counts:
        assert counts[0][counts[1]] - before == 2
    want = fc.step({"Agt": c["Agt"].cpu()}, *(x.cpu() for x in ins))
    assert sorted(out) == sorted(want)
    for key, val in want.items():
        assert out[key].device.type == "cuda"
        assert torch.equal(out[key].cpu(), val), key
    d_ntt = fs.tm.crt_t(out["digits"])
    assert torch.equal(fs.commit(c, d_ntt, block=2), out["cd"])
    _hold_witness_in_ints(fs, c, out, 0)


def _hold_witness_in_ints(fs, c, out, w):
    """Witness ``w`` of a step's outputs in Python ints: its digits
    recompose to the ICRT of its folded s, ``ok_l2`` is the exact norm
    against the bound, ``cd``'s row 0 the spec's slot products summed,
    ``ok_psi`` the host psi check of its digit values."""
    from stark_rings_tpu_torch.decomp.norms import l2_norm_squared
    from stark_rings_tpu_torch.rings.monomial import psi_range_check
    from stark_rings_tpu_torch.spec.decomp import recompose_ints, to_signed

    ring, tm, q = fs.ring, fs.tm, fs.ring.q
    coeff = ring.decode(ring.icrt(tm.from_t(out["s"])[w]))      # [L, D]
    dig = tm.from_t(out["digits"])[w]                            # [M, D]
    di = ring.decode(dig).reshape(fs.L, fs.k, ring.D)
    for l in range(fs.L):
        for i in range(ring.D):
            v = recompose_ints([to_signed(int(x), q) for x in di[l, :, i]],
                               fs.base)
            assert v % q == int(coeff[l, i]), (l, i)
    norm = l2_norm_squared(ring.field, dig)
    assert bool(out["ok_l2"][w]) == (norm <= fs.l2_bound_sq)
    A0 = ring.decode(tm.from_t(c["Agt"])[0])                     # [M, D]
    dn = ring.decode(ring.crt(dig))
    acc = [0] * ring.D
    for j in range(fs.M):
        p_ = ring.spec.ntt_mul([int(v) for v in A0[j]],
                               [int(v) for v in dn[j]])
        acc = [(x + y) % q for x, y in zip(acc, p_)]
    assert [int(v) for v in ring.decode(tm.from_t(out["cd"])[w, 0])] == acc
    if "ok_psi" in out:
        vals = {int(v) for v in ring.decode(dig).reshape(-1)}
        assert bool(out["ok_psi"][w]) == all(psi_range_check(ring, v)
                                             for v in vals)


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_folding_tree_on_card(dev, name):
    """FoldingTree prove and verify on the card: the same levels as on
    the CPU, accepted, and a tampered digit commitment rejected."""
    from stark_rings_tpu_torch.protocol import FoldingTree
    from stark_rings_tpu_torch.rings import get_ring

    ring, cpu = get_ring(name, device=dev), get_ring(name, device="cpu")
    ft, fc = FoldingTree(ring, 2, 3), FoldingTree(cpu, 2, 3)
    rng = np.random.default_rng(32)
    c = ft.init_tables(rng)
    wt = ft.rand_witnesses(8, rng)
    ct = ft.commit_witnesses(c, wt)
    rts = ft.precompute_challenges([ring.rand_coeff((), rng)
                                    for _ in range(3)])
    levels, rw, rc = ft.prove(c, wt, ct, rts)
    assert ft.verify(c, wt, ct, levels, rts)
    cc = {k: v.cpu() for k, v in c.items()}
    lv_c, rw_c, _ = fc.prove(cc, wt.cpu(), ct.cpu(), [r.cpu() for r in rts])
    assert torch.equal(rw.cpu(), rw_c)
    for got, want in zip(levels, lv_c):
        for key in want:
            assert torch.equal(got[key].cpu(), want[key]), key
    bad = [dict(o) for o in levels]
    cd = bad[0]["cd"].clone()
    cd.view(-1)[0] = ring.field.add(cd.view(-1)[:1],
                                    ring.field.const(1, dev))[0]
    bad[0]["cd"] = cd
    assert not ft.verify(c, wt, ct, bad, rts)


# -- the 252-bit stark prime: S1-S3 and the paths on them -------------------


def _stark_edges(dev):
    from stark_rings_tpu_torch.fields import STARK

    q = STARK.q
    vals = [0, 1, 2, q - 1, q - 2, (1 << 256) % q, q, q + 1, (1 << 256) - 1,
            (1 << 255) + 12345]
    return torch.from_numpy(STARK.limbs_np(vals).view(np.int32)).to(dev)


def test_stark_kernels_match_twins(dev):
    """S1 (stark_mul) and S2 (stark_add, stark_sub) bit-equal to their
    twins on random limbs in [0, q), on every pair of edge values (q's
    own limbs and 2^256 - 1 among them) and on broadcast operands; S3
    (limb_fold) on random and full-range buckets in both schemes and both
    output layouts; one launch a call."""
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.ops import stark as S

    rng = np.random.default_rng(40)
    ev = _stark_edges(dev)
    ne = ev.shape[0]
    x = STARK.rand((5000,), rng, dev)
    y = STARK.rand((5000,), rng, dev)
    x[:ne * ne] = ev.repeat_interleave(ne, 0)
    y[:ne * ne] = ev.repeat(ne, 1)
    tab = STARK.rand((7, 9), rng, dev)
    big = STARK.rand((3, 7, 9), rng, dev)
    for op in ("mul", "add", "sub"):
        kern = getattr(S, "stark_" + op)
        twin = getattr(S, f"stark_{op}_ref")
        for a, b in ((x, y), (big, tab), (tab, big), (big, ev[5]),
                     (big[:, None], tab[None, :1])):
            before = S.LAUNCHES["stark_" + op]
            got = kern(a, b)
            assert S.LAUNCHES["stark_" + op] - before == 1
            assert got.device.type == "cuda"
            assert torch.equal(got, twin(a, b)), (op, a.shape, b.shape)
        assert torch.equal(kern(x.cpu(), y.cpu()), twin(x, y).cpu())
    for signed, K_ in ((False, 32), (True, 33)):
        for R, cols in ((16, 4096), (64, 300), (3, 1)):
            V = torch.from_numpy(rng.integers(-2**31, 2**31, (K_ * R, cols))
                                 .astype(np.int32)).to(dev)
            for tr in (False, True):
                before = S.LAUNCHES["limb_fold"]
                got = S.limb_fold(V, R, signed=signed, transpose_out=tr)
                assert S.LAUNCHES["limb_fold"] - before == 1
                assert torch.equal(got, S.limb_fold_ref(
                    V, R, signed=signed, transpose_out=tr)), (signed, R, tr)
    with pytest.raises(TypeError):
        S.stark_mul(x.to(torch.int64), y)
    with pytest.raises(ValueError):
        S.limb_fold(torch.zeros((31, 8), dtype=torch.int32, device=dev), 1,
                    signed=False)


def test_stark_step_launches_match_twins_at_the_cells_shape(dev,
                                                            monkeypatch):
    """Every S1-S3 launch of the stark16 cell's call (the challenge's
    precompute and a step at n = 8, L = 16,384, W = 16, base 2^16, k = 16,
    psi on) equals its twin word for word at the shape the step gives it:
    the commit blocks' broadcast pairs, the challenge's [16, 1, 1, 8]
    operand, the words read at row mod b_rows = 1, and the CRTs' R = 16
    folds over W L and W k L columns.  The twins run in slices (the
    result's first axis; 2^18 columns of a fold)."""
    from stark_rings_tpu_torch.ops import mxu_limb as ML
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    seen = {}
    binary, fold = S._binary, ML.limb_fold

    def checked_binary(name, twin, a, b, commutative):
        before = S.LAUNCHES[name]
        out = binary(name, twin, a, b, commutative)
        assert S.LAUNCHES[name] - before == 1, name
        ae, be = a.expand(out.shape), b.expand(out.shape)
        for i in range(out.shape[0]):
            assert torch.equal(out[i], twin(ae[i], be[i])), (
                name, tuple(a.shape), tuple(b.shape), i)
        key = (name, tuple(a.shape), tuple(b.shape))
        seen[key] = seen.get(key, 0) + 1
        return out

    def checked_fold(V, R, *, signed, transpose_out=False):
        before = S.LAUNCHES["limb_fold"]
        out = fold(V, R, signed=signed, transpose_out=transpose_out)
        assert S.LAUNCHES["limb_fold"] - before == 1
        assert not transpose_out
        for c in range(0, V.shape[1], 1 << 18):
            assert torch.equal(out[:, c:c + (1 << 18)], S.limb_fold_ref(
                V[:, c:c + (1 << 18)], R, signed=signed)), (V.shape, c)
        key = ("limb_fold", tuple(V.shape), R, signed)
        seen[key] = seen.get(key, 0) + 1
        return out

    monkeypatch.setattr(S, "_binary", checked_binary)
    monkeypatch.setattr(ML, "limb_fold", checked_fold)
    fs = FoldingStep(get_ring("stark_prime", device=dev), 8, 16384,
                     1 << 16, k=16, l2_bound_sq=4_718_592, psi_check=True)
    c, ins = _step_inputs(fs, np.random.default_rng(42), W=16)
    fs.step(c, *ins)
    torch.cuda.synchronize(dev)
    by_name = {}
    for key, n in seen.items():
        by_name[key[0]] = by_name.get(key[0], 0) + n
    assert by_name == {"stark_mul": 64, "stark_add": 11, "stark_sub": 19,
                       "limb_fold": 3}
    M, WL = 16 * 16384, 16 * 16384
    assert seen[("stark_mul", (16, 1, 8, 8192, 8), (16, 16, 1, 8192, 8))] \
        == 32
    assert seen[("stark_mul", (16, 16, 16384, 8), (16, 1, 1, 8))] == 1
    assert seen[("stark_mul", (16, 16, M, 8), (8,))] == 3
    assert seen[("limb_fold", (512, WL), 16, False)] == 1
    assert seen[("limb_fold", (512, 16 * M), 16, False)] == 1


def test_stark_kernels_carry_their_launch_names(dev):
    """Under ``torch.profiler`` each stark kernel's device name maps to
    its own launch name by the benchmark's rule (``portbench/trace.py``
    ``_hand_name``: the longest launch name its base name begins with,
    over every ``LAUNCHES`` counter of the program), so the trace
    classes S1-S3 as hand kernels."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace as tr
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.ops import stark as S

    rng = np.random.default_rng(41)
    x, y = (STARK.rand((4096,), rng, dev) for _ in range(2))
    V = torch.zeros((32 * 4, 256), dtype=torch.int32, device=dev)
    calls = {"stark_mul": lambda: S.stark_mul(x, y),
             "stark_add": lambda: S.stark_add(x, y),
             "stark_sub": lambda: S.stark_sub(x, y),
             "limb_fold": lambda: S.limb_fold(V, 4, signed=False)}
    names = set(tr.launch_counters())
    assert set(S.LAUNCHES) <= names
    for want, call in calls.items():
        call()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize(dev)
        kernels = {e.name for e in prof.events()
                   if e.device_type.name == "CUDA"
                   and not e.name.startswith(("Memcpy", "Memset"))}
        assert kernels, want
        assert {tr._hand_name(k, names) for k in kernels} == {want}, kernels


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s7"])
@pytest.mark.parametrize("N", [16, 512, 4096])
def test_stark_mxu_limb_ntt_on_card(dev, N, unsigned):
    """MxuLimbNTT on the card: mul, mul_cached (batch-B and batch-1
    states) and square bit-equal to the radix NTTContext on the card and
    to MxuLimbNTT on the CPU; six S3 folds and four S1 products a mul."""
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.ops.mxu_limb import MxuLimbNTT

    rng = np.random.default_rng(N)
    e = MxuLimbNTT(N, unsigned=unsigned, device=dev)
    ctx = NTTContext(STARK, N, device=dev)
    a, b = (STARK.rand((3, N), rng, dev) for _ in range(2))
    before = dict(S.LAUNCHES)
    got = e.mul(a, b)
    torch.cuda.synchronize()
    assert S.LAUNCHES["limb_fold"] - before["limb_fold"] == 6
    assert S.LAUNCHES["stark_mul"] - before["stark_mul"] == 4
    want = ctx.mul(a, b)
    assert torch.equal(got, want)
    assert torch.equal(e.mul_cached(a, e.precompute(b)), want)
    assert torch.equal(e.mul_cached(a, e.precompute(b[:1])),
                       ctx.mul(a, b[:1].expand(3, N, 8)))
    assert torch.equal(e.square(a), ctx.mul(a, a))
    if N <= 512:
        cpu = MxuLimbNTT(N, unsigned=unsigned, device="cpu")
        assert torch.equal(cpu.mul(a.cpu(), b.cpu()), got.cpu())
    pr = get_power_ring("stark_prime", N.bit_length() - 1, device=dev)
    assert torch.equal(pr.mxu_ctx().mul(a, b), want)
    for r in (0, 2):    # against the Python-int negacyclic product
        ai, bi = ([int(v) for v in pr.decode(x[r])] for x in (a, b))
        assert [int(v) for v in pr.decode(got[r])] == _py_negacyclic(
            ai, bi, STARK.q), r


@pytest.mark.parametrize("B", [1, 13, 1000])
def test_stark_model_mul_on_card(dev, B):
    """The D = 16 stark_prime model on the card: TModelMul.mul_t, square_t
    and mul_cached_t, RingModel crt / icrt / coeff_mul equal to the CPU
    path; mul_t of two rows equals the integer spec; three S3 folds a
    mul_t; the commit matvec_t blocked equals unblocked and the CPU."""
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.rings import get_ring

    ring, cpu = (get_ring("stark_prime", device=d) for d in (dev, "cpu"))
    f = ring.field
    rng = np.random.default_rng(B + 7)
    a, b = (f.rand((B, ring.D), rng, dev) for _ in range(2))
    tm, tc = TModelMul(ring), TModelMul(cpu)
    before = S.LAUNCHES["limb_fold"]
    got = tm.mul_t(tm.to_t(a), tm.to_t(b))
    torch.cuda.synchronize()
    assert S.LAUNCHES["limb_fold"] - before == 3
    assert torch.equal(got.cpu(), tc.mul_t(tc.to_t(a.cpu()),
                                           tc.to_t(b.cpu())))
    assert torch.equal(tm.square_t(tm.to_t(a)).cpu(),
                       tc.square_t(tc.to_t(a.cpu())))
    f1 = tm.precompute_t(tm.to_t(b[:1]))
    assert torch.equal(tm.mul_cached_t(tm.to_t(a), f1).cpu(),
                       tc.mul_cached_t(tc.to_t(a.cpu()),
                                       tc.precompute_t(tc.to_t(b[:1].cpu()))))
    assert torch.equal(ring.crt(a).cpu(), cpu.crt_staged(a.cpu()))
    assert torch.equal(ring.icrt(ring.crt(a)), a)
    assert torch.equal(tm.from_t(got), ring.coeff_mul(a, b))
    ai, bi, gi = ring.decode(a[:2]), ring.decode(b[:2]), ring.decode(
        tm.from_t(got)[:2])
    for r in range(min(B, 2)):
        assert [int(v) for v in gi[r]] == ring.spec.coeff_mul(
            [int(v) for v in ai[r]], [int(v) for v in bi[r]])
    if B >= 13:
        A = f.rand((ring.D, 3, B), rng, dev)
        x = f.rand((ring.D, 2, B), rng, dev)
        full = tm.matvec_t(A, x)
        assert torch.equal(tm.matvec_t(A, x, block=4), full)
        assert torch.equal(full.cpu(), tc.matvec_t(A.cpu(), x.cpu()))


def test_stark_step_tree_sumcheck_on_card(dev):
    """The limbed FoldingStep on the card equals the CPU step output by
    output (two S3 folds a step), with a forced commit block, and one
    witness in Python ints; a 4-leaf FoldingTree verifies and rejects a
    tampered digit commitment; the generic sumcheck prover over
    stark_prime equals the CPU proof and holds the sumcheck relations in
    Python ints."""
    from stark_rings_tpu_torch.mle.sumcheck_kernel import sumcheck_prove_many
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree
    from stark_rings_tpu_torch.rings import get_ring

    ring, cpu = (get_ring("stark_prime", device=d) for d in (dev, "cpu"))
    f = ring.field
    fs = FoldingStep(ring, n_rows=3, wit_len=5, base=1 << 16)
    fc = FoldingStep(cpu, n_rows=3, wit_len=5, base=1 << 16)
    c, ins = _step_inputs(fs, np.random.default_rng(33), W=3)
    before = S.LAUNCHES["limb_fold"]
    out = fs.step(c, *ins)
    torch.cuda.synchronize()
    assert S.LAUNCHES["limb_fold"] - before == 2
    want = fc.step({"Agt": c["Agt"].cpu()}, *(x.cpu() for x in ins))
    assert sorted(out) == sorted(want)
    for key, val in want.items():
        assert torch.equal(out[key].cpu(), val), key
    assert torch.equal(fs.commit(c, fs.tm.crt_t(out["digits"]), block=7),
                       out["cd"])
    _hold_witness_in_ints(fs, c, out, 2)
    ft = FoldingTree(ring, 2, 2, base=1 << 16, psi_check=False)
    rng = np.random.default_rng(34)
    ct = ft.init_tables(rng)
    wt = ft.rand_witnesses(4, rng)
    cw = ft.commit_witnesses(ct, wt)
    rts = ft.precompute_challenges([ring.rand_coeff((), rng)
                                    for _ in range(2)])
    levels, _, _ = ft.prove(ct, wt, cw, rts)
    assert ft.verify(ct, wt, cw, levels, rts)
    bad = [dict(o) for o in levels]
    bad[0]["cd"] = f.add(bad[0]["cd"], f.ones((), dev))
    assert not ft.verify(ct, wt, cw, bad, rts)
    tables = [f.rand((1 << 10,), rng, dev) for _ in range(3)]
    chal = f.rand((10,), rng, dev)
    msgs, finals = sumcheck_prove_many(tables, chal, field="stark_prime")
    m_c, f_c = sumcheck_prove_many([t.cpu() for t in tables], chal.cpu(),
                                   field="stark_prime")
    assert msgs.shape == (10, 4, 8) and torch.equal(msgs.cpu(), m_c)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(finals, f_c))
    _py_check_proof(f, tables, chal, msgs, finals)


@pytest.mark.parametrize("b_shape", [(8, 64, 128), (64, 128), (1, 64, 128),
                                     (128,), (1,)],
                         ids=["n", "table", "batch1", "row", "one"])
def test_pointwise_kernel_broadcast_matches_twin(dev, b_shape):
    """pointwise_mul with b broadcast over a's leading axes: one launch,
    read at i mod b.numel(), equal to the twin's torch broadcast."""
    rng = np.random.default_rng(len(b_shape))
    a = to_torch(rng.integers(0, Q, (8, 64, 128), dtype=np.uint64), dev)
    b = to_torch(rng.integers(0, Q, b_shape, dtype=np.uint64), dev)
    before = K.LAUNCHES["pointwise_mul"]
    got = K.pointwise_mul(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["pointwise_mul"] == before + 1
    assert torch.equal(got, K.pointwise_mul_ref(a, b))
    assert torch.equal(got.cpu(), K.pointwise_mul_ref(a.cpu(), b.cpu()))


@pytest.mark.parametrize("N,P", [(1 << 10, "single"), (1 << 12, 4),
                                 (1 << 16, 2), (1 << 16, "single")])
def test_goldilocks_fourstep_runs_on_kernels(dev, N, P):
    """The Goldilocks four-step on the card: 6 ntt_tile launches a shard
    a mul, 7 pointwise_mul (4 with K8, which takes the twiddles), no
    NTTContext transform, and the product of the radix engine and of the
    CPU path."""
    from stark_rings_tpu_torch import (GoldilocksKernelNTT, ShardedNTT,
                                       make_mesh)
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.ops import ntt as NT

    f = GOLDILOCKS
    rng = np.random.default_rng(N)
    a, b = f.rand((2, N), rng, dev), f.rand((2, N), rng, dev)
    want = GoldilocksKernelNTT(N, device=dev).mul(a, b)
    calls = []
    orig = NT.NTTContext.forward
    NT.NTTContext.forward = lambda self, x: calls.append(1) or orig(self, x)
    try:
        runs = []
        if P == "single":
            fs = get_power_ring("goldilocks", N.bit_length() - 1,
                                device=dev).fourstep_ctx()
            runs.append((1, 7, lambda: fs.mul(a, b)))
        else:
            mesh = make_mesh(P, device=dev)
            for exchange in ("xla", "pallas"):
                sn = ShardedNTT("goldilocks", N, P, exchange=exchange)
                cspec, _ = sn.shard_specs(1)
                sa = sn.shard(sn.to_matrix(a), cspec, mesh)
                sb = sn.shard(sn.to_matrix(b), cspec, mesh)
                mul = sn.make_fns(mesh, batch_ndim=1)[2]
                runs.append((P, 4 if exchange == "pallas" else 7,
                             lambda sn=sn, mul=mul, sa=sa, sb=sb:
                             sn.from_matrix(sn.gather(mul(sa, sb), cspec,
                                                      dev))))
        for shards, products, run in runs:
            tiles, pw = G.LAUNCHES["ntt_tile"], K.LAUNCHES["pointwise_mul"]
            got = run()
            torch.cuda.synchronize()
            assert G.LAUNCHES["ntt_tile"] - tiles == 6 * shards
            assert K.LAUNCHES["pointwise_mul"] - pw == products * shards
            assert torch.equal(got, want)
    finally:
        NT.NTTContext.forward = orig
    assert not calls
    if P == "single":
        cpu = get_power_ring("goldilocks", N.bit_length() - 1,
                             device="cpu").fourstep_ctx()
        assert torch.equal(cpu.mul(a.cpu(), b.cpu()), want.cpu())


# -- the sharded layer on P = 8 shards of the card ----------------------------


@pytest.fixture
def no_twins(monkeypatch):
    """Make the K5, K7, model-fold, slot-product and digit-stage twins
    (Goldilocks and BabyBear) fail if the card route calls them."""
    from stark_rings_tpu_torch.ops import digits as DG
    from stark_rings_tpu_torch.ops import stark as ST

    def refuse(*args, **kw):
        raise AssertionError("a twin ran on the card")

    for mod, name in ((FX, "evaluate_goldilocks_ref"),
                      (SK, "sumcheck_prove_many_ref"), (K, "fold_end_ref"),
                      (KB, "bb_fold_end_ref"), (ST, "limb_fold_ref"),
                      (SL, "slot_mul_ref"), (SL, "slot_matvec_ref"),
                      (SB, "bb_slot_mul_ref"), (SB, "bb_slot_matvec_ref"),
                      (DG, "step_digits_ref")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_sharded_sumcheck_runs_k7_per_shard(dev, name, no_twins):
    """ShardedMLE's provers on 8 shards of the card at nv = 20: one K7
    launch a shard a proof (k = 2 and 3), no twin call, and the
    messages and finals of the generic lsb prover on the whole
    tables; the sharded inner product, and round 0's p(0) + p(1) equal
    to it in Python ints."""
    from stark_rings_tpu_torch.mle.sumcheck import (
        sumcheck_prove_many_with_challenges)
    from stark_rings_tpu_torch.parallel import ShardedMLE, make_mesh

    f = get_field(name)
    nv, P = 20, 8
    rng = np.random.default_rng(nv)
    tables = [f.rand((1 << nv,), rng, dev) for _ in range(3)]
    chal = list(f.rand((nv,), rng, dev))
    sm = ShardedMLE(f, nv, make_mesh(P, device=dev))
    shards = [sm.shard(T) for T in tables]
    key = f"sumcheck_prove_many_{name}"
    for k in (2, 3):
        before = SK.LAUNCHES[key]
        if k == 2:
            msgs, g, h = sm.make_sumcheck_fn()(*shards[:2], *chal)
            finals = [g, h]
        else:
            msgs, finals = sm.make_sumcheck_many_fn(k)(*shards[:k], *chal)
        torch.cuda.synchronize()
        assert SK.LAUNCHES[key] - before == P
        want_m, want_f = sumcheck_prove_many_with_challenges(
            f, tables[:k], chal)
        assert msgs.shape == (nv, k + 1) and msgs.device == dev
        assert torch.equal(msgs, want_m)
        assert all(torch.equal(a, b) for a, b in zip(finals, want_f))
    # round 0 of the k = 2 proof: p(0) + p(1) is the sharded inner
    # product, in Python ints
    ip = sm.make_inner_product_fn()(*shards[:2])
    assert torch.equal(ip, f.sum(f.mul(tables[0], tables[1]), 0))
    m0 = f.decode(sm.make_sumcheck_fn()(*shards[:2], *chal)[0][0]).tolist()
    assert (m0[0] + m0[1]) % f.q == int(f.decode(ip))


@pytest.mark.parametrize("nv", [3, 9, 20])
def test_sharded_eval_runs_k5_per_shard(dev, nv, no_twins):
    """ShardedMLE.make_eval_fn on 8 shards of the card: one K5 launch a
    shard (none at nv = 3, one entry a shard), equal to
    DenseMLE.evaluate; the sums equal the field's sum; make_fix_fn (up to
    k = 17) equals DenseMLE.fix_variables."""
    from stark_rings_tpu_torch.parallel import ShardedMLE, make_mesh

    f, P = GOLDILOCKS, 8
    rng = np.random.default_rng(nv)
    T = f.rand((1 << nv,), rng, dev)
    pts = list(f.rand((nv,), rng, dev))
    sm = ShardedMLE(f, nv, make_mesh(P, device=dev))
    before = FX.LAUNCHES["evaluate_goldilocks"]
    got = sm.make_eval_fn()(sm.shard(T), *pts)
    torch.cuda.synchronize()
    assert FX.LAUNCHES["evaluate_goldilocks"] - before == (P if nv > 3
                                                          else 0)
    dm = DenseMLE(FieldElems(f, dev), nv, T)
    assert torch.equal(got, dm.evaluate(pts))
    assert torch.equal(sm.make_hypercube_sum_fn()(sm.shard(T)), f.sum(T, 0))
    if nv > 3:          # fix the first variables, each shard's own
        k = min(17, nv - 3)
        fixed = sm.make_fix_fn(k)(sm.shard(T), *pts[:k])
        assert torch.equal(torch.cat(list(fixed)),
                           dm.fix_variables(pts[:k]).evals)


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "stark_prime"])
def test_sharded_model_mul_launch_counts(dev, name, no_twins):
    """ShardedModelMul on 8 shards of the card: the model CRT fold (K3,
    bb_fold_end, S3) three times a shard a mul, none for ntt_mul, two a
    shard and one for the challenge; equal to TModelMul on the whole
    batch, and 4 rows of the mul to the integer spec."""
    from stark_rings_tpu_torch.ops import stark as ST
    from stark_rings_tpu_torch.ops.model_mul import TModelMul
    from stark_rings_tpu_torch.parallel import ShardedModelMul, make_mesh
    from stark_rings_tpu_torch.rings import get_ring

    ring, P, B = get_ring(name, device=dev), 8, 1024
    counts, key = {"goldilocks": (K.LAUNCHES, "fold_end"),
                   "babybear": (KB.LAUNCHES, "bb_fold_end"),
                   "stark_prime": (ST.LAUNCHES, "limb_fold")}[name]
    rng = np.random.default_rng(B)
    a, b = ring.rand_coeff((B,), rng), ring.rand_coeff((B,), rng)
    smm, tm = ShardedModelMul(ring, make_mesh(P, device=dev)), TModelMul(ring)
    sa, sb = smm.shard(a), smm.shard(b)
    na, nb = ring.crt(a), ring.crt(b)
    runs = ((3 * P, lambda: smm.make_mul_fn()(sa, sb), tm.mul(a, b)),
            (0, lambda: smm.make_ntt_mul_fn()(smm.shard(na), smm.shard(nb)),
             ring.ntt_mul(na, nb)),
            (2 * P + 1, lambda: smm.make_challenge_mul_fn()(sa, b[:1]),
             tm.mul(a, b[:1].expand(a.shape).contiguous())))
    for launches, run, want in runs:
        torch.cuda.synchronize()
        before = counts[key]
        got = run()
        torch.cuda.synchronize()
        assert counts[key] - before == launches
        assert torch.equal(smm.gather(got, dev), want)
    # rows of the sharded mul against the integer spec
    got = ring.decode(smm.gather(smm.make_mul_fn()(sa, sb), dev)[:4])
    ai, bi = ring.decode(a[:4]), ring.decode(b[:4])
    for r in range(4):
        assert [int(v) for v in got[r]] == ring.spec.coeff_mul(
            [int(v) for v in ai[r]], [int(v) for v in bi[r]]), r


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("W", [8, 16])
def test_sharded_step_on_card(dev, W, psi, no_twins):
    """FoldingStep.make_sharded_step_fn on 8 shards of the card at the
    reference bench's width (n = 8, L = 1,024, base 256), witnesses
    sharded on axis 1: every output equal to the unsharded step, 2 K3
    launches a shard, no twin call."""
    from stark_rings_tpu_torch.parallel import make_mesh, shard
    from stark_rings_tpu_torch.protocol import FoldingStep
    from stark_rings_tpu_torch.rings import get_ring

    P = 8
    mesh = make_mesh(P, device=dev)
    ring = get_ring("goldilocks", device=dev)
    fs = FoldingStep(ring, 8, 1024, 256, psi_check=psi)
    c, ins = _step_inputs(fs, np.random.default_rng(W + psi), W)
    sins = [shard(x, mesh, 1) for x in ins[:4]]
    step = fs.make_sharded_step_fn(mesh)
    from stark_rings_tpu_torch.ops import digits as DG

    torch.cuda.synchronize()
    before = K.LAUNCHES["fold_end"], DG.LAUNCHES["step_digits"]
    got = step(c, *sins, ins[4])
    torch.cuda.synchronize()
    assert K.LAUNCHES["fold_end"] - before[0] == 2 * P
    assert DG.LAUNCHES["step_digits"] - before[1] == P
    want = fs.step(c, *ins)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        whole = torch.cat(list(got[key]), 0 if key.startswith("ok_") else 1)
        assert torch.equal(whole, val), key


def test_prove_sharded_on_card(dev, no_twins):
    """FoldingTree.prove_sharded of 16 leaves (L = 256) on 8 shards of the
    card: the levels and root of FoldingTree.prove, verified; K3 twice a
    shard on the level whose pairs the shards divide, twice on each
    level after it."""
    from stark_rings_tpu_torch.parallel import make_mesh
    from stark_rings_tpu_torch.protocol import FoldingTree
    from stark_rings_tpu_torch.rings import get_ring

    P, leaves = 8, 16
    mesh = make_mesh(P, device=dev)
    ring = get_ring("goldilocks", device=dev)
    ft = FoldingTree(ring, 8, 256, base=256)
    rng = np.random.default_rng(16)
    tc = ft.init_tables(rng)
    wt = ft.rand_witnesses(leaves, rng)
    cw = ft.commit_witnesses(tc, wt)
    rts = ft.precompute_challenges([ring.rand_coeff((), rng)
                                    for _ in range(4)])
    torch.cuda.synchronize()
    before = K.LAUNCHES["fold_end"]
    levels, rw, rc = ft.prove_sharded(mesh, tc, wt, cw, rts)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fold_end"] - before == 2 * P + 2 * 3
    lv, rw_l, rc_l = ft.prove(tc, wt, cw, rts)
    assert torch.equal(rw, rw_l) and torch.equal(rc, rc_l)
    for got, want in zip(levels, lv):
        for key, val in want.items():
            assert torch.equal(got[key], val), key
    assert ft.verify(tc, wt, cw, levels, rts)


def test_sharded_matvecs_on_card(dev, no_twins):
    """ShardedSparseMatVec of config 4's A (nnz 2^22) and ShardedMatVec of
    an 8 x 8,192 goldilocks ring matrix on 8 shards of the card: equal
    to SparseMatrix.mul_vec and Matrix.mul_vec; 64 sparse rows and 2 ring
    rows against Python-int sums."""
    from stark_rings_tpu_torch.linalg import Matrix, RingElems
    from stark_rings_tpu_torch.parallel import (ShardedMatVec,
                                                ShardedSparseMatVec,
                                                make_mesh)
    from stark_rings_tpu_torch.rings import get_ring

    P = 8
    mesh = make_mesh(P, device=dev)
    A, z, (data, cols, z_np), rng = _config4_matrix(dev)
    ssmv = ShardedSparseMatVec(FieldElems(GOLDILOCKS, dev), mesh)
    y = ssmv.make_matvec_fn(A.nrows)(*ssmv.shard(A), z)
    assert torch.equal(y, A.mul_vec(z))
    y_host = y.cpu().numpy().view(np.uint64)
    for i in rng.choice(A.nrows, 64, replace=False):
        want = sum(int(data[t]) * int(z_np[cols[t]])
                   for t in range(4 * i, 4 * i + 4)) % Q
        assert int(y_host[i]) == want, i
    ring = get_ring("goldilocks", device=dev)
    Am, vm = ring.rand_ntt((8, 8192), rng), ring.rand_ntt((8192,), rng)
    smv = ShardedMatVec(RingElems(ring), mesh)
    cv = smv.make_matvec_fn()(*smv.shard(Am, vm))
    assert torch.equal(cv, Matrix(RingElems(ring), Am).mul_vec(vm))
    vi = ring.decode(vm)
    for i in (0, 7):
        Ai, acc = ring.decode(Am[i]), [0] * ring.D
        for j in range(8192):
            p_ = ring.spec.ntt_mul([int(v) for v in Ai[j]],
                                   [int(v) for v in vi[j]])
            acc = [(x + w) % Q for x, w in zip(acc, p_)]
        assert [int(v) for v in ring.decode(cv[i])] == acc, i


def test_distributed_prover_on_card(dev, capsys):
    """The distributed prover example on 8 shards of the card verifies:
    its sharded multiply and commit are 3 K3 launches a shard and 2, its
    sharded proof one K7 launch a shard."""
    from stark_rings_tpu_torch.examples import distributed_prover

    P = 8
    torch.cuda.synchronize()
    before = (K.LAUNCHES["fold_end"],
              SK.LAUNCHES["sumcheck_prove_many_goldilocks"])
    distributed_prover.main(device=dev, P=P)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["fold_end"] - before[0],
            SK.LAUNCHES["sumcheck_prove_many_goldilocks"] - before[1]) \
        == (3 * P + 2, P)
    assert "sharded sumcheck verified" in capsys.readouterr().out


# -- the entry points --------------------------------------------------


def _twin_counts(run):
    """{twin: calls} of the kernels' twins on the entry points' path
    while ``run()`` runs (each twin call is one launch on the card)."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.parallel import exchange as EX

    mods = ((K, "fold_end_ref"), (G, "ntt_tile_ref"),
            (K, "pointwise_mul_ref"), (SK, "sumcheck_prove_many_ref"),
            (EX, "twiddle_exchange_fwd_ref"), (EX, "twiddle_exchange_inv_ref"))
    calls, saved = {}, []
    for mod, name in mods:
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return calls


def _entry_launches():
    """{twin name: the launches of its kernel so far} on the card."""
    from stark_rings_tpu_torch.ops import goldilocks_ntt as G
    from stark_rings_tpu_torch.parallel import exchange as EX

    return {"fold_end_ref": K.LAUNCHES["fold_end"],
            "ntt_tile_ref": G.LAUNCHES["ntt_tile"],
            "pointwise_mul_ref": K.LAUNCHES["pointwise_mul"],
            "sumcheck_prove_many_ref": SK.LAUNCHES[
                "sumcheck_prove_many_goldilocks"],
            "twiddle_exchange_fwd_ref": sum(
                v for k, v in EX.LAUNCHES.items() if "fwd" in k),
            "twiddle_exchange_inv_ref": sum(
                v for k, v in EX.LAUNCHES.items() if "inv" in k)}


def test_entry_on_card(dev):
    """entry() on the card: the zero difference, the product and digits
    of the CPU path on the same inputs, 3 K3 launches a step."""
    from stark_rings_tpu_torch import entry as E
    from stark_rings_tpu_torch.rings import get_ring

    step, (a, b) = E.entry()
    assert a.device == dev
    before = K.LAUNCHES["fold_end"]
    out = step(a, b)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fold_end"] - before == 3
    assert out.shape == (32, 24) and not out.any()
    ring = get_ring("goldilocks", device=dev)
    got = E.step_stages(ring, a, b)
    want = E.step_stages(get_ring("goldilocks", device="cpu"), a.cpu(),
                         b.cpu())
    for key in ("prod", "digits", "back", "zero"):
        assert torch.equal(got[key].cpu(), want[key]), key
    # at the reference bench's goldilocks batch: the difference zero, and
    # 64 rows of the product against the integer spec
    rng = np.random.default_rng(65536)
    x, y = ring.rand_coeff((65536,), rng), ring.rand_coeff((65536,), rng)
    assert not step(x, y).any()
    prod = E.step_stages(ring, x[:64], y[:64])["prod"]
    xi, yi, pi = (ring.decode(v) for v in (x[:64], y[:64], prod))
    for r in range(64):
        assert [int(v) for v in pi[r]] == ring.spec.coeff_mul(
            [int(v) for v in xi[r]], [int(v) for v in yi[r]]), r


@pytest.mark.parametrize("n", [6, 8])
def test_dryrun_multichip_on_card(dev, n):
    """dryrun_multichip(n) on n shards of the card runs to its end, and
    launches each kernel of its path as often as the CPU run calls the
    kernel's twin; no twin runs on the card."""
    from stark_rings_tpu_torch import entry as E

    want = _twin_counts(lambda: E.dryrun_multichip(n, "cpu"))
    torch.cuda.synchronize()
    before = _entry_launches()
    twins = _twin_counts(lambda: E.dryrun_multichip(n))
    torch.cuda.synchronize()
    assert not any(twins.values()), twins
    got = {k: v - before[k] for k, v in _entry_launches().items()}
    assert got == want
    assert all(want.values())


@pytest.mark.parametrize("exchange", ["xla", "pallas"])
@pytest.mark.parametrize("n", [6, 8])
def test_grid_step_launch_counts_on_card(dev, n, exchange):
    """grid_step at N = 2^12 on dp x sp shards of the card: a product is
    6 ntt_tile and 7 pointwise_mul launches a shard (4 with K8), 2 + 1
    K8 launches a row; the product equals fourstep_ctx().mul and the
    checksum the sum of its entries."""
    from stark_rings_tpu_torch import ShardedNTT
    from stark_rings_tpu_torch import entry as E

    N, f = 1 << 12, GOLDILOCKS
    dp, sp = E.grid_shape(n)
    rows = E.make_grid(n, dev)
    sn = ShardedNTT("goldilocks", N, sp, axis="sp", exchange=exchange)
    rng = np.random.default_rng(n)
    a, b = (f.rand((2 * dp, N), rng, dev) for _ in range(2))
    ga, gb = (E.shard_grid(sn, rows, sn.to_matrix(x)) for x in (a, b))
    torch.cuda.synchronize()
    before = _entry_launches()
    out = {}
    twins = _twin_counts(lambda: out.update(
        step=E.grid_step(sn, rows, ga, gb)))
    torch.cuda.synchronize()
    prod, checksum = out["step"]
    assert not any(twins.values()), twins
    got = {k: v - before[k] for k, v in _entry_launches().items()}
    k8 = exchange == "pallas"
    assert got == {"fold_end_ref": 0, "ntt_tile_ref": 6 * n,
                   "pointwise_mul_ref": (4 if k8 else 7) * n,
                   "sumcheck_prove_many_ref": 0,
                   "twiddle_exchange_fwd_ref": 2 * dp if k8 else 0,
                   "twiddle_exchange_inv_ref": dp if k8 else 0}
    whole = sn.from_matrix(E.gather_grid(sn, prod, dev))
    want = get_power_ring("goldilocks", 12, device=dev).fourstep_ctx().mul(
        a, b)
    assert torch.equal(whole, want)
    assert torch.equal(checksum, f.reduce_words(
        f.widen(want).reshape(-1, 2).sum(dim=0)))


# -- the compiled multiplies (one CUDA graph replay a call) ---------------------

JIT_ENGINES = {
    "Mxu2NTT": lambda dev: Mxu2NTT(1 << 12, device=dev),
    "Mxu2FusedNTT": lambda dev: Mxu2FusedNTT(1 << 12, device=dev),
    "Mxu2KernelNTT": lambda dev: Mxu2KernelNTT(1 << 12, device=dev),
    "MxuBBNTT": lambda dev: MxuBBNTT(1 << 12, device=dev),
    "MxuBBFusedNTT": lambda dev: MxuBBFusedNTT(1 << 12, device=dev),
}


def _fold_launches():
    return {**K.LAUNCHES, **KB.LAUNCHES}


@pytest.mark.parametrize("engine", list(JIT_ENGINES))
def test_compiled_calls_on_card(dev, engine):
    """jit_mul, jit_mul_cached (batch-B and batch-1 states), jit_square
    and staged_mul in its four granularities at N = 2^12, B = 3: each
    replay equals the eager call on the card (the eager mul also the CPU
    engine's); a second call on fresh inputs is right and leaves the
    first result as it was; a replay launches nothing from Python.  The
    first call of jit_mul, jit_mul_cached and jit_square (warm-up and
    capture) launches twice the eager call's hand kernels, so its graph
    holds them."""
    e = JIT_ENGINES[engine](dev)
    f, N = e.F, e.N
    rng = np.random.default_rng(17)
    a, b, a2, b2 = (f.rand((3, N), rng, dev) for _ in range(4))
    mc, square = e.jit_mul_cached(), e.jit_square()
    assert mc.graphs is mc.precompute.graphs
    calls = {
        "jit_mul": (e.jit_mul(), e.mul),
        "jit_square": (lambda x, _: square(x), lambda x, _: e.square(x)),
        "jit_mul_cached": (lambda x, y: mc(x, mc.precompute(y)),
                           lambda x, y: e.mul_cached(x, e.precompute(y))),
        "jit_mul_cached_batch1": (
            lambda x, y: mc(x, mc.precompute(y[:1])),
            lambda x, y: e.mul_cached(x, e.precompute(y[:1]))),
    }
    for g in ("stage", "mixed", "mixed4", "transform"):
        calls[g] = (e.staged_mul(g), e.mul)
    want = e.mul(a, b)
    cpu = type(e)(N, device="cpu")
    assert torch.equal(want.cpu(), cpu.mul(a.cpu(), b.cpu()))
    for name, (jit, eager) in calls.items():
        torch.cuda.synchronize()
        before = _fold_launches()
        first = jit(a, b)
        torch.cuda.synchronize()
        captured = {k: v - before[k] for k, v in _fold_launches().items()}
        kept = first.clone()
        before = _fold_launches()
        assert torch.equal(first, eager(a, b)), name
        torch.cuda.synchronize()
        # the first call's warm-up and capture each ran the eager call's
        # hand kernels, so its graph replays them (a staged call replays
        # a stage's graph where its eager call runs the stage again)
        if name.startswith("jit"):
            assert captured == {k: 2 * (v - before[k])
                                for k, v in _fold_launches().items()}, name
        torch.cuda.synchronize()
        before = _fold_launches()
        second = jit(a2, b2)
        torch.cuda.synchronize()
        assert _fold_launches() == before, name
        assert torch.equal(second, eager(a2, b2)), name
        assert torch.equal(first, kept), name
    assert torch.equal(calls["stage"][0].forward(a),
                       e.forward_internal(e._to_internal(a)))


def test_limb_jit_mul_on_card(dev):
    """MxuLimbNTT.jit_mul at N = 512, B = 3: the replay equals the eager
    mul and NTTContext on the card, a second call on fresh inputs is
    right and leaves the first result unchanged, and a replay launches
    no S1/S3 from Python."""
    from stark_rings_tpu_torch.fields import STARK
    from stark_rings_tpu_torch.ops import stark as S
    from stark_rings_tpu_torch.ops.mxu_limb import MxuLimbNTT

    N = 512
    rng = np.random.default_rng(19)
    e = MxuLimbNTT(N, device=dev)
    a, b, a2, b2 = (STARK.rand((3, N), rng, dev) for _ in range(4))
    jit = e.jit_mul()
    first = jit(a, b)
    kept = first.clone()
    assert torch.equal(first, NTTContext(STARK, N, device=dev).mul(a, b))
    torch.cuda.synchronize()
    before = dict(S.LAUNCHES)
    second = jit(a2, b2)
    torch.cuda.synchronize()
    assert S.LAUNCHES == before
    assert torch.equal(second, e.mul(a2, b2))
    assert torch.equal(first, kept)


_FAILING_CAPTURE = r"""
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


def test_failed_capture_raises(dev):
    """A function that synchronises inside its capture raises on its
    first CUDA call and returns no eager result (its warm-up ran, its
    capture was refused).  In a child process, so that the abandoned
    capture cannot reach this process's allocator."""
    proc = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE],
                          cwd=pathlib.Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "capture refused" in proc.stdout
