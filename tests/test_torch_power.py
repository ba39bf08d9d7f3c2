"""The port's power-of-two rings on the CPU against the JAX reference:
the radix ``NTTContext`` for both fields, the Goldilocks pointwise
kernel's twin against the reference's Pallas ``pointwise_mul`` and
``pointwise_dma`` (interpret mode), the evaluation-domain engine
``Mxu2KernelNTT`` against ``Mxu2PallasNTT(pointwise_pallas=True)``, and
every ported ``PowerRing`` method against the reference's
``get_power_ring``, with BASELINE configs 1 and 2.  Inputs are
numpy-seeded; values are compared through the reference's storage
(canonical u64 for Goldilocks, Montgomery u32 for BabyBear), with 0
differing bits allowed.  Also: the entry points default to the card."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.native.host import HostRing
from stark_rings_tpu.ops.ntt import NTTContext as RefNTTContext
from stark_rings_tpu.ops.pallas_fold import (Mxu2PallasNTT, pointwise_dma,
                                             pointwise_mul)
from stark_rings_tpu.rings.power import get_power_ring as ref_power_ring

from stark_rings_tpu_torch import (GOLDILOCKS, Mxu2FusedNTT, Mxu2KernelNTT,
                                   Mxu2NTT, MxuBBFusedNTT, MxuBBNTT,
                                   NTTContext, get_field, get_ntt,
                                   get_power_ring,
                                   to_numpy_u32, to_numpy_u64, to_torch,
                                   to_torch_u32)
from stark_rings_tpu_torch.examples import sumcheck as example
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook_q
from stark_rings_tpu_torch.ops import fold as K

QG = GOLDILOCKS.q


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _codec(name):
    """(numpy dtype, numpy -> CPU tensor, tensor -> numpy) of a field's
    storage."""
    if name == "babybear":
        return np.uint32, (lambda x: to_torch_u32(x, "cpu")), to_numpy_u32
    return np.uint64, (lambda x: to_torch(x, "cpu")), to_numpy_u64


def _rand(name, rng, shape):
    dt, _, _ = _codec(name)
    return rng.integers(0, ref_field(name).q, shape, dtype=dt)


# -- NTTContext ---------------------------------------------------------------


@pytest.mark.parametrize("logN", [4, 5, 10, 11])
@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_ntt_context_matches_reference(name, logN):
    N = 1 << logN
    _, tt, back = _codec(name)
    rng = np.random.default_rng(logN)
    x, y = _rand(name, rng, (2, N)), _rand(name, rng, (2, N))
    ref = RefNTTContext(ref_field(name), N, negacyclic=True)
    port = get_ntt(name, N, device="cpu")
    assert get_ntt(name, N, device="cpu") is port
    assert port.f is get_field(name) and port.negacyclic
    assert port.leaf_exps == ref.leaf_exps
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert np.array_equal(back(port.forward(tt(x))), np.asarray(
        ref.forward(jx)))
    assert np.array_equal(back(port.inverse(tt(x))), np.asarray(
        ref.inverse(jx)))
    assert np.array_equal(back(port.mul(tt(x), tt(y))), np.asarray(
        ref.mul(jx, jy)))
    assert np.array_equal(back(port.square(tt(x))), np.asarray(
        ref.square(jx)))


# -- the pointwise kernel's twin ----------------------------------------------


def test_pointwise_twin_matches_pallas():
    rng = np.random.default_rng(5)
    a = rng.integers(0, QG, (4, 2, 512), dtype=np.uint64)
    b = rng.integers(0, QG, (4, 2, 512), dtype=np.uint64)
    a[0, 0, :4] = [0, 1, QG - 1, QG - 1]
    b[0, 0, :4] = [QG - 1, QG - 1, QG - 1, 2**32]
    got = to_numpy_u64(K.pointwise_mul_ref(to_torch(a, "cpu"),
                                           to_torch(b, "cpu")))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(got, np.asarray(pointwise_mul(ja, jb,
                                                        interpret=True)))
    assert np.array_equal(got, np.asarray(pointwise_dma(
        ja, jb, chunk_rows=2, width=512, interpret=True)))
    K.reset_launches()
    assert np.array_equal(to_numpy_u64(K.pointwise_mul(
        to_torch(a, "cpu"), to_torch(b, "cpu"))), got)
    assert K.LAUNCHES["pointwise_mul"] == 0
    # b broadcasts over a's leading axes (read at i mod b.numel()); a
    # shape that is not a trailing part of a's raises
    got1 = to_numpy_u64(K.pointwise_mul(to_torch(a, "cpu"),
                                        to_torch(b[:1], "cpu")))
    assert np.array_equal(got1, np.asarray(pointwise_mul(
        ja, jnp.broadcast_to(jb[:1], ja.shape), interpret=True)))
    with pytest.raises(ValueError, match="does not broadcast"):
        K.pointwise_mul(to_torch(a, "cpu"), to_torch(b[:, :1], "cpu"))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.pointwise_mul(to_torch(a, "cpu").to("meta"),
                        to_torch(b, "cpu").to("meta"))


# -- Mxu2KernelNTT ------------------------------------------------------------


@pytest.mark.parametrize("N", [1 << 10, 1 << 11])
def test_kernel_engine_matches_pallas_engine(N):
    """Mxu2KernelNTT against the reference's mxu_ctx() engine,
    Mxu2PallasNTT(N, pointwise_pallas=True) (whole-array folds and
    pointwise_mul, interpret mode)."""
    rng = np.random.default_rng(N)
    a = rng.integers(0, QG, (2, N), dtype=np.uint64)
    b = rng.integers(0, QG, (2, N), dtype=np.uint64)
    ref = Mxu2PallasNTT(N, pointwise_pallas=True, interpret=True)
    port = Mxu2KernelNTT(N, device="cpu")
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    want = np.asarray(ref.mul(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(to_numpy_u64(port.mul(ta, tb)), want)
    state = port.precompute(tb)
    assert state.dtype == torch.int64 and state.shape == (port.N2, 2,
                                                          port.N1)
    assert np.array_equal(to_numpy_u64(port.mul_cached(ta, state)), want)
    if N == 1 << 11:
        assert np.array_equal(to_numpy_u64(port.square(ta)),
                              np.asarray(ref.square(jnp.asarray(a))))
    else:
        # evaluation-domain chaining: (a*b)*b from one cached state
        fa = port.forward_internal(port._to_internal(ta))
        ab2 = port._from_internal(port.inverse_internal(
            port.pointwise(port.pointwise(fa, state), state)))
        assert torch.equal(ab2, port.mul_cached(
            port._from_internal(port.inverse_internal(
                port.pointwise(fa, state))), state))
        # a batch-1 cached operand broadcasts over the batch
        one = port.mul_cached(ta, port.precompute(tb[:1]))
        plain = Mxu2NTT(N, device="cpu")
        assert torch.equal(one, plain.mul_cached(ta,
                                                 plain.precompute(tb[:1])))


# -- PowerRing ----------------------------------------------------------------


RINGS = [("goldilocks", 6), ("goldilocks", 9), ("goldilocks", 12),
         ("babybear", 10), ("babybear", 12)]


@pytest.mark.parametrize("name,logN", RINGS)
def test_power_ring_matches_reference(name, logN):
    ref = ref_power_ring(name, logN)
    ring = get_power_ring(name, logN, device="cpu")
    assert get_power_ring(name, logN, device="cpu") is ring
    assert (ring.name, ring.q, ring.D, ring.N, ring.E) == (
        ref.name, ref.q, ref.D, ref.N, ref.E)
    _, tt, back = _codec(name)
    D, q = ring.D, ring.q
    rng = np.random.default_rng(logN)
    B = 2
    a, b = _rand(name, rng, (B, D)), _rand(name, rng, (B, D))
    ta, tb = tt(a), tt(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)

    def same(got, want):
        assert np.array_equal(back(got), np.asarray(want))

    ints = np.array([[(i * 7919 + 3 * j) % q for i in range(D)]
                     for j in range(B)], dtype=object)
    ints[0, :3] = [0, 1, q - 1]
    same(ring.encode_coeffs(ints), ref.encode_coeffs(ints))
    assert (ring.decode(ring.encode_coeffs(ints)) == ints).all()
    same(ring.zeros((3,)), ref.zeros((3,)))
    same(ring.from_scalar_coeff(5, (2,)), ref.from_scalar_coeff(5, (2,)))
    same(ring.from_scalar_ntt(q - 2, (2,)), ref.from_scalar_ntt(q - 2,
                                                                  (2,)))
    for op in ("add", "sub", "ntt_mul", "mul_unchecked"):
        same(getattr(ring, op)(ta, tb), getattr(ref, op)(ja, jb))
    same(ring.neg(ta), ref.neg(ja))
    same(ring.crt(ta), ref.crt(ja))
    same(ring.icrt(ta), ref.icrt(ja))
    want = np.asarray(ref.coeff_mul(ja, jb))
    same(ring.coeff_mul(ta, tb), want)
    same(ring.coeff_square(ta), ref.coeff_square(ja))
    same(ring.coeff_mul_cached(ta, ring.precompute(tb)), want)
    same(ring.coeff_mul_cached(ta, ring.precompute(tb[:1])),
         ref.coeff_mul_cached(ja, ref.precompute(jb[:1])))
    fa, jfa = ring.crt(ta), ref.crt(ja)
    for e in (0, 1, 5):
        same(ring.ntt_pow(fa, e), ref.ntt_pow(jfa, e))
    if logN == min(n for f, n in RINGS if f == name):
        # the Fermat exponent is long: held against the reference on the
        # smallest ring of each field, by a * a^-1 = 1 on the others
        same(ring.ntt_pow(fa, q - 2), ref.ntt_pow(jfa, q - 2))
        same(ring.ntt_inv(fa), ref.ntt_inv(jfa))
    assert torch.equal(ring.ntt_mul(fa, ring.ntt_inv(fa)),
                       ring.from_scalar_ntt(1, (B,)))
    same(ring.rot(ta), ref.rot(ja))
    same(ring.flatten(ta[None]), ref.flatten(ja[None]))
    same(ring.promote(ring.flatten(ta)), ref.promote(ref.flatten(ja)))
    # the digit-GEMM engines: kernel path (twins on the CPU) and plain
    eng = ring.mxu_ctx()
    assert ring.mxu_ctx() is eng
    assert type(eng) is (MxuBBFusedNTT if name == "babybear"
                         else Mxu2KernelNTT)
    plain = ring.mxu_ctx(pallas=False)
    assert type(plain) is (MxuBBNTT if name == "babybear" else Mxu2NTT)
    if logN >= 9:       # the engines' smallest level is 16x32
        same(eng.mul(ta, tb), want)
        same(plain.mul(ta, tb), want)


def test_power_ring_schoolbook_oracle_and_unported_fields():
    """The C++ schoolbook for any q (the BabyBear oracle) against the
    reference's HostRing and the ring's multiply; stark_prime's power
    ring multiplies on MxuLimbNTT, as its NTTContext does."""
    ring = get_power_ring("babybear", 10, device="cpu")
    rng = np.random.default_rng(6)
    a = rng.integers(0, ring.q, (2, ring.D), dtype=np.uint32)
    b = rng.integers(0, ring.q, (2, ring.D), dtype=np.uint32)
    ca, cb = (np.array(ring.decode(to_torch_u32(x, "cpu")), dtype=np.uint64)
              for x in (a, b))
    got = np.stack([negacyclic_mul_schoolbook_q(x, y, ring.q)
                    for x, y in zip(ca, cb)])
    host = HostRing("babybear", ring.D)
    assert np.array_equal(got, np.stack([host.mul_schoolbook(x, y)
                                         for x, y in zip(ca, cb)]))
    prod = ring.mxu_ctx().mul(to_torch_u32(a, "cpu"), to_torch_u32(b, "cpu"))
    assert np.array_equal(np.array(ring.decode(prod), dtype=np.uint64), got)
    sp = get_power_ring("stark_prime", 4, device="cpu")
    x, y = (sp.rand_coeff((2,), rng) for _ in range(2))
    assert x.shape == (2, 16, 8)
    assert torch.equal(sp.mxu_ctx().mul(x, y), sp.coeff_mul(x, y))


def test_config1_goldilocks_pow2_ring():
    """BASELINE config 1's check (tests/test_baseline_configs.py): ring
    ops and the NTT round trip on X^64 + 1 against Python ints."""
    ring = get_power_ring("goldilocks", 6, device="cpu")
    q = ring.q
    rng = random.Random(90)
    a_i = [rng.randrange(q) for _ in range(64)]
    b_i = [rng.randrange(q) for _ in range(64)]
    a = ring.encode_coeffs(np.array(a_i, dtype=object))
    b = ring.encode_coeffs(np.array(b_i, dtype=object))
    s = ring.decode(ring.add(a, b))
    assert [int(v) for v in s] == [(x + y) % q for x, y in zip(a_i, b_i)]
    assert [int(v) for v in ring.decode(ring.icrt(ring.crt(a)))] == a_i
    want = [0] * 64
    for i, x in enumerate(a_i):
        for j, y in enumerate(b_i):
            k = i + j
            if k < 64:
                want[k] = (want[k] + x * y) % q
            else:
                want[k - 64] = (want[k - 64] - x * y) % q
    assert [int(v) for v in ring.decode(ring.coeff_mul(a, b))] == want


def test_config2_babybear_deg_2_12_batched_mul_invertibility():
    """BASELINE config 2's check at B = 2: the deg-2^12 product through
    the NTT form, every slot of every row invertible, and the product's
    round trip through icrt/crt; the kernel engine's product equal."""
    ring = get_power_ring("babybear", 12, device="cpu")
    f = ring.field
    rng = np.random.default_rng(91)
    a = f.from_canon(to_torch_u32(rng.integers(0, f.q, (2, ring.D),
                                               dtype=np.uint32), "cpu"))
    b = f.from_canon(to_torch_u32(rng.integers(0, f.q, (2, ring.D),
                                               dtype=np.uint32), "cpu"))
    prod = ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))
    assert torch.equal(prod, ring.mxu_ctx().mul(a, b))
    na = ring.crt(a)
    one = ring.decode(ring.ntt_mul(na, ring.ntt_inv(na)))
    assert all(int(v) == 1 for v in one.reshape(-1))
    direct = ring.ntt_mul(ring.crt(a), ring.crt(b))
    assert torch.equal(ring.crt(ring.icrt(direct)), direct)


# -- the card is the default --------------------------------------------------


def test_entry_points_default_to_cuda():
    """Without device="cpu" every entry point asks for the CUDA card,
    which raises here (no CPU fallback)."""
    calls = [lambda: Mxu2NTT(1 << 10), lambda: Mxu2FusedNTT(1 << 10),
             lambda: Mxu2KernelNTT(1 << 10), lambda: MxuBBNTT(1 << 10),
             lambda: MxuBBFusedNTT(), lambda: get_power_ring("babybear", 12),
             lambda: NTTContext(GOLDILOCKS, 16),
             lambda: GOLDILOCKS.encode([1]), lambda: get_field(
                 "babybear").rand((2,), np.random.default_rng(0)),
             lambda: FieldElems(GOLDILOCKS),
             lambda: example.main(n_vars=4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
