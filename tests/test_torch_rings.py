"""The port's ring models (``rings/ring.py`` ``RingModel``) on the CPU
against the JAX reference's ``get_ring`` for goldilocks, babybear and
frog: crt / icrt (the dense digit GEMM, and its oracles the staged chain and
the plain ``DenseModMat``, with the ring's own digit tables and with the
reference's carried across),
ntt_mul, ntt_pow, ntt_frobenius, ntt_inv, coeff_mul, reduce, rot,
flatten and promote; and ``get_ring``'s cache and refusals.  Inputs are
numpy-seeded storage words carried across to both packages; outputs are
compared through ``decode``, with no differing value allowed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.ops.dense_linear import (probe_dense_matrix as
                                              ref_probe)
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import from_jax_consts, from_jax_storage
from stark_rings_tpu_torch.ops import mxu_dense
from stark_rings_tpu_torch.ops.dense_linear import (DenseModMat,
                                                    probe_dense_matrix)
from stark_rings_tpu_torch.rings import RINGS, RingModel, get_ring

NAMES = ["goldilocks", "babybear", "frog"]
B = 13      # not a multiple of 8: the GEMM's padded columns


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def J(fn, **static):
    """The reference function ``fn`` jitted (one compile of the whole
    graph, much faster here than its ops one by one), ``static`` bound."""
    return jax.jit(lambda *args: fn(*args, **static))


def _dtype(f):
    return np.uint32 if f.dtype == torch.int32 else np.uint64


class Pair:
    """One model in both packages, with numpy-drawn operands carried
    across (storage words below q, valid in every field's storage)."""

    def __init__(self, name):
        self.R, self.P = ref_ring(name), get_ring(name, device="cpu")
        rng = np.random.default_rng(NAMES.index(name))
        a, b = (rng.integers(0, self.P.q, (B, self.P.D),
                             dtype=_dtype(self.P.field)) for _ in range(2))
        self.a_r, self.b_r = jnp.asarray(a), jnp.asarray(b)
        self.a, self.b = self.port(a), self.port(b)
        crt = J(self.R.crt)
        self.fa_r, self.fb_r = crt(self.a_r), crt(self.b_r)
        self.fa, self.fb = self.P.crt(self.a), self.P.crt(self.b)

    def port(self, x):
        return from_jax_storage(self.P.field, np.asarray(x), "cpu")

    def same(self, got, want, what):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert self.P.decode(got).tolist() == self.R.decode(want).tolist(), \
            (self.P.name, what)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, name):
    if name not in pairs:
        pairs[name] = Pair(name)
    return pairs[name]


@pytest.mark.parametrize("name", NAMES)
def test_crt_icrt_match_reference(pairs, name):
    p = _pair(pairs, name)
    P, R = p.P, p.R
    p.same(p.fa, p.fa_r, "crt")
    p.same(P.icrt(p.fa), J(R.icrt)(p.fa_r), "icrt")
    p.same(P.icrt(p.fa), p.a_r, "icrt(crt)")
    # the staged chain and the plain dense matrix are the GEMM's oracles
    p.same(P.crt_staged(p.a), p.fa_r, "crt_staged")
    p.same(P.icrt_staged(p.fa), p.a_r, "icrt_staged")
    staged = RingModel(P.spec, P.field, "cpu")
    staged.use_dense_crt = False
    assert torch.equal(staged.crt(p.a), p.fa)
    assert torch.equal(staged.icrt(p.fa), p.a)
    mat = probe_dense_matrix(P.spec.crt, P.D, P.D, P.q)
    assert mat.tolist() == ref_probe(R.spec.crt, R.D, R.D, R.q).tolist()
    assert torch.equal(DenseModMat(P.field, mat, "cpu")(p.a), p.fa)
    # the reference's digit tables, carried across, give the same maps
    ref_c = {k: np.asarray(v) for k, v in R.mul_consts().items()}
    for k, v in P.mul_consts().items():
        assert v.dtype == ref_c[k].dtype and v.tobytes() == ref_c[k].tobytes()
    c = from_jax_consts(ref_c, "cpu")
    crt, icrt = P._dense_crt
    for key, m in (("crt", crt), ("icrt", icrt)):
        assert torch.equal(c[key], m.w)
        assert torch.equal(c[key + "_corr"], m.w_corr)
    assert torch.equal(P.crt(p.a, c), p.fa)
    assert torch.equal(P.icrt(p.fa, c), p.a)
    # a batch of one and a two-axis batch
    assert torch.equal(P.crt(p.a[:1]), p.fa[:1])
    assert torch.equal(P.crt(p.a[:12].reshape(3, 4, P.D)),
                       p.fa[:12].reshape(3, 4, P.D))


@pytest.mark.parametrize("name", NAMES)
def test_slot_ops_match_reference(pairs, name):
    p = _pair(pairs, name)
    P, R = p.P, p.R
    ntt_mul = J(R.ntt_mul)
    p.same(P.ntt_mul(p.fa, p.fb), ntt_mul(p.fa_r, p.fb_r), "ntt_mul")
    p.same(P.ntt_mul(p.fa, p.fb[:1]), ntt_mul(p.fa_r, p.fb_r[:1]),
           "ntt_mul broadcast")
    for e in (0, 1, 13):
        p.same(P.ntt_pow(p.fa, e), R.ntt_pow(p.fa_r, e), f"ntt_pow {e}")
    for i in (1, 2, P.E):
        p.same(P.ntt_frobenius(p.fa, i), J(R.ntt_frobenius, i=i)(p.fa_r),
               f"ntt_frobenius {i}")
    inv = P.ntt_inv(p.fa)
    p.same(inv, R.ntt_inv(p.fa_r), "ntt_inv")
    p.same(P.ntt_mul(p.fa, inv), R.from_scalar_ntt(1, (B,)), "a * a^-1")
    p.same(P.from_scalar_ntt(5, (2,)), R.from_scalar_ntt(5, (2,)),
           "from_scalar_ntt")


@pytest.mark.parametrize("name", NAMES)
def test_coeff_ops_match_reference(pairs, name):
    p = _pair(pairs, name)
    P, R = p.P, p.R
    p.same(P.coeff_mul(p.a, p.b), J(R.coeff_mul)(p.a_r, p.b_r),
           "coeff_mul")
    p.same(P.coeff_mul(p.a, p.b),
           J(lambda x, y: R.icrt(R.ntt_mul(x, y)))(p.fa_r, p.fb_r),
           "coeff_mul = icrt(ntt_mul)")
    p.same(P.rot(p.a), J(R.rot)(p.a_r), "rot")
    p.same(P.pow_rot(p.a, 3), J(R.pow_rot, k=3)(p.a_r), "pow_rot")
    rots = list(P.rot_iter(p.a[0], 3))
    assert len(rots) == 3 and torch.equal(rots[2], P.pow_rot(p.a[0], 2))
    wide = np.random.default_rng(9).integers(
        0, P.q, (2, 2 * P.D - 1), dtype=_dtype(P.field))
    p.same(P.reduce(p.port(wide)), J(R.reduce)(jnp.asarray(wide)), "reduce")
    for ints in ([3, 4], list(range(1, P.D + 1)),
                 list(range(1, 2 * P.D + 1))):
        p.same(P.from_coeff_list(ints), R.from_coeff_list(ints),
               f"from_coeff_list {len(ints)}")
    p.same(P.from_scalar_coeff(7, (2,)), R.from_scalar_coeff(7, (2,)),
           "from_scalar_coeff")
    x = p.a[:12].reshape(2, 6, P.D)
    flat = P.flatten(x)
    p.same(flat, R.flatten(p.a_r[:12].reshape(2, 6, P.D)), "flatten")
    assert flat.shape == (2, 6 * P.D) and torch.equal(P.promote(flat), x)
    with pytest.raises(ValueError, match="multiple of D"):
        P.promote(flat[:, 1:])


def test_get_ring_cache_and_refusals():
    ring = get_ring("frog", device="cpu")
    assert get_ring("frog", device="cpu") is ring
    assert RINGS[("frog", "cpu")] is ring and isinstance(ring, RingModel)
    assert (ring.D, ring.N, ring.E) == (16, 4, 4)
    sp = get_ring("stark_prime", device="cpu")
    assert (sp.D, sp.N, sp.E) == (16, 16, 1) and sp.field.limbed
    with pytest.raises(KeyError):
        get_ring("nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_ring("goldilocks")
    with pytest.raises(ValueError, match="last axis"):
        ring.encode_coeffs([1, 2, 3])
    with pytest.raises(KeyError, match="no prescaled matrix"):
        mxu_dense.prescaled_dense(type("F", (), {"name": "nope"}), [[1]],
                                  "cpu")
    # rand draws from a numpy Generator onto the ring's device
    x = ring.rand_coeff((2, 3), np.random.default_rng(0))
    assert x.shape == (2, 3, 16) and x.device.type == "cpu"
