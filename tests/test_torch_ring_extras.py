"""What stands on the port's ring models, on the CPU against the JAX
reference, for goldilocks, babybear and frog: monomial algebra (monomial,
psi, exp / exp_signed, the scalar and the batched psi range check,
exp_batched), sampling (ranges; ``is_invertible`` on the reference's own
draws, carried across), ``Transcript.squeeze_ring_element``, the ``Rq``
operator surface (its elementwise operators against the reference's, its
products against the ring model's; its decomposition and norm methods
against the reference's), the ring element adapters and the lazy
``models`` registry.
Ints are carried across; outputs are compared through ``decode``, with
no differing value allowed."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.rings import Rq as RefRq
from stark_rings_tpu.rings import absorb as ref_absorb
from stark_rings_tpu.rings import get_ring as ref_ring
from stark_rings_tpu.rings import monomial as ref_mono
from stark_rings_tpu.rings import sampling as ref_sampling

import stark_rings_tpu_torch.models as models
from stark_rings_tpu_torch import from_jax_storage
from stark_rings_tpu_torch.linalg import RingCoeffElems, RingElems
from stark_rings_tpu_torch.rings import (Rq, Transcript, get_ring, monomial,
                                         sampling)

NAMES = ["goldilocks", "babybear", "frog"]


def _rings(name):
    return get_ring(name, device="cpu"), ref_ring(name)


def _edge_values(ring, seed):
    """Range-check inputs: boundaries on both sides of 0, the half point,
    values whose low 32 bits are small, and random draws."""
    q, D = ring.q, ring.D
    rng = random.Random(seed)
    vals = [0, 1, D // 2 - 1, D // 2, D - 1, D, D + 1, q - 1,
            q - (D // 2 - 1), q - D // 2, q - D, q - D - 1, (q - 1) // 2,
            (q + 1) // 2]
    if q > 1 << 33:
        vals += [1 << 32, (1 << 32) + 3, q - (1 << 32), q - (1 << 32) - 3]
    vals += [rng.randrange(q) for _ in range(6)]
    vals += [rng.randrange(D) for _ in range(4)]
    return vals + [q - rng.randrange(1, D) for _ in range(4)]


@pytest.mark.parametrize("name", NAMES)
def test_monomials_and_psi_match_reference(name):
    ring, ref = _rings(name)

    def same(got, want, what):
        assert ring.decode(got).tolist() == ref.decode(want).tolist(), what

    same(monomial.monomial(ring, 5, 3, (2,)), ref_mono.monomial(ref, 5, 3,
                                                               (2,)), "mono")
    same(monomial.unit_monomial(ring, 0), ref_mono.unit_monomial(ref, 0),
         "unit")
    same(monomial.zero_monomial(ring, (3,)), ref_mono.zero_monomial(ref, (3,)),
         "zero")
    same(monomial.psi(ring), ref_mono.psi(ref), "psi")
    x = monomial.psi(ring)[None]
    same(monomial.ct(ring, x), ref_mono.ct(ref, np.asarray(ref_mono.psi(
        ref))[None]), "ct")
    for a in _edge_values(ring, 1):
        for fn in ("exp", "exp_signed"):
            try:
                want = getattr(ref_mono, fn)(ref, a)
            except ref_mono.MonomialError:
                with pytest.raises(monomial.MonomialError):
                    getattr(monomial, fn)(ring, a)
                continue
            same(getattr(monomial, fn)(ring, a), want, f"{fn}({a})")


@pytest.mark.parametrize("name", NAMES)
def test_batched_exp_and_range_check_match_reference(name):
    """exp_batched and psi_range_check_batched (the unrolled chain of
    selects) over a tensor of edge values and random draws.  Negative
    digits fail the check on goldilocks and babybear, as in the
    reference (its completeness domain)."""
    ring, ref = _rings(name)
    vals = _edge_values(ring, 2)
    enc = ring.field.encode(np.array(vals, dtype=object), "cpu")
    enc_r = ref.field.encode(np.array(vals, dtype=object))
    mono, valid = monomial.exp_batched(ring, enc)
    mono_r, valid_r = jax.jit(lambda x: ref_mono.exp_batched(ref, x))(enc_r)
    assert valid.tolist() == np.asarray(valid_r).tolist()
    assert ring.decode(mono).tolist() == ref.decode(mono_r).tolist()
    got = monomial.psi_range_check_batched(ring, enc)
    want = jax.jit(lambda x: ref_mono.psi_range_check_batched(ref, x))(enc_r)
    assert got.dtype == torch.bool and got.shape == (len(vals),)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == [monomial.psi_range_check(ring, v) for v in vals]
    if name != "frog":          # X^D - X^(D/2) + 1: -1 is outside
        assert not got[vals.index(ring.q - 1)]


@pytest.mark.parametrize("name", NAMES)
def test_sampling(name):
    ring, ref = _rings(name)
    rng = np.random.default_rng(4)
    x = sampling.sample_short(ring, (5,), rng, 2)
    assert x.shape == (5, ring.D) and x.device.type == "cpu"
    signed = [[v if v <= ring.q // 2 else v - ring.q for v in row]
              for row in ring.decode(x).tolist()]
    assert all(-2 <= v <= 2 for row in signed for v in row)
    assert {v for row in signed for v in row} == {-2, -1, 0, 1, 2}
    u = sampling.rand_uniform(ring, (3,), rng)
    assert u.shape == (3, ring.D)
    # the reference's draws, carried across, and non-units built in the
    # NTT form (one slot zeroed)
    draws = np.asarray(ref_sampling.sample_short(ref, (6,), random.Random(5),
                                                 1))
    ntt = np.array(ref.crt(jnp.asarray(draws)))
    ntt[1, :ref.E] = 0
    ntt[2, -ref.E:] = 0
    cases = np.concatenate([draws, np.asarray(ref.icrt(jnp.asarray(
        ntt[1:3])))])
    got = sampling.is_invertible(ring, from_jax_storage(ring.field, cases,
                                                        "cpu"))
    want = np.asarray(ref_sampling.is_invertible(ref, jnp.asarray(cases)))
    assert got.tolist() == want.tolist()
    assert got.tolist()[-2:] == [False, False]
    y = sampling.sample_short_invertible(ring, rng, 3)
    assert y.shape == (ring.D,) and bool(sampling.is_invertible(ring, y))
    with pytest.raises(RuntimeError, match="no short invertible"):
        sampling.sample_short_invertible(ring, rng, 0, max_tries=2)


@pytest.mark.parametrize("name", NAMES)
def test_squeeze_ring_element_matches_reference(name):
    ring, ref = _rings(name)
    data = np.random.default_rng(6).integers(0, ring.q, (2, ring.D),
                                             dtype=np.uint64)
    data = data.astype(np.uint32) if name == "babybear" else data
    t, t_r = Transcript(), ref_absorb.Transcript()
    t.absorb(b"x", ring.field, from_jax_storage(ring.field, data, "cpu"))
    t_r.absorb(b"x", ref.field, jnp.asarray(data))
    for _ in range(2):
        el = t.squeeze_ring_element(ring)
        el_r = t_r.squeeze_ring_element(ref)
        assert el.shape == (ring.D,) and el.device.type == "cpu"
        assert ring.decode(el).tolist() == ref.decode(el_r).tolist()
        assert el.numpy().tobytes() == np.asarray(el_r).tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_rq_operator_surface(name):
    ring, ref = _rings(name)
    rng = random.Random(17)
    ints = [[[rng.randrange(ring.q) for _ in range(ring.D)]
             for _ in range(3)] for _ in range(2)]
    a, b = (Rq.coeff(ring, ring.encode_coeffs(np.array(v, dtype=object)))
            for v in ints)
    ar, br = (RefRq.coeff(ref, ref.encode_coeffs(np.array(v, dtype=object)))
              for v in ints)

    def same(x, y):
        assert x.form == y.form
        assert ring.decode(x.data).tolist() == ref.decode(y.data).tolist()

    same(a + b, ar + br)
    same(a - b, ar - br)
    same(-a, -ar)
    same(a * 5, ar * 5)
    same(a.rot(), ar.rot())
    same(a.crt(), ar.crt())
    assert ring.decode(a.ct()).tolist() == ref.decode(ar.ct()).tolist()
    # the products delegate to the ring model (held to the reference in
    # test_torch_rings.py)
    fa, fb = a.crt(), b.crt()
    assert (a * b).data.equal(ring.coeff_mul(a.data, b.data))
    assert (fa * fb).data.equal(ring.ntt_mul(fa.data, fb.data))
    assert (fa * fb).icrt() == a * b and a.square() == a * a
    assert a ** 3 == a * a * a and fa ** 3 == fa * fa * fa
    assert a ** 0 == Rq.one(ring, (3,))
    assert fa.inv().data.equal(ring.ntt_inv(fa.data))
    one = Rq.one(ring, (3,))
    assert a * one == a and (a.crt() * a.crt().inv()) == Rq.one(
        ring, (3,), "ntt")
    assert (a + b) - b == a and a * 0 == Rq.zero(ring, (3,))
    assert a != b.crt() and a.shape == (3,) and "frog" in repr(
        Rq.zero(get_ring("frog", device="cpu")))
    long = list(range(1, 2 * ring.D + 1))
    same(Rq.from_ints(ring, long), RefRq.from_ints(ref, long))
    same(Rq.from_scalar(ring, 4, "ntt", (2,)),
         RefRq.from_scalar(ref, 4, "ntt", (2,)))
    same(Rq.from_ints(ring, ints[0][0], "ntt"),
         RefRq.from_ints(ref, ints[0][0], "ntt"))
    with pytest.raises(ValueError, match="form mismatch"):
        _ = a * b.crt()
    with pytest.raises(ValueError, match="needs ntt form"):
        a.inv()
    # the decomposition and norm methods (the port's decomp/)
    k = 64 // 8 if ring.q > 1 << 32 else 4
    norm = sum(int(w) << (32 * j) for j, w in
               enumerate(a.l2_norm_squared_words().tolist()))

    def methods(x):   # the reference's five methods, jitted as one graph
        xr = RefRq.coeff(ref, x)
        d = xr.decompose(256, k)
        return (d, RefRq.recompose(ref, d, 256).data, xr.linf_norm(),
                xr.l2_norm_squared_words(), xr.l2_check(norm - 1),
                xr.l2_check(norm))

    want = [np.asarray(v) for v in jax.jit(methods)(ar.data)]
    dig = a.decompose(256, k)
    got = (dig, Rq.recompose(ring, dig, 256).data, a.linf_norm(),
           a.l2_norm_squared_words(), a.l2_check(norm - 1), a.l2_check(norm))
    for g, w in zip(got, want):
        assert g.cpu().numpy().astype(w.dtype).tolist() == w.tolist()
    assert Rq.recompose(ring, dig, 256) == a
    with pytest.raises(ValueError, match="needs coeff form"):
        fa.decompose(256, k)


def test_ring_elems_and_models_registry():
    ring = get_ring("babybear", device="cpu")
    rng = np.random.default_rng(8)
    e, ec = RingElems(ring), RingCoeffElems(ring)
    x, y = e.rand((2,), rng), ec.rand((2,), rng)
    assert e.elem_ndim == 1 and e.elem_shape == (ring.D,)
    assert torch.equal(e.mul(x, y), ring.ntt_mul(x, y))
    assert torch.equal(ec.mul(x, y), ring.coeff_mul(x, y))
    assert torch.equal(e.mul(x, e.one()), x)
    assert torch.equal(ec.mul(x, ec.one()), x)
    assert torch.equal(e.zeros((2,)), torch.zeros_like(x))
    assert e.device.type == "cpu"
    # the registry resolves names on access, on the default device
    assert models.get_ring is get_ring and models.RingModel is type(ring)
    assert models.get_ring("stark_prime", device="cpu").field.limbed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.stark_prime
    with pytest.raises(AttributeError):
        models.nope
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.goldilocks
