"""The port's decomposition layer (``stark_rings_tpu_torch/decomp/``) on
the CPU against the reference's ``stark_rings_tpu.decomp`` for
goldilocks, babybear and frog: balanced digits, recompose and the gadget
round trip, center / sign / linf_norm, the exact L2 words through the
unchunked and the chunked reduction on full-range and short inputs,
``l2_check`` at bound - 1, bound and bound + 1, and ``Rq``'s
decomposition methods.  Inputs are numpy-seeded storage words (with the
field's edge values) carried across; the tolerance is exact equality of
the stored words."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stark_rings_tpu.decomp as RD
from stark_rings_tpu.fields import get_field as ref_field

import stark_rings_tpu_torch.decomp as PD
from stark_rings_tpu_torch import from_jax_storage, get_field, to_numpy_storage
from stark_rings_tpu_torch.decomp.norms import int_to_words
from stark_rings_tpu_torch.decomp.representatives import (
    SignedRepresentative, UnsignedRepresentative)
from stark_rings_tpu_torch.rings import Rq, get_ring

NAMES = ["goldilocks", "babybear", "frog"]
BASES = (4, 256, 65536)


def J(fn, f, **static):
    """The reference function ``fn(f, x, ...)`` jitted over x (one compile
    of the whole graph, much faster here than its ops one by one)."""
    return jax.jit(lambda x: fn(f, x, **static))


def _vals(name, shape, seed, short=False):
    """(port storage, reference storage) of canonical values: the field's
    edges then numpy draws, full range or short signed (|v| <= 1000)."""
    f, rf = get_field(name), ref_field(name)
    q = f.q
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if short:
        ints = [int(v) % q for v in rng.integers(-1000, 1001, n)]
    else:
        edges = [0, 1, 2, q - 1, q - 2, (q - 1) // 2, (q + 1) // 2]
        ints = (edges + [int(v) for v in rng.integers(0, q, n,
                                                      dtype=np.uint64)])[:n]
    arr = np.array(ints, dtype=object).reshape(shape)
    ref = rf.encode(arr)
    return from_jax_storage(f, np.asarray(ref), "cpu"), ref


def _same(got, want, what):
    assert np.array_equal(to_numpy_storage(got), np.asarray(want)), what


@pytest.mark.parametrize("name", NAMES)
def test_decompose_recompose_match_reference(name):
    f, rf = get_field(name), ref_field(name)
    x, xr = _vals(name, (5, 11), 1)
    for b in BASES:
        k = PD.decomposition_max_length(f.q, b)
        assert k == RD.decomposition_max_length(f.q, b)
        dig = PD.decompose(f, x, b, k)
        assert dig.shape == (5, 11, k)
        _same(dig, J(RD.decompose, rf, b=b, k=k)(xr), (name, b))
        back = PD.recompose(f, dig, b)
        assert torch.equal(back, x)
        if b == 256:
            _same(back, J(RD.recompose, rf, b=b)(jnp.asarray(
                to_numpy_storage(dig))), (name, b, "recompose"))


@pytest.mark.parametrize("name", NAMES)
def test_gadget_round_trip_matches_reference(name):
    """[n, D] ring rows: decompose_ring / gadget_decompose digit order
    (column l*k + j holds digit j of element l) and their inverses."""
    f, rf = get_field(name), ref_field(name)
    D = get_ring(name, device="cpu").D
    x, xr = _vals(name, (2, 3, D), 2)
    b, k = 256, PD.decomposition_max_length(f.q, 256)
    dr = PD.decompose_ring(f, x, b, k)
    assert dr.shape == (2, 3, k, D)
    _same(dr, J(RD.decompose_ring, rf, b=b, k=k)(xr), "decompose_ring")
    assert torch.equal(PD.recompose_ring(f, dr, b), x)
    g = PD.gadget_decompose(f, x, b, k)
    assert g.shape == (2, 3 * k, D)
    _same(g, J(RD.gadget_decompose, rf, b=b, k=k)(xr), "gadget")
    assert torch.equal(g[:, k:2 * k], dr[:, 1])
    assert torch.equal(PD.gadget_recompose(f, g, b, k), x)


@pytest.mark.parametrize("name", NAMES)
def test_center_sign_linf_match_reference(name):
    f, rf = get_field(name), ref_field(name)
    x, xr = _vals(name, (4, 9), 3)
    neg, mag = PD.signed_magnitude(f, x)
    rneg, rmag = J(RD.signed_magnitude, rf)(xr)
    assert np.array_equal(neg.numpy(), np.asarray(rneg))
    _same(mag, rmag, "magnitude")
    _same(PD.center(f, x), J(RD.center, rf)(xr), "center")
    _same(PD.sign(f, x), J(RD.sign, rf)(xr), "sign")
    _same(PD.linf_norm(f, x), J(RD.linf_norm, rf)(xr), "linf")
    _same(PD.linf_norm(f, x, axis=1), J(RD.linf_norm, rf, axis=1)(xr),
          "linf axis 1")
    ints = f.decode(x).reshape(-1)
    assert PD.linf_norm_exact(f, x) == max(
        abs(SignedRepresentative.from_field(f, int(v)).value) for v in ints)


@pytest.mark.parametrize("short", [False, True], ids=["full", "short"])
@pytest.mark.parametrize("name", NAMES)
def test_l2_words_match_reference(name, short):
    """The unchunked sum, a forced chunk_n (the chunked path), a reduced
    tuple of axes and a kept axis: the words equal the reference's, and
    their integer the exact host norm."""
    f, rf = get_field(name), ref_field(name)
    x, xr = _vals(name, (3, 7, 5), 4, short)
    fn = J(RD.l2_norm_squared_words, rf)
    for kw in ({}, {"chunk_n": 8}, {"axis": (0, 2)},
               {"axis": (0, 2), "chunk_n": 4}, {"axis": 1}):
        got = PD.l2_norm_squared_words(f, x, **kw)
        _same(got, J(RD.l2_norm_squared_words, rf, **kw)(xr), (name, kw))
    host = PD.l2_norm_squared(f, x)
    assert host == RD.l2_norm_squared(rf, xr)
    assert PD.words_to_int(PD.l2_norm_squared_words(f, x)) == host
    assert PD.words_to_int(PD.l2_norm_squared_words(f, x, chunk_n=8)) == host
    per = PD.l2_norm_squared_words(f, x, axis=(0, 2))
    for w in range(7):
        assert PD.words_to_int(per[w]) == PD.l2_norm_squared(f, x[:, w])
    assert int(fn(xr).shape[-1]) == PD.l2_norm_squared_words(f, x).shape[-1]


@pytest.mark.parametrize("name", NAMES)
def test_l2_check_at_the_bound(name):
    f, rf = get_field(name), ref_field(name)
    x, xr = _vals(name, (2, 6, 4), 5, short=True)
    per = PD.l2_norm_squared_words(f, x, axis=(0, 2))
    bound = PD.words_to_int(per[0])
    for bsq in (bound - 1, bound, bound + 1, 1 << 200):
        got = PD.l2_check(f, x, bsq, axis=(0, 2))
        want = J(RD.l2_check, rf, bound_sq=bsq, axis=(0, 2))(xr)
        assert np.array_equal(got.numpy(), np.asarray(want)), bsq
        assert got.tolist() == [bsq >= PD.words_to_int(w) for w in per]
    whole = PD.words_to_int(PD.l2_norm_squared_words(f, x))
    for bsq in (whole - 1, whole, whole + 1):
        assert bool(PD.l2_check(f, x, bsq)) == (bsq >= whole)


def test_int_words_round_trip_and_representatives():
    v = (1 << 95) + 12345
    w = int_to_words(v, 4, "cpu")
    assert w.dtype == torch.int64 and w.tolist() == [12345, 0, 1 << 31, 0]
    assert PD.words_to_int(w) == v == PD.words_to_int(w.numpy())
    f = get_field("goldilocks")
    s = SignedRepresentative.from_field(f, f.q - 5)
    assert s == -5 and s.to_field_int(f) == f.q - 5
    assert abs(s) * 2 + 1 == 11 and UnsignedRepresentative(7) < 8


def test_limbed_fields_wait_for_stark_prime():
    """The limbed field decomposes: its magnitudes are limb tensors and
    its balanced digits recompose (held against the reference in
    tests/test_torch_stark_ring.py)."""
    f = get_field("stark_prime")
    x = f.encode([0, 5, -5, (f.q - 1) // 2, (f.q + 1) // 2], "cpu")
    neg, mag = PD.signed_magnitude(f, x)
    assert neg.tolist() == [False, False, True, False, True]
    assert mag.shape == (5, 8) and mag.dtype == torch.int32
    dig = PD.decompose(f, x, 1 << 16, 16)
    assert dig.shape == (5, 16, 8)
    assert torch.equal(PD.recompose(f, dig, 1 << 16), x)


@pytest.mark.parametrize("name", NAMES)
def test_rq_decomposition_methods(name):
    """Rq's five methods are the functions held above, on its storage."""
    ring = get_ring(name, device="cpu")
    f = ring.field
    x, _ = _vals(name, (3, ring.D), 6)
    a = Rq.coeff(ring, x)
    b, k = 256, PD.decomposition_max_length(ring.q, 256)
    dig = a.decompose(b, k)
    assert torch.equal(dig, PD.decompose_ring(f, x, b, k))
    assert Rq.recompose(ring, dig, b) == a
    assert torch.equal(a.linf_norm(), PD.linf_norm(f, x))
    assert torch.equal(a.l2_norm_squared_words(),
                       PD.l2_norm_squared_words(f, x))
    bound = PD.words_to_int(a.l2_norm_squared_words())
    assert bool(a.l2_check(bound)) and not bool(a.l2_check(bound - 1))
    with pytest.raises(ValueError, match="coeff form"):
        a.crt().decompose(b, k)
