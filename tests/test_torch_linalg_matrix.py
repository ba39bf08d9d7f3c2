"""The port's dense ring ``Matrix`` (``stark_rings_tpu_torch/linalg/``
``matrix.py``) and ``linalg/ops.py`` on the CPU against the reference's
``stark_rings_tpu.linalg`` for goldilocks, babybear and frog: the
constructors, pads, concatenations and transpose, add / sub /
scalar_mul, ``mul_vec`` (and its ``AlgebraError``), the k-blocked
``mul_mat`` at several blocks against the unblocked one, and the gadget
decomposition of ring and scalar matrices.  Matrices are numpy-seeded
storage words carried across; the tolerance is exact equality."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import (FieldElems as RefFieldElems,
                                    Matrix as RefMatrix,
                                    RingElems as RefRingElems)
from stark_rings_tpu.linalg import rounded_div_jnp
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import from_jax_storage, get_field, to_numpy_storage
from stark_rings_tpu_torch.linalg import (AlgebraError, FieldElems, Matrix,
                                          RingElems, pad_ragged,
                                          rounded_div_torch, transpose)
from stark_rings_tpu_torch.rings import get_ring
from stark_rings_tpu_torch.spec.decomp import rounded_div

NAMES = ["goldilocks", "babybear", "frog"]


def _elems(name, ring_elems):
    if ring_elems:
        return (RingElems(get_ring(name, device="cpu")),
                RefRingElems(ref_ring(name)))
    return FieldElems(get_field(name), "cpu"), RefFieldElems(ref_field(name))


def _draw(e, shape, rng):
    """Storage words [*shape]+elem of uniform elements, in both packages."""
    f = e.f
    dt = np.uint32 if f.dtype == torch.int32 else np.uint64
    words = rng.integers(0, f.q, tuple(shape) + tuple(e.elem_shape), dtype=dt)
    return from_jax_storage(f, words, "cpu"), jnp.asarray(words)


def _same(got, want, what):
    g = got.vals if isinstance(got, Matrix) else got
    w = want.vals if isinstance(want, RefMatrix) else want
    assert np.array_equal(to_numpy_storage(g), np.asarray(w)), what


def _pair(e, re, shape, rng):
    x, xr = _draw(e, shape, rng)
    return Matrix(e, x), RefMatrix(re, xr)


@pytest.mark.parametrize("ring_elems", [False, True], ids=["field", "ring"])
@pytest.mark.parametrize("name", NAMES)
def test_constructors_and_structure(name, ring_elems):
    e, re = _elems(name, ring_elems)
    rng = np.random.default_rng(NAMES.index(name))
    _same(Matrix.zero(e, 2, 3), RefMatrix.zero(re, 2, 3), "zero")
    _same(Matrix.identity(e, 3), RefMatrix.identity(re, 3), "identity")
    ints = np.array(rng.integers(0, 1 << 30, (2, 3) + tuple(e.elem_shape)),
                    dtype=object)
    _same(Matrix.from_ints(e, ints), RefMatrix.from_ints(re, ints),
          "from_ints")
    R = Matrix.rand(e, 3, 4, np.random.default_rng(5))
    assert R.vals.shape == (3, 4) + tuple(e.elem_shape)
    assert R.vals.device == e.device
    A, Ar = _pair(e, re, (2, 3), rng)
    B, Br = _pair(e, re, (2, 3), rng)
    assert (A.nrows, A.ncols) == (2, 3)
    assert np.array_equal(A.decode(), Ar.decode())
    _same(A.pad_rows(4).pad_cols(5), Ar.pad_rows(4).pad_cols(5), "pads")
    _same(A.hconcat(B), Ar.hconcat(Br), "hconcat")
    _same(A.vconcat(B), Ar.vconcat(Br), "vconcat")
    _same(A.transpose(), Ar.transpose(), "transpose")
    _same(transpose(A.vals, len(e.elem_shape)), Ar.transpose(), "ops")
    s, sr = _draw(e, (), rng)
    add, sub, smul = jax.jit(lambda a, b, s: tuple(
        m.vals for m in (RefMatrix(re, a).add(RefMatrix(re, b)),
                         RefMatrix(re, a).sub(RefMatrix(re, b)),
                         RefMatrix(re, a).scalar_mul(s))))(Ar.vals, Br.vals,
                                                           sr)
    _same(A.add(B), add, "add")
    _same(A.sub(B), sub, "sub")
    _same(A.scalar_mul(s), smul, "scalar_mul")


@pytest.mark.parametrize("ring_elems", [False, True], ids=["field", "ring"])
@pytest.mark.parametrize("name", NAMES)
def test_mul_vec_and_blocked_mul_mat(name, ring_elems):
    """mul_vec and the try_* aliases, AlgebraError on a mismatch; mul_mat
    unblocked, at blocks 1, 3 and 6, and by its auto-block, equal to each
    other and to the reference's."""
    e, re = _elems(name, ring_elems)
    rng = np.random.default_rng(10 + NAMES.index(name))
    A, Ar = _pair(e, re, (3, 7), rng)
    B, Br = _pair(e, re, (7, 2), rng)
    v, vr = _draw(e, (7,), rng)
    got = A.mul_vec(v)
    _same(got, jax.jit(Ar.mul_vec)(vr), "mul_vec")
    assert torch.equal(A.try_mul_vec(v), got)
    with pytest.raises(AlgebraError, match="DifferentLengths"):
        A.mul_vec(v[:6])
    with pytest.raises(AlgebraError):
        A.try_mul_mat(A)
    assert issubclass(AlgebraError, ValueError)
    full = A.mul_mat(B, block=7)
    _same(full, jax.jit(lambda a, b: RefMatrix(re, a).mul_mat(
        RefMatrix(re, b), block=7).vals)(Ar.vals, Br.vals), "mul_mat")
    _same(A.mul_mat(B, block=3), jax.jit(lambda a, b: RefMatrix(re, a)
                                         .mul_mat(RefMatrix(re, b), block=3)
                                         .vals)(Ar.vals, Br.vals),
          "mul_mat block 3")
    for blk in (1, 3, 6, None):
        assert torch.equal(A.mul_mat(B, block=blk).vals, full.vals), blk
    assert torch.equal(A.try_mul_mat(B).vals, full.vals)


@pytest.mark.parametrize("ring_elems", [False, True], ids=["field", "ring"])
@pytest.mark.parametrize("name", NAMES)
def test_matrix_gadget_round_trip(name, ring_elems):
    e, re = _elems(name, ring_elems)
    A, Ar = _pair(e, re, (2, 3), np.random.default_rng(20))
    b = 256
    k = 8 if get_field(name).bits == 64 else 4
    G = A.gadget_decompose(b, k)
    assert (G.nrows, G.ncols) == (2, 3 * k)
    _same(G, Ar.gadget_decompose(b, k), "gadget_decompose")
    back = G.gadget_recompose(b, k)
    _same(back, Ar.gadget_decompose(b, k).gadget_recompose(b, k),
          "gadget_recompose")
    assert torch.equal(back.vals, A.vals)


def test_rounded_div_and_pad_ragged():
    vals = [-17, -8, -5, -2, -1, 0, 1, 2, 5, 8, 17]
    divs = [-6, -4, -2, 2, 4, 6]
    for a, b in itertools.product(vals, divs):
        got = int(rounded_div_torch(torch.tensor(a), b))
        assert got == rounded_div(a, b) == int(
            rounded_div_jnp(np.int64(a), np.int64(b))), (a, b)
    a = torch.tensor(vals)
    assert rounded_div_torch(a, torch.tensor(4)).tolist() == [
        rounded_div(x, 4) for x in vals]
    out = pad_ragged([np.ones((2, 3)), np.ones((0, 3)), np.ones((1, 3))],
                     (3,), np.uint64)
    assert out.shape == (3, 2, 3) and out.sum() == 9
