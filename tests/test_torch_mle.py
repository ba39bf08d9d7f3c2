"""The port's Goldilocks field reductions, DenseMLE, MLE helpers, the
K5/K6 twins and wrappers (CPU tensors) and the digit-GEMM evaluation,
against the JAX reference on the same seeded inputs.  Exact equality
throughout (tolerance 0): these are integers mod q."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.linalg import FieldElems as RFieldElems
from stark_rings_tpu.mle import DenseMLE as RDenseMLE
from stark_rings_tpu.mle import mxu_eval as RM
from stark_rings_tpu.mle import polynomials as RP
from stark_rings_tpu.mle.pallas_fix import (evaluate_goldilocks_pallas,
                                            fix_last_goldilocks_pallas)

from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.mle import fix as FX
from stark_rings_tpu_torch.mle import mxu_eval as MX
from stark_rings_tpu_torch.mle import polynomials as P
from stark_rings_tpu_torch.mle import util as U

Q = F.q
NEAR_Q = [Q - 1, Q - 2, Q - 3, 2**64 - 2**32, 2**63, 2**32 - 1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _u64(rng, shape):
    return rng.integers(0, Q, size=shape, dtype=np.uint64)


def _t(x):
    return to_torch(np.asarray(x, dtype=np.uint64), "cpu")


def _np(t):
    return to_numpy_u64(t)


def _ints(x):
    return [int(v) for v in np.asarray(x, dtype=np.uint64).reshape(-1)]


# -- field -------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 9, 100])
def test_field_sum_matches_reference(n):
    """The halving-tree sum, odd lengths included, on values near q
    (torch.sum would wrap mod 2^64)."""
    rng = np.random.default_rng(n)
    x = _u64(rng, (n, 3))
    x[:len(NEAR_Q)] = np.array(NEAR_Q[:n], dtype=np.uint64)[:, None]
    for axis in (0, -1):
        want = np.asarray(RF.sum(jnp.asarray(x), axis))
        assert np.array_equal(_np(F.sum(_t(x), axis)), want), axis
    assert _ints(_np(F.sum(_t(x[:, 0]), 0))) == [sum(_ints(x[:, 0])) % Q]
    assert int(_np(F.dot(_t(x[:, 0]), _t(x[:, 1]), 0))) == \
        int(RF.dot(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), 0))


def test_field_sum_of_empty_axis_is_zero():
    assert torch.equal(F.sum(torch.zeros((0, 4), dtype=torch.int64), 0),
                       torch.zeros(4, dtype=torch.int64))


def test_field_inv_pow_const_and_constants():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.array([1, 2] + NEAR_Q, dtype=np.uint64),
                        rng.integers(1, Q, 64, dtype=np.uint64)])
    assert np.array_equal(_np(F.inv(_t(x))), np.asarray(RF.inv(
        jnp.asarray(x))))
    assert _ints(_np(F.mul(F.inv(_t(x)), _t(x)))) == [1] * x.size
    for e in (0, 1, 2, 3, 7, 64, 2**32 + 5, Q - 1):
        want = np.asarray(RF.pow_const(jnp.asarray(x), e))
        assert np.array_equal(_np(F.pow_const(_t(x), e)), want), e
    assert int(_np(F.const(-1, "cpu"))) == int(RF.const(-1)) == Q - 1
    assert _ints(_np(F.ones((3,), "cpu"))) == _ints(np.asarray(RF.ones((3,))))
    assert _ints(_np(F.zeros((2,), "cpu"))) == [0, 0]


# -- DenseMLE ----------------------------------------------------------------


def _pair(nv, rng):
    ev = _u64(rng, 1 << nv)
    return (DenseMLE(FieldElems(F, "cpu"), nv, _t(ev)),
            RDenseMLE(RFieldElems(RF), nv, jnp.asarray(ev)))


def _same(mine, ref):
    assert mine.num_vars == ref.num_vars
    assert np.array_equal(_np(mine.evals), np.asarray(ref.evals))


@pytest.mark.parametrize("nv", [1, 5, 9])
def test_dense_mle_matches_reference(nv):
    """Every ported DenseMLE method, with distinct random points."""
    rng = np.random.default_rng(nv)
    m, r = _pair(nv, rng)
    o, ro = _pair(nv, rng)
    pts = _u64(rng, nv)
    tp, jp = list(_t(pts)), [jnp.asarray(p) for p in pts]
    s = _u64(rng, ())
    ts, js = _t(s), jnp.asarray(s)

    assert int(_np(m.evaluate(tp))) == int(r.evaluate(jp))
    for k in range(nv + 1):
        _same(m.fix_variables(tp[:k]), r.fix_variables(jp[:k]))
        _same(m.fix_last_variables(tp[:k]), r.fix_last_variables(jp[:k]))
    _same(m.add(o), r.add(ro))
    _same(m.sub(o), r.sub(ro))
    _same(m.neg(), r.neg())
    _same(m.scalar_mul(ts), r.scalar_mul(js))
    _same(m.scalar_add(ts), r.scalar_add(js))
    _same(m.axpy(ts, o), r.axpy(js, ro))
    for a, b, k in [(0, nv // 2, nv // 2), (nv - 1, 0, 1), (1, 1, 1),
                    (0, 2, 0), (1, nv - 2, 2)]:
        lo, hi = sorted((a, b))
        if lo == hi or k == 0 or (hi + k <= nv and lo + k <= hi):
            _same(m.relabel(a, b, k), r.relabel(a, b, k))
    for i in (0, (1 << nv) - 1, 1 << nv, 5 << nv):
        assert int(_np(m.index(i))) == int(r.index(i)), i
    i = (1 << nv) // 3
    _same(m.set_index(i, ts), r.set_index(i, js))
    with pytest.raises(IndexError):
        m.set_index(1 << nv, ts)
    assert m.decode().tolist() == r.decode().tolist()
    assert m.to_evaluations() is m.evals


@pytest.mark.parametrize("nv", [1, 5, 9])
def test_dense_mle_constructors_match_reference(nv):
    rng = random.Random(nv)
    e, re_ = FieldElems(F, "cpu"), RFieldElems(RF)
    short = [rng.randrange(Q) for _ in range((1 << nv) // 2 + 1)]
    _same(DenseMLE.from_ints(e, nv, np.array(short, dtype=object)),
          RDenseMLE.from_ints(re_, nv, np.array(short, dtype=object)))
    for n in (1, (1 << nv) - 1, 1 << nv, (1 << nv) + 3):
        ev = np.array([rng.randrange(Q) for _ in range(n)], dtype=np.uint64)
        _same(DenseMLE.from_evaluations_padded(e, nv, _t(ev)),
              RDenseMLE.from_evaluations_padded(re_, nv, jnp.asarray(ev)))
    full = np.array([rng.randrange(Q) for _ in range(1 << nv)],
                    dtype=np.uint64)
    _same(DenseMLE.from_evaluations(e, nv, _t(full)),
          RDenseMLE.from_evaluations(re_, nv, jnp.asarray(full)))
    m = DenseMLE.rand(e, nv, np.random.default_rng(nv))
    assert m.evals.shape == (1 << nv,) and m.evals.dtype == torch.int64
    with pytest.raises(ValueError):
        DenseMLE(e, nv, _t(full[:-1]))


def test_polynomial_helpers_match_reference():
    nv, e, re_ = 4, FieldElems(F, "cpu"), RFieldElems(RF)
    mles, total = P.random_mle_list(e, nv, 3, np.random.default_rng(2))
    want = RF.sum(RF.mul(RF.mul(jnp.asarray(_np(mles[0].evals)),
                                jnp.asarray(_np(mles[1].evals))),
                         jnp.asarray(_np(mles[2].evals))), 0)
    assert int(_np(total)) == int(want)
    zero = P.random_zero_mle_list(e, nv, 3, np.random.default_rng(3))
    assert len(zero) == 3 and not zero[0].evals.any()
    assert np.array_equal(_np(P.identity_permutation(e, nv, 3)),
                          np.asarray(RP.identity_permutation(re_, nv, 3)))
    for a, b in zip(P.identity_permutation_mles(e, nv, 2),
                    RP.identity_permutation_mles(re_, nv, 2)):
        _same(a, b)
    assert np.array_equal(
        _np(P.random_permutation(e, nv, 2, random.Random(5))),
        np.asarray(RP.random_permutation(re_, nv, 2, random.Random(5))))
    for a, b in zip(P.random_permutation_mles(e, nv, 2, random.Random(6)),
                    RP.random_permutation_mles(re_, nv, 2,
                                               random.Random(6))):
        _same(a, b)
    rng = np.random.default_rng(7)
    ms = [_pair(nv, rng) for _ in range(3)]
    _same(P.merge_polynomials([m for m, _ in ms]),
          RP.merge_polynomials([r for _, r in ms]))
    m, r = ms[0]
    pts = _u64(rng, nv)
    tp, jp = list(_t(pts)), [jnp.asarray(p) for p in pts]
    assert int(_np(P.evaluate_opt(m, tp))) == int(RP.evaluate_opt(r, jp))
    _same(P.fix_variables(m, tp[:2]), RP.fix_variables(r, jp[:2]))
    _same(P.fix_last_variables(m, tp[:2]), RP.fix_last_variables(r, jp[:2]))
    with pytest.raises(ValueError):
        P.merge_polynomials([m, DenseMLE.rand(e, nv + 1, rng)])


def test_util_is_the_reference_util():
    from stark_rings_tpu.mle import util as RU

    for fn, args in [("bit_decompose", (11, 6)), ("get_index", (13, 5)),
                     ("get_batched_nv", (3, 5)),
                     ("gen_eval_point_bits", (6, 4)),
                     ("swap_bits", (0b110010, 1, 4, 2))]:
        assert getattr(U, fn)(*args) == getattr(RU, fn)(*args), fn
    assert U.project(U.bit_decompose(45, 7)) == 45


# -- K5 and K6: twins and wrappers on CPU tensors ---------------------------


@pytest.mark.parametrize("nv", [9, 11])
def test_evaluate_twin_matches_pallas_kernel(nv):
    """K5's twin and its wrapper on a CPU tensor against the Pallas kernel
    in interpret mode (tests/test_mle.py's sizes)."""
    rng = np.random.default_rng(20 + nv)
    ev = _u64(rng, 1 << nv)
    pts = _u64(rng, nv)
    want = int(evaluate_goldilocks_pallas(
        jnp.asarray(ev), [np.uint64(p) for p in pts], interpret=True))
    assert int(_np(FX.evaluate_goldilocks_ref(_t(ev), _t(pts)))) == want
    before = dict(FX.LAUNCHES)
    got = FX.evaluate_goldilocks(_t(ev), [int(p) for p in pts])
    assert got.dim() == 0 and int(_np(got)) == want
    assert FX.LAUNCHES == before          # CPU tensors launch nothing


@pytest.mark.parametrize("nv,k", [(9, 2), (11, 4)])
def test_fix_last_twin_matches_pallas_kernel(nv, k):
    rng = np.random.default_rng(30 + nv)
    ev = _u64(rng, 1 << nv)
    pts = _u64(rng, k)
    want = np.asarray(fix_last_goldilocks_pallas(
        jnp.asarray(ev), [np.uint64(p) for p in pts], interpret=True))
    assert np.array_equal(_np(FX.fix_last_goldilocks_ref(_t(ev), _t(pts))),
                          want)
    assert np.array_equal(_np(FX.fix_last_goldilocks(_t(ev), list(_t(pts)))),
                          want)


@pytest.mark.parametrize("nv", [1, 4, 8])
def test_evaluate_wrapper_below_the_reference_cut(nv):
    """K5's wrapper takes tables below the reference kernel's nv >= 9
    (there the reference calls DenseMLE.evaluate): the same value as
    the JAX DenseMLE.evaluate."""
    rng = np.random.default_rng(60 + nv)
    ev = _u64(rng, 1 << nv)
    pts = _u64(rng, nv)
    want = RDenseMLE(RFieldElems(RF), nv, jnp.asarray(ev)).evaluate(
        [jnp.asarray(p) for p in pts])
    assert int(_np(FX.evaluate_goldilocks(_t(ev), _t(pts)))) == int(want)


def test_kernel_wrappers_keep_the_reference_contracts():
    with pytest.raises(ValueError, match="nv >= 1"):
        FX.evaluate_goldilocks(torch.zeros(1, dtype=torch.int64), [])
    with pytest.raises(ValueError, match="points"):
        FX.evaluate_goldilocks(torch.zeros(1 << 9, dtype=torch.int64), [0])
    big = torch.zeros(1 << 10, dtype=torch.int64)
    for k in (0, 4):
        with pytest.raises(ValueError, match="k <= nv - 7"):
            FX.fix_last_goldilocks(big, [0] * k)
    with pytest.raises(ValueError, match="power of two"):
        FX.fix_last_goldilocks(torch.zeros(1000, dtype=torch.int64), [0])
    with pytest.raises(TypeError):
        FX.evaluate_goldilocks(big.to(torch.int32), [0] * 10)


# -- mxu_eval ----------------------------------------------------------------


@pytest.mark.parametrize("nv", [4, 10, 14])
def test_mxu_eval_matches_reference(nv):
    """The digit-GEMM evaluation and fix-last-variables (the unsigned
    scheme; the signed one has its own test below) against the
    reference's, and evaluate_many with W = 4."""
    rng = np.random.default_rng(40 + nv)
    ev = _u64(rng, 1 << nv)
    pts = _u64(rng, nv)
    jev, jp = jnp.asarray(ev), [jnp.asarray(p) for p in pts]
    assert int(_np(MX.evaluate_goldilocks_mxu(_t(ev), _t(pts)))) == \
        int(RM.evaluate_goldilocks_mxu(jev, jp))
    for h in sorted({1, 3, nv // 2, min(nv - 1, 9)}):
        assert np.array_equal(
            _np(MX.fix_last_variables_mxu(_t(ev), _t(pts[:h]))),
            np.asarray(RM.fix_last_variables_mxu(jev, jp[:h]))), h
    W = _u64(rng, (4, nv))
    assert np.array_equal(
        _np(MX.evaluate_many_goldilocks_mxu(_t(ev), _t(W))),
        np.asarray(RM.evaluate_many_goldilocks_mxu(jev, W)))


def test_mxu_signed_contraction_matches_reference():
    """A contraction over R = 2^13 > _U8_MAX_R rows takes the signed
    7-bit scheme (int8 weights straight into _int_mm)."""
    rng = np.random.default_rng(50)
    ev = _u64(rng, 1 << 14)
    pts = _u64(rng, 13)
    assert (1 << 13) > MX._U8_MAX_R
    got = MX.fix_last_variables_mxu(_t(ev), _t(pts))
    want = RDenseMLE(RFieldElems(RF), 14, jnp.asarray(ev)) \
        .fix_last_variables([jnp.asarray(p) for p in pts]).evals
    assert np.array_equal(_np(got), np.asarray(want))
