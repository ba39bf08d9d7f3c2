"""The port's generic sumcheck prover and the K7 wrapper (CPU tensors:
its twin) against the JAX reference on the same seeded inputs: every
prover function in both binding orders, the msb/lsb bit-reversal
identity, and the one-pass Pallas prover in interpret mode.  Exact
equality throughout (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.mle import sumcheck as RS
from stark_rings_tpu.mle.pallas_sumcheck import sumcheck_prove_many_pallas

from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.mle import sumcheck as S
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK

Q = F.q


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return to_numpy_u64(t)


def _inputs(seed, nv, k):
    rng = np.random.default_rng(seed)
    tables = [rng.integers(0, Q, 1 << nv, dtype=np.uint64) for _ in range(k)]
    chal = rng.integers(0, Q, nv, dtype=np.uint64)
    return tables, chal


def _port(tables, chal):
    return [to_torch(t, "cpu") for t in tables], to_torch(chal, "cpu")


def _jax(tables, chal):
    return [jnp.asarray(t) for t in tables], [jnp.asarray(c) for c in chal]


def _same_proof(mine, ref):
    (m, f), (rm, rf) = mine, ref
    assert np.array_equal(_np(m), np.asarray(rm))
    assert [int(_np(v)) for v in f] == [int(v) for v in rf]


@pytest.mark.parametrize("order", ["lsb", "msb"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_generic_prover_matches_reference(k, order):
    """sumcheck_round_many / fold_many / prove_many at nv = 8, and for
    k = 2 the dedicated two-table round, fold and prover."""
    nv = 8
    tables, chal = _inputs(k + (order == "msb"), nv, k)
    tt, tc = _port(tables, chal)
    jt, jc = _jax(tables, chal)
    _same_proof(S.sumcheck_prove_many_with_challenges(F, tt, tc, order),
                RS.sumcheck_prove_many_with_challenges(RF, jt, jc, order))
    msgs, t0s, ds = S.sumcheck_round_many(F, tt, order=order)
    rmsgs, rt0s, rds = RS.sumcheck_round_many(RF, jt, order=order)
    for a, b in zip(msgs + t0s + ds, rmsgs + rt0s + rds):
        assert np.array_equal(_np(a), np.asarray(b))
    for a, b in zip(S.sumcheck_fold_many(F, tc[0], t0s, ds),
                    RS.sumcheck_fold_many(RF, jc[0], rt0s, rds)):
        assert np.array_equal(_np(a), np.asarray(b))
    if k != 2:
        return
    got = S.sumcheck_round(F, tt[0], tt[1], order)
    want = RS.sumcheck_round(RF, jt[0], jt[1], order)
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    for a, b in zip(S.sumcheck_fold(F, tc[1], *got[3:]),
                    RS.sumcheck_fold(RF, jc[1], *want[3:])):
        assert np.array_equal(_np(a), np.asarray(b))
    m, g, h = S.sumcheck_prove_with_challenges(F, tt[0], tt[1], tc, order)
    rm, rg, rh = RS.sumcheck_prove_with_challenges(RF, jt[0], jt[1], jc,
                                                   order)
    assert np.array_equal(_np(m), np.asarray(rm))
    assert int(_np(g)) == int(rg) and int(_np(h)) == int(rh)


def test_msb_on_bit_reversed_tables_is_lsb():
    nv = 8
    tables, chal = _inputs(3, nv, 2)
    tt, tc = _port(tables, chal)
    for t, r in zip(tt, tables):
        assert np.array_equal(_np(S.bit_reverse_table(t)),
                              np.asarray(RS.bit_reverse_table(
                                  jnp.asarray(r))))
    lsb = S.sumcheck_prove_many_with_challenges(F, tt, tc, "lsb")
    msb = S.sumcheck_prove_many_with_challenges(
        F, [S.bit_reverse_table(t) for t in tt], tc, "msb")
    assert torch.equal(lsb[0], msb[0])
    assert all(torch.equal(a, b) for a, b in zip(lsb[1], msb[1]))
    with pytest.raises(ValueError, match="power of two"):
        S.bit_reverse_table(torch.zeros(6, dtype=torch.int64))


def test_k7_twin_matches_pallas_kernel():
    """K7's twin and its wrapper on CPU tensors against the one-pass
    Pallas prover in interpret mode (nv = 12, k = 2, as
    tests/test_sumcheck_lib.py)."""
    tables, chal = _inputs(9, 12, 2)
    jt, jc = _jax(tables, chal)
    want = sumcheck_prove_many_pallas(jt, jc, interpret=True)
    tt, tc = _port(tables, chal)
    _same_proof(SK.sumcheck_prove_many_ref(tt, tc), want)
    before = dict(SK.LAUNCHES)
    _same_proof(SK.sumcheck_prove_many_goldilocks(tt, list(tc)), want)
    assert SK.LAUNCHES == before
    m, g, h = SK.sumcheck_prove_goldilocks(tt[0], tt[1], tc)
    assert np.array_equal(_np(m), np.asarray(want[0]))
    assert [int(_np(g)), int(_np(h))] == [int(v) for v in want[1]]


@pytest.mark.parametrize("nv,k", [(13, 3), (11, 4), (12, 1), (12, 4),
                                  (4, 2), (1, 3)])
def test_k7_wrapper_matches_generic_msb_prover(nv, k):
    """Shapes the Pallas kernel's interpret run cannot take in the
    default tier (nv = 13, k = 3), both sides of the reference's nv = 12
    cut (the port's kernel takes every nv >= 1) and small tables,
    against the JAX msb prover."""
    tables, chal = _inputs(nv * 10 + k, nv, k)
    _same_proof(SK.sumcheck_prove_many(*_port(tables, chal)),
                RS.sumcheck_prove_many_with_challenges(
                    RF, *_jax(tables, chal), order="msb"))


def test_k7_rejects_unported_fields_and_bad_tables():
    T = torch.zeros(1 << 12, dtype=torch.int64)
    with pytest.raises(ValueError, match="no sumcheck kernel for field "
                                         "'nope'"):
        SK.sumcheck_prove_many([T, T], [0] * 12, field="nope")
    with pytest.raises(TypeError, match="field"):
        SK.sumcheck_prove_batch_goldilocks([T[None], T[None]], [0] * 12,
                                           field="babybear")
    with pytest.raises(ValueError, match="int32"):
        SK.sumcheck_prove_many([T, T], [0] * 12, field="babybear")
    with pytest.raises(ValueError, match="int64"):
        SK.sumcheck_prove_many([T, T[:-1]], [0] * 12)
    with pytest.raises(ValueError, match="no tables"):
        SK.sumcheck_prove_many([], [0] * 12)
