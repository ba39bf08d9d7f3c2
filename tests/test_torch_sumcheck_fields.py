"""Sumcheck over BabyBear and frog, and over batched claims, on the CPU
against the JAX reference on the same numpy-seeded storage: the generic
prover and ``DenseMLE`` over both fields (nv 1-10, k 1-4, both binding
orders), the K7 wrapper (its twin on CPU tensors) against the one-pass
Pallas prover in interpret mode for babybear and frog, and the batch
wrapper against the reference's batched Pallas prover and against
single proofs.  Exact equality throughout (tolerance 0): storage words
are compared bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import FieldElems as RFieldElems
from stark_rings_tpu.mle import DenseMLE as RDenseMLE
from stark_rings_tpu.mle import sumcheck as RS
from stark_rings_tpu.mle.pallas_sumcheck import (
    sumcheck_prove_batch_goldilocks_pallas, sumcheck_prove_many_pallas)

from stark_rings_tpu_torch import from_jax_storage, get_field, \
    to_numpy_storage
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.mle import sumcheck as S
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK

FIELDS = ["babybear", "frog"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _words(f, rng, shape):
    """Uniform storage words of ``f`` (a bijection of [0, q)) as the
    reference's numpy storage."""
    dt = np.uint32 if f.dtype == torch.int32 else np.uint64
    return rng.integers(0, f.q, shape, dtype=dt)


def _inputs(field, seed, nv, k, lead=()):
    f = get_field(field)
    rng = np.random.default_rng(seed)
    tables = [_words(f, rng, (*lead, 1 << nv)) for _ in range(k)]
    return tables, _words(f, rng, nv)


def _port(field, tables, chal):
    f = get_field(field)
    return ([from_jax_storage(f, t, "cpu") for t in tables],
            from_jax_storage(f, chal, "cpu"))


def _jax(tables, chal):
    return [jnp.asarray(t) for t in tables], [jnp.asarray(c) for c in chal]


def _same(got, want):
    assert np.array_equal(to_numpy_storage(got), np.asarray(want))


def _same_proof(mine, ref):
    (m, fs), (rm, rfs) = mine, ref
    _same(m, rm)
    assert len(fs) == len(rfs)
    for a, b in zip(fs, rfs):
        _same(a, b)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("order", ["lsb", "msb"])
@pytest.mark.parametrize("field", FIELDS)
def test_generic_prover_matches_reference(field, order, k):
    """sumcheck_prove_many_with_challenges for nv = 1..10, and one
    round's messages, fold ingredients and fold at nv = 10."""
    f, rf = get_field(field), ref_field(field)
    for nv in range(1, 11):
        tables, chal = _inputs(field, 100 * k + nv, nv, k)
        tt, tc = _port(field, tables, chal)
        jt, jc = _jax(tables, chal)
        _same_proof(S.sumcheck_prove_many_with_challenges(f, tt, tc, order),
                    RS.sumcheck_prove_many_with_challenges(rf, jt, jc,
                                                           order))
    msgs, t0s, ds = S.sumcheck_round_many(f, tt, order=order)
    rmsgs, rt0s, rds = RS.sumcheck_round_many(rf, jt, order=order)
    for a, b in zip(msgs + t0s + ds, rmsgs + rt0s + rds):
        _same(a, b)
    for a, b in zip(S.sumcheck_fold_many(f, tc[0], t0s, ds),
                    RS.sumcheck_fold_many(rf, jc[0], rt0s, rds)):
        _same(a, b)


@pytest.mark.parametrize("field", FIELDS)
def test_msb_on_bit_reversed_tables_is_lsb(field):
    f = get_field(field)
    tables, chal = _inputs(field, 7, 8, 3)
    tt, tc = _port(field, tables, chal)
    lsb = S.sumcheck_prove_many_with_challenges(f, tt, tc, "lsb")
    msb = S.sumcheck_prove_many_with_challenges(
        f, [S.bit_reverse_table(t) for t in tt], tc, "msb")
    assert torch.equal(lsb[0], msb[0])
    assert all(torch.equal(a, b) for a, b in zip(lsb[1], msb[1]))
    for t, r in zip(tt, tables):
        _same(S.bit_reverse_table(t), RS.bit_reverse_table(jnp.asarray(r)))


@pytest.mark.parametrize("nv", [1, 2, 5, 10])
@pytest.mark.parametrize("field", FIELDS)
def test_dense_mle_matches_reference(field, nv):
    """evaluate, fix_variables and fix_last_variables on the field's
    storage (BabyBear int32, frog int64), and from_ints."""
    f, rf = get_field(field), ref_field(field)
    rng = np.random.default_rng(nv)
    ev = _words(f, rng, 1 << nv)
    pts = _words(f, rng, nv)
    mine = DenseMLE(FieldElems(f, "cpu"), nv, from_jax_storage(f, ev, "cpu"))
    ref = RDenseMLE(RFieldElems(rf), nv, jnp.asarray(ev))
    tp = list(from_jax_storage(f, pts, "cpu"))
    jp = [jnp.asarray(p) for p in pts]
    assert mine.evals.dtype == f.dtype
    _same(mine.evaluate(tp), ref.evaluate(jp))
    for h in sorted({1, nv // 2, nv}):
        _same(mine.fix_variables(tp[:h]).evals,
              ref.fix_variables(jp[:h]).evals)
        _same(mine.fix_last_variables(tp[:h]).evals,
              ref.fix_last_variables(jp[:h]).evals)
    ints = [int(v) for v in rng.integers(0, f.q, (1 << nv) - 1,
                                         dtype=np.uint64)] + [f.q - 1]
    _same(DenseMLE.from_ints(FieldElems(f, "cpu"), nv, ints).evals,
          RDenseMLE.from_ints(RFieldElems(rf), nv, ints).evals)


@pytest.mark.parametrize("field", FIELDS)
def test_k7_matches_pallas_kernel_in_interpret_mode(field):
    """K7's wrapper on CPU tensors (its twin) against the reference's
    one-pass Pallas prover with the field's ops (``_BbOps`` /
    ``_FrogOps``) in interpret mode, nv = 12, k = 2."""
    tables, chal = _inputs(field, 12, 12, 2)
    want = sumcheck_prove_many_pallas(*_jax(tables, chal), interpret=True,
                                      field=field)
    tt, tc = _port(field, tables, chal)
    before = dict(SK.LAUNCHES)
    _same_proof(SK.sumcheck_prove_many(tt, tc, field=field), want)
    _same_proof(SK.sumcheck_prove_many(tt, list(tc), field=field), want)
    _same_proof(SK.sumcheck_prove_many_ref(tt, tc, field), want)
    assert SK.LAUNCHES == before


@pytest.mark.parametrize("nv,k", [(1, 3), (4, 1), (9, 4), (13, 2)])
@pytest.mark.parametrize("field", FIELDS)
def test_k7_wrapper_matches_generic_msb_prover(field, nv, k):
    tables, chal = _inputs(field, nv * 10 + k, nv, k)
    tt, tc = _port(field, tables, chal)
    _same_proof(SK.sumcheck_prove_many(tt, tc, field=field),
                RS.sumcheck_prove_many_with_challenges(
                    ref_field(field), *_jax(tables, chal), order="msb"))


def test_batch_matches_pallas_batch_in_interpret_mode():
    """sumcheck_prove_batch_goldilocks against the reference's batched
    prover in interpret mode, W = 2 claims at nv = 12."""
    tables, chal = _inputs("goldilocks", 2, 12, 2, lead=(2,))
    rm, rfs = sumcheck_prove_batch_goldilocks_pallas(
        [jnp.asarray(t) for t in tables], [jnp.asarray(c) for c in chal],
        interpret=True)
    tt, tc = _port("goldilocks", tables, chal)
    m, fs = SK.sumcheck_prove_batch_goldilocks(tt, tc)
    assert m.shape == (2, 12, 3) and [tuple(x.shape) for x in fs] == [(2,)] * 2
    _same_proof((m, fs), (rm, rfs))


@pytest.mark.parametrize("W", [1, 3, 4])
def test_batch_matches_single_proofs(W):
    """W claims: claim w's proof is the single proof of row w, for
    k = 1..3, and equals the reference's generic prover."""
    rf = ref_field("goldilocks")
    for k in (1, 2, 3):
        tables, chal = _inputs("goldilocks", W * 10 + k, 6, k, lead=(W,))
        tt, tc = _port("goldilocks", tables, chal)
        m, fs = SK.sumcheck_prove_batch_goldilocks(tt, tc)
        assert m.shape == (W, 6, k + 1) and m.dtype == torch.int64
        for w in range(W):
            single = SK.sumcheck_prove_many([T[w] for T in tt], tc)
            assert torch.equal(m[w], single[0])
            assert all(torch.equal(x[w], y) for x, y in zip(fs, single[1]))
            _same_proof((m[w], [x[w] for x in fs]),
                        RS.sumcheck_prove_many_with_challenges(
                            rf, [jnp.asarray(t[w]) for t in tables],
                            [jnp.asarray(c) for c in chal], order="msb"))


def test_batch_rejects_bad_tables():
    T = torch.zeros((2, 1 << 4), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\[W, 2\^nv\]"):
        SK.sumcheck_prove_batch_goldilocks([T[0], T[0]], [0] * 4)
    with pytest.raises(ValueError, match=r"\[W, 2\^nv\]"):
        SK.sumcheck_prove_batch_goldilocks([T[:0], T[:0]], [0] * 4)
    with pytest.raises(ValueError, match=r"torch.int64 \[2, 16\]"):
        SK.sumcheck_prove_batch_goldilocks([T, T[:, :8]], [0] * 4)
    with pytest.raises(ValueError, match=r"torch.int64 \[2, 16\]"):
        SK.sumcheck_prove_batch_goldilocks([T.int(), T.int()], [0] * 4)
    with pytest.raises(ValueError, match="1-D torch.int32"):
        SK.sumcheck_prove_many([T[0].int()], torch.zeros(4,
                                                         dtype=torch.int64),
                               field="babybear")
