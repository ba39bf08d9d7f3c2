"""The port's ``SparseMLE`` and ``DenseMLE.from_matrix`` on the CPU
against the reference's ``stark_rings_tpu.mle`` (mirroring
tests/test_mle.py:157-200 and tests/test_extras.py:227-256, 339):
evaluate, fix_variables and its windowed form, to_dense, index, relabel,
the arithmetic, over scalar fields and NTT-form ring elements, and the
MLEs of a sparse matrix (row-major with power-of-two padding).  Inputs
are numpy-seeded Python ints encoded by both packages; storage is
compared word for word (tolerance: bit-equal), and evaluations also
against a Python-int interpolation."""

import numpy as np
import pytest
import torch

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import (FieldElems as RefFieldElems,
                                    RingElems as RefRingElems,
                                    SparseMatrix as RefSparse)
from stark_rings_tpu.mle import DenseMLE as RefDense
from stark_rings_tpu.mle import SparseMLE as RefSparseMLE
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import get_field, to_numpy_storage
from stark_rings_tpu_torch.linalg import FieldElems, RingElems, SparseMatrix
from stark_rings_tpu_torch.mle import DenseMLE, SparseMLE, swap_bits
from stark_rings_tpu_torch.rings import get_ring


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ints(q, shape, rng):
    n = int(np.prod(shape, dtype=np.int64))
    vals = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    return np.array(vals, dtype=object).reshape(shape)


def _same(got, want, what=""):
    assert np.array_equal(to_numpy_storage(got), np.asarray(want)), what


def _same_mle(got, want):
    assert got.num_vars == want.num_vars
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    _same(got.values, want.values, "values")


def _eval_ints(evals, point, q):
    """Multilinear interpolation over {0,1}^n, little-endian."""
    cur = list(evals)
    for r in point:
        cur = [(cur[2 * b] + r * (cur[2 * b + 1] - cur[2 * b])) % q
               for b in range(len(cur) // 2)]
    return cur[0]


def _pairs(q, nv, n, rng, elem_shape=()):
    idx = rng.choice(1 << nv, size=n, replace=False)
    return [(int(i), _ints(q, elem_shape, rng)) for i in idx]


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog",
                                  "stark_prime"])
def test_sparse_evaluate_and_fix(name):
    f, rf = get_field(name), ref_field(name)
    e, re = FieldElems(f, "cpu"), RefFieldElems(rf)
    q = f.q
    rng = np.random.default_rng(36)
    nv = 6
    pairs = _pairs(q, nv, 10, rng)
    sm, rsm = SparseMLE.from_pairs(e, nv, pairs), \
        RefSparseMLE.from_pairs(re, nv, pairs)
    _same_mle(sm, rsm)
    point = list(_ints(q, (nv,), rng))
    pe, rpe = [f.encode(p, "cpu") for p in point], \
        [rf.encode(np.array(p, dtype=object)) for p in point]
    got = sm.evaluate(pe)
    _same(got, rsm.evaluate(rpe), "evaluate")
    dense = [0] * (1 << nv)
    for i, v in pairs:
        dense[i] = int(v)
    assert int(f.decode(got)) == _eval_ints(dense, point, q)
    part = sm.fix_variables(pe[:2])
    _same_mle(part, rsm.fix_variables(rpe[:2]))
    _same(part.to_dense().evals, rsm.fix_variables(rpe[:2]).to_dense().evals)
    _same(sm.to_dense().evals, rsm.to_dense().evals, "to_dense")
    assert [int(v) for v in sm.decode_dense()] == dense
    assert sm.fix_variables([]) is sm
    with pytest.raises(ValueError):
        sm.evaluate(pe[:2])


def test_sparse_arithmetic_and_relabel():
    f, rf = get_field("goldilocks"), ref_field("goldilocks")
    e, re = FieldElems(f, "cpu"), RefFieldElems(rf)
    rng = np.random.default_rng(5)
    pa, pb = _pairs(f.q, 5, 6, rng), _pairs(f.q, 5, 4, rng)
    a, ra = SparseMLE.from_pairs(e, 5, pa), RefSparseMLE.from_pairs(re, 5, pa)
    b, rb = SparseMLE.from_pairs(e, 5, pb), RefSparseMLE.from_pairs(re, 5, pb)
    s = _ints(f.q, (), rng)
    _same_mle(a.neg(), ra.neg())
    _same_mle(a.scalar_mul(e.encode(s)), ra.scalar_mul(re.encode(s)))
    _same_mle(a.add(b), ra.add(rb))
    _same_mle(a.sub(b), ra.sub(rb))
    _same(a.sub(b).to_dense().evals, ra.sub(rb).to_dense().evals)
    for args in ((0, 3, 2), (3, 0, 2), (1, 1, 2), (0, 2, 0), (1, 3, 2)):
        _same_mle(a.relabel(*args), ra.relabel(*args))
    with pytest.raises(ValueError):
        a.relabel(0, 1, 2)


def test_sparse_mle_relabel_and_ring_elements():
    """Ring elements (goldilocks, NTT form): relabel against swap_bits, and
    evaluate at ring points equal to the reference's and to the densified
    MLE's (test_extras.py:227-256)."""
    ring, rring = get_ring("goldilocks", device="cpu"), ref_ring("goldilocks")
    e, re = RingElems(ring), RefRingElems(rring)
    rng = np.random.default_rng(70)
    nv = 5
    pairs = _pairs(ring.q, nv, 6, rng, (ring.D,))
    sm, rsm = SparseMLE.from_pairs(e, nv, pairs), \
        RefSparseMLE.from_pairs(re, nv, pairs)
    rl = sm.relabel(0, 3, 2)
    _same_mle(rl, rsm.relabel(0, 3, 2))
    dense = rl.decode_dense()
    for i, v in pairs:
        assert [int(x) for x in dense[swap_bits(i, 0, 3, 2)]] == list(v)
    pts = _ints(ring.q, (nv, ring.D), rng)
    got = sm.evaluate([e.encode(p) for p in pts])
    _same(got, rsm.evaluate([re.encode(p) for p in pts]), "ring evaluate")
    assert torch.equal(got, sm.to_dense().evaluate(
        [e.encode(p) for p in pts]))


def test_sparse_mle_windowed_fix_and_index():
    """The windowed fix equals the eq-factor path, the reference's and the
    dense oracle; index() reads present, absent and duplicate entries
    (test_extras.py:339)."""
    f, rf = get_field("goldilocks"), ref_field("goldilocks")
    e, re = FieldElems(f, "cpu"), RefFieldElems(rf)
    rng = np.random.default_rng(11)
    m = SparseMLE.rand_with_config(e, 8, 20, rng)
    assert m.nnz == 20 and len(set(m.indices.tolist())) == 20
    assert torch.equal(m.indices, m.indices.sort().values)
    rm = RefSparseMLE(re, 8, m.indices.numpy(), to_numpy_storage(m.values))
    pts = list(_ints(f.q, (3,), rng))
    pe, rpe = [f.encode(p, "cpu") for p in pts], \
        [rf.encode(np.array(p, dtype=object)) for p in pts]
    a = m.fix_variables(pe)
    dense = m.to_dense().fix_variables(pe)
    for window in (None, 1, 2):
        got = m.fix_variables_windowed(pe, window=window)
        _same_mle(got, rm.fix_variables_windowed(rpe, window=window))
        assert torch.equal(got.to_dense().evals, dense.evals)
    assert torch.equal(a.to_dense().evals, dense.evals)
    m2 = SparseMLE.from_pairs(e, 4, [(3, 7), (9, 11), (3, 5)])
    assert int(f.decode(m2.index(3))) == 12
    assert int(f.decode(m2.index(9))) == 11
    assert int(f.decode(m2.index(4))) == 0


def test_mle_from_matrix_dense_and_sparse():
    """Both MLEs of a 3 x 5 matrix (padded to 4 x 8, nv = 5; index
    8*row + col) and of a ring-element matrix, against the reference."""
    f, rf = get_field("goldilocks"), ref_field("goldilocks")
    e, re = FieldElems(f, "cpu"), RefFieldElems(rf)
    q = f.q
    rng = np.random.default_rng(37)
    entries = [(0, 0, 5), (1, 2, 7), (2, 4, int(_ints(q, (), rng))),
               (1, 2, 9)]
    S, RS = SparseMatrix.from_entries(e, 3, 5, entries), \
        RefSparse.from_entries(re, 3, 5, entries)
    md = DenseMLE.from_matrix(e, S)
    assert md.num_vars == 2 + 3
    _same(md.evals, RefDense.from_matrix(re, RS).evals, "dense")
    ms = SparseMLE.from_matrix(e, S)
    _same_mle(ms, RefSparseMLE.from_matrix(re, RS))
    want = [0] * 32
    for r, c, v in entries:
        want[8 * r + c] = (want[8 * r + c] + v) % q
    assert [int(v) for v in md.decode()] == want
    assert [int(v) for v in ms.decode_dense()] == want
    ring, rring = get_ring("babybear", device="cpu"), ref_ring("babybear")
    er, rer = RingElems(ring), RefRingElems(rring)
    ents = [(0, 1, _ints(ring.q, (ring.D,), rng)),
            (4, 0, _ints(ring.q, (ring.D,), rng))]
    T, RT = SparseMatrix.from_entries(er, 5, 2, ents), \
        RefSparse.from_entries(rer, 5, 2, ents)
    _same(DenseMLE.from_matrix(er, T).evals,
          RefDense.from_matrix(rer, RT).evals, "ring dense")
    _same_mle(SparseMLE.from_matrix(er, T), RefSparseMLE.from_matrix(rer, RT))


def test_sparse_fix_of_matrix_mle_is_matvec():
    """Binding the column variables of a matrix's MLE (the low ones) at c
    gives A.mul_vec(eq(c, .)), and its evaluation at r the full one at
    r||c: the identity the card's config-4 path checks at full width."""
    f = get_field("goldilocks")
    e = FieldElems(f, "cpu")
    rng = np.random.default_rng(8)
    n, m, nnz = 16, 8, 40
    A = SparseMatrix(e, n, m, e.encode(_ints(f.q, (nnz,), rng)),
                     rng.integers(0, n, nnz), rng.integers(0, m, nnz))
    mle = SparseMLE.from_matrix(e, A)
    r = [f.encode(v, "cpu") for v in _ints(f.q, (4,), rng)]
    c = [f.encode(v, "cpu") for v in _ints(f.q, (3,), rng)]
    eq = DenseMLE(e, 0, f.ones((1,), "cpu"))
    for p in c:             # eq table, variable j at bit j
        ev = eq.evals
        eq = DenseMLE(e, eq.num_vars + 1, torch.cat(
            [e.mul(ev, f.sub(f.ones((), "cpu"), p)), e.mul(ev, p)]))
    fixed = mle.fix_variables(c)
    assert fixed.num_vars == 4
    assert torch.equal(fixed.to_dense().evals, A.mul_vec(eq.evals))
    assert torch.equal(fixed.evaluate(r), mle.evaluate(c + r))
