"""The port's sparse and symmetric linear algebra on the CPU against the
reference's ``stark_rings_tpu.linalg`` (mirroring tests/test_linalg.py
and tests/test_extras.py): the field's modular ``segment_sum`` over all
four fields (duplicate, empty and out-of-order segments), the COO
``SparseMatrix`` (constructors, dense round trips, structure, mul_vec
and its AlgebraError, mul_dense, the gadget decomposition, sparse x
sparse at a 1e5-nnz join), ``SymmetricMatrix`` and the G^T M G
recomposition.  Elements are numpy-seeded Python ints encoded by both
packages; storage is compared word for word (tolerance: bit-equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import (FieldElems as RefFieldElems,
                                    RingElems as RefRingElems,
                                    SparseMatrix as RefSparse,
                                    SymmetricMatrix as RefSym)
from stark_rings_tpu.linalg import (
    recompose_left_right_symmetric_matrix as ref_recompose)
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import get_field, to_numpy_storage
from stark_rings_tpu_torch.linalg import (AlgebraError, FieldElems,
                                          RingElems, SparseMatrix,
                                          SymmetricMatrix,
                                          recompose_left_right_symmetric_matrix)
from stark_rings_tpu_torch.rings import get_ring

NAMES = ["goldilocks", "babybear", "frog", "stark_prime"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ints(q, shape, rng):
    """Uniform ints in [0, q) as an object array (any q, up to 2^256)."""
    n = int(np.prod(shape, dtype=np.int64))
    vals = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    return np.array(vals, dtype=object).reshape(shape)


def _elems(name, ring_elems=False):
    """(port adapter on the CPU, reference adapter)."""
    if ring_elems:
        return RingElems(get_ring(name, device="cpu")), \
            RefRingElems(ref_ring(name))
    return FieldElems(get_field(name), "cpu"), RefFieldElems(ref_field(name))


def _same(got, want, what=""):
    assert np.array_equal(to_numpy_storage(got), np.asarray(want)), what


def _same_sparse(got, want):
    assert (got.nrows, got.ncols, got.nnz) == (want.nrows, want.ncols,
                                               want.nnz)
    _same(got.data, want.data, "data")
    assert np.array_equal(got.rows.numpy(), np.asarray(want.rows))
    assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))


def _pair(e, re, nrows, ncols, data_ints, rows, cols):
    """The same COO matrix in both packages."""
    return (SparseMatrix(e, nrows, ncols, e.encode(data_ints), rows, cols),
            RefSparse(re, nrows, ncols, re.encode(data_ints), rows, cols))


# -- the field's segment sum ---------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_segment_sum_matches_reference(name):
    """Duplicate ids, segments with no entry (0, 3, 6) and ids out of
    order; [n] and [n, 3] values; equal to the reference and to Python
    ints."""
    f, rf = get_field(name), ref_field(name)
    rng = np.random.default_rng(NAMES.index(name))
    ids = np.array([5, 1, 5, 2, 7, 1, 4, 5, 2])
    for shape in ((9,), (9, 3)):
        ints = _ints(f.q, shape, rng)
        ints[0] = f.q - 1                # near-q words must carry
        got = f.segment_sum(f.encode(ints, "cpu"), ids, 8)
        _same(got, rf.segment_sum(rf.encode(ints), jnp.asarray(ids), 8),
              shape)
        dec = f.decode(got)
        for s in range(8):
            want = ints[ids == s].sum(axis=0, initial=0) % f.q
            assert np.array_equal(np.asarray(dec[s], dtype=object),
                                  want * np.ones(shape[1:], dtype=object)), s
    # a tensor of ids works as the array does
    x = f.encode(_ints(f.q, (9,), rng), "cpu")
    assert torch.equal(f.segment_sum(x, torch.as_tensor(ids), 8),
                       f.segment_sum(x, ids, 8))


# -- SparseMatrix ----------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_sparse_matvec_and_dense_roundtrip(name):
    e, re = _elems(name)
    q = e.f.q
    rng = np.random.default_rng(22)
    n, m = 6, 5
    mask = rng.random((n, m)) < 0.4
    vals = _ints(q, (n, m), rng)
    entries = [(r, c, vals[r, c]) for r in range(n) for c in range(m)
               if mask[r, c]]
    S, RS = SparseMatrix.from_entries(e, n, m, entries), \
        RefSparse.from_entries(re, n, m, entries)
    _same_sparse(S, RS)
    _same(S.to_dense().vals, RS.to_dense().vals, "to_dense")
    dense = np.where(mask, vals, 0)
    assert np.array_equal(S.decode_dense(), dense)
    v = _ints(q, (m,), rng)
    got = S.mul_vec(e.encode(v))
    _same(got, RS.mul_vec(re.encode(v)), "mul_vec")
    assert list(e.decode(got)) == [sum(dense[i] * v) % q for i in range(n)]
    with pytest.raises(AlgebraError, match="DifferentLengths"):
        S.mul_vec(e.encode(v[:4]))
    S2, RS2 = SparseMatrix.from_dense(e, S.to_dense()), \
        RefSparse.from_dense(re, RS.to_dense())
    _same_sparse(S2, RS2)
    assert np.array_equal(S2.decode_dense(), dense)


@pytest.mark.parametrize("ring_elems", [False, True], ids=["field", "ring"])
def test_sparse_structure_matches_reference(ring_elems):
    """identity, hconcat, vconcat, pad, transpose, scalar_mul and
    mul_dense over goldilocks scalars and ring elements."""
    e, re = _elems("goldilocks", ring_elems)
    q = e.f.q
    rng = np.random.default_rng(3)
    es = tuple(e.elem_shape)
    _same_sparse(SparseMatrix.identity(e, 4), RefSparse.identity(re, 4))
    A, RA = _pair(e, re, 3, 4, _ints(q, (5,) + es, rng),
                  [0, 2, 1, 2, 0], [3, 0, 1, 3, 3])
    B, RB = _pair(e, re, 3, 2, _ints(q, (2,) + es, rng), [1, 2], [0, 1])
    C, RC = _pair(e, re, 2, 4, _ints(q, (3,) + es, rng), [0, 1, 1],
                  [2, 0, 3])
    _same_sparse(A.hconcat(B), RA.hconcat(RB))
    _same_sparse(A.vconcat(C), RA.vconcat(RC))
    _same_sparse(A.pad(5, 7), RA.pad(5, 7))
    _same_sparse(A.transpose(), RA.transpose())
    s = _ints(q, es, rng)
    _same_sparse(A.scalar_mul(e.encode(s)), RA.scalar_mul(re.encode(s)))
    D = _ints(q, (4, 3) + es, rng)
    _same(A.mul_dense(e.encode(D)), RA.mul_dense(re.encode(D)), "mul_dense")
    _same(A.hconcat(B).to_dense().vals, RA.hconcat(RB).to_dense().vals)
    with pytest.raises(ValueError):
        A.hconcat(C)
    with pytest.raises(ValueError, match="outside"):
        SparseMatrix(e, 2, 2, e.encode(_ints(q, (1,) + es, rng)), [2], [0])


def test_sparse_rand_from_generator():
    """rand draws its pattern and values from a numpy Generator: the
    same seed gives the same matrix; its entries lie in the shape."""
    e, _ = _elems("babybear")
    A = SparseMatrix.rand(e, 7, 5, 0.4, np.random.default_rng(4))
    B = SparseMatrix.rand(e, 7, 5, 0.4, np.random.default_rng(4))
    assert torch.equal(A.data, B.data) and torch.equal(A.rows, B.rows)
    assert int(A.rows.max()) < 7 and int(A.cols.max()) < 5
    Z = SparseMatrix.rand(e, 3, 3, 0.0, np.random.default_rng(4))
    assert Z.nnz == 1 and not Z.data.any()


def test_sparse_sparse_mul_matches_reference():
    """mul_sparse: the same entries (data, rows, cols) as the reference's
    join, the Python-int product, and the empty product."""
    e, re = _elems("goldilocks")
    q = e.f.q
    rng = np.random.default_rng(23)
    nnz_a, nnz_b = 12, 9
    A, RA = _pair(e, re, 4, 6, _ints(q, (nnz_a,), rng),
                  rng.integers(0, 4, nnz_a), rng.integers(0, 6, nnz_a))
    B, RB = _pair(e, re, 6, 3, _ints(q, (nnz_b,), rng),
                  rng.integers(0, 6, nnz_b), rng.integers(0, 3, nnz_b))
    C = A.mul_sparse(B)
    _same_sparse(C, RA.mul_sparse(RB))
    DA, DB = A.decode_dense(), B.decode_dense()
    want = [[sum(DA[i][t] * DB[t][j] for t in range(6)) % q
             for j in range(3)] for i in range(4)]
    assert C.decode_dense().tolist() == want
    with pytest.raises(AlgebraError):
        A.mul_sparse(A)
    E, RE = _pair(e, re, 3, 4, _ints(q, (1,), rng), [0], [0])
    F_, RF_ = _pair(e, re, 4, 2, _ints(q, (1,), rng), [3], [1])
    _same_sparse(E.mul_sparse(F_), RE.mul_sparse(RF_))


def test_sparse_sparse_mul_stays_sparse():
    """Two banded 64 x 64 matrices give 64 entries, not the 4,096 of a
    dense accumulator; the NTT-form ring variant (frog, slot-wise)."""
    e, re = _elems("goldilocks")
    n = 64
    A = SparseMatrix.from_entries(e, n, n, [(i, i, i + 1) for i in range(n)])
    B = SparseMatrix.from_entries(
        e, n, n, [(i, (i + 1) % n, i + 2) for i in range(n)])
    C = A.mul_sparse(B)
    assert C.nnz <= n
    got = C.decode_dense()
    for i in range(n):
        for j in range(n):
            want = (i + 1) * (i + 2) if j == (i + 1) % n else 0
            assert int(got[i][j]) == want
    er, rer = _elems("frog", ring_elems=True)
    D = er.ring.D
    ents_a = [(0, 1, [2] * D), (2, 2, [3] * D)]
    ents_b = [(1, 0, [5] * D), (2, 2, [7] * D)]
    C2 = SparseMatrix.from_entries(er, 3, 3, ents_a).mul_sparse(
        SparseMatrix.from_entries(er, 3, 3, ents_b))
    assert C2.nnz <= 2
    _same_sparse(C2, RefSparse.from_entries(rer, 3, 3, ents_a).mul_sparse(
        RefSparse.from_entries(rer, 3, 3, ents_b)))


def test_mul_sparse_1e5_nnz_host_join():
    """A 2,000 x 2,000 matrix of 10^5 entries times its transpose (about
    5 million matched pairs): the vectorized host join and one
    segment_sum, equal entry for entry to the reference's."""
    f, rf = get_field("goldilocks"), ref_field("goldilocks")
    n, nnz = 2000, 100_000
    rs = np.random.default_rng(33)
    rows = rs.integers(0, n, nnz).astype(np.int32)
    cols = rs.integers(0, n, nnz).astype(np.int32)
    words = rs.integers(0, f.q, nnz, dtype=np.uint64)
    A = SparseMatrix(FieldElems(f, "cpu"), n, n,
                     torch.from_numpy(words.view(np.int64)), rows, cols)
    RA = RefSparse(RefFieldElems(rf), n, n, jnp.asarray(words), rows, cols)
    _same_sparse(A.mul_sparse(A.transpose()), RA.mul_sparse(RA.transpose()))


@pytest.mark.parametrize("name,ring_elems,b,k", [
    ("goldilocks", True, 256, 9), ("babybear", False, 16, 8),
    ("stark_prime", False, 1 << 16, 16)])
def test_sparse_gadget_matches_reference(name, ring_elems, b, k):
    """gadget_decompose (n x m -> n x km) and gadget_recompose back,
    entry for entry as the reference's (test_extras.py:183-225)."""
    e, re = _elems(name, ring_elems)
    rng = np.random.default_rng(64)
    es = tuple(e.elem_shape[:1]) if ring_elems else ()
    ents = [(0, 1, _ints(e.f.q, es, rng)), (2, 3, _ints(e.f.q, es, rng)),
            (1, 0, _ints(e.f.q, es, rng))]
    S, RS = SparseMatrix.from_entries(e, 3, 4, ents), \
        RefSparse.from_entries(re, 3, 4, ents)
    G, RG = S.gadget_decompose(b, k), RS.gadget_decompose(b, k)
    assert (G.ncols, G.nnz) == (4 * k, 3 * k)
    _same_sparse(G, RG)
    back = G.gadget_recompose(b, k)
    _same_sparse(back, RG.gadget_recompose(b, k))
    assert torch.equal(back.to_dense().vals, S.to_dense().vals)


# -- SymmetricMatrix ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["goldilocks", "stark_prime"])
def test_symmetric_matches_reference(name):
    e, re = _elems(name)
    q = e.f.q
    rng = np.random.default_rng(24)
    n = 5
    rows = [list(_ints(q, (i + 1,), rng)) for i in range(n)]
    S, RS = SymmetricMatrix.from_rows(e, rows), RefSym.from_rows(re, rows)
    _same(S.vals, RS.vals, "from_rows")
    assert S.size() == n
    dense = S.to_dense()
    _same(dense, RS.to_dense(), "to_dense")
    _same(S.diag(), RS.diag(), "diag")
    for i, j in ((0, 0), (3, 1), (1, 3), (4, 4)):
        _same(S.at(i, j), RS.at(i, j), (i, j))
    v = _ints(q, (), rng)
    _same(S.set_at(1, 3, e.encode(v)).vals,
          RS.set_at(1, 3, re.encode(v)).vals, "set_at")
    _same(S.vals, RS.vals, "set_at leaves its input")
    _same(S.map_mul(e.encode(v)).vals, RS.map_mul(re.encode(v)).vals)
    assert np.array_equal(S.decode(), np.asarray(RS.decode()))
    _same(SymmetricMatrix.from_dense_vals(e, dense).vals, RS.vals)
    _same(SymmetricMatrix.zero(e, 3).vals, RefSym.zero(re, 3).vals)
    with pytest.raises(ValueError, match="row 1"):
        SymmetricMatrix.from_rows(e, [[1], [2]])
    assert SymmetricMatrix.rand(e, 4, rng).vals.shape[0] == 10


def test_symmetric_from_fn():
    """from_fn (the reference's from_par_fn): per entry and vectorized."""
    e, re = _elems("goldilocks")
    n = 5
    m = SymmetricMatrix.from_fn(e, n, lambda i, j: 10 * i + j)
    mv = SymmetricMatrix.from_fn(
        e, n, lambda ii, jj: torch.as_tensor(10 * ii + jj), vectorized=True)
    _same(m.vals, RefSym.from_fn(re, n, lambda i, j: 10 * i + j).vals)
    assert torch.equal(m.vals, mv.vals)
    for i in range(n):
        for j in range(n):
            assert int(e.f.decode(m.at(i, j))) == 10 * max(i, j) + min(i, j)


@pytest.mark.parametrize("name", ["goldilocks", "frog"])
def test_recompose_left_right_symmetric_matrix(name):
    """G^T M G against the reference and the Python-int sum."""
    e, re = _elems(name)
    q = e.f.q
    rng = np.random.default_rng(25)
    n, d, b = 2, 3, 256
    rows = [list(_ints(q, (i + 1,), rng)) for i in range(n * d)]
    pb = np.array([pow(b, i, q) for i in range(d)], dtype=object)
    G = recompose_left_right_symmetric_matrix(
        SymmetricMatrix.from_rows(e, rows), e.encode(pb))
    _same(G.vals, ref_recompose(RefSym.from_rows(re, rows),
                                re.encode(pb)).vals)
    M = SymmetricMatrix.from_rows(e, rows).to_dense()
    dense = np.asarray(e.decode(M))
    got = e.decode(G.to_dense())
    for i in range(n):
        for j in range(n):
            want = sum(int(dense[k][l]) * pb[k % d] * pb[l % d]
                       for k in range(i * d, i * d + d)
                       for l in range(j * d, j * d + d)) % q
            assert int(got[i][j]) == want
