"""The port's ``utils`` on the CPU against the reference's
``stark_rings_tpu.utils``: the arkworks byte layouts of matrices,
symmetric and sparse matrices, dense and sparse MLEs and vectors (the
golden bytes of tests/test_serialize_structs.py, all seven cases; the
same bytes as the reference for the same objects; the compressed and
uncompressed modes and the validate gate), the element round trips of
tests/test_extras.py:156, checkpoints whose files cross between the two
packages, and ``trace_span``.  Tolerance: byte-equal and bit-equal."""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu import utils as RU
from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import (FieldElems as RefFieldElems,
                                    Matrix as RefMatrix,
                                    RingElems as RefRingElems,
                                    SparseMatrix as RefSparse,
                                    SymmetricMatrix as RefSym)
from stark_rings_tpu.mle import DenseMLE as RefDense
from stark_rings_tpu.mle import SparseMLE as RefSparseMLE
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import get_field, to_numpy_storage
from stark_rings_tpu_torch import utils as U
from stark_rings_tpu_torch.linalg import (FieldElems, Matrix, RingElems,
                                          SparseMatrix, SymmetricMatrix)
from stark_rings_tpu_torch.mle import DenseMLE, SparseMLE
from stark_rings_tpu_torch.rings import get_ring
from stark_rings_tpu_torch.utils.serialize import (
    symmetric_matrix_from_bytes, symmetric_matrix_to_bytes)

NAMES = ["goldilocks", "babybear", "frog", "stark_prime"]


def u64(v):
    return struct.pack("<Q", v)


def bb4(v):
    return int(v).to_bytes(4, "little")   # babybear Fq compressed = 4 bytes


def _ints(q, shape, rng):
    n = int(np.prod(shape, dtype=np.int64))
    vals = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    return np.array(vals, dtype=object).reshape(shape)


def _bb():
    return FieldElems(get_field("babybear"), "cpu")


# -- the golden bytes (tests/test_serialize_structs.py) ----------------------


def test_matrix_golden_bytes():
    """Vec<Vec<R>>: u64 nrows, then per row u64 ncols + elements."""
    e = _bb()
    M = Matrix.from_ints(e, [[1, 2], [3, 4]])
    got = U.matrix_to_bytes(M)
    assert got == (u64(2) + u64(2) + bb4(1) + bb4(2)
                   + u64(2) + bb4(3) + bb4(4))
    assert torch.equal(U.matrix_from_bytes(e, got).vals, M.vals)


def test_sparse_matrix_golden_bytes():
    """u64 nrows, u64 ncols, Vec<Vec<(R, u64 col)>>."""
    e = _bb()
    S = SparseMatrix.from_entries(e, 2, 3, [(0, 1, 5), (1, 2, 7)])
    got = U.sparse_matrix_to_bytes(S)
    assert got == (u64(2) + u64(3) + u64(2)
                   + u64(1) + bb4(5) + u64(1)
                   + u64(1) + bb4(7) + u64(2))
    back = U.sparse_matrix_from_bytes(e, got)
    assert torch.equal(back.to_dense().vals, S.to_dense().vals)


def test_dense_mle_golden_bytes():
    """Vec<R> (trailing zeros cut), u64 num_vars, u64 elen, R zero."""
    e = _bb()
    m = DenseMLE.from_ints(e, 2, [9, 0, 7, 0])
    got = U.dense_mle_to_bytes(m)
    assert got == (u64(3) + bb4(9) + bb4(0) + bb4(7) + u64(2) + u64(4)
                   + bb4(0))
    back = U.dense_mle_from_bytes(e, got)
    assert back.num_vars == 2
    assert [int(v) for v in back.decode()] == [9, 0, 7, 0]


def test_sparse_mle_golden_bytes():
    """BTreeMap<u64, R> ascending, u64 num_vars, R zero."""
    e = _bb()
    f = e.f
    m = SparseMLE.from_pairs(e, 2, [(3, 8), (1, 5)])
    got = U.sparse_mle_to_bytes(m)
    assert got == (u64(2) + u64(1) + bb4(5) + u64(3) + bb4(8)
                   + u64(2) + bb4(0))
    back = U.sparse_mle_from_bytes(e, got)
    pt = [f.encode(v, "cpu") for v in (1, 0)]
    assert torch.equal(back.evaluate(pt), m.evaluate(pt))


def test_ring_and_limbed_roundtrips():
    """Ring-element matrices (D values an element) and the 252-bit stark
    field (32-byte elements) round trip."""
    ring = get_ring("goldilocks", device="cpu")
    er = RingElems(ring)
    rng = np.random.default_rng(9)
    M = Matrix.rand(er, 2, 3, rng)
    assert torch.equal(U.matrix_from_bytes(er, U.matrix_to_bytes(M)).vals,
                       M.vals)
    es = FieldElems(get_field("stark_prime"), "cpu")
    assert U.elem_nbytes(es.f) == 32
    MS = Matrix.rand(es, 2, 2, rng)
    assert torch.equal(U.matrix_from_bytes(es, U.matrix_to_bytes(MS)).vals,
                       MS.vals)
    S = SparseMatrix.from_entries(er, 2, 2, [(0, 0, [3] * ring.D),
                                             (1, 1, [4] * ring.D)])
    back = U.sparse_matrix_from_bytes(er, U.sparse_matrix_to_bytes(S))
    assert torch.equal(back.to_dense().vals, S.to_dense().vals)
    dm = DenseMLE.rand(er, 3, rng)
    assert torch.equal(
        U.dense_mle_from_bytes(er, U.dense_mle_to_bytes(dm)).evals, dm.evals)


def test_symmetric_matrix_golden_bytes():
    """u64 n, then row i = u64 (i+1) + its i+1 elements."""
    e = _bb()
    S = SymmetricMatrix.from_rows(e, [[5], [6, 7], [8, 9, 10]])
    got = symmetric_matrix_to_bytes(S)
    assert got == (u64(3) + u64(1) + bb4(5) + u64(2) + bb4(6) + bb4(7)
                   + u64(3) + bb4(8) + bb4(9) + bb4(10))
    back = symmetric_matrix_from_bytes(e, got)
    assert back.n == 3 and torch.equal(back.vals, S.vals)


def test_modes_compressed_equals_uncompressed_and_validate_gate():
    """Both modes write the same bytes; every deserializer reads them
    back; Validate::No skips the structural checks only, and element
    canonicity is always enforced."""
    er = RingElems(get_ring("goldilocks", device="cpu"))
    e = FieldElems(get_field("goldilocks"), "cpu")
    rng = np.random.default_rng(41)
    objs = [Matrix.rand(er, 2, 3, rng),
            SymmetricMatrix.from_rows(e, [[5], [6, 7], [8, 9, 10]]),
            SparseMatrix.from_entries(e, 3, 3, [(0, 1, 7), (2, 0, 9)]),
            DenseMLE.rand(er, 3, rng),
            SparseMLE.from_pairs(e, 4, [(3, 11), (9, 12)])]
    for obj in objs:
        comp = U.serialize_compressed(obj)
        assert comp == U.serialize_uncompressed(obj), type(obj).__name__
        for de in (U.deserialize_compressed,
                   U.deserialize_compressed_unchecked,
                   U.deserialize_uncompressed,
                   U.deserialize_uncompressed_unchecked):
            back = de(type(obj), obj.e, comp)
            assert U.serialize_compressed(back) == comp, de.__name__
    sp = SparseMatrix.from_entries(e, 3, 3, [(0, 1, 7), (2, 0, 9)])
    raw = bytearray(U.serialize_compressed(sp))
    raw[16:24] = struct.pack("<Q", 99)      # outer count != nrows
    with pytest.raises(ValueError, match="invalid structure"):
        U.deserialize_compressed(SparseMatrix, e, bytes(raw))
    back = U.deserialize_compressed_unchecked(SparseMatrix, e, bytes(raw))
    assert back.nrows == 3 and back.ncols == 3
    bad = bytearray(U.serialize_compressed(Matrix.from_ints(e, [[1]])))
    bad[16:24] = struct.pack("<Q", e.f.q)   # the first element := q
    with pytest.raises(ValueError, match="non-canonical"):
        U.deserialize_compressed_unchecked(Matrix, e, bytes(bad))
    with pytest.raises(TypeError, match="no codec"):
        U.serialize_compressed(object())


# -- the same bytes as the reference --------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_bytes_match_reference(name):
    """Every structure codec writes the reference's bytes for the same
    values (scalars of each field; ring elements for goldilocks), and
    reads the reference's bytes back to the same storage."""
    f, rf = get_field(name), ref_field(name)
    e, re = FieldElems(f, "cpu"), RefFieldElems(rf)
    rng = np.random.default_rng(NAMES.index(name))
    q = f.q
    m = _ints(q, (3, 4), rng)
    cases = [(Matrix(e, e.encode(m)), RefMatrix(re, re.encode(m)))]
    rows = [list(_ints(q, (i + 1,), rng)) for i in range(3)]
    cases.append((SymmetricMatrix.from_rows(e, rows),
                  RefSym.from_rows(re, rows)))
    ents = [(2, 1, int(_ints(q, (), rng))), (0, 3, int(_ints(q, (), rng))),
            (0, 1, 0), (2, 0, int(_ints(q, (), rng)))]
    cases.append((SparseMatrix.from_entries(e, 3, 4, ents),
                  RefSparse.from_entries(re, 3, 4, ents)))
    ev = _ints(q, (8,), rng)
    ev[6:] = 0
    cases.append((DenseMLE(e, 3, e.encode(ev)),
                  RefDense(re, 3, re.encode(ev))))
    pairs = [(5, int(_ints(q, (), rng))), (1, int(_ints(q, (), rng))),
             (5, int(_ints(q, (), rng)))]
    cases.append((SparseMLE.from_pairs(e, 3, pairs),
                  RefSparseMLE.from_pairs(re, 3, pairs)))
    if name == "goldilocks":
        ring, rring = get_ring(name, device="cpu"), ref_ring(name)
        er, rer = RingElems(ring), RefRingElems(rring)
        rm = _ints(q, (2, 2, ring.D), rng)
        cases.append((Matrix(er, er.encode(rm)),
                      RefMatrix(rer, rer.encode(rm))))
    for obj, ref in cases:
        data = U.serialize_compressed(obj)
        assert data == RU.serialize_compressed(ref), type(obj).__name__
        back = U.deserialize_compressed(type(obj), obj.e, data)
        assert U.serialize_compressed(back) == data


@pytest.mark.parametrize("name", NAMES)
def test_serialize_roundtrip(name):
    """vec_to_bytes / vec_from_bytes and elements_to_bytes /
    elements_from_bytes round trip and write the reference's bytes."""
    f, rf = get_field(name), ref_field(name)
    vals = _ints(f.q, (7,), np.random.default_rng(62))
    x = f.encode(vals, "cpu")
    data = U.vec_to_bytes(f, x, 7)
    assert data == RU.vec_to_bytes(rf, rf.encode(vals), 7)
    n, back = U.vec_from_bytes(f, data, device="cpu")
    assert n == 7 and list(f.decode(back)) == list(vals)
    raw = U.elements_to_bytes(f, x)
    assert raw == RU.elements_to_bytes(rf, rf.encode(vals))
    back2 = U.elements_from_bytes(f, raw, (7,), device="cpu")
    assert list(f.decode(back2)) == list(vals)
    one = U.elements_from_bytes(f, raw, (), device="cpu")
    assert int(f.decode(one)) == vals[0]
    with pytest.raises(ValueError, match="short buffer"):
        U.elements_from_bytes(f, raw[:5], (7,), device="cpu")


# -- checkpoints, trace ------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_crosses_packages(name, tmp_path):
    """A file saved by either package loads in the other to the same
    values (the same canonical layout, __field__ beside it)."""
    f, rf = get_field(name), ref_field(name)
    vals = _ints(f.q, (4, 3), np.random.default_rng(71))
    x = f.encode(vals, "cpu")
    p = U.save_tensors(tmp_path / "port.npz", name, x=x, y=x[:1])
    back_name, ts = U.load_tensors(p, device="cpu")
    assert back_name == name and set(ts) == {"x", "y"}
    assert torch.equal(ts["x"], x) and torch.equal(ts["y"], x[:1])
    rname, rts = RU.load_tensors(p)
    assert rname == name
    assert np.array_equal(np.asarray(rts["x"]), np.asarray(rf.encode(vals)))
    pr = RU.save_tensors(tmp_path / "ref.npz", name, x=rf.encode(vals))
    pname, pts = U.load_tensors(pr, device="cpu")
    assert pname == name and torch.equal(pts["x"], x)
    assert np.array_equal(to_numpy_storage(pts["x"]),
                          np.asarray(jnp.asarray(rf.encode(vals))))


def test_load_tensors_defaults_to_the_card(tmp_path):
    """load_tensors places the tensors on the card unless asked; without
    one it raises (no CPU fallback)."""
    p = U.save_tensors(tmp_path / "c.npz", "goldilocks",
                       x=get_field("goldilocks").encode([1, 2], "cpu"))
    if torch.cuda.is_available():
        assert U.load_tensors(p)[1]["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            U.load_tensors(p)


def test_trace_span():
    """The span names a region of the profiler's timeline, the parent of
    the ops inside it; with no profiler it is the shared no-op."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with U.trace_span("srt-span"):
            torch.ones(4).sum()
    assert any(ev.key == "srt-span" for ev in prof.key_averages())
    assert {e.cpu_parent.name for e in prof.events()
            if e.name == "aten::sum"} == {"srt-span"}
    quiet = U.trace_span("quiet")
    assert quiet is U.trace_span("other")
    with quiet:
        pass
