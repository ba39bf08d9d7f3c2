"""The digit-product modular matrices and the deg-2^14 four-step NTT
(``ops/mxu.py``), the fused mod-mat kernel's twin (``ops/mxu_fused.py``)
and the chain kernel's twin (``ops/fold.py``) on the CPU, against the
reference: ``MxuModMat`` / ``MatmulNTT`` and their tables against the
JAX classes, Python ints and ``HostGoldilocks``; the fused twin against
``MxuModMatPallas`` in interpret mode, both kernel shapes, a ragged
column count and the inputs at the int32 bucket bound;
``pointwise_chain`` against its Pallas kernel in interpret mode.  Exact
equality throughout."""

import copy
import random

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.native import HostGoldilocks
from stark_rings_tpu.ops import mxu as ref_mxu
from stark_rings_tpu.ops.pallas_fold import pointwise_chain as ref_chain
from stark_rings_tpu.ops.pallas_mxu import MxuModMatPallas

from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops import mxu_fused as MF
from stark_rings_tpu_torch.ops.mxu import MatmulNTT, MxuModMat

F = get_field("goldilocks")
Q = F.q
LEVELS = ("col_mat", "row_mat", "col_mat_inv", "row_mat_inv")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def matmul_ntts():
    return MatmulNTT(device="cpu"), ref_mxu.MatmulNTT()


def _matrix(rng, R, C):
    m = [[rng.randrange(Q) for _ in range(C)] for _ in range(R)]
    m[0] = [(1 << 63) - 1] * C      # every digit 127 but the top one
    return m


def _data(rng, C, M):
    """u64 [C, M]: columns of all ones (2^64 - 1), q - 1, 0 and 1 first."""
    x = np.array([[rng.randrange(Q) for _ in range(M)] for _ in range(C)],
                 dtype=np.uint64)
    for j, v in enumerate([2**64 - 1, Q - 1, 0, 1][:M]):
        x[:, j] = v
    return x


def _py_matmul(m, x):
    cols = x.astype(object).T
    return np.array([[sum(v % Q * int(u) for v, u in zip(row, col)) % Q
                      for col in cols] for row in m], dtype=np.uint64)


def test_mod_mat_matches_reference_and_ints():
    rng = random.Random(80)
    R, C = 4, 128
    m = _matrix(rng, R, C)
    x = _data(rng, C, 5)
    mm = MxuModMat(m, device="cpu")
    ref = ref_mxu.MxuModMat(m)
    assert np.array_equal(mm.planes, ref.planes)
    got = to_numpy_u64(mm.apply(to_torch(x, "cpu")))
    assert np.array_equal(got, np.asarray(ref.apply(jax.device_put(x))))
    assert np.array_equal(got, _py_matmul(m, x))


def test_mod_mat_rejects_bucket_overflow():
    with pytest.raises(ValueError, match="2\\^31"):
        MxuModMat(np.zeros((1, 13315), dtype=object), device="cpu")
    with pytest.raises(ValueError, match="2\\^31"):
        MF.MxuModMatFused(np.zeros((1, 13315), dtype=object), device="cpu")


def test_matmul_ntt_tables_match_reference(matmul_ntts):
    mn, ref = matmul_ntts
    for key in ("twist", "twist_inv", "twiddle", "twiddle_inv"):
        assert np.array_equal(getattr(mn, key), getattr(ref, key)), key
    for key in LEVELS:
        assert np.array_equal(getattr(mn, key).planes,
                              getattr(ref, key).planes), key


def test_matmul_ntt_matches_reference_and_host(matmul_ntts):
    mn, ref = matmul_ntts
    nprng = np.random.default_rng(81)
    a = nprng.integers(0, Q, size=(2, mn.N), dtype=np.uint64)
    b = nprng.integers(0, Q, size=(2, mn.N), dtype=np.uint64)
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    fwd = mn.forward(ta)
    assert np.array_equal(to_numpy_u64(fwd),
                          np.asarray(ref.forward(jax.device_put(a))))
    assert torch.equal(mn.inverse(fwd), ta)
    got = to_numpy_u64(mn.mul(ta, tb))
    assert np.array_equal(got, np.asarray(ref.mul(jax.device_put(a),
                                                  jax.device_put(b))))
    assert np.array_equal(got, HostGoldilocks(mn.N).mul(a, b))


def test_matmul_ntt_on_fused_levels(matmul_ntts):
    """MatmulNTT with each level swapped for an MxuModMatFused of the same
    matrix (the kernel's twin on the CPU) equals MatmulNTT on
    MxuModMat."""
    mn, _ = matmul_ntts
    fused = copy.copy(mn)
    for key in LEVELS:
        level = getattr(mn, key)
        f = MF.MxuModMatFused(level.matrix(), device="cpu")
        assert np.array_equal(f.planes, level.planes), key
        setattr(fused, key, f)
    nprng = np.random.default_rng(82)
    a, b = (to_torch(nprng.integers(0, Q, (1, mn.N), dtype=np.uint64),
                     "cpu") for _ in range(2))
    assert torch.equal(fused.mul(a, b), mn.mul(a, b))


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "split"])
def test_fused_twin_matches_pallas_interpret(stacked):
    """Both kernel shapes of the reference, a column count that is no
    multiple of its tile, and the bound inputs."""
    rng = random.Random(90 + stacked)
    R, C, M = 4, 128, 130
    m = _matrix(rng, R, C)
    x = _data(rng, C, M)
    pk = MxuModMatPallas(m, tile=128, interpret=True, stacked=stacked)
    want = np.asarray(pk.apply(jax.device_put(x)))
    f = MF.MxuModMatFused(m, device="cpu")
    assert np.array_equal(f.planes, pk.planes)
    if stacked:
        assert np.array_equal(f.big, pk.big_planes)
    got = f.apply(to_torch(x, "cpu"))
    assert np.array_equal(to_numpy_u64(got), want)
    assert torch.equal(got, MxuModMat(m, device="cpu").apply(
        to_torch(x, "cpu")))


def test_fused_twin_at_bucket_bound():
    """Every weight and data digit at 127 (the largest buckets the int32
    bound allows at C = 128) and the edge values, against Python ints."""
    C = 128
    allx = sum(127 << (7 * k) for k in range(10)) % (1 << 64)
    m = [[(1 << 63) - 1] * C, [Q - 1] * C, [1] * C, [0] * C]
    x = np.array([[allx, Q - 1, 1, 0, 2**63]] * C, dtype=np.uint64)
    w = MF.MxuModMatFused(m, device="cpu").w
    got = to_numpy_u64(MF.mxu_mod_mat(to_torch(x, "cpu"), w))
    assert np.array_equal(got, _py_matmul(m, x))


def test_fused_wrapper_checks_inputs():
    f = MF.MxuModMatFused([[1, 2], [3, 4]], device="cpu")
    x = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(TypeError):
        MF.mxu_mod_mat(x.to(torch.int32), f.w)
    with pytest.raises(ValueError, match="rows"):
        MF.mxu_mod_mat(torch.zeros((3, 3), dtype=torch.int64), f.w)
    with pytest.raises(ValueError, match="contiguous"):
        MF.mxu_mod_mat(torch.zeros((3, 2), dtype=torch.int64).t(), f.w)
    assert MF.LAUNCHES == {"mxu_mod_mat": 0}


@pytest.mark.parametrize("depth", [0, 5, 16])
def test_pointwise_chain_matches_pallas_interpret(depth):
    rng = np.random.default_rng(9 + depth)
    a = rng.integers(0, Q, (2, 2048), dtype=np.uint64)
    b = rng.integers(0, Q, (2, 2048), dtype=np.uint64)
    a[0, :2], b[0, :2] = Q - 1, [Q - 1, 0]
    want = np.asarray(ref_chain(jax.device_put(a), jax.device_put(b),
                                depth=depth, interpret=True))
    got = K.pointwise_chain(to_torch(a, "cpu"), to_torch(b, "cpu"), depth)
    assert np.array_equal(to_numpy_u64(got), want)
    with pytest.raises(ValueError, match="depth"):
        K.pointwise_chain(to_torch(a, "cpu"), to_torch(b, "cpu"), -1)
