"""The port's BabyBear layer on the CPU against the JAX reference: the
field (``BABYBEAR``), the digit tables and the plain engine
(``BBPrescaledMat``, ``MxuBBNTT``), the K4 fold twins against the
reference's Pallas kernels in interpret mode, and the fused engine
``MxuBBFusedNTT`` (whose wrappers run their twins here).  Inputs are
numpy-seeded; values are compared as the reference's u32 Montgomery
storage, with 0 differing bits allowed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import BABYBEAR as RB
from stark_rings_tpu.ops.mxu_bb import MxuBBNTT as RefMxuBBNTT
from stark_rings_tpu.ops.pallas_fold_bb import (MxuBBPallasNTT,
                                                bb_fold_end2_mul_dma,
                                                bb_fold_end_dma,
                                                bb_fold_tw_dma)

from stark_rings_tpu_torch import (BABYBEAR as F, MxuBBFusedNTT, MxuBBNTT,
                                   from_jax_consts, get_field, to_numpy_u32,
                                   to_torch_u32)
from stark_rings_tpu_torch.ops import fold_bb as KB

Q = F.q
EDGE = [0, 1, 2, Q - 2, Q - 1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return to_torch_u32(np.asarray(x, dtype=np.uint32), "cpu")


def _np(x):
    return to_numpy_u32(x)


def _storage(rng, n):
    """Montgomery storage of 0, 1, 2, q-2, q-1 and n random elements."""
    edge = np.asarray(RB.encode(np.array(EDGE, dtype=object)))
    return np.concatenate([edge, rng.integers(0, Q, n, dtype=np.uint32)])


# -- the field ----------------------------------------------------------------


def test_encode_decode_and_constants_match_reference():
    rng = np.random.default_rng(0)
    ints = np.array(EDGE + [int(v) for v in rng.integers(0, Q, 40)]
                    + [Q, 2 * Q + 5, -1], dtype=object)
    enc = F.encode(ints, "cpu")
    assert enc.dtype == torch.int32
    assert np.array_equal(_np(enc), np.asarray(RB.encode(ints)))
    assert list(F.decode(enc)) == [int(v) % Q for v in ints]
    for v in (0, 1, Q - 1, -3, 12345):
        assert int(_np(F.const(v, "cpu"))) == int(RB.const(v))
    assert np.array_equal(_np(F.ones((3,), "cpu")),
                          np.asarray(RB.ones((3,))))
    assert np.array_equal(_np(F.zeros((2, 2), "cpu")),
                          np.zeros((2, 2), np.uint32))
    small = np.array([0, 1, 7, Q - 1, Q, 2**32 - 1], dtype=np.uint64)
    assert np.array_equal(_np(F.from_uint(small, "cpu")),
                          np.asarray(RB.from_uint(jnp.asarray(small))))
    x = F.rand((6, 5), rng, "cpu")
    assert x.shape == (6, 5) and x.dtype == torch.int32
    assert ((x >= 0) & (x < Q)).all()
    assert get_field("babybear") is F
    assert get_field("stark_prime").limbed
    with pytest.raises(KeyError, match="unknown field"):
        get_field("nope")


def test_elementwise_ops_match_reference():
    rng = np.random.default_rng(1)
    a = _storage(rng, 200)
    b = np.concatenate([a[::-1][:5], rng.integers(0, Q, 200,
                                                  dtype=np.uint32)])
    a2, b2 = np.repeat(a, len(EDGE)), np.tile(b, len(a))[:len(a) * 5]
    for x, y in ((a, b), (a2, b2)):
        ja, jb = jnp.asarray(x), jnp.asarray(y)
        for name in ("add", "sub", "mul"):
            got = _np(getattr(F, name)(_t(x), _t(y)))
            want = np.asarray(getattr(RB, name)(ja, jb))
            assert np.array_equal(got, want), name
        assert np.array_equal(_np(F.neg(_t(x))), np.asarray(RB.neg(ja)))
        assert np.array_equal(_np(F.canon(_t(x))), np.asarray(RB.canon(ja)))
        assert np.array_equal(_np(F.from_canon(_t(x))),
                              np.asarray(RB.from_canon(ja)))


def test_reductions_powers_and_inverse_match_reference():
    rng = np.random.default_rng(2)
    x = _storage(rng, 59).reshape(8, 8)
    for axis in (0, 1):
        assert np.array_equal(_np(F.sum(_t(x), axis)),
                              np.asarray(RB.sum(jnp.asarray(x), axis)))
    assert np.array_equal(_np(F.dot(_t(x), _t(x[::-1]), 1)),
                          np.asarray(RB.dot(jnp.asarray(x),
                                            jnp.asarray(x[::-1]), 1)))
    nz = x.reshape(-1)[1:]                      # drop the encoded 0
    for e in (0, 1, 2, 5, 2**31 + 3, Q - 1):
        assert np.array_equal(_np(F.pow_const(_t(nz), e)),
                              np.asarray(RB.pow_const(jnp.asarray(nz), e)))
    assert np.array_equal(_np(F.inv(_t(nz))), np.asarray(RB.inv(
        jnp.asarray(nz))))
    assert list(F.decode(F.mul(F.inv(_t(nz)), _t(nz)))) == [1] * nz.size


# -- digit tables, planes, GEMM and fold --------------------------------------


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
@pytest.mark.parametrize("N", [1 << 10, 1 << 11, 1 << 12])
def test_consts_byte_equal(N, unsigned):
    """N = 2^11 has an odd log: N1 = 32, N2 = 64."""
    port = MxuBBNTT(N, unsigned=unsigned, device="cpu")
    ref = RefMxuBBNTT(N, unsigned=unsigned)
    assert (port.N1, port.N2) == (ref.N1, ref.N2)
    want, got = ref.consts(), port.consts()
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype, key
        assert np.array_equal(got[key], w), key


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_planes_dot_fold_match_reference(unsigned):
    N = 1 << 11
    port = MxuBBNTT(N, unsigned=unsigned, device="cpu")
    ref = RefMxuBBNTT(N, unsigned=unsigned)
    rng = np.random.default_rng(3)
    for pm, rm, key in ((port.mat1, ref.mat1, "w1"),
                        (port.mat2i, ref.mat2i, "w2i")):
        x = _storage(rng, pm.C * 24 - 5).reshape(pm.C, 24)
        assert np.array_equal(pm.planes(_t(x)).numpy(),
                              np.asarray(rm.planes(jnp.asarray(x))))
        V = pm.dot(_t(x), port.c[key], port.c.get(key + "_corr"))
        want_V = np.asarray(rm.dot(jnp.asarray(x)))
        assert np.array_equal(V.numpy(), want_V)
        assert np.array_equal(_np(pm.fold(V)),
                              np.asarray(rm.fold(jnp.asarray(want_V))))


def test_reference_tables_carried_across():
    """The reference's numpy consts() through from_jax_consts give the
    port's own device tables, and a multiply with them the same result."""
    N = 1 << 10
    port = MxuBBNTT(N, device="cpu")
    c = from_jax_consts(RefMxuBBNTT(N).consts(), "cpu")
    assert set(c) == set(port.c)
    for key, v in port.c.items():
        assert c[key].dtype == v.dtype and torch.equal(c[key], v), key
    rng = np.random.default_rng(4)
    a = rng.integers(0, Q, (2, N), dtype=np.uint32)
    b = rng.integers(0, Q, (2, N), dtype=np.uint32)
    want = np.asarray(jax.jit(RefMxuBBNTT(N).mul)(jnp.asarray(a),
                                                  jnp.asarray(b)))
    assert np.array_equal(_np(port.mul(_t(a), _t(b), c)), want)
    assert np.array_equal(_np(port.mul(_t(a), _t(b))), want)


# -- the K4 twins against the Pallas kernels ----------------------------------


def _buckets(R, t, signed, seed):
    """Four batch blocks: zeros, the bucket bound, random within it, and
    random over the whole int32 range."""
    rng = np.random.default_rng(seed)
    K = 5 if signed else 4
    bound = (1 << 26) - 1 if signed else (1 << 27) - 1
    lo = -bound if signed else 0
    blocks = [np.zeros((K * R, t), np.int64),
              np.full((K * R, t), bound, np.int64),
              rng.integers(lo, bound + 1, (K * R, t)),
              rng.integers(-2**31, 2**31, (K * R, t))]
    if signed:
        blocks[2][:, ::3] = -bound
    return np.concatenate(blocks, axis=1).astype(np.int32)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t", [(32, 32), (64, 64)])
def test_k4_twins_match_pallas(R, t, signed):
    V = _buckets(R, t, signed, seed=R + t + signed)
    Vb = _buckets(R, t, signed, seed=R * t)[:, ::-1].copy()
    tw = np.random.default_rng(t).integers(0, Q, (R, t), dtype=np.uint32)
    jV, jVb = jnp.asarray(V), jnp.asarray(Vb)
    tV, tVb = torch.from_numpy(V), torch.from_numpy(Vb)
    kw = {"chunk": 64, "interpret": True, "signed": signed}

    def same(got, want):
        assert np.array_equal(_np(got), np.asarray(want))

    same(KB.bb_fold_end_ref(tV, R, signed=signed),
         bb_fold_end_dma(jV, R, **kw))
    for transpose_out in (True, False):
        same(KB.bb_fold_tw_ref(tV, _t(tw), R, transpose_out=transpose_out,
                               signed=signed),
             bb_fold_tw_dma(jV, jnp.asarray(tw), R,
                            transpose_out=transpose_out, **kw))
    same(KB.bb_fold_end2_mul_ref(tV, tVb, R, signed=signed),
         bb_fold_end2_mul_dma(jV, jVb, R, **kw))
    stacked = np.concatenate([V, Vb], axis=1)
    same(KB.bb_fold_end2_mul_ref(torch.from_numpy(stacked), None, R,
                                 signed=signed),
         bb_fold_end2_mul_dma(jnp.asarray(stacked), None, R, **kw))
    # batch-1 operand: the reference broadcasts it before its kernel
    # (MxuBBPallasNTT.mul_cached); the port's K4 reads column c mod t
    same(KB.bb_fold_end2_mul_ref(tV, tVb[:, :t], R, signed=signed),
         bb_fold_end2_mul_dma(jV, jnp.asarray(np.tile(Vb[:, :t], (1, 4))),
                              R, **kw))


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
def test_k4_wrappers_on_cpu_use_twins_and_launch_nothing(signed):
    R, t = 32, 64
    V = torch.from_numpy(_buckets(R, t, signed, seed=9))
    Vb = torch.from_numpy(_buckets(R, t, signed, seed=10))
    tw = _t(np.random.default_rng(11).integers(0, Q, (R, t),
                                               dtype=np.uint32))
    KB.reset_launches()
    pairs = [
        (KB.bb_fold_tw(V, tw, R, transpose_out=True, signed=signed),
         KB.bb_fold_tw_ref(V, tw, R, transpose_out=True, signed=signed)),
        (KB.bb_fold_end(V, R, signed=signed),
         KB.bb_fold_end_ref(V, R, signed=signed)),
        (KB.bb_fold_end2_mul(V, Vb[:, :t].contiguous(), R, signed=signed),
         KB.bb_fold_end2_mul_ref(V, Vb[:, :t], R, signed=signed)),
        (KB.bb_fold_end2_mul(torch.cat([V, Vb], 1), None, R, signed=signed),
         KB.bb_fold_end2_mul_ref(V, Vb, R, signed=signed)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert KB.LAUNCHES == {"bb_fold_tw": 0, "bb_fold_end2_mul": 0,
                           "bb_fold_end": 0}
    with pytest.raises(ValueError, match="no kernel for device"):
        KB.bb_fold_end(V.to("meta"), R, signed=signed)
    with pytest.raises(ValueError, match="bucket rows"):
        KB.bb_fold_end(V, R, signed=not signed)
    with pytest.raises(ValueError, match="contiguous int32"):
        KB.bb_fold_tw(V, tw.to(torch.int64), R, signed=signed)


# -- the fused engine ---------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    N = 1 << 10
    return {"ref": MxuBBPallasNTT(N, interpret=True),
            "ref_stacked": MxuBBPallasNTT(N, interpret=True,
                                          stack_forward=True),
            "port": MxuBBFusedNTT(N, device="cpu"),
            "port_stacked": MxuBBFusedNTT(N, stack_forward=True,
                                          device="cpu")}


@pytest.mark.parametrize("variant", ["mul", "stack_forward", "square",
                                     "mul_cached", "mul_cached_batch1"])
def test_fused_engine_matches_pallas_engine(engines, variant):
    """MxuBBFusedNTT against MxuBBPallasNTT(interpret=True) at N = 2^10,
    the reference's defaults (fused transpose and slot product)."""
    rng = np.random.default_rng(12)
    a = _storage(rng, 2 * 1024 - 5).reshape(2, 1024)
    b = rng.integers(0, Q, (2, 1024), dtype=np.uint32)
    ref, port = engines["ref"], engines["port"]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if variant == "mul":
        got, want = port.mul(_t(a), _t(b)), ref.mul(ja, jb)
    elif variant == "stack_forward":
        got = engines["port_stacked"].mul(_t(a), _t(b))
        want = engines["ref_stacked"].mul(ja, jb)
    elif variant == "square":
        got, want = port.square(_t(a)), ref.square(ja)
    elif variant == "mul_cached":
        state = port.precompute(_t(b))
        assert state.dtype == torch.int32          # level-2 buckets
        got = port.mul_cached(_t(a), state)
        want = ref.mul_cached(ja, ref.precompute(jb))
    else:
        state = port.precompute(_t(b[:1]))
        assert state.shape[1] == port.N1
        got = port.mul_cached(_t(a), state)
        want = ref.mul_cached(ja, ref.precompute(jb[:1]))
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_fused_engine_matches_plain_engine_odd_log(unsigned):
    """N = 2^11 (N1 = 32, N2 = 64), both digit schemes: the fused engine
    against the reference's jitted MxuBBNTT and the port's plain one."""
    N = 1 << 11
    rng = np.random.default_rng(13)
    a = rng.integers(0, Q, (3, N), dtype=np.uint32)
    b = rng.integers(0, Q, (3, N), dtype=np.uint32)
    want = np.asarray(jax.jit(RefMxuBBNTT(N, unsigned=unsigned).mul)(
        jnp.asarray(a), jnp.asarray(b)))
    port = MxuBBFusedNTT(N, unsigned=unsigned, device="cpu")
    plain = MxuBBNTT(N, unsigned=unsigned, device="cpu")
    assert np.array_equal(_np(port.mul(_t(a), _t(b))), want)
    assert np.array_equal(_np(plain.mul(_t(a), _t(b))), want)
    assert torch.equal(port.square(_t(a)), plain.square(_t(a)))
    assert torch.equal(port.mul_cached(_t(a), port.precompute(_t(b[:1]))),
                       plain.mul_cached(_t(a), plain.precompute(_t(b[:1]))))
