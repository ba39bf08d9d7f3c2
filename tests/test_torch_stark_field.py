"""The port's 252-bit stark prime (``STARK``: eight u32 Montgomery limbs
in ``int32 [..., 8]``) and its limb kernels' plain twins on the CPU
against the JAX reference's ``STARK``, ``LimbPrescaledMat``,
``MxuLimbNTT`` and ``NTTContext``: host conversions, elementwise ops
(canonical values, edge values, and arbitrary u32 limbs), reductions and
powers, the S1-S3 twins, the digit-plane matrix in both schemes (weights
byte-equal) and the four-step multiply at N = 16 and 512 (an odd log2
split).  Inputs are made from numpy seeds; the tolerance is exact
equality of the storage words.  Each reference function is jitted once
per module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.fields import STARK as RF
from stark_rings_tpu.ops.mxu_limb import LimbPrescaledMat as RefLimbMat
from stark_rings_tpu.ops.mxu_limb import MxuLimbNTT as RefLimbNTT
from stark_rings_tpu.ops.ntt import NTTContext as RefNTT
from stark_rings_tpu.ops.ntt import find_primitive_root as ref_root

from stark_rings_tpu_torch import (NTTContext, from_jax_consts,
                                   from_jax_storage, get_field,
                                   to_numpy_storage)
from stark_rings_tpu_torch.fields import FIELDS, STARK as F
from stark_rings_tpu_torch.ops import stark as S
from stark_rings_tpu_torch.ops.mxu2 import digit_table
from stark_rings_tpu_torch.ops.mxu_limb import LimbPrescaledMat, MxuLimbNTT
from stark_rings_tpu_torch.ops.ntt import find_primitive_root

Q = F.q
#: canonical edge values, and limb patterns beyond q (storage words that
#: no canonical value has: the kernels must give the reference's bits on
#: them too)
EDGE = [0, 1, 2, Q - 2, Q - 1, (Q - 1) // 2, (Q + 1) // 2, (1 << 256) % Q,
        (1 << 224) - 1, 1 << 192]
BEYOND = [Q, Q + 1, (1 << 255) + 3, (1 << 256) - 1]

_JIT = {}


def _ref(name, fn):
    """The reference function ``fn`` under jax.jit, compiled once."""
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


def _t(x):
    return from_jax_storage(F, np.asarray(x, dtype=np.uint32), "cpu")


def _np(x):
    return to_numpy_storage(x)


def _limbs(vals):
    """Python ints (any shape) -> uint32 [n, 8] limbs, flattened."""
    return F.limbs_np(np.asarray(vals, dtype=object).reshape(-1))


def _pairs(rng, n=24):
    """(a, b) storage arrays: every pair of edge values, then random."""
    e = _limbs(EDGE)
    ne = len(EDGE)
    a = np.concatenate([np.repeat(e, ne, 0), _limbs(F.rand_ints((n,), rng))])
    b = np.concatenate([np.tile(e, (ne, 1)), _limbs(F.rand_ints((n,), rng))])
    return a, b


def _raw(rng, n):
    """Arbitrary u32 limbs (most of them are not canonical)."""
    raw = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_limbs(BEYOND), raw])


def test_field_constants_and_registry():
    assert (F.name, F.q, F.bits, F.dtype) == ("stark_prime", RF.q, RF.bits,
                                              torch.int32)
    assert get_field("stark_prime") is F and FIELDS["stark_prime"] is F
    assert F.limbed and F.limb_shape == (8,) and F.coeff_axis == -2
    assert F.n_words == RF.n_words == 8
    assert (S.Q, S.QPRIME32) == (RF.q, int(RF._qprime32))
    assert S.Q_LIMBS == [int(v) for v in RF._q_limbs]


def test_encode_decode_and_constants_match_reference():
    rng = np.random.default_rng(0)
    ints = np.array(EDGE + BEYOND + [int(v) for v in F.rand_ints((20,), rng)]
                    + [-1, -Q, 2 * Q + 5, 1 << 300], dtype=object)
    enc = F.encode(ints, "cpu")
    assert enc.dtype == torch.int32 and enc.shape == (len(ints), 8)
    assert np.array_equal(_np(enc), np.asarray(RF.encode(ints)))
    assert np.array_equal(F.storage_np(ints.reshape(2, -1)),
                          np.asarray(RF.encode(ints.reshape(2, -1))))
    assert list(F.decode(enc)) == [int(v) % Q for v in ints]
    for v in (0, 1, Q - 1, -3, 12345):
        assert np.array_equal(_np(F.const(v, "cpu")), np.asarray(RF.const(v)))
        assert np.array_equal(_np(F.canon_const(v)), RF.canon_const(v))
    assert np.array_equal(_np(F.ones((3,), "cpu")), np.asarray(RF.ones((3,))))
    assert np.array_equal(_np(F.zeros((2, 3), "cpu")),
                          np.asarray(RF.zeros((2, 3))))
    x = F.rand((50, 3), rng, "cpu")
    assert x.shape == (50, 3, 8) and x.dtype == torch.int32
    assert all(0 <= int(v) < Q for v in F.decode(x).reshape(-1))
    draw = F.rand_ints((4, 5), np.random.default_rng(1))
    assert draw.shape == (4, 5) and all(0 <= int(v) < Q
                                        for v in draw.reshape(-1))
    assert isinstance(F.rand_ints((), rng), int)
    data = (Q - 1).to_bytes(32, "little")
    assert F.from_random_bytes(data) == RF.from_random_bytes(data) == Q - 1
    assert F.from_random_bytes(Q.to_bytes(32, "little")) is None


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_ops_match_reference(op):
    """Canonical edge pairs and random values, then arbitrary u32 limbs:
    the twins (and so the wrappers on CPU tensors) are the reference's
    bits on every input."""
    rng = np.random.default_rng(2)
    a, b = _pairs(rng)
    r1, r2 = _raw(rng, 16), _raw(rng, 16)[::-1].copy()
    fn = _ref(op, getattr(RF, op))
    for x, y in ((a, b), (r1, r2)):
        want = np.asarray(fn(x, y))
        assert np.array_equal(_np(getattr(F, op)(_t(x), _t(y))), want)
        assert np.array_equal(_np(getattr(S, f"stark_{op}_ref")(
            _t(x), _t(y))), want)
    # broadcasting: a table against a batch, one element against all
    fn_b = _ref(op + "_b", getattr(RF, op))
    want = np.asarray(fn_b(a.reshape(2, -1, 8), b[:a.shape[0] // 2]))
    assert np.array_equal(_np(getattr(F, op)(_t(a).reshape(2, -1, 8),
                                             _t(b[:a.shape[0] // 2]))), want)


def test_neg_canon_from_canon_from_uint_match_reference():
    rng = np.random.default_rng(3)
    a, _ = _pairs(rng)
    for name in ("neg", "canon", "from_canon"):
        want = np.asarray(_ref(name, getattr(RF, name))(a))
        assert np.array_equal(_np(getattr(F, name)(_t(a))), want), name
    small = np.array([0, 1, 7, 2**31, 2**32 - 1], dtype=np.uint32)
    want = np.asarray(_ref("from_uint", RF.from_uint)(small))
    assert np.array_equal(_np(F.from_uint(small, "cpu")), want)
    assert np.array_equal(_np(F.from_uint(torch.from_numpy(
        small.astype(np.int64)))), want)
    assert np.array_equal(F.is_zero(_t(a)).numpy(), np.asarray(RF.is_zero(a)))
    cond = np.arange(a.shape[0]) % 3 == 0
    assert np.array_equal(_np(F.select(torch.from_numpy(cond), _t(a),
                                       F.zeros((a.shape[0],), "cpu"))),
                          np.asarray(RF.select(cond, a, np.zeros_like(a))))


def test_reductions_powers_and_words_match_reference():
    rng = np.random.default_rng(4)
    x = _limbs(F.rand_ints((5, 7), rng)).reshape(5, 7, 8)
    tx = _t(x)
    for axis in (0, 1, -2):
        assert np.array_equal(_np(F.sum(tx, axis)),
                              np.asarray(RF.sum(jnp.asarray(x), axis)))
    empty = tx[:0]
    assert F.sum(empty, 0).shape == RF.sum(jnp.asarray(x[:0]), 0).shape
    assert not F.sum(empty, 0).any()
    assert np.array_equal(_np(F.dot(tx, tx, 1)),
                          np.asarray(RF.dot(jnp.asarray(x), jnp.asarray(x), 1)))
    v = tx[0, :3]
    assert F.decode(F.mul(F.inv(v), v)).tolist() == [1, 1, 1]
    p = F.pow_const(v, 12345)
    want = [pow(int(u), 12345, Q) for u in F.decode(v)]
    assert F.decode(p).tolist() == want
    assert F.decode(F.pow_const(v, 0)).tolist() == [1, 1, 1]
    tab = F.square_table(v)
    assert len(tab) == F.bits
    assert torch.equal(F.pow_with_table(tab, 12345), p)
    words = rng.integers(0, 1 << 40, (3, 12), dtype=np.uint64)
    want = np.asarray(RF.reduce_words(jnp.asarray(words)))
    got = F.reduce_words(torch.from_numpy(words.view(np.int64)))
    assert np.array_equal(_np(got), want)
    assert np.array_equal(F.widen(tx).numpy().astype(np.uint64),
                          np.asarray(RF.widen(jnp.asarray(x))))
    a, b = _pairs(rng)
    assert np.array_equal(F.geq(_t(a), _t(b)).numpy(),
                          np.asarray(RF.geq(a, b)))
    assert np.array_equal(F.geq(F.canon_const(Q - 1), _t(a)).numpy(),
                          np.asarray(RF.geq(RF.canon_const(Q - 1), a)))


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s7"])
def test_limb_fold_twin_matches_reference_fold(signed):
    """S3's twin against the reference's LimbPrescaledMat.fold on random
    and full-range int32 buckets, in both output layouts."""
    rng = np.random.default_rng(5 + signed)
    R, cols = 3, 10
    mat = RefLimbMat(RF, [[1] * 2] * R, unsigned=not signed)
    K = mat.K
    V = rng.integers(-2**31, 2**31, (K * R, cols)).astype(np.int32)
    V[:, :3] = rng.integers(0, 1 << 20, (K * R, 3))
    want = np.asarray(_ref(f"fold{signed}", mat.fold)(V))
    tV = torch.from_numpy(V)
    assert np.array_equal(_np(S.limb_fold_ref(tV, R, signed=signed)), want)
    assert np.array_equal(_np(S.limb_fold(tV, R, signed=signed)), want)
    assert np.array_equal(
        _np(S.limb_fold(tV, R, signed=signed, transpose_out=True)),
        want.transpose(1, 0, 2))


def test_kernel_wrappers_on_cpu_and_refusals():
    """On CPU tensors the wrappers return the twins' results and launch
    nothing; they refuse what the kernels do not take."""
    rng = np.random.default_rng(6)
    a, b = (F.rand((4, 3), rng, "cpu") for _ in range(2))
    before = dict(S.LAUNCHES)
    for op in ("mul", "add", "sub"):
        assert torch.equal(getattr(S, "stark_" + op)(a, b),
                           getattr(S, f"stark_{op}_ref")(a, b))
    assert S.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        S.stark_mul(a.to(torch.int64), b)
    with pytest.raises(TypeError, match="int32"):
        S.stark_add(a[..., :4], b[..., :4])
    with pytest.raises(ValueError, match="bucket rows"):
        S.limb_fold(torch.zeros((31, 4), dtype=torch.int32), 1, signed=False)
    with pytest.raises(TypeError, match="contiguous"):
        S.limb_fold(torch.zeros((4, 64), dtype=torch.int32).t(), 2,
                    signed=False)
    with pytest.raises(ValueError, match="several devices"):
        S.stark_mul(a, b.to("meta"))


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s7"])
def test_limb_prescaled_mat_matches_reference(unsigned):
    """The weights are byte-equal to the reference's; the product of a
    batch equals the reference's __call__, in both layouts."""
    rng = np.random.default_rng(7 + unsigned)
    m = F.rand_ints((5, 6), rng)
    mat = LimbPrescaledMat(m, unsigned)
    ref = RefLimbMat(RF, m, unsigned=unsigned)
    assert (mat.P, mat.K) == (ref.P, ref.K)
    assert mat.big.dtype == ref.big.dtype and np.array_equal(mat.big, ref.big)
    x = _limbs(F.rand_ints((3, 4, 6), rng)).reshape(3, 4, 6, 8)
    want = np.asarray(_ref(f"mat{unsigned}", ref.__call__)(x))
    w, corr = digit_table(mat.big, "cpu")
    assert np.array_equal(_np(mat(_t(x), w, corr)), want)
    x2 = _t(x).reshape(-1, 6, 8)
    # the batch-trailing layout, with a ragged column count padded to 8
    xt = x2.transpose(0, 1).contiguous()
    got_t = mat.apply(xt, w, corr)
    assert np.array_equal(_np(got_t.transpose(0, 1).reshape(3, 4, 5, 8)),
                          want)
    if unsigned:
        planes = mat.planes(xt)
        assert planes.shape == (32 * 6, 12)
        assert np.array_equal(planes.numpy(), np.asarray(
            ref.planes(jnp.asarray(x.reshape(12, 6, 8)))))


def test_primitive_root_matches_reference():
    """Pollard-rho factorization gives the reference's generators."""
    for f in ("goldilocks", "babybear", "frog", "stark_prime"):
        q = FIELDS[f].q
        assert find_primitive_root(q) == ref_root(q), f


@pytest.mark.parametrize("N", [4, 8])
def test_ntt_context_limb_axis_matches_reference(N):
    """The radix engine with the limb axis (log2 N even and odd: radix-4
    stages alone, and a radix-2 stage first): forward, inverse and mul
    against the reference's NTTContext."""
    rng = np.random.default_rng(N)
    ctx, ref = NTTContext(F, N, device="cpu"), RefNTT(RF, N)
    x = _limbs(F.rand_ints((2, N), rng)).reshape(2, N, 8)
    y = _limbs(F.rand_ints((2, N), rng)).reshape(2, N, 8)
    fx = ctx.forward(_t(x))
    assert np.array_equal(_np(fx), np.asarray(ref.forward(jnp.asarray(x))))
    assert torch.equal(ctx.inverse(fx), _t(x))
    assert np.array_equal(_np(ctx.mul(_t(x), _t(y))),
                          np.asarray(ref.mul(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("N", [16, 512])
def test_mxu_limb_ntt_matches_reference(N):
    """MxuLimbNTT at N = 16 (4 x 4) and 512 (16 x 32): its tables are
    byte-equal to the reference's consts() and its levels are
    LimbPrescaledMat (held to the reference above), and mul equals the
    radix NTTContext's (held to the reference's); mul_cached (batch-B and
    batch-1 states) and square equal the radix products; the reference's
    tables carried across give the same product.  (The reference's jitted
    mul takes most of a minute to compile on the CPU.)"""
    rng = np.random.default_rng(N + 1)
    e, ref = MxuLimbNTT(N, device="cpu"), RefLimbNTT(RF, N)
    assert (e.N1, e.N2) == (ref.N1, ref.N2)
    rc = {k: np.asarray(v) for k, v in ref.consts().items()}
    for k, v in e.consts().items():
        assert v.dtype == rc[k].dtype and np.array_equal(v, rc[k]), k
    B = 2
    x = _limbs(F.rand_ints((B, N), rng)).reshape(B, N, 8)
    y = _limbs(F.rand_ints((B, N), rng)).reshape(B, N, 8)
    got = e.mul(_t(x), _t(y))
    ctx = NTTContext(F, N, device="cpu")
    assert torch.equal(got, ctx.mul(_t(x), _t(y)))
    assert torch.equal(e.mul(_t(x), _t(y), from_jax_consts(rc, "cpu")), got)
    assert torch.equal(e.mul_cached(_t(x), e.precompute(_t(y))), got)
    assert torch.equal(e.mul_cached(_t(x), e.precompute(_t(y[:1]))),
                       ctx.mul(_t(x), _t(y[:1]).expand(B, N, 8)))
    assert torch.equal(e.square(_t(x)), ctx.mul(_t(x), _t(x)))
    assert torch.equal(e.inverse(e.forward(_t(x))), _t(x))
