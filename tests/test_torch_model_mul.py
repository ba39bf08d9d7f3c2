"""The slice as a whole: the port's batch-trailing model multiply
(``ops/model_mul.py`` ``TModelMul``) on the CPU against the reference's
``stark_rings_tpu.ops.model_mul.TModelMul`` for goldilocks, babybear and
frog: crt_t / icrt_t / ntt_mul_t, mul_t (with the ring's own digit
tables and the reference's carried across), mul_cached_t with a batch-B
and a batch-1 operand, square_t, ntt_mul_bt's broadcasts, matvec_t
unblocked and blocked (bit-equal to each other), and the integer spec's
coefficient product.  On the CPU the folds K3 and ``bb_fold_end`` run as
their twins.  Inputs are numpy-seeded storage words carried across,
with a batch that is not a multiple of 8; outputs are compared through
``decode``, with no differing value allowed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.ops.model_mul import TModelMul as RefTModelMul
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import from_jax_consts, from_jax_storage
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.rings import get_ring

NAMES = ["goldilocks", "babybear", "frog"]
B = 13


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _setup(name, shape, seed):
    ring, ref = get_ring(name, device="cpu"), ref_ring(name)
    rng = np.random.default_rng(seed)
    dt = np.uint32 if ring.field.dtype == torch.int32 else np.uint64
    xs = [rng.integers(0, ring.q, s + (ring.D,), dtype=dt) for s in shape]
    port = [from_jax_storage(ring.field, x, "cpu") for x in xs]
    return ring, ref, port, [jnp.asarray(x) for x in xs]


def J(fn, **static):
    """The reference function ``fn`` jitted (one compile of the whole
    graph, much faster here than its ops one by one), ``static`` bound."""
    return jax.jit(lambda *args: fn(*args, **static))


def _same(ring, ref, got, want, what):
    assert ring.decode(got).tolist() == ref.decode(want).tolist(), \
        (ring.name, what)


@pytest.mark.parametrize("name", NAMES)
def test_mul_t_matches_reference(name):
    ring, ref, (a, b), (a_r, b_r) = _setup(name, [(B,), (B,)],
                                            NAMES.index(name))
    tm, rt = TModelMul(ring), RefTModelMul(ref)
    at, bt = tm.to_t(a), tm.to_t(b)
    at_r, bt_r = rt.to_t(a_r), rt.to_t(b_r)
    assert at.shape == (ring.D, B) and torch.equal(tm.from_t(at), a)

    fa, fb = tm.crt_t(at), tm.crt_t(bt)
    _same(ring, ref, fa, J(rt.crt_t)(at_r), "crt_t")
    _same(ring, ref, tm.icrt_t(fa), at_r, "icrt_t")
    prod = tm.ntt_mul_t(fa, fb)
    _same(ring, ref, prod, J(lambda x, y: rt.ntt_mul_t(rt.crt_t(x),
                                                       rt.crt_t(y)))(
        at_r, bt_r), "ntt_mul_t")
    want = J(rt.mul_t)(at_r, bt_r)
    got = tm.mul_t(at, bt)
    _same(ring, ref, got, want, "mul_t")
    _same(ring, ref, got, J(ref.coeff_mul)(a_r, b_r).T, "mul_t = coeff_mul")
    _same(ring, ref, tm.mul(a, b), J(rt.mul)(a_r, b_r), "mul")
    c = from_jax_consts({k: np.asarray(v) for k, v in rt.consts().items()},
                        "cpu")
    assert tm.consts().keys() == c.keys() - {"crt_corr", "icrt_corr"}
    assert torch.equal(tm.mul_t(at, bt, c), got)

    _same(ring, ref, tm.mul_cached_t(at, tm.precompute_t(bt)), want,
          "mul_cached_t")
    f1 = tm.precompute_t(bt[:, :1])
    _same(ring, ref, tm.mul_cached_t(at, f1),
          J(lambda x, y: rt.mul_cached_t(x, rt.precompute_t(y)))(
              at_r, bt_r[:, :1]),
          "mul_cached_t batch-1")
    _same(ring, ref, tm.square_t(at), J(rt.square_t)(at_r), "square_t")
    # a two-axis batch keeps its shape
    a2 = tm.to_t(a[:12].reshape(3, 4, ring.D))
    assert torch.equal(tm.mul_t(a2, a2).reshape(ring.D, 12),
                       tm.square_t(at[:, :12]))


@pytest.mark.parametrize("name", NAMES)
def test_ntt_mul_bt_broadcasts(name):
    ring, ref, (a, b), (a_r, b_r) = _setup(name, [(3, 1), (1, 4)], 7)
    tm, rt = TModelMul(ring), RefTModelMul(ref)
    got = tm.ntt_mul_bt(tm.to_t(a), tm.to_t(b))
    assert got.shape == (ring.D, 3, 4)
    _same(ring, ref, got, J(rt.ntt_mul_bt)(rt.to_t(a_r), rt.to_t(b_r)),
          "ntt_mul_bt")
    full = tm.ntt_mul_t(tm.to_t(a.expand(3, 4, ring.D)),
                        tm.to_t(b.expand(3, 4, ring.D)))
    assert torch.equal(got, full)


@pytest.mark.parametrize("name", NAMES)
def test_matvec_t_blocked_and_unblocked(name):
    n, m, W = 3, 5, 2
    ring, ref, (A, x), (A_r, x_r) = _setup(name, [(n, m), (W, m)], 8)
    tm, rt = TModelMul(ring), RefTModelMul(ref)
    At, xt = tm.to_t(A), tm.to_t(x)          # [D, n, m], [D, W, m]
    At_r, xt_r = rt.to_t(A_r), rt.to_t(x_r)
    got = tm.matvec_t(At, xt)
    assert got.shape == (ring.D, W, n)
    _same(ring, ref, got, J(rt.matvec_t)(At_r, xt_r), "matvec_t")
    for block in (1, 2, 4):
        assert torch.equal(tm.matvec_t(At, xt, block=block), got), block
    _same(ring, ref, tm.matvec_t(At, xt, block=2),
          J(rt.matvec_t, block=2)(At_r, xt_r), "matvec_t blocked")
    got1 = tm.matvec_t(At, xt[:, 0])
    assert got1.shape == (ring.D, n) and torch.equal(got1, got[:, 0])
    # c[i] = sum_j A[i, j] * x[j], by the ring's slot product
    want = ring.field.sum(ring.ntt_mul(A[None], x[:, None]), axis=2)
    assert torch.equal(tm.from_t(got), want)


@pytest.mark.parametrize("name", NAMES)
def test_mul_t_spec_oracle(name):
    """One element through the port's integer spec's coefficient
    product."""
    ring = get_ring(name, device="cpu")
    rng = np.random.default_rng(5)
    a, b = (ring.field.rand_ints((ring.D,), rng) for _ in range(2))
    want = ring.spec.coeff_mul(list(a), list(b))
    tm = TModelMul(ring)
    got = tm.mul(ring.encode_coeffs(a[None]), ring.encode_coeffs(b[None]))
    assert ring.decode(got)[0].tolist() == want
