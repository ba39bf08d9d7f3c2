"""The PyTorch port's ring multiply as a whole, on the CPU, against the
JAX reference: the fused engine (Mxu2FusedNTT, whose fold wrappers run
their plain twins here) against Mxu2PallasNTT in interpret mode with
the settings of the main path, and against the independent radix
NTTContext; the plain Mxu2NTT against the reference's jitted multiply
at the asymmetric N = 2^13.  Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.ops.mxu2 import Mxu2NTT as RefMxu2NTT
from stark_rings_tpu.ops.ntt import NTTContext
from stark_rings_tpu.ops.pallas_fold import Mxu2PallasNTT

from stark_rings_tpu_torch import (Mxu2FusedNTT, Mxu2NTT, to_numpy_u64,
                                   to_torch)
from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook

N = 1 << 10
B = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    a = rng.integers(0, RF.q, (B, N), dtype=np.uint64)
    b = rng.integers(0, RF.q, (B, N), dtype=np.uint64)
    a[0, :4] = [0, 1, RF.q - 1, 2**32]
    return a, b


@pytest.fixture(scope="module")
def engines():
    def ref(stack_forward=False):
        return Mxu2PallasNTT(N, interpret=True, dma_folds=True,
                             fold_chunk=128, pointwise_pallas=True,
                             fuse_pointwise=True,
                             stack_forward=stack_forward)
    return {"ref": ref(), "ref_stacked": ref(True),
            "port": Mxu2FusedNTT(N, device="cpu"),
            "port_stacked": Mxu2FusedNTT(N, stack_forward=True,
                                         device="cpu"),
            "ctx": NTTContext(RF, N, negacyclic=True)}


def _t(x):
    return to_torch(x, "cpu")


def _run(engines, variant, a, b):
    """(port result, reference result, radix-oracle result)."""
    ref, port, ctx = engines["ref"], engines["port"], engines["ctx"]
    if variant == "mul":
        got = port.mul(_t(a), _t(b))
        want = ref.mul(a, b)
        oracle = ctx.mul(a, b)
    elif variant == "stack_forward":
        got = engines["port_stacked"].mul(_t(a), _t(b))
        want = engines["ref_stacked"].mul(a, b)
        oracle = ctx.mul(a, b)
    elif variant == "square":
        got = port.square(_t(a))
        want = ref.square(a)
        oracle = ctx.mul(a, a)
    elif variant == "mul_cached":
        state = port.precompute(_t(b))
        assert state.dtype == torch.int32     # level-2 buckets
        got = port.mul_cached(_t(a), state)
        want = ref.mul_cached(a, ref.precompute(b))
        oracle = ctx.mul(a, b)
    else:  # mul_cached_batch1: one challenge times the whole batch
        c1 = b[:1]
        state = port.precompute(_t(c1))
        assert state.shape[1] == port.N1
        got = port.mul_cached(_t(a), state)
        want = ref.mul_cached(a, ref.precompute(c1))
        oracle = ctx.mul(a, jnp.broadcast_to(c1, a.shape))
    return to_numpy_u64(got), np.asarray(want), np.asarray(oracle)


@pytest.mark.parametrize("variant", ["mul", "stack_forward", "square",
                                     "mul_cached", "mul_cached_batch1"])
def test_fused_engine_matches_reference(engines, data, variant):
    got, want, oracle = _run(engines, variant, *data)
    assert got.shape == (B, N)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle)


def test_plain_engine_batch1_cached(data):
    """The plain engine's cached state is evaluations; a batch-1 state
    broadcasts over the live batch."""
    a, b = data
    port = Mxu2NTT(N, device="cpu")
    got = port.mul_cached(_t(a), port.precompute(_t(b[:1])))
    want = NTTContext(RF, N, negacyclic=True).mul(
        a, jnp.broadcast_to(b[:1], a.shape))
    assert np.array_equal(to_numpy_u64(got), np.asarray(want))


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_asymmetric_layout_matches_jit_mul(engine):
    """N = 2^13 (N1 = 64, N2 = 128): R != t at every level."""
    n = 1 << 13
    rng = np.random.default_rng(8)
    a = rng.integers(0, RF.q, (2, n), dtype=np.uint64)
    b = rng.integers(0, RF.q, (2, n), dtype=np.uint64)
    port = (Mxu2NTT(n, device="cpu") if engine == "plain"
            else Mxu2FusedNTT(n, device="cpu"))
    assert (port.N1, port.N2) == (64, 128)
    got = to_numpy_u64(port.mul(_t(a), _t(b)))
    want = np.asarray(RefMxu2NTT(n).jit_mul()(a, b))
    assert np.array_equal(got, want)


def test_native_schoolbook_oracle(data):
    """The port's JAX-free loader of the C++ schoolbook multiply (the
    card run's independent oracle) against the radix NTTContext, and
    against the fused engine."""
    a, b = data
    want = np.asarray(NTTContext(RF, N, negacyclic=True).mul(a, b))
    got = np.stack([negacyclic_mul_schoolbook(x, y) for x, y in zip(a, b)])
    assert np.array_equal(got, want)
    fused = Mxu2FusedNTT(N, device="cpu").mul(_t(a), _t(b))
    assert np.array_equal(to_numpy_u64(fused), got)
