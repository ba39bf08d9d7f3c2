"""The digit GEMM of the PyTorch port (PrescaledMat.planes / dot / fold)
against the JAX reference: int32 buckets bit-equal for both digit
schemes, including all-255 digits at the int32 accumulation bound.  The
unsigned scheme goes through torch._int_mm (int8 only) by the offset
identity of ops/mxu2.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.ops.mxu2 import PrescaledMat as RefMat

from stark_rings_tpu_torch import GOLDILOCKS, from_jax_consts, to_torch
from stark_rings_tpu_torch.ops.mxu2 import PrescaledMat

Q = GOLDILOCKS.q


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mats(R, C, unsigned, seed, full=False):
    """A random constant matrix (all entries q - 1 with ``full``)."""
    rng = np.random.default_rng(seed)
    if full:
        m = np.full((R, C), Q - 1, dtype=object)
    else:
        m = np.array(rng.integers(0, Q, (R, C), dtype=np.uint64).tolist(),
                     dtype=object)
    return PrescaledMat(m, unsigned), RefMat(m, unsigned)


def _table(mat):
    tabs = from_jax_consts({"w1": mat.big, "w2": mat.big, "w2i": mat.big,
                            "w1i": mat.big,
                            "tw": np.zeros((1, 1), np.uint64),
                            "twi": np.zeros((1, 1), np.uint64)}, "cpu")
    return tabs["w1"], tabs.get("w1_corr")


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
@pytest.mark.parametrize("R,C,cols", [(32, 32, 96), (64, 128, 40),
                                      (256, 256, 24)])
def test_dot_bit_equal(R, C, cols, unsigned):
    port, ref = _mats(R, C, unsigned, seed=R + C)
    assert port.big.tobytes() == ref.big.tobytes()
    rng = np.random.default_rng(cols)
    x = rng.integers(0, Q, (C, cols), dtype=np.uint64)
    x[:, 0] = 0
    x[:, 1] = Q - 1
    xt = to_torch(x, "cpu")
    planes = port.planes(xt)
    assert np.array_equal(planes.numpy(), np.asarray(ref.planes(x)))
    w, corr = _table(port)
    V = port.dot(xt, w, corr)
    want = np.asarray(ref.dot(jnp.asarray(x)))
    assert V.dtype == torch.int32 and np.array_equal(V.numpy(), want)
    # the plain fold of those buckets (the kernel-free Mxu2NTT path)
    got = port.fold(V).numpy().view(np.uint64)
    assert np.array_equal(got, np.asarray(ref.fold(jnp.asarray(want))))


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_dot_at_accumulation_bound(unsigned):
    """Data 2^64 - 1 (every 8-bit digit 255; every 7-bit digit 127 but
    the tenth, which holds only bit 63) times a weight table of extreme
    digits (255, or -128 signed): the unsigned buckets sit exactly at
    the int32 bound P*C*255*255 the scheme asserts."""
    R, C, cols = 32, 256, 16
    port, ref = _mats(R, C, unsigned, seed=0)
    port.big = np.full_like(port.big, 255 if unsigned else -128)
    x = np.full((C, cols), 2**64 - 1, dtype=np.uint64)
    w, corr = _table(port)
    V = port.dot(to_torch(x, "cpu"), w, corr)
    want = np.asarray(ref.dot(jnp.asarray(x), big=jnp.asarray(port.big)))
    bound = (8 * C * 255 * 255 if unsigned else -128 * C * (9 * 127 + 1))
    assert np.all(want == bound)
    assert np.array_equal(V.numpy(), want)
