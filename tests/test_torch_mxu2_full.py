"""The PyTorch port's ring multiply at full width (N = 2^16, the main
path's N1 = N2 = 256 layout) on the CPU, batch 2, against the native
host oracle HostGoldilocks and the reference's jitted Mxu2NTT on XLA
CPU.  Exact equality."""

import numpy as np
import pytest
import torch

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.native.host import HostGoldilocks
from stark_rings_tpu.ops.mxu2 import Mxu2NTT as RefMxu2NTT

from stark_rings_tpu_torch import Mxu2FusedNTT, Mxu2NTT, to_numpy_u64, to_torch

N = 1 << 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(9)
    a = rng.integers(0, RF.q, (2, N), dtype=np.uint64)
    b = rng.integers(0, RF.q, (2, N), dtype=np.uint64)
    port = Mxu2FusedNTT(N)
    got = to_numpy_u64(port.mul(to_torch(a, "cpu"), to_torch(b, "cpu")))
    return a, b, port, got


@pytest.fixture(scope="module")
def ref():
    return RefMxu2NTT(N)


def test_full_width_matches_host_oracle(case):
    a, b, port, got = case
    assert (port.N1, port.N2) == (256, 256)
    assert np.array_equal(got, HostGoldilocks(N).mul(a, b))


def test_full_width_matches_reference_jit_mul(case, ref):
    a, b, _, got = case
    assert np.array_equal(got, np.asarray(ref.jit_mul()(a, b)))


def test_full_width_plain_engine_and_square(case, ref):
    """The kernel-free Mxu2NTT path at full width, and the fused square
    against the reference's jitted square."""
    a, b, port, got = case
    plain = Mxu2NTT(N)
    assert np.array_equal(
        to_numpy_u64(plain.mul(to_torch(a, "cpu"), to_torch(b, "cpu"))), got)
    sq = to_numpy_u64(port.square(to_torch(a, "cpu")))
    assert np.array_equal(sq, np.asarray(ref.jit_square()(a)))
