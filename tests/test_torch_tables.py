"""Host tables of the PyTorch port against the JAX reference: the digit
weights and twiddles of Mxu2NTT byte for byte, find_primitive_root, and
the from_jax_consts path from the reference's tables to the port's
device tables."""

import numpy as np
import pytest
import torch

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.ops.mxu2 import Mxu2NTT as RefMxu2NTT
from stark_rings_tpu.ops.ntt import find_primitive_root as ref_root

from stark_rings_tpu_torch import (GOLDILOCKS, Mxu2FusedNTT, Mxu2NTT,
                                   from_jax_consts, to_numpy_u64, to_torch)
from stark_rings_tpu_torch.ops.ntt import find_primitive_root


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
@pytest.mark.parametrize("N", [1 << 10, 1 << 13, 1 << 16])
def test_consts_byte_equal(N, unsigned):
    """N = 2^13 is the asymmetric layout (N1 = 64, N2 = 128)."""
    port = Mxu2NTT(N, unsigned=unsigned, device="cpu")
    ref = RefMxu2NTT(N, unsigned=unsigned)
    assert (port.N1, port.N2) == (ref.N1, ref.N2)
    pc, rc = port.consts(), ref.consts()
    assert pc.keys() == rc.keys()
    for key in rc:
        want = np.asarray(rc[key])
        assert pc[key].dtype == want.dtype, key
        assert pc[key].shape == want.shape, key
        assert pc[key].tobytes() == want.tobytes(), key


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_find_primitive_root(name):
    q = get_field(name).q
    assert find_primitive_root(q) == ref_root(q)


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_from_jax_consts_roundtrip(unsigned):
    """The reference's consts() give the port's own device tables, and
    the engine's product is the same fed either way."""
    N = 1 << 10
    ref = RefMxu2NTT(N, unsigned=unsigned)
    tabs = from_jax_consts(ref.consts(), "cpu")
    port = Mxu2FusedNTT(N, unsigned=unsigned, device="cpu")
    assert tabs.keys() == port.c.keys()
    for key, t in port.c.items():
        assert tabs[key].dtype == t.dtype, key
        assert torch.equal(tabs[key], t), key
    for key in ("w1", "w2", "w2i", "w1i"):
        raw = np.asarray(ref.consts()[key])
        back = tabs[key].numpy()
        if unsigned:
            # a row of ones and 7 of zeros follow the digit rows
            extra = back[raw.shape[0]:]
            assert extra.shape == (8, raw.shape[1])
            assert (extra[0] == 1).all() and not extra[1:].any()
            back = (back[:raw.shape[0]].view(np.uint8) ^ np.uint8(0x80))
            ws = back.astype(np.int64) - 128
            corr = 128 * ws.sum(1) + 128 * 128 * raw.shape[1]
            assert np.array_equal(tabs[key + "_corr"].numpy()[:, 0], corr)
        assert back.tobytes() == raw.tobytes()
    for key in ("tw", "twi"):
        assert np.array_equal(to_numpy_u64(tabs[key]), ref.consts()[key])
    rng = np.random.default_rng(7)
    a = to_torch(rng.integers(0, GOLDILOCKS.q, (2, N), dtype=np.uint64),
                 "cpu")
    b = to_torch(rng.integers(0, GOLDILOCKS.q, (2, N), dtype=np.uint64),
                 "cpu")
    assert torch.equal(port.mul(a, b, tabs), port.mul(a, b))
