"""The port's CUDA fold kernels on the card, against their plain twins,
and the fused engine against the kernel-free engine.  Marked ``cuda``:
they skip where no CUDA card is present.  This file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from stark_rings_tpu_torch import (GOLDILOCKS, Mxu2FusedNTT, Mxu2NTT,
                                   to_torch)
from stark_rings_tpu_torch.ops import fold as K

pytestmark = pytest.mark.cuda

Q = GOLDILOCKS.q


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _buckets(rng, rows, cols, signed):
    bound = (1 << 26) - 1 if signed else (1 << 27) - 1
    V = rng.integers(-bound if signed else 0, bound + 1, (rows, cols))
    V[:, :8] = bound
    V[:, 8:16] = -bound if signed else 0
    V[:, 16:24] = rng.integers(-2**31, 2**31, (rows, 8))
    return torch.from_numpy(V.astype(np.int32))


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t,B", [(32, 32, 3), (64, 128, 2), (128, 64, 2)])
def test_kernels_match_twins(dev, R, t, B, signed):
    rng = np.random.default_rng(R + t + signed)
    K_ = 9 if signed else 8
    V = _buckets(rng, K_ * R, B * t, signed).to(dev)
    Vb = _buckets(rng, K_ * R, B * t, signed).to(dev)
    tw = to_torch(rng.integers(0, Q, (R, t), dtype=np.uint64), dev)
    cases = [
        (K.fold_tw, K.fold_tw_ref, (V, tw, R), {"transpose_out": True}),
        (K.fold_tw, K.fold_tw_ref, (V, tw, R), {"transpose_out": False}),
        (K.fold_end, K.fold_end_ref, (V, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref, (V, Vb, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref,
         (torch.cat([V, Vb], 1), None, R), {}),
        (K.fold_end2_mul, K.fold_end2_mul_ref,
         (V, Vb[:, :t].contiguous(), R), {}),
    ]
    for kernel, twin, args, kw in cases:
        before = dict(K.LAUNCHES)
        got = kernel(*args, signed=signed, **kw)
        torch.cuda.synchronize()
        assert K.LAUNCHES[kernel.__name__] == before[kernel.__name__] + 1
        assert torch.equal(got, twin(*args, signed=signed, **kw)), \
            (kernel.__name__, kw)


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_fused_engine_matches_plain_on_card(dev, unsigned):
    N = 1 << 10
    rng = np.random.default_rng(3)
    a = to_torch(rng.integers(0, Q, (4, N), dtype=np.uint64), dev)
    b = to_torch(rng.integers(0, Q, (4, N), dtype=np.uint64), dev)
    fused = Mxu2FusedNTT(N, unsigned=unsigned, device=dev)
    plain = Mxu2NTT(N, unsigned=unsigned, device=dev)
    K.reset_launches()
    got = fused.mul(a, b)
    assert K.LAUNCHES == {"fold_tw": 3, "fold_end2_mul": 1, "fold_end": 1}
    assert torch.equal(got, plain.mul(a, b))
    state = fused.precompute(b[:1])
    assert torch.equal(fused.mul_cached(a, state),
                       plain.mul_cached(a, plain.precompute(b[:1])))


def test_wrappers_reject_mixed_devices(dev):
    V = torch.zeros((8 * 32, 64), dtype=torch.int32, device=dev)
    tw = torch.zeros((32, 32), dtype=torch.int64)
    with pytest.raises(ValueError, match="several devices"):
        K.fold_tw(V, tw, 32, signed=False)
    with pytest.raises(ValueError, match="several devices"):
        K.fold_end2_mul(V, V.cpu(), 32, signed=False)
