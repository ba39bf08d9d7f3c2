"""The fold kernels' plain twins (K1 fold_tw_ref, K2 fold_end2_mul_ref,
K3 fold_end_ref) against the reference Pallas kernels run in interpret
mode, on the same numpy-seeded buckets; and the wrappers' dispatch rule
on the CPU.  Exact equality throughout.

Each bucket tensor has four batch blocks: all zeros, all at the
scheme's bucket bound, random within the bound, and random over the
whole int32 range (the folds are exact for any int32 input)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.ops.pallas_fold import (fold_end2_mul_dma,
                                             fold_end_dma, fold_tw_dma)

from stark_rings_tpu_torch import GOLDILOCKS, to_numpy_u64, to_torch
from stark_rings_tpu_torch.ops import _build, fold as F

Q = GOLDILOCKS.q
B = 4
# (R, t): the N = 2^10 levels, and the N = 2^13 level 1 (R=64, t=128)
# and inverse level 1 (R=128, t=64), where R != t
LAYOUTS = [(32, 32), (64, 128), (128, 64)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _buckets(R, t, signed, seed, nb=B):
    rng = np.random.default_rng(seed)
    K = 9 if signed else 8
    bound = (1 << 26) - 1 if signed else (1 << 27) - 1
    lo = -bound if signed else 0
    blocks = [np.zeros((K * R, t), np.int64),
              np.full((K * R, t), bound, np.int64),
              rng.integers(lo, bound + 1, (K * R, t)),
              rng.integers(-2**31, 2**31, (K * R, t))][:nb]
    if signed:
        blocks[2][:, ::3] = -bound
    return np.concatenate(blocks, axis=1).astype(np.int32)


def _tw(R, t, seed):
    return np.random.default_rng(seed).integers(0, Q, (R, t), dtype=np.uint64)


def _u64(y):
    return np.asarray(y)


def _tw_planes(tw):
    v = jax.lax.bitcast_convert_type(jnp.asarray(tw), jnp.uint32)
    return v[..., 0], v[..., 1]


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("transpose_out", [True, False], ids=["T", "N"])
@pytest.mark.parametrize("R,t", LAYOUTS)
def test_fold_tw_twin(R, t, transpose_out, signed):
    V = _buckets(R, t, signed, seed=R + t)
    tw = _tw(R, t, seed=R * t)
    want = _u64(fold_tw_dma(jnp.asarray(V), *_tw_planes(tw), R, chunk=128,
                            transpose_out=transpose_out, interpret=True,
                            signed=signed))
    got = F.fold_tw_ref(torch.from_numpy(V), to_torch(tw, "cpu"), R,
                        transpose_out=transpose_out, signed=signed)
    assert got.shape == want.shape
    assert np.array_equal(to_numpy_u64(got), want)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("R,t", LAYOUTS[:2])
def test_fold_end_twin(R, t, signed):
    V = _buckets(R, t, signed, seed=3 * R + t)
    want = _u64(fold_end_dma(jnp.asarray(V), R, chunk=128, interpret=True,
                             signed=signed))
    got = F.fold_end_ref(torch.from_numpy(V), R, signed=signed)
    assert np.array_equal(to_numpy_u64(got), want)


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("mode", ["two", "stacked", "batch1"])
@pytest.mark.parametrize("R,t", LAYOUTS[:2])
def test_fold_end2_mul_twin(R, t, mode, signed):
    Va = _buckets(R, t, signed, seed=5 * R + t)
    Vb = _buckets(R, t, signed, seed=7 * R + t)[:, ::-1].copy()
    if mode == "two":
        want = fold_end2_mul_dma(jnp.asarray(Va), jnp.asarray(Vb), R,
                                 chunk=128, interpret=True, signed=signed)
        got = F.fold_end2_mul_ref(torch.from_numpy(Va),
                                  torch.from_numpy(Vb), R, signed=signed)
    elif mode == "stacked":
        V = np.concatenate([Va, Vb], axis=1)
        want = fold_end2_mul_dma(jnp.asarray(V), None, R, chunk=128,
                                 interpret=True, signed=signed)
        got = F.fold_end2_mul_ref(torch.from_numpy(V), None, R,
                                  signed=signed)
    else:
        # batch-1 cached operand: the reference broadcasts it over the
        # batch before its kernel (pallas_fold.py Mxu2PallasNTT
        # ._tail_cached); the port's K2 reads column c mod t instead
        V1 = Vb[:, :t].copy()
        wide = np.tile(V1, (1, B))
        want = fold_end2_mul_dma(jnp.asarray(Va), jnp.asarray(wide), R,
                                 chunk=128, interpret=True, signed=signed)
        got = F.fold_end2_mul_ref(torch.from_numpy(Va),
                                  torch.from_numpy(V1), R, signed=signed)
    assert np.array_equal(to_numpy_u64(got), _u64(want))


# -- the wrappers on the CPU -------------------------------------------------


def _wrapper_calls(R, t, signed):
    V = torch.from_numpy(_buckets(R, t, signed, seed=11))
    Vb = torch.from_numpy(_buckets(R, t, signed, seed=12))
    tw = to_torch(_tw(R, t, seed=13), "cpu")
    return [
        (F.fold_tw(V, tw, R, transpose_out=True, signed=signed),
         F.fold_tw_ref(V, tw, R, transpose_out=True, signed=signed)),
        (F.fold_end(V, R, signed=signed), F.fold_end_ref(V, R, signed=signed)),
        (F.fold_end2_mul(V, Vb, R, signed=signed),
         F.fold_end2_mul_ref(V, Vb, R, signed=signed)),
        (F.fold_end2_mul(V, Vb[:, :t].contiguous(), R, signed=signed),
         F.fold_end2_mul_ref(V, Vb[:, :t], R, signed=signed)),
        (F.fold_end2_mul(torch.cat([V, Vb], 1), None, R, signed=signed),
         F.fold_end2_mul_ref(V, Vb, R, signed=signed)),
    ]


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
def test_wrappers_on_cpu_use_twins_and_launch_nothing(signed):
    F.reset_launches()
    for got, want in _wrapper_calls(64, 128, signed):
        assert torch.equal(got, want)
    assert F.LAUNCHES == {"fold_tw": 0, "fold_end2_mul": 0, "fold_end": 0,
                          "pointwise_mul": 0, "pointwise_chain": 0}


def test_wrappers_reject_other_devices_and_bad_inputs():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA
    card raises, as do inputs the kernels do not take."""
    R, t = 32, 32
    V = torch.from_numpy(_buckets(R, t, False, seed=1))
    tw = to_torch(_tw(R, t, seed=2), "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        F.fold_end(V.to("meta"), R, signed=False)
    with pytest.raises(ValueError, match="no kernel for device"):
        F.fold_tw(V.to("meta"), tw.to("meta"), R, signed=False)
    with pytest.raises(ValueError, match="no kernel for device"):
        F.fold_end2_mul(V.to("meta"), None, R, signed=False)
    with pytest.raises(TypeError):
        F.fold_end(V.to(torch.int64), R, signed=False)
    with pytest.raises(ValueError, match="contiguous"):
        F.fold_end(V.t().contiguous().t(), R, signed=False)
    with pytest.raises(ValueError, match="bucket rows"):
        F.fold_end(V, R, signed=True)
    with pytest.raises(ValueError, match="contiguous int64"):
        F.fold_tw(V, tw.t(), R, signed=False)
    with pytest.raises(ValueError, match="does not divide"):
        F.fold_tw(V[:, :40].contiguous(), tw, R, signed=False)
    with pytest.raises(ValueError, match="do not divide"):
        F.fold_end2_mul(V, V[:, :48].contiguous(), R, signed=False)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Asking for the kernels where nvcc cannot be found raises."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.setattr(_build, "_CUDA_ROOTS", ())
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()
