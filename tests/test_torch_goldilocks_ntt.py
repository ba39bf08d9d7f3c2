"""The radix-2 Goldilocks NTT engine (``ops/goldilocks_ntt.py``) on the
CPU, where its kernel wrappers run their plain twins, against the
reference: its tables against ``GoldilocksPallasNTT``'s, forward and
inverse against the Pallas kernel in interpret mode, and mul /
mul_composite against the JAX ``NTTContext.mul``, with the stage split
(tile stages and device-memory passes) moved by lowering ``LOG_TILE`` so
that small rows reach the passes.  Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.fields import get_field
from stark_rings_tpu.ops.ntt import get_ntt
from stark_rings_tpu.ops.pallas_goldilocks import GoldilocksPallasNTT

from stark_rings_tpu_torch import NTTContext, to_numpy_u64, to_torch
from stark_rings_tpu_torch.ops import goldilocks_ntt as G
from stark_rings_tpu_torch.ops.goldilocks_ntt import GoldilocksKernelNTT

F = get_field("goldilocks")
Q = F.q


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rows(rng, B, N):
    x = rng.integers(0, Q, (B, N), dtype=np.uint64)
    x[0, :3] = [Q - 1, 0, 1]
    return x


def _join(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))


@pytest.mark.parametrize("N", [128, 1024])
def test_tables_match_reference(N):
    ref = GoldilocksPallasNTT(N)
    wf, wi, ninv = GoldilocksKernelNTT(N, device="cpu").tables()
    assert np.array_equal(to_numpy_u64(wf), _join(ref.wf_lo, ref.wf_hi))
    assert np.array_equal(to_numpy_u64(wi), _join(ref.wi_lo, ref.wi_hi))
    assert ninv == int(_join(ref.ninv_lo, ref.ninv_hi))


def test_forward_inverse_match_pallas_interpret(monkeypatch):
    N = 128
    rng = np.random.default_rng(72)
    a = _rows(rng, 3, N)
    pk = GoldilocksPallasNTT(N, rows_per_block=2, interpret=True)
    fwd = np.asarray(pk.forward(jax.device_put(a)))
    inv = np.asarray(pk.inverse(jax.device_put(a)))
    for log_tile in (7, 3):
        monkeypatch.setattr(G, "LOG_TILE", log_tile)
        e = GoldilocksKernelNTT(N, device="cpu")
        assert e.passes == 7 - log_tile
        assert np.array_equal(to_numpy_u64(e.forward(to_torch(a, "cpu"))),
                              fwd), log_tile
        assert np.array_equal(to_numpy_u64(e.inverse(to_torch(a, "cpu"))),
                              inv), log_tile


@pytest.mark.parametrize("log_tile", [14, 5, 1])
@pytest.mark.parametrize("logN", [7, 10, 12])
def test_mul_matches_jax_ntt(logN, log_tile, monkeypatch):
    N = 1 << logN
    rng = np.random.default_rng(logN * 16 + log_tile)
    a, b = _rows(rng, 2, N), _rows(rng, 2, N)
    want = np.asarray(jax.jit(get_ntt("goldilocks", N).mul)(
        jax.device_put(a), jax.device_put(b)))
    monkeypatch.setattr(G, "LOG_TILE", log_tile)
    e = GoldilocksKernelNTT(N, device="cpu")
    assert e.passes == max(0, logN - log_tile)
    ta, tb = to_torch(a, "cpu"), to_torch(b, "cpu")
    assert np.array_equal(to_numpy_u64(e.mul(ta, tb)), want)
    assert np.array_equal(to_numpy_u64(e.mul_composite(ta, tb)), want)
    ctx = NTTContext(e.ctx.f, N, device="cpu")
    assert torch.equal(e.forward(ta), ctx.forward(ta))
    assert torch.equal(e.inverse(ta), ctx.inverse(ta))


@pytest.mark.parametrize("mode", list(G.MODES))
def test_tile_twin_is_stage_twins(mode):
    """ntt_tile's twin equals its stages run one by one with ntt_stage's
    twin (the tile is the whole row here, so 1/N lands in the tile)."""
    N, log_tile = 256, 8
    rng = np.random.default_rng(len(mode))
    x, o = (to_torch(_rows(rng, 2, N), "cpu") for _ in range(2))
    e = GoldilocksKernelNTT(N, device="cpu")
    wf, wi, ninv = e.tables()
    got = G.ntt_tile(x, wf, wi, ninv, log_tile, mode, o)
    y = x
    if mode != "inverse":
        for s in range(8):
            y = G.ntt_stage_ref(y, wf, s, inverse=False)
    if mode == "mul":
        o = e.forward(o)
    if mode in ("mul", "mul_eval"):
        y = e.pointwise(y, o)
    if mode != "forward":
        for s in reversed(range(8)):
            y = G.ntt_stage_ref(y, wi, s, inverse=True,
                                ninv=ninv if s == 0 else None)
    assert torch.equal(got, y)


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    N = 256
    e = GoldilocksKernelNTT(N, device="cpu")
    wf, wi, ninv = e.tables()
    x = torch.zeros((2, N), dtype=torch.int64)
    before = dict(G.LAUNCHES)
    e.mul(x, x)
    assert G.LAUNCHES == before
    with pytest.raises(TypeError):
        G.ntt_stage(x.to(torch.int32), wf, 0)
    with pytest.raises(ValueError, match="contiguous"):
        G.ntt_stage(x.t(), wf, 0)
    with pytest.raises(ValueError, match="power of two"):
        G.ntt_stage(x[:, :12].contiguous(), wf[:12].contiguous(), 0)
    with pytest.raises(ValueError, match="stage"):
        G.ntt_stage(x, wf, 8)
    with pytest.raises(ValueError, match="whole row"):
        G.ntt_tile(x, wf, wi, ninv, 4, "mul", x)
    with pytest.raises(ValueError, match="unknown mode"):
        G.ntt_tile(x, wf, wi, ninv, 8, "square")
