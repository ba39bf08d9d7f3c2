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
    x[0, :3] = [Q - 1, 0, 1][:N]
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


# -- the tile kernel's register rounds (csrc/ntt.cu), modelled on the CPU ---
#
# ntt_tile_kernel gives a thread REG = 2^RB words whose tile indices
# differ in the bits [lo, lo + RB) and runs those bits' stages in
# registers; between rounds the tile goes once through shared memory at
# the padded place i + (i >> RB).  The model below follows the kernel's
# index rules on the threads of one tile at once (a torch vector over
# the thread index u), so the schedule is checked here: every stage once
# and in order, the twiddle entries inside their stage, every exchange a
# permutation of the tile and free of bank conflicts.

RB = 4
REG = 1 << RB


def _word(u, lo, j):
    return ((u >> lo) << (lo + RB)) | (j << lo) | (u & ((1 << lo) - 1))


def _spad(i):
    return i + (i >> RB)


def _reg_stages(f, x, w, logN, L, tile, u, lo, e_lo, e_hi, inverse, done):
    for n in range(RB):
        b = n if inverse else RB - 1 - n
        h = lo + b
        if h < e_lo or h >= e_hi:
            continue
        done.append(h)
        s = logN - 1 - h
        wb = (1 << s) + (tile << (L - h - 1)) + ((u >> lo) << (RB - 1 - b))
        nw = min(1 << (RB - 1 - b), 1 << (L - 1 - b))
        assert int(wb.min()) >= 1 << s and int(wb.max()) + nw <= 2 << s
        tw = [w[wb + k] if k < nw else torch.zeros_like(u)
              for k in range(1 << (RB - 1 - b))]
        for j in range(REG):
            if j & (1 << b):
                continue
            a, c, t = x[j], x[j | (1 << b)], tw[j >> (b + 1)]
            if inverse:
                x[j], x[j | (1 << b)] = f.add(a, c), f.mul(t, f.sub(a, c))
            else:
                p = f.mul(t, c)
                x[j], x[j | (1 << b)] = f.add(a, p), f.sub(a, p)


def _load(words, u, lo, L):
    return [words[_word(u, lo, j)] if j < 1 << L else torch.zeros_like(u)
            for j in range(REG)]


def _store(out, x, u, lo, L):
    for j in range(min(REG, 1 << L)):
        out[_word(u, lo, j)] = x[j]


def _exchange(x, u, lo, nxt, L, log):
    sh = torch.zeros(((1 << L) + ((1 << L) >> RB),), dtype=torch.int64)
    hit = torch.zeros(sh.shape, dtype=torch.int64)
    for j in range(REG):
        sh[_spad(_word(u, lo, j))] = x[j]
        hit[_spad(_word(u, lo, j))] += 1
    for j in range(REG):
        x[j] = sh[_spad(_word(u, nxt, j))]
        hit[_spad(_word(u, nxt, j))] += 1
    assert int((hit == 2).sum()) == 1 << L   # a permutation of the tile
    log.append((lo, nxt))


def _forward_rounds(f, x, w, logN, L, tile, u, log, done):
    lo = max(L - RB, 0)
    _reg_stages(f, x, w, logN, L, tile, u, lo, lo, L, False, done)
    hi = lo
    while hi > 0:
        nxt = max(hi - RB, 0)
        _exchange(x, u, lo, nxt, L, log)
        lo = nxt
        _reg_stages(f, x, w, logN, L, tile, u, lo, lo, hi, False, done)
        hi = lo


def _inverse_rounds(f, x, w, logN, L, tile, u, log, done):
    top = max(L - RB, 0)
    _reg_stages(f, x, w, logN, L, tile, u, 0, 0, min(L, RB), True, done)
    lo, e = 0, RB
    while e < L:
        nxt = min(e, top)
        _exchange(x, u, lo, nxt, L, log)
        lo = nxt
        _reg_stages(f, x, w, logN, L, tile, u, lo, e, min(e + RB, L), True,
                    done)
        e += RB


def _tile_model(x, wf, wi, ninv, L, mode, other=None):
    """ntt_tile_kernel's rounds, one tile at a time; returns the rows and
    the exchanges and stage bits of the last tile."""
    f = G.F
    rows, N = x.shape
    logN = N.bit_length() - 1
    bits = G.MODES[mode]
    top = max(L - RB, 0)
    u = torch.arange(1 << max(L - RB, 0))
    out = torch.empty_like(x)
    for g in range(rows << (logN - L)):
        tile = g & ((1 << (logN - L)) - 1)
        row, at = g >> (logN - L), tile << L
        log, done = [], []
        args = (wf, logN, L, tile, u, log, done)
        if bits & G._PW_TILE:
            y = _load(other[row, at:at + (1 << L)], u, top, L)
            _forward_rounds(f, y, *args)
        xs = _load(x[row, at:at + (1 << L)], u,
                   top if bits & G._FWD else 0, L)
        if bits & G._FWD:
            _forward_rounds(f, xs, *args)
        if bits & G._PW_TILE:
            xs = [f.mul(a, c) for a, c in zip(xs, y)]
        if bits & G._PW_GLOBAL:
            o = _load(other[row, at:at + (1 << L)], u, 0, L)
            xs = [f.mul(a, c) for a, c in zip(xs, o)]
        seg = out[row, at:at + (1 << L)]
        if bits & G._INV:
            _inverse_rounds(f, xs, wi, logN, L, tile, u, log, done)
            if L == logN:
                xs = [f.mul(a, f.const(ninv, "cpu")) for a in xs]
            _store(seg, xs, u, top, L)
        else:
            _store(seg, xs, u, 0, L)
    return out, log, done


@pytest.mark.parametrize("L", list(range(1, 11)))
@pytest.mark.parametrize("mode", list(G.MODES))
def test_tile_rounds_model_matches_twin(mode, L):
    """The register rounds give the twin's tile for every log_tile below,
    at and above one thread's 2^RB words, in every mode: the whole row in
    one tile, and 2^(logN - L) tiles a row."""
    rng = np.random.default_rng(16 * L + len(mode))
    for logN in sorted({L, L + 2}):
        if mode == "mul" and logN != L:
            continue
        N = 1 << logN
        x, o = (to_torch(_rows(rng, 2, N), "cpu") for _ in range(2))
        e = GoldilocksKernelNTT(N, device="cpu")
        wf, wi, ninv = e.tables()
        got, log, done = _tile_model(x, wf, wi, ninv, L, mode, o)
        want = G.ntt_tile_ref(x, wf, wi, ninv, L, mode, o)
        assert torch.equal(got, want), logN
        fwd, inv = list(range(L - 1, -1, -1)), list(range(L))
        order = {"forward": fwd, "inverse": inv, "mul_eval": fwd + inv,
                 "mul": fwd + fwd + inv}[mode]
        assert done == order   # each stage once a direction, in order
        per_dir = max(0, -(-L // RB) - 1)
        assert len(log) == per_dir * (len(order) // L)


@pytest.mark.parametrize("L", [6, 9, 13, 14])
def test_tile_exchanges_free_of_bank_conflicts(L):
    """Every exchange of a tile of 2^L words, in both directions, writes
    and reads shared memory without a bank conflict: the 16 threads of a
    64-bit half-warp phase hit 16 distinct 8-byte bank pairs for every
    register j.  At 2^14 words: 4 rounds a direction, 3 exchanges."""
    u = torch.arange(1 << (L - RB))
    los = set()
    lo = L - RB
    while lo > 0:        # forward rounds: bit sets from the top down
        los.add(lo)
        lo = max(lo - RB, 0)
    los |= {0} | {min(e, L - RB) for e in range(RB, L, RB)}
    if L == 14:
        assert los == {10, 6, 2, 0, 4, 8}
    for lo in sorted(los):
        for j in range(REG):
            banks = (_spad(_word(u, lo, j)) % 16).reshape(-1, min(16, len(u)))
            for half in banks:
                assert len(set(half.tolist())) == len(half), (lo, j)
