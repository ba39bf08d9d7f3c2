"""A CPU model of the fused mod-mat kernel's tiling (``csrc/mxu.cu``,
wrapper ``ops/mxu_fused.py``), held against the plain twin
``mxu_mod_mat_ref`` and, on small matrices, ``MxuModMatPallas`` in
interpret mode.  The model walks the kernel's schedule with numpy: the
weight table of ``tc_weights`` (digit planes, rows padded to 64 and
columns to 32), a block's 64 x 32 tile of y over chunks of 32 matrix
columns, the chunk's shared-memory planes (weights as 32-bit words of 4
bytes, x's digits packed 4 rows to a word the way the kernel's byte
permutes pack them), each warp's A and B fragments gathered at the
kernel's addresses and multiplied by the m16n8k32 layouts of the PTX
ISA, the 19 int32 bucket tiles a thread holds, and the epilogue's fold
of a thread's buckets into 32-bit limbs summed in 64 bits, three 64-bit
words and mod q.  Shapes are
ragged against the tile on every axis; x holds 2^64 - 1, q - 1, 0 and 1;
C reaches check_bound's limit at one small M.  Exact equality
throughout."""

import random

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.ops.pallas_mxu import MxuModMatPallas

from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.ops import mxu_fused as MF
from stark_rings_tpu_torch.ops.mxu import DIGITS, NBUCKETS, check_bound

Q = F.q
BR, BM, KC, KQ, MT = 64, 32, 32, 8, 2    # csrc/mxu.cu's tile
WARPS_M = BM // 8

# the m16n8k32 s8 fragment layouts (PTX ISA, mma.m16n8k32): lane = 4g + t.
# A (16 x 32, row): register i, byte j -> row g + 8 (i & 1), column
# 4t + j + 16 (i >> 1); B (32 x 8, col): register i, byte j -> row
# 4t + j + 16 i, column g; C (16 x 8): element i -> row g + 8 (i >> 1),
# column 2t + (i & 1).
_L = np.arange(32)
_G, _T = _L // 4, _L % 4
A_ROW = (_G[:, None, None] + 8 * (np.arange(4)[None, :, None] & 1)
         + 0 * np.arange(4)[None, None, :])
A_COL = (4 * _T[:, None, None] + np.arange(4)[None, None, :]
         + 16 * (np.arange(4)[None, :, None] >> 1))
B_ROW = (4 * _T[:, None, None] + np.arange(4)[None, None, :]
         + 16 * np.arange(2)[None, :, None])
B_COL = np.broadcast_to(_G[:, None, None], B_ROW.shape)
C_ROW = _G[:, None] + 8 * (np.arange(4)[None, :] >> 1)
C_COL = 2 * _T[:, None] + (np.arange(4)[None, :] & 1)


def _bytes(words):
    """uint32 [...] -> int64 [..., 4], byte j of each word (the digits
    lie in [0, 127], so s8 reads them as they are)."""
    return ((words[..., None] >> (8 * np.arange(4, dtype=np.uint32)))
            & 0xFF).astype(np.int64)


def _mma(a_regs, b_regs):
    """D = A B for the fragments of one warp: a_regs uint32 [..., 32, 4],
    b_regs [..., 32, 2] -> D int64 [..., 16, 8].  The product runs in
    float64, exact here: each sum is at most 32 * 127^2 < 2^53."""
    A = np.zeros(a_regs.shape[:-2] + (16, 32))
    A[..., A_ROW, A_COL] = _bytes(a_regs)
    B = np.zeros(b_regs.shape[:-2] + (32, 8))
    B[..., B_ROW, B_COL] = _bytes(b_regs)
    return (A @ B).astype(np.int64)


def _digit_words(xv):
    """uint64 [..., 4] (rows 4q .. 4q+3 of one column) -> uint32 [DIGITS,
    ...]: digit l of the four words packed low row first, as the kernel's
    digit_word and byte permutes make them."""
    lo = (xv & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    hi = xv >> np.uint64(32)
    out = []
    for l in range(DIGITS):
        r = 7 * l
        if r + 7 <= 32:
            y = lo >> np.uint64(r)
        elif r < 32:                     # the funnel shift
            y = ((hi << np.uint64(32)) | lo) >> np.uint64(r)
        else:
            y = hi >> np.uint64(r - 32)
        y = y & np.uint64(0xFF)
        w = (y[..., 0] | (y[..., 1] << np.uint64(8))
             | (y[..., 2] << np.uint64(16)) | (y[..., 3] << np.uint64(24)))
        out.append((w & np.uint64(0x7F7F7F7F)).astype(np.uint32))
    return np.stack(out)


def _reduce128(hi, lo):
    return (hi * 2**64 + lo) % Q


def _fold(v):
    """The kernel's fold_buckets: each bucket's value shifted by 7s split
    into two 32-bit pieces summed into 64-bit limbs, one carry pass, three
    64-bit words, mod q (2^64 = 2^32 - 1, 2^128 = -2^32)."""
    limb = [0] * 5
    for s in range(NBUCKETS):
        val = int(v[s])
        assert 0 <= val < 2**31
        r = 7 * s
        j, sh = r >> 5, r & 31
        limb[j] += (val << sh) & 0xFFFFFFFF
        if sh:
            limb[j + 1] += val >> (32 - sh)
    assert max(limb) < 2**37
    for j in range(4):
        limb[j + 1] += limb[j] >> 32
        limb[j] &= 0xFFFFFFFF
    w0 = limb[0] | limb[1] << 32
    w1 = limb[2] | limb[3] << 32
    assert limb[4] < 2**30
    return (_reduce128(w1, w0) - (limb[4] << 32)) % Q


def tc_model(x, wt, R, C):
    """y = M x (mod q) by the kernel's tiling: x uint64 [C, M], wt the
    int8 [DIGITS, Rp, Cp] table -> uint64 [R, M]."""
    M = x.shape[1]
    _, Rp, Cp = wt.shape
    assert Rp % BR == 0 and Cp % KC == 0 and Rp >= R and Cp >= C
    planes = wt.view(np.uint8)
    out = np.zeros((R, M), dtype=np.uint64)
    # warp w = wr * WARPS_M + wm; lane (g, t)
    wr = np.arange(8) // WARPS_M
    wm = np.arange(8) % WARPS_M
    for r0 in range(0, Rp, BR):
        for m0 in range(0, M, BM):
            acc = np.zeros((8, MT, NBUCKETS, 32, 4), dtype=np.int64)
            for c0 in range(0, Cp, KC):
                # the chunk's weight buffer: Wsm[k][row][word]
                wsm = np.ascontiguousarray(
                    planes[:, r0:r0 + BR, c0:c0 + KC]).view(np.uint32)
                # the chunk's x words (rows past C, columns past M read
                # 0) and digit buffer Dsm[l][xq][xm]
                xv = np.zeros((KQ, BM, 4), dtype=np.uint64)
                for q in range(KQ):
                    for i in range(4):
                        c = c0 + 4 * q + i
                        if c < C:
                            n = min(BM, M - m0)
                            xv[q, :n, i] = x[c, m0:m0 + n]
                dsm = _digit_words(xv)
                # B fragments of digit l: Dsm[l][t (+4)][8 wm + g]
                b = np.stack([dsm[:, _T, wm[w] * 8 + _G] for w in range(8)])
                b = np.stack([b, np.stack(
                    [dsm[:, _T + 4, wm[w] * 8 + _G] for w in range(8)])], -1)
                # A fragments of plane k, m16 tile mt: rows 32 wr + 16 mt +
                # g (+8), words t (+4)
                rows = (32 * wr[:, None, None] + 16 * np.arange(MT)[None, :,
                                                                    None]
                        + _G[None, None, :])
                a = np.stack([wsm[:, rows, _T], wsm[:, rows + 8, _T],
                              wsm[:, rows, _T + 4],
                              wsm[:, rows + 8, _T + 4]], -1)
                a = a.transpose(1, 2, 0, 3, 4)    # [warp, mt, k, lane, 4]
                # [warp, mt, k, l, 16, 8]: the 100 products a tile
                d = _mma(a[:, :, :, None], b[:, None, None])
                for k in range(DIGITS):
                    for l in range(DIGITS):
                        acc[:, :, k + l] += d[:, :, k, l][..., C_ROW, C_COL]
                assert acc.max() < 2**31
            for w in range(8):
                for mt in range(MT):
                    for lane in range(32):
                        for i in range(4):
                            r = (r0 + 32 * wr[w] + 16 * mt + C_ROW[lane, i])
                            m = m0 + 8 * wm[w] + C_COL[lane, i]
                            if r < R and m < M:
                                out[r, m] = _fold(acc[w, mt, :, lane, i])
    return out


def _matrix(rng, R, C):
    m = [[rng.randrange(Q) for _ in range(C)] for _ in range(R)]
    m[0] = [(1 << 63) - 1] * C      # every digit 127 but the top one
    return m


def _data(rng, C, M):
    """u64 [C, M]: columns 2^64 - 1, q - 1, 0 and 1 first."""
    x = np.array([[rng.randrange(Q) for _ in range(M)] for _ in range(C)],
                 dtype=np.uint64)
    for j, v in enumerate([2**64 - 1, Q - 1, 0, 1][:M]):
        x[:, j] = v
    return x


def test_tc_weights_layout():
    """Plane k of the table is digit k of M, zero-padded to 64 rows and
    32 columns; the wrapper's [R, C, 16] bytes are its source."""
    rng = random.Random(1)
    for R, C in ((1, 1), (5, 33), (64, 32), (65, 100)):
        f = MF.MxuModMatFused(_matrix(rng, R, C), device="cpu")
        wt = f.wt.numpy()
        assert wt.shape == (DIGITS, -(-R // 64) * 64, -(-C // 32) * 32)
        assert np.array_equal(wt[:, :R, :C], f.planes)
        assert not wt[:, R:].any() and not wt[:, :, C:].any()
        assert torch.equal(MF.tc_weights(f.w), f.wt)


def test_digit_words_pack_the_digits():
    """A digit word holds digit l of rows 4q .. 4q+3 at bytes 0 .. 3."""
    rng = np.random.default_rng(2)
    xv = rng.integers(0, 2**64, (50, 4), dtype=np.uint64)
    xv[0] = [2**64 - 1, Q - 1, 0, 1]
    words = _digit_words(xv)
    for l in range(DIGITS):
        for i in range(4):
            got = (words[l] >> np.uint32(8 * i)) & np.uint32(0xFF)
            want = (xv[:, i] >> np.uint64(7 * l)) & np.uint64(127)
            assert np.array_equal(got.astype(np.uint64), want)


@pytest.mark.parametrize("R,C,M", [(1, 1, 1), (5, 9, 13), (70, 40, 33),
                                   (64, 64, 64), (3, 97, 70)])
def test_model_matches_twin(R, C, M):
    rng = random.Random(R * 1000 + C * 10 + M)
    m = _matrix(rng, R, C)
    x = _data(rng, C, M)
    f = MF.MxuModMatFused(m, device="cpu")
    want = MF.mxu_mod_mat_ref(to_torch(x, "cpu"), f.w)
    assert np.array_equal(tc_model(x, f.wt.numpy(), R, C),
                          to_numpy_u64(want))


def test_model_at_bucket_bound():
    """C at check_bound's limit (the largest int32 buckets the bound
    allows), every weight digit 127 in row 0, every data digit 127 in
    column 0, at a small M; against Python ints."""
    C = 13314
    check_bound(C)
    with pytest.raises(ValueError):
        check_bound(C + 1)
    rng = random.Random(13314)
    allx = sum(127 << (7 * k) for k in range(10)) % (1 << 64)
    m = [[(1 << 63) - 1] * C, [rng.randrange(Q) for _ in range(C)]]
    x = np.array([[allx, Q - 1, 0, rng.randrange(Q)] for _ in range(C)],
                 dtype=np.uint64)
    f = MF.MxuModMatFused(m, device="cpu")
    got = tc_model(x, f.wt.numpy(), 2, C)
    want = [[sum(int(v) % Q * int(u) for v, u in zip(row, x[:, j])) % Q
             for j in range(x.shape[1])] for row in m]
    assert np.array_equal(got, np.array(want, dtype=np.uint64))


@pytest.mark.parametrize("R,C,M", [(4, 70, 35), (3, 40, 7)])
def test_model_matches_pallas_interpret(R, C, M):
    rng = random.Random(R + C + M)
    m = _matrix(rng, R, C)
    x = _data(rng, C, M)
    pk = MxuModMatPallas(m, tile=128, interpret=True, stacked=False)
    want = np.asarray(pk.apply(jax.device_put(x)))
    f = MF.MxuModMatFused(m, device="cpu")
    assert np.array_equal(tc_model(x, f.wt.numpy(), R, C), want)


def test_wrapper_takes_the_plane_table():
    """On CPU tensors the wrapper runs the twin whatever ``wt`` is; the
    table's shape is checked only where the kernel reads it."""
    f = MF.MxuModMatFused([[1, 2], [3, 4]], device="cpu")
    x = torch.tensor([[5, 6], [7, 8]], dtype=torch.int64)
    assert torch.equal(MF.mxu_mod_mat(x, f.w, f.wt), MF.mxu_mod_mat(x, f.w))
    assert torch.equal(f.apply(x), torch.tensor([[19, 22], [43, 50]]))
    assert MF.LAUNCHES == {"mxu_mod_mat": 0}
