"""K5's and K6's launch plans (``mle/fix.py``: ``eval_plan``,
``fix_plan``) and CPU models of the kernels' binding orders.

The plans: one launch for every nv and every legal k, the levels and
blocks of K5, K6's kernel, tiles, chunks and j's, the tickets and
partials in the work buffer, and shared memory within a block's 227 KB.

The models replay ``csrc/mle.cu`` in torch on CPU tensors, step for
step: K5's registers (16-byte loads, then the words' top bits; 16 words
a thread, and 8 a thread, the variant it was chosen over), lane
shuffles, the warps' step and the ticket levels; K6's register tree
(k <= 5) and, for k > 5, its eq weights (the chunk's high-bit factor
times the in-chunk factors), 128-bit row sums, row adds and chunk
partials.  They must be bit-equal to the twins at nv = 1 ... 14 on
tables of zeros, of q-1 and of random words, and to the Pallas kernels
in interpret mode at nv = 9 and 11.  Nothing here needs a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.mle.pallas_fix import (evaluate_goldilocks_pallas,
                                            fix_last_goldilocks_pallas)
from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.fields.field import u64_lt
from stark_rings_tpu_torch.mle import fix as FX

Q = F.q
SMEM = 232_448          # bytes of shared memory a block can use (227 KB)
KINDS = ("zeros", "q-1", "random")


def _table(rng, nv, kind):
    n = 1 << nv
    if kind == "zeros":
        x = np.zeros(n, dtype=np.uint64)
    elif kind == "q-1":
        x = np.full(n, Q - 1, dtype=np.uint64)
    else:
        x = rng.integers(0, Q, n, dtype=np.uint64)
    return to_torch(x, "cpu")


def _points(rng, n):
    return to_torch(rng.integers(0, Q, n, dtype=np.uint64), "cpu")


def _lerp(lo, hi, r):
    return F.add(lo, F.mul(r, F.sub(hi, lo)))


# -- the plans ---------------------------------------------------------------


@pytest.mark.parametrize("nv", range(1, 31))
def test_eval_plan(nv):
    """Level 0 binds min(nv, 12) variables in 2^(nv - 12) blocks, each
    later level up to 12; one ticket a group of every later level, the
    values of every level but the last as partials."""
    p = FX.eval_plan(nv)
    assert p.launches == 1 and sum(p.levels) == nv
    assert p.levels[0] == min(nv, 12) and all(1 <= b <= 12
                                              for b in p.levels)
    assert all(b == 12 for b in p.levels[:-1])
    assert p.blocks == 1 << (nv - p.levels[0]) and p.blocks < 2**31
    done, tickets, partials = p.levels[0], 0, 0
    for b in p.levels[1:]:
        partials += 1 << (nv - done)
        tickets += 1 << (nv - done - b)
        done += b
    assert (p.tickets, p.partials) == (tickets, partials)
    assert p.smem <= SMEM


def test_eval_plan_main_path():
    """nv = 20: 256 blocks of 2^12 words and one ticket whose last
    block binds the 2^8 partials; nv = 24: 4,096 blocks and one group of
    2^12 partials; nv = 25: two ticket levels."""
    assert FX.eval_plan(20) == FX.EvalPlan((12, 8), 256, 1, 256, 68)
    assert FX.eval_plan(24) == FX.EvalPlan((12, 12), 4096, 1, 4096, 68)
    assert FX.eval_plan(25) == FX.EvalPlan((12, 12, 1), 8192, 3, 8194, 68)
    with pytest.raises(ValueError):
        FX.eval_plan(0)
    with pytest.raises(ValueError):
        FX.eval_plan(FX.MAX_POINTS + 1)


@pytest.mark.parametrize("nv", range(9, 31))
def test_fix_plan(nv):
    """Every legal k: one launch; k <= 5 on the tree kernel, one thread
    an output; beyond, tiles of 128 outputs times chunks of 4J j's cover
    the 2^k j's once, J within [8, 256], and chunks only as far as the
    rules allow."""
    for k in range(1, nv - 6):
        p = FX.fix_plan(nv, k)
        M = 1 << (nv - k)
        assert p.launches == 1 and p.smem <= SMEM
        if k <= 5:
            assert p.kernel == "tree" and p.blocks * 256 >= M > (
                p.blocks - 1) * 256
            assert (p.tickets, p.partials) == (0, 0)
            continue
        assert p.kernel == "eq"
        assert p.tiles * 128 == M and p.blocks == p.tiles * p.chunks
        assert p.chunks * 4 * p.j_row == 1 << k
        assert 8 <= p.j_row <= 256
        assert p.blocks < 2**31
        if p.chunks > 1:
            grown = p.j_row * 2 > 256 or (p.blocks // 2 < 256
                                          and p.chunks // 2 < 128)
            assert grown, (nv, k)
            assert (p.tickets, p.partials) == (p.tiles, p.chunks * M)
        else:
            assert (p.tickets, p.partials) == (0, 0)


def test_fix_plan_main_path():
    """nv = 20: k = 7 in 64 tiles x 4 chunks of J = 8; k = 13 in one
    tile x 128 chunks of J = 16; nv = 24, k = 17 at the J cap."""
    p7, p13 = FX.fix_plan(20, 7), FX.fix_plan(20, 13)
    assert (p7.tiles, p7.chunks, p7.j_row, p7.blocks) == (64, 4, 8, 256)
    assert (p13.tiles, p13.chunks, p13.j_row, p13.blocks) == (1, 128, 16,
                                                              128)
    p = FX.fix_plan(24, 17)
    assert (p.tiles, p.chunks, p.j_row) == (1, 128, 256)
    assert FX.fix_plan(20, 1).kernel == "tree"
    with pytest.raises(ValueError, match="k <= nv - 7"):
        FX.fix_plan(20, 14)


# -- K5's model --------------------------------------------------------------


def _shuffle_bind(v, s, r):
    """Every lane binds the pair (lane, lane ^ 2^s): lerp_lanes over the
    last axis of ``v`` (32 lanes)."""
    lane = torch.arange(32)
    o = v[..., lane ^ (1 << s)]
    odd = (lane >> s) & 1 == 1
    return _lerp(torch.where(odd, o, v), torch.where(odd, v, o), r)


def _eval_block(src, n, pts, off, vw, bits):
    """eval_block<vw> with 2^bits words a block on each row of ``src``
    [G, 2^n]: thread 0's value a row."""
    G, lv = src.shape[0], vw // 2
    x = torch.zeros((G, 1 << bits), dtype=torch.int64)
    x[:, :1 << n] = src
    # index v + vw*(lane + 32*(warp + 8*u))
    x = x.reshape(G, (1 << (bits - 8)) // vw, 8, 32, vw)
    if vw == 2:
        x = _lerp(x[..., 0], x[..., 1], pts[off])
    else:
        x = x[..., 0]
    for s in range(bits - 8 - lv):            # u's bits, pairs (2c, 2c+1)
        b = lv + 8 + s
        x = _lerp(x[:, 0::2], x[:, 1::2], pts[off + b]) if b < n \
            else x[:, 0::2]
    v = x[:, 0]                               # [G, warps, lanes]
    for s in range(5):
        if lv + s < n:
            v = _shuffle_bind(v, s, pts[off + lv + s])
    w = torch.zeros((G, 32), dtype=torch.int64)
    w[:, :8] = v[:, :, 0]                     # lane 0 of each warp
    for s in range(3):
        if lv + 5 + s < n:
            w = _shuffle_bind(w, s, pts[off + lv + 5 + s])
    return w[:, 0]


def _levels(nv, bits):
    """The variables each level binds with 2^bits words a block
    (``eval_layout``): min(nv, bits) in level 0, up to bits in each
    later one."""
    levels = [min(nv, bits)]
    while sum(levels) < nv:
        levels.append(min(nv - sum(levels), bits))
    return levels


def model_evaluate(T, pts, vw=2, bits=12):
    """mle_eval_kernel<vw>: level 0's blocks, then the ticket levels."""
    nv = T.shape[0].bit_length() - 1
    vals, done = T, 0
    for b in _levels(nv, bits):
        vals = _eval_block(vals.reshape(-1, 1 << b), b, pts, done, vw, bits)
        done += b
    assert vals.shape == (1,)
    return vals[0]


@pytest.mark.parametrize("nv", range(1, 15))
def test_eval_model_matches_twin(nv):
    rng = np.random.default_rng(100 + nv)
    pts = _points(rng, nv)
    for kind in KINDS:
        T = _table(rng, nv, kind)
        want = FX.evaluate_goldilocks_ref(T, pts)
        for vw in (2, 1):
            for bits in (12, 11):      # the kept tile and the 8-word one
                assert torch.equal(model_evaluate(T, pts, vw, bits),
                                   want), (kind, vw, bits)


# -- K6's model --------------------------------------------------------------


def _sum128(p, dim):
    """Sum of canonical words along ``dim`` as a 128-bit (hi, lo), as the
    kernel's Acc2 adds them, reduced to a canonical word (reduce128)."""
    lo = torch.zeros_like(p.select(dim, 0))
    hi = torch.zeros_like(lo)
    for a in p.unbind(dim):
        lo = lo + a                           # wraps as the u64 add
        hi = hi + u64_lt(lo, a).to(torch.int64)
    return F._reduce128(hi, lo)


def _rows_add(x):
    """Thread x < 128 adds its output's rows 0, 1, 2, 3 in turn."""
    s = x[..., 0, :]
    for y in range(1, x.shape[-2]):
        s = F.add(s, x[..., y, :])
    return s


def model_fix_tree(T, pts):
    """mle_fix_tree_kernel<k>: the top bit of j splits first."""
    k = len(pts)
    M = T.shape[0] >> k

    def tree(S, base):
        if S == 0:
            return T[base * M:(base + 1) * M]
        return _lerp(tree(S - 1, base), tree(S - 1, base + (1 << (S - 1))),
                     pts[S - 1])

    return tree(k, 0)


def model_fix_eq(T, pts):
    """mle_fix_eq_kernel: eq weights a chunk, row sums, chunk partials."""
    nv, k = T.shape[0].bit_length() - 1, len(pts)
    plan = FX.fix_plan(nv, k)
    M, C, J = 1 << (nv - k), plan.chunks, plan.j_row
    lb = (4 * J).bit_length() - 1
    one = torch.ones((), dtype=torch.int64)
    fac = [(F.sub(one, pts[s]), pts[s]) for s in range(k)]
    c = torch.arange(C)
    hi = torch.ones(C, dtype=torch.int64)
    for s in range(lb, k):
        hi = F.mul(hi, torch.where(((c << lb) >> s) & 1 == 1, fac[s][1],
                                   fac[s][0]))
    e = torch.arange(4 * J)
    w = hi[:, None].expand(C, 4 * J)
    for s in range(lb):
        w = F.mul(w, torch.where((e >> s) & 1 == 1, fac[s][1], fac[s][0]))
    X = T.reshape(C, 4, J, M)                 # j = c*4J + y*J + u
    rows = _sum128(F.mul(w.reshape(C, 4, J, 1), X), 2)      # [C, 4, M]
    parts = _rows_add(rows)                   # [C, M]
    if C == 1:
        return parts[0]
    # the last block: row y adds chunks y, y + 4, ...
    fin = torch.stack([_sum128(parts[y::4], 0) if y < C
                       else torch.zeros(M, dtype=torch.int64)
                       for y in range(4)])
    return _rows_add(fin)


def model_fix(T, pts):
    return (model_fix_tree if len(pts) <= 5 else model_fix_eq)(T, pts)


@pytest.mark.parametrize("nv", range(9, 15))
def test_fix_model_matches_twin(nv):
    rng = np.random.default_rng(200 + nv)
    for kind in KINDS:
        T = _table(rng, nv, kind)
        for k in range(1, nv - 6):
            pts = _points(rng, k)
            assert torch.equal(model_fix(T, pts),
                               FX.fix_last_goldilocks_ref(T, pts)), (kind, k)


def test_fix_model_partials_near_the_carry():
    """Many chunks of q-1 products: the 128-bit sums carry out of the
    low word in every row and chunk add (nv = 16, k = 9: 4 chunks of
    J = 32 over 2 tiles; the points q-1 make every weight +-1)."""
    T = to_torch(np.full(1 << 16, Q - 1, dtype=np.uint64), "cpu")
    pts = to_torch(np.full(9, Q - 1, dtype=np.uint64), "cpu")
    p = FX.fix_plan(16, 9)
    assert p.chunks > 1
    assert torch.equal(model_fix_eq(T, pts), FX.fix_last_goldilocks_ref(T,
                                                                        pts))


# -- against the Pallas kernels in interpret mode ----------------------------


@pytest.mark.parametrize("nv", [9, 11])
def test_models_match_pallas_kernels(nv):
    rng = np.random.default_rng(300 + nv)
    ev = rng.integers(0, Q, 1 << nv, dtype=np.uint64)
    pts = rng.integers(0, Q, nv, dtype=np.uint64)
    T, P = to_torch(ev, "cpu"), to_torch(pts, "cpu")
    want = int(evaluate_goldilocks_pallas(
        jnp.asarray(ev), [np.uint64(p) for p in pts], interpret=True))
    assert int(to_numpy_u64(model_evaluate(T, P))) == want
    for k in (1, nv - 7 - (nv == 11), nv - 7):
        if k <= 0:
            continue
        want = np.asarray(fix_last_goldilocks_pallas(
            jnp.asarray(ev), [np.uint64(p) for p in pts[:k]],
            interpret=True))
        assert np.array_equal(to_numpy_u64(model_fix(T, P[:k])), want), k


# -- the point table ---------------------------------------------------------


def test_point_table_packs_addresses_and_values():
    """A CPU tensor and python ints go in as words (u64, so -1 is
    2^64 - 1); the table is MAX_POINTS wide at most."""
    dev = torch.device("cpu")
    ptrs, vals = FX._point_table("t", [3, -1, torch.tensor(7)], dev)
    assert ptrs == bytes(24)
    assert np.frombuffer(vals, dtype=np.uint64).tolist() == [3, 2**64 - 1,
                                                             7]
    with pytest.raises(ValueError, match="at most"):
        FX._point_table("t", [0] * (FX.MAX_POINTS + 1), dev)
