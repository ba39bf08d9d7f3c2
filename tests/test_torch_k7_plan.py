"""K7's launch plan (``mle/sumcheck_kernel.py``: ``plan``) against
hand-worked cases: the chunks of claims, the grid phases and the blocks
of each round before the one-block tail, the round where the tail
begins, the partial rows a claim and the launches a chunk, up to 8
tables and beyond.  A CPU model of the wide kernel's schedule (k > 8:
its grid rounds' blocks, entries and groups of sums, the partial rows,
the tail and the reduction of the partials) is held against the generic
prover.  No kernel runs."""

import numpy as np
import pytest
import torch

from stark_rings_tpu_torch.mle import sumcheck_kernel as SK


@pytest.mark.parametrize("nv,k,word,tail", [
    # 8-byte words (Goldilocks, frog): k <= 2 tables of 2*1024 words fit
    # 32 KB, k = 3, 4 tables of 2*512, k = 5 .. 8 of 2*256
    (20, 1, 8, 9), (20, 2, 8, 9), (20, 3, 8, 10), (20, 4, 8, 10),
    (20, 5, 8, 11), (20, 8, 8, 11),
    # 4-byte words (BabyBear): k <= 4 at 1024, k = 5 .. 8 at 512
    (20, 2, 4, 9), (20, 4, 4, 9), (20, 5, 4, 10), (20, 8, 4, 10),
    # the tail takes the whole proof while half0 <= the tail's half
    (1, 1, 8, 0), (2, 8, 8, 0), (11, 2, 8, 0), (9, 8, 8, 0), (11, 4, 4, 0),
    # and begins after one grid round one variable later
    (12, 2, 8, 1), (10, 8, 8, 1), (12, 4, 4, 1),
    (24, 2, 8, 13),
])
def test_plan_tail(nv, k, word, tail):
    p = SK.plan(nv, k, word)
    assert p.tail == tail and len(p.blocks) == tail
    assert sum(n for _, n in p.phases) == tail
    assert p.launches == 1 and p.chunks == ((0, 1),)
    assert p.rows == sum(p.blocks)


@pytest.mark.parametrize("k,word,rounds", [
    # 2^m entries of each of k tables in 128 bytes a thread, m <= 4
    (1, 8, 4), (2, 8, 3), (3, 8, 2), (4, 8, 2), (5, 8, 1), (8, 8, 1),
    (1, 4, 4), (2, 4, 4), (3, 4, 3), (4, 4, 3), (5, 4, 2), (8, 4, 2),
])
def test_plan_phase_rounds(k, word, rounds):
    """nv = 24 has 11 to 13 grid rounds: every phase but the last takes
    the phase's full rounds."""
    p = SK.plan(24, k, word)
    assert all(n == rounds for _, n in p.phases[:-1])
    assert 1 <= p.phases[-1][1] <= rounds
    assert [i for i, _ in p.phases] == list(range(0, p.tail, rounds))


def test_plan_main_path():
    """nv = 20, k = 2 Goldilocks: rounds 0-8 in 3 phases of 3 (3 grid
    barriers); a phase's rounds take the blocks of its last round's half
    (2^17, 2^14, 2^11 entries: 512, 64, 8 blocks of 256 threads); 1,752
    partial rows; the tail from half = 1024 (round 9); one launch."""
    p = SK.plan(20, 2, 8)
    assert p == SK.Plan(((0, 1),), 9, ((0, 3), (3, 3), (6, 3)),
                        (512,) * 3 + (64,) * 3 + (8,) * 3, 1752, 1)
    assert SK.plan(20, 2, 8, 4) == p._replace(chunks=((0, 4),))


@pytest.mark.parametrize("nv,k,word,phases,blocks", [
    # BabyBear k = 2: phases of 4 rounds, the last cut at the tail
    (20, 2, 4, ((0, 4), (4, 4), (8, 1)), (256,) * 4 + (16,) * 4 + (8,)),
    # Goldilocks k = 3: phases of 2, the tail at round 10
    (20, 3, 8, ((0, 2), (2, 2), (4, 2), (6, 2), (8, 2)),
     (1024,) * 2 + (256,) * 2 + (64,) * 2 + (16,) * 2 + (4,) * 2),
    # Goldilocks k = 8: one round a phase, as many blocks as the round
    (20, 8, 8, tuple((i, 1) for i in range(11)),
     (1024, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)),
    # nv = 24: the first phases cap at 1024 blocks
    (24, 2, 8, ((0, 3), (3, 3), (6, 3), (9, 3), (12, 1)),
     (1024,) * 6 + (128,) * 3 + (16,) * 3 + (8,)),
    (12, 2, 8, ((0, 1),), (8,)),
    (11, 2, 8, (), ()),
])
def test_plan_phases(nv, k, word, phases, blocks):
    p = SK.plan(nv, k, word)
    assert p.phases == phases and p.blocks == blocks
    assert p.rows == sum(blocks)


@pytest.mark.parametrize("W,chunks", [
    (1, ((0, 1),)), (65535, ((0, 65535),)),
    (65536, ((0, 65535), (65535, 1))),
    (131071, ((0, 65535), (65535, 65535), (131070, 1))),
])
def test_plan_chunks(W, chunks):
    p = SK.plan(4, 2, 8, W)
    assert p.chunks == chunks
    assert sum(n for _, n in chunks) == W
    assert p.launches == 1


@pytest.mark.parametrize("nv,k,tail,blocks", [
    (1, 9, 0, ()), (12, 9, 4, (16, 8, 4, 2)),
    (20, 24, 13, (1024,) * 4 + (512, 256, 128, 64, 32, 16, 8, 4, 2)),
])
def test_plan_wide(nv, k, tail, blocks):
    """Beyond 8 tables: one launch a chunk, the tail where k tables of
    2*half words fit 32 KB (half <= 128 for 9 Goldilocks tables, 64 for
    24), one round a grid phase, and blocks of 256 / wide_groups(k)
    entries (128 for k = 9, 64 for k = 24), at most 1024."""
    p = SK.plan(nv, k, 8)
    assert p.tail == tail and p.phases == tuple((i, 1) for i in range(tail))
    assert p.blocks == blocks and p.rows == sum(blocks) and p.launches == 1


@pytest.mark.parametrize("k,groups", [
    (9, 2), (15, 2), (16, 4), (17, 4), (24, 4), (31, 4), (32, 8), (63, 8),
    (64, 16), (127, 16), (128, 32), (255, 32), (256, 32), (1000, 32)])
def test_wide_groups(k, groups):
    """Threads an entry: the groups of 8 of the k + 1 sums, rounded up
    to a power of 2 (so a group's lanes of a warp reduce by shuffles),
    at most 32 (more groups take passes)."""
    assert SK.wide_groups(k) == groups
    assert groups >= min(32, -(-(k + 1) // 8))


@pytest.mark.parametrize("W", [1, 65536])
@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("k", [9, 16, 17, 24])
def test_plan_wide_rules(k, word, W):
    """k > 8 at nv = 1-20: one launch a chunk of at most 65,535 claims;
    the tail's tables fit 32 KB with half <= 1024, every grid round's
    half is more, and one round more would not fit; one round a phase;
    each grid round's blocks take 256 / wide_groups(k) entries."""
    entries = 256 // SK.wide_groups(k)
    for nv in range(1, 21):
        p = SK.plan(nv, k, word, W)
        assert p.launches == 1 and sum(n for _, n in p.chunks) == W
        assert all(n <= 65535 for _, n in p.chunks)
        half0 = 1 << (nv - 1)
        half_t = half0 >> p.tail
        assert 2 * half_t * k * word <= 32 * 1024 and half_t <= 1024
        if p.tail:
            assert 4 * half_t * k * word > 32 * 1024 or half_t == 1024
        assert all(half0 >> i > half_t for i in range(p.tail))
        assert p.phases == tuple((i, 1) for i in range(p.tail))
        assert p.blocks == tuple(min(1024, -(-(half0 >> i) // entries))
                                 for i in range(p.tail))
        assert p.rows == sum(p.blocks)


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("k", range(1, 9))
def test_plan_tail_fits(k, word):
    """At every nv the tail's tables fit 32 KB of shared memory, its
    first half is at most 1024, every grid round's half is more, and a
    phase's entries fit 128 bytes a thread (or it takes one round)."""
    for nv in range(1, 31):
        p = SK.plan(nv, k, word)
        half_t = 1 << (nv - 1 - p.tail)
        assert 2 * half_t * k * word <= 32 * 1024 and half_t <= 1024
        assert all((1 << (nv - 1 - i)) > half_t for i in range(p.tail))
        if p.tail:
            assert 2 * 2 * half_t * k * word > 32 * 1024 or half_t == 1024
        for _, n in p.phases:
            assert n == 1 or (1 << n) * k * word <= 128


@pytest.mark.parametrize("args", [(0, 2, 8), (4, 0, 8), (4, 2, 8, 0)])
def test_plan_rejects_empty(args):
    with pytest.raises(ValueError):
        SK.plan(*args)


# -- a CPU model of the wide kernel's schedule (k > 8) ------------------------


def _fsum(f, x):
    """Field sum of x along its last axis (pairwise)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, f.zeros(x.shape[:-1] + (1,), "cpu")], -1)
        x = f.add(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def _terms(f, tabs, h, k):
    """[k + 1, h]: prod_j (lo_j + t d_j) for t = 0 .. k at every entry."""
    lo = torch.stack([T[:h] for T in tabs])
    d = f.sub(torch.stack([T[h:2 * h] for T in tabs]), lo)
    out, cur = [], lo
    for t in range(k + 1):
        if t:
            cur = f.add(cur, d)
        p = cur[0]
        for j in range(1, k):
            p = f.mul(p, cur[j])
        out.append(p)
    return torch.stack(out), lo, d


def wide_model(f, tables, chal, word):
    """sumcheck_wide_kernel's schedule on the CPU: grid round i's block b
    takes entries b*E + e + n*nb*E (E = 256 / wide_groups(k)), its
    thread (e, gl) in pass g0 the sums 8*(g0 + gl) .. + 7, written to
    partial row rows(i) + b; the tail rounds' sums go to the messages;
    the grid rounds' messages are the sums of their partial rows."""
    k, nv = len(tables), len(chal)
    p = SK.plan(nv, k, word)
    GP = SK.wide_groups(k)
    E = 256 // GP
    half0 = 1 << (nv - 1)
    tabs = [T.clone() for T in tables]
    partials = f.zeros((p.rows, k + 1), "cpu")
    written = torch.zeros((p.rows, k + 1), dtype=torch.int64)
    msgs = f.zeros((nv, k + 1), "cpu")
    row0 = 0
    for i in range(nv):
        h = half0 >> i
        terms, lo, d = _terms(f, tabs, h, k)
        if i < p.tail:
            nb = p.blocks[i]
            seen = torch.zeros(h, dtype=torch.int64)
            for b in range(nb):
                ys = torch.tensor([y for e in range(E)
                                   for y in range(b * E + e, h, nb * E)],
                                  dtype=torch.int64)
                seen[ys] += 1
                for g0 in range(0, -(-(k + 1) // 8), GP):
                    for gl in range(GP):
                        for u in range(8):
                            t = 8 * (g0 + gl) + u
                            if t <= k and len(ys):
                                partials[row0 + b, t] = _fsum(f,
                                                              terms[t, ys])
                            if t <= k:
                                written[row0 + b, t] += 1
            assert torch.equal(seen, torch.ones(h, dtype=torch.int64))
            row0 += nb
        else:
            msgs[i] = _fsum(f, terms)
        tabs = list(f.add(lo, f.mul(chal[i].expand(h), d)))
    assert row0 == p.rows and torch.equal(written, torch.ones_like(written))
    for i in range(p.tail):
        r = sum(p.blocks[:i])
        msgs[i] = _fsum(f, partials[r:r + p.blocks[i]].t())
    return msgs, [T[0] for T in tabs]


@pytest.mark.parametrize("field,word", [("goldilocks", 8), ("babybear", 4)])
@pytest.mark.parametrize("nv", [1, 4, 9, 10])
@pytest.mark.parametrize("k", [9, 17])
def test_wide_model_matches_generic_prover(k, nv, field, word):
    from stark_rings_tpu_torch.fields.field import get_field

    f = get_field(field)
    rng = np.random.default_rng(100 * k + nv)
    tables = [f.rand((1 << nv,), rng, "cpu") for _ in range(k)]
    chal = f.rand((nv,), rng, "cpu")
    msgs, finals = wide_model(f, tables, chal, word)
    want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal, field)
    assert torch.equal(msgs, want_m)
    assert all(torch.equal(a, b) for a, b in zip(finals, want_f))


def test_wide_model_with_entries_past_the_block_cap(monkeypatch):
    """With the blocks of a round capped at 2 (1024 on the card), a
    thread takes several entries of a round, nb*E apart."""
    from stark_rings_tpu_torch.fields.field import get_field

    monkeypatch.setattr(SK, "_MAX_BLOCKS", 2)
    SK.plan.cache_clear()
    try:
        f = get_field("goldilocks")
        rng = np.random.default_rng(2)
        tables = [f.rand((1 << 10,), rng, "cpu") for _ in range(9)]
        chal = f.rand((10,), rng, "cpu")
        assert SK.plan(10, 9, 8).blocks == (2, 2)
        msgs, finals = wide_model(f, tables, chal, 8)
        want_m, want_f = SK.sumcheck_prove_many_ref(tables, chal)
        assert torch.equal(msgs, want_m)
        assert all(torch.equal(a, b) for a, b in zip(finals, want_f))
    finally:
        SK.plan.cache_clear()
