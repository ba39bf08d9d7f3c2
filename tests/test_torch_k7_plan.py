"""K7's launch plan (``mle/sumcheck_kernel.py``: ``plan``) against
hand-worked cases: the chunks of claims, the grid phases and the blocks
of each round before the one-block tail, the round where the tail
begins, the partial rows a claim and the launches a chunk.  Pure
Python; no kernel runs."""

import pytest

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


@pytest.mark.parametrize("nv,k,blocks", [
    (1, 9, (1,)), (12, 9, (8, 4, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1)),
    (20, 24, (1024, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2) + (1,) * 9),
])
def test_plan_wide(nv, k, blocks):
    """Beyond 8 tables: no tail and no phase, a round kernel per round
    and a reduction, nv + 1 launches a chunk."""
    p = SK.plan(nv, k, 8)
    assert p.tail is None and p.phases == () and p.blocks == blocks
    assert p.rows == sum(blocks) and p.launches == nv + 1


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
