"""The BabyBear slot-product kernels' CPU side (``ops/slot_bb.py``): the
routing predicate (BabyBear, E = 9, storage order [0, 3, 6, 1, 4, 7, 2,
5, 8], a CUDA device) beside the Goldilocks one, and ``TModelMul``'s
route; the wrappers' input checks, which raise before any launch; the
twins ``bb_slot_mul_ref`` / ``bb_slot_matvec_ref`` (the CPU path of
``bb_slot_mul`` / ``bb_slot_matvec``) against the reference's
``ntt_mul_bt`` / ``matvec_t`` and the integer spec, blocked and
unblocked; a Python-int model of the kernels' arithmetic (81 products of
u32 words, four at a time into a u64, into 17 exact 96-bit degree sums,
folded once) at the operands' extremes and at the longest chunk the plan
allows; a model of ``bb_slot_matvec_kernel``'s chunks and tiles from
``slot.matvec_plan`` at E = 9; and the rooflines read from the wrappers' launch
arguments.  The kernels themselves are held to the twins on the card in
``test_torch_cuda.py``."""

import pathlib
import types

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.ops.model_mul import TModelMul as RefTModelMul
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import BABYBEAR, from_jax_storage
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops import slot as S
from stark_rings_tpu_torch.ops import slot_bb as SB
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.rings import get_ring

Q = BABYBEAR.q
RING = get_ring("babybear", device="cpu")
T = S.ext_tables(RING)
NR = T.nr
N, E, D = 8, 9, 72
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
R2 = (1 << 64) % Q                      # csrc/slot_bb.cu's R2


def _words(rng, shape, fill=None):
    x = (np.full(shape, fill, dtype=np.uint32) if fill is not None
         else rng.integers(0, Q, shape, dtype=np.uint32))
    return x, from_jax_storage(BABYBEAR, x, "cpu")


def _u32(t):
    return t.contiguous().numpy().view(np.uint32)


def _plan(N, n, W, m):
    """``bb_slot_matvec``'s launch: the slot mat-vec plan at E = 9 with
    u32 partials."""
    return S.matvec_plan(N, n, W, m, E, partial_bytes=4)


@pytest.fixture(scope="module")
def ref():
    return RefTModelMul(ref_ring("babybear"))


# -- routing -----------------------------------------------------------


@pytest.mark.parametrize("device,want", [("cuda", True), ("cuda:0", True),
                                         ("cpu", False), ("meta", False)])
@pytest.mark.parametrize("perm", [SB.PERM9, list(range(9)),
                                  [0, 3, 6, 1, 4, 7, 2, 8, 5]])
def test_predicate_babybear(device, want, perm):
    """The predicate reads the field, E and the permutation; the device
    is ``TModelMul.uses_bb_slot_kernel``'s own test.  The Goldilocks
    predicate stays false for BabyBear."""
    assert SB.bb_slot_kernel_applies(BABYBEAR, 9, perm) == (perm == SB.PERM9)
    assert not S.slot_kernel_applies(BABYBEAR, 9, perm)
    tm = TModelMul(RING)
    assert tm.uses_bb_slot_kernel(device) == want
    assert not tm.uses_slot_kernel(device)


@pytest.mark.parametrize("name", ["goldilocks", "frog", "stark_prime"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_predicate_other_models(name, device):
    """Goldilocks keeps its own kernels (on CUDA), frog and stark_prime
    the torch ops; none of them takes the BabyBear kernels."""
    ring = get_ring(name, device="cpu")
    perm = list(ring.spec.storage_perm)
    assert not SB.bb_slot_kernel_applies(ring.field, ring.E, perm)
    # the BabyBear field with another E, or E = 9 over another field
    assert not SB.bb_slot_kernel_applies(BABYBEAR, ring.E, perm)
    assert not SB.bb_slot_kernel_applies(ring.field, 9, SB.PERM9)
    tm = TModelMul(ring)
    assert not tm.uses_bb_slot_kernel(device)
    assert tm.uses_slot_kernel(device) == (name == "goldilocks"
                                           and device == "cuda")


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_cpu_tensors_launch_nothing(name, monkeypatch):
    """On CPU tensors every model keeps the torch ops, the folding step
    too: no kernel is built or launched, and the counters of both slot
    modules stay at 0."""
    from stark_rings_tpu_torch.protocol import FoldingStep

    def refuse(*args, **kw):
        raise AssertionError("a kernel was asked for on CPU tensors")

    monkeypatch.setattr(_build, "kernels", refuse)
    S.reset_launches()
    SB.reset_launches()
    ring = get_ring(name, device="cpu")
    tm = TModelMul(ring)
    rng = np.random.default_rng(5)
    a, b = (ring.field.rand((ring.D, 6), rng, "cpu") for _ in range(2))
    tm.mul_t(a, b)
    A = ring.field.rand((ring.D, 3, 5), rng, "cpu")
    x = ring.field.rand((ring.D, 2, 5), rng, "cpu")
    tm.matvec_t(A, x)
    tm.matvec_t(A, x, block=2)
    fs = FoldingStep(ring, n_rows=2, wit_len=3)
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    s0, s1 = fs.rand_witness(2, rng), fs.rand_witness(2, rng)
    c0, c1 = (fs.tm.to_t(ring.rand_ntt((2, 2), rng)).contiguous()
              for _ in range(2))
    fs.step(c, s0, s1, c0, c1, rt)
    assert SB.LAUNCHES == {"bb_slot_mul": 0, "bb_slot_matvec": 0}
    assert S.LAUNCHES == {"slot_mul": 0, "slot_matvec": 0}


def test_kernel_route_on_cpu_tensors():
    """``TModelMul``'s kernel route (the broadcast normalisation in front
    of ``bb_slot_mul``, the views in front of ``bb_slot_matvec``), run on
    CPU tensors, where the wrappers answer with their twins, equals the
    torch-op route: products, the batch-1 challenge, and the commit at
    every block."""
    tm, route = TModelMul(RING), TModelMul(RING)
    assert route._slot_pair == (SB.bb_slot_mul, SB.bb_slot_matvec)
    route._kernels = lambda device: route._slot_pair
    assert route.uses_bb_slot_kernel("cpu")
    rng = np.random.default_rng(11)
    f = RING.field
    a, b = (f.rand((D, 3, 5), rng, "cpu") for _ in range(2))
    ch = f.rand((D, 1, 1), rng, "cpu")
    assert torch.equal(route.mul_t(a, b), tm.mul_t(a, b))
    assert torch.equal(route.ntt_mul_bt(a, ch), tm.ntt_mul_bt(a, ch))
    assert torch.equal(route.ntt_mul_bt(ch, a), tm.ntt_mul_bt(a, ch))
    A = f.rand((D, 3, 7), rng, "cpu")
    x = f.rand((D, 4, 7), rng, "cpu")
    want = tm.matvec_t(A, x)
    for block in (None, 1, 3, 7):
        assert torch.equal(route.matvec_t(A, x, block=block), want)
        assert torch.equal(tm.matvec_t(A, x, block=block), want)
    assert torch.equal(route.matvec_t(A, x[:, 0]), want[:, 0])


# -- the wrappers' checks -----------------------------------------------


def _bad_calls():
    rng = np.random.default_rng(1)
    a = _words(rng, (N, E, 6))[1]
    A = _words(rng, (N, E, 4, 5))[1]
    x = _words(rng, (N, E, 2, 5))[1]
    i64 = torch.zeros((N, E, 6), dtype=torch.int64)
    short = T._replace(perm=torch.arange(8), inv_perm=torch.arange(8))
    gl = S.ext_tables(get_ring("goldilocks", device="cpu"))
    return [
        ("mul int64", TypeError, lambda: SB.bb_slot_mul(i64, a, T)),
        ("mul numpy", TypeError, lambda: SB.bb_slot_mul(a.numpy(), a, T)),
        ("mul 2-D", ValueError, lambda: SB.bb_slot_mul(a.reshape(D, 6), a,
                                                       T)),
        ("mul E=3", ValueError, lambda: SB.bb_slot_mul(
            torch.zeros((6, 3, 6), dtype=torch.int32),
            torch.zeros((6, 3, 1), dtype=torch.int32), T)),
        ("mul batch", ValueError, lambda: SB.bb_slot_mul(
            a, a[:, :, :2].contiguous(), T)),
        ("mul slots", ValueError, lambda: SB.bb_slot_mul(a, a[:4], T)),
        ("mul strided", ValueError, lambda: SB.bb_slot_mul(
            a[:, :, ::2], a[:, :, :3], T)),
        ("mul nr=q", ValueError, lambda: SB.bb_slot_mul(
            a, a, T._replace(nr=Q))),
        ("mul nr<0", ValueError, lambda: SB.bb_slot_mul(
            a, a, T._replace(nr=-1))),
        ("mul nr float", ValueError, lambda: SB.bb_slot_mul(
            a, a, T._replace(nr=2.0))),
        ("mul perm of 8", ValueError, lambda: SB.bb_slot_mul(a, a, short)),
        ("mul E=3 tables", ValueError, lambda: SB.bb_slot_mul(a, a, gl)),
        ("mul no tables", ValueError, lambda: SB.bb_slot_mul(a, a, NR)),
        ("mul meta", ValueError, lambda: SB.bb_slot_mul(
            a.to("meta"), a.to("meta"), T)),
        ("matvec int64", TypeError, lambda: SB.bb_slot_matvec(
            A.to(torch.int64), x, T)),
        ("matvec 3-D", ValueError, lambda: SB.bb_slot_matvec(
            A.reshape(D, 4, 5), x, T)),
        ("matvec m", ValueError, lambda: SB.bb_slot_matvec(
            A, x[..., :4].contiguous(), T)),
        ("matvec slots", ValueError, lambda: SB.bb_slot_matvec(A[:4], x, T)),
        ("matvec empty", ValueError, lambda: SB.bb_slot_matvec(
            A[:, :, :0], x, T)),
        ("matvec m=0", ValueError, lambda: SB.bb_slot_matvec(
            A[..., :0], x[..., :0], T)),
        ("matvec strided", ValueError, lambda: SB.bb_slot_matvec(
            A.transpose(2, 3).contiguous().transpose(2, 3), x, T)),
        ("matvec nr", ValueError, lambda: SB.bb_slot_matvec(
            A, x, T._replace(nr=Q + 1))),
        ("matvec perm of 8", ValueError, lambda: SB.bb_slot_matvec(
            A, x, short)),
        ("matvec E=4 tables", ValueError, lambda: SB.bb_slot_matvec(
            A, x, S.ext_tables(get_ring("frog", device="cpu")))),
        ("matvec meta", ValueError, lambda: SB.bb_slot_matvec(
            A.to("meta"), x.to("meta"), T)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_checks_raise_before_launch(case, monkeypatch):
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda *args, **kw: launched.append(args))
    monkeypatch.setattr(_build, "kernels", lambda: pytest.fail("built"))
    _, err, call = _bad_calls()[case]
    before = dict(SB.LAUNCHES)
    with pytest.raises(err):
        call()
    assert not launched and SB.LAUNCHES == before


# -- the twins against the reference and the integer spec ----------------


@pytest.mark.parametrize("ba,bb", [((7,), (7,)), ((7,), (1,)),
                                   ((2, 5), (2, 5)), ((2, 5), (1, 1)),
                                   ((128,), (1,)), ((13,), (13,))])
def test_bb_slot_mul_ref_matches_reference(ref, ba, bb):
    rng = np.random.default_rng(sum(ba) + len(bb))
    xa, a = _words(rng, (D,) + ba)
    xb, b = _words(rng, (D,) + bb)
    want = np.asarray(jax.jit(ref.ntt_mul_bt)(xa, xb))
    Ba, Bb = int(np.prod(ba)), int(np.prod(bb))
    got = SB.bb_slot_mul(a.reshape(N, E, Ba), b.reshape(N, E, Bb), T)
    assert got.shape == (D, Ba) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), want.reshape(D, Ba))
    assert torch.equal(got, SB.bb_slot_mul_ref(a.reshape(N, E, Ba),
                                               b.reshape(N, E, Bb), T))


def test_bb_slot_mul_ref_matches_spec():
    """The twin on canonical values against the integer spec's Fq9
    product (``SpecModel.ext_mul``: the permutation, mod Y^9 - nr)."""
    rng = np.random.default_rng(3)
    spec = RING.spec
    va = rng.integers(0, Q, (N, E, 3), dtype=np.int64)
    vb = rng.integers(0, Q, (N, E, 3), dtype=np.int64)
    va[0, :, 0] = vb[0, :, 0] = Q - 1
    a = from_jax_storage(BABYBEAR, BABYBEAR.storage_np(va), "cpu")
    b = from_jax_storage(BABYBEAR, BABYBEAR.storage_np(vb), "cpu")
    got = BABYBEAR.canon(SB.bb_slot_mul_ref(a, b, T)).view(N, E, 3)
    for s in range(N):
        for j in range(3):
            want = spec.ext_mul([int(v) for v in va[s, :, j]],
                                [int(v) for v in vb[s, :, j]])
            assert [int(v) for v in got[s, :, j]] == want


@pytest.mark.parametrize("n,W,m", [(3, 2, 7), (1, 1, 1), (5, 3, 33),
                                   (9, 17, 40)])
@pytest.mark.parametrize("block", [None, 4, 1])
def test_bb_slot_matvec_ref_matches_reference(ref, n, W, m, block):
    rng = np.random.default_rng(n * 100 + W * 10 + m)
    xA, A = _words(rng, (D, n, m))
    xx, x = _words(rng, (D, W, m))
    want = np.asarray(jax.jit(ref.matvec_t)(xA, xx))
    got = SB.bb_slot_matvec(A.reshape(N, E, n, m), x.reshape(N, E, W, m), T)
    assert got.shape == (D, W, n) and got.dtype == torch.int32
    assert np.array_equal(_u32(got), want)
    blocked = SB.bb_slot_matvec_ref(A.reshape(N, E, n, m),
                                    x.reshape(N, E, W, m), T, block=block)
    assert torch.equal(blocked, got)


# -- the kernels' arithmetic, in Python ints ------------------------------


def _redc64(x):
    """``bb::redc64``: (x + m q) / 2^32, one conditional subtract; the u32
    sum must not wrap, and below q 2^32 the result is canonical."""
    lo, hi = x & M32, x >> 32
    m = lo * BABYBEAR.QINV & M32
    t = hi + (m * Q >> 32) + (lo != 0)
    assert t <= M32
    t = t - Q if t >= Q else t
    assert t < Q and t == x * pow(1 << 32, -1, Q) % Q
    return t


def _reduce96(v):
    """``Acc96::reduce``: the sum (below 2^96) times 2^-32 mod q."""
    assert 0 <= v < 1 << 96
    lo, top = v & M64, v >> 64
    l, h = _redc64(lo & M32), lo >> 32
    h = h - 2 * Q if h >= 2 * Q else h
    h = h - Q if h >= Q else h
    c = _redc64(top * R2)                 # bb::mont_mul(top, R2)
    return ((l + h) % Q + c) % Q


def _ext9_model(pairs, nr, reps=1):
    """What ``Ext9`` computes over the pairs (a, b) of stored rows, each
    pair's products added ``reps`` times: degree sums of u64 groups of at
    most four products, exact in 96 bits, then c_k = reduce(S_k + nr R
    reduce(S_{k+9})) and c_8 = reduce(S_8), stored back by the
    permutation."""
    sums = [0] * 17
    for a, b in pairs:
        ad = [int(a[p]) for p in SB.PERM9]
        bd = [int(b[p]) for p in SB.PERM9]
        for d in range(17):
            terms = [i for i in range(9) if 0 <= d - i < 9]
            for g in range(0, len(terms), 4):
                t = sum(ad[i] * bd[d - i] for i in terms[g:g + 4])
                assert t <= M64
                sums[d] += reps * t
    nr_mont = nr * (1 << 32) % Q
    c = [_reduce96(sums[k] + nr_mont * _reduce96(sums[k + 9]))
         for k in range(8)] + [_reduce96(sums[8])]
    out = [0] * 9
    for d in range(9):
        out[SB.PERM9[d]] = c[d]
    return out


@pytest.mark.parametrize("fill", [None, Q - 1, 0, 1, Q // 2])
@pytest.mark.parametrize("m", [1, 3, 40])
def test_kernel_arithmetic_model(fill, m):
    rng = np.random.default_rng(m)
    xA, A = _words(rng, (1, E, 1, m), fill)
    xx, x = _words(rng, (1, E, 1, m), Q - 1 if fill is None else fill)
    want = _u32(SB.bb_slot_matvec_ref(A, x, T)).reshape(E)
    got = _ext9_model(zip(xA[0, :, 0].T, xx[0, :, 0].T), NR)
    assert [int(v) for v in want] == got
    if m == 1:                                # bb_slot_mul's one product
        prod = _u32(SB.bb_slot_mul_ref(A[..., 0], x[..., 0], T)).reshape(E)
        assert [int(v) for v in prod] == got


def test_kernel_arithmetic_longest_chunk():
    """At the longest chunk the plan allows (``MV_MAX_CHUNK`` j's, every
    word q - 1: every group and sum at its largest) the 96-bit sums stay
    exact and the fold gives the chunk's sum; the last block's sum of
    chunk partials reduces exactly too."""
    plan = _plan(1, 1, 1, 1 << 40)
    assert plan.chunk == S.MV_MAX_CHUNK
    words = np.full(E, Q - 1, dtype=np.uint32)
    one = _ext9_model([(words, words)], NR)
    got = _ext9_model([(words, words)], NR, reps=S.MV_MAX_CHUNK)
    assert got == [S.MV_MAX_CHUNK * v % Q for v in one]
    # the chunks' partials, canonical words, added in a u64 and reduced
    # by mont_mul(redc64(sum), R2)
    chunks = plan.chunks
    total = chunks * (Q - 1)
    assert total < Q << 32
    assert _redc64(_redc64(total) * R2) == total % Q


# -- the launch plan ------------------------------------------------------


@pytest.mark.parametrize("n,W,m", [(8, 16, 65536), (8, 16, 8192), (3, 1, 1),
                                   (3, 1, 7), (8, 1, 8193), (9, 17, 100),
                                   (1, 1, 1 << 30)])
def test_bb_matvec_plan(n, W, m):
    p = _plan(N, n, W, m)
    assert p.tiles_n == -(-n // 8) and p.tiles == p.tiles_n * -(-W // 16)
    assert p.chunk % S.MV_STEP == 0 and p.chunk <= S.MV_MAX_CHUNK
    assert (p.chunks - 1) * p.chunk < m <= p.chunks * p.chunk
    if p.chunks > 1:
        assert p.tickets == N * p.tiles
        assert 2 * p.partials == N * p.tiles * p.chunks * E * S.MV_THREADS
    else:
        assert p.tickets == p.partials == 0
    if (n, W, m) == (8, 16, 65536):           # the BabyBear fold's commit
        assert (p.chunks, p.chunk) == (64, 1024)


@pytest.mark.parametrize("n,W,m", [(3, 1, 7), (9, 17, 70), (2, 3, 1)])
def test_matvec_kernel_model(n, W, m, monkeypatch):
    """``bb_slot_matvec_kernel``'s decomposition, run with the twin: each
    (chunk, tile) block's sum reduced mod q, the chunks' partials added
    and reduced by the last block, gives the whole contraction."""
    monkeypatch.setattr(S, "MV_BLOCKS", 10 ** 6)   # a chunk a 32 j's
    rng = np.random.default_rng(n + W + m)
    A = _words(rng, (N, E, n, m))[1]
    x = _words(rng, (N, E, W, m))[1]
    p = _plan(N, n, W, m)
    assert p.chunks == -(-m // S.MV_STEP)
    out = torch.zeros((E * N, W, n), dtype=torch.int32)
    for t in range(p.tiles):
        i0, w0 = (t % p.tiles_n) * 8, (t // p.tiles_n) * 16
        Ai, xw = A[:, :, i0:i0 + 8], x[:, :, w0:w0 + 16]
        total = None
        for c in range(p.chunks):
            j = slice(c * p.chunk, (c + 1) * p.chunk)
            part = SB.bb_slot_matvec_ref(Ai[..., j].contiguous(),
                                         xw[..., j].contiguous(), T)
            part = part.to(torch.int64) & M32
            total = part if total is None else total + part
        out[:, w0:w0 + 16, i0:i0 + 8] = (total % Q).to(torch.int32)
    assert torch.equal(out, SB.bb_slot_matvec_ref(A, x, T))


# -- TModelMul's broadcasts in front of bb_slot_mul -----------------------


@pytest.mark.parametrize("ba,bb", [((4, 5), (4, 5)), ((4, 5), (1, 1)),
                                   ((1, 1), (4, 5)), ((4, 1), (1, 5)),
                                   ((4, 1), (4, 5)), ((1,), (1,))])
def test_bb_slot_mul_broadcasts(ba, bb):
    """``TModelMul._slot_mul`` on the BabyBear model (``bb_slot_mul``, run
    here on the CPU, where it answers with its twin) equals the torch ops
    for every broadcast."""
    tm = TModelMul(RING)
    rng = np.random.default_rng(len(ba) + len(bb))
    a = _words(rng, (N, E) + ba)[1]
    b = _words(rng, (N, E) + bb)[1]
    want = S.ext_mul(BABYBEAR, tm._tables, a, b)
    got = tm._slot_mul(a, b)
    assert got.shape == want.shape and torch.equal(got, want)
    strided = torch.stack([a, a], -1)[..., 0]       # a, not contiguous
    assert torch.equal(tm._slot_mul(strided, b), want)


# -- the benchmark's rooflines read the wrappers' launches ----------------


def _roofline(kernel):
    import importlib.util

    path = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "roofline" / f"{kernel}.py")
    spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,shapes,bytes_", [
    # the BabyBear fold's challenge: s1 [72, 16 x 16,384] by r [72, 1]
    ("bb_slot_mul", ((N, E, 262144), (N, E, 1)), 150_995_232),
    ("bb_slot_mul", ((N, E, 16384), (N, E, 16384)), 4 * E * N * 3 * 16384),
    ("bb_slot_mul", ((N, E, 13), (N, E, 13)), 4 * E * N * 3 * 13),
    # the BabyBear fold's commit: n = 8, M = 65,536, W = 16
    ("bb_slot_matvec", ((N, E, 8, 65536), (N, E, 16, 65536)), 453_021_696),
    ("bb_slot_matvec", ((N, E, 3, 7), (N, E, 1, 7)),
     4 * E * N * (7 * 4 + 3)),
])
def test_roofline_reads_the_launch(kernel, shapes, bytes_, monkeypatch):
    """``portbench/roofline/<kernel>.py`` counts the operands' bytes and
    the products of 32-bit words from the C arguments the wrapper hands
    the launch."""
    launched = []
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        srt_bb_slot_mul=None, srt_bb_slot_matvec=None))
    monkeypatch.setattr(_build, "work", lambda *a: (0, None, 0, None))
    monkeypatch.setattr(_build, "launch", lambda counts, name, fn, dev,
                        *args, stream=None: launched.append((name, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    x, y = (torch.zeros(s, dtype=torch.int32) for s in shapes)
    getattr(SB, kernel)(x, y, T)
    assert [name for name, _ in launched] == [kernel]
    args = launched[0][1]
    assert args[7 if kernel == "bb_slot_mul" else 11] == NR * 2**32 % Q
    cost = _roofline(kernel).cost(args)
    assert cost["bytes"] == bytes_
    if kernel == "bb_slot_mul":
        assert cost["ops"] == 81 * shapes[0][0] * shapes[0][2]
    else:
        (N_, _, n, m), W = shapes[0], shapes[1][2]
        assert cost["ops"] == 81 * N_ * n * W * m
