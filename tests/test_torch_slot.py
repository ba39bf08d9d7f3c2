"""The Goldilocks slot-product kernels' CPU side (``ops/slot.py``): the
routing predicate (Goldilocks, E = 3, identity storage permutation, a
CUDA device) and ``TModelMul``'s route; the wrappers' input checks,
which raise before any launch; the twins ``slot_mul_ref`` /
``slot_matvec_ref`` (the CPU path of ``slot_mul`` / ``slot_matvec``)
against the reference's ``ntt_mul_bt`` / ``matvec_t``, blocked and
unblocked; a Python-int model of the kernels' arithmetic (nine 128-bit
products into five 192-bit degree sums, folded once) at the operands'
extremes; a model of ``slot_matvec_kernel``'s chunks and tiles from
``matvec_plan``; and ``TModelMul``'s broadcast normalisation in front of
``slot_mul``.  The kernels themselves are held to the twins on the card
in ``test_torch_cuda.py``."""

import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.ops.model_mul import TModelMul as RefTModelMul
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import GOLDILOCKS, from_jax_storage
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops import slot as S
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.rings import get_ring

Q = GOLDILOCKS.q
T = S.ext_tables(get_ring("goldilocks", device="cpu"))
NR = T.nr
BB_T = S.ext_tables(get_ring("babybear", device="cpu"))
N, D = 8, 24


def _words(rng, shape, fill=None):
    x = (np.full(shape, fill, dtype=np.uint64) if fill is not None
         else rng.integers(0, Q, shape, dtype=np.uint64))
    return x, from_jax_storage(GOLDILOCKS, x, "cpu")


def _u64(t):
    return t.contiguous().numpy().view(np.uint64)


@pytest.fixture(scope="module")
def ref():
    return RefTModelMul(ref_ring("goldilocks"))


# -- routing -----------------------------------------------------------


@pytest.mark.parametrize("device,want", [("cuda", True), ("cuda:0", True),
                                         ("cpu", False), ("meta", False)])
@pytest.mark.parametrize("perm", [[0, 1, 2], [0, 2, 1], [2, 1, 0]])
def test_predicate_goldilocks(device, want, perm, monkeypatch):
    """The predicate reads the field, E and the permutation; the device
    is ``TModelMul.uses_slot_kernel``'s own test.  A Goldilocks ring in
    another storage order stores no kernel pair."""
    from stark_rings_tpu_torch.ops import model_mul as MM

    assert S.slot_kernel_applies(GOLDILOCKS, 3, perm) == (perm == [0, 1, 2])
    tm = TModelMul(get_ring("goldilocks", device="cpu"))
    assert tm.uses_slot_kernel(device) == want
    assert tm._slot_pair == (S.slot_mul, S.slot_matvec)
    monkeypatch.setattr(MM, "ext_tables", lambda ring: T._replace(
        perm=torch.tensor(perm)))
    permuted = TModelMul(get_ring("goldilocks", device="cpu"))
    want_pair = (S.slot_mul, S.slot_matvec) if perm == [0, 1, 2] else None
    assert permuted._slot_pair == want_pair
    assert permuted.uses_slot_kernel(device) == (want and perm == [0, 1, 2])


@pytest.mark.parametrize("name", ["babybear", "frog", "stark_prime"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_predicate_other_fields(name, device):
    ring = get_ring(name, device="cpu")
    perm = list(ring.spec.storage_perm)
    assert not S.slot_kernel_applies(ring.field, ring.E, perm)
    # the Goldilocks field with another E is no kernel's either
    assert not S.slot_kernel_applies(GOLDILOCKS, ring.E, perm)
    tm = TModelMul(ring)
    assert not tm.uses_slot_kernel(device)
    if name != "babybear":
        assert tm._slot_pair is None    # frog, stark_prime: torch ops


def test_tmodelmul_route():
    tm = TModelMul(get_ring("goldilocks", device="cpu"))
    assert tm.uses_slot_kernel("cuda")
    assert tm.uses_slot_kernel(torch.device("cuda", 0))
    assert not tm.uses_slot_kernel("cpu")


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_cpu_tensors_launch_nothing(name, monkeypatch):
    """On CPU tensors every model keeps the torch ops: no kernel is
    built or launched, and the counters stay at 0."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel was asked for on CPU tensors")

    monkeypatch.setattr(_build, "kernels", refuse)
    S.reset_launches()
    ring = get_ring(name, device="cpu")
    tm = TModelMul(ring)
    rng = np.random.default_rng(5)
    a, b = (ring.field.rand((ring.D, 6), rng, "cpu") for _ in range(2))
    tm.mul_t(a, b)
    A = ring.field.rand((ring.D, 3, 5), rng, "cpu")
    x = ring.field.rand((ring.D, 2, 5), rng, "cpu")
    tm.matvec_t(A, x)
    assert S.LAUNCHES == {"slot_mul": 0, "slot_matvec": 0}


# -- the wrappers' checks -----------------------------------------------


def _bad_calls():
    rng = np.random.default_rng(1)
    a = _words(rng, (N, 3, 6))[1]
    A = _words(rng, (N, 3, 4, 5))[1]
    x = _words(rng, (N, 3, 2, 5))[1]
    i32 = torch.zeros((N, 3, 6), dtype=torch.int32)
    return [
        ("mul int32", TypeError, lambda: S.slot_mul(i32, a, T)),
        ("mul numpy", TypeError, lambda: S.slot_mul(a.numpy(), a, T)),
        ("mul 2-D", ValueError, lambda: S.slot_mul(a.reshape(D, 6), a, T)),
        ("mul E=4", ValueError, lambda: S.slot_mul(
            torch.zeros((6, 4, 6), dtype=torch.int64),
            torch.zeros((6, 4, 1), dtype=torch.int64), T)),
        ("mul batch", ValueError, lambda: S.slot_mul(
            a, a[:, :, :2].contiguous(), T)),
        ("mul slots", ValueError, lambda: S.slot_mul(a, a[:4], T)),
        ("mul strided", ValueError, lambda: S.slot_mul(a[:, :, ::2],
                                                      a[:, :, :3], T)),
        ("mul nr=q", ValueError, lambda: S.slot_mul(
            a, a, T._replace(nr=Q))),
        ("mul nr<0", ValueError, lambda: S.slot_mul(
            a, a, T._replace(nr=-1))),
        ("mul nr float", ValueError, lambda: S.slot_mul(
            a, a, T._replace(nr=2.0))),
        ("mul meta", ValueError, lambda: S.slot_mul(
            a.to("meta"), a.to("meta"), T)),
        ("matvec int32", TypeError, lambda: S.slot_matvec(
            A.to(torch.int32), x, T)),
        ("matvec 3-D", ValueError, lambda: S.slot_matvec(
            A.reshape(D, 4, 5), x, T)),
        ("matvec m", ValueError, lambda: S.slot_matvec(
            A, x[..., :4].contiguous(), T)),
        ("matvec slots", ValueError, lambda: S.slot_matvec(A[:4], x, T)),
        ("matvec empty", ValueError, lambda: S.slot_matvec(
            A[:, :, :0], x, T)),
        ("matvec m=0", ValueError, lambda: S.slot_matvec(
            A[..., :0], x[..., :0], T)),
        ("matvec strided", ValueError, lambda: S.slot_matvec(
            A.transpose(2, 3).contiguous().transpose(2, 3), x, T)),
        ("matvec nr", ValueError, lambda: S.slot_matvec(
            A, x, T._replace(nr=Q + 1))),
        ("mul E=9 tables", ValueError, lambda: S.slot_mul(a, a, BB_T)),
        ("mul no tables", ValueError, lambda: S.slot_mul(a, a, NR)),
        ("matvec E=4 tables", ValueError, lambda: S.slot_matvec(
            A, x, S.ext_tables(get_ring("frog", device="cpu")))),
        ("matvec meta", ValueError, lambda: S.slot_matvec(
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
    before = dict(S.LAUNCHES)
    with pytest.raises(err):
        call()
    assert not launched and S.LAUNCHES == before


# -- the twins against the reference -------------------------------------


@pytest.mark.parametrize("ba,bb", [((7,), (7,)), ((7,), (1,)),
                                   ((2, 5), (2, 5)), ((2, 5), (1, 1)),
                                   ((128,), (1,))])
def test_slot_mul_ref_matches_reference(ref, ba, bb):
    rng = np.random.default_rng(sum(ba) + len(bb))
    xa, a = _words(rng, (D,) + ba)
    xb, b = _words(rng, (D,) + bb)
    want = np.asarray(jax.jit(ref.ntt_mul_bt)(xa, xb))
    Ba, Bb = int(np.prod(ba)), int(np.prod(bb))
    got = S.slot_mul(a.reshape(N, 3, Ba), b.reshape(N, 3, Bb), T)
    assert got.shape == (D, Ba)
    assert np.array_equal(_u64(got), want.reshape(D, Ba))
    assert torch.equal(got, S.slot_mul_ref(a.reshape(N, 3, Ba),
                                           b.reshape(N, 3, Bb), T))


@pytest.mark.parametrize("n,W,m", [(3, 2, 7), (1, 1, 1), (5, 3, 33)])
@pytest.mark.parametrize("block", [None, 4, 1])
def test_slot_matvec_ref_matches_reference(ref, n, W, m, block):
    rng = np.random.default_rng(n * 100 + W * 10 + m)
    xA, A = _words(rng, (D, n, m))
    xx, x = _words(rng, (D, W, m))
    want = np.asarray(jax.jit(ref.matvec_t)(xA, xx))
    got = S.slot_matvec(A.reshape(N, 3, n, m), x.reshape(N, 3, W, m), T)
    assert got.shape == (D, W, n)
    assert np.array_equal(_u64(got), want)
    blocked = S.slot_matvec_ref(A.reshape(N, 3, n, m),
                                x.reshape(N, 3, W, m), T, block=block)
    assert torch.equal(blocked, got)


# -- the kernels' arithmetic, in Python ints ------------------------------


def _kernel_model(a, b, nr):
    """What ``Ext`` computes for one slot: the nine products a_i b_j
    added as 128-bit words into five 192-bit degree sums (lo, hi, top),
    each folded by 2^128 = -2^32 (mod q), then c_k = S_k + nr S_{k+3}."""
    M64 = (1 << 64) - 1
    sums = [[0, 0, 0] for _ in range(5)]
    for aj, bj in zip(a, b):
        for i in range(3):
            for j in range(3):
                p = int(aj[i]) * int(bj[j])
                lo, hi, top = sums[i + j]
                lo += p & M64
                hi += (p >> 64) + (lo >> 64)
                top += hi >> 64
                sums[i + j] = [lo & M64, hi & M64, top]
    red = []
    for lo, hi, top in sums:
        assert top < (1 << 32) - 1
        red.append(((hi << 64 | lo) - (top << 32)) % Q)
    c = [(red[0] + nr * red[3]) % Q, (red[1] + nr * red[4]) % Q, red[2]]
    # the same as the exact sums, by 2^128 = -2^32 (mod q)
    assert (1 << 128) % Q == Q - (1 << 32)
    return c


@pytest.mark.parametrize("fill", [None, Q - 1, 0, 1, 1 << 63, (1 << 32) - 1])
@pytest.mark.parametrize("m", [1, 3, 40])
def test_kernel_arithmetic_model(fill, m):
    rng = np.random.default_rng(m)
    xA, A = _words(rng, (1, 3, 1, m), fill)
    xx, x = _words(rng, (1, 3, 1, m), Q - 1 if fill is None else fill)
    want = _u64(S.slot_matvec_ref(A, x, T)).reshape(3)
    got = _kernel_model(xA[0, :, 0].T, xx[0, :, 0].T, NR)
    assert [int(v) for v in want] == got


# -- the launch plan ------------------------------------------------------


@pytest.mark.parametrize("n,W,m", [(8, 16, 8192), (8, 16, 65536), (3, 1, 1),
                                   (3, 1, 7), (8, 1, 8193), (9, 17, 100),
                                   (1, 1, 1 << 30)])
def test_matvec_plan(n, W, m):
    p = S.matvec_plan(N, n, W, m)
    assert p.tiles_n == -(-n // 8) and p.tiles == p.tiles_n * -(-W // 16)
    assert p.chunk % S.MV_STEP == 0 and p.chunk <= S.MV_MAX_CHUNK
    assert (p.chunks - 1) * p.chunk < m <= p.chunks * p.chunk
    if p.chunks > 1:
        assert p.tickets == N * p.tiles
        assert p.partials == N * p.tiles * p.chunks * 3 * S.MV_THREADS
    else:
        assert p.tickets == p.partials == 0
    if (n, W, m) == (8, 16, 8192):            # the folding step's commit
        assert (p.chunks, p.chunk) == (64, 128)


@pytest.mark.parametrize("n,W,m", [(3, 1, 7), (9, 17, 70), (2, 3, 1)])
def test_matvec_kernel_model(n, W, m, monkeypatch):
    """``slot_matvec_kernel``'s decomposition, run with the twin: each
    (chunk, tile) block's sum folded mod q, the chunks added mod q by the
    last block, gives the whole contraction."""
    monkeypatch.setattr(S, "MV_BLOCKS", 10 ** 6)   # a chunk a 32 j's
    rng = np.random.default_rng(n + W + m)
    A = _words(rng, (N, 3, n, m))[1]
    x = _words(rng, (N, 3, W, m))[1]
    p = S.matvec_plan(N, n, W, m)
    assert p.chunks == -(-m // S.MV_STEP)
    out = torch.zeros((3 * N, W, n), dtype=torch.int64)
    for t in range(p.tiles):
        i0, w0 = (t % p.tiles_n) * 8, (t // p.tiles_n) * 16
        Ai, xw = A[:, :, i0:i0 + 8], x[:, :, w0:w0 + 16]
        tile = None
        for c in range(p.chunks):
            j = slice(c * p.chunk, (c + 1) * p.chunk)
            part = S.slot_matvec_ref(Ai[..., j].contiguous(),
                                     xw[..., j].contiguous(), T)
            tile = part if tile is None else GOLDILOCKS.add(tile, part)
        out[:, w0:w0 + 16, i0:i0 + 8] = tile
    assert torch.equal(out, S.slot_matvec_ref(A, x, T))


# -- TModelMul's broadcasts in front of slot_mul --------------------------


@pytest.mark.parametrize("ba,bb", [((4, 5), (4, 5)), ((4, 5), (1, 1)),
                                   ((1, 1), (4, 5)), ((4, 1), (1, 5)),
                                   ((4, 1), (4, 5)), ((1, 5), (4, 5)),
                                   ((1,), (1,))])
def test_slot_mul_broadcasts(ba, bb):
    """``TModelMul._slot_mul`` (the kernel route's front, run here on the
    CPU, where ``slot_mul`` answers with its twin) equals the torch ops
    for every broadcast: b's batch a's or 1, a's batch 1 (swapped), and
    others (expanded)."""
    ring = get_ring("goldilocks", device="cpu")
    tm = TModelMul(ring)
    rng = np.random.default_rng(len(ba) + len(bb))
    a = _words(rng, (N, 3) + ba)[1]
    b = _words(rng, (N, 3) + bb)[1]
    want = S.ext_mul(GOLDILOCKS, tm._tables, a, b)
    got = tm._slot_mul(a, b)
    assert got.shape == want.shape and torch.equal(got, want)
    strided = torch.stack([a, a], -1)[..., 0]       # a, not contiguous
    assert torch.equal(tm._slot_mul(strided, b), want)


def test_broadcast_raises_on_mismatch():
    tm = TModelMul(get_ring("goldilocks", device="cpu"))
    a = torch.zeros((N, 3, 4, 5), dtype=torch.int64)
    with pytest.raises(ValueError):
        tm._slot_mul(a, torch.zeros((N, 3, 3, 5), dtype=torch.int64))


def test_kernel_route_imports_no_sympy():
    """The route in front of the kernels works out broadcasts itself: the
    first ``torch.broadcast_shapes`` of a process imports sympy and
    torch's symbolic shapes, seconds of set-up on the card's host."""
    code = (
        "import sys, torch\n"
        "from stark_rings_tpu_torch.rings import get_ring\n"
        "from stark_rings_tpu_torch.ops.model_mul import TModelMul\n"
        "tm = TModelMul(get_ring('goldilocks', device='cpu'))\n"
        "z = torch.zeros\n"
        "tm._slot_mul(z((8, 3, 2, 4), dtype=torch.int64),\n"
        "             z((8, 3, 1, 1), dtype=torch.int64))\n"
        "tm._slot_mul(z((8, 3, 2, 1), dtype=torch.int64),\n"
        "             z((8, 3, 1, 4), dtype=torch.int64))\n"
        "assert 'sympy' not in sys.modules, 'sympy was imported'\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)


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
    # mul_t at B = 65,536 (PERF.md's kernel table), the fold challenge
    ("slot_mul", ((N, 3, 65536), (N, 3, 65536)), 37_748_736),
    ("slot_mul", ((N, 3, 16384), (N, 3, 1)), 8 * 3 * N * (2 * 16384 + 1)),
    ("slot_mul", ((N, 3, 13), (N, 3, 13)), 8 * 3 * N * 3 * 13),
    # the folding step's commit: n = 8, M = 8,192, W = 16
    ("slot_matvec", ((N, 3, 8, 8192), (N, 3, 16, 8192)), 37_773_312),
    ("slot_matvec", ((N, 3, 3, 7), (N, 3, 1, 7)),
     8 * 3 * N * (7 * 4 + 3)),
])
def test_roofline_reads_the_launch(kernel, shapes, bytes_, monkeypatch):
    """``portbench/roofline/<kernel>.py`` counts the operands' bytes and
    the products from the C arguments the wrapper hands the launch."""
    launched = []
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        srt_slot_mul=None, srt_slot_matvec=None))
    monkeypatch.setattr(_build, "work", lambda *a: (0, None, 0, None))
    monkeypatch.setattr(_build, "launch", lambda counts, name, fn, dev,
                        *args, stream=None: launched.append((name, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    x, y = (torch.zeros(s, dtype=torch.int64) for s in shapes)
    getattr(S, kernel)(x, y, T)
    assert [name for name, _ in launched] == [kernel]
    cost = _roofline(kernel).cost(launched[0][1])
    assert cost["bytes"] == bytes_
    if kernel == "slot_mul":
        assert cost["ops"] == 9 * shapes[0][0] * shapes[0][2]
    else:
        (N_, _, n, m), W = shapes[0], shapes[1][2]
        assert cost["ops"] == 9 * N_ * n * W * m
