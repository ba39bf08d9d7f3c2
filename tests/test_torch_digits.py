"""The fold step's digit-stage kernels' CPU side (``ops/digits.py``): the
dispatch predicate (Goldilocks and BabyBear on a CUDA device, an even
base 2 <= b < 2^31, every witness's L2 sum below 2^64; frog,
stark_prime, CPU tensors, an odd base and an over-guard sum keep the
torch ops); the twin, which is the step's three stages as torch ops,
against those three calls; a Python-int model of ``csrc/digits.cu``'s
arithmetic (the balanced magnitude, the fixed-k digit loop, the digit's
storage word, its signed magnitude squared, psi's formula on the word,
the per-witness sum and count) against the twin at the field's edge
values, planted psi failures, negative digits and sums at the L2 bound;
and the rooflines read from the wrapper's launch arguments.  The kernels
themselves are held to the twin on the card in ``test_torch_cuda.py``."""

import importlib.util
import pathlib
import random
import types

import numpy as np
import pytest
import torch

from stark_rings_tpu_torch.decomp import decompose
from stark_rings_tpu_torch.decomp.norms import (l2_check,
                                                l2_norm_squared_words,
                                                words_to_int)
from stark_rings_tpu_torch.fields import get_field
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops import digits as DG
from stark_rings_tpu_torch.protocol import FoldingStep
from stark_rings_tpu_torch.rings import get_ring
from stark_rings_tpu_torch.rings.monomial import (_ct_psi_table,
                                                  psi_range_check_batched)

M32 = (1 << 32) - 1
CELLS = {"goldilocks": (24, 8), "babybear": (72, 4)}    # D, k at base 256


# -- dispatch -----------------------------------------------------------


@pytest.mark.parametrize("name,want", [("goldilocks", True),
                                       ("babybear", True), ("frog", False),
                                       ("stark_prime", False)])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cpu", "meta"])
def test_predicate_fields_and_devices(name, want, device):
    """The kernel takes Goldilocks and BabyBear on a CUDA device only."""
    D, k = CELLS.get(name, (24, 8))
    for psi in (True, False):
        got = DG.uses_digit_kernel(get_field(name), (D, 16, 16384), device,
                                   256, k, psi)
        assert got == (want and device.startswith("cuda"))


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
@pytest.mark.parametrize("base,k,shape,want", [
    (256, 4, (72, 16, 16384), True),           # the cells' bases
    (6, 13, (24, 2, 5), True),                 # even, not a power of two
    (2, 64, (24, 1, 1), True),
    (2**31 - 2, 2, (2, 1, 1), True),           # 2 x 2 x (2^30 - 1)^2
    (7, 23, (24, 2, 5), False),                # odd
    (0, 4, (24, 2, 5), False),
    (2**31, 2, (24, 2, 5), False),
    (256, 0, (24, 2, 5), False),
    (4, 64, (24, 2, 5), True),                 # k up to 64
    (4, 65, (24, 2, 5), False),
    # D L k (b/2)^2 at 2^64: over the u64 guard; at 2^64 - 2^34: in
    (2**16, 4, (16, 2, 1 << 28), False),
    (2**16, 2, (8, 1, 1 << 30), False),
    (2**16, 2, (8, 1, (1 << 30) - 1), True),
    (256, 4, (24, 2), False),                  # not [D, W, L]
])
def test_predicate_base_and_guard(name, base, k, shape, want):
    """An even base 2 <= b < 2^31, 1 <= k <= 64, a [D, W, L] shape, and D L k
    (b/2)^2 < 2^64 (8 x 2^30 x 2 x 2^30 = 2^64 is out, one column fewer
    is in)."""
    for psi in (True, False):
        assert DG.uses_digit_kernel(get_field(name), shape, "cuda", base,
                                    k, psi) is want


@pytest.mark.parametrize("name,D_max", [("goldilocks", 6144),
                                        ("babybear", 12288)])
def test_predicate_psi_table_fits(name, D_max):
    """With psi the D-word table must fit 48 KB of shared memory; without
    psi any D goes."""
    f = get_field(name)
    for D, psi, want in ((D_max, True, True), (D_max + 1, True, False),
                         (D_max + 1, False, True)):
        assert DG.uses_digit_kernel(f, (D, 1, 1), "cuda", 256, 4,
                                    psi) is want


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog",
                                  "stark_prime"])
def test_cpu_tensors_take_the_twin(name, monkeypatch):
    """On CPU tensors (and for frog and stark_prime anywhere) the step
    calls the twin and launches nothing."""
    called = []
    twin = DG.step_digits_ref
    monkeypatch.setattr(DG, "step_digits_ref",
                        lambda *a: called.append(1) or twin(*a))
    monkeypatch.setattr(_build, "launch", _refuse)
    ring = get_ring(name, device="cpu")
    base = {"frog": 4, "stark_prime": 1 << 16}.get(name, 256)
    fs = FoldingStep(ring, 2, 3, base, psi_check=True)
    rng = np.random.default_rng(5)
    c = fs.init_tables(rng)
    ins = [fs.rand_witness(2, rng) for _ in range(2)]
    ins += [fs.tm.to_t(ring.rand_ntt((2, 2), rng)).contiguous()
            for _ in range(2)]
    fs.step(c, *ins, fs.precompute_challenge(ring.rand_coeff((), rng)))
    assert called == [1]


def _refuse(*a, **kw):
    raise AssertionError("a kernel launched on the CPU")


# -- the twin: today's three calls ---------------------------------------


def _edge_values(q, b):
    """The coefficients at the edges of the field and the digit loop."""
    h = (q - 1) // 2
    vals = [0, 1, q - 1, b // 2, b // 2 + 1, q - b // 2, q - b // 2 - 1,
            h, h + 1, h - 1, b - 1, b, b + 1, q - b, b * b // 2,
            q - b * b // 2]
    return sorted({v % q for v in vals})


def _coeff(ring, vals, W, L, seed):
    """[D, W, L] storage: ``vals`` first, the rest drawn from [0, q)."""
    D, q = ring.D, ring.q
    rnd = random.Random(seed)
    flat = [rnd.randrange(q) for _ in range(D * W * L)]
    flat[:len(vals)] = vals
    return ring.field.encode(np.array(flat, dtype=object).reshape(D, W, L),
                             "cpu")


@pytest.mark.parametrize("name,base", [("goldilocks", 256),
                                       ("babybear", 256), ("goldilocks", 6),
                                       ("babybear", 6), ("frog", 4),
                                       ("stark_prime", 1 << 16)])
def test_twin_is_the_three_calls(name, base):
    """``step_digits_ref`` and ``check_psi`` give the step's outputs as
    ``decompose``, ``l2_check`` and ``psi_range_check_batched`` do."""
    from stark_rings_tpu_torch.spec.decomp import decomposition_max_length

    ring = get_ring(name, device="cpu")
    f, W, L = ring.field, 3, 5
    k = decomposition_max_length(ring.q, base)
    coeff = _coeff(ring, _edge_values(ring.q, base)
                   if not f.limbed else [], W, L, 1)
    bound = 10**9
    dt, ok_l2, fails = DG.step_digits(ring, coeff, base, k, bound, True)
    assert fails is None
    dig = decompose(f, coeff, base, k)
    assert torch.equal(dt, dig.reshape((ring.D, W, L * k) + f.limb_shape))
    assert torch.equal(ok_l2, l2_check(f, dt, bound, axis=(0, 2)))
    assert torch.equal(DG.check_psi(ring, dt, fails),
                       psi_range_check_batched(ring, dt).all(2).all(0))


# -- a model of the kernel -----------------------------------------------


def _field_maps(f):
    """(canon, from_canon) on Python ints, as csrc/digits.cu's field
    structs: the identity for Goldilocks, Montgomery for BabyBear."""
    if f.name == "goldilocks":
        return (lambda x: x), (lambda u: u)
    r, rinv = (1 << 32) % f.q, pow(1 << 32, -1, f.q)
    return (lambda x: x * rinv % f.q), (lambda u: u * r % f.q)


def kernel_model(ring, words, base, k, psi):
    """csrc/digits.cu on Python ints: storage words [D, W, L] (nested
    lists) -> (digit words [D][W][L k], L2 sums [W], failing
    coefficients [W])."""
    f, D = ring.field, ring.D
    q, half = f.q, (f.q - 1) // 2
    canon, from_canon = _field_maps(f)
    tbl = [int(v) for v in _ct_psi_table(ring).reshape(-1).tolist()]
    tbl = [v & ((1 << 64) - 1) for v in tbl]
    W = len(words[0])
    sums, fails = [0] * W, [0] * W
    out = []
    for d in range(D):
        out.append([])
        for w in range(W):
            row = []
            for x in words[d][w]:
                u = canon(x)
                neg = u > half
                cur = q - u if neg else u
                ok = True
                for _ in range(k):
                    quot, m = divmod(cur, base)
                    low = 2 * m <= base
                    dmag = m if low else base - m
                    dpos = from_canon(dmag)
                    dneg = (neg != (not low)) and dmag != 0
                    word = q - dpos if dneg else dpos
                    cur = quot if low else quot + 1
                    vm = canon(word)
                    is_pos = vm <= half
                    centered = vm if is_pos else q - vm
                    sums[w] += centered * centered
                    if psi:
                        # the kernel's index: centered < 2^30, so the
                        # narrowing keeps it and (D - sm) mod D is D - sm
                        # or 0
                        assert 0 <= centered < 1 << 30
                        sm = centered
                        valid = sm < D if is_pos else sm <= D
                        pos = (0 if not valid else sm if is_pos
                               else 0 if sm == D else D - sm)
                        ok = ok and valid and tbl[pos] == word
                    row.append(word)
                fails[w] += not ok
            out[d].append(row)
    return out, sums, fails


def _u(f, t):
    """Storage tensor -> nested lists of the words read unsigned."""
    m = (1 << 64) - 1 if f.dtype == torch.int64 else M32
    return (np.vectorize(lambda v: int(v) & m, otypes=[object])(
        t.numpy().astype(object))).tolist()


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
@pytest.mark.parametrize("base", [256, 6, 2])
@pytest.mark.parametrize("psi", [True, False], ids=["psi", "nopsi"])
def test_kernel_model_matches_the_twin(name, base, psi):
    """Edge coefficients (0, +-1, b/2, b/2 + 1, (q - 1)/2, (q + 1)/2,
    q - 1, ...) and random ones: the model's digit words equal the
    twin's, its sums the exact L2 of each witness's digits, and its
    counts are 0 exactly where the twin's psi passes."""
    from stark_rings_tpu_torch.spec.decomp import decomposition_max_length

    ring = get_ring(name, device="cpu")
    f, W, L = ring.field, 2, 4
    k = decomposition_max_length(ring.q, base)
    coeff = _coeff(ring, _edge_values(ring.q, base), W, L, base)
    dt, sums, fails = kernel_model(ring, _u(f, coeff), base, k, psi)
    want, _, _ = DG.step_digits_ref(ring, coeff, base, k, 0)
    assert dt == _u(f, want)
    words = l2_norm_squared_words(f, want, axis=(0, 2))
    assert sums == [words_to_int(words[w]) for w in range(W)]
    if psi:
        ok_psi = DG.check_psi(ring, want, None).tolist()
        assert [x == 0 for x in fails] == ok_psi
    else:
        assert fails == [0] * W


def _small(ring, rows, W, L, rng):
    """[D, W, L] storage of small signed values: ``rows[w]`` the (low,
    high) range of witness w's coefficients."""
    vals = np.stack([rng.integers(lo, hi + 1, (ring.D, L))
                     for lo, hi in rows], axis=1)
    return ring.field.encode(np.vectorize(int, otypes=[object])(vals)
                             % ring.q, "cpu")


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_kernel_model_psi_failures_and_negative_digits(name):
    """Witness 0 holds digits in psi's range, witness 1 one planted
    coefficient past it, witness 2 negative digits only: the model
    counts the failing coefficients, 0 exactly where the twin passes.
    On these rings the reference fails every negative digit (ct(psi
    X^(D - a)) != -a): the kernel keeps its formula, not a test of
    |d| < D/2."""
    ring = get_ring(name, device="cpu")
    f, D, base = ring.field, ring.D, 256
    k, L = CELLS[name][1], 6
    rng = np.random.default_rng(7)
    coeff = _small(ring, [(0, D // 2 - 1), (0, D // 2 - 1), (-5, -1)], 3, L,
                   rng)
    coeff[0, 1, 2] = f.encode(np.array([D], dtype=object), "cpu")[0]
    _, _, fails = kernel_model(ring, _u(f, coeff), base, k, True)
    dt, _, _ = DG.step_digits_ref(ring, coeff, base, k, 0)
    assert DG.check_psi(ring, dt, None).tolist() == [True, False, False]
    assert fails == [0, 1, D * L]


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_kernel_model_l2_at_the_bound(name):
    """A witness's sum exactly at the bound passes, one past it fails,
    and a bound of 2^64 or more holds: the kernel path's u64 compare on
    the model's sums gives the twin's ``ok_l2``."""
    ring = get_ring(name, device="cpu")
    f, base = ring.field, 256
    k = CELLS[name][1]
    coeff = _small(ring, [(-9, 9), (-3, 3)], 2, 5, np.random.default_rng(3))
    _, sums, _ = kernel_model(ring, _u(f, coeff), base, k, False)
    for bound in (sums[0], sums[0] - 1, sums[1], sums[1] - 1, 1 << 64,
                  (1 << 64) - 1, 1 << 200):
        got = DG.l2_within(torch.tensor(sums, dtype=torch.int64), bound)
        _, want, _ = DG.step_digits_ref(ring, coeff, base, k, bound)
        assert got.tolist() == want.tolist() == [s <= bound for s in sums]


# -- the launch and its roofline ----------------------------------------


def _roofline(kernel):
    path = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "roofline" / f"{kernel}.py")
    spec = importlib.util.spec_from_file_location(f"roofline_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(monkeypatch):
    launched, work = [], []
    monkeypatch.setattr(DG, "uses_digit_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        srt_step_digits=None, srt_bb_step_digits=None))
    monkeypatch.setattr(_build, "work", lambda dev, stream, t, p:
                        work.append((t, p)) or (0, None, 0, None))
    monkeypatch.setattr(_build, "launch", lambda counts, name, fn, dev,
                        *args, stream=None: launched.append((name, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 0, raising=False)
    return launched, work


@pytest.mark.parametrize("name,base,shift", [("goldilocks", 256, 8),
                                             ("babybear", 256, 8),
                                             ("goldilocks", 6, -1),
                                             ("babybear", 2, 1)])
@pytest.mark.parametrize("psi", [True, False], ids=["psi", "nopsi"])
def test_launch_arguments(name, base, shift, psi, monkeypatch):
    """One launch under the field's name, with the shape, base, shift,
    psi flag and table; the scratch holds a ticket a witness and two
    words a block."""
    launched, work = _capture(monkeypatch)
    ring = get_ring(name, device="cpu")
    D, W, L, k = ring.D, 3, 1500, 5
    coeff = torch.zeros((D, W, L), dtype=ring.field.dtype)
    dt, ok_l2, fails = DG.step_digits(ring, coeff, base, k, 10, psi)
    kernel = "step_digits" if name == "goldilocks" else "bb_step_digits"
    assert [n for n, _ in launched] == [kernel]
    args = launched[0][1]
    assert args[3:10] == (D, W, L, k, base, shift, int(psi))
    assert (args[2] != 0) == psi
    assert work == [(W, 2 * W * D * 2)]            # 2 chunks of 1,024
    assert dt.shape == (D, W, L * k) and dt.dtype == ring.field.dtype
    assert ok_l2.shape == (W,) and (fails is None) == (not psi)


@pytest.mark.parametrize("name", ["goldilocks", "babybear"])
def test_wrong_coefficients_raise(name, monkeypatch):
    launched, _ = _capture(monkeypatch)
    ring = get_ring(name, device="cpu")
    other = torch.int32 if ring.field.dtype == torch.int64 else torch.int64
    for coeff in (torch.zeros((ring.D, 2, 3), dtype=other),
                  torch.zeros((ring.D + 1, 2, 3), dtype=ring.field.dtype)):
        with pytest.raises(ValueError):
            DG.step_digits(ring, coeff, 256, 4, 10, True)
    assert not launched


@pytest.mark.parametrize("kernel,args,bytes_", [
    # the cells' steps, psi on: coefficients, digits, W pairs, the table
    ("step_digits", (0, 0, 0, 24, 16, 16384, 8, 256, 8, 1),
     8 * (24 * 16 * 16384 * 9 + 24) + 16 * 16),
    ("bb_step_digits", (0, 0, 0, 72, 16, 16384, 4, 256, 8, 1),
     4 * (72 * 16 * 16384 * 5 + 72) + 16 * 16),
    ("bb_step_digits", (0, 0, 0, 72, 2, 3, 4, 256, 8, 0),
     4 * 72 * 2 * 3 * 5 + 16 * 2),
])
def test_roofline_counts_one_pass(kernel, args, bytes_):
    """``portbench/roofline/<kernel>.py``: the coefficients read once, the
    k digits a coefficient written once, the W (sum, count) pairs and
    psi's table; the operations are the digits made."""
    cost = _roofline(kernel).cost(args)
    assert cost["bytes"] == bytes_
    assert cost["ops"] == args[3] * args[4] * args[5] * args[6]
