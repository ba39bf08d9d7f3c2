"""CPU tests of the plain reference: the field, the negacyclic product and
the degree-24 ring against Python-int schoolbook arithmetic, and the
rooflines against the byte counts of PERF.md's kernel table."""

import random

import pytest
import torch

from portbench import harness
from portbench.reference import cyclotomic24 as c24
from portbench.reference import goldilocks as gl
from portbench.reference.negacyclic import NegacyclicRef

Q = gl.Q
EDGE = [0, 1, 2, Q - 1, Q - 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1,
        1 << 63, (1 << 64) - (1 << 32) - 1, Q // 2, Q // 2 + 1]


def _ints(t):
    return [gl.to_int(int(v)) for v in t.reshape(-1)]


def _pairs(n, seed):
    rng = random.Random(seed)
    a = EDGE + [rng.randrange(Q) for _ in range(n)]
    b = EDGE[::-1] + [rng.randrange(Q) for _ in range(n)]
    return a, b


@pytest.mark.parametrize("op,ref", [
    ("mul", lambda x, y: x * y % Q), ("add", lambda x, y: (x + y) % Q),
    ("sub", lambda x, y: (x - y) % Q)])
def test_field_ops_match_python_ints(op, ref):
    a, b = _pairs(3000, 1)
    got = _ints(getattr(gl, op)(gl.tensor(a, "cpu"), gl.tensor(b, "cpu")))
    assert got == [ref(x, y) for x, y in zip(a, b)]


def test_sum_mod_matches_python_ints():
    rng = random.Random(2)
    rows = [[rng.choice([Q - 1, rng.randrange(Q)]) for _ in range(700)]
            for _ in range(4)]
    got = _ints(gl.sum_mod(torch.stack([gl.tensor(r, "cpu") for r in rows]),
                           1))
    assert got == [sum(r) % Q for r in rows]


def test_truncated_product_differs():
    a, b = _pairs(200, 3)
    ta, tb = gl.tensor(a, "cpu"), gl.tensor(b, "cpu")
    assert int((gl.mul(ta, tb, truncated=True) != gl.mul(ta, tb)).sum()) > 150


def _negacyclic(a, b):
    n = len(a)
    out = [0] * n
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < n:
                out[i + j] += x * y
            else:
                out[i + j - n] -= x * y
    return [v % Q for v in out]


@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_negacyclic_matches_schoolbook(log_n):
    n, rng = 1 << log_n, random.Random(log_n)
    a = [[rng.randrange(Q) for _ in range(n)] for _ in range(3)]
    b = [[rng.choice([Q - 1, rng.randrange(Q)]) for _ in range(n)]
         for _ in range(3)]
    ref = NegacyclicRef(n, "cpu")
    got = ref.mul(torch.stack([gl.tensor(r, "cpu") for r in a]),
                  torch.stack([gl.tensor(r, "cpu") for r in b]), block=2)
    for i in range(3):
        assert _ints(got[i]) == _negacyclic(a[i], b[i])


def _phi72_schoolbook(a, b):
    prod = [0] * 47
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            prod[i + j] += x * y
    # reduce with X^24 = X^12 - 1, highest degree first
    for d in range(46, 23, -1):
        prod[d - 12] += prod[d]
        prod[d - 24] -= prod[d]
    return [v % Q for v in prod[:24]]


def test_ring24_products_match_schoolbook():
    rng = random.Random(4)
    a = [[rng.randrange(Q) for _ in range(24)] for _ in range(5)]
    b = [[rng.randrange(Q) for _ in range(24)] for _ in range(5)]
    ring = c24.Cyclotomic24("cpu")
    at = torch.stack([gl.tensor(col, "cpu") for col in zip(*a)])
    bt = torch.stack([gl.tensor(col, "cpu") for col in zip(*b)])
    got = ring.coeff_mul(at, bt)
    via_slots = ring.icrt(ring.slot_mul(ring.crt(at), ring.crt(bt)))
    for i in range(5):
        want = _phi72_schoolbook(a[i], b[i])
        assert c24.coeff_mul_ints(a[i], b[i]) == want
        assert _ints(got[:, i]) == want
        assert _ints(via_slots[:, i]) == want


def test_ring24_crt_round_trip_and_psi_table():
    rng = random.Random(5)
    v = [rng.randrange(Q) for _ in range(24)]
    assert c24.icrt_ints(c24.crt_ints(v)) == v
    ring = c24.Cyclotomic24("cpu")
    # ct(psi * X^p) = p for p < 12: only digits 0..11 pass psi's check
    # over X^24 - X^12 + 1 (it is complete for power-of-two cyclotomics)
    assert ring.ct_psi[:12] == list(range(12))
    assert all(ring.ct_psi[p] != p for p in range(12, 24))


def test_fold_step_on_small_digits_passes_both_checks():
    """Witnesses whose folded coefficients are digits in [0, 12): L2 and
    psi hold; one negative digit fails psi alone."""
    ring = c24.Cyclotomic24("cpu")
    W, L, n, base, k = 2, 3, 2, 256, 8
    rng = random.Random(6)
    coeffs = torch.tensor([[[rng.randrange(0, 12) for _ in range(L)]
                            for _ in range(W)] for _ in range(24)])
    coeffs[0, 1, 0] = -1                     # witness 1 leaves psi's range
    s0 = ring.crt(torch.where(coeffs < 0, coeffs + gl.Q_W, coeffs))
    zero = torch.zeros_like
    at = torch.stack([gl.tensor([rng.randrange(Q) for _ in range(n * L * k)],
                                "cpu").reshape(n, L * k) for _ in range(24)])
    c0 = gl.tensor([rng.randrange(Q) for _ in range(24 * W * n)],
                   "cpu").reshape(24, W, n)
    out = c24.fold_step(ring, at, s0, zero(s0), c0, zero(c0),
                        gl.tensor([3] * 24, "cpu"), base, k,
                        L * k * 24 * (base // 2) ** 2)
    assert out["ok_l2"].tolist() == [True, True]
    assert out["ok_psi"].tolist() == [True, False]
    assert torch.equal(out["s"], s0) and torch.equal(out["c"], c0)
    norms = (coeffs * coeffs).sum(dim=(0, 2)).tolist()
    bound = sum(norms) // 2
    tight = c24.fold_step(ring, at, s0, zero(s0), c0, zero(c0),
                          gl.tensor([3] * 24, "cpu"), base, k, bound)
    assert tight["ok_l2"].tolist() == [x <= bound for x in norms]
    assert tight["ok_l2"].tolist() in ([True, False], [False, True])


# PERF.md's kernel table: bytes a launch at the benchmark's shapes
@pytest.mark.parametrize("kernel,args,bytes_", [
    # K1 untransposed at N = 2^16, B = 80: R = 256, cols = B t = 20,480
    ("fold_tw", (0, 20480, 0, 256, 0, 256, 20480, 0, 0), 210_239_488),
    # K3 at the same shape, and at the model shape [192, 65,536]: R = 24
    ("fold_end", (0, 20480, 0, 256, 20480, 0), 209_715_200),
    ("fold_end", (0, 65536, 0, 24, 65536, 0), 62_914_560),
    # pointwise_mul on [80, 2^16] words
    ("pointwise_mul", (0, 0, 0, 80 * 65536, 80 * 65536), 125_829_120),
])
def test_roofline_bytes_match_the_kernel_table(kernel, args, bytes_):
    assert harness.roofline_module(kernel).cost(args)["bytes"] == bytes_


def test_int_mm_roofline_counts_the_digit_gemm():
    c = harness.roofline_module("int_mm").cost([[2056, 2048], [2048, 20480]])
    assert c["ops"] * 6 == pytest.approx(1.035e12, rel=1e-3)
    assert c["bytes"] == 2056 * 2048 + 2048 * 20480 + 4 * 2056 * 20480
