"""The stark_prime D = 16 cell of the benchmark on the CPU: its plain
reference (``portbench/reference/stark.py``, ``cyclotomic16.py``)
against Python ints, the integer specs and the port's ``FoldingStep``,
its entry and traffic at a small size and the mix at the cell's own
size, the cell's manifest entries, the rooflines of S1-S3, and the
trace's classing of every kernel of ``csrc/stark.cu``.

The reference is the yardstick of the cell's ``correct``: it has to
agree with the port word for word, and its half-width products (the
control) must not."""

import ast
import json
import pathlib
import random
import re
import subprocess
import sys
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from portbench import harness
from portbench import trace as tr
from portbench.reference import cyclotomic16 as C
from portbench.reference import stark as sk
from stark_rings_tpu_torch import get_ring
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops import stark as ST
from stark_rings_tpu_torch.protocol.folding import FoldingStep
from stark_rings_tpu_torch.rings.monomial import psi_range_check_batched

CELL = "stark16-L16384-fold-W16"
SEED = 2**31 + 28
REPO = pathlib.Path(__file__).resolve().parents[1]
Q, R = sk.Q, sk.R
EDGES = [0, 1, 2, Q - 1, Q - 2, (Q - 1) // 2, (Q + 1) // 2, Q - 2**192,
         Q - 2**192 + 7, Q - 17 * 2**192 - 1, 2**251 - 1, 2**251, R]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ring():
    return C.Cyclotomic16(CPU)


def _values(n, seed):
    rnd = random.Random(seed)
    return EDGES + [rnd.randrange(Q) for _ in range(n)]


@pytest.mark.parametrize("op", ["mul", "add", "sub", "truncated"])
def test_field_ops_against_python_ints(op):
    """Products, sums and differences mod q of random 252-bit values and
    every pair of edge values (0, 1, q - 1, values at or above
    q - 2^192); the half-width product differs on almost every random
    pair."""
    a = _values(200, 1)
    b = _values(200, 2)[::-1]
    pairs = [(x, y) for x in EDGES for y in EDGES] + list(zip(a, b))
    xs, ys = (sk.to_limbs([p[i] for p in pairs]) for i in (0, 1))
    if op == "truncated":
        bad = (sk.mul(xs, ys, True) != sk.mul(xs, ys)).any(dim=-1)
        rand = bad[len(EDGES) * (len(EDGES) + 1):-len(EDGES)]
        assert rand.numel() == 187 and bool(rand.all())
        return
    got = sk.from_limbs(getattr(sk, op)(xs, ys))
    fn = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    assert got == [fn(x, y) % Q for x, y in pairs]


def test_reduce_takes_wide_signed_columns():
    """Any signed base-2^16 columns below 2^61 in size reduce to their
    value mod q, as do small signed integers."""
    gen = torch.Generator().manual_seed(5)
    for width in (1, 3, 16, 31, 40):
        cols = torch.randint(-2**60, 2**60, (50, width), generator=gen)
        want = [sum(int(c) << (16 * j) for j, c in enumerate(r)) % Q
                for r in cols.tolist()]
        assert sk.from_limbs(sk.reduce(cols, 61)) == want
    x = torch.tensor([0, 1, -1, 2**46 - 1, -2**46 + 1, -32768, 32768])
    assert sk.from_limbs(sk.from_signed(x)) == [v % Q for v in x.tolist()]


def test_storage_conversion():
    """Storage is the value times 2^256 mod q in eight u32 limbs (int32
    bits): both ways, at the edges and at random values; the port's
    encoding gives the same words."""
    from stark_rings_tpu_torch.fields import STARK

    vals = _values(100, 3)
    st = sk.value_storage(sk.to_limbs(vals))
    assert st.dtype == torch.int32 and st.shape == (len(vals), 8)
    assert sk.from_limbs(sk.from_storage(st)) == [v * R % Q for v in vals]
    assert sk.from_limbs(sk.to_values(st)) == vals
    port = STARK.encode(np.array(vals, dtype=object), "cpu")
    assert torch.equal(st, port)
    table = sk.signed_storage_table(-3, 3, CPU)
    assert torch.equal(table, sk.value_storage(sk.from_signed(
        torch.arange(-3, 4))))


@pytest.mark.parametrize("spec", ["port", "jax"])
def test_crt_is_the_models(spec):
    """The reference's CRT equals the integer spec's (the golden-vector
    anchor of both packages) on random and unit coefficients, and its
    negacyclic product the spec's."""
    if spec == "port":
        from stark_rings_tpu_torch.spec import MODELS
        model = MODELS["stark_prime"]
    else:
        from stark_rings_tpu.spec import get_model
        model = get_model("stark_prime")
    rnd = random.Random(16)
    vecs = [[rnd.randrange(Q) for _ in range(C.D)] for _ in range(3)]
    vecs += [[int(i == j) for i in range(C.D)] for j in (0, 1, 8, 15)]
    for v in vecs:
        assert C.crt_ints(v) == model.crt(v)
        assert C.coeff_mul_ints(v, vecs[0]) == model.coeff_mul(v, vecs[0])


def _storage(gen, shape):
    x = torch.randint(0, 1 << 16, shape + (sk.N,), generator=gen)
    x[..., sk.N - 1] &= 0x3FF                      # below 2^250 < q
    return sk.to_storage(x)


def test_crt_icrt_round_trip(ring):
    gen = torch.Generator().manual_seed(1)
    x = _storage(gen, (C.D, 3, 5))
    y = ring.crt(x)
    assert not torch.equal(y, x)
    assert torch.equal(ring.icrt(y), x)
    assert torch.equal(ring.crt(ring.icrt(x)), x)
    assert not torch.equal(ring.crt(x, True), y)
    small = torch.randint(-5, 6, (C.D, 2, 3), generator=gen)
    assert torch.equal(ring.ntt_of_signed(small), ring.crt(
        sk.value_storage(sk.from_signed(small))))


def test_slot_product_is_the_ring_product(ring):
    """crt(a) * crt(b) slot by slot is the CRT of the negacyclic
    schoolbook product of a and b in Python ints, also broadcast."""
    gen = torch.Generator().manual_seed(2)
    a, b = _storage(gen, (C.D, 4)), _storage(gen, (C.D, 4))
    av = [sk.from_limbs(sk.to_values(a[:, j])) for j in range(4)]
    bv = [sk.from_limbs(sk.to_values(b[:, j])) for j in range(4)]
    got = ring.icrt(ring.slot_mul(ring.crt(a), ring.crt(b)))
    for j in range(4):
        assert sk.from_limbs(sk.to_values(got[:, j])) == \
            C.coeff_mul_ints(av[j], bv[j])
    one = ring.slot_mul(ring.crt(a), ring.crt(b[:, :1]))
    assert torch.equal(one[:, 1:2], ring.slot_mul(ring.crt(a[:, 1:2]),
                                                  ring.crt(b[:, :1])))


def test_psi_passes_exactly_the_digits_up_to_seven(ring):
    """At D = 16 the reference's psi and the port's psi range check both
    pass a digit exactly when it lies in [-7, 7] (the mix plants 16 and
    more), on every digit in [-40, 40]."""
    assert ring.ct_psi[:8] == list(range(8))
    digits = torch.arange(-40, 41)
    ok = [bool(ring.psi_ok(digits[i:i + 1].reshape(1, 1, 1)))
          for i in range(digits.numel())]
    assert ok == [-7 <= d <= 7 for d in digits.tolist()]
    port = get_ring("stark_prime", device="cpu")
    words = sk.value_storage(sk.from_signed(digits))
    assert psi_range_check_batched(port, words).tolist() == ok


def _small_step_inputs(ring, n, L, W):
    """Witnesses [D, W, L] of four classes: small, small with one digit
    out of psi's range, heavy, heavy and out of range."""
    gen = torch.Generator().manual_seed(4)
    lo = torch.tensor([1, 1, 5, 5])[None, :W, None]
    hi = torch.tensor([3, 3, 6, 6])[None, :W, None]
    coeff = lo + torch.randint(0, 1 << 20, (C.D, W, L), generator=gen) % (
        hi - lo + 1)
    coeff[5, 1, 2] = 9
    coeff[13, 3, 1] = 12
    r = torch.zeros(C.D, dtype=torch.int64)
    r[11] = -1
    return (_storage(gen, (C.D, n, L * 16)), ring.ntt_of_signed(coeff),
            ring.ntt_of_signed(torch.randint(-1, 2, (C.D, W, L),
                                             generator=gen)),
            _storage(gen, (C.D, W, n)), _storage(gen, (C.D, W, n)),
            sk.value_storage(sk.from_signed(r)))


@pytest.mark.parametrize("blocked", [False, True])
def test_port_step_matches_reference(ring, monkeypatch, blocked):
    """The port's FoldingStep over stark_prime at n = 2, L = 4, W = 4,
    base 2^16, k = 16, psi on, word for word against
    ``cyclotomic16.fold_step``, its commit unblocked and in blocks of 5
    (ragged at M = 64); the classes split both checks 2/2, and the
    control differs."""
    n, L, W = 2, 4, 4
    bound = C.D * L * 18
    at, s0, s1, c0, c1, r = _small_step_inputs(ring, n, L, W)
    per = C.D * W * n * 8
    if blocked:
        monkeypatch.setattr(FoldingStep, "_COMMIT_BUDGET_WORDS", per * 5)
    fs = FoldingStep(get_ring("stark_prime", device="cpu"), n, L,
                     base=1 << 16, k=16, l2_bound_sq=bound, psi_check=True)
    assert fs.commit_block(W) == (5 if blocked else 2**27 // per)
    out = fs.step({"Agt": at}, s0, s1, c0, c1, fs.precompute_challenge(r))
    want = C.fold_step(ring, at, s0, s1, c0, c1, r, 1 << 16, 16, bound)
    assert set(out) == set(want)
    for key, w in want.items():
        assert out[key].dtype == w.dtype and torch.equal(out[key], w), key
    assert want["ok_l2"].tolist() == [True, True, False, False]
    assert want["ok_psi"].tolist() == [True, False, True, False]
    control = C.fold_step(ring, at, s0, s1, c0, c1, r, 1 << 16, 16, bound,
                          True)
    assert harness.mismatches(out, control)[0] > 0


def test_fold_mix_keeps_its_classes_at_the_cells_size(ring):
    """At the cell's own sizes, the witnesses as dealt (call 2j + 1's
    folded ``s``) and with one challenge's product folded in (call
    2j's) fall into all four L2 x psi outcomes, four witnesses each, the
    same witnesses both times; every coefficient stays in [0, 128]."""
    e = harness.load_module(harness.BENCH / "entries"
                            / "folding_step_stark16.py")
    c = harness.cell(CELL)
    gen = torch.Generator().manual_seed(SEED)
    W, L = c.traffic["batch"], c.config["wit_len"]
    coeff = e.witnesses(gen, c.traffic["witness_classes"], (C.D, W, L), CPU)
    s1 = torch.randint(-1, 2, (C.D, W, L), generator=gen)
    a, sign = 11, -1                          # r = -X^11
    rs1 = sign * torch.cat([-s1[C.D - a:], s1[:C.D - a]])   # X^16 = -1
    seen = ([], [])
    for w in range(W):
        for got, x in zip(seen, (coeff[:, w:w + 1],
                                 coeff[:, w:w + 1] + rs1[:, w:w + 1])):
            assert 0 <= int(x.min()) and int(x.max()) <= 128
            sd = ring.decompose(sk.from_signed(x), c.config["base"],
                                c.config["k"])
            got.append((bool(ring.l2_ok(sd, c.config["l2_bound_sq"])),
                        bool(ring.psi_ok(sd))))
    assert seen[0] == seen[1]
    assert sorted(Counter(seen[0]).items()) == [
        ((a, b), 4) for a in (False, True) for b in (False, True)]


def _small():
    fold = harness.load_json(harness.BENCH / "traffic"
                             / "fold-stark16-W16.json")
    classes = [dict(k, count=1, **({"planted": [9, 12]} if "planted" in k
                                   else {}))
               for k in fold["witness_classes"]]
    return {"config": {"n_rows": 2, "wit_len": 4,
                       "l2_bound_sq": C.D * 4 * 18},
            "traffic": {"batch": 4, "pool": 2, "challenges": 3,
                        "witness_classes": classes, "warmup_calls": 2,
                        "check_calls": 2, "trace_calls": 2}}


@pytest.mark.parametrize("program,trace", [("program", False),
                                           ("program", True),
                                           ("control", False)])
def test_entry_runs_on_the_cpu(program, trace):
    """The cell's entry at a small size, two warm-up calls and a window
    of one or more: the port passes the comparison, the control fails
    it."""
    out = harness.run(CELL, SEED, 0.05, trace, time.perf_counter(),
                      device="cpu", overrides=_small(), program=program)
    assert out["attempted"] >= 1 + 2 * trace
    bad = out["check"]["mismatched_words"]["value"]
    assert out["correct"] == (program == "program") == (bad == 0)
    want = {"host_ms.fold_stark"} if trace else {
        "witnesses_per_s", "setup_s", "call_p95_ms"}
    assert want <= set(out["metrics"])


def test_the_cells_manifest_entries():
    """One configuration, one one-chip cell, the rate's list and five
    ``fold_stark`` metrics of the cell's own, each reader found."""
    man = harness.manifest()
    c = harness.cell(CELL)
    wl = harness.by_name(man["workloads"], CELL, "workload")
    assert (wl["config"], wl["traffic"], c.chips) == (
        "stark-d16", "fold-stark16-W16", 1)
    cfg = harness.by_name(man["configs"], "stark-d16", "config")
    assert cfg["file"] == "portbench/configs/stark-d16.json"
    assert cfg["reduced"] == [] and c.config["reduced"] == {}
    assert c.config["model"] == "stark_prime" and int(c.config["q"]) == Q
    assert (c.config["n_rows"], c.config["wit_len"], c.config["base"],
            c.config["k"], c.config["l2_bound_sq"]) == (
        8, 16384, 1 << 16, 16, 4718592)
    assert set(c.config["assumed"]) == {"n_rows", "wit_len", "base",
                                        "l2_bound_sq"}
    assert {m["name"] for m in c.end_to_end} == {
        "witnesses_per_s", "call_p95_ms", "setup_s"}
    own = sorted(m["name"] for m in c.per_layer)
    assert own == sorted(f"{s}.fold_stark" for s in (
        "host_ms", "torch_ops_ms", "idle_share", "digit_gemm_roofline",
        "hand_kernels_roofline"))
    for m in c.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "witnesses_per_s"
        assert callable(harness.metric_module(m["name"]).read)
    t = c.traffic
    assert (t["entry"], t["batch"], t["pool"], t["challenges"],
            t["warmup_calls"], t["check_calls"], t["trace_calls"]) == (
        "folding_step_stark16", 16, 8, 64, 3, 2, 5)


def _recorded(monkeypatch):
    launched = []
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        **{f"srt_{n}": None for n in ST.LAUNCHES}))
    monkeypatch.setattr(_build, "launch", lambda counts, name, fn, dev,
                        *args, stream=None: launched.append((name, args)))
    return launched


@pytest.mark.parametrize("op", ["stark_mul", "stark_add", "stark_sub"])
def test_stark_binary_rooflines(monkeypatch, op):
    """``roofline/stark_*.py`` read the wrappers' own launch arguments:
    a and the result [rows, 8] and b [b_rows, 8] once, 32 bytes a row;
    operations the SASS instructions of a row."""
    launched = _recorded(monkeypatch)
    a = torch.zeros((5, 7, 8), dtype=torch.int32)
    getattr(ST, op)(a, a[0])                    # b broadcast: 7 rows
    getattr(ST, op)(a, a)
    [(n1, args1), (n2, args2)] = launched
    assert n1 == n2 == op
    cost = harness.roofline_module(op).cost
    ins = {"stark_mul": 604, "stark_add": 208, "stark_sub": 191}[op]
    assert (args1[2], args1[4]) == (7, 35)
    assert cost(args1) == {"ops": ins * 35, "bytes": 32 * (2 * 35 + 7)}
    assert cost(args2)["bytes"] == 32 * 3 * 35
    # the cell's challenge product, [16, 16, 16,384] x [16, 1, 1]
    rows = 16 * 16 * 16384
    assert cost((0, 0, 16, 0, rows))["bytes"] == 32 * (2 * rows + 16)


@pytest.mark.parametrize("signed,k", [(False, 32), (True, 33)])
def test_limb_fold_roofline(monkeypatch, signed, k):
    """``roofline/limb_fold.py``: 4 K R cols bytes of buckets and 32 R
    cols of limbs, K = 32 unsigned and 33 signed."""
    launched = _recorded(monkeypatch)
    R, cols = 16, 24
    ST.limb_fold(torch.zeros((k * R, cols), dtype=torch.int32), R,
                 signed=signed)
    [(name, args)] = launched
    assert name == "limb_fold" and args[2:5] == (R, cols, int(signed))
    assert harness.roofline_module(name).cost(args) == {
        "ops": 535 * R * cols, "bytes": (4 * k + 32) * R * cols}


def _program_launch_names():
    import stark_rings_tpu_torch.mle.fix  # noqa: F401
    import stark_rings_tpu_torch.mle.sumcheck_kernel  # noqa: F401
    import stark_rings_tpu_torch.ops.digits  # noqa: F401
    import stark_rings_tpu_torch.ops.fold  # noqa: F401
    import stark_rings_tpu_torch.ops.fold_bb  # noqa: F401
    import stark_rings_tpu_torch.ops.goldilocks_ntt  # noqa: F401
    import stark_rings_tpu_torch.ops.mxu_fused  # noqa: F401
    import stark_rings_tpu_torch.ops.slot  # noqa: F401
    import stark_rings_tpu_torch.ops.slot_bb  # noqa: F401
    import stark_rings_tpu_torch.parallel.exchange  # noqa: F401
    return set(tr.launch_counters())


def test_trace_classes_every_stark_kernel():
    """Every ``__global__`` of ``csrc/stark.cu`` has a base name (the
    trace's ``kernel_base``) that begins with its own launch name of
    ``ops/stark.py`` and with no other launch name of the program, so the
    trace's rule (``_hand_name``) classes it; every launch name of
    ``ops/stark.py`` has its kernel.  The names the profiler records are
    held to the same rule on the card (``tests/test_torch_cuda.py``)."""
    src = (REPO / "stark_rings_tpu_torch" / "csrc" / "stark.cu").read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(", src)
    names = _program_launch_names()
    assert set(ST.LAUNCHES) <= names
    got = []
    for k in kernels:
        base = tr.kernel_base(k)
        assert [n for n in names if base.startswith(n)] == [base], k
        assert tr._hand_name(k, names) == base, k
        got.append(base)
    assert sorted(got) == sorted(ST.LAUNCHES)


def test_reference_imports_nothing_of_the_port():
    """The reference's modules name no module of the program or of
    JAX, and importing them (and the entry) loads none."""
    for name in ("stark.py", "cyclotomic16.py"):
        tree = ast.parse((harness.BENCH / "reference" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(m.split(".")[0] in ("torch", "__future__")
                       for m in mods), (name, mods)
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.reference.cyclotomic16;"
            "from portbench import harness;"
            "harness.load_module(harness.BENCH / 'entries'"
            " / 'folding_step_stark16.py');"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0] in ('stark_rings_tpu_torch', "
            "'stark_rings_tpu', 'jax', 'jaxlib')})))")
    res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
