"""The BabyBear D = 72 cell of the benchmark on the CPU: its plain
reference (``portbench/reference/babybear.py``, ``cyclotomic72.py``)
against the integer specs and against the port's ``FoldingStep``, its
entry and traffic at a small size, and K4's roofline file.

The reference is the yardstick of the cell's ``correct``: it has to
agree with the port word for word, and its half-width products (the
control) must not."""

import ast
import json
import pathlib
import random
import subprocess
import sys
import time
import types
from collections import Counter

import pytest
import torch

from portbench import harness
from portbench.reference import babybear as bb
from portbench.reference import cyclotomic72 as C
from stark_rings_tpu_torch import get_ring
from stark_rings_tpu_torch.ops import _build
from stark_rings_tpu_torch.ops.fold_bb import bb_fold_end
from stark_rings_tpu_torch.protocol.folding import FoldingStep

CELL = "bb72-L16384-fold-W16"
SEED = 2**31 + 24
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ring():
    return C.Cyclotomic72(torch.device("cpu"))


def _words(gen, shape):
    return torch.randint(0, bb.Q, shape, generator=gen, dtype=torch.int32)


def test_root_and_slots():
    """r is a primitive 24th root of unity, each slot map X -> r^a Y^t
    sends X^9 - r^k to 0, and the storage order is the 3 x 3 transpose."""
    assert pow(C.ROOT, 24, bb.Q) == 1
    assert all(pow(C.ROOT, 24 // p, bb.Q) != 1 for p in (2, 3))
    assert sorted(C.K_SLOTS) == [k for k in range(24) if k % 2 and k % 3]
    for k, (a, t) in zip(C.K_SLOTS, C.SLOT_MAPS):
        assert (9 * a + t - k) % 24 == 0 and t % 3
    assert [C.PERM[3 * (i % 3) + i // 3] for i in range(9)] == list(range(9))


@pytest.mark.parametrize("spec", ["port", "jax"])
def test_crt_is_the_models(spec):
    """The reference's CRT equals the integer spec's (the golden-vector
    anchor of both packages) on random and unit coefficients."""
    if spec == "port":
        from stark_rings_tpu_torch.spec import MODELS
        model = MODELS["babybear"]
    else:
        from stark_rings_tpu.spec import get_model
        model = get_model("babybear")
    rnd = random.Random(24)
    vecs = [[rnd.randrange(bb.Q) for _ in range(C.D)] for _ in range(3)]
    vecs += [[int(i == j) for i in range(C.D)] for j in (0, 1, 35, 36, 71)]
    for v in vecs:
        assert C.crt_ints(v) == model.crt(v)
        assert C.coeff_mul_ints(v, vecs[0]) == model.coeff_mul(v, vecs[0])


def test_crt_icrt_round_trip(ring):
    gen = torch.Generator().manual_seed(1)
    x = _words(gen, (C.D, 3, 5))
    y = ring.crt(x)
    assert not torch.equal(y, x.long())
    assert torch.equal(ring.icrt(y), x.long())
    assert torch.equal(ring.crt(ring.icrt(x)), x.long())


def test_slot_product_is_the_ring_product(ring):
    """crt(a b) = slot_mul(crt(a), crt(b)), the product the schoolbook
    multiply mod Phi_216 gives, also broadcast over a batch."""
    gen = torch.Generator().manual_seed(2)
    a, b = _words(gen, (C.D, 4)), _words(gen, (C.D, 4))
    ab = ring.coeff_mul(a, b)
    for j in range(4):
        want = C.coeff_mul_ints(bb.to_values(a[:, j]).tolist(),
                                bb.to_values(b[:, j]).tolist())
        assert bb.to_values(ab[:, j]).tolist() == want
    assert torch.equal(ring.slot_mul(ring.crt(a), ring.crt(b)), ring.crt(ab))
    one = b[:, :1]
    assert torch.equal(ring.slot_mul(ring.crt(a), ring.crt(one)),
                       ring.crt(ring.coeff_mul(a, one)))


def test_ct_psi_table(ring):
    """ct(psi X^p) = p for p <= 35 and never p above: psi passes a
    non-negative digit exactly when it is at most 35."""
    assert ring.ct_psi[:36] == list(range(36))
    assert all(ring.ct_psi[p] != p for p in range(36, C.D))
    a = torch.arange(0, 130)[None, None, :]
    ok = [bool(ring.psi_ok(a[:, :, i:i + 1])) for i in range(130)]
    assert ok == [i <= 35 for i in range(130)]


def test_truncated_products_differ(ring):
    gen = torch.Generator().manual_seed(3)
    a, b = _words(gen, (C.D, 64)), _words(gen, (C.D, 64))
    assert (bb.mul(a, b, True) != bb.mul(a, b)).float().mean() > 0.99
    assert not torch.equal(ring.crt(a, True), ring.crt(a))


def _small_step_inputs(n, L, W):
    """Witnesses [D, W, L] of four classes: small, small with one digit
    out of psi's range, heavy, heavy and out of range."""
    gen = torch.Generator().manual_seed(4)
    lo = torch.tensor([2, 2, 8, 8])[:W, None, None]
    hi = torch.tensor([5, 5, 9, 9])[:W, None, None]
    coeff = lo + torch.randint(0, 1 << 20, (W, C.D, L), generator=gen) % (
        hi - lo + 1)
    coeff[1, 5, 2] = coeff[3, 70, 7] = 60
    coeff = coeff.permute(1, 0, 2)
    ref = C.Cyclotomic72(torch.device("cpu"))

    def ntt(x):
        return ref.crt(bb.from_signed(x)).to(torch.int32)

    s1 = torch.randint(-1, 2, (C.D, W, L), generator=gen)
    r = torch.zeros(C.D, dtype=torch.int64)
    r[50] = -1
    return (ref, _words(gen, (C.D, n, L * 4)), ntt(coeff), ntt(s1),
            _words(gen, (C.D, W, n)), _words(gen, (C.D, W, n)),
            bb.from_signed(r).to(torch.int32))


@pytest.mark.parametrize("blocked", [False, True])
def test_port_step_matches_reference(monkeypatch, blocked):
    """The port's FoldingStep over babybear, word for word against
    ``cyclotomic72.fold_step``, its commit unblocked and in blocks of 5
    (ragged at M = 32); the classes split both checks 2/2."""
    n, L, W = 2, 8, 4
    bound = C.D * L * 41
    ref, at, s0, s1, c0, c1, r = _small_step_inputs(n, L, W)
    if blocked:
        monkeypatch.setattr(FoldingStep, "_COMMIT_BUDGET_WORDS",
                            C.D * C.E * W * n * 5)
    fs = FoldingStep(get_ring("babybear", device="cpu"), n, L, base=256, k=4,
                     l2_bound_sq=bound, psi_check=True)
    assert fs.commit_block(W) == (5 if blocked else 2**27 // (C.D * C.E * W
                                                                * n))
    out = fs.step({"Agt": at}, s0, s1, c0, c1, fs.precompute_challenge(r))
    want = C.fold_step(ref, at, s0, s1, c0, c1, r, 256, 4, bound)
    assert set(out) == set(want)
    for key, w in want.items():
        assert out[key].dtype == w.dtype and torch.equal(out[key], w), key
    assert want["ok_l2"].tolist() == [True, True, False, False]
    assert want["ok_psi"].tolist() == [True, False, True, False]
    control = C.fold_step(ref, at, s0, s1, c0, c1, r, 256, 4, bound, True)
    assert harness.mismatches(out, control)[0] > 0


def test_fold_mix_keeps_its_classes_at_the_cells_size():
    """At the cell's own sizes, the witnesses as dealt (call 2j + 1's
    folded ``s``) and with one challenge's product folded in (call
    2j's) fall into all four L2 x psi outcomes, four witnesses each, the
    same witnesses both times; every coefficient stays in [0, 129]."""
    e = harness.load_module(harness.BENCH / "entries"
                            / "folding_step_bb72.py")
    c = harness.cell(CELL)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    W, L = c.traffic["batch"], c.config["wit_len"]
    coeff = e.witnesses(gen, c.traffic["witness_classes"], (C.D, W, L), cpu)
    s1 = torch.randint(-1, 2, (C.D, W, L), generator=gen)
    r = e.challenges(gen, 1, cpu)[0, 0]
    ring = C.Cyclotomic72(cpu)
    seen = ([], [])
    for w in range(W):
        dealt = bb.from_signed(coeff[:, w:w + 1])
        folded = bb.add(dealt, ring.coeff_mul(
            r[:, None, None].expand(C.D, 1, L), bb.from_signed(s1[:, w:w + 1])))
        for got, x in zip(seen, (dealt, folded)):
            v = bb.to_values(x)
            assert int(v.max()) <= 129
            _, signed = ring.decompose(x, c.config["base"], c.config["k"])
            got.append((bool(ring.l2_ok(signed, c.config["l2_bound_sq"])),
                        bool(ring.psi_ok(signed))))
    assert seen[0] == seen[1]
    assert sorted(Counter(seen[0]).items()) == [
        ((a, b), 4) for a in (False, True) for b in (False, True)]


def _small():
    fold = harness.load_json(harness.BENCH / "traffic" / "fold-bb72-W16.json")
    classes = [dict(k, count=1, **({"planted": [40, 50]} if "planted" in k
                                   else {}))
               for k in fold["witness_classes"]]
    return {"config": {"n_rows": 2, "wit_len": 4,
                       "l2_bound_sq": C.D * 4 * 41},
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
    want = {"host_ms.fold_bb"} if trace else {"witnesses_per_s", "setup_s",
                                              "call_p95_ms"}
    assert want <= set(out["metrics"])


def test_the_cells_manifest_entries():
    """One configuration, one one-chip cell, the rate's list and five
    ``fold_bb`` metrics of the cell's own, each reader found."""
    c = harness.cell(CELL)
    assert c.chips == 1 and c.config["model"] == "babybear"
    assert c.config["reduced"] == {} and set(c.config["assumed"]) == {
        "n_rows", "wit_len", "base", "l2_bound_sq"}
    assert {m["name"] for m in c.end_to_end} == {
        "witnesses_per_s", "call_p95_ms", "setup_s"}
    own = sorted(m["name"] for m in c.per_layer)
    assert own == sorted(f"{s}.fold_bb" for s in (
        "host_ms", "torch_ops_ms", "idle_share", "digit_gemm_roofline",
        "hand_kernels_roofline"))
    for m in c.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "witnesses_per_s"
        assert callable(harness.metric_module(m["name"]).read)


@pytest.mark.parametrize("signed,k", [(False, 4), (True, 5)])
def test_bb_fold_end_roofline(monkeypatch, signed, k):
    """``roofline/bb_fold_end.py`` reads the wrapper's own launch
    arguments: 4 K R cols bytes of buckets and 4 R cols of output, K = 4
    unsigned and 5 signed; at the step's digit CRT, R = 72 over W M =
    1,048,576 columns."""
    launched = []
    monkeypatch.setattr(_build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        srt_bb_fold_end=None))
    monkeypatch.setattr(_build, "launch", lambda counts, name, fn, dev,
                        *args, stream=None: launched.append((name, args)))
    R, cols = 72, 24
    bb_fold_end(torch.zeros((k * R, cols), dtype=torch.int32), R,
                signed=signed)
    [(name, args)] = launched
    cost = harness.roofline_module(name).cost
    assert name == "bb_fold_end" and args[3:] == (R, cols, int(signed))
    assert cost(args) == {"ops": 0, "bytes": 4 * (k + 1) * R * cols}
    step = (0, 1 << 20, 0, 72, 1 << 20, int(signed))
    assert cost(step)["bytes"] == 4 * (k + 1) * 72 * (1 << 20)


def test_reference_imports_nothing_of_the_port():
    """The reference's modules name no module of the program or of
    JAX, and importing them (and the entry) loads none."""
    for name in ("babybear.py", "cyclotomic72.py"):
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
            "import portbench.reference.cyclotomic72;"
            "from portbench import harness;"
            "harness.load_module(harness.BENCH / 'entries'"
            " / 'folding_step_bb72.py');"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules"
            " if m.split('.')[0] in ('stark_rings_tpu_torch', "
            "'stark_rings_tpu', 'jax', 'jaxlib')})))")
    res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
