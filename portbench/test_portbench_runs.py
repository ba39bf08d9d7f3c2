"""CPU runs of every cell at a small size: the program passes the
comparison; the control (half-width products) and the program broken
underneath (its state returned unchanged, half of the batch left out, one
word of an answer altered, a check bit made constant) fail it.  A card
run is marked ``cuda``."""

import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.reference import goldilocks as gl


def _small_classes():
    """The fold mix's witness classes, one witness each, the planted
    values cut so that at L = 4 they still pass the L2 bound."""
    fold = harness.load_json(harness.BENCH / "traffic" / "fold-W16.json")
    return [dict(c, count=1, **({"planted": [14, 20]} if "planted" in c
                                else {}))
            for c in fold["witness_classes"]]


SMALL = {        # traffic mix -> the keys a CPU run shrinks
    "fold-W16": {"config": {"n_rows": 2, "wit_len": 4,
                            "l2_bound_sq": 24 * 4 * 41},
                 "traffic": {"batch": 4, "pool": 2, "challenges": 3,
                             "witness_classes": _small_classes(),
                             "warmup_calls": 2, "check_calls": 2,
                             "trace_calls": 2}},
    "mul-B80": {"config": {"log_n": 6},
                "traffic": {"batch": 4, "trace_calls": 3}},
    "mul_t-B262144": {"traffic": {"batch": 64, "trace_calls": 3}},
}
CONFIG_OF = {"fold-W16": "goldilocks-d24",
             "mul_t-B262144": "goldilocks-d24",
             "mul-B80": "goldilocks-pow2-16"}
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the manifest, configurations and traffic mixes with a
    cell for every traffic file, also one no cell of BENCHMARK.json uses
    yet."""
    import shutil

    root = tmp_path_factory.mktemp("bench")
    man = harness.manifest()
    cells = {w["traffic"]: w["name"] for w in man["workloads"]}
    for traffic, config in CONFIG_OF.items():
        if traffic not in cells:
            man["workloads"].append({"name": f"extra-{traffic}",
                                     "config": config, "traffic": traffic,
                                     "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for sub in ("configs", "traffic"):
        shutil.copytree(harness.BENCH / sub, root / "portbench" / sub)
    return root


def _cell(root, traffic):
    man = harness.manifest(root)
    return next(w["name"] for w in man["workloads"]
                if w["traffic"] == traffic)


def _run(root, traffic, program="program", trace=False, seed=SEED):
    return harness.run(_cell(root, traffic), seed, 0.1, trace,
                       time.perf_counter(), device="cpu",
                       overrides=SMALL[traffic], program=program, root=root)


def test_every_traffic_file_has_a_small_size():
    files = {p.stem for p in (harness.BENCH / "traffic").glob("*.json")}
    assert set(SMALL) == files == set(CONFIG_OF)


@pytest.mark.parametrize("traffic", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_program_passes(root, traffic, trace):
    out = _run(root, traffic, trace=trace)
    assert out["correct"] and out["failed"] == 0
    assert out["check"]["mismatched_words"] == {"value": 0, "limit": 0}
    assert list(out)[-1] == "check"
    c = harness.cell(_cell(root, traffic), root=root)
    want = c.per_layer if trace else c.end_to_end
    # on the CPU no device metric has anything to read
    host = {m["name"] for m in want if m["source"] == "host_clock"}
    assert host <= set(out["metrics"])
    if trace:
        assert "breakdown" in out and "busy_s" in out["device"]


@pytest.mark.parametrize("traffic", sorted(SMALL))
def test_control_fails(root, traffic):
    out = _run(root, traffic, program="control")
    assert not out["correct"]
    assert out["check"]["mismatched_words"]["value"] > 0


def _break_mul(kind):
    def broken(orig):
        def call(self, a, b, *rest):
            if kind == "unchanged":
                return a
            h = a.shape[-1] // 2 if a.shape[0] == 24 else a.shape[0] // 2
            if kind == "half":
                if a.shape[0] == 24:               # [D, B]: batch trails
                    return torch.cat([orig(self, a[:, :h], b[:, :h]),
                                      a[:, h:]], dim=1)
                return torch.cat([orig(self, a[:h], b[:h]), a[h:]])
            out = orig(self, a, b).clone()
            out.view(-1)[3] ^= 1
            return out
        return call
    return broken


def _break_step(kind):
    def broken(orig):
        def step(self, c, s0t, s1t, c0t, c1t, rt):
            out = orig(self, c, s0t, s1t, c0t, c1t, rt)
            if kind == "unchanged":
                out["s"], out["cd"] = s0t, c0t
            elif kind in CONSTANT_BITS:
                bit, value = CONSTANT_BITS[kind]
                out[bit] = torch.full_like(out[bit], value)
            elif kind == "psi_is_l2":
                out["ok_psi"] = out["ok_l2"].clone()
            elif kind == "half":
                h = s0t.shape[1] // 2
                out["s"] = torch.cat([out["s"][:, :h], s0t[:, h:]], dim=1)
            else:
                out["cd"] = out["cd"].clone()
                out["cd"].view(-1)[5] ^= 1
            return out
        return step
    return broken


TARGETS = {
    "fold-W16": ("stark_rings_tpu_torch.protocol.folding", "FoldingStep",
                 "step", _break_step),
    "mul-B80": ("stark_rings_tpu_torch.ops.fold", "Mxu2KernelNTT", "mul",
                _break_mul),
    "mul_t-B262144": ("stark_rings_tpu_torch.ops.model_mul", "TModelMul",
                      "mul_t", _break_mul),
}
CONSTANT_BITS = {"l2_true": ("ok_l2", True), "l2_false": ("ok_l2", False),
                 "psi_true": ("ok_psi", True),
                 "psi_false": ("ok_psi", False)}


@pytest.mark.parametrize("traffic", sorted(SMALL))
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_program_fails(root, monkeypatch, traffic, kind):
    import importlib

    mod_name, cls_name, meth, breaker = TARGETS[traffic]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    monkeypatch.setattr(cls, meth, breaker(kind)(getattr(cls, meth)))
    out = _run(root, traffic)
    assert not out["correct"]
    assert out["check"]["mismatched_words"]["value"] > 0


@pytest.mark.parametrize("kind", sorted(CONSTANT_BITS) + ["psi_is_l2"])
def test_fold_check_bit_faults_fail(root, monkeypatch, kind):
    """A step whose L2 or psi check returns a constant, or psi's bit
    for L2's, fails: the mix holds witnesses on both sides of each
    check."""
    import importlib

    mod_name, cls_name, meth, breaker = TARGETS["fold-W16"]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    monkeypatch.setattr(cls, meth, breaker(kind)(getattr(cls, meth)))
    out = _run(root, "fold-W16")
    assert not out["correct"]
    assert out["check"]["mismatched_words"]["value"] > 0


def test_fold_mix_splits_both_checks_at_the_cells_size():
    """At the cell's own sizes, the witnesses as dealt (call 2j + 1's
    folded ``s``) and with one challenge's product folded in (call
    2j's) fall into all four L2 x psi outcomes, four witnesses each,
    the same witnesses both times.  Witness by witness, so that the
    digits of one witness at a time are held."""
    from collections import Counter

    from portbench.reference.cyclotomic24 import D, Cyclotomic24

    e = harness.load_module(harness.BENCH / "entries" / "folding_step.py")
    c = harness.cell("gl24-L16384-fold-W16")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    W, L = c.traffic["batch"], c.config["wit_len"]
    s0 = e._words(e.witnesses(gen, c.traffic["witness_classes"], (D, W, L),
                              cpu))
    s1 = e._words(e._uniform(gen, -1, 1, (D, W, L), cpu))
    r = e.challenges(gen, 1, cpu)[0, 0]
    ring = Cyclotomic24(cpu)
    seen = ([], [])
    for w in range(W):
        dealt = s0[:, w:w + 1]
        folded = gl.add(dealt, ring.coeff_mul(
            r[:, None, None].expand(D, 1, L), s1[:, w:w + 1]))
        for got, coeff in zip(seen, (dealt, folded)):
            _, signed = ring.decompose(coeff, c.config["base"],
                                       c.config["k"])
            got.append((bool(ring.l2_ok(signed, c.config["l2_bound_sq"])),
                        bool(ring.psi_ok(signed))))
    assert seen[0] == seen[1]
    assert sorted(Counter(seen[0]).items()) == [
        ((a, b), 4) for a in (False, True) for b in (False, True)]


def test_same_seed_same_inputs():
    e = harness.load_module(harness.BENCH / "entries" / "power_mul.py")
    c = harness.cell("gl-pow16-mul-B80", SMALL["mul-B80"])
    one = e.Entry(c.config, c.traffic, SEED, torch.device("cpu"), "control")
    two = e.Entry(c.config, c.traffic, SEED, torch.device("cpu"), "control")
    three = e.Entry(c.config, c.traffic, SEED + 1, torch.device("cpu"),
                    "control")
    assert torch.equal(one.a, two.a) and torch.equal(one.pool, two.pool)
    assert not torch.equal(one.a, three.a)


def test_run_loads_no_banned_module():
    """In a fresh process: the harness and the program, run on the CPU,
    load no module whose top-level name is banned."""
    code = (
        "import json, sys, time; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness;"
        f"small = json.loads({json.dumps(json.dumps(SMALL))});"
        "out = harness.run('gl-pow16-mul-B80', 3, 0.05, True,"
        " time.perf_counter(), device='cpu', overrides=small['mul-B80']);"
        "print(json.dumps([out['correct'], harness.banned_modules(),"
        " 'stark_rings_tpu_torch' in sys.modules]))")
    res = subprocess.run([sys.executable, "-c", code,
                          str(harness.ROOT)], capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_run_refuses_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and portbench/ prints no
    result and exits non-zero."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "gl-pow16-mul-B80", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_on_the_card(card, cell):
    root = pathlib.Path(harness.ROOT)
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          cell, "--seed", str(SEED), "--seconds", "2",
                          "--trace", "1"], cwd=root, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
