"""CPU tests of BENCHMARK.json and of finding every piece by name."""

import copy
import json
import re
import uuid

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _lines_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(_lines_ok(w) for w in MAN["command"])
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in MAN[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          item["name"]))
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _lines_ok(w["why"])
    for c in MAN["configs"]:
        assert _lines_ok(c["source"]) and _lines_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_config_has_a_cell_and_every_cell_its_metrics():
    cells = {w["name"]: w for w in MAN["workloads"]}
    assert {c["name"] for c in MAN["configs"]} == {
        w["config"] for w in cells.values()}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(
        cells)
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for name in cells:
        c = harness.cell(name)
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported, (name, m["name"])
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells


def test_every_piece_is_found():
    for w in MAN["workloads"]:
        c = harness.cell(w["name"])
        assert (harness.BENCH / "entries"
                / f"{c.traffic['entry']}.py").is_file()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)
    layer_of = {}
    for m in MAN["per_layer"]:
        assert _lines_ok(m["layer"])
        # one quantity, one layer, letter for letter
        stem = m["name"].split(".")[0]
        assert layer_of.setdefault(stem, m["layer"]) == m["layer"]


def test_file_names_under_paths():
    for path in harness.BENCH.rglob("*"):
        rel = path.relative_to(harness.ROOT).as_posix()
        if "__pycache__" in rel:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_configs_match_their_files():
    for c in MAN["configs"]:
        data = harness.load_json(harness.ROOT / c["file"])
        assert data["name"] == c["name"]
        assert data["source"] == c["source"]
        assert data["reduced"] == {} and c["reduced"] == []
        assert c["file"].startswith("portbench/configs/")


def test_pieces_added_as_files_are_found(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a metric and a kernel roofline, each
    in a new file, are found by name without an edit to any file."""
    tag = uuid.uuid4().hex[:8]
    root = tmp_path
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir()
    (root / "portbench" / "metrics").mkdir()
    (root / "portbench" / "roofline").mkdir()
    cfg = {"name": f"gl-pow5-{tag}", "source": "test", "field": "goldilocks",
           "log_n": 5, "reduced": {}}
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    traffic = {"entry": "power_mul", "batch": 2, "pool": 2,
               "warmup_calls": 1, "check_calls": 2, "trace_calls": 2}
    (root / "portbench" / "traffic" / f"mul-B2-{tag}.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / f"calls_{tag}.py").write_text(
        "def read(st):\n    return st.calls\n")
    (root / "portbench" / "roofline" / f"k_{tag}.py").write_text(
        "def cost(args):\n    return {'ops': 0, 'bytes': 8 * args[0]}\n")
    man = copy.deepcopy(MAN)
    man["configs"].append({"name": cfg["name"], "source": "test",
                           "file": f"portbench/configs/{cfg['name']}.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": f"cell-{tag}", "config": cfg["name"],
                             "traffic": f"mul-B2-{tag}", "chips": 1,
                             "why": "test"})
    man["end_to_end"].append({"name": f"calls_{tag}", "unit": "calls",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": [f"cell-{tag}"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    c = harness.cell(f"cell-{tag}", root=root)
    assert c.config["log_n"] == 5 and c.traffic["batch"] == 2
    bench = root / "portbench"
    assert harness.metric_module(f"calls_{tag}", bench).read(
        harness.RunState(c, calls=7)) == 7
    assert harness.roofline_module(f"k_{tag}", bench).cost((3,))["bytes"] == 24
    assert harness.roofline_module(f"none_{tag}", bench) is None
    monkeypatch.setattr(harness, "metric_module",
                        lambda name, b=bench: (
                            harness.load_module(b / "metrics"
                                                / f"{name}.py")
                            if (b / "metrics" / f"{name}.py").is_file()
                            else harness.load_module(
                                harness.BENCH / "metrics"
                                / f"{name.split('.')[0]}.py")))
    out = harness.run(f"cell-{tag}", 5, 0.05, False, 0.0, device="cpu",
                      root=root)
    assert out["correct"]
    assert out["metrics"][f"calls_{tag}"]["value"] >= 1
    assert set(out["metrics"]) == {f"calls_{tag}", "call_p95_ms", "setup_s"}


def test_no_module_imports_jax_or_the_reference_package():
    import ast

    banned = set(harness.BANNED)
    for path in harness.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
                if path.parent.name == "reference":
                    assert n.split(".")[0] != harness.PROGRAM, (path, n)


@pytest.mark.parametrize("name,expected", [
    ("stark_rings_tpu_torch.ops.fold", []),
    ("stark_rings_tpu.ops", ["stark_rings_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]),
    ("flax.linen", ["flax"]),
    ("jaxtyping", []),
])
def test_banned_names_compare_whole_top_level_names(name, expected):
    assert harness.banned_modules(["torch", "numpy", name]) == expected
