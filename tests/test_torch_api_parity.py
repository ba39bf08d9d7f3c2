"""Method-level API parity of the port with the reference: every public
method and class attribute of every public class of
``stark_rings_tpu/``, its inherited ones included, exists on the port's
counterpart class, inherited or its own (``hasattr`` on the imported
class; a dataclass field counts as an attribute).

The reference is read with ``ast``, so this needs no JAX import.  The
only differences allowed are the class renames of ``RENAMES``.  Classes
of the reference's Pallas modules live in the port's kernel modules
(``HOMES``), and the reference's ``fields.field.Field`` is the port's
``fields.Field``."""

import ast
import dataclasses
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "stark_rings_tpu"

RENAMES = {"Mxu2PallasNTT": "Mxu2FusedNTT", "MxuBBPallasNTT": "MxuBBFusedNTT",
           "GoldilocksPallasNTT": "GoldilocksKernelNTT",
           "MxuModMatPallas": "MxuModMatFused"}
# reference module (below the package) -> the port's module of its classes
HOMES = {"fields.field": "fields", "ops.pallas_fold": "ops.fold",
         "ops.pallas_fold_bb": "ops.fold_bb",
         "ops.pallas_goldilocks": "ops.goldilocks_ntt",
         "ops.pallas_mxu": "ops.mxu_fused"}


def _public(names):
    return {n for n in names if not n.startswith("_")}


def _parse():
    """{(module, class): (own public members, bases as (module, class))}
    over every module of the reference."""
    classes = {}
    for path in sorted(REF.rglob("*.py")):
        parts = path.relative_to(REF).with_suffix("").parts
        is_pkg = parts[-1] == "__init__"
        mod = ".".join(parts[:-1] if is_pkg else parts)
        pkg = mod.split(".") if is_pkg else mod.split(".")[:-1]
        tree = ast.parse(path.read_text())
        imported = {}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                src = ".".join(base + ([node.module] if node.module else []))
                for alias in node.names:
                    imported[alias.asname or alias.name] = (src, alias.name)
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            own = set()
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    own.add(item.name)
                elif isinstance(item, ast.Assign):
                    own |= {t.id for t in item.targets
                            if isinstance(t, ast.Name)}
                elif isinstance(item, ast.AnnAssign) \
                        and isinstance(item.target, ast.Name):
                    own.add(item.target.id)
            bases = [imported.get(b.id, (mod, b.id)) for b in node.bases
                     if isinstance(b, ast.Name)]
            classes[(mod, node.name)] = (_public(own), bases)
    return classes


CLASSES = _parse()
PUBLIC = sorted(k for k in CLASSES if not k[1].startswith("_"))


def _members(key):
    own, bases = CLASSES.get(key, (set(), []))
    out = set(own)
    for base in bases:
        out |= _members(base)
    return out


def _port_class(mod, name):
    port = importlib.import_module(
        "stark_rings_tpu_torch" + ("." if mod else "")
        + HOMES.get(mod, mod))
    return getattr(port, RENAMES.get(name, name))


@pytest.mark.parametrize("mod,name", PUBLIC,
                         ids=[f"{m}.{n}" for m, n in PUBLIC])
def test_public_class_has_every_reference_member(mod, name):
    cls = _port_class(mod, name)
    fields = ({f.name for f in dataclasses.fields(cls)}
              if dataclasses.is_dataclass(cls) else set())
    missing = sorted(m for m in _members((mod, name))
                     if not hasattr(cls, m) and m not in fields)
    assert not missing, f"{cls.__module__}.{cls.__name__} lacks {missing}"


def test_the_check_covers_the_reference():
    """The parse finds the reference's classes and their inherited
    members (a broken parse would pass vacuously)."""
    assert len(PUBLIC) >= 40
    assert sum(len(_members(k)) for k in PUBLIC) >= 400
    fused = _members(("ops.pallas_fold", "Mxu2PallasNTT"))
    assert {"jit_mul", "staged_mul", "mul_cached", "forward"} <= fused
    for name in RENAMES:
        assert any(n == name for _, n in PUBLIC), name
