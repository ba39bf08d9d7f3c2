"""The PyTorch port stands without JAX, and has no CPU fallback for the
card: its modules import with JAX blocked, and chip_smoke.py fails
where no CUDA card is present."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import sys

for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "stark_rings_tpu")]:
    del sys.modules[name]


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "stark_rings_tpu"):
            raise ImportError("blocked import of " + name)
        return None


sys.meta_path.insert(0, Block())
import stark_rings_tpu_torch
import stark_rings_tpu_torch.ops.fold
import stark_rings_tpu_torch.ops._build
import stark_rings_tpu_torch.native.host
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "stark_rings_tpu")]
assert not leaked, leaked
print("imported without jax")
"""


def test_port_imports_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported without jax" in proc.stdout


def test_port_sources_never_import_jax():
    for path in (ROOT / "stark_rings_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in (
                    "jax", "jaxlib", "stark_rings_tpu"), (path, line)
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "stark_rings_tpu." not in smoke


def test_chip_smoke_fails_without_cuda():
    """This machine has no CUDA card: the script must fail and print no
    result (no CPU fallback)."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr
