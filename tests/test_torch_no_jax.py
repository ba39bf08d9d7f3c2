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
import numpy as np
import stark_rings_tpu_torch
import stark_rings_tpu_torch.ops.fold
import stark_rings_tpu_torch.ops.fold_bb
import stark_rings_tpu_torch.ops.goldilocks_ntt
import stark_rings_tpu_torch.ops.mxu
import stark_rings_tpu_torch.ops.mxu_fused
import stark_rings_tpu_torch.ops.mxu_bb
import stark_rings_tpu_torch.ops.ntt
import stark_rings_tpu_torch.ops._build
import stark_rings_tpu_torch.rings.power
import stark_rings_tpu_torch.native.host
import stark_rings_tpu_torch.parallel
import stark_rings_tpu_torch.parallel.exchange
import stark_rings_tpu_torch.parallel.mesh
import stark_rings_tpu_torch.parallel.ntt
import stark_rings_tpu_torch.linalg
import stark_rings_tpu_torch.mle
import stark_rings_tpu_torch.mle.fix
import stark_rings_tpu_torch.mle.mxu_eval
import stark_rings_tpu_torch.mle.sumcheck
import stark_rings_tpu_torch.mle.sumcheck_kernel
import stark_rings_tpu_torch.rings.absorb
import stark_rings_tpu_torch.examples.sumcheck
import stark_rings_tpu_torch.spec
import stark_rings_tpu_torch.spec.decomp
import stark_rings_tpu_torch.rings.ring
import stark_rings_tpu_torch.rings.element
import stark_rings_tpu_torch.rings.monomial
import stark_rings_tpu_torch.rings.sampling
import stark_rings_tpu_torch.ops.stages
import stark_rings_tpu_torch.ops.dense_linear
import stark_rings_tpu_torch.ops.mxu_dense
import stark_rings_tpu_torch.ops.model_mul
import stark_rings_tpu_torch.ops.stark
import stark_rings_tpu_torch.ops.mxu_limb
import stark_rings_tpu_torch.models
import stark_rings_tpu_torch.decomp
import stark_rings_tpu_torch.decomp.balanced
import stark_rings_tpu_torch.decomp.norms
import stark_rings_tpu_torch.decomp.representatives
import stark_rings_tpu_torch.linalg.matrix
import stark_rings_tpu_torch.linalg.ops
import stark_rings_tpu_torch.protocol
import stark_rings_tpu_torch.protocol.folding
import stark_rings_tpu_torch.protocol.tree
import stark_rings_tpu_torch.examples.ajtai_commitment
import stark_rings_tpu_torch.examples.folding_step
import stark_rings_tpu_torch.examples.folding_tree
import stark_rings_tpu_torch.examples.bigring_fold
from stark_rings_tpu_torch.linalg import AlgebraError, Matrix
from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree, ntt_matvec
assert issubclass(AlgebraError, ValueError)
for name in ("ajtai_commitment", "folding_step", "folding_tree",
             "bigring_fold"):
    getattr(stark_rings_tpu_torch.examples, name).main(device="cpu")
R = stark_rings_tpu_torch.rings
for name in ("goldilocks", "babybear", "frog"):
    ring = R.get_ring(name, device="cpu")
    x = ring.rand_coeff((3,), np.random.default_rng(0))
    tm = stark_rings_tpu_torch.ops.model_mul.TModelMul(ring)
    assert (tm.mul(x, x) == ring.coeff_mul(x, x)).all()
    assert (ring.crt(x) == ring.crt_staged(x)).all()
    a = R.Rq.coeff(ring, x)
    assert (a * a).crt() == a.crt() * a.crt()
    assert R.monomial.psi_range_check_batched(ring, x[0, :4]).shape == (4,)
    assert R.sampling.is_invertible(ring, x).shape == (3,)
    assert R.Rq.recompose(ring, a.decompose(256, 8), 256) == a
    assert bool(a.l2_check(1 << 200)) and a.linf_norm().dim() == 0
for field in ("goldilocks", "babybear", "frog"):
    stark_rings_tpu_torch.examples.sumcheck.main(n_vars=9, device="cpu",
                                                 field=field)
    f = stark_rings_tpu_torch.get_field(field)
    T = f.rand((2, 1 << 5), np.random.default_rng(0), "cpu")
    SK = stark_rings_tpu_torch.mle.sumcheck_kernel
    msgs, _ = SK.sumcheck_prove_many([T[1], T[1]], T[0, :5], field=field)
    if field == "goldilocks":
        batch, _ = SK.sumcheck_prove_batch_goldilocks([T, T], T[0, :5])
        assert (batch[1] == msgs).all()
for field in ("babybear", "goldilocks"):
    ring = stark_rings_tpu_torch.get_power_ring(field, 10, device="cpu")
    x = ring.rand_coeff((1,), np.random.default_rng(0))
    assert (ring.mxu_ctx().mul(x, x) == ring.coeff_square(x)).all()
ops = stark_rings_tpu_torch.ops
x = stark_rings_tpu_torch.GOLDILOCKS.rand((2, 256), np.random.default_rng(0),
                                          "cpu")
ops.goldilocks_ntt.LOG_TILE = 4
e = ops.goldilocks_ntt.GoldilocksKernelNTT(256, device="cpu")
assert (e.mul(x, x) == ops.ntt.NTTContext(e.ctx.f, 256, device="cpu")
        .mul(x, x)).all()
m = ops.mxu_fused.MxuModMatFused([[1, 2], [3, 4]], device="cpu")
plain = ops.mxu.MxuModMat([[1, 2], [3, 4]], device="cpu")
assert (m.apply(x[:, :5]) == plain.apply(x[:, :5])).all()
assert (ops.fold.pointwise_chain(x, x, 2) == ops.fold.pointwise_chain_ref(
    x, x, 2)).all()
par = stark_rings_tpu_torch.parallel
for field in ("goldilocks", "babybear"):
    sn = par.ShardedNTT(field, 256, 4, exchange="pallas")
    mesh = par.make_mesh(4, device="cpu")
    cspec, _ = sn.shard_specs(1)
    f = stark_rings_tpu_torch.get_field(field)
    a = f.rand((2, 256), np.random.default_rng(1), "cpu")
    got = sn.gather(sn.make_fns(mesh, batch_ndim=1)[2](
        sn.shard(sn.to_matrix(a), cspec, mesh),
        sn.shard(sn.to_matrix(a), cspec, mesh)), cspec, "cpu")
    want = stark_rings_tpu_torch.get_power_ring(field, 8, device="cpu")
    assert (sn.from_matrix(got) == want.coeff_square(a)).all()
ring = R.get_ring("stark_prime", device="cpu")
x = ring.rand_coeff((2,), np.random.default_rng(0))
tm = stark_rings_tpu_torch.ops.model_mul.TModelMul(ring)
assert (tm.mul(x, x) == ring.coeff_mul(x, x)).all()
pr = stark_rings_tpu_torch.get_power_ring("stark_prime", 5, device="cpu")
y = pr.rand_coeff((1,), np.random.default_rng(0))
assert (pr.mxu_ctx().mul(y, y) == pr.coeff_square(y)).all()
fs = FoldingStep(ring, n_rows=1, wit_len=1, base=1 << 16)
c = fs.init_tables(np.random.default_rng(1))
w = fs.rand_witness(2, np.random.default_rng(2))
rt = fs.precompute_challenge(x[0])
assert fs.step(c, w, w, w[:, :, :1], w[:, :, :1], rt)["ok_l2"].all()
import stark_rings_tpu_torch.errors
import stark_rings_tpu_torch.linalg.sparse
import stark_rings_tpu_torch.linalg.symmetric
import stark_rings_tpu_torch.mle.sparse
import stark_rings_tpu_torch.utils.checkpoint
import stark_rings_tpu_torch.utils.serialize
import stark_rings_tpu_torch.utils.trace
L, UT = stark_rings_tpu_torch.linalg, stark_rings_tpu_torch.utils
e = L.FieldElems(stark_rings_tpu_torch.GOLDILOCKS, "cpu")
S = L.SparseMatrix.from_entries(e, 2, 3, [(0, 1, 5), (1, 2, 7), (0, 1, 1)])
assert (S.mul_vec(e.encode([1, 2, 3])) == e.encode([12, 21])).all()
assert (S.mul_sparse(S.transpose()).to_dense().vals
        == e.encode([[36, 0], [0, 49]])).all()
sm = stark_rings_tpu_torch.mle.SparseMLE.from_matrix(e, S)
dm = stark_rings_tpu_torch.mle.DenseMLE.from_matrix(e, S)
assert (sm.to_dense().evals == dm.evals).all() and dm.num_vars == 3
sym = L.SymmetricMatrix.from_rows(e, [[1], [2, 3]])
assert UT.deserialize_compressed(
    "SymmetricMatrix", e, UT.serialize_compressed(sym)).decode().tolist() \
    == [1, 2, 3]
with UT.trace_span("no-jax"):
    assert stark_rings_tpu_torch.errors.ConversionError.__mro__[1] \
        is ValueError
import stark_rings_tpu_torch.parallel.collectives
import stark_rings_tpu_torch.parallel.linalg
import stark_rings_tpu_torch.parallel.mle
import stark_rings_tpu_torch.parallel.model
import stark_rings_tpu_torch.examples.distributed_prover
stark_rings_tpu_torch.examples.distributed_prover.main(device="cpu", P=4)
assert all(hasattr(par, n) for n in (
    "make_mesh", "ShardedNTT", "ShardedMLE", "ShardedMatVec",
    "ShardedSparseMatVec", "ShardedModelMul", "psum_words"))
from stark_rings_tpu_torch.ops import (NTTContext, StageTable, TModelMul,
                                       derive_linear_table,
                                       derive_stage_tables,
                                       find_primitive_root, get_ntt)
from stark_rings_tpu_torch.native import HostGoldilocks, HostRing, get_host_lib
from stark_rings_tpu_torch.fields import Field
import stark_rings_tpu_torch.entry
assert isinstance(stark_rings_tpu_torch.GOLDILOCKS, Field)
assert NTTContext is stark_rings_tpu_torch.ops.ntt.NTTContext
step, (a, b) = stark_rings_tpu_torch.entry.entry("cpu")
assert not step(a, b).any()
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


def test_subpackages_export_the_reference_names():
    """Every name in the ``__all__`` of each subpackage of the reference
    is exported by the port's subpackage at the same path.  The one
    exception is ``linalg.rounded_div_jnp``, which the port names
    ``rounded_div_torch``.  ``models`` resolves its ring names lazily on
    the card, so names are read from ``__all__`` and ``dir``; ``ops``
    resolves its names on first access, which is checked with
    ``getattr``."""
    import importlib
    import pkgutil

    import stark_rings_tpu

    renamed = {("stark_rings_tpu.linalg", "rounded_div_jnp"):
               "rounded_div_torch"}
    seen = 0
    for info in pkgutil.walk_packages(stark_rings_tpu.__path__,
                                      "stark_rings_tpu."):
        if not info.ispkg:
            continue
        ref = importlib.import_module(info.name)
        port = importlib.import_module(info.name.replace(
            "stark_rings_tpu", "stark_rings_tpu_torch", 1))
        names = set(getattr(port, "__all__", ())) | set(dir(port))
        for name in ref.__all__:
            want = renamed.get((info.name, name), name)
            assert want in names, (info.name, name)
            if info.name != "stark_rings_tpu.models":
                getattr(port, want)
            seen += 1
    assert seen > 100
    import stark_rings_tpu_torch

    missing = set(stark_rings_tpu.__all__) - set(stark_rings_tpu_torch.__all__)
    assert not missing


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
