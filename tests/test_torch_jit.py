"""The port's compiled multiplies and the methods that close its API on
the CPU, against the JAX reference: ``jit_mul``, ``jit_mul_cached`` (its
``.precompute`` at batch B and at batch 1), ``jit_square`` and
``forward`` of the Goldilocks and BabyBear engines against the
reference's same calls (the fused engines against ``Mxu2PallasNTT`` and
``MxuBBPallasNTT`` in interpret mode); ``staged_mul`` in its four
granularities against the port's own ``mul``, the reference's
``jit_mul`` compiled once an engine; ``PrescaledMat.apply`` and
``BBPrescaledMat.apply`` against the reference's ``apply``;
``GoldilocksKernelNTT.to_planes`` / ``from_planes``; and the graph
helper's CPU rule.  On CPU tensors every compiled call runs the method
itself (``ops/graphed.py``).  Bit-exact throughout: no tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import BABYBEAR as RB
from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.ops.mxu2 import Mxu2NTT as RefMxu2NTT
from stark_rings_tpu.ops.mxu2 import PrescaledMat as RefPrescaledMat
from stark_rings_tpu.ops.mxu_bb import BBPrescaledMat as RefBBPrescaledMat
from stark_rings_tpu.ops.mxu_bb import MxuBBNTT as RefMxuBBNTT
from stark_rings_tpu.ops.pallas_fold import Mxu2PallasNTT
from stark_rings_tpu.ops.pallas_fold_bb import MxuBBPallasNTT
from stark_rings_tpu.ops.pallas_goldilocks import GoldilocksPallasNTT

from stark_rings_tpu_torch import (BABYBEAR, GOLDILOCKS, Mxu2FusedNTT,
                                   Mxu2KernelNTT, Mxu2NTT, MxuBBFusedNTT,
                                   MxuBBNTT, from_jax_storage,
                                   to_numpy_storage)
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops.goldilocks_ntt import GoldilocksKernelNTT
from stark_rings_tpu_torch.ops.graphed import GraphSet, graphed
from stark_rings_tpu_torch.ops.mxu2 import PrescaledMat, digit_table
from stark_rings_tpu_torch.ops.mxu_bb import BBPrescaledMat

N = 1 << 12
B = 2
CALLS = ("jit_mul", "jit_mul_cached", "jit_mul_cached_batch1", "jit_square",
         "forward")
GRANULARITIES = ("stage", "mixed", "mixed4", "transform")
# port engine -> (its field, the reference's field, the reference engine)
ENGINES = {
    "Mxu2NTT": (lambda: Mxu2NTT(N, device="cpu"), GOLDILOCKS, RF,
                lambda: RefMxu2NTT(N)),
    "Mxu2FusedNTT": (lambda: Mxu2FusedNTT(N, device="cpu"), GOLDILOCKS, RF,
                     lambda: Mxu2PallasNTT(N, interpret=True, dma_folds=True,
                                           pointwise_pallas=True,
                                           fuse_pointwise=True)),
    "Mxu2KernelNTT": (lambda: Mxu2KernelNTT(N, device="cpu"), GOLDILOCKS, RF,
                      lambda: Mxu2PallasNTT(N, interpret=True,
                                            pointwise_pallas=True)),
    "MxuBBNTT": (lambda: MxuBBNTT(N, device="cpu"), BABYBEAR, RB,
                 lambda: RefMxuBBNTT(N)),
    "MxuBBFusedNTT": (lambda: MxuBBFusedNTT(N, device="cpu"), BABYBEAR, RB,
                      lambda: MxuBBPallasNTT(N, interpret=True)),
}
# the reference's Pallas slot product takes no batch-1 operand
# (``ops/pallas_fold.py:685``): that product is held to its plain engine
BATCH1_REF = {"Mxu2KernelNTT": lambda: RefMxu2NTT(N)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(rf, seed):
    """Reference storage [B, N] of a and b, a's first words the edge
    values 0, 1, q - 1 (Montgomery storage for BabyBear)."""
    rng = np.random.default_rng(seed)
    dt = np.uint32 if rf.q < 1 << 32 else np.uint64
    a, b = (rng.integers(0, rf.q, (B, N), dtype=dt) for _ in range(2))
    a[0, :3] = np.asarray(rf.encode(np.array([0, 1, rf.q - 1],
                                             dtype=object)))
    return a, b


_RUNS: dict = {}


def _run(name):
    """{call: (port result, reference result)} of one engine, each
    reference call compiled once (module cache)."""
    if name in _RUNS:
        return _RUNS[name]
    make_port, f, rf, make_ref = ENGINES[name]
    port, ref = make_port(), make_ref()
    a, b = _operands(rf, 7)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = (from_jax_storage(f, x, "cpu") for x in (a, b))
    mc, rmc = port.jit_mul_cached(), ref.jit_mul_cached()
    st, rst = mc.precompute(tb), rmc.precompute(jb)
    st1, rst1 = mc.precompute(tb[:1]), rmc.precompute(jb[:1])
    rmc1 = BATCH1_REF[name]().jit_mul_cached() if name in BATCH1_REF \
        else rmc
    out = {
        "jit_mul": (port.jit_mul()(ta, tb), ref.jit_mul()(ja, jb)),
        "jit_mul_cached": (mc(ta, st), rmc(ja, rst)),
        "jit_mul_cached_batch1": (mc(ta, st1),
                                  rmc1(ja, rmc1.precompute(jb[:1]))),
        "jit_square": (port.jit_square()(ta), ref.jit_square()(ja)),
        "forward": (port.forward(ta), ref.forward(ja)),
        "state": (st, rst),
        "state_batch1": (st1, rst1),
    }
    _RUNS[name] = out = {k: (g, np.asarray(w)) for k, (g, w) in out.items()}
    out["port"], out["operands"] = port, (ta, tb)
    return out


def _same(got, want):
    """Bit-equal: int32 bucket states as they are, storage as the
    reference's words."""
    if got.dtype == torch.int32 and want.dtype == np.int32:
        return np.array_equal(got.numpy(), want)
    return np.array_equal(to_numpy_storage(got), want)


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_compiled_calls_match_reference(engine, call):
    got, want = _run(engine)[call]
    assert got.shape == want.shape
    assert _same(got, want)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_cached_states_match_reference(engine):
    """``.precompute``'s state, batch B and batch 1: evaluations for the
    plain and evaluation-domain engines, the un-folded level-2 buckets
    (int32) for the fused ones, byte for byte."""
    run = _run(engine)
    for key in ("state", "state_batch1"):
        got, want = run[key]
        assert got.shape == want.shape, key
        assert _same(got, want), key


@pytest.mark.parametrize("granularity", GRANULARITIES)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_staged_mul_matches_mul(engine, granularity):
    """Every granularity is the port's own ``mul`` (and so the
    reference's ``jit_mul``); ``.forward`` is ``forward_internal``."""
    run = _run(engine)
    port, (ta, tb) = run["port"], run["operands"]
    sm = port.staged_mul(granularity)
    got = sm(ta, tb)
    assert torch.equal(got, port.mul(ta, tb))
    assert _same(got, run["jit_mul"][1])
    assert torch.equal(sm.forward(ta),
                       port.forward_internal(port._to_internal(ta)))


def test_staged_mul_rejects_unknown_granularity():
    with pytest.raises(ValueError, match="granularity"):
        Mxu2NTT(1 << 6, device="cpu").staged_mul("module")


def _counting(monkeypatch, names):
    """Count the calls of the fold module's twins ``names``."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        twin = getattr(K, name)

        def counted(*args, _name=name, _twin=twin, **kw):
            calls[_name] += 1
            return _twin(*args, **kw)
        monkeypatch.setattr(K, name, counted)
    return calls


@pytest.mark.parametrize("granularity", ["stage", "mixed"])
def test_fused_staged_pieces_run_on_the_kernels(monkeypatch, granularity):
    """The fused engine's untransposed level and slot product (which only
    ``staged_mul`` reaches) run on K1 untransposed and the slot-product
    kernel's wrappers (their twins here): a "stage" mul calls K1 three
    times and K3 three times, a "mixed" one K1 transposed three times and
    K3 three times, each with one slot product; no field product runs in
    torch ops."""
    port = Mxu2FusedNTT(1 << 8, device="cpu")
    rng = np.random.default_rng(3)
    a, b = (GOLDILOCKS.rand((2, 1 << 8), rng, "cpu") for _ in range(2))
    want = port.mul(a, b)
    calls = _counting(monkeypatch, ("fold_tw_ref", "fold_end_ref",
                                    "fold_end2_mul_ref",
                                    "pointwise_mul_ref"))
    monkeypatch.setattr(GOLDILOCKS, "mul", None)   # a torch product fails
    assert torch.equal(port.staged_mul(granularity)(a, b), want)
    assert calls == {"fold_tw_ref": 3, "fold_end_ref": 3,
                     "fold_end2_mul_ref": 0, "pointwise_mul_ref": 1}


def test_bb_fused_pointwise_is_the_field_product():
    """BabyBear has no slot-product kernel: the fused engine's
    ``pointwise`` is the field's Montgomery product, as in the
    reference's ``MxuBBPallasNTT``."""
    port = MxuBBFusedNTT(1 << 6, device="cpu")
    rng = np.random.default_rng(4)
    x, y = (BABYBEAR.rand((8, 2, 8), rng, "cpu") for _ in range(2))
    assert torch.equal(port.pointwise(x, y), BABYBEAR.mul(x, y))


# -- PrescaledMat.apply -------------------------------------------------------


@pytest.mark.parametrize("cols", [8, 5])
@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_prescaled_mat_apply_matches_reference(field, unsigned, cols):
    """The matrix of the reference's own test (16 x 16, x [16, cols]):
    ``apply`` with the port's device tables equals the reference's
    ``apply`` and the Python-int product; 5 columns are padded for
    ``_int_mm`` and dropped."""
    rf, f, port_cls, ref_cls = {
        "goldilocks": (RF, GOLDILOCKS, PrescaledMat, RefPrescaledMat),
        "babybear": (RB, BABYBEAR, BBPrescaledMat, RefBBPrescaledMat),
    }[field]
    rng = np.random.default_rng(7)
    m = rng.integers(0, rf.q, (16, 16), dtype=np.uint64)
    m_ints = [[int(v) for v in row] for row in m]
    xi = rng.integers(0, rf.q, (16, cols), dtype=np.uint64).astype(object)
    x = np.asarray(rf.encode(xi))
    pm = port_cls(m_ints, unsigned)
    w, w_corr = digit_table(pm.big, "cpu")
    got = pm.apply(from_jax_storage(f, x, "cpu"), w, w_corr)
    want = np.asarray(ref_cls(m_ints, unsigned).apply(jnp.asarray(x)))
    assert np.array_equal(to_numpy_storage(got), want)
    ints = [[sum(m_ints[r][k] * int(xi[k, c]) for k in range(16)) % rf.q
             for c in range(cols)] for r in range(16)]
    assert f.decode(got).tolist() == ints


# -- GoldilocksKernelNTT planes ---------------------------------------------


def test_goldilocks_planes_match_reference():
    """``to_planes`` gives the reference's u32 halves as int32 bit
    patterns; ``from_planes`` rebuilds the words."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 64, (3, 7), dtype=np.uint64)
    x[0, :3] = [0, RF.q - 1, (1 << 64) - 1]
    lo, hi = GoldilocksKernelNTT.to_planes(from_jax_storage(GOLDILOCKS, x,
                                                            "cpu"))
    rlo, rhi = GoldilocksPallasNTT.to_planes(jnp.asarray(x))
    assert lo.dtype == hi.dtype == torch.int32 and lo.shape == x.shape
    assert np.array_equal(to_numpy_storage(lo), np.asarray(rlo))
    assert np.array_equal(to_numpy_storage(hi), np.asarray(rhi))
    back = GoldilocksKernelNTT.from_planes(lo, hi)
    assert np.array_equal(to_numpy_storage(back),
                          np.asarray(GoldilocksPallasNTT.from_planes(rlo,
                                                                     rhi)))
    assert np.array_equal(to_numpy_storage(back), x)


# -- the graph helper on the CPU ----------------------------------------------


def test_graphed_runs_cpu_inputs_as_they_are():
    """CPU inputs call the function itself, every call (no capture, no
    cache); anything but tensors, or tensors on two devices, raise."""
    calls = []

    def fn(x, y):
        calls.append(1)
        return x + y

    g = graphed(fn)
    x = torch.arange(4)
    assert torch.equal(g(x, x), 2 * x) and torch.equal(g(x, x), 2 * x)
    assert len(calls) == 2 and not g.captures
    with pytest.raises(TypeError):
        g(x, 1)
    with pytest.raises(TypeError):
        g()
    with pytest.raises(ValueError, match="several devices"):
        g(x, torch.arange(4, device="meta"))
    pair = GraphSet()
    assert pair.wrap(fn).graphs is pair.wrap(fn).graphs
