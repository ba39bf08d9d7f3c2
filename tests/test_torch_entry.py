"""The port's entry points (``stark_rings_tpu_torch.entry``) on the
CPU against the reference's ``__graft_entry__.py``.

* ``entry``: the port's step on the reference's own inputs (drawn there
  from ``random.Random(0)``, carried across as storage words): the
  product, its nine base-256 digit planes, their recomposition and the
  zero difference bit-equal to the reference's ring ops on CPU JAX.
* ``grid_step``: at n = 6 (dp 3 x sp 2) and n = 8 (dp 1 x sp 8), the
  product and the checksum bit-equal to the reference's (dp, sp)
  ``shard_map`` step on its 8-device CPU mesh (tests/conftest.py),
  rebuilt from the reference's public pieces as its dry run lays it
  out; through the plain block transpose and through K8's twin, the
  kernels' twins counted (the card's launches).
* ``dryrun_multichip``: run to its end on CPU shards; a tampered shard
  result raises.
* The command line prints both ``ok`` lines.

The tolerance is exact equality throughout."""

import functools
import importlib.util
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as RefMesh
from jax.sharding import PartitionSpec as P

from stark_rings_tpu.decomp import decompose_ring as ref_decompose_ring
from stark_rings_tpu.decomp import recompose_ring as ref_recompose_ring
from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.parallel.collectives import psum_words as ref_psum_words
from stark_rings_tpu.parallel.ntt import ShardedNTT as RefShardedNTT
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import (GOLDILOCKS, ShardedNTT, from_jax_storage,
                                   to_numpy_storage)
from stark_rings_tpu_torch import entry as E
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops import goldilocks_ntt as G
from stark_rings_tpu_torch.parallel import ShardedMLE, ShardedModelMul
from stark_rings_tpu_torch.parallel import ShardedSparseMatVec
from stark_rings_tpu_torch.parallel import exchange as EX
from stark_rings_tpu_torch.parallel import ntt as PN
from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree
from stark_rings_tpu_torch.rings import get_ring

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _reference_entry():
    """The reference's ``__graft_entry__`` module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "_reference_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counter(monkeypatch, mod, name):
    """Count the calls of ``mod.name`` (a kernel's twin)."""
    calls = [0]
    fn = getattr(mod, name)

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


# -- entry --------------------------------------------------------------------


def test_entry_step_matches_reference(monkeypatch):
    """The reference's entry(): its a and b through the port's step; the
    product, the digit planes [32, 9, 24], the recomposition and the
    zero difference equal the reference's; K3's twin runs three times
    (the CRT of a and of b, the ICRT), as K3 launches on the card."""
    step, (a, b) = _reference_entry().entry()
    ring = ref_ring("goldilocks")
    f = ring.field

    def stages(a, b):
        prod = ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))
        digits = ref_decompose_ring(f, prod, 256, 9)
        return prod, digits, ref_recompose_ring(f, digits, 256)

    want = [np.asarray(x) for x in jax.jit(stages)(a, b)]
    want_zero = np.asarray(jax.jit(step)(a, b))
    port = get_ring("goldilocks", device="cpu")
    folds = _counter(monkeypatch, K, "fold_end_ref")
    got = E.step_stages(port, from_jax_storage(GOLDILOCKS, a, "cpu"),
                        from_jax_storage(GOLDILOCKS, b, "cpu"))
    assert folds[0] == 3
    assert got["digits"].shape == (32, 9, 24)
    for key, w in zip(("prod", "digits", "back"), want):
        assert np.array_equal(to_numpy_storage(got[key]), w), key
    assert np.array_equal(to_numpy_storage(got["zero"]), want_zero)
    assert not want_zero.any()


def test_entry_draws_its_inputs_and_returns_zero():
    """entry("cpu"): inputs from default_rng(0) at B = 32, and a step
    that returns the zero difference for them and for another batch."""
    step, (a, b) = E.entry("cpu")
    ring = get_ring("goldilocks", device="cpu")
    rng = np.random.default_rng(0)
    assert torch.equal(a, ring.rand_coeff((32,), rng))
    assert torch.equal(b, ring.rand_coeff((32,), rng))
    out = step(a, b)
    assert out.shape == (32, 24) and out.dtype == torch.int64
    assert not out.any()
    x = ring.rand_coeff((5,), np.random.default_rng(7))
    assert not step(x, a[:5]).any()


def test_default_device_is_the_card():
    """Without CUDA the default device raises: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for call in (E.entry, lambda: E.dryrun_multichip(2),
                 lambda: E.make_grid(2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- the (dp, sp) grid --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_grid_step(n):
    """The reference dry run's (dp, sp) step (``__graft_entry__.py``
    :82-120) on its CPU mesh: (a, b, prod, checksum) as numpy storage."""
    devs = jax.devices()[:n]
    sp = n & -n
    dp = n // sp
    mesh = RefMesh(np.array(devs).reshape(dp, sp), ("dp", "sp"))
    f = ref_field("goldilocks")
    N1 = N2 = max(2 * sp, 4)
    sn = RefShardedNTT("goldilocks", N1 * N2, sp, axis="sp")
    sn.consts()
    B = 2 * dp
    rng = random.Random(1)
    a = np.asarray(f.rand((B, N1, N2), rng))
    b = np.asarray(f.rand((B, N1, N2), rng))
    cspec = P("dp", None, "sp")

    def local_step(a, b):
        fa = sn._local_forward(a)
        fb = sn._local_forward(b)
        prod = sn._local_inverse(f.mul(fa, fb))
        w = f.widen(prod)
        local = jnp.sum(w.reshape(-1, w.shape[-1]), axis=0)
        total = ref_psum_words(ref_psum_words(local, "sp"), "dp")
        return prod, f.reduce_words(total)

    step = jax.jit(jax.shard_map(local_step, mesh=mesh,
                                 in_specs=(cspec, cspec),
                                 out_specs=(cspec, P())))
    prod, checksum = step(a, b)
    return a, b, np.asarray(prod), np.asarray(checksum)


@pytest.mark.parametrize("exchange", ["xla", "pallas"])
@pytest.mark.parametrize("n", [6, 8])
def test_grid_step_matches_reference(n, exchange, monkeypatch):
    """grid_step on dp rows of sp CPU shards: the product and the
    checksum equal the reference's shard_map step; per shard a product
    is 6 ntt_tile and 7 pointwise_mul twin calls (4 with K8, which takes
    the twiddles), per row 2 forward and 1 inverse K8 twin calls."""
    if len(jax.devices()) < n:
        pytest.skip("the reference needs its 8-device CPU mesh")
    a, b, want, want_ck = _reference_grid_step(n)
    dp, sp = E.grid_shape(n)
    assert (dp, sp) == {6: (3, 2), 8: (1, 8)}[n]
    rows = E.make_grid(n, "cpu")
    assert [r.size for r in rows] == [sp] * dp
    assert all(r.axis == "sp" for r in rows)
    sn = ShardedNTT("goldilocks", a.shape[1] * a.shape[2], sp, axis="sp",
                    exchange=exchange)
    calls = {name: _counter(monkeypatch, mod, name) for mod, name in (
        (G, "ntt_tile_ref"), (K, "pointwise_mul_ref"),
        (EX, "twiddle_exchange_fwd_ref"), (EX, "twiddle_exchange_inv_ref"))}
    prod, checksum = E.grid_step(sn, rows, E.shard_grid(sn, rows, a),
                                 E.shard_grid(sn, rows, b))
    assert len(prod) == dp and all(len(r) == sp for r in prod)
    assert prod[0][0].shape == (2, a.shape[1], a.shape[2] // sp)
    assert np.array_equal(E.gather_grid(sn, prod), want)
    assert np.array_equal(to_numpy_storage(checksum), want_ck)
    k8 = exchange == "pallas"
    assert {k: v[0] for k, v in calls.items()} == {
        "ntt_tile_ref": 6 * n, "pointwise_mul_ref": (4 if k8 else 7) * n,
        "twiddle_exchange_fwd_ref": 2 * dp if k8 else 0,
        "twiddle_exchange_inv_ref": dp if k8 else 0}


def test_grid_layout_and_checks():
    """n = dp * sp with sp the largest power of two dividing n; a list
    of devices gives one shard each; bad operands raise."""
    for n in range(1, 17):
        dp, sp = E.grid_shape(n)
        assert dp * sp == n and sp & (sp - 1) == 0 and dp % 2 == 1
    with pytest.raises(ValueError, match="at least one"):
        E.grid_shape(0)
    rows = E.make_grid(6, ["cpu"] * 6)
    assert [len(r.devices) for r in rows] == [2, 2, 2]
    with pytest.raises(ValueError, match="need 6 devices"):
        E.make_grid(6, ["cpu"] * 5)
    sn = ShardedNTT("goldilocks", 16, 2, axis="sp")
    x = GOLDILOCKS.rand((6, 4, 4), np.random.default_rng(0), "cpu")
    g = E.shard_grid(sn, rows, x)
    assert torch.equal(E.gather_grid(sn, g, "cpu"), x)
    with pytest.raises(ValueError, match="does not split"):
        E.shard_grid(sn, rows, x[:4])
    with pytest.raises(ValueError, match="rows of shards"):
        E.grid_step(sn, rows, g[:2], g[:2])
    with pytest.raises(ValueError, match="shards"):
        E.grid_step(sn, rows, [r[:1] for r in g], g)
    with pytest.raises(ValueError, match="mesh of 2 shards for P=4"):
        E.grid_step(ShardedNTT("goldilocks", 16, 4, axis="sp"), rows, g, g)


# -- the dry run --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8])
def test_dryrun_multichip_runs_on_cpu_shards(n, monkeypatch):
    """dryrun_multichip(n, "cpu") runs every section to its end; the
    kernels' twins of its path are each called (K3, the radix tile,
    pointwise_mul and K7; K8 where sp >= 2)."""
    calls = {name: _counter(monkeypatch, mod, name) for mod, name in (
        (K, "fold_end_ref"), (G, "ntt_tile_ref"), (K, "pointwise_mul_ref"),
        (SK, "sumcheck_prove_many_ref"), (EX, "twiddle_exchange_fwd_ref"),
        (EX, "twiddle_exchange_inv_ref"))}
    E.dryrun_multichip(n, "cpu")
    sp = n & -n
    for name, c in calls.items():
        assert c[0] > 0 or (sp == 1 and "exchange" in name), name


def test_dryrun_multichip_on_a_device_list():
    E.dryrun_multichip(4, ["cpu"] * 4)


def _flip(x):
    """x with the low bit of its first word flipped."""
    y = x.clone(memory_format=torch.contiguous_format)
    y.view(-1)[0] ^= 1
    return y


def _tamper_first_shard(fn):
    def call(*args, **kw):
        out = list(fn(*args, **kw))
        out[0] = _flip(out[0])
        return out
    return call


def _tamper_result(make):
    def wrapped(self, *args, **kw):
        inner = make(self, *args, **kw)
        return _tamper_first_shard(inner)
    return wrapped


def _tamper_psum(fn):
    calls = [0]

    def call(words):
        calls[0] += 1
        total = fn(words)
        return _flip(total) if calls[0] == 1 else total
    return call


def _tamper_step(make):
    def wrapped(self, *args, **kw):
        inner = make(self, *args, **kw)

        def call(*a, **k):
            out = inner(*a, **k)
            out["digits"] = [_flip(out["digits"][0])] + out["digits"][1:]
            return out
        return call
    return wrapped


def _tamper_tree(fn):
    def call(self, *args, **kw):
        levels, wt, ct = fn(self, *args, **kw)
        return levels, _flip(wt), ct
    return call


def _tamper_sumcheck(fn):
    calls = [0]

    def call(self, tables, chal):        # the first shard's messages
        calls[0] += 1
        msgs, finals = fn(self, tables, chal)
        return (_flip(msgs) if calls[0] == 1 else msgs), finals
    return call


def _tamper_spmv(fn):
    def call(self, smat, v):
        return _flip(fn(self, smat, v))
    return call


TAMPER = {  # what -> (object, attribute, wrapper, the check that fires)
    "grid product": (PN.ShardedNTT, "_local_inverse", _tamper_first_shard,
                     "grid step product"),
    "grid checksum": (E, "psum_words", _tamper_psum, "grid step checksum"),
    "K8": (PN, "twiddle_exchange_fwd", _tamper_first_shard,
           "goldilocks K8 exchange"),
    "sumcheck": (ShardedMLE, "_prove_local", _tamper_sumcheck,
                 "sharded sumcheck"),
    "sparse mat-vec": (ShardedSparseMatVec, "mul_vec", _tamper_spmv,
                       "sharded sparse mat-vec"),
    "model mul": (ShardedModelMul, "make_mul_fn", _tamper_result,
                  "sharded model mul"),
    "challenge mul": (ShardedModelMul, "make_challenge_mul_fn",
                      _tamper_result, "sharded challenge mul"),
    "folding step": (FoldingStep, "make_sharded_step_fn", _tamper_step,
                     "sharded folding step digits"),
    "folding tree": (FoldingTree, "prove_sharded", _tamper_tree,
                     "sharded folding tree root"),
}


@pytest.mark.parametrize("what", list(TAMPER))
def test_dryrun_multichip_raises_on_a_tampered_shard(what, monkeypatch):
    """One sharded result with one bit flipped: the dry run raises at
    that section's check (an explicit raise, kept under python -O)."""
    obj, attr, wrap, check = TAMPER[what]
    monkeypatch.setattr(obj, attr, wrap(getattr(obj, attr)))
    with pytest.raises(AssertionError, match=check):
        E.dryrun_multichip(2, "cpu")


def test_command_line_runs_both_steps():
    proc = subprocess.run(
        [sys.executable, "-O", "-m", "stark_rings_tpu_torch.entry",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["entry ok (32, 24)", "dryrun ok"]
