"""The port's witness-sharded folding step and tree on CPU shards
against the JAX reference on its virtual 8-device CPU mesh
(tests/conftest.py), at the sizes of the reference's multi-chip dry run
(``__graft_entry__.py``: goldilocks, n = 2, L = 2, W = 8 for the step at
base 256, 16 leaves for the tree at base 8), psi off and on; and the
distributed prover example.  The reference draws its tables, witnesses
and challenges from ``random.Random``; they are carried across as
storage arrays, split along the witness axis as its ``PartitionSpec``s
split them.  The tolerance is exact equality.  On the CPU the model CRT
folds (K3) run as their twins, counted: two a shard a step."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.parallel import make_mesh as ref_make_mesh
from stark_rings_tpu.protocol import FoldingStep as RefFoldingStep
from stark_rings_tpu.protocol import FoldingTree as RefFoldingTree
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import (from_jax_consts, from_jax_storage,
                                   to_numpy_storage)
from stark_rings_tpu_torch.examples import distributed_prover
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.parallel import gather, make_mesh, shard
from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree
from stark_rings_tpu_torch.rings import get_ring

PN = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_mesh():
    if len(jax.devices()) < PN:
        pytest.skip("the reference needs its 8-device CPU mesh")
    return ref_make_mesh(PN)


def _port(f, x):
    return from_jax_storage(f, np.asarray(x), "cpu")


def _tables(f, c):
    """The reference's tables as port tables (its digit tables too)."""
    out = {"tm": from_jax_consts({k: np.asarray(v)
                                  for k, v in c["tm"].items()}, "cpu")}
    for key in ("Agt", "Awt"):
        if key in c:
            out[key] = _port(f, c[key])
    return out


def _same(got, want, what):
    if got.dtype == torch.bool:
        assert np.array_equal(got.numpy(), np.asarray(want)), what
    else:
        assert np.array_equal(to_numpy_storage(got), np.asarray(want)), what


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
def test_sharded_step_matches_reference(psi, ref_mesh, monkeypatch):
    """make_sharded_step_fn on 8 shards of W = 8 witnesses: every output,
    gathered along the witness axis, equals the reference's sharded step
    (and its local step); each shard runs its ICRT and CRT fold."""
    rring, ring = ref_ring("goldilocks"), get_ring("goldilocks", device="cpu")
    f = ring.field
    rfs = RefFoldingStep(rring, n_rows=2, wit_len=2, base=256,
                         psi_check=psi)
    rr = random.Random(4)
    c_ref = rfs.init_tables(rr)
    r = np.asarray(rring.rand_coeff((), rr))
    rt = np.asarray(rfs.precompute_challenge(r))
    s0, s1 = (np.asarray(rfs.rand_witness(PN, rr)) for _ in range(2))
    c0, c1 = (np.asarray(rfs.tm.to_t(jnp.asarray(np.asarray(
        rring.rand_ntt((PN, 2), rr))))) for _ in range(2))
    cj = jax.device_put(c_ref)
    want = rfs.make_sharded_step_fn(ref_mesh)(cj, s0, s1, c0, c1, rt)
    local = jax.jit(rfs.step)(cj, s0, s1, c0, c1, rt)

    fs = FoldingStep(ring, n_rows=2, wit_len=2, base=256, psi_check=psi)
    mesh = make_mesh(PN, device="cpu")
    ins = [shard(x, mesh, 1, f) for x in (s0, s1, c0, c1)]
    assert ins[0][0].shape == (ring.D, 1, 2)
    calls = [0]
    twin = K.fold_end_ref

    def counted(*args, **kw):
        calls[0] += 1
        return twin(*args, **kw)

    monkeypatch.setattr(K, "fold_end_ref", counted)
    got = fs.make_sharded_step_fn(mesh)(_tables(f, c_ref), *ins,
                                        _port(f, rt))
    assert calls[0] == 2 * PN
    keys = ["s", "c", "digits", "cd", "ok_l2"] + (["ok_psi"] if psi else [])
    assert sorted(got) == sorted(keys)
    for key in keys:
        assert len(got[key]) == PN
        whole = torch.cat(got[key], dim=0 if key.startswith("ok_") else 1)
        _same(whole, want[key], key)
        _same(whole, local[key], key)


def _ref_tree(W, psi):
    """The reference's 16-leaf tree (n = 2, L = 2, base 8), proved
    sharded on its mesh: tables, leaves, challenges and levels."""
    rring = ref_ring("goldilocks")
    rft = RefFoldingTree(rring, n_rows=2, wit_len=2, base=8, psi_check=psi)
    rr = random.Random(4)
    c_ref = rft.init_tables(rr)
    cj = jax.device_put(c_ref)
    wt = np.asarray(rft.rand_witnesses(W, rr))
    ct = np.asarray(jax.jit(rft.commit_witnesses)(cj, jnp.asarray(wt)))
    rs = [np.asarray(rring.rand_coeff((), rr))
          for _ in range(W.bit_length() - 1)]
    rts = [np.asarray(x) for x in rft.precompute_challenges(
        [jnp.asarray(x) for x in rs])]
    return rft, c_ref, cj, wt, ct, rs, rts


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
def test_prove_sharded_matches_reference(psi, ref_mesh):
    """16 leaves on 8 shards: level 0 (8 pairs) runs sharded, the three
    levels near the root locally; every level and the root equal the
    reference's prove_sharded and the port's prove, and verify accepts
    the sharded tree (psi off; with psi on it rejects both trees, as
    goldilocks' negative digits fail the range check).  Leaves given as
    shard lists give the same."""
    W = 16
    rft, c_ref, cj, wt, ct, rs, rts = _ref_tree(W, psi)
    lv_r, rw_r, rc_r = rft.prove_sharded(ref_mesh, cj, wt, ct, rts)

    ring = get_ring("goldilocks", device="cpu")
    f = ring.field
    ft = FoldingTree(ring, n_rows=2, wit_len=2, base=8, psi_check=psi)
    mesh = make_mesh(PN, device="cpu")
    c = _tables(f, c_ref)
    pw, pc = _port(f, wt), _port(f, ct)
    prts = [_port(f, x) for x in rts]
    levels, rw, rc = ft.prove_sharded(mesh, c, pw, pc, prts)
    _same(rw, rw_r, "root witness")
    _same(rc, rc_r, "root commitment")
    assert len(levels) == len(lv_r) == 4
    for lvl, (got, want) in enumerate(zip(levels, lv_r)):
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key], (lvl, key))
    lv_l, rw_l, rc_l = ft.prove(c, pw, pc, prts)
    assert torch.equal(rw, rw_l) and torch.equal(rc, rc_l)
    for a, b in zip(levels, lv_l):
        assert all(torch.equal(a[k], b[k]) for k in b)
    # psi on goldilocks: negative digits honestly fail the range check,
    # so verify rejects the sharded tree exactly as it rejects prove's
    assert ft.verify(c, pw, pc, levels, prts) == ft.verify(
        c, pw, pc, lv_l, prts) == (not psi)
    lv_s, rw_s, _ = ft.prove_sharded(mesh, c, shard(pw, mesh, 1),
                                     shard(pc, mesh, 1), prts)
    assert torch.equal(rw_s, rw)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(lv_s, levels)
               for k in a)


def test_prove_sharded_on_four_shards_shards_two_levels():
    """On 4 shards, 16 leaves run two levels sharded (8 and 4 pairs),
    then two locally: equal to prove."""
    ring = get_ring("goldilocks", device="cpu")
    ft = FoldingTree(ring, n_rows=2, wit_len=2, base=8)
    rng = np.random.default_rng(9)
    c = ft.init_tables(rng)
    wt = ft.rand_witnesses(16, rng)
    ct = ft.commit_witnesses(c, wt)
    rts = ft.precompute_challenges([ring.rand_coeff((), rng)
                                    for _ in range(4)])
    mesh = make_mesh(4, device="cpu")
    levels, rw, rc = ft.prove_sharded(mesh, c, wt, ct, rts)
    lv_l, rw_l, rc_l = ft.prove(c, wt, ct, rts)
    assert torch.equal(rw, rw_l) and torch.equal(rc, rc_l)
    for a, b in zip(levels, lv_l):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert ft.verify(c, wt, ct, levels, rts)
    assert gather(shard(wt, mesh, 1), 1, "cpu").equal(wt)


def test_distributed_prover_example(capsys):
    """The example on 8 CPU shards: the verifier chain passes."""
    distributed_prover.main(device="cpu")
    out = capsys.readouterr().out
    assert "sharded sumcheck verified: 12 rounds on 8 shards" in out
    distributed_prover.main(device="cpu", P=2, seed=1)
    assert "sharded sumcheck verified" in capsys.readouterr().out
