"""The port's protocol layer (``stark_rings_tpu_torch/protocol/``) on the
CPU against the reference's ``stark_rings_tpu.protocol`` run under
``jax.jit``, for goldilocks, babybear and frog: ``FoldingStep.step`` at
the reference test's shape (W = 2, L = 3, n = 2, base 256; frog base 4),
psi on and off, output by output (``s``, ``c``, ``digits``, ``cd``,
``ok_l2``, ``ok_psi``); the blocked commit at blocks 1, 3 and 7; and
``FoldingTree`` prove, verify and tamper.  The reference draws its
tables, witnesses and challenges from ``random.Random``; they are
carried across as storage arrays.  The tolerance is exact equality.  On
the CPU the model CRT folds (K3, ``bb_fold_end``) run as their twins."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stark_rings_tpu.protocol import FoldingStep as RefFoldingStep
from stark_rings_tpu.protocol import FoldingTree as RefFoldingTree
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import (from_jax_consts, from_jax_storage,
                                   make_mesh, to_numpy_storage)
from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree, ntt_matvec
from stark_rings_tpu_torch.protocol.tree import _is_negacyclic
from stark_rings_tpu_torch.rings import get_ring

NAMES = ["goldilocks", "babybear", "frog"]
W, L, N_ROWS = 2, 3, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _base(name):
    return 4 if name == "frog" else 256


def _port(f, x):
    return from_jax_storage(f, np.asarray(x), "cpu")


def _tables(f, c):
    """The reference's tables (numpy or jax storage) as port tables."""
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


_REF_STEPS = {}


def _ref_step(name, psi):
    """The reference's step on its own draws (random.Random(51)), once per
    (model, psi): (inputs, tables, outputs) as numpy storage."""
    key = (name, psi)
    if key not in _REF_STEPS:
        ring = ref_ring(name)
        fs = RefFoldingStep(ring, n_rows=N_ROWS, wit_len=L,
                            base=_base(name), psi_check=psi)
        rng = random.Random(51)
        c = fs.init_tables(rng)
        r = np.asarray(ring.rand_coeff((), rng))
        rt = fs.precompute_challenge(r)
        s0t, s1t = fs.rand_witness(W, rng), fs.rand_witness(W, rng)
        c0t, c1t = (fs.tm.to_t(jnp.asarray(np.asarray(
            ring.rand_ntt((W, N_ROWS), rng)))) for _ in range(2))
        out = jax.jit(fs.step)(jax.device_put(c), s0t, s1t, c0t, c1t, rt)
        ins = [np.asarray(x) for x in (s0t, s1t, c0t, c1t)]
        _REF_STEPS[key] = (r, np.asarray(rt), ins, c,
                           {k: np.asarray(v) for k, v in out.items()})
    return _REF_STEPS[key]


@pytest.mark.parametrize("psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_reference(name, psi):
    """Every output of the step is bit-equal; psi on goldilocks and
    babybear fails the negative digits exactly as the reference's does."""
    ring = get_ring(name, device="cpu")
    f = ring.field
    r, rt_ref, ins, c_ref, want = _ref_step(name, psi)
    fs = FoldingStep(ring, n_rows=N_ROWS, wit_len=L, base=_base(name),
                     psi_check=psi)
    assert (fs.k, fs.M, fs.l2_bound_sq) == (
        RefFoldingStep(ref_ring(name), N_ROWS, L, _base(name)).k,
        fs.L * fs.k, fs.M * ring.D * (_base(name) // 2) ** 2)
    rt = fs.precompute_challenge(_port(f, r))
    assert rt.shape == (ring.D, 1, 1)
    _same(rt, rt_ref, "precompute_challenge")
    out = fs.step(_tables(f, c_ref), *(_port(f, x) for x in ins), rt)
    assert sorted(out) == sorted(want)
    for key, val in want.items():
        _same(out[key], val, (name, psi, key))
    assert bool(out["ok_l2"].all())
    if psi:
        assert bool(out["ok_psi"].all()) == _is_negacyclic(ring)
    # the ring's own digit tables give the same step
    own = {"Agt": _port(f, c_ref["Agt"])}
    assert torch.equal(fs.step(own, *(_port(f, x) for x in ins), rt)["cd"],
                       out["cd"])


@pytest.mark.parametrize("name", NAMES)
def test_commit_blocked_matches_unblocked(name):
    """FoldingStep.commit at blocks 1, 3 and 7 and by its auto-block
    equals the one-block contraction and the reference's commit."""
    ring = get_ring(name, device="cpu")
    f = ring.field
    fs = FoldingStep(ring, n_rows=3, wit_len=2, base=256)
    rng = np.random.default_rng(77)
    c = fs.init_tables(rng)
    dt = fs.tm.crt_t(fs.tm.to_t(ring.rand_coeff((4, fs.M), rng)))
    full = fs.commit(c, dt, block=fs.M)
    assert full.shape == (ring.D, 4, 3)
    for blk in (1, 3, 7, None):
        assert torch.equal(fs.commit(c, dt, block=blk), full), blk
    rfs = RefFoldingStep(ref_ring(name), n_rows=3, wit_len=2, base=256)
    want = jax.jit(lambda a, d: rfs.commit({"Agt": a}, d, block=3))(
        jnp.asarray(to_numpy_storage(c["Agt"])),
        jnp.asarray(to_numpy_storage(dt)))
    _same(full, want, "commit")


def test_commit_block_budget():
    """The bench's goldilocks shape (n = 8, L = 1,024, base 256, W = 16)
    commits unblocked; babybear's E = 9 at that shape blocks."""
    gl = FoldingStep(get_ring("goldilocks", device="cpu"), 8, 1024, 256)
    assert gl.M == 8192 and gl.commit_block(16) >= gl.M
    bb = FoldingStep(get_ring("babybear", device="cpu"), 8, 1024, 256)
    assert 1 <= bb.commit_block(16) < bb.M


def _tamper(f, x):
    bad = x.clone()
    bad.view(-1)[0] = f.add(bad.view(-1)[:1], f.const(1, x.device))[0]
    return bad


@pytest.mark.parametrize("name", NAMES)
def test_tree_prove_verify_and_tamper(name):
    """Four witnesses fold to one (two levels, base 8; psi live on frog
    alone): every level's outputs and the root equal the reference's,
    the verifier accepts, and rejects a tampered folded witness and a
    tampered digit commitment."""
    ring, rring = get_ring(name, device="cpu"), ref_ring(name)
    f = ring.field
    rft = RefFoldingTree(rring, n_rows=2, wit_len=2, base=8)
    ft = FoldingTree(ring, n_rows=2, wit_len=2, base=8)
    assert ft.fs.psi_check == rft.fs.psi_check == (name == "frog")
    rng = random.Random(3)
    c_ref = rft.init_tables(rng)
    wt_r = rft.rand_witnesses(4, rng)
    rs = [np.asarray(rring.rand_coeff((), rng)) for _ in range(2)]
    cj = jax.device_put(c_ref)
    ct_r = jax.jit(rft.commit_witnesses)(cj, wt_r)
    rts_r = rft.precompute_challenges([jnp.asarray(r) for r in rs])
    lv_r, rw_r, rc_r = jax.jit(
        lambda c, wt, ct: rft.prove(c, wt, ct, rts_r))(cj, wt_r, ct_r)

    c = _tables(f, c_ref)
    wt = _port(f, wt_r)
    ct = ft.commit_witnesses(c, wt)
    _same(ct, ct_r, "commit_witnesses")
    rts = ft.precompute_challenges([_port(f, r) for r in rs])
    levels, rw, rc = ft.prove(c, wt, ct, rts)
    assert rw.shape == (ring.D, 1, 2) and rc.shape == (ring.D, 1, 2)
    _same(rw, rw_r, "root witness")
    _same(rc, rc_r, "root commitment")
    for lvl, (got, want) in enumerate(zip(levels, lv_r)):
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key], (name, lvl, key))
    assert ft.verify(c, wt, ct, levels, rts)
    for lvl, key in ((0, "s"), (1, "cd"), (0, "digits")):
        bad = [dict(o) for o in levels]
        bad[lvl][key] = _tamper(f, bad[lvl][key])
        assert not ft.verify(c, wt, ct, bad, rts), (lvl, key)


def test_step_chains_and_multi_device_raises():
    """Output shapes feed the next step; the E == 1 matvec; the sharded
    entry points run on a mesh of 2 CPU shards, equal the local step and
    tree, and raise on a shard list that does not fit the mesh (held to
    the reference in test_torch_sharded_protocol.py)."""
    ring = get_ring("goldilocks", device="cpu")
    fs = FoldingStep(ring, n_rows=2, wit_len=2, base=256)
    rng = np.random.default_rng(5)
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    s0, s1 = fs.rand_witness(2, rng), fs.rand_witness(2, rng)
    c0, c1 = (fs.tm.to_t(ring.rand_ntt((2, 2), rng)) for _ in range(2))
    out = fs.step(c, s0, s1, c0, c1, rt)
    out2 = fs.step(c, out["s"], s1, out["cd"], c1, rt)
    assert out2["s"].shape == out["s"].shape == (ring.D, 2, 2)
    assert out2["cd"].shape == out["cd"].shape == (ring.D, 2, 2)
    # the E == 1 branch (stark_prime's, held in test_torch_stark_protocol)
    # contracts with the field's product: its widened blocks agree
    f = ring.field
    full = ntt_matvec(f, fs.tm, 1, c["Agt"], out["digits"])
    assert full.shape == (ring.D, 2, 2)
    assert torch.equal(ntt_matvec(f, fs.tm, 1, c["Agt"], out["digits"],
                                  block=3), full)
    mesh = make_mesh(2, device="cpu")
    sfn = fs.make_sharded_step_fn(mesh)
    got = sfn(c, *([x[:, :1], x[:, 1:]] for x in (s0, s1, c0, c1)), rt)
    for key, val in out.items():
        assert torch.equal(torch.cat(got[key], dim=0 if key == "ok_l2"
                                     else 1), val), key
    with pytest.raises(ValueError, match="2 torch.int64 shards"):
        sfn(c, [s0], [s1], [c0], [c1], rt)
    ft = FoldingTree(ring, 2, 2)
    tabs = ft.init_tables(rng)
    wt = ft.rand_witnesses(4, rng)
    ct = ft.commit_witnesses(tabs, wt)
    rts = [rt, rt]
    lv_s, rw_s, rc_s = ft.prove_sharded(mesh, tabs, wt, ct, rts)
    lv_l, rw_l, rc_l = ft.prove(tabs, wt, ct, rts)
    assert torch.equal(rw_s, rw_l) and torch.equal(rc_s, rc_l)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(lv_s, lv_l)
               for k in a)
