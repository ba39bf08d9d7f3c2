"""The port's protocol and MLE layers over the limbed stark_prime, on the
CPU against the JAX reference: ``ntt_matvec``'s E == 1 branch (unblocked
and M-blocked through ``widen`` / ``reduce_words``), a 4-leaf
``FoldingTree`` (its first level is a W = 2 ``FoldingStep``, held output
by output, also with a forced commit block), its verifier and a tampered
proof, ``DenseMLE`` evaluate / fix, and the generic sumcheck prover
(``sumcheck_prove_many(..., field="stark_prime")``).  The reference runs
op by op: its limbed steps take most of a minute to compile under
``jax.jit`` on the CPU.  It draws its tables, witnesses and challenges
from ``random.Random``; they are carried across as storage arrays.  The
tolerance is exact equality."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.linalg import FieldElems as RefFieldElems
from stark_rings_tpu.mle import DenseMLE as RefDenseMLE
from stark_rings_tpu.mle import sumcheck as RS
from stark_rings_tpu.ops.model_mul import TModelMul as RefTModelMul
from stark_rings_tpu.protocol import FoldingTree as RefFoldingTree
from stark_rings_tpu.protocol import ntt_matvec as ref_matvec
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import (from_jax_consts, from_jax_storage,
                                   to_numpy_storage)
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.mle.sumcheck_kernel import sumcheck_prove_many
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.protocol import FoldingStep, FoldingTree, ntt_matvec
from stark_rings_tpu_torch.rings import get_ring

N_ROWS, L, BASE = 2, 2, 1 << 16


@pytest.fixture(scope="module")
def ref_tree():
    """The reference's 4-leaf tree on its own draws (random.Random(3)):
    (tables, leaves, their commitments, challenges, levels, root), all
    numpy storage."""
    ring = ref_ring("stark_prime")
    tr = RefFoldingTree(ring, n_rows=N_ROWS, wit_len=L, base=BASE,
                        psi_check=False)
    rng = random.Random(3)
    c = tr.init_tables(rng)
    wt = tr.rand_witnesses(4, rng)
    ct = tr.commit_witnesses(c, wt)
    rs = [np.asarray(ring.rand_coeff((), rng)) for _ in range(2)]
    rts = tr.precompute_challenges(rs)
    levels, root, _ = tr.prove(c, wt, ct, rts)
    levels = [{k: np.asarray(v) for k, v in o.items()} for o in levels]
    return (c, np.asarray(wt), np.asarray(ct), rs,
            [np.asarray(r) for r in rts], levels, np.asarray(root))


def _p(f, x):
    return from_jax_storage(f, np.asarray(x), "cpu")


def _same(got, want, what):
    if got.dtype == torch.bool:
        assert np.array_equal(got.numpy(), np.asarray(want)), what
    else:
        assert np.array_equal(to_numpy_storage(got), np.asarray(want)), what


def _tables(f, c):
    out = {"tm": from_jax_consts({k: np.asarray(v)
                                  for k, v in c["tm"].items()}, "cpu")}
    for key in ("Agt", "Awt"):
        out[key] = _p(f, c[key])
    return out


def test_ntt_matvec_e1_matches_reference():
    """c[i] = sum_j A[i, j] * x[j] with the field's product (E == 1),
    unblocked and at blocks 1, 2 and 4, against the reference's."""
    ring, ref = get_ring("stark_prime", device="cpu"), ref_ring("stark_prime")
    f = ring.field
    rng = np.random.default_rng(0)
    At = f.rand((16, 3, 5), rng, "cpu")
    xt = f.rand((16, 2, 5), rng, "cpu")
    tm = TModelMul(ring)
    full = ntt_matvec(f, tm, 1, At, xt)
    assert full.shape == (16, 2, 3, 8)
    want = ref_matvec(ref.field, RefTModelMul(ref), 1,
                      jnp.asarray(to_numpy_storage(At)),
                      jnp.asarray(to_numpy_storage(xt)))
    _same(full, want, "unblocked")
    for block in (1, 2, 4):
        assert torch.equal(ntt_matvec(f, tm, 1, At, xt, block), full), block


def test_step_matches_reference(ref_tree):
    """The tree's first level is one W = 2 step: every output bit-equal,
    the challenge's NTT form too; a forced commit block and the ring's
    own digit tables give the same commitment; the auto-block counts the
    limb axis."""
    c_ref, wt, ct, rs, rts, levels, _ = ref_tree
    ring = get_ring("stark_prime", device="cpu")
    f = ring.field
    fs = FoldingStep(ring, N_ROWS, L, BASE)
    assert (fs.k, fs.M) == (16, L * 16)
    rt = fs.precompute_challenge(_p(f, rs[0]))
    assert rt.shape == (16, 1, 1, 8)
    _same(rt, rts[0], "precompute_challenge")
    c = _tables(f, c_ref)
    w, cw = _p(f, wt), _p(f, ct)
    out = fs.step(c, w[:, 0::2], w[:, 1::2], cw[:, 0::2], cw[:, 1::2], rt)
    want = levels[0]
    assert sorted(out) == sorted(want)
    for key, val in want.items():
        _same(out[key], val, key)
    assert bool(out["ok_l2"].all())
    d_ntt = fs.tm.crt_t(out["digits"])
    assert torch.equal(fs.commit(c, d_ntt, block=5), out["cd"])
    own = {"Agt": c["Agt"]}
    assert torch.equal(fs.commit(own, d_ntt), out["cd"])
    assert fs.commit_block(1 << 11) == max(
        1, FoldingStep._COMMIT_BUDGET_WORDS // (16 * (1 << 11) * N_ROWS * 8))


def test_tree_matches_reference_and_verifies(ref_tree):
    """The port's 4-leaf tree on the reference's tables and leaves: every
    level and the root bit-equal; verify accepts, and rejects a tampered
    digit commitment and a tampered folded witness."""
    c_ref, wt, ct, rs, rts, levels, root = ref_tree
    ring = get_ring("stark_prime", device="cpu")
    f = ring.field
    tr = FoldingTree(ring, N_ROWS, L, base=BASE, psi_check=False)
    c = _tables(f, c_ref)
    w, cw = _p(f, wt), _p(f, ct)
    assert torch.equal(tr.commit_witnesses(c, w), cw)
    prts = tr.precompute_challenges([_p(f, r) for r in rs])
    got, groot, _ = tr.prove(c, w, cw, prts)
    _same(groot, root, "root")
    for lvl, (o, want) in enumerate(zip(got, levels)):
        for key, val in want.items():
            _same(o[key], val, (lvl, key))
    assert tr.verify(c, w, cw, got, prts)
    bad = [dict(o) for o in got]
    bad[0]["cd"] = f.add(bad[0]["cd"], f.ones((), "cpu"))
    assert not tr.verify(c, w, cw, bad, prts)
    bad = [dict(o) for o in got]
    bad[1]["s"] = f.neg(bad[1]["s"])
    assert not tr.verify(c, w, cw, bad, prts)


def test_mle_and_sumcheck_match_reference():
    """DenseMLE evaluate, fix_variables and fix_last_variables, and the
    generic k-ary sumcheck prover in msb order (k = 2 and 3, nv = 4)
    against the reference's, on the same limb tables."""
    f = get_ring("stark_prime", device="cpu").field
    rf = ref_ring("stark_prime").field
    rng = np.random.default_rng(1)
    nv = 4
    tables = [f.rand((1 << nv,), rng, "cpu") for _ in range(3)]
    chal = f.rand((nv,), rng, "cpu")
    np_t = [to_numpy_storage(t) for t in tables]
    np_c = to_numpy_storage(chal)
    e, re_ = FieldElems(f, "cpu"), RefFieldElems(rf)
    m, rm = DenseMLE(e, nv, tables[0]), RefDenseMLE(re_, nv,
                                                    jnp.asarray(np_t[0]))
    pts = [chal[i] for i in range(nv)]
    rpts = [jnp.asarray(np_c[i]) for i in range(nv)]
    _same(m.evaluate(pts), rm.evaluate(rpts), "evaluate")
    _same(m.fix_variables(pts[:2]).evals,
          rm.fix_variables(rpts[:2]).evals, "fix_variables")
    _same(m.fix_last_variables(pts[:1]).evals,
          rm.fix_last_variables(rpts[:1]).evals, "fix_last_variables")
    for k in (2, 3):
        msgs, finals = sumcheck_prove_many(tables[:k], chal,
                                           field="stark_prime")
        rmsgs, rfinals = RS.sumcheck_prove_many_with_challenges(
            rf, [jnp.asarray(t) for t in np_t[:k]], jnp.asarray(np_c),
            order="msb")
        assert msgs.shape == (nv, k + 1, 8)
        _same(msgs, rmsgs, ("msgs", k))
        for got, want in zip(finals, rfinals):
            _same(got, want, ("finals", k))
