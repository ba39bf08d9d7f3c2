"""The port's Fiat-Shamir transcript and the slice end to end: the same
absorbs squeeze the same bytes and field elements as the JAX
``Transcript`` (Goldilocks, and BabyBear and frog, whose Montgomery
storage is serialized as canonical values), and the port's sumcheck
``prove`` gives the same sum, messages and challenges as the JAX
example's round loop (nv = 14 over Goldilocks, nv = 10 over BabyBear and
frog), which the port's ``verify`` accepts and a tampered proof fails.
Exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.mle.sumcheck import sumcheck_fold, sumcheck_round
from stark_rings_tpu.rings.absorb import Transcript as RTranscript
from stark_rings_tpu.utils import serialize as RSer

from stark_rings_tpu_torch import (from_jax_storage, get_field,
                                   to_numpy_storage, to_numpy_u64, to_torch)
from stark_rings_tpu_torch.examples import sumcheck as example
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.linalg import FieldElems
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.rings import absorb as A

Q = F.q


def _np(t):
    return to_numpy_u64(t)


def test_serialization_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, Q, (3, 5), dtype=np.uint64)
    x[0, :3] = [0, Q - 1, 2**63]
    assert A.elem_nbytes(F) == RSer.elem_nbytes(RF) == 8
    want = RSer.elements_to_bytes(RF, jnp.asarray(x))
    assert A.elements_to_bytes(F, to_torch(x, "cpu")) == want
    assert A.elements_to_bytes(F, x) == want
    assert A.to_absorb(F, to_torch(x[1, 2], "cpu")) == \
        RSer.elements_to_bytes(RF, jnp.asarray(x[1, 2]))


def test_transcript_matches_reference():
    """Interleaved absorbs (tensors of several shapes, a scalar, raw
    bytes) and squeezes give the same bytes and field elements."""
    rng = np.random.default_rng(1)
    mine, ref = A.Transcript(b"parity"), RTranscript(b"parity")
    for step in range(4):
        x = rng.integers(0, Q, (step + 1, 2), dtype=np.uint64)
        mine.absorb(b"x", F, to_torch(x, "cpu"))
        ref.absorb(b"x", RF, jnp.asarray(x))
        s = rng.integers(0, Q, (), dtype=np.uint64)
        mine.absorb(b"s", F, to_torch(s, "cpu"))
        ref.absorb(b"s", RF, jnp.asarray(s))
        mine.absorb_bytes(b"raw", bytes([step]) * 7)
        ref.absorb_bytes(b"raw", bytes([step]) * 7)
        assert mine.squeeze_bytes(33) == ref.squeeze_bytes(33)
        n = 3 * step + 1
        got = mine.squeeze_field_elements(F, n, "cpu")
        assert got.shape == (n,) and got.dtype == torch.int64
        assert np.array_equal(_np(got), np.asarray(
            ref.squeeze_field_elements(RF, n)))


def _jax_round_loop(g, h, nv, RF=RF):
    """The JAX example's prover loop (examples/sumcheck.py prove) on the
    JAX transcript, over the reference field ``RF``: (S, messages,
    challenges) as storage ints."""
    tr = RTranscript(b"sumcheck")
    G, H = jnp.asarray(g), jnp.asarray(h)
    S = RF.sum(RF.mul(G, H), axis=0)
    tr.absorb(b"sum", RF, S)
    msgs, chals = [], []
    for _ in range(nv):
        p0, p1, p2, G0, H0, dG, dH = sumcheck_round(RF, G, H)
        for lbl, p in ((b"p0", p0), (b"p1", p1), (b"p2", p2)):
            tr.absorb(lbl, RF, p)
        (r,) = tr.squeeze_field_elements(RF, 1)
        G, H = sumcheck_fold(RF, r, G0, H0, dG, dH)
        msgs.append([int(p0), int(p1), int(p2)])
        chals.append(int(r))
    return int(S), msgs, chals


def test_sumcheck_proof_matches_the_jax_example_at_nv14():
    nv = 14
    rng = np.random.default_rng(14)
    g = rng.integers(0, Q, 1 << nv, dtype=np.uint64)
    h = rng.integers(0, Q, 1 << nv, dtype=np.uint64)
    S, msgs, chals = example.prove(to_torch(g, "cpu"), to_torch(h, "cpu"),
                                   A.Transcript(b"sumcheck"), nv)
    want_S, want_msgs, want_chals = _jax_round_loop(g, h, nv)
    assert int(_np(S)) == want_S
    assert [[int(_np(p)) for p in m] for m in msgs] == want_msgs
    assert [int(_np(r)) for r in chals] == want_chals

    e = FieldElems(F, "cpu")
    gm, hm = DenseMLE(e, nv, to_torch(g, "cpu")), \
        DenseMLE(e, nv, to_torch(h, "cpu"))
    assert example.verify(S, msgs, gm, hm, A.Transcript(b"sumcheck"))
    for i, j in ((0, 0), (nv // 2, 1), (nv - 1, 2)):
        bad = [list(m) for m in msgs]
        bad[i][j] = F.add(bad[i][j], F.const(1, "cpu"))
        assert not example.verify(S, [tuple(m) for m in bad], gm, hm,
                                  A.Transcript(b"sumcheck")), (i, j)
    with pytest.raises(ValueError, match="2\\^13"):
        example.prove(to_torch(g, "cpu"), to_torch(h, "cpu"),
                      A.Transcript(b"sumcheck"), 13)


def test_example_main_runs():
    example.main(n_vars=9, device="cpu")


# -- BabyBear and frog --------------------------------------------------------

OTHER_FIELDS = ["babybear", "frog"]


def _storage(f, rng, shape):
    dt = np.uint32 if f.dtype == torch.int32 else np.uint64
    return rng.integers(0, f.q, shape, dtype=dt)


@pytest.mark.parametrize("field", OTHER_FIELDS)
def test_serialization_matches_reference_fields(field):
    """Canonical little-endian bytes (4 for BabyBear, 8 for frog) of
    Montgomery storage, from tensors and from numpy storage."""
    f, rf = get_field(field), ref_field(field)
    rng = np.random.default_rng(2)
    x = _storage(f, rng, (3, 5))
    x[0, :3] = f.storage_np([0, 1, f.q - 1])
    assert A.elem_nbytes(f) == RSer.elem_nbytes(rf) == \
        (4 if field == "babybear" else 8)
    want = RSer.elements_to_bytes(rf, jnp.asarray(x))
    assert A.elements_to_bytes(f, from_jax_storage(f, x, "cpu")) == want
    assert A.elements_to_bytes(f, x) == want
    assert want != x.astype(x.dtype.newbyteorder("<")).tobytes()
    assert A.to_absorb(f, from_jax_storage(f, x[1, 2], "cpu")) == \
        RSer.elements_to_bytes(rf, jnp.asarray(x[1, 2]))


@pytest.mark.parametrize("field", OTHER_FIELDS)
def test_transcript_matches_reference_fields(field):
    """Interleaved absorbs of storage tensors and squeezes of field
    elements (rejection sampling on the canonical values, returned as
    storage) give the reference's bytes and elements."""
    f, rf = get_field(field), ref_field(field)
    rng = np.random.default_rng(3)
    mine, ref = A.Transcript(b"parity"), RTranscript(b"parity")
    for step in range(4):
        x = _storage(f, rng, (step + 1, 2))
        mine.absorb(b"x", f, from_jax_storage(f, x, "cpu"))
        ref.absorb(b"x", rf, jnp.asarray(x))
        assert mine.squeeze_bytes(17) == ref.squeeze_bytes(17)
        n = 5 * step + 1
        got = mine.squeeze_field_elements(f, n, "cpu")
        assert got.shape == (n,) and got.dtype == f.dtype
        assert np.array_equal(to_numpy_storage(got), np.asarray(
            ref.squeeze_field_elements(rf, n)))


@pytest.mark.parametrize("field", OTHER_FIELDS)
def test_fiat_shamir_round_trip_fields(field):
    """prove over the field equals the JAX round loop (sum, messages and
    challenges), verify accepts through DenseMLE.evaluate, and a proof
    with one message changed is rejected."""
    nv = 10
    f, rf = get_field(field), ref_field(field)
    rng = np.random.default_rng(nv)
    g, h = _storage(f, rng, 1 << nv), _storage(f, rng, 1 << nv)
    gt, ht = from_jax_storage(f, g, "cpu"), from_jax_storage(f, h, "cpu")
    S, msgs, chals = example.prove(gt, ht, A.Transcript(b"sumcheck"), nv, f)
    want_S, want_msgs, want_chals = _jax_round_loop(g, h, nv, rf)

    def ints(t):
        return int(to_numpy_storage(t))

    assert ints(S) == want_S
    assert [[ints(p) for p in m] for m in msgs] == want_msgs
    assert [ints(r) for r in chals] == want_chals
    e = FieldElems(f, "cpu")
    gm, hm = DenseMLE(e, nv, gt), DenseMLE(e, nv, ht)
    assert example.verify(S, msgs, gm, hm, A.Transcript(b"sumcheck"))
    for i, j in ((0, 0), (nv - 1, 2)):
        bad = [list(m) for m in msgs]
        bad[i][j] = f.add(bad[i][j], f.const(1, "cpu"))
        assert not example.verify(S, [tuple(m) for m in bad], gm, hm,
                                  A.Transcript(b"sumcheck")), (i, j)
    example.main(n_vars=6, device="cpu", field=field)
