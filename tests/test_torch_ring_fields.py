"""What the port's ring models stand on, on the CPU against the JAX
reference: the field methods they call (``take_coeff``, ``select``,
``is_zero``, ``geq``, ``canon_const``, ``widen`` / ``reduce_words``,
``square_table`` / ``pow_with_table``, ``from_random_bytes``,
``rand_ints``, ``reduce_u64``) over goldilocks, babybear and frog; frog's
digit matrix ``Mont64PrescaledMat`` (weights, REDC fold and map, both
digit schemes); and the frog power rings at logN = 1 and 2.  Inputs are
numpy-seeded storage words carried across; outputs are compared through
``decode`` or the storage bytes, with no differing value allowed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.ops.mxu_dense import (Mont64PrescaledMat as
                                           RefMont64PrescaledMat)
from stark_rings_tpu.rings import get_power_ring as ref_power_ring

from stark_rings_tpu_torch import (FROG, from_jax_storage, get_field,
                                   get_power_ring, to_numpy_storage)
from stark_rings_tpu_torch.ops import mxu_dense

NAMES = ["goldilocks", "babybear", "frog"]


def _dtype(f):
    return np.uint32 if f.dtype == torch.int32 else np.uint64


@pytest.mark.parametrize("unsigned", [True, False], ids=["u8", "s8"])
def test_mont64_prescaled_matches_reference(unsigned):
    """frog's digit matrix: its weights byte-equal to the reference's, its
    REDC fold equal on buckets from the GEMM, at the bound, zero and the
    whole int32 range, and the dense map equal on storage words."""
    rng = np.random.default_rng(3 + unsigned)
    q = FROG.q
    m = rng.integers(0, q, (16, 16), dtype=np.uint64).astype(object)
    ref = RefMont64PrescaledMat(ref_field("frog"), m, unsigned=unsigned)
    port = mxu_dense.Mont64PrescaledMat(m, unsigned)
    assert port.big.dtype == ref.big.dtype
    assert port.big.tobytes() == ref.big.tobytes()
    x = rng.integers(0, q, (16, 24), dtype=np.uint64)
    w, corr = mxu_dense.digit_table(port.big, "cpu")
    V = port.dot(from_jax_storage(FROG, x, "cpu"), w, corr)
    bound = (1 << 26) - 1 if not unsigned else (1 << 27) - 1
    cases = [V, torch.full_like(V, bound), torch.zeros_like(V),
             torch.from_numpy(rng.integers(-2**31, 2**31, V.shape)
                              .astype(np.int32))]
    for Vc in cases:
        want = np.asarray(ref.fold(jnp.asarray(Vc.numpy())))
        assert np.array_equal(to_numpy_storage(port.fold(Vc)), want)
    want = np.asarray(ref(jnp.asarray(x.T)))
    dense = mxu_dense.prescaled_dense(FROG, m, "cpu") if unsigned else None
    if unsigned:
        assert np.array_equal(to_numpy_storage(dense(from_jax_storage(
            FROG, x.T.copy(), "cpu"))), want)
    else:
        got = mxu_dense.apply_cols(port, from_jax_storage(FROG, x, "cpu"),
                                   w, corr)
        assert np.array_equal(to_numpy_storage(got).T, want)


@pytest.mark.parametrize("name", NAMES)
def test_field_methods_match_reference(name):
    f, rf = get_field(name), ref_field(name)
    rng = np.random.default_rng(11)
    dt = _dtype(f)
    x_np = rng.integers(0, f.q, (6, 5), dtype=dt)
    x_np[0, :3] = [0, 1, f.q - 1]
    x, x_r = from_jax_storage(f, x_np, "cpu"), jnp.asarray(x_np)

    def same(got, want):
        assert f.decode(got).tolist() == rf.decode(want).tolist()

    idx = np.array([[4, 0], [2, 2]])
    same(f.take_coeff(x, idx), rf.take_coeff(x_r, idx))
    same(f.take_coeff(x, np.array(3)), rf.take_coeff(x_r, np.array(3)))
    cond = x_np > x_np[:, :1]
    same(f.select(torch.from_numpy(cond), x, x.flip(0)),
         rf.select(cond, x_r, x_r[::-1]))
    assert np.array_equal(f.is_zero(x).numpy(), np.asarray(rf.is_zero(x_r)))
    cx, cx_r = f.canon(x), rf.canon(x_r)
    half = (f.q - 1) // 2
    assert np.array_equal(f.geq(f.canon_const(half), cx).numpy(),
                          np.asarray(rf.geq(rf.canon_const(half), cx_r)))
    assert np.array_equal(f.geq(cx, cx.flip(1)).numpy(),
                          np.asarray(rf.geq(cx_r, cx_r[:, ::-1])))
    assert to_numpy_storage(torch.tensor(f.canon_const(-1), dtype=f.dtype)
                            ) == rf.canon_const(-1)
    w = f.widen(x)
    assert np.array_equal(w.numpy().view(np.uint64),
                          np.asarray(rf.widen(x_r)))
    acc = w.sum(dim=0)
    same(f.reduce_words(acc), rf.reduce_words(jnp.asarray(
        acc.numpy().view(np.uint64))))
    assert torch.equal(f.reduce_words(acc), f.sum(x, 0))
    big = rng.integers(0, 2**63, (3, 4), dtype=np.int64).view(np.uint64)
    big[0, 0] = np.uint64(2**64 - 1)
    same(f.reduce_words(torch.from_numpy(big.view(np.int64))),
         rf.reduce_words(jnp.asarray(big)))
    table = f.square_table(x[1])
    assert len(table) == rf.bits
    same(f.pow_with_table(table, 0), jnp.broadcast_to(rf.pow_with_table(
        rf.square_table(x_r[1]), 0), x_r[1].shape))
    same(f.pow_with_table(table, 123456789),
         rf.pow_with_table(rf.square_table(x_r[1]), 123456789))
    nb = (rf.bits + 7) // 8
    for data in (bytes(nb), b"\xff" * nb, bytes(range(1, nb + 1)), b"\x01"):
        assert f.from_random_bytes(data) == rf.from_random_bytes(data)
    ints = f.rand_ints((3, 4), rng)
    assert ints.shape == (3, 4) and all(0 <= int(v) < f.q
                                        for v in ints.reshape(-1))
    assert isinstance(f.rand_ints((), rng), int)
    if name == "goldilocks":
        u = np.array([0, f.q - 1, f.q, 2**64 - 1], dtype=np.uint64)
        assert np.array_equal(
            to_numpy_storage(f.reduce_u64(from_jax_storage(f, u, "cpu"))),
            np.asarray(rf.reduce_u64(jnp.asarray(u))))


def test_frog_power_rings_build():
    """frog power rings at logN = 1 and 2 on NTTContext, as in the
    reference; logN = 3 exceeds frog's 2-adicity and raises; the
    digit-GEMM engine refuses frog."""
    ring = get_power_ring("frog", 2, device="cpu")
    ref = ref_power_ring("frog", 2)
    q = ring.q
    x, y = ([1, 2, 3, 4], [5, 6, 7, 8])
    want = [q - 56, q - 36, 2, 60]
    got = ring.coeff_mul(ring.encode_coeffs(x), ring.encode_coeffs(y))
    assert ring.decode(got).tolist() == want
    assert ref.decode(ref.coeff_mul(ref.encode_coeffs(x),
                                    ref.encode_coeffs(y))).tolist() == want
    for logN in (1, 2):
        ring, ref = (get_power_ring("frog", logN, device="cpu"),
                     ref_power_ring("frog", logN))
        rng = np.random.default_rng(logN)
        a, b = (rng.integers(0, q, (5, ring.D), dtype=np.uint64)
                for _ in range(2))
        ta, tb = (from_jax_storage(ring.field, v, "cpu") for v in (a, b))
        got = ring.coeff_mul(ta, tb)
        assert ring.decode(got).tolist() == ref.decode(ref.coeff_mul(
            jnp.asarray(a), jnp.asarray(b))).tolist()
        assert torch.equal(ring.icrt(ring.ntt_mul(ring.crt(ta),
                                                  ring.crt(tb))), got)
    with pytest.raises(ValueError, match="2-adicity 3"):
        get_power_ring("frog", 3, device="cpu")
    with pytest.raises(ValueError, match="no digit-GEMM engine over frog"):
        get_power_ring("frog", 2, device="cpu").mxu_ctx()
