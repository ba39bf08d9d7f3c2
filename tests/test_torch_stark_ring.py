"""The port's D = 16 stark_prime ring model and the layers that branch on
the limb axis, on the CPU against the JAX reference: ``RingModel`` (the
CRT / ICRT digit GEMM, the staged oracle, coefficient and slot ops) and
the Rust golden vectors of stark_prime/ntt.rs through it,
``TModelMul`` (mul_t, the commit matvec_t), the power ring, balanced
decomposition (the stark_prime/decomposition.rs:72-99 golden vector,
the multi-limb division at b = 2^32 - 2, the lexicographic L-infinity
tree, the exact L2 words), ``Matrix`` and the element adapters,
``Rq``, sampling, monomials and the transcript.  Inputs are made from
numpy seeds (the reference's own draws where its functions draw);
the tolerance is exact equality."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stark_rings_tpu.decomp as RD
from stark_rings_tpu.ops.model_mul import TModelMul as RefTModelMul
from stark_rings_tpu.rings import get_ring as ref_ring
from stark_rings_tpu.rings import monomial as ref_mono
from stark_rings_tpu.rings import sampling as ref_sampling
from stark_rings_tpu.rings.absorb import Transcript as RefTranscript

import stark_rings_tpu_torch.decomp as PD
from stark_rings_tpu_torch import (from_jax_consts, from_jax_storage,
                                   get_power_ring, to_numpy_storage)
from stark_rings_tpu_torch.decomp import norms
from stark_rings_tpu_torch.decomp.balanced import _divmod_limbs
from stark_rings_tpu_torch.linalg import FieldElems, Matrix, RingElems
from stark_rings_tpu_torch.ops.dense_linear import (DenseModMat,
                                                    probe_dense_matrix)
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.rings import Rq, Transcript, get_ring, monomial
from stark_rings_tpu_torch.rings import sampling
from stark_rings_tpu_torch.spec.decomp import (decompose_balanced_fixed,
                                               to_signed)

B = 3


def _golden():
    """tests/test_spec_golden.py's module, for its stark_prime vectors."""
    path = pathlib.Path(__file__).with_name("test_spec_golden.py")
    spec = importlib.util.spec_from_file_location("_stark_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rings():
    ring = get_ring("stark_prime", device="cpu")
    return ring, ref_ring("stark_prime"), ring.field


def _t(f, x):
    return from_jax_storage(f, np.asarray(x), "cpu")


def _np(x):
    return to_numpy_storage(x)


def test_ring_shape_and_crt_match_reference(rings):
    """crt / icrt (one digit GEMM and its S3 fold) equal the reference's
    and the staged butterfly oracle; the digit tables are byte-equal and
    the reference's, carried across, give the same maps."""
    P, R, f = rings
    assert (P.D, P.N, P.E) == (R.D, R.N, R.E) == (16, 16, 1)
    rng = np.random.default_rng(0)
    a = P.rand_coeff((B,), rng)
    assert a.shape == (B, 16, 8) and a.dtype == torch.int32
    fa = P.crt(a)
    assert np.array_equal(_np(fa), np.asarray(jax.jit(R.crt)(_np(a))))
    assert torch.equal(P.crt_staged(a), fa)
    assert torch.equal(P.icrt(fa), a) and torch.equal(P.icrt_staged(fa), a)
    ref_c = {k: np.asarray(v) for k, v in R.mul_consts().items()}
    for k, v in P.mul_consts().items():
        assert v.dtype == ref_c[k].dtype and np.array_equal(v, ref_c[k])
    c = from_jax_consts(ref_c, "cpu")
    assert torch.equal(P.crt(a, c), fa) and torch.equal(P.icrt(fa, c), a)
    assert torch.equal(P.crt(a[:2].reshape(2, 1, 16, 8)),
                       fa[:2].reshape(2, 1, 16, 8))
    # the same map as field products and a modular sum (DenseModMat)
    mat = probe_dense_matrix(P.spec.crt, 16, 16, f.q)
    assert torch.equal(DenseModMat(f, mat, "cpu")(a), fa)


def test_golden_vectors_through_the_ring(rings):
    """stark_prime/ntt.rs's golden vectors (tests/test_spec_golden.py)
    through the ring's CRT GEMM, its ICRT and its staged oracle."""
    P, _, _ = rings
    g = _golden()
    for poly, ev in ((g.SP_POLY1, g.SP_EVAL1), (g.SP_POLY2, g.SP_EVAL2)):
        x = P.encode_coeffs(np.array(poly, dtype=object))
        assert [int(v) for v in P.decode(P.crt(x))] == ev
        assert [int(v) for v in P.decode(P.crt_staged(x))] == ev
        y = P.encode_coeffs(np.array(ev, dtype=object))
        assert [int(v) for v in P.decode(P.icrt(y))] == poly


def test_ring_ops_match_reference(rings):
    P, R, f = rings
    rng = np.random.default_rng(1)
    a, b = P.rand_coeff((B,), rng), P.rand_coeff((B,), rng)
    A, Bn = _np(a), _np(b)
    cm = P.coeff_mul(a, b)
    # the reference's multiply through its ring, run op by op (its jitted
    # coeff_mul takes half a minute to compile on the CPU)
    want = R.icrt(R.ntt_mul(R.crt(jnp.asarray(A)), R.crt(jnp.asarray(Bn))))
    assert np.array_equal(_np(cm), np.asarray(want))
    for r in range(B):
        assert [int(v) for v in P.decode(cm[r])] == P.spec.coeff_mul(
            [int(v) for v in P.decode(a[r])], [int(v) for v in P.decode(b[r])])
    assert np.array_equal(_np(P.rot(a)), np.asarray(R.rot(jnp.asarray(A))))
    assert torch.equal(P.pow_rot(a, 16), P.neg(a))
    fa, fb = P.crt(a), P.crt(b)
    assert torch.equal(P.ntt_mul(fa, fb), f.mul(fa, fb))
    assert torch.equal(P.icrt(P.ntt_mul(fa, fb)), cm)
    assert np.array_equal(_np(P.ntt_pow(fa, 0)),
                          np.asarray(R.ntt_pow(jnp.asarray(_np(fa)), 0)))
    assert torch.equal(P.ntt_pow(fa, 3), f.mul(f.mul(fa, fa), fa))
    assert torch.equal(P.ntt_frobenius(fa, 1), fa)
    assert torch.equal(P.ntt_mul(fa, P.ntt_inv(fa)),
                       P.from_scalar_ntt(1, (B,)))
    for fn in ("from_scalar_coeff", "from_scalar_ntt"):
        assert np.array_equal(_np(getattr(P, fn)(5, (2,))),
                              np.asarray(getattr(R, fn)(5, (2,))))
    x = a[None].expand(2, B, 16, 8)
    flat = P.flatten(x)
    assert flat.shape == (2, B * 16, 8)
    assert np.array_equal(_np(flat), np.asarray(R.flatten(jnp.asarray(
        _np(x)))))
    assert torch.equal(P.promote(flat), x)
    with pytest.raises(ValueError, match="multiple of D"):
        P.promote(flat[:, 1:])


def test_model_mul_matches_reference(rings):
    """TModelMul over the limbed model: mul_t (against the reference's
    TModelMul, run op by op), square_t, mul_cached_t and the commit
    matvec_t (unblocked and blocked)."""
    P, R, f = rings
    tm, rt = TModelMul(P), RefTModelMul(R)
    rng = np.random.default_rng(2)
    a, b = P.rand_coeff((5,), rng), P.rand_coeff((5,), rng)
    at, bt = tm.to_t(a), tm.to_t(b)
    assert at.shape == (16, 5, 8) and torch.equal(tm.from_t(at), a)
    got = tm.mul_t(at, bt)
    want = np.asarray(rt.mul_t(jnp.asarray(_np(at)), jnp.asarray(_np(bt))))
    assert np.array_equal(_np(got), want)
    assert torch.equal(tm.mul(a, b), P.coeff_mul(a, b))
    assert torch.equal(tm.square_t(at), tm.mul_t(at, at))
    assert torch.equal(tm.mul_cached_t(at, tm.precompute_t(bt[:, :1])),
                       tm.mul_t(at, bt[:, :1].expand(16, 5, 8)))
    A = f.rand((16, 3, 7), rng, "cpu")
    xs = f.rand((16, 2, 7), rng, "cpu")
    full = tm.matvec_t(A, xs)
    assert full.shape == (16, 2, 3, 8)
    assert torch.equal(tm.matvec_t(A, xs, block=3), full)
    assert torch.equal(tm.matvec_t(A, xs[:, 0]), full[:, 0])
    want = f.sum(f.mul(A[:, None], xs[:, :, None]), axis=3)
    assert torch.equal(full, want)


def test_power_ring_matches_reference(rings):
    """The limb axis of PowerRing (deg 2^4): mxu_ctx (the MxuLimbNTT
    engine) against the radix NTT (held to the reference's in
    test_torch_stark_field), flatten and powers; rot and the scalars
    against the reference's D = 16 model, whose X^16 = -1 makes them the
    power ring's (the reference's power ring would factor q - 1 by trial
    division first)."""
    _, R, _ = rings
    P = get_power_ring("stark_prime", 4, device="cpu")
    f = P.field
    rng = np.random.default_rng(3)
    a, b = P.rand_coeff((2,), rng), P.rand_coeff((2,), rng)
    A = jnp.asarray(_np(a))
    prod = P.mxu_ctx().mul(a, b)
    assert torch.equal(prod, P.coeff_mul(a, b))
    assert torch.equal(P.coeff_square(a), P.coeff_mul(a, a))
    assert torch.equal(P.coeff_mul_cached(a, P.precompute(b)), prod)
    assert type(P.mxu_ctx(pallas=False)) is type(P.mxu_ctx())
    assert np.array_equal(_np(P.rot(a)), np.asarray(R.rot(A)))
    assert np.array_equal(_np(P.from_scalar_ntt(3, (2,))),
                          np.asarray(R.from_scalar_ntt(3, (2,))))
    fa = P.crt(a)
    assert torch.equal(P.ntt_pow(fa, 0), P.from_scalar_ntt(1, (2,)))
    assert torch.equal(P.ntt_pow(fa, 2), f.mul(fa, fa))
    flat = P.flatten(a[None])
    assert flat.shape == (1, 32, 8) and torch.equal(P.promote(flat), a[None])


def test_limb_jit_mul_matches_reference(rings):
    """``MxuLimbNTT.jit_mul`` (on the CPU the multiply itself) against
    the reference's ``jit_mul`` at config 3's degree 2^12, B = 2: one
    compile of the reference's limbed multiply (about 40 s here)."""
    from stark_rings_tpu.fields import STARK as RS
    from stark_rings_tpu.ops.mxu_limb import MxuLimbNTT as RefMxuLimbNTT

    from stark_rings_tpu_torch.ops.mxu_limb import MxuLimbNTT

    _, _, f = rings
    N = 1 << 12
    rng = np.random.default_rng(17)
    a, b = (f.rand((2, N), rng, "cpu") for _ in range(2))
    port = MxuLimbNTT(N, device="cpu")
    got = port.jit_mul()(a, b)
    assert got.shape == (2, N, 8)
    want = RefMxuLimbNTT(RS, N).jit_mul()(jnp.asarray(_np(a)),
                                          jnp.asarray(_np(b)))
    assert np.array_equal(_np(got), np.asarray(want))


def test_decomposition_golden_and_limb_division(rings):
    """stark_prime/decomposition.rs:72-99's golden vector; the two-half
    limb division at b = 2^32 - 2 (where r * 2^32 + limb passes 2^63)
    against Python ints; the digits at bases 2^16, 2^32 - 2 and 6 against
    the spec's fixed-k digits in Python ints."""
    P, R, f = rings
    x = f.encode([253532532532352325], "cpu")
    q = f.q
    want = [(-27323) % q, (-17255) % q, (-17793) % q, 901] + [0] * 12
    assert [int(v) for v in f.decode(PD.decompose(f, x, 1 << 16, 16))[0]] \
        == want
    rng = np.random.default_rng(4)
    vals = [(1 << 252) - 1, (1 << 224) + 5, 2**32 - 3] + [
        int(v) for v in f.rand_ints((5,), rng)]
    mags = torch.from_numpy(f.limbs_np(vals).astype(np.int64))
    for b in (2**32 - 2, 2**31 + 1, 1 << 16, 6):
        quot, rem = _divmod_limbs(mags, b)
        for i, v in enumerate(vals):
            qv = sum(int(w) << (32 * j) for j, w in enumerate(quot[i]))
            assert (qv, int(rem[i])) == divmod(v, b), (b, i)
    xs = f.rand((6,), rng, "cpu")
    for b in (1 << 16, 2**32 - 2, 6):
        k = PD.decomposition_max_length(q, b)
        dig = PD.decompose(f, xs, b, k)
        assert dig.shape == (6, k, 8)
        for i, v in enumerate(f.decode(xs)):
            assert [int(d) for d in f.decode(dig[i])] == [
                d % q for d in decompose_balanced_fixed(to_signed(int(v), q),
                                                        b, k)], (b, i)
        assert torch.equal(PD.recompose(f, dig, b), xs)


def test_norms_center_sign_and_gadget_match_reference(rings):
    P, R, f = rings
    q = f.q
    vals = [0, 1, q - 1, (q - 1) // 2, (q + 1) // 2, 12345, q - 12345]
    x = f.encode(vals, "cpu")
    X = _np(x)
    for fn in ("center", "sign"):
        assert np.array_equal(_np(getattr(PD, fn)(f, x)),
                              np.asarray(getattr(RD, fn)(R.field, X)))
    neg, mag = PD.signed_magnitude(f, x)
    rneg, rmag = RD.signed_magnitude(R.field, X)
    assert np.array_equal(neg.numpy(), np.asarray(rneg))
    assert np.array_equal(_np(mag), np.asarray(rmag))
    m2 = f.rand((5, 7), np.random.default_rng(5), "cpu")
    for axis in (None, 0, 1):
        assert np.array_equal(_np(PD.linf_norm(f, m2, axis)), np.asarray(
            RD.linf_norm(R.field, jnp.asarray(_np(m2)), axis)))
    assert norms.linf_norm_exact(f, m2) == int(f.decode(
        f.from_canon(PD.linf_norm(f, m2))))
    words = norms.l2_norm_squared_words(f, m2)
    assert norms.words_to_int(words) == norms.l2_norm_squared(f, m2)
    per_row = norms.l2_norm_squared_words(f, m2, axis=1)
    for i in range(5):
        assert norms.words_to_int(per_row[i]) == norms.l2_norm_squared(
            f, m2[i])
    assert bool(norms.l2_check(f, m2, norms.l2_norm_squared(f, m2)))
    assert not bool(norms.l2_check(f, m2, norms.l2_norm_squared(f, m2) - 1))
    a = P.rand_coeff((2, 3), np.random.default_rng(6))
    g = PD.gadget_decompose(f, a, 1 << 16, 16)
    assert g.shape == (2, 48, 16, 8)
    assert torch.equal(PD.gadget_recompose(f, g, 1 << 16, 16), a)
    assert torch.equal(PD.recompose_ring(f, PD.decompose_ring(
        f, a, 1 << 16, 16), 1 << 16), a)


def test_matrix_and_elems_over_limbs(rings):
    """Matrix over NTT-form ring elements and over field elements: the
    k-blocked mul_mat and mul_vec against the slot products summed in
    Python ints; identity, gadget decomposition of a field matrix."""
    P, _, f = rings
    rng = np.random.default_rng(7)
    e = RingElems(P)
    assert e.elem_ndim == 2 and e.elem_shape == (16, 8)
    A = Matrix.rand(e, 2, 5, rng)
    Bm = Matrix.rand(e, 5, 3, rng)
    full = A.mul_mat(Bm)
    assert torch.equal(A.mul_mat(Bm, block=2).vals, full.vals)
    Ai, Bi, Ci = (np.asarray(m.decode()) for m in (A, Bm, full))
    q = f.q
    for i in range(2):
        for j in range(3):
            want = [sum(int(Ai[i, t, d]) * int(Bi[t, j, d])
                        for t in range(5)) % q for d in range(16)]
            assert [int(v) for v in Ci[i, j]] == want
    v = Bm.vals[:, 0]
    assert torch.equal(A.mul_vec(v), full.vals[:, 0])
    ident = Matrix.identity(e, 5)
    assert torch.equal(A.mul_mat(ident).vals, A.vals)
    fe = FieldElems(f, "cpu")
    assert fe.elem_shape == (8,) and fe.one().shape == (8,)
    M = Matrix.rand(fe, 2, 3, rng)
    gm = M.gadget_decompose(1 << 16, 16)
    assert gm.vals.shape == (2, 48, 8)
    assert torch.equal(gm.gadget_recompose(1 << 16, 16).vals, M.vals)


def test_rq_sampling_monomial_and_transcript(rings):
    """Rq over the limbed ring; is_invertible and the short samplers; the
    batched monomial exponent and psi range check against the reference;
    the transcript absorbs and squeezes the reference's bytes and
    elements."""
    P, R, f = rings
    rng = np.random.default_rng(8)
    x = Rq.rand(P, (3,), rng)
    assert x.shape == (3,)
    y = Rq.rand(P, (3,), rng)
    assert torch.equal((x * y).data, P.coeff_mul(x.data, y.data))
    assert torch.equal(x.ct(), x.data[..., :1, :])
    s = sampling.sample_short(P, (4,), rng, 3)
    assert s.shape == (4, 16, 8)
    assert np.array_equal(sampling.is_invertible(P, s).numpy(),
                          np.asarray(ref_sampling.is_invertible(R, _np(s))))
    z = P.zeros((2,))
    assert not sampling.is_invertible(P, z).any()
    assert bool(sampling.is_invertible(P, sampling.sample_short_invertible(
        P, rng, 2)))
    vals = [0, 1, 2, 7, 8, 9, f.q - 1, f.q - 8, f.q - 9, 1 << 40]
    a = f.encode(vals, "cpu")
    mono, ok = monomial.exp_batched(P, a)
    rmono, rok = ref_mono.exp_batched(R, _np(a))
    assert np.array_equal(ok.numpy(), np.asarray(rok))
    assert np.array_equal(_np(mono), np.asarray(rmono))
    assert np.array_equal(monomial.psi_range_check_batched(P, a).numpy(),
                          np.asarray(ref_mono.psi_range_check_batched(
                              R, _np(a))))
    assert [monomial.psi_range_check(P, v) for v in vals] == \
        monomial.psi_range_check_batched(P, a).tolist()
    assert int(f.decode(monomial.ct(P, P.rot(monomial.unit_monomial(
        P, 15))))) == f.q - 1
    t, rt = Transcript(), RefTranscript()
    t.absorb(b"x", f, a)
    rt.absorb(b"x", R.field, _np(a))
    assert t.squeeze_bytes(40) == rt.squeeze_bytes(40)
    got = t.squeeze_ring_element(P)
    want = np.asarray(rt.squeeze_ring_element(R))
    assert got.shape == (16, 8) and np.array_equal(_np(got), want)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sharded_ntt_limb_axis(P):
    """ShardedNTT over stark_prime on P CPU shards (deg 2^6, batch 3):
    mul and inverse(forward) through the plain block-transpose exchange
    equal the radix NTTContext (held to the reference's in
    test_torch_stark_field) and Python ints on a row; the phase functions
    compose to the forward; the single-device four-step (fourstep_ctx)
    agrees; K8 refuses the limbed field."""
    from stark_rings_tpu_torch import NTTContext, ShardedNTT, make_mesh

    f = get_ring("stark_prime", device="cpu").field
    N = 64
    rng = np.random.default_rng(P)
    a, b = (f.rand((3, N), rng, "cpu") for _ in range(2))
    want = NTTContext(f, N, device="cpu").mul(a, b)
    ai, bi = f.decode(a[0]), f.decode(b[0])
    row = [0] * N
    for i in range(N):
        for j in range(N):
            k, s = (i + j) % N, 1 if i + j < N else -1
            row[k] = (row[k] + s * int(ai[i]) * int(bi[j])) % f.q
    assert [int(v) for v in f.decode(want[0])] == row
    sn, mesh = ShardedNTT("stark_prime", N, P), make_mesh(P, device="cpu")
    fwd, inv, mul = sn.make_fns(mesh, batch_ndim=1)
    cs, es = sn.shard_specs(1)
    assert cs == (None, None, "x", None) and es == (None, "x", None, None)
    A = sn.shard(sn.to_matrix(a), cs, mesh)
    Bs = sn.shard(sn.to_matrix(b), cs, mesh)
    assert A[0].shape == (3, 8, 8 // P, 8)
    got = sn.from_matrix(sn.gather(mul(A, Bs), cs, "cpu"))
    assert torch.equal(got, want)
    fa = fwd(A)
    assert fa[0].shape == (3, 8 // P, 8, 8)
    assert torch.equal(sn.from_matrix(sn.gather(inv(fa), cs, "cpu")), a)
    ph = sn.make_phase_fns(mesh, batch_ndim=1)
    for x, y in zip(ph["rows"](ph["exchange"](ph["pre"](A))), fa):
        assert torch.equal(x, y)
    fs, isq, fmul = get_power_ring("stark_prime", 6,
                                   device="cpu").fourstep_ctx()
    assert torch.equal(fmul(a, b), want) and torch.equal(isq(fs(a)), a)
    with pytest.raises(ValueError, match="pallas exchange"):
        ShardedNTT("stark_prime", N, P, exchange="pallas")
