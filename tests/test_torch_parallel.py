"""The port's sharded layer on CPU shards against the JAX reference on
its virtual 8-device CPU mesh (tests/conftest.py): ``psum_words``,
``ShardedModelMul``, ``ShardedMatVec``, ``ShardedSparseMatVec`` and
``ShardedMLE`` (evaluation, fix, sums, the sumcheck provers).  The same
numpy storage goes into both packages, split as the reference's
``PartitionSpec``s split it; results are compared as the reference's
storage with 0 differing bits allowed.  The reference draws from
``random.Random`` as its own tests do.  The kernels' twins are counted,
so the card's routing runs here: K5 once a shard for a Goldilocks
evaluation, K7 once a shard for a sumcheck over Goldilocks, BabyBear and
frog, the model CRT folds (K3, ``bb_fold_end``) three times a shard for
a multiply.  The limbed stark_prime cases are held to the port's
unsharded functions (held to the reference since they were ported),
and to the reference's sharded ones where those run in seconds."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.linalg import FieldElems as RefFieldElems
from stark_rings_tpu.linalg import Matrix as RefMatrix
from stark_rings_tpu.linalg import RingElems as RefRingElems
from stark_rings_tpu.linalg import SparseMatrix as RefSparseMatrix
from stark_rings_tpu.parallel import ShardedMatVec as RefShardedMatVec
from stark_rings_tpu.parallel import ShardedMLE as RefShardedMLE
from stark_rings_tpu.parallel import ShardedModelMul as RefShardedModelMul
from stark_rings_tpu.parallel import \
    ShardedSparseMatVec as RefShardedSparseMatVec
from stark_rings_tpu.parallel import make_mesh as ref_make_mesh
from stark_rings_tpu.parallel.collectives import psum_words as ref_psum_words
from stark_rings_tpu.rings import get_ring as ref_ring

from stark_rings_tpu_torch import (AlgebraError, from_jax_storage,
                                   get_field, to_numpy_storage)
from stark_rings_tpu_torch.linalg import (FieldElems, Matrix, RingElems,
                                          SparseMatrix)
from stark_rings_tpu_torch.mle import DenseMLE
from stark_rings_tpu_torch.mle import fix as FX
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
from stark_rings_tpu_torch.mle.sumcheck import (
    sumcheck_prove_many_with_challenges)
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops import fold_bb as KB
from stark_rings_tpu_torch.ops.model_mul import TModelMul
from stark_rings_tpu_torch.parallel import (ShardedMatVec, ShardedMLE,
                                            ShardedModelMul,
                                            ShardedSparseMatVec, gather,
                                            make_mesh, psum_words, shard)
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


@pytest.fixture
def mesh():
    return make_mesh(PN, device="cpu")


def _port(f, x):
    return from_jax_storage(f, np.asarray(x), "cpu")


def _same(got, want, what=""):
    """``got`` (a storage tensor, or numpy storage) bit-equal to the
    reference's ``want``."""
    if isinstance(got, torch.Tensor):
        got = to_numpy_storage(got)
    assert got.dtype == np.asarray(want).dtype, what
    assert np.array_equal(got, np.asarray(want)), what


def _enc(f, rng, shape):
    """Uniform elements as the reference's numpy storage."""
    n = int(np.prod(shape, dtype=np.int64))
    ints = np.array([rng.randrange(f.q) for _ in range(n)], dtype=object)
    return np.asarray(f.encode(ints.reshape(shape)))


def _counter(monkeypatch, mod, name):
    """Count the calls of ``mod.name`` (a kernel's twin)."""
    calls = [0]
    fn = getattr(mod, name)

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


# -- psum_words ---------------------------------------------------------------


def test_psum_words_is_exact_mod_2_64(ref_mesh):
    """Words near 2^64 from every shard: the int64 sum wraps mod 2^64 as
    the reference's 16-bit-chunk all-reduce does, and equals the
    Python-int sum mod 2^64."""
    rng = np.random.default_rng(3)
    top = np.uint64(2**64 - 1)
    words = top - rng.integers(0, 2**20, (PN, 3, 2), dtype=np.uint64)
    words[0, 0, 0] = top
    words[1, 0, 0] = np.uint64(2**63)
    got = psum_words([torch.from_numpy(w.view(np.int64).copy())
                      for w in words])
    assert got.shape == (3, 2) and got.dtype == torch.int64
    want = [sum(int(w) for w in words[:, i, j]) % 2**64
            for i in range(3) for j in range(2)]
    assert got.numpy().view(np.uint64).reshape(-1).tolist() == want
    ref = jax.jit(jax.shard_map(
        lambda w: ref_psum_words(w[0], "x")[None], mesh=ref_mesh,
        in_specs=P("x"), out_specs=P("x")))(jnp.asarray(words))
    assert np.array_equal(got.numpy().view(np.uint64), np.asarray(ref)[0])


def test_psum_words_checks_its_operands():
    with pytest.raises(ValueError, match="no shards"):
        psum_words([])
    a = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        psum_words([a, a.to(torch.int32)])
    with pytest.raises(ValueError, match="int64"):
        psum_words([a, a[:2]])


# -- ShardedModelMul ----------------------------------------------------------

_FOLDS = {"goldilocks": (K, "fold_end_ref"),
          "babybear": (KB, "bb_fold_end_ref")}


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_sharded_model_mul_matches_reference(name, ref_mesh, mesh,
                                             monkeypatch):
    """mul, ntt_mul and the challenge multiply at B = 16 over 8 shards,
    bit-equal to the reference's ShardedModelMul; each shard's mul_t
    runs its model CRT fold three times (K3 / bb_fold_end on the card,
    their twins here) and the challenge multiply two a shard and one
    a device."""
    rr = ref_ring(name)
    ring = get_ring(name, device="cpu")
    f = ring.field
    rng = random.Random(5)
    B = 16
    a = np.asarray(rr.rand_coeff((B,), rng))
    b = np.asarray(rr.rand_coeff((B,), rng))
    ch = b[:1]
    ref = RefShardedModelMul(rr, ref_mesh)
    smm = ShardedModelMul(ring, mesh)
    assert smm.spec() == ("x", None)
    sa, sb = smm.shard(a), smm.shard(b)
    assert len(sa) == PN and sa[0].shape == (B // PN, ring.D)
    calls = (_counter(monkeypatch, *_FOLDS[name]) if name in _FOLDS
             else [0])
    got = smm.make_mul_fn()(sa, sb)
    assert calls[0] == (3 * PN if name in _FOLDS else 0)
    _same(gather(got), ref.make_mul_fn()(a, b), "mul")
    na, nb = np.asarray(rr.crt(a)), np.asarray(rr.crt(b))
    _same(smm.gather(smm.make_ntt_mul_fn()(smm.shard(na), smm.shard(nb))),
          ref.make_ntt_mul_fn()(na, nb), "ntt_mul")
    calls[0] = 0
    got_c = smm.make_challenge_mul_fn()(sa, _port(f, ch))
    assert calls[0] == (2 * PN + 1 if name in _FOLDS else 0)
    _same(smm.gather(got_c), ref.make_challenge_mul_fn()(a, ch), "challenge")


def test_sharded_model_mul_stark_prime(mesh):
    """The limbed model: the sharded multiplies equal the port's
    unsharded TModelMul (held to the reference since it was ported; the
    reference's sharded limbed multiply takes minutes here)."""
    ring = get_ring("stark_prime", device="cpu")
    rng = np.random.default_rng(6)
    B = 16
    a, b = ring.rand_coeff((B,), rng), ring.rand_coeff((B,), rng)
    smm = ShardedModelMul(ring, mesh)
    assert smm.spec() == ("x", None, None)
    tm = TModelMul(ring)
    sa, sb = smm.shard(a), smm.shard(b)
    assert sa[0].shape == (B // PN, ring.D, 8)
    assert torch.equal(smm.gather(smm.make_mul_fn()(sa, sb), "cpu"),
                       tm.mul(a, b))
    na, nb = ring.crt(a), ring.crt(b)
    assert torch.equal(smm.gather(smm.make_ntt_mul_fn()(
        smm.shard(na), smm.shard(nb)), "cpu"), ring.ntt_mul(na, nb))
    assert torch.equal(smm.gather(smm.make_challenge_mul_fn()(sa, b[:1]),
                                  "cpu"),
                       tm.mul(a, b[:1].expand(a.shape)))


def test_sharded_model_mul_checks_shards(mesh):
    ring = get_ring("goldilocks", device="cpu")
    smm = ShardedModelMul(ring, mesh)
    a = smm.shard(ring.rand_coeff((16,), np.random.default_rng(0)))
    fn = smm.make_mul_fn()
    with pytest.raises(ValueError, match="8 torch.int64 shards"):
        fn(a[:7], a[:7])
    with pytest.raises(ValueError, match="shards"):
        fn(a, [x.to(torch.int32) for x in a])
    with pytest.raises(ValueError, match="shards"):
        fn(a, a[:-1] + [a[-1].to("meta")])
    with pytest.raises(ValueError, match="does not split"):
        smm.shard(ring.rand_coeff((12,), np.random.default_rng(0)))


# -- ShardedMatVec, ShardedSparseMatVec ---------------------------------------


def test_sharded_matvec_ring_matches_reference(ref_mesh, mesh):
    """Goldilocks ring elements, A 3 x 16, columns over 8 shards."""
    rr = ref_ring("goldilocks")
    ring = get_ring("goldilocks", device="cpu")
    rng = random.Random(110)
    n, m = 3, 16
    A = RefMatrix.rand(RefRingElems(rr), n, m, rng)
    v = np.asarray(rr.rand_ntt((m,), rng))
    want = RefShardedMatVec(RefRingElems(rr), ref_mesh).make_matvec_fn()(
        np.asarray(A.vals), v)
    smv = ShardedMatVec(RingElems(ring), mesh)
    assert smv.specs() == ((None, "x", None), ("x", None), (None, None))
    sA, sv = smv.shard(np.asarray(A.vals), v)
    assert sA[0].shape == (n, m // PN, ring.D) and sv[0].shape == (2, ring.D)
    got = smv.make_matvec_fn()(sA, sv)
    assert got.device == mesh.devices[0]
    _same(got, want)
    _same(got, A.mul_vec(v))
    whole = Matrix(RingElems(ring), _port(ring.field, A.vals))
    assert torch.equal(got, whole.mul_vec(_port(ring.field, v)))


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "stark_prime"])
def test_sharded_matvec_field_scalars(name, ref_mesh, mesh):
    """Field scalars, A 2 x 8, against the reference's sharded mat-vec
    and its Matrix.mul_vec; over stark_prime against its Matrix.mul_vec
    only (the reference's limbed sharded mat-vec compiles for about 10
    s here)."""
    rf = ref_field(name)
    f = get_field(name)
    rng = random.Random(111)
    A = RefMatrix.rand(RefFieldElems(rf), 2, 8, rng)
    v = np.asarray(rf.rand((8,), rng))
    smv = ShardedMatVec(FieldElems(f, "cpu"), mesh)
    sA, sv = smv.shard(np.asarray(A.vals), v)
    assert sA[0].shape == (2, 1) + f.limb_shape
    got = smv.make_matvec_fn()(sA, sv)
    if not f.limbed:
        _same(got, RefShardedMatVec(RefFieldElems(rf), ref_mesh)
              .make_matvec_fn()(np.asarray(A.vals), v))
    _same(got, A.mul_vec(v))


def _port_sparse(e, A):
    """The reference's SparseMatrix as the port's, the same COO arrays."""
    return SparseMatrix(e, A.nrows, A.ncols, _port(e.f, A.data),
                        np.array(A.rows), np.array(A.cols))


def test_sharded_sparse_matvec_ring_matches_reference(ref_mesh, mesh):
    """nnz-sharded ring mat-vec (5 x 12, density 0.4, nnz padded to a
    multiple of 8 with zero entries at (0, 0))."""
    rr = ref_ring("goldilocks")
    ring = get_ring("goldilocks", device="cpu")
    rng = random.Random(210)
    A = RefSparseMatrix.rand(RefRingElems(rr), 5, 12, 0.4, rng)
    v = np.asarray(rr.rand_ntt((12,), rng))
    want = RefShardedSparseMatVec(RefRingElems(rr), ref_mesh).mul_vec(A, v)
    smv = ShardedSparseMatVec(RingElems(ring), mesh)
    sA = _port_sparse(RingElems(ring), A)
    data, rows, cols = smv.shard(sA)
    pad = (-sA.nnz) % PN
    assert pad and sum(d.shape[0] for d in data) == sA.nnz + pad
    assert all(int(r[-1]) == 0 for r in rows[-1:])
    got = smv.mul_vec(sA, _port(ring.field, v))
    _same(got, want)
    assert torch.equal(got, sA.mul_vec(_port(ring.field, v)))


def test_sharded_sparse_matvec_limbed_and_skewed(ref_mesh, mesh):
    """stark_prime scalars with every entry in ONE row (nnz 16, two a
    shard), against the reference's SparseMatrix.mul_vec (its limbed
    sharded mat-vec compiles for about 10 s here); the DifferentLengths
    error of mul_vec."""
    rf = ref_field("stark_prime")
    f = get_field("stark_prime")
    rng = random.Random(211)
    m = 16
    re_ = RefFieldElems(rf)
    vals = re_.rand((m,), rng)
    entries = [(2, c, int(x)) for c, x in enumerate(rf.decode(vals))]
    A = RefSparseMatrix.from_entries(re_, 4, m, entries)
    v = np.asarray(rf.rand((m,), rng))
    want = A.mul_vec(v)
    e = FieldElems(f, "cpu")
    smv = ShardedSparseMatVec(e, mesh)
    sA = _port_sparse(e, A)
    got = smv.mul_vec(sA, _port(f, v))
    _same(got, want)
    with pytest.raises(AlgebraError, match="DifferentLengths"):
        smv.mul_vec(sA, _port(f, v)[:-1])
    fn = smv.make_matvec_fn(4)
    data, rows, cols = smv.shard(sA)
    with pytest.raises(ValueError, match="int32 shards"):
        fn(data, [r.long() for r in rows], cols, _port(f, v))


# -- ShardedMLE ---------------------------------------------------------------


def _mle_inputs(f, nv, seed, k=1):
    rng = random.Random(seed)
    tables = [_enc(f, rng, (1 << nv,)) for _ in range(k)]
    points = [_enc(f, rng, ()) for _ in range(nv)]
    return tables, points


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_sharded_eval_matches_reference(name, ref_mesh, mesh, monkeypatch):
    """Full evaluation at nv = 10: bit-equal to the reference's sharded
    evaluation and to DenseMLE.evaluate; a Goldilocks shard evaluates
    through K5 (its twin here), once a shard."""
    rf = ref_field(name)
    f = get_field(name)
    nv = 10
    (evals,), point = _mle_inputs(rf, nv, 100)
    want = RefShardedMLE(rf, nv, ref_mesh).make_eval_fn()(evals, *point)
    sm = ShardedMLE(f, nv, mesh)
    calls = _counter(monkeypatch, FX, "evaluate_goldilocks_ref")
    pts = [_port(f, p) for p in point]
    got = sm.make_eval_fn()(sm.shard(evals), *pts)
    assert calls[0] == (PN if name == "goldilocks" else 0)
    _same(got, want)
    whole = DenseMLE(FieldElems(f, "cpu"), nv, _port(f, evals))
    assert torch.equal(got, whole.evaluate(pts))


def test_sharded_fix_and_sums_match_reference(ref_mesh, mesh):
    """Fix of the first 3 variables (local), the hypercube sum and the
    inner product at nv = 9, against the reference and Python ints."""
    rf = ref_field("goldilocks")
    f = get_field("goldilocks")
    nv, k = 9, 3
    (a, b), pts = _mle_inputs(rf, nv, 101, k=2)
    ref = RefShardedMLE(rf, nv, ref_mesh)
    sm = ShardedMLE(f, nv, mesh)
    assert sm.spec() == ("x",)
    sa, sb = sm.shard(a), sm.shard(b)
    pp = [_port(f, p) for p in pts[:k]]
    fixed = sm.make_fix_fn(k)(sa, *pp)
    assert len(fixed) == PN and fixed[0].shape == (1 << (nv - 3 - k),)
    _same(torch.cat(fixed), ref.make_fix_fn(k)(a, *pts[:k]))
    whole = DenseMLE(FieldElems(f, "cpu"), nv, _port(f, a))
    assert torch.equal(torch.cat(fixed), whole.fix_variables(pp).evals)
    s = sm.make_hypercube_sum_fn()(sa)
    _same(s, ref.make_hypercube_sum_fn()(a))
    ai, bi = (rf.decode(x) for x in (a, b))
    assert int(f.decode(s)) == sum(int(x) for x in ai) % f.q
    ip = sm.make_inner_product_fn()(sa, sb)
    _same(ip, ref.make_inner_product_fn()(a, b))
    assert int(f.decode(ip)) == sum(int(x) * int(y)
                                    for x, y in zip(ai, bi)) % f.q


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog"])
def test_sharded_sumcheck_matches_reference(name, ref_mesh, mesh,
                                            monkeypatch):
    """make_sumcheck_fn at nv = 8 (the reference test's size): messages
    and finals bit-equal to the reference's sharded prover; each shard's
    5 low rounds are one K7 call on its bit-reversed table (the twin
    here, the generic msb prover)."""
    rf = ref_field(name)
    f = get_field(name)
    nv = 8
    (G, H), chals = _mle_inputs(rf, nv, 7, k=2)
    want = RefShardedMLE(rf, nv, ref_mesh).make_sumcheck_fn()(G, H, *chals)
    sm = ShardedMLE(f, nv, mesh)
    calls = _counter(monkeypatch, SK, "sumcheck_prove_many_ref")
    got = sm.make_sumcheck_fn()(sm.shard(G), sm.shard(H),
                                *[_port(f, c) for c in chals])
    assert calls[0] == PN
    assert got[0].shape == (nv, 3)
    for g, w, what in zip(got, want, ("msgs", "g", "h")):
        _same(g, w, what)


@pytest.mark.parametrize("nv", [7, 10])
def test_sharded_kary_sumcheck_matches_reference(nv, ref_mesh, mesh,
                                                 monkeypatch):
    """make_sumcheck_many_fn(3) (degree-3 rounds), Goldilocks: bit-equal
    to the reference's sharded prover and to the port's unsharded lsb
    prover; one K7 call a shard."""
    rf = ref_field("goldilocks")
    f = get_field("goldilocks")
    k = 3
    tables, chals = _mle_inputs(rf, nv, 17, k=k)
    want_m, want_f = RefShardedMLE(rf, nv, ref_mesh).make_sumcheck_many_fn(
        k)(*tables, *chals)
    sm = ShardedMLE(f, nv, mesh)
    pc = [_port(f, c) for c in chals]
    calls = _counter(monkeypatch, SK, "sumcheck_prove_many_ref")
    msgs, finals = sm.make_sumcheck_many_fn(k)(
        *[sm.shard(T) for T in tables], *pc)
    assert calls[0] == PN
    _same(msgs, want_m, "msgs")
    for g, w in zip(finals, want_f):
        _same(g, w, "final")
    m1, f1 = sumcheck_prove_many_with_challenges(
        f, [_port(f, T) for T in tables], pc)
    assert torch.equal(msgs, m1)
    assert all(torch.equal(a, b) for a, b in zip(finals, f1))


def test_sharded_mle_stark_prime(mesh):
    """The limbed field at nv = 6: evaluation, fix, sums and both provers
    equal the port's unsharded DenseMLE and generic lsb prover (the
    reference's limbed sharded sumcheck takes minutes here)."""
    f = get_field("stark_prime")
    e = FieldElems(f, "cpu")
    rng = np.random.default_rng(8)
    nv = 6
    G, H, T = (f.rand((1 << nv,), rng, "cpu") for _ in range(3))
    pts = list(f.rand((nv,), rng, "cpu"))
    sm = ShardedMLE(f, nv, mesh)
    assert sm.spec() == ("x", None)
    sG, sH, sT = sm.shard(G), sm.shard(H), sm.shard(T)
    assert sG[0].shape == (1 << (nv - 3), 8)
    dG = DenseMLE(e, nv, G)
    assert torch.equal(sm.make_eval_fn()(sG, *pts), dG.evaluate(pts))
    assert torch.equal(torch.cat(sm.make_fix_fn(2)(sG, *pts[:2])),
                       dG.fix_variables(pts[:2]).evals)
    assert torch.equal(sm.make_hypercube_sum_fn()(sG), f.sum(G, 0))
    assert torch.equal(sm.make_inner_product_fn()(sG, sH),
                       f.sum(f.mul(G, H), 0))
    msgs, g, h = sm.make_sumcheck_fn()(sG, sH, *pts)
    m1, f1 = sumcheck_prove_many_with_challenges(f, [G, H], pts)
    assert torch.equal(msgs, m1) and msgs.shape == (nv, 3, 8)
    assert torch.equal(g, f1[0]) and torch.equal(h, f1[1])
    m3, f3 = sm.make_sumcheck_many_fn(3)(sG, sH, sT, *pts)
    m1, f1 = sumcheck_prove_many_with_challenges(f, [G, H, T], pts)
    assert torch.equal(m3, m1)
    assert all(torch.equal(a, b) for a, b in zip(f3, f1))


@pytest.mark.parametrize("P_", [1, 2, 4])
def test_sharded_mle_other_shard_counts(P_, monkeypatch):
    """P = 1, 2, 4 shards (nv = 5; at P = 1 no top round): evaluation
    and the sumcheck equal the unsharded ones, K5 and K7 once a shard."""
    f = get_field("goldilocks")
    rng = np.random.default_rng(P_)
    nv = 5
    G, H = f.rand((1 << nv,), rng, "cpu"), f.rand((1 << nv,), rng, "cpu")
    pts = list(f.rand((nv,), rng, "cpu"))
    sm = ShardedMLE(f, nv, make_mesh(P_, device="cpu"))
    k5 = _counter(monkeypatch, FX, "evaluate_goldilocks_ref")
    k7 = _counter(monkeypatch, SK, "sumcheck_prove_many_ref")
    got = sm.make_eval_fn()(sm.shard(G), *pts)
    assert torch.equal(got, DenseMLE(FieldElems(f, "cpu"), nv, G)
                       .evaluate(pts))
    msgs, g, h = sm.make_sumcheck_fn()(sm.shard(G), sm.shard(H), *pts)
    m1, f1 = sumcheck_prove_many_with_challenges(f, [G, H], pts)
    assert torch.equal(msgs, m1)
    assert torch.equal(g, f1[0]) and torch.equal(h, f1[1])
    assert k5[0] == P_ and k7[0] == P_


def test_sharded_mle_checks(mesh):
    f = get_field("goldilocks")
    with pytest.raises(ValueError, match="power of two"):
        ShardedMLE(f, 4, make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="power of two"):
        ShardedMLE(f, 2, mesh)
    sm = ShardedMLE(f, 5, mesh)
    with pytest.raises(ValueError, match="at most"):
        sm.make_fix_fn(3)
    rng = np.random.default_rng(0)
    T = sm.shard(f.rand((32,), rng, "cpu"))
    pts = list(f.rand((5,), rng, "cpu"))
    with pytest.raises(ValueError, match="expected 5 points"):
        sm.make_eval_fn()(T, *pts[:4])
    with pytest.raises(ValueError, match="8 torch.int64 shards"):
        sm.make_eval_fn()(T[:4], *pts)
    with pytest.raises(ValueError, match="shards must be"):
        sm.make_hypercube_sum_fn()([t[:2] for t in T])
    with pytest.raises(ValueError, match="2 tables and 5 challenges"):
        sm.make_sumcheck_many_fn(2)(T, *pts)
    # nv = log2 P: one entry a shard, every round on the gathered table
    sm3 = ShardedMLE(f, 3, mesh)
    G = f.rand((8,), rng, "cpu")
    msgs, fin = sm3.make_sumcheck_many_fn(1)(sm3.shard(G), *pts[:3])
    m1, f1 = sumcheck_prove_many_with_challenges(f, [G], pts[:3])
    assert torch.equal(msgs, m1) and torch.equal(fin[0], f1[0])
    assert torch.equal(sm3.make_eval_fn()(sm3.shard(G), *pts[:3]),
                       DenseMLE(FieldElems(f, "cpu"), 3, G)
                       .evaluate(pts[:3]))
