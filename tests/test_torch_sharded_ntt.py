"""The port's sharded four-step NTT on CPU shards against the JAX
reference on its virtual 8-device CPU mesh (tests/conftest.py):
``make_fns``, ``make_cached_fns``, ``make_phase_fns`` and
``make_single_chip_fns`` of ``ShardedNTT``, the exchange kernel K8's
twin against the reference's Pallas kernel in distributed interpret mode
and, inside the port's ``make_fns``, against its XLA all_to_all route,
and ``PowerRing.fourstep_ctx``.  Inputs
are numpy-seeded storage; results are compared as the reference's
storage (canonical u64 for Goldilocks, u32 Montgomery for BabyBear) with
0 differing bits allowed, and products also against Python-int
schoolbook sums."""

import functools
import random

import numpy as np
import pytest
import torch

import jax

from stark_rings_tpu.fields import get_field as ref_field
from stark_rings_tpu.parallel import ShardedNTT as RefShardedNTT
from stark_rings_tpu.parallel import make_mesh as ref_make_mesh
from stark_rings_tpu.rings.power import get_power_ring as ref_power_ring

from stark_rings_tpu.ops.pallas_fold import pointwise_mul as ref_pointwise

from stark_rings_tpu_torch import (GoldilocksKernelNTT, NTTContext,
                                   ShardedNTT, from_jax_storage, get_field,
                                   get_power_ring, make_mesh,
                                   to_numpy_storage)
from stark_rings_tpu_torch.ops import fold as K
from stark_rings_tpu_torch.ops import goldilocks_ntt as G
from stark_rings_tpu_torch.ops import ntt as NT
from stark_rings_tpu_torch.parallel import exchange as EX


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dtype(name):
    return np.uint32 if name == "babybear" else np.uint64


def _rand(name, rng, shape):
    return rng.integers(0, ref_field(name).q, shape, dtype=_dtype(name))


@functools.lru_cache(maxsize=None)
def _ref_fns(name, N, P, batch_ndim, exchange="xla", kind="fns"):
    """The reference's jitted functions over its CPU mesh (cached: each
    compiles once per module)."""
    sn = RefShardedNTT(name, N, P, exchange=exchange,
                       exchange_interpret=exchange == "pallas")
    mesh = ref_make_mesh(P)
    if kind == "cached":
        return sn.make_cached_fns(mesh, batch_ndim=batch_ndim)
    return sn.make_fns(mesh, batch_ndim=batch_ndim, overlap=False)


def _port(name, N, P, **kw):
    sn = ShardedNTT(name, N, P, **kw)
    return sn, make_mesh(P, device="cpu")


def _negacyclic_mul_ints(a, b, q):
    n = len(a)
    out = [0] * n
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + x * y) % q
            else:
                out[k - n] = (out[k - n] - x * y) % q
    return out


def _check_sharded_mul(name, N, P, exchange):
    """make_fns on [N1, N2] (batchless) shards: mul equals the Python-int
    schoolbook product (the reference's own oracle for its make_fns);
    forward, gathered, equals the reference's row-sharded evaluations
    (its XLA all_to_all route) slot for slot, the same leaf order;
    inverse(forward(a)) == a, so inverse maps the reference's
    evaluations to its coefficients."""
    f = get_field(name)
    sn, mesh = _port(name, N, P, exchange=exchange)
    fwd, inv, mul = sn.make_fns(mesh)
    rfwd, _, _ = _ref_fns(name, N, P, 0)
    rng = random.Random(50)
    a_i = [rng.randrange(f.q) for _ in range(N)]
    b_i = [rng.randrange(f.q) for _ in range(N)]
    a = sn.to_matrix(f.storage_np(a_i))
    b = sn.to_matrix(f.storage_np(b_i))
    cspec, espec = sn.shard_specs()
    sa, sb = sn.shard(a, cspec, mesh), sn.shard(b, cspec, mesh)
    assert [s.shape for s in sa] == [(sn.N1, sn.N2 // P)] * P
    got = sn.gather(mul(sa, sb), cspec)
    assert [int(v) for v in f.decode(from_jax_storage(
        f, sn.from_matrix(got), "cpu"))] == _negacyclic_mul_ints(a_i, b_i,
                                                                 f.q)
    ev = fwd(sa)
    assert [e.shape for e in ev] == [(sn.N1 // P, sn.N2)] * P
    assert np.array_equal(sn.gather(ev, espec), np.asarray(rfwd(a)))
    assert np.array_equal(sn.gather(inv(ev), cspec), a)


@pytest.mark.parametrize("name,N,P", [("goldilocks", 256, 4),
                                      ("goldilocks", 1024, 8),
                                      ("babybear", 1024, 8)])
def test_sharded_mul_forward_inverse_match_reference(name, N, P):
    """The plain exchange: see :func:`_check_sharded_mul`."""
    _check_sharded_mul(name, N, P, "xla")


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_k8_twin_matches_reference_all_to_all(field):
    """K8's twin (exchange="pallas" on CPU shards) at P = 8, N = 2^10
    against the reference's XLA route, through the checks of
    :func:`_check_sharded_mul`; the batched K8 twin is held to the
    reference's Pallas kernel in
    :func:`test_k8_twin_matches_reference_pallas_interpret`."""
    _check_sharded_mul(field, 1 << 10, 8, "pallas")


def test_sharded_batched_cached_and_square_match_reference():
    """Batched make_fns mul and make_cached_fns (mul_cached with batch-B
    and batch-1 cached operands, square): precompute equals the
    reference's, every product its Python-int schoolbook sum (the
    reference's own oracle for these, tests/test_sharded_ntt.py)."""
    name, N, P, B = "goldilocks", 256, 4, 2
    f = get_field(name)
    sn, mesh = _port(name, N, P)
    cspec, espec = sn.shard_specs(1)
    rng = random.Random(53)
    a_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    b_i = [[rng.randrange(f.q) for _ in range(N)] for _ in range(B)]
    a = sn.to_matrix(f.storage_np(a_i))
    b = sn.to_matrix(f.storage_np(b_i))
    sa, sb = sn.shard(a, cspec, mesh), sn.shard(b, cspec, mesh)

    def ints(shards):
        return sn.from_matrix(sn.gather(shards, cspec)).tolist()

    _, _, mul = sn.make_fns(mesh, batch_ndim=1)
    pre, mul_cached, square = sn.make_cached_fns(mesh, batch_ndim=1)
    rfwd, _, _ = _ref_fns(name, N, P, 0)      # shared with the batchless
    fb, fb1 = pre(sb), pre(sn.shard(b[:1], cspec, mesh))
    assert np.array_equal(sn.gather(fb, espec),
                          np.stack([np.asarray(rfwd(x)) for x in b]))
    for got, want in ((mul(sa, sb), b_i), (mul_cached(sa, fb), b_i),
                      (mul_cached(sa, fb1), [b_i[0]] * B),
                      (square(sa), a_i)):
        assert ints(got) == [_negacyclic_mul_ints(x, y, f.q)
                             for x, y in zip(a_i, want)]


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_k8_twin_matches_reference_pallas_interpret(field):
    """exchange="pallas" on CPU shards (K8's twin) against the
    reference's K8 in distributed interpret mode, both directions, at
    P = 2, N = 2^6, B = 2; and the round trip."""
    N, P, B = 1 << 6, 2, 2
    sn, mesh = _port(field, N, P, exchange="pallas")
    fwd, inv, _ = sn.make_fns(mesh, batch_ndim=1)
    rfp, rip, _ = _ref_fns(field, N, P, 1, exchange="pallas")
    cspec, espec = sn.shard_specs(1)
    rng = np.random.default_rng(12)
    a = sn.to_matrix(_rand(field, rng, (B, N)))
    EX.reset_launches()
    ev = fwd(sn.shard(a, cspec, mesh))
    assert np.array_equal(sn.gather(ev, espec), np.asarray(rfp(a)))
    y = sn.to_matrix(_rand(field, rng, (B, N)))
    back = inv(sn.shard(y, espec, mesh))
    assert np.array_equal(sn.gather(back, cspec), np.asarray(rip(y)))
    assert np.array_equal(sn.gather(inv(ev), cspec), a)
    assert not any(EX.LAUNCHES.values())      # CPU shards: no launch


@pytest.mark.parametrize("field", ["goldilocks", "babybear"])
def test_exchange_twins_are_twiddle_then_transpose(field):
    """The twins are f.mul then the block transpose, shard d receiving
    block d of every shard; the wrappers send CPU shards to them."""
    f = get_field(field)
    P, B, N1, N2 = 4, 2, 8, 16
    R1, C = N1 // P, N2 // P
    rng = np.random.default_rng(3)
    xs = [f.rand((B, N1, C), rng, "cpu") for _ in range(P)]
    tws = [f.rand((N1, C), rng, "cpu") for _ in range(P)]
    ys = EX.twiddle_exchange_fwd(xs, tws, field)
    assert [y.shape for y in ys] == [(B, R1, N2)] * P
    for d in range(P):
        for s in range(P):
            blk = f.mul(xs[s], tws[s])[:, d * R1:(d + 1) * R1]
            assert torch.equal(ys[d][:, :, s * C:(s + 1) * C], blk)
    tis = [f.rand((R1, N2), rng, "cpu") for _ in range(P)]
    zs = EX.twiddle_exchange_inv(ys, tis, field)
    assert [z.shape for z in zs] == [(B, N1, C)] * P
    for d in range(P):
        for s in range(P):
            blk = f.mul(ys[s], tis[s])[:, :, d * C:(d + 1) * C]
            assert torch.equal(zs[d][:, s * R1:(s + 1) * R1], blk)
    flat = EX.twiddle_exchange_fwd([x[0] for x in xs], tws, field)
    assert all(torch.equal(a, b[0]) for a, b in zip(flat, ys))


def test_exchange_rejects_bad_shards():
    f = get_field("goldilocks")
    x = f.zeros((8, 4), "cpu")
    with pytest.raises(ValueError, match="no exchange kernel"):
        EX.twiddle_exchange_fwd([x], [x], "frog")
    with pytest.raises(ValueError, match="one twiddle table per shard"):
        EX.twiddle_exchange_fwd([x, x], [x], "goldilocks")
    with pytest.raises(ValueError, match="must divide"):
        EX.twiddle_exchange_fwd([x[:6]] * 4, [x[:6]] * 4, "goldilocks")
    with pytest.raises(TypeError, match="storage"):
        EX.twiddle_exchange_fwd([x.int()], [x.int()], "goldilocks")
    with pytest.raises(ValueError, match=r"twiddle tables must be \[8, 4\]"):
        EX.twiddle_exchange_fwd([x], [x[:4]], "goldilocks")
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        EX.twiddle_exchange_fwd([x.to("meta")], [x], "goldilocks")


@pytest.mark.parametrize("B", [2, 3])
def test_overlap_forward_matches_plain(B):
    """overlap=True, None and False give one forward, inverse and mul: the
    port has one forward (the reference's chunked one gives its plain
    one's bits)."""
    name, N, P = "goldilocks", 1 << 8, 4
    sn, mesh = _port(name, N, P)
    cspec, _ = sn.shard_specs(1)
    rng = np.random.default_rng(13 + B)
    sa = sn.shard(sn.to_matrix(_rand(name, rng, (B, N))), cspec, mesh)
    sb = sn.shard(sn.to_matrix(_rand(name, rng, (B, N))), cspec, mesh)
    fwd, inv, mul = sn.make_fns(mesh, batch_ndim=1)
    plain = fwd(sa)
    assert all(torch.equal(x, y) for x, y in zip(inv(plain), sa))
    for overlap in (True, None, False):
        fwd_o, inv_o, mul_o = sn.make_fns(mesh, batch_ndim=1,
                                          overlap=overlap)
        assert all(torch.equal(x, y) for x, y in zip(fwd_o(sa), plain))
        assert all(torch.equal(x, y) for x, y in zip(inv_o(plain), sa))
        assert all(torch.equal(x, y) for x, y in zip(mul_o(sa, sb),
                                                     mul(sa, sb)))


def test_mxu_local_matches_vpu(monkeypatch):
    """local="mxu" (PrescaledMat digit GEMMs) gives local="vpu"'s
    forward and mul at 2^12, P = 8; with either engine K8 is handed
    contiguous shards, as its kernel requires."""
    name, N, P = "goldilocks", 1 << 12, 8
    rng = np.random.default_rng(21)
    a = _rand(name, rng, (N,))
    b = _rand(name, rng, (N,))
    for twin in ("twiddle_exchange_fwd_ref", "twiddle_exchange_inv_ref"):
        def contiguous_only(xs, tws, field, _twin=getattr(EX, twin)):
            assert all(t.is_contiguous() for t in (*xs, *tws))
            return _twin(xs, tws, field)
        monkeypatch.setattr(EX, twin, contiguous_only)
    outs = {}
    for local in ("vpu", "mxu"):
        sn, mesh = _port(name, N, P, local=local, exchange="pallas")
        fwd, _, mul = sn.make_fns(mesh)
        cspec, espec = sn.shard_specs()
        sa = sn.shard(sn.to_matrix(a), cspec, mesh)
        sb = sn.shard(sn.to_matrix(b), cspec, mesh)
        outs[local] = (sn.gather(fwd(sa), espec),
                       sn.gather(mul(sa, sb), cspec))
    assert np.array_equal(outs["vpu"][0], outs["mxu"][0])
    assert np.array_equal(outs["vpu"][1], outs["mxu"][1])
    with pytest.raises(ValueError, match="goldilocks-only"):
        ShardedNTT("babybear", N, P, local="mxu")


@pytest.mark.parametrize("exchange", ["xla", "pallas"])
def test_phase_fns_compose_to_forward(exchange):
    """make_phase_fns: pre -> exchange -> rows equals forward."""
    name, N, P = "babybear", 1 << 8, 4
    sn, mesh = _port(name, N, P, exchange=exchange)
    ph = sn.make_phase_fns(mesh, batch_ndim=1)
    cspec, _ = sn.shard_specs(1)
    sa = sn.shard(sn.to_matrix(_rand(name, np.random.default_rng(4),
                                     (2, N))), cspec, mesh)
    pre = ph["pre"](sa)
    assert [p.shape for p in pre] == [s.shape for s in sa]
    got = ph["rows"](ph["exchange"](pre))
    assert all(torch.equal(x, y) for x, y in zip(got, ph["forward"](sa)))


def test_single_chip_fns_match_reference():
    """make_single_chip_fns at 2^10: mul equals the reference's, and
    inverse(forward) == id; its tables sit on ``device`` and it refuses
    tensors elsewhere."""
    name, N = "goldilocks", 1 << 10
    sn = ShardedNTT(name, N, 1, single_chip=True, device="cpu")
    fwd, inv, mul = sn.make_single_chip_fns()
    ref = RefShardedNTT(name, N, 1, single_chip=True)
    _, _, rmul = ref.make_single_chip_fns()
    rng = np.random.default_rng(21)
    a = sn.to_matrix(_rand(name, rng, (3, N)))
    b = sn.to_matrix(_rand(name, rng, (3, N)))
    ta, tb = (from_jax_storage(sn.f, x, "cpu") for x in (a, b))
    assert np.array_equal(to_numpy_storage(mul(ta, tb)),
                          np.asarray(jax.jit(rmul)(a, b)))
    assert torch.equal(inv(fwd(ta)), ta)
    assert sn.device == torch.device("cpu")
    assert all(t.device == sn.device for t in sn._tables(0, "cpu").values())
    with pytest.raises(ValueError, match="runs on cpu"):
        fwd(ta.to("meta"))
    with pytest.raises(ValueError, match="runs on cpu"):
        mul(ta, tb.to("meta"))
    with pytest.raises(ValueError, match="single_chip=True"):
        ShardedNTT(name, N, 1).make_single_chip_fns()
    with pytest.raises(ValueError, match="P == 1"):
        ShardedNTT(name, N, 2, single_chip=True, device="cpu")


@pytest.mark.parametrize("name,logN", [("goldilocks", 9), ("babybear", 8)])
def test_fourstep_ctx_matches_reference(name, logN):
    """PowerRing.fourstep_ctx on flat tensors: mul equals the reference's
    fourstep mul and coeff_mul (the port's, held to the reference's in
    tests/test_torch_power.py); inverse(forward) == id."""
    ring = get_power_ring(name, logN, device="cpu")
    fs = ring.fourstep_ctx()
    assert ring.fourstep_ctx() is fs
    _, _, rmul = ref_power_ring(name, logN).fourstep_ctx()
    rng = np.random.default_rng(7)
    a, b = _rand(name, rng, (2, ring.D)), _rand(name, rng, (2, ring.D))
    ta, tb = (from_jax_storage(ring.field, x, "cpu") for x in (a, b))
    got = fs.mul(ta, tb)
    assert np.array_equal(to_numpy_storage(got),
                          np.asarray(jax.jit(rmul)(a, b)))
    assert torch.equal(got, ring.coeff_mul(ta, tb))
    assert torch.equal(fs.inverse(fs.forward(ta)), ta)


def test_consts_match_reference():
    """The host-built tables equal the reference's device-built ones."""
    name, N, P = "babybear", 1 << 8, 4
    sn, _ = _port(name, N, P)
    ref = RefShardedNTT(name, N, P)
    for got, want in zip(sn.consts(), ref.consts()):
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                assert np.array_equal(to_numpy_storage(g), np.asarray(w))
        else:
            assert np.array_equal(to_numpy_storage(got), np.asarray(want))
    assert sn.k1_leaf.tolist() == ref.k1_leaf.tolist()


def test_mesh_and_shards():
    """make_mesh: P shards on one device, one per listed device; the
    default is the card; shard / gather move numpy storage and tensors,
    and the functions check their shards against the mesh."""
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis == "x"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(device=["cpu", "cpu"]).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedNTT("goldilocks", 256, 1, single_chip=True)
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, device="cpu")
    sn = ShardedNTT("goldilocks", 256, 4)
    cspec, espec = sn.shard_specs(1)
    assert cspec == (None, None, "x") and espec == (None, "x", None)
    x = _rand("goldilocks", np.random.default_rng(0), (2, 16, 16))
    shards = sn.shard(x, cspec, mesh)
    assert np.array_equal(sn.gather(shards, cspec), x)
    again = sn.shard(from_jax_storage(sn.f, x, "cpu"), espec, mesh)
    assert torch.equal(sn.gather(again, espec, "cpu"),
                       from_jax_storage(sn.f, x, "cpu"))
    fwd, _, _ = sn.make_fns(mesh, batch_ndim=1)
    with pytest.raises(ValueError, match="4 torch.int64 shards"):
        fwd(shards[:3])
    with pytest.raises(ValueError, match="4 torch.int64 shards"):
        fwd([s.int() for s in shards])
    with pytest.raises(ValueError, match="mesh of 2 shards"):
        sn.make_fns(make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="must divide"):
        ShardedNTT("goldilocks", 256, 32)
    with pytest.raises(ValueError, match="K8"):
        ShardedNTT("frog", 4, 1, exchange="pallas")


# -- the Goldilocks four-step on the radix kernels and pointwise_mul ---------


@pytest.mark.parametrize("logN", range(1, 14))
def test_kernel_engine_cyclic_tables_match_ntt_context(logN):
    """GoldilocksKernelNTT(negacyclic=False): its tables are
    NTTContext(negacyclic=False)'s in the m + i layout, and forward,
    inverse and mul (the cyclic product) equal NTTContext's."""
    f = get_field("goldilocks")
    N = 1 << logN
    eng = GoldilocksKernelNTT(N, device="cpu", negacyclic=False)
    ctx = NTTContext(f, N, negacyclic=False, device="cpu")
    fwd, inv, ninv = ctx.tables()
    wf, wi, n_inv = eng.tables()
    assert torch.equal(wf[1:], torch.cat(fwd))
    assert torch.equal(wi[1:], torch.cat(inv))
    assert n_inv == int(f.decode(ninv))
    rng = np.random.default_rng(logN)
    a = from_jax_storage(f, _rand("goldilocks", rng, (2, N)), "cpu")
    b = from_jax_storage(f, _rand("goldilocks", rng, (2, N)), "cpu")
    assert torch.equal(eng.forward(a), ctx.forward(a))
    assert torch.equal(eng.inverse(a), ctx.inverse(a))
    if logN <= 10:
        assert torch.equal(eng.mul(a, b), ctx.mul(a, b))


def _count_routes(monkeypatch):
    """Count the radix tile twin, the pointwise twin and NTTContext's
    transforms as the four-step calls them."""
    calls = {"ntt_tile": 0, "pointwise_mul": 0, "NTTContext": 0}

    def counted(key, fn):
        def wrap(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrap

    monkeypatch.setattr(G, "ntt_tile_ref",
                        counted("ntt_tile", G.ntt_tile_ref))
    monkeypatch.setattr(K, "pointwise_mul_ref",
                        counted("pointwise_mul", K.pointwise_mul_ref))
    for name in ("forward", "inverse"):
        monkeypatch.setattr(NT.NTTContext, name,
                            counted("NTTContext", getattr(NT.NTTContext,
                                                          name)))
    return calls


@pytest.mark.parametrize("P", [1, 2, 4, "single"])
def test_goldilocks_fourstep_runs_the_kernel_route(P, monkeypatch):
    """Goldilocks ShardedNTT at deg 2^10 on P shards (the "xla"
    exchange) and on one device (single_chip): the local transforms run
    on the radix tile and the products on pointwise_mul (here their
    twins; on the card the kernels), none on NTTContext, and forward and
    mul equal the reference's (its P = 8 functions: the gathered
    evaluations and products do not depend on P)."""
    name, N = "goldilocks", 1 << 10
    single = P == "single"
    if single:
        sn = ShardedNTT(name, N, 1, single_chip=True, device="cpu")
        fwd1, inv1, mul1 = sn.make_single_chip_fns()
        fwd, inv = ((lambda xs, fn=fn: [fn(xs[0])]) for fn in (fwd1, inv1))
        mul = (lambda xs, ys: [mul1(xs[0], ys[0])])
        mesh, P = make_mesh(1, device="cpu"), 1
    else:
        sn, mesh = _port(name, N, P)
        fwd, inv, mul = sn.make_fns(mesh)
    rfwd, _, rmul = _ref_fns(name, N, 8, 0)
    rng = np.random.default_rng(P + 10 * single)
    a = sn.to_matrix(_rand(name, rng, (N,)))
    b = sn.to_matrix(_rand(name, rng, (N,)))
    cspec, espec = sn.shard_specs()
    sa, sb = sn.shard(a, cspec, mesh), sn.shard(b, cspec, mesh)
    calls = _count_routes(monkeypatch)
    got = mul(sa, sb)
    # 3 transforms of P shards, a column and a row tile each; a twist
    # and a twiddle a forward, the slot product, the inverse twiddle and
    # the untwist
    assert calls == {"ntt_tile": 6 * P, "pointwise_mul": 7 * P,
                     "NTTContext": 0}
    assert np.array_equal(sn.gather(got, cspec), np.asarray(rmul(a, b)))
    ev = fwd(sa)
    assert np.array_equal(sn.gather(ev, espec), np.asarray(rfwd(a)))
    assert np.array_equal(sn.gather(inv(ev), cspec), a)


def test_fourstep_ctx_kernel_route_at_deg_2_12(monkeypatch):
    """fourstep_ctx() at deg 2^12 (B = 2): 6 tile and 7 pointwise calls
    a mul, no NTTContext transform, the reference's fourstep product and
    the radix engine's; BabyBear keeps NTTContext (no radix kernel over
    it in either package)."""
    name, logN = "goldilocks", 12
    f = get_field(name)
    fs = get_power_ring(name, logN, device="cpu").fourstep_ctx()
    _, _, rmul = ref_power_ring(name, logN).fourstep_ctx()
    rng = np.random.default_rng(12)
    a, b = (_rand(name, rng, (2, 1 << logN)) for _ in range(2))
    ta, tb = (from_jax_storage(f, x, "cpu") for x in (a, b))
    calls = _count_routes(monkeypatch)
    got = fs.mul(ta, tb)
    assert calls == {"ntt_tile": 6, "pointwise_mul": 7, "NTTContext": 0}
    monkeypatch.undo()
    assert np.array_equal(to_numpy_storage(got),
                          np.asarray(jax.jit(rmul)(a, b)))
    assert torch.equal(got, GoldilocksKernelNTT(1 << logN, device="cpu")
                       .mul(ta, tb))
    bb = get_power_ring("babybear", 8, device="cpu").fourstep_ctx()
    x = from_jax_storage(get_field("babybear"),
                         _rand("babybear", rng, (1, 256)), "cpu")
    calls = _count_routes(monkeypatch)
    bb.mul(x, x)
    assert calls["NTTContext"] == 6 and calls["ntt_tile"] == 0


@pytest.mark.parametrize("b_shape", [(4, 128, 64), (128, 64), (1, 128, 64),
                                     (64,), (1,), ()],
                         ids=["n", "table", "batch1", "row", "one", "0d"])
def test_pointwise_mul_broadcast_twin(b_shape):
    """pointwise_mul with b of a's shape or broadcast over its leading
    axes (read at i mod b.numel()): equal to the field's broadcast
    product and to the reference's Pallas kernel (interpret mode) on the
    broadcast operand."""
    f = get_field("goldilocks")
    rng = np.random.default_rng(len(b_shape))
    a = _rand("goldilocks", rng, (4, 128, 64))
    b = _rand("goldilocks", rng, b_shape)
    b.reshape(-1)[:1] = f.q - 1
    ta, tb = (from_jax_storage(f, x, "cpu") for x in (a, b))
    got = K.pointwise_mul(ta, tb)
    assert torch.equal(got, f.mul(ta, tb))
    flat_b = np.broadcast_to(b, a.shape).reshape(-1, 64)
    want = ref_pointwise(jax.numpy.asarray(a.reshape(-1, 64)),
                         jax.numpy.asarray(np.ascontiguousarray(flat_b)),
                         interpret=True)
    assert np.array_equal(to_numpy_storage(got).reshape(-1, 64),
                          np.asarray(want))
    with pytest.raises(ValueError, match="does not broadcast"):
        K.pointwise_mul(ta, tb.reshape(-1)[:3].contiguous()
                        if tb.numel() > 3 else tb.expand(3).contiguous())
