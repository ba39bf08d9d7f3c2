"""Goldilocks arithmetic of the PyTorch port against the JAX reference
and Python ints: the int64 field (fields/field.py) and the u32-pair
twins of the fold kernels' helpers (ops/goldilocks.py).  Exact
equality throughout: these are integers mod q."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import GOLDILOCKS as RF
from stark_rings_tpu.fields.field import _mul64_128 as ref_mul64_128
from stark_rings_tpu.ops import pallas_goldilocks as RG

from stark_rings_tpu_torch import to_numpy_u64, to_torch
from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.fields.field import _mul64_128
from stark_rings_tpu_torch.ops import goldilocks as G

Q = RF.q
EDGE = [0, 1, 2, Q - 1, Q - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**63,
        2**63 - 1, Q // 2]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(seed, n=512):
    """Canonical pairs: every edge value against every edge value, then
    random ones."""
    rng = np.random.default_rng(seed)
    ea, eb = np.meshgrid(np.array(EDGE, dtype=np.uint64),
                         np.array(EDGE, dtype=np.uint64))
    a = np.concatenate([ea.ravel(), rng.integers(0, Q, n, dtype=np.uint64)])
    b = np.concatenate([eb.ravel(), rng.integers(0, Q, n, dtype=np.uint64)])
    return a, b


def _pairs(x):
    """numpy uint64 -> (lo, hi) int64 tensors of u32 words."""
    return (torch.from_numpy((x & np.uint64(0xFFFFFFFF)).astype(np.int64)),
            torch.from_numpy((x >> np.uint64(32)).astype(np.int64)))


def _jpairs(x):
    return (jnp.asarray((x & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((x >> np.uint64(32)).astype(np.uint32)))


def _np(t):
    return t.numpy().astype(np.uint64)


_PY = {"add": lambda a, b: (a + b) % Q, "sub": lambda a, b: (a - b) % Q,
       "neg": lambda a, b: (-a) % Q, "mul": lambda a, b: a * b % Q}


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul"])
def test_field_op_matches_reference(op):
    a, b = _operands(1)
    args = (a,) if op == "neg" else (a, b)
    targs = [to_torch(x, "cpu") for x in args]
    got = to_numpy_u64(getattr(F, op)(*targs))
    want = np.asarray(getattr(RF, op)(*[jnp.asarray(x) for x in args]))
    assert np.array_equal(got, want)
    py = [_PY[op](int(x), int(y)) for x, y in zip(a, b)]
    assert [int(v) for v in got] == py


@pytest.mark.parametrize("op", ["_add_q", "_sub_q", "_mul_q"])
def test_pair_op_matches_reference(op):
    a, b = _operands(2)
    lo, hi = getattr(G, op)(*_pairs(a), *_pairs(b))
    rlo, rhi = getattr(RG, op)(*_jpairs(a), *_jpairs(b))
    assert np.array_equal(_np(lo), np.asarray(rlo).astype(np.uint64))
    assert np.array_equal(_np(hi), np.asarray(rhi).astype(np.uint64))
    py = {"_add_q": "add", "_sub_q": "sub", "_mul_q": "mul"}[op]
    got = _np(lo) | (_np(hi) << np.uint64(32))
    assert [int(v) for v in got] == [_PY[py](int(x), int(y))
                                     for x, y in zip(a, b)]


def test_mul64_128_exact():
    """Both 64x64 -> 128 products (int64 words and u32 pairs), on any
    u64 operands, against Python ints and the reference."""
    rng = np.random.default_rng(3)
    edge = np.array([0, 1, 2**32 - 1, 2**32, 2**64 - 1, 2**63, Q],
                    dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, edge.size),
                        rng.integers(0, 2**64, 300, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, edge.size),
                        rng.integers(0, 2**64, 300, dtype=np.uint64)])
    want = [int(x) * int(y) for x, y in zip(a, b)]
    hi, lo = _mul64_128(to_torch(a, "cpu"), to_torch(b, "cpu"))
    hi, lo = to_numpy_u64(hi), to_numpy_u64(lo)
    assert [(int(h) << 64) | int(lo_) for h, lo_ in zip(hi, lo)] == want
    rhi, rlo = ref_mul64_128(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(hi, np.asarray(rhi))
    assert np.array_equal(lo, np.asarray(rlo))
    words = [_np(w) for w in G._mul64_128(*_pairs(a), *_pairs(b))]
    assert [sum(int(w[i]) << (32 * k) for k, w in enumerate(words))
            for i in range(a.size)] == want


def test_reduce128_any_input():
    """Raw 128-bit inputs up to 2^128 - 1, both reductions."""
    rng = np.random.default_rng(4)
    edge = [0, 1, Q - 1, Q, Q + 1, 2**64 - 1, 2**64, 2**96 - 1, 2**96,
            2**127, 2**128 - 1, Q * Q, (Q - 1) * (Q - 1)]
    xs = edge + [int(v) << 64 | int(w) for v, w in
                 zip(rng.integers(0, 2**64, 300, dtype=np.uint64),
                     rng.integers(0, 2**64, 300, dtype=np.uint64))]
    hi = np.array([x >> 64 for x in xs], dtype=np.uint64)
    lo = np.array([x & (2**64 - 1) for x in xs], dtype=np.uint64)
    want = [x % Q for x in xs]
    got = to_numpy_u64(F._reduce128(to_torch(hi, "cpu"), to_torch(lo, "cpu")))
    assert [int(v) for v in got] == want
    assert np.array_equal(
        got, np.asarray(RF._reduce128(jnp.asarray(hi), jnp.asarray(lo))))
    plo, phi = G._reduce128(*_pairs(lo), *_pairs(hi))
    assert [int(v) for v in _np(plo) | (_np(phi) << np.uint64(32))] == want


def test_mul32_and_pair_carries():
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000000],
                    dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, edge.size),
                        rng.integers(0, 2**32, 200, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, edge.size),
                        rng.integers(0, 2**32, 200, dtype=np.uint64)])
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(
        b.astype(np.int64))
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    lo, hi = G._mul32(ta, tb)
    assert [int(x) | int(y) << 32 for x, y in zip(_np(lo), _np(hi))] == \
        [int(x) * int(y) for x, y in zip(a, b)]
    for name in ("_pair_add", "_pair_sub"):
        got = getattr(G, name)(ta, tb, tb, ta)
        want = getattr(RG, name)(ja, jb, jb, ja)
        for g, w in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(w).astype(np.uint64))


def test_encode_decode_rand_roundtrip():
    rng = np.random.default_rng(6)
    ints = [0, 1, Q - 1, Q, Q + 5, -1, 2**70]
    enc = F.encode(ints, "cpu")
    assert enc.dtype == torch.int64
    assert list(F.decode(enc)) == [v % Q for v in ints]
    assert np.array_equal(to_numpy_u64(enc), np.asarray(RF.encode(ints)))
    x = F.rand((4, 5), rng, "cpu")
    assert x.shape == (4, 5) and all(0 <= int(v) < Q
                                     for v in F.decode(x).ravel())
    u = to_numpy_u64(x)
    assert np.shares_memory(to_torch(u, "cpu").numpy(), u)
