"""The port's frog field (``FROG``, q = 15912092521325583641, u64
Montgomery form in int64 tensors) on the CPU against the JAX reference's
``FROG``: host conversions, elementwise ops, reductions, powers and the
inverse.  Inputs are numpy-seeded words plus 0, 1, q-1 and words near
2^63 and 2^64; values are compared as the reference's uint64 storage,
with 0 differing bits allowed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stark_rings_tpu.fields import FROG as RF

from stark_rings_tpu_torch import (FROG as F, from_jax_storage, get_field,
                                   to_numpy_storage)
from stark_rings_tpu_torch.fields import FIELDS

Q = F.q
#: storage words: the edges of [0, q) and of the sign bit
EDGE = [0, 1, 2, Q - 2, Q - 1, 2**63 - 2, 2**63 - 1, 2**63, 2**63 + 1]
#: words beyond q, up to 2^64 - 1 (not storage; from_uint takes them)
HIGH = [Q, Q + 1, 2**64 - 2, 2**64 - 1]


def _t(x):
    return from_jax_storage(F, np.asarray(x, dtype=np.uint64), "cpu")


def _np(x):
    return to_numpy_storage(x)


def _storage(rng, n):
    return np.concatenate([np.array(EDGE, dtype=np.uint64),
                           rng.integers(0, Q, n, dtype=np.uint64)])


def test_field_constants_and_registry():
    assert (F.name, F.q, F.bits, F.dtype) == ("frog", RF.q, RF.bits,
                                              torch.int64)
    assert get_field("frog") is F and FIELDS["frog"] is F
    assert F.q > 2**63 and F.q.bit_length() == 64


def test_encode_decode_and_constants_match_reference():
    rng = np.random.default_rng(0)
    ints = np.array(EDGE + HIGH + [int(v) for v in rng.integers(0, Q, 40,
                                                               dtype=np.uint64)]
                    + [2 * Q + 5, -1, -Q, 2**70 + 3], dtype=object)
    enc = F.encode(ints, "cpu")
    assert enc.dtype == torch.int64
    assert np.array_equal(_np(enc), np.asarray(RF.encode(ints)))
    assert np.array_equal(F.storage_np(ints), np.asarray(RF.encode(ints)))
    assert list(F.decode(enc)) == [int(v) % Q for v in ints]
    assert list(F.decode(enc)) == list(RF.decode(RF.encode(ints)))
    for v in (0, 1, Q - 1, -3, 12345, 2**63):
        assert int(_np(F.const(v, "cpu"))) == int(RF.const(v))
    assert np.array_equal(_np(F.ones((3,), "cpu")), np.asarray(RF.ones((3,))))
    assert np.array_equal(_np(F.zeros((2, 2), "cpu")),
                          np.zeros((2, 2), np.uint64))
    x = F.rand((6, 5), rng, "cpu")
    assert x.shape == (6, 5) and x.dtype == torch.int64
    assert all(0 <= int(v) < Q for v in _np(x).reshape(-1))


def test_from_uint_matches_reference_on_every_u64():
    rng = np.random.default_rng(1)
    x = np.concatenate([np.array(EDGE + HIGH, dtype=np.uint64),
                        rng.integers(0, 2**64 - 1, 200, dtype=np.uint64,
                                     endpoint=True)])
    assert np.array_equal(_np(F.from_uint(x, "cpu")),
                          np.asarray(RF.from_uint(jnp.asarray(x))))
    assert list(F.decode(F.from_uint(x, "cpu"))) == [int(v) % Q for v in x]


@pytest.mark.parametrize("pairs", ["seeded", "edges", "full-u64"])
def test_elementwise_ops_match_reference(pairs):
    """add (wrap detect (s < a) | (s >= q)), sub, neg, mul (REDC with the
    carry of the low words), canon and from_canon, bit for bit: on
    seeded storage, on every pair of edge words, and on full-range u64
    words, where the reference's wrapping arithmetic is followed too."""
    rng = np.random.default_rng(2)
    if pairs == "seeded":
        a, b = _storage(rng, 400), _storage(rng, 400)[::-1].copy()
    elif pairs == "edges":
        e = np.array(EDGE, dtype=np.uint64)
        a, b = np.repeat(e, len(e)), np.tile(e, len(e))
    else:
        a, b = (np.concatenate([np.array(EDGE + HIGH, dtype=np.uint64),
                                rng.integers(0, 2**64 - 1, 400,
                                             dtype=np.uint64, endpoint=True)])
                for _ in range(2))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("add", "sub", "mul"):
        got = _np(getattr(F, name)(_t(a), _t(b)))
        assert np.array_equal(got, np.asarray(getattr(RF, name)(ja, jb))), \
            name
    for name in ("neg", "canon", "from_canon"):
        assert np.array_equal(_np(getattr(F, name)(_t(a))),
                              np.asarray(getattr(RF, name)(ja))), name


def test_arithmetic_on_canonical_values():
    """mul, add and sub agree with Python ints mod q, and canon /
    from_canon are inverse to each other."""
    rng = np.random.default_rng(3)
    a, b = _storage(rng, 100), _storage(rng, 100)[::-1].copy()
    ca, cb = F.decode(_t(a)), F.decode(_t(b))
    assert list(F.decode(F.mul(_t(a), _t(b)))) == [
        x * y % Q for x, y in zip(ca, cb)]
    assert list(F.decode(F.add(_t(a), _t(b)))) == [
        (x + y) % Q for x, y in zip(ca, cb)]
    assert list(F.decode(F.sub(_t(a), _t(b)))) == [
        (x - y) % Q for x, y in zip(ca, cb)]
    assert torch.equal(F.from_canon(F.canon(_t(a))), _t(a))
    assert [int(v) for v in _np(F.canon(_t(a)))] == list(ca)


def test_reductions_powers_and_inverse_match_reference():
    rng = np.random.default_rng(4)
    x = _storage(rng, 55).reshape(8, 8)
    for axis in (0, 1, -1):
        assert np.array_equal(_np(F.sum(_t(x), axis)),
                              np.asarray(RF.sum(jnp.asarray(x), axis)))
    assert np.array_equal(_np(F.sum(_t(x[:7, :3]), 0)),
                          np.asarray(RF.sum(jnp.asarray(x[:7, :3]), 0)))
    assert np.array_equal(_np(F.dot(_t(x), _t(x[::-1]), 1)),
                          np.asarray(RF.dot(jnp.asarray(x),
                                            jnp.asarray(x[::-1].copy()), 1)))
    nz = x.reshape(-1)[1:]                      # drop the word 0
    for e in (0, 1, 2, 5, 2**63 + 3, Q - 1):
        assert np.array_equal(_np(F.pow_const(_t(nz), e)),
                              np.asarray(RF.pow_const(jnp.asarray(nz), e)))
    assert np.array_equal(_np(F.inv(_t(nz))),
                          np.asarray(RF.inv(jnp.asarray(nz))))
    assert list(F.decode(F.mul(F.inv(_t(nz)), _t(nz)))) == [1] * nz.size
