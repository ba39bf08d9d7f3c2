"""The port's host NTT oracles (``native/host.py`` ``HostGoldilocks``,
``HostRing``) against the reference's loaders: the stage tables, forward,
inverse and mul on numpy-seeded canonical rows, ``mul_storage`` on
Montgomery storage, and the schoolbook multiply; 0 differing bits."""

import numpy as np
import pytest

from stark_rings_tpu.native.host import HostGoldilocks as RefHostGoldilocks
from stark_rings_tpu.native.host import HostRing as RefHostRing

from stark_rings_tpu_torch import from_jax_storage, get_field
from stark_rings_tpu_torch.native.host import HostGoldilocks, HostRing


@pytest.mark.parametrize("N", [1 << 4, 1 << 9])
def test_host_goldilocks_matches_reference(N):
    ref, port = RefHostGoldilocks(N), HostGoldilocks(N)
    assert np.array_equal(port.wf, ref.wf) and np.array_equal(port.wi,
                                                              ref.wi)
    assert port.ninv == ref.ninv
    rng = np.random.default_rng(N)
    a = rng.integers(0, port.q, (3, N), dtype=np.uint64)
    b = rng.integers(0, port.q, (3, N), dtype=np.uint64)
    a[0, :2] = [port.q - 1, 0]
    for name in ("forward", "inverse"):
        assert np.array_equal(getattr(port, name)(a), getattr(ref, name)(a))
    got = port.mul(a, b)
    assert np.array_equal(got, ref.mul(a, b))
    assert np.array_equal(got[1], port.mul_schoolbook(a[1], b[1]))
    assert np.array_equal(port.inverse(port.forward(a)), a)
    assert np.array_equal(port.mul_storage(
        from_jax_storage(port.f, a, "cpu"),
        from_jax_storage(port.f, b, "cpu")), got)


@pytest.mark.parametrize("name,N", [("babybear", 1 << 4),
                                    ("goldilocks", 1 << 6)])
def test_host_ring_matches_reference(name, N):
    ref, port = RefHostRing(name, N), HostRing(name, N)
    assert np.array_equal(port.wf, ref.wf) and np.array_equal(port.wi,
                                                              ref.wi)
    assert port.ninv == ref.ninv and port.q == ref.q
    rng = np.random.default_rng(N)
    a = rng.integers(0, port.q, (2, N), dtype=np.uint64)
    b = rng.integers(0, port.q, (2, N), dtype=np.uint64)
    for op in ("forward", "inverse"):
        assert np.array_equal(getattr(port, op)(a), getattr(ref, op)(a))
    assert np.array_equal(port.mul(a, b), ref.mul(a, b))
    assert np.array_equal(port.mul_schoolbook(a[0], b[0]),
                          ref.mul_schoolbook(a[0], b[0]))
    f = get_field(name)
    dt = np.uint32 if name == "babybear" else np.uint64
    sa = rng.integers(0, port.q, (2, N), dtype=dt)
    sb = rng.integers(0, port.q, (2, N), dtype=dt)
    assert np.array_equal(port.mul_storage(from_jax_storage(f, sa, "cpu"),
                                           from_jax_storage(f, sb, "cpu")),
                          ref.mul_storage(sa, sb))
