"""ctypes loader for the native host oracle ``csrc/stark_rings_host.cpp``.

Counterpart of ``stark_rings_tpu/native/host.py`` that imports no JAX.
The C++ source is compiled with g++ on first use into ``build/`` at the
root of the checkout, keyed by a hash of the source, as the reference
loader does.  It holds two kinds of oracle:

* the schoolbook negacyclic multiplies, O(N^2) and independent of every
  NTT and table, for Goldilocks and for any prime below 2^64;
* :class:`HostGoldilocks` and :class:`HostRing`, the host NTTs with the
  stage tables and leaf order of ``ops/ntt.py``: the only oracle fast
  enough at deg 2^20 (a few seconds a row).

Arrays cross as numpy ``uint64``, canonical values in [0, q).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from ..device import to_numpy_storage

__all__ = ["get_host_lib", "negacyclic_mul_schoolbook",
           "negacyclic_mul_schoolbook_q", "HostGoldilocks", "HostRing"]

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "csrc" / "stark_rings_host.cpp"
_BUILD = _ROOT / "build"

_lib = None


def _so_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libstark_rings_host.{digest}.so"


def get_host_lib() -> ctypes.CDLL:
    """The loaded host library, compiled first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists():
        _BUILD.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared",
                            "-fPIC", str(_SRC), "-o", tmp], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(so))
    u64 = ctypes.c_uint64
    p64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.srh_negacyclic_mul_schoolbook.argtypes = [p64, p64, p64, u64]
    lib.srh_negacyclic_mul_schoolbook_q.argtypes = [p64, p64, p64, u64,
                                                    u64]
    lib.srh_ntt_forward.argtypes = [p64, p64, u64, u64]
    lib.srh_ntt_inverse.argtypes = [p64, p64, u64, u64, u64]
    lib.srh_pointwise_mul.argtypes = [p64, p64, p64, u64]
    lib.srh_ntt_forward_q.argtypes = [p64, p64, u64, u64, u64]
    lib.srh_ntt_inverse_q.argtypes = [p64, p64, u64, u64, u64, u64]
    lib.srh_pointwise_mul_q.argtypes = [p64, p64, p64, u64, u64]
    for fn in (lib.srh_negacyclic_mul_schoolbook,
               lib.srh_negacyclic_mul_schoolbook_q, lib.srh_ntt_forward,
               lib.srh_ntt_inverse, lib.srh_pointwise_mul,
               lib.srh_ntt_forward_q, lib.srh_ntt_inverse_q,
               lib.srh_pointwise_mul_q):
        fn.restype = None
    _lib = lib
    return lib


def negacyclic_mul_schoolbook(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b in F_q[X]/(X^N + 1) for one pair of uint64 [N] coefficient
    vectors, by the O(N^2) schoolbook sum.  Releases the GIL while it
    runs, so several rows can go to threads."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"expected two [N] vectors, got {a.shape}, "
                         f"{b.shape}")
    c = np.empty_like(a)
    get_host_lib().srh_negacyclic_mul_schoolbook(a, b, c, a.size)
    return c


def negacyclic_mul_schoolbook_q(a: np.ndarray, b: np.ndarray,
                                q: int) -> np.ndarray:
    """a * b in F_q[X]/(X^N + 1) for one pair of [N] vectors of canonical
    values below a prime q < 2^64, by the O(N^2) schoolbook sum; uint64
    result.  Releases the GIL while it runs."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"expected two [N] vectors, got {a.shape}, "
                         f"{b.shape}")
    c = np.empty_like(a)
    get_host_lib().srh_negacyclic_mul_schoolbook_q(a, b, c, a.size, q)
    return c


def _u64(x) -> np.ndarray:
    """A contiguous uint64 copy (the C entry points work in place)."""
    return np.array(x, dtype=np.uint64, order="C", copy=True)


class HostRing:
    """Host negacyclic NTT of size N over a prime below 2^64, with the
    radix engine's stage tables and leaf order (canonical values in
    [0, q); Montgomery storage is decoded at the boundary by
    :meth:`mul_storage`).  Tables: ``wf[2^s + i]`` is stage s's i-th
    forward twiddle, ``wi`` the inverse's, ``ninv`` = 1/N.  It calls the
    library's entry points that take q (``srh_*_q``)."""

    _ENTRY_SUFFIX = "_q"

    def __init__(self, field_name: str, N: int):
        from ..fields import get_field
        from ..ops.ntt import NTTContext

        self.f = get_field(field_name)
        self.q = self.f.q
        self.N = N
        self.lib = get_host_lib()
        ctx = NTTContext(self.f, N, negacyclic=True, device="cpu")
        exps = np.array([e for ex in ctx.stage_exps for e in ex],
                        dtype=np.int64)
        self.wf = np.zeros(N, dtype=np.uint64)
        self.wi = np.zeros(N, dtype=np.uint64)
        for tab, base in ((self.wf, ctx.psi_int), (self.wi, ctx.psi_inv_int)):
            pows = np.array(_pow_list(base, 2 * N, self.q), dtype=np.uint64)
            tab[1:] = pows[exps]
        self.ninv = pow(N, self.q - 2, self.q)

    def _entry(self, name: str, *args):
        """Call ``srh_<name>`` (with q last, for the ``_q`` entries)."""
        q = (self.q,) if self._ENTRY_SUFFIX else ()
        getattr(self.lib, f"srh_{name}{self._ENTRY_SUFFIX}")(*args, *q)

    def _rows(self, name, x, *tables) -> np.ndarray:
        out = _u64(x)
        flat = out.reshape(-1, self.N)
        self._entry(name, flat, *tables, flat.shape[0], self.N)
        return out

    def forward(self, x) -> np.ndarray:
        """[..., N] coefficients -> leaf-order evaluations."""
        return self._rows("ntt_forward", x, self.wf)

    def inverse(self, x) -> np.ndarray:
        return self._rows("ntt_inverse", x, self.wi, self.ninv)

    def mul(self, a, b) -> np.ndarray:
        """Canonical uint64 [..., N] in, canonical uint64 out."""
        fa, fb = self.forward(a), self.forward(b)
        prod = np.empty_like(fa)
        self._entry("pointwise_mul", fa.reshape(-1), fb.reshape(-1),
                    prod.reshape(-1), fa.size)
        return self.inverse(prod)

    def mul_storage(self, a, b) -> np.ndarray:
        """Storage tensors of the field (any device) -> the canonical
        product (compare with ``field.decode`` of a device result)."""
        return self.mul(*(to_numpy_storage(self.f.canon(x).cpu())
                          for x in (a, b)))

    def mul_schoolbook(self, a, b) -> np.ndarray:
        """The independent O(N^2) oracle on one [N] row."""
        return negacyclic_mul_schoolbook_q(a, b, self.q)


class HostGoldilocks(HostRing):
    """:class:`HostRing` over Goldilocks through the fixed-modulus entry
    points (the reference's ``HostGoldilocks``)."""

    _ENTRY_SUFFIX = ""

    def __init__(self, N: int):
        super().__init__("goldilocks", N)


def _pow_list(base: int, n: int, q: int) -> list[int]:
    out, v = [], 1
    for _ in range(n):
        out.append(v)
        v = v * base % q
    return out
