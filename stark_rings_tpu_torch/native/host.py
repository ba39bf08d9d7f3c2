"""ctypes loader for the native host oracle ``csrc/stark_rings_host.cpp``.

Counterpart of ``stark_rings_tpu/native/host.py`` that imports no JAX.
The C++ source is compiled with g++ on first use into ``build/`` at the
root of the checkout, keyed by a hash of the source, as the reference
loader does.  The port needs only the schoolbook negacyclic multiply:
an O(N^2) oracle independent of every NTT and table.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

__all__ = ["get_host_lib", "negacyclic_mul_schoolbook"]

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
    p64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.srh_negacyclic_mul_schoolbook.argtypes = [p64, p64, p64,
                                                  ctypes.c_uint64]
    lib.srh_negacyclic_mul_schoolbook.restype = None
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
