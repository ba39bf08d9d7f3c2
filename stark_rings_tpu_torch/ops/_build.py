"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into one shared library with a
plain C interface, on first use, and loaded with ctypes.  The library
lives under ``build/torch_kernels/`` at the root of the checkout and is
keyed by a hash of the sources and the flags, so a stale binary never
loads.  Nothing is compiled when this module is imported: a machine
without ``nvcc`` imports it fine and raises only when a kernel is
asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "kernels", "library_path", "nvcc"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_CUDA_ROOTS = ("/usr/local/cuda",)

_lib = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *_CUDA_ROOTS):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "stark_rings_tpu_torch cannot be built here")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libsrt_kernels.{h.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sorted(_CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (raises if it
    cannot be built or loaded)."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.srt_fold_tw.argtypes = [p, i64, p, i64, p, i64, i64, i32, i32, p]
    lib.srt_fold_end2_mul.argtypes = [p, i64, p, i64, i64, p, i64, i64,
                                      i32, p]
    lib.srt_fold_end.argtypes = [p, i64, p, i64, i64, i32, p]
    for fn in (lib.srt_fold_tw, lib.srt_fold_end2_mul, lib.srt_fold_end):
        fn.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [i32]
    lib.srt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
