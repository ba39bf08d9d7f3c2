"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` into one shared library with a
plain C interface, on first use, and loaded with ctypes: one ``nvcc -c``
per source, all started together, then one link.  The library lives
under ``build/torch_kernels/`` at the root of the checkout and is keyed
by a hash of the sources and the flags, so a stale binary never loads.
Nothing is compiled when this module is imported: a machine without
``nvcc`` imports it fine and raises only when a kernel is asked for.

:func:`on_cuda` and :func:`launch` are the dispatch rule every kernel
wrapper follows: CPU tensors go to the plain twin, CUDA tensors to the
kernel (or an exception), and every launch is counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

__all__ = ["NVCC_FLAGS", "WORK", "kernels", "launch", "library_path",
           "nvcc", "on_cuda", "work"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_CUDA_ROOTS = ("/usr/local/cuda",)

_lib = None
WORK = {}   # (device index, stream handle) -> [tickets, partials]


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


def _run_all(cmds) -> str:
    """Run the commands side by side; raise with the log if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def _build(so: pathlib.Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmpdir:
        srcs = sorted(_CSRC.glob("*.cu"))
        objs = [str(pathlib.Path(tmpdir) / (s.stem + ".o")) for s in srcs]
        log = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(srcs, objs)])
        tmp = str(pathlib.Path(tmpdir) / "lib.so")
        log += _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
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
    lib.srt_pointwise_mul.argtypes = [p, p, p, i64, i64, p]
    lib.srt_pointwise_chain.argtypes = [p, p, p, i64, i32, p]
    u64 = ctypes.c_uint64
    lib.srt_ntt_stage.argtypes = [p, p, p, u64, i32, i32, i32, i64, i32, p]
    lib.srt_ntt_tile.argtypes = [p, p, p, p, p, u64, i32, i32, i64, i32, p]
    lib.srt_mxu_mod_mat.argtypes = [p, p, p, i32, i32, i64, p]
    lib.srt_mxu_mod_mat_smem.argtypes = []
    lib.srt_mxu_mod_mat_smem.restype = ctypes.c_int
    lib.srt_bb_fold_tw.argtypes = lib.srt_fold_tw.argtypes
    lib.srt_bb_fold_end2_mul.argtypes = lib.srt_fold_end2_mul.argtypes
    lib.srt_bb_fold_end.argtypes = lib.srt_fold_end.argtypes
    lib.srt_mle_eval.argtypes = [p, i32, p, p, p, i64, p, i64, p, p]
    lib.srt_mle_fix.argtypes = [p, i32, i32, p, p, p, i64, p, i64, p, p]
    sumcheck = []
    for field in ("goldilocks", "babybear", "frog"):
        prove = getattr(lib, f"srt_sumcheck_prove_{field}")
        prove.argtypes = [p, p, p, i32, i32, i64, i32, i32, p, i64, p, p, p,
                          p]
        sumcheck.append(prove)
    exchange = []
    for field in ("goldilocks", "babybear"):
        fn = getattr(lib, f"srt_twiddle_exchange_{field}")
        fn.argtypes = [p, p, p, i32, i64, i32, i32, i32, i32, p]
        exchange.append(fn)
    stark = [getattr(lib, f"srt_stark_{op}") for op in ("mul", "add", "sub")]
    for fn in stark:
        fn.argtypes = [p, p, i64, p, i64, p]
    lib.srt_limb_fold.argtypes = [p, p, i64, i64, i32, i32, p]
    lib.srt_slot_mul.argtypes = [p, p, p, i64, i64, i32, i32, u64, p]
    lib.srt_slot_matvec.argtypes = [p, p, p, i64, i32, i32, i64, i64, i64,
                                    i32, i32, u64, p, p, p]
    u32 = ctypes.c_uint32
    lib.srt_bb_slot_mul.argtypes = [p, p, p, i64, i64, i32, i32, u32, p]
    lib.srt_bb_slot_matvec.argtypes = [p, p, p, i64, i32, i32, i64, i64,
                                       i64, i32, i32, u32, p, p, p]
    digits = [lib.srt_step_digits, lib.srt_bb_step_digits]
    for fn in digits:
        fn.argtypes = [p, p, p, i32, i32, i64, i32, u64, i32, i32, p, p, p, p]
    for fn in (lib.srt_fold_tw, lib.srt_fold_end2_mul, lib.srt_fold_end,
               lib.srt_pointwise_mul, lib.srt_pointwise_chain,
               lib.srt_ntt_stage, lib.srt_ntt_tile, lib.srt_mxu_mod_mat,
               lib.srt_bb_fold_tw,
               lib.srt_bb_fold_end2_mul, lib.srt_bb_fold_end,
               lib.srt_mle_eval, lib.srt_mle_fix, *sumcheck,
               *exchange, *stark, lib.srt_limb_fold, lib.srt_slot_mul,
               lib.srt_slot_matvec, lib.srt_bb_slot_mul,
               lib.srt_bb_slot_matvec, *digits):
        fn.restype = ctypes.c_int
    lib.srt_error_string.argtypes = [i32]
    lib.srt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def on_cuda(name, *tensors) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {dev}")


def launch(counts: dict, name: str, fn, device, *args, stream=None) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s
    current stream (or on the handle ``stream``), raise if the launch
    failed, and count it in ``counts[name]``."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err:
        msg = kernels().srt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    counts[name] += 1


def work(device, stream: int, tickets: int, partials: int):
    """The scratch of ``stream`` on ``device`` for kernels that combine
    their blocks' values by last-block tickets: (address, length) of its
    tickets (int32, at least ``tickets``) and of its partials (int64, at
    least ``partials``), (0, 0) for either where none is needed.  The
    tickets are zeroed when they are made, on that stream, and every
    kernel leaves them at 0; the partials are scratch.  Launches on one
    stream run in turn, so the kernels of all modules share it."""
    bufs = WORK.setdefault((device.index, stream), [None, None])
    out = []
    for i, (n, make) in enumerate(((tickets, torch.zeros),
                                   (partials, torch.empty))):
        if not n:
            out += (0, 0)
            continue
        if bufs[i] is None or bufs[i].numel() < n:
            bufs[i] = make(n, dtype=(torch.int32, torch.int64)[i],
                           device=device)
        out += (bufs[i].data_ptr(), bufs[i].numel())
    return out
