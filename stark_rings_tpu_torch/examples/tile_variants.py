#!/usr/bin/env python
"""Time variants of the two tiled kernels of the deg-2^16 Goldilocks ring
multiply on the card, beside the kept design: the transposed K1 (the
tile shape, loads in flight, blocks an SM of ``csrc/fold.cu``'s
``fold_tw_t_kernel``) and the radix engine's tile (words a thread of
``csrc/ntt.cu``'s ``ntt_tile_kernel``), at the main path's shapes
(B = 80, N = 2^16, R = t = 256); and of K5, the MLE evaluation
(``csrc/mle.cu``'s ``mle_eval_kernel``, words a block), at nv = 20 and
24.

Each variant is a copy of the kept source with some constants changed,
built by nvcc on its own into ``build/tile_variants/``, and called
through its C entry point on the same inputs; its output is held to the
plain twin.  Four cost probes change the tile instead, so their
outputs differ on purpose: one drops the twiddle products' reduction
(``w * b`` mod 2^64), one the reduction of the butterfly's sum and
difference, one the twiddle loads (constant twiddles), one the words an
exchange moves through shared memory (its barrier stays).  What each
saves is what that part costs in the tile.  K5's three probes do the
same for its lerps (each becomes an xor), for the levels after the first
(each block writes its value and stops: no tickets, no last block), and
for both at once (the loads, shuffles and one barrier).

Run on a machine with a CUDA card and nvcc, from the root of a checkout:
    python -m stark_rings_tpu_torch.examples.tile_variants [fold] [tile]
        [eval]
(every group when none is named).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..fields import GOLDILOCKS as F
from ..mle import fix as FX
from ..ops import _build, fold as K, goldilocks_ntt as G
from ..ops.fold import Mxu2FusedNTT

__all__ = ["EVAL_VARIANTS", "FOLD_VARIANTS", "TILE_VARIANTS", "main"]

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / "tile_variants"

# name -> (what it changes, [(kept text, variant text)]); "kept" is the
# source as it stands
FOLD_VARIANTS = {
    "kept": ("32 x 32 tile, 1 row in flight, 8 blocks an SM", []),
    "32x64": ("32 x 64 tile", [("TILE_C = 32;", "TILE_C = 64;")]),
    "64x64": ("64 x 64 tile, 6 blocks an SM",
              [("TILE_R = 32;", "TILE_R = 64;"),
               ("TILE_C = 32;", "TILE_C = 64;"),
               ("TILE_BLOCKS = 8;", "TILE_BLOCKS = 6;")]),
    "depth2": ("2 rows in flight, 4 blocks an SM",
               [("DEPTH = 1;", "DEPTH = 2;"),
                ("TILE_BLOCKS = 8;", "TILE_BLOCKS = 4;")]),
}
TILE_VARIANTS = {
    "kept": ("16 words a thread (RB = 4)", []),
    "rb5": ("32 words a thread (RB = 5)", [("RB = 4;", "RB = 5;")]),
    "probe: w*b mod 2^64": (
        "cost probe, the twiddle products unreduced",
        [("    const uint64_t p = gl::mul(w, b);",
          "    const uint64_t p = w * b;"),
         ("    b = gl::mul(w, d);", "    b = w * d;")]),
    "probe: a+p, a-p mod 2^64": (
        "cost probe, the sum and difference unreduced",
        [("    b = gl::sub(a, p);\n    a = gl::add(a, p);",
          "    b = a - p;\n    a = a + p;"),
         ("    const uint64_t d = gl::sub(a, b);\n    a = gl::add(a, b);",
          "    const uint64_t d = a - b;\n    a = a + b;")]),
    "probe: no twiddle loads": (
        "cost probe, constant twiddles",
        [("tw[k] = k < nw ? __ldg(wb + k) : 0;",
          "tw[k] = k < nw ? 3 + k : 0;")]),
    "probe: no exchange traffic": (
        "cost probe, the barriers without the shared-memory words",
        [("sh[spad(word_at(p.u, lo, j))] = x[j];\n    __syncthreads();\n"
          "#pragma unroll\n"
          "    for (int j = 0; j < REG; ++j) x[j] = sh[spad(word_at(p.u, "
          "next, j))];",
          "x[j] += lo + next;\n    __syncthreads();")]),
}
_NO_LERPS = [
    ("return gl::lerp(odd ? o : v, odd ? v : o, r);", "return v ^ o ^ r;"),
    ("x[u] = gl::lerp(a, b, r0);", "x[u] = a ^ b ^ r0;"),
    ("x[c] = b < n ? gl::lerp(x[2 * c], x[2 * c + 1], r) : x[2 * c];",
     "x[c] = b < n ? x[2 * c] ^ x[2 * c + 1] ^ r : x[2 * c];")]
_ONE_LEVEL = [
    ("    while (done < nv) {\n"
     "        const int b = nv - done < EVAL_BITS ? nv - done : EVAL_BITS;\n"
     "        const int64_t g = idx >> b;",
     "    if (done < nv) {\n"
     "        if (threadIdx.x == 0) partials[idx] = v;\n"
     "        return;\n"
     "    }\n"
     "    while (done < nv) {\n"
     "        const int b = nv - done < EVAL_BITS ? nv - done : EVAL_BITS;\n"
     "        const int64_t g = idx >> b;")]
EVAL_VARIANTS = {
    "kept": ("2^12 words a block, 16 a thread", []),
    "8 words a thread": ("2^11 words a block",
                         [("EVAL_BITS = 12;", "EVAL_BITS = 11;")]),
    "probe: no lerps": ("cost probe, every lerp an xor", _NO_LERPS),
    "probe: one level": ("cost probe, no tickets and no last block",
                         _ONE_LEVEL),
    "probe: loads only": ("cost probe, both", _NO_LERPS + _ONE_LEVEL),
}
REPS = 10


def _build_variants(src: str, variants: dict) -> dict:
    """{name: loaded library} of ``src`` with each variant's changes,
    built side by side."""
    jobs = {}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        d = _OUT / src.split(".")[0] / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for header in _CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        text = (_CSRC / src).read_text()
        for kept, new in subs:
            if kept not in text:
                raise RuntimeError(f"{src}: variant {name!r} expects "
                                   f"{kept!r}")
            text = text.replace(kept, new)
        (d / src).write_text(text)
        so = d / "lib.so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(d / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} variant {name!r}:\n"
                               f"{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _time_ms(fn) -> float:
    """Median ms per call over REPS groups of 10 calls (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / 10)
    return statistics.median(samples)


def _call(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed ({err})")


def main(groups=None) -> None:
    groups = set(groups or sys.argv[1:] or ("fold", "tile", "eval"))
    if not torch.cuda.is_available():
        raise SystemExit("tile_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(0)
    N, B = 1 << 16, 80
    a, b = F.rand((B, N), rng, dev), F.rand((B, N), rng, dev)
    if "fold" in groups:
        _fold(a, dev, card)
    if "tile" in groups:
        _tile(a, b, dev, card)
    if "eval" in groups:
        _eval(rng, dev, card)


def _fold(a, dev, card) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    N = a.shape[1]
    eng = Mxu2FusedNTT(N, device=dev)
    V = eng._dot(eng.mat1, eng._to_internal(a), eng.c, "w1")
    tw, R = eng.c["tw"], eng.mat1.R
    t, cols = tw.shape[1], V.shape[1]
    want = K.fold_tw_ref(V, tw, R, transpose_out=True, signed=False)
    for name, lib in _build_variants("fold.cu", FOLD_VARIANTS).items():
        lib.srt_fold_tw.argtypes = [p, i64, p, i64, p, i64, i64, i32, i32,
                                    p]
        out = torch.empty((t, cols // t * R), dtype=torch.int64, device=dev)

        def run():
            _call(lib.srt_fold_tw, V.data_ptr(), cols, tw.data_ptr(), t,
                  out.data_ptr(), R, cols, 1, 0)

        run()
        torch.cuda.synchronize()
        equal = torch.equal(out, want)
        if not equal:
            raise AssertionError(f"K1 variant {name!r} differs from the "
                                 "twin")
        print(f"K1 transposed [{V.shape[0]}, {cols}] {name} "
              f"({FOLD_VARIANTS[name][0]}): {_time_ms(run):.4f} ms  "
              f"({card})")


def _tile(a, b, dev, card) -> None:
    p, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint64)
    B, N = a.shape
    wf, wi, ninv = G.GoldilocksKernelNTT(N, device=dev).tables()
    libs = _build_variants("ntt.cu", TILE_VARIANTS)
    for log_tile in (13, 14):
        for mode in ("forward", "mul_eval"):
            want = G.ntt_tile_ref(a, wf, wi, ninv, log_tile, mode, b)
            for name, lib in libs.items():
                lib.srt_ntt_tile.argtypes = [p, p, p, p, p, u64, i32, i32,
                                             i64, i32, p]
                out = torch.empty_like(a)

                def run():
                    _call(lib.srt_ntt_tile, a.data_ptr(), b.data_ptr(),
                          out.data_ptr(), wf.data_ptr(), wi.data_ptr(), ninv,
                          16, log_tile, B, G.MODES[mode])

                run()
                torch.cuda.synchronize()
                equal = torch.equal(out, want)
                if equal == name.startswith("probe"):
                    raise AssertionError(f"tile variant {name!r}: equal to "
                                         f"the twin is {equal}")
                print(f"tile {mode} log_tile {log_tile} [{B}, {N}] {name} "
                      f"({TILE_VARIANTS[name][0]}): {_time_ms(run):.4f} ms"
                      f"  ({card})")



def _eval(rng, dev, card) -> None:
    """K5's variants at nv = 20 and 24 through ``srt_mle_eval``, each
    launch on its own scratch (more than any variant asks for); the kept
    design is timed first and last."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = _build_variants("mle.cu", EVAL_VARIANTS)
    tickets = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    partials = torch.empty(1 << 16, dtype=torch.int64, device=dev)
    for nv in (20, 24):
        T = F.rand((1 << nv,), rng, dev)
        P = F.rand((nv,), rng, dev)
        want = FX.evaluate_goldilocks_ref(T, P)
        ptrs, vals = FX._point_table("variant", P, dev)
        for name in [*EVAL_VARIANTS, "kept"]:
            lib = libs[name]
            lib.srt_mle_eval.argtypes = [p, i32, p, p, p, i64, p, i64, p, p]
            out = torch.empty((), dtype=torch.int64, device=dev)

            def run():
                _call(lib.srt_mle_eval, T.data_ptr(), nv, ptrs, vals,
                      tickets.data_ptr(), tickets.numel(),
                      partials.data_ptr(), partials.numel(), out.data_ptr())

            for _ in range(3):   # back to back: the tickets return to 0
                run()
                torch.cuda.synchronize()
                equal = torch.equal(out, want)
                if equal == name.startswith("probe"):
                    raise AssertionError(f"K5 variant {name!r} nv={nv}: "
                                         f"equal to the twin is {equal}")
            print(f"K5 nv={nv} {name} ({EVAL_VARIANTS[name][0]}): "
                  f"{_time_ms(run):.4f} ms  ({card})", flush=True)


if __name__ == "__main__":
    main()
