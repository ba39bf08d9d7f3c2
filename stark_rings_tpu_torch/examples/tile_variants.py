#!/usr/bin/env python
"""Time variants of the two tiled kernels of the deg-2^16 Goldilocks ring
multiply on the card, beside the kept design: the transposed K1 (the
tile shape, loads in flight, blocks an SM of ``csrc/fold.cu``'s
``fold_tw_t_kernel``) and the radix engine's tile (words a thread of
``csrc/ntt.cu``'s ``ntt_tile_kernel``), at the main path's shapes
(B = 80, N = 2^16, R = t = 256); and of K5, the MLE evaluation
(``csrc/mle.cu``'s ``mle_eval_kernel``, words a block), at nv = 20 and
24; and the mod-mat kernel (``csrc/mxu.cu``'s ``mxu_mod_mat_kernel``)
beside the reference's stacked operand form, which multiplies the zero
blocks of its stacked weights too (190 tensor-core products a tile
against 100), at the main shape of ``MatmulNTT``'s levels; and the
Goldilocks slot mat-vec (``csrc/slot.cu``'s ``slot_matvec_kernel``) at
the folding step's commit (n = 8, m = 8,192, W = 16), with reduced
products in 128-bit sums in place of unreduced ones in 192-bit sums, or
64 j's staged at a time in place of 32.

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
        [eval] [mxu] [wide] [slot]
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
from ..mle import sumcheck_kernel as SK
from ..ops import _build, fold as K, goldilocks_ntt as G, mxu_fused as MF
from ..ops import slot as SL
from ..ops.fold import Mxu2FusedNTT
from ..ops.mxu import MatmulNTT
from ..rings import get_ring

__all__ = ["EVAL_VARIANTS", "FOLD_VARIANTS", "MXU_VARIANTS", "SLOT_VARIANTS",
           "TILE_VARIANTS", "WIDE_VARIANTS", "main"]

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
_MXU_B = ("        b[l][1] = ds[(l * KQ + t + 4) * D_STRIDE + g];\n"
          "    }\n")
_MXU_ZERO_BLOCKS = (
    "    {   // the stacked form's zero blocks: s - l outside the digits\n"
    "        const uint32_t z[4] = {0, 0, 0, 0};\n"
    "#pragma unroll\n"
    "        for (int mt = 0; mt < MT; ++mt)\n"
    "#pragma unroll\n"
    "            for (int l = 0; l < DIGITS; ++l)\n"
    "#pragma unroll\n"
    "                for (int s = 0; s < BUCKETS; ++s)\n"
    "                    if (s < l || s >= l + DIGITS)\n"
    "                        mma_s8(acc[mt][s], z, b[l][0], b[l][1]);\n"
    "    }\n")
MXU_VARIANTS = {
    "kept": ("the 100 digit products W_k x_l into 19 bucket tiles", []),
    "stacked": ("the stacked [19R, 10C] x [10C, M] form: 190 products a "
                "tile, the 90 zero blocks of its weights included",
                [(_MXU_B, _MXU_B + _MXU_ZERO_BLOCKS)]),
    "16 warps": ("512 threads, one m16 tile (16 x 8 of y) a warp: 76 "
                 "accumulator registers",
                 [("THREADS = 256;", "THREADS = 512;"), ("MT = 2;",
                                                         "MT = 1;")]),
    "2 blocks an SM": ("one m16 tile a warp, blocks of 32 x 32, at most "
                       "128 registers: two blocks an SM",
                       [("MT = 2;", "MT = 1;"),
                        ("MIN_BLOCKS = 1;", "MIN_BLOCKS = 2;")]),
    "x loaded late": (
        "the next chunk's x loaded after the products, not before them",
        [("            copy_w(ch + 1, smem + (buf ^ 1) * W_WORDS);\n"
          "            load_x(ch + 1);\n        }\n"
          "        chunk_products(acc, ws + wr * 16 * MT * W_STRIDE, "
          "ds + wm * 8, g, t);\n",
          "            copy_w(ch + 1, smem + (buf ^ 1) * W_WORDS);\n"
          "        }\n"
          "        chunk_products(acc, ws + wr * 16 * MT * W_STRIDE, "
          "ds + wm * 8, g, t);\n"
          "        if (ch + 1 < chunks) load_x(ch + 1);\n")]),
    "probe: no fold": (
        "cost probe, each output the plain sum of its 19 buckets",
        [("y[e] = fold_buckets(v);",
          "y[e] = 0;\n"
          "                for (int s2 = 0; s2 < BUCKETS; ++s2)\n"
          "                    y[e] += static_cast<uint32_t>(v[s2]);")]),
    "probe: no tensor-core products": (
        "cost probe, each mma.sync an integer add of its operands",
        [('    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
          '        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
          '{%0, %1, %2, %3};"\n'
          '        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])\n'
          '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), '
          '"r"(b1));',
          "    d[0] += a[0] ^ b0;\n    d[1] += a[1] ^ b1;\n"
          "    d[2] += a[2];\n    d[3] += a[3];")]),
}
WIDE_VARIANTS = {
    "kept": ("one (entry, group of 8 sums) a thread", []),
    "probe: no products": (
        "cost probe, every factor's products dropped (staging, folds, "
        "barriers and sums kept)",
        [("                        sc_wide_factor<F>(prod, stage[j * 2 * E "
          "+ e],\n                                          stage[j * 2 * E "
          "+ E + e], t0, k,\n                                          "
          "j0 + j == 0);",
          "                        prod[0] = stage[j * 2 * E + e];"),
         ("                    sc_wide_factor<F>(prod, tab(j)[y], "
          "tab(j)[y + h], t0, k,\n                                      "
          "j == s);",
          "                    prod[0] = tab(j)[y];")]),
    "probe: block barriers for grid barriers": (
        "cost probe, each grid round ended by __syncthreads",
        [("        row0 += nb;\n        cooperative_groups::this_grid()"
          ".sync();",
          "        row0 += nb;\n        __syncthreads();")]),
    "probe: no tail rounds": (
        "cost probe, the tail's rounds skipped",
        [("        for (int i = tail; i < rounds; ++i)\n"
          "            sc_wide_tail_round<F>(",
          "        for (int i = rounds; i < rounds; ++i)\n"
          "            sc_wide_tail_round<F>(")]),
}
SLOT_VARIANTS = {
    "kept": ("unreduced products in 192-bit sums, 32 j's a stage", []),
    "reduced": ("each product reduced mod q, 128-bit sums",
                [("""        const uint64_t plo = a * b, phi = __umul64hi(a, b);
        lo += plo;
        const uint64_t c0 = lo < plo;
        const uint64_t h = hi + phi;
        const uint64_t c1 = h < phi;      // then h < 2^64 - 1: no 2nd carry
        hi = h + c0;
        top += c1 + (hi < c0);""", """        const uint64_t p = gl::mul(a, b);
        lo += p;
        hi += lo < p;""")]),
    "step64": ("64 j's a stage (38 KB of shared memory)",
               [("MV_STEP = 32;", "MV_STEP = 64;")]),
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
    groups = set(groups or sys.argv[1:]
                 or ("fold", "tile", "eval", "mxu", "wide", "slot"))
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
    if "mxu" in groups:
        _mxu(rng, dev, card)
    if "wide" in groups:
        _wide(rng, dev, card)
    if "slot" in groups:
        _slot(rng, dev, card)


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


def _mxu(rng, dev, card) -> None:
    """The mod-mat kernel and its stacked-form variant on MatmulNTT's
    column matrix at the main shape (R = C = 128, 10,240 columns) through
    ``srt_mxu_mod_mat``; the kept design is timed first and last."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = _build_variants("mxu.cu", MXU_VARIANTS)
    f = MF.MxuModMatFused(MatmulNTT(device=dev).col_mat.matrix(),
                          device=dev)
    x = F.rand((f.C, 80 * 128), rng, dev)
    want = MF.mxu_mod_mat_ref(x[:, :1024].contiguous(), f.w)
    for name in [*MXU_VARIANTS, "kept"]:
        lib = libs[name]
        lib.srt_mxu_mod_mat.argtypes = [p, p, p, i32, i32, i64, p]
        out = torch.empty((f.R, x.shape[1]), dtype=torch.int64, device=dev)

        def run():
            _call(lib.srt_mxu_mod_mat, x.data_ptr(), f.wt.data_ptr(),
                  out.data_ptr(), f.R, f.C, x.shape[1])

        run()
        torch.cuda.synchronize()
        equal = torch.equal(out[:, :1024], want)
        if equal == name.startswith("probe"):
            raise AssertionError(f"mod-mat variant {name!r}: equal to the "
                                 f"twin is {equal}")
        print(f"mxu_mod_mat [{f.R}, {f.C}] x [{f.C}, {x.shape[1]}] {name} "
              f"({MXU_VARIANTS[name][0]}): {_time_ms(run):.4f} ms  "
              f"({card})", flush=True)


def _wide(rng, dev, card) -> None:
    """K7 beyond 8 tables (``sumcheck_wide_kernel``) and its cost probes
    at nv = 16, k = 9 and 16 over Goldilocks, launched bare through
    ``srt_sumcheck_prove_goldilocks``; the kept design first and last."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = _build_variants("mle.cu", WIDE_VARIANTS)
    for nv, k in ((16, 9), (16, 16)):
        tables = [F.rand((1 << nv,), rng, dev) for _ in range(k)]
        chal = F.rand((nv,), rng, dev)
        want = SK.sumcheck_prove_many_ref(tables, chal)[0]
        plan = SK.plan(nv, k, 8)
        half = 1 << (nv - 1)
        scratch = torch.empty((1, k, half), dtype=torch.int64, device=dev)
        partials = torch.empty((plan.rows, k + 1), dtype=torch.int64,
                               device=dev)
        msgs = torch.empty((1, nv, k + 1), dtype=torch.int64, device=dev)
        ins = (ctypes.c_void_p * k)(*[T.data_ptr() for T in tables])
        info = (ctypes.c_int * 2)()
        for name in [*WIDE_VARIANTS, "kept"]:
            fn = libs[name].srt_sumcheck_prove_goldilocks
            fn.argtypes = [p, p, p, i32, i32, i64, i32, i32, p, i64, p, p,
                           p, p]

            def run():
                _call(fn, ins, None, scratch.data_ptr(), k, 1, half, nv,
                      plan.tail, chal.data_ptr(), plan.rows,
                      partials.data_ptr(), msgs.data_ptr(), info)

            run()
            torch.cuda.synchronize()
            equal = torch.equal(msgs[0], want)
            if equal == name.startswith("probe"):
                raise AssertionError(f"K7 variant {name!r} nv={nv} k={k}: "
                                     f"equal to the twin is {equal}")
            print(f"K7 nv={nv} k={k} {name} ({WIDE_VARIANTS[name][0]}): "
                  f"{_time_ms(run):.4f} ms, grid {info[0]} blocks "
                  f"({info[1]}/SM)  ({card})", flush=True)


def _slot(rng, dev, card) -> None:
    """``slot_matvec_kernel`` at the commit's shape, launched bare
    through ``srt_slot_matvec`` with the wrapper's plan and scratch; the
    kept design first and last."""
    p, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_uint64)
    libs = _build_variants("slot.cu", SLOT_VARIANTS)
    N, n, W, m = 8, 8, 16, 8192
    t = SL.ext_tables(get_ring("goldilocks", device=dev))
    A, x = F.rand((N, 3, n, m), rng, dev), F.rand((N, 3, W, m), rng, dev)
    want = SL.slot_matvec_ref(A, x, t)
    plan = SL.matvec_plan(N, n, W, m)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets, _, partials, _ = _build.work(dev, stream, plan.tickets,
                                          plan.partials)
    out = torch.empty_like(want)
    for name in [*SLOT_VARIANTS, "kept"]:
        fn = libs[name].srt_slot_matvec
        fn.argtypes = [p, p, p, i64, i32, i32, i64, i64, i64, i32, i32, u64,
                       p, p, p]

        def run():
            _call(fn, A.data_ptr(), x.data_ptr(), out.data_ptr(), N, n, W, m,
                  plan.chunk, plan.chunks, plan.tiles_n, plan.tiles, t.nr,
                  partials, tickets)

        out.zero_()
        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"slot_matvec variant {name!r} differs "
                                 "from the twin")
        print(f"slot_matvec n={n} W={W} m={m} {name} "
              f"({SLOT_VARIANTS[name][0]}): {_time_ms(run):.4f} ms  "
              f"({card})", flush=True)


if __name__ == "__main__":
    main()
