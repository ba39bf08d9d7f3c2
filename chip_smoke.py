#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA Hopper card.

The main path is the deg-2^16 Goldilocks negacyclic ring multiply at
batch 80 through ``stark_rings_tpu_torch.Mxu2FusedNTT``: six digit GEMMs
(``torch._int_mm``) and the hand-written CUDA fold kernels K1
(``fold_tw``), K2 (``fold_end2_mul``) and K3 (``fold_end``).

Run from the root of a checkout, on a machine with one CUDA card of
compute capability 9.x and ``nvcc``:

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card, its name and power limit (nvidia-smi);
  2. build: nvcc builds the kernels from ``stark_rings_tpu_torch/csrc``;
  3. kernel parity: each kernel against its plain twin on the card, bit
     for bit, at the main path's shapes, on buckets from the real GEMM,
     at the bucket bound and over the whole int32 range; both digit
     schemes (the signed one at batch 8); the GEMM against an exact
     float64 product;
  4. engine parity at N = 2^16, B = 80: mul, stack_forward mul, square,
     mul_cached (batch-80 and batch-1 operand) and the folding combine
     w' = c*w + v, each bit-equal to the kernel-free Mxu2NTT on the card,
     and for 2 rows to the native schoolbook oracle (C++, O(N^2));
  5. launch counts of phase 4 (each kernel must have run);
  6. timings (CUDA events, median of 10 after warm-up): each kernel
     against its plain twin, the four digit GEMMs, and whole multiplies
     per second on the kernel path and on the plain path;
  7. profile: device busy time of one mul and its top kernels
     (torch.profiler).

Every check raises on failure, so the exit code is non-zero.  The next
to last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card the script fails
before printing any result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parent
N = 1 << 16
B = 80
B_SIGNED = 8
SEED = 0
REPS = 10
ORACLE_ROWS = 2
SOURCE = "stark_rings_tpu_torch/csrc/fold.cu"
KERNELS = {  # wrapper -> (reference kernel entry point, file:line)
    "fold_tw": "stark_rings_tpu/ops/pallas_fold.py:377",
    "fold_end2_mul": "stark_rings_tpu/ops/pallas_fold.py:467",
    "fold_end": "stark_rings_tpu/ops/pallas_fold.py:370",
}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out.splitlines()[0]


def main() -> None:
    if not (HERE / "stark_rings_tpu_torch" / "csrc" / "fold.cu").is_file():
        raise SystemExit(f"chip_smoke.py: {HERE} holds no "
                         "stark_rings_tpu_torch package; run it from the "
                         "root of a checkout")
    sys.path.insert(0, str(HERE))

    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this script measures the card only)")
    cap = torch.cuda.get_device_capability(0)
    if cap[0] != 9:
        raise RuntimeError(f"need a Hopper card (compute capability 9.x), "
                           f"got {cap}")
    dev = torch.device("cuda", 0)
    smi = card_info()
    print(smi)
    phase("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")

    from stark_rings_tpu_torch import (GOLDILOCKS as F, Mxu2FusedNTT,
                                       Mxu2NTT, to_numpy_u64, to_torch)
    from stark_rings_tpu_torch.fields.field import u64_lt
    from stark_rings_tpu_torch.native.host import negacyclic_mul_schoolbook
    from stark_rings_tpu_torch.ops import _build, fold as K

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.library_path()
    fresh = not so.exists()
    _build.kernels()
    log = so.with_suffix(".log")
    phase("build", f"{'built' if fresh else 'cached'} {so.name} in "
          f"{time.perf_counter() - t0:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    if fresh and log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    rng = np.random.default_rng(SEED)
    q = F.q
    a_np = rng.integers(0, q, (B, N), dtype=np.uint64)
    b_np = rng.integers(0, q, (B, N), dtype=np.uint64)
    ch_np = rng.integers(0, q, (1, N), dtype=np.uint64)
    v_np = rng.integers(0, q, (B, N), dtype=np.uint64)

    # the independent oracle runs on host threads while the card works
    pool = ThreadPoolExecutor(max_workers=3 * ORACLE_ROWS)
    oracle = {
        name: [pool.submit(negacyclic_mul_schoolbook, x[i], y[i])
               for i in range(ORACLE_ROWS)]
        for name, x, y in (("ab", a_np, b_np), ("aa", a_np, a_np),
                           ("ac", a_np, np.repeat(ch_np, ORACLE_ROWS, 0)))}

    t0 = time.perf_counter()
    eng = Mxu2FusedNTT(N, device=dev)
    eng_stacked = Mxu2FusedNTT(N, stack_forward=True, device=dev)
    plain = Mxu2NTT(N, device=dev)
    eng_signed = Mxu2FusedNTT(N, unsigned=False, device=dev)
    phase("tables", f"4 engines (N={N}) built in "
          f"{time.perf_counter() - t0:.1f} s")
    a, b, ch, v = (to_torch(x, dev) for x in (a_np, b_np, ch_np, v_np))

    # -- 3. kernel parity at the main path's shapes ------------------------
    max_err = {name: 0 for name in KERNELS}

    def check(name, got, want, what):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {got.dtype} "
                                 f"{tuple(got.shape)} vs {want.dtype} "
                                 f"{tuple(want.shape)}")
        bad = (got != want).nonzero()
        err = 0
        if bad.numel():
            g = to_numpy_u64(got[tuple(bad.t())]).tolist()
            w = to_numpy_u64(want[tuple(bad.t())]).tolist()
            err = max(abs(x - y) for x, y in zip(g, w))
        max_err[name] = max(max_err[name], err)
        if err:
            raise AssertionError(f"{name} {what}: {bad.shape[0]} elements "
                                 f"differ from the plain twin, max |err| "
                                 f"{err}")

    def kernel_parity(e, Bx, label):
        s = e.signed
        R = e.mat1.R
        x = F.rand((Bx, N), rng, dev)
        y = F.rand((e.mat2i.C, Bx, e.N1), rng, dev)   # NTT-domain input
        z = F.rand((e.mat1i.C, Bx, e.N2), rng, dev)
        V1 = e._dot(e.mat1, e._to_internal(x), e.c, "w1")
        V2i = e._dot(e.mat2i, y, e.c, "w2i")
        V1i = e._dot(e.mat1i, z, e.c, "w1i")
        Va, _, _ = e._fwd_buckets(x, e.c)
        Vb, _, _ = e._fwd_buckets(F.rand((Bx, N), rng, dev), e.c)
        Vc, _, _ = e._fwd_buckets(F.rand((1, N), rng, dev), e.c)
        bound = (1 << 26) - 1 if s else (1 << 27) - 1
        gen = torch.Generator(device=dev).manual_seed(SEED)
        extreme = {
            "bound": torch.full_like(V1, bound),
            "-bound" if s else "zero": torch.full_like(V1, -bound if s
                                                       else 0),
            "int32": torch.randint(-2**31, 2**31, V1.shape, generator=gen,
                                   dtype=torch.int32, device=dev),
        }
        cases = [("fold_tw", "tw T", (V1, e.c["tw"], R), {"transpose_out":
                                                           True}),
                 ("fold_tw", "twi T", (V2i, e.c["twi"], e.mat2i.R),
                  {"transpose_out": True}),
                 ("fold_tw", "tw N", (V1, e.c["tw"], R),
                  {"transpose_out": False}),
                 ("fold_end", "inverse level 2", (V1i, e.mat1i.R), {}),
                 ("fold_end2_mul", "two inputs", (Va, Vb, e.mat2.R), {}),
                 ("fold_end2_mul", f"stacked {tuple(Va.shape[:1])}x"
                  f"{2 * Va.shape[1]}", (torch.cat([Va, Vb], 1), None,
                                         e.mat2.R), {}),
                 ("fold_end2_mul", f"batch-1 Vb {tuple(Vc.shape)}",
                  (Va, Vc, e.mat2.R), {})]
        for key, Vx in extreme.items():
            cases += [("fold_tw", key, (Vx, e.c["tw"], R),
                       {"transpose_out": True}),
                      ("fold_end", key, (Vx, R), {}),
                      ("fold_end2_mul", key, (Vx, Vx.flip(1).contiguous(),
                                              R), {})]
        refs = {"fold_tw": K.fold_tw_ref, "fold_end": K.fold_end_ref,
                "fold_end2_mul": K.fold_end2_mul_ref}
        for name, what, args, kw in cases:
            got = getattr(K, name)(*args, signed=s, **kw)
            want = refs[name](*args, signed=s, **kw)
            torch.cuda.synchronize()
            check(name, got, want, f"{label} {what}")
        # the digit GEMM against an exact float64 product (sums < 2^53)
        mat = e.mat1
        d = mat.planes(e._to_internal(x).reshape(mat.C, -1))
        big = torch.from_numpy(mat.big).to(dev).double()
        exact = big @ d.double()
        if not torch.equal(V1.double(), exact):
            raise AssertionError(f"{label}: digit GEMM differs from the "
                                 "float64 product")
        phase("parity", f"{label}: {len(cases)} kernel cases bit-equal to "
              f"the twins; GEMM {tuple(V1.shape)} exact")
        return V1, V2i, V1i, Va, Vb, Vc

    t0 = time.perf_counter()
    V1, V2i, V1i, Va, Vb, Vc = kernel_parity(eng, B, f"unsigned B={B}")
    kernel_parity(eng_signed, B_SIGNED, f"signed B={B_SIGNED}")
    phase("parity", f"done in {time.perf_counter() - t0:.1f} s")

    # -- 4. engine parity at N = 2^16, B = 80 ------------------------------
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    runs = {
        "mul": lambda: eng.mul(a, b),
        "stack_forward": lambda: eng_stacked.mul(a, b),
        "square": lambda: eng.square(a),
        "mul_cached": lambda: eng.mul_cached(a, eng.precompute(b)),
        "mul_cached_batch1": lambda: eng.mul_cached(a, eng.precompute(ch)),
        "combine": lambda: F.add(eng.mul_cached(a, eng.precompute(ch)), v),
    }
    results, per_variant = {}, {}
    for name, fn in runs.items():
        before = dict(K.LAUNCHES)
        results[name] = fn()
        per_variant[name] = {k: K.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    phase("engine", f"6 variants at N={N}, B={B} in "
          f"{time.perf_counter() - t0:.2f} s; launches {per_variant}")

    pc = plain.precompute(ch)
    want = {
        "mul": plain.mul(a, b),
        "square": plain.square(a),
        "mul_cached": plain.mul_cached(a, plain.precompute(b)),
        "mul_cached_batch1": plain.mul_cached(a, pc),
        "combine": F.add(plain.mul_cached(a, pc), v),
    }
    want["stack_forward"] = want["mul"]
    qmax = F.encode([q - 1], dev)
    for name, got in results.items():
        if got.shape != (B, N) or got.dtype != torch.int64:
            raise AssertionError(f"{name}: got {got.dtype} "
                                 f"{tuple(got.shape)}")
        if u64_lt(qmax, got).any():
            raise AssertionError(f"{name}: non-canonical output")
        if not torch.equal(got, want[name]):
            raise AssertionError(f"{name}: kernel path differs from the "
                                 "plain path on the card")
    if not torch.equal(want["mul"], plain.mul_cached(a, plain.precompute(
            b))):
        raise AssertionError("plain mul and plain mul_cached differ")
    phase("engine", "kernel path bit-equal to the plain Mxu2NTT path for "
          "all 6 variants, whole batch")

    t0 = time.perf_counter()
    orc = {k: np.stack([f.result() for f in fs]) for k, fs in oracle.items()}
    pool.shutdown()
    comb = np.array([[(int(x) + int(y)) % q for x, y in zip(r, s)]
                     for r, s in zip(orc["ac"], v_np[:ORACLE_ROWS])],
                    dtype=np.uint64)
    expect = {"mul": orc["ab"], "stack_forward": orc["ab"],
              "mul_cached": orc["ab"], "square": orc["aa"],
              "mul_cached_batch1": orc["ac"], "combine": comb}
    for name, rows in expect.items():
        got = to_numpy_u64(results[name][:ORACLE_ROWS])
        if not np.array_equal(got, rows):
            raise AssertionError(f"{name}: differs from the schoolbook "
                                 "oracle")
    phase("oracle", f"{ORACLE_ROWS} rows of every variant equal the native "
          f"schoolbook product (waited {time.perf_counter() - t0:.1f} s)")

    # -- 5. launch counts --------------------------------------------------
    phase("launches", json.dumps(launches))
    for name in KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 "path")

    # -- 6. timings ---------------------------------------------------------
    def time_ms(fn, inner=1):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            samples.append(start.elapsed_time(stop) / inner)
        return statistics.median(samples)

    Vs = torch.cat([Va, Vb], 1)
    R = eng.mat2.R

    def shape(*ts):
        return " x ".join(str(list(t.shape)) for t in ts)

    timed = [  # (kernel, shapes, call); the first per kernel is the record's
        ("fold_tw", shape(V1) + " transposed",
         lambda f: f(V1, eng.c["tw"], R, transpose_out=True, signed=False)),
        ("fold_end2_mul", shape(Va, Vb),
         lambda f: f(Va, Vb, R, signed=False)),
        ("fold_end", shape(V1i), lambda f: f(V1i, R, signed=False)),
        ("fold_end2_mul", "stacked " + shape(Vs),
         lambda f: f(Vs, None, R, signed=False)),
        ("fold_end2_mul", "batch-1 " + shape(Va, Vc),
         lambda f: f(Va, Vc, R, signed=False)),
    ]
    twins = {"fold_tw": K.fold_tw_ref, "fold_end2_mul": K.fold_end2_mul_ref,
             "fold_end": K.fold_end_ref}
    times = {}
    for name, shapes, call in timed:
        ms = time_ms(lambda: call(getattr(K, name)), inner=10)
        plain_ms = time_ms(lambda: call(twins[name]))
        times.setdefault(name, (ms, plain_ms))
        phase("time", f"{name} {shapes}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms  ({smi})")
    gemm = {}
    for key, mat in (("w1", eng.mat1), ("w2", eng.mat2), ("w2i", eng.mat2i),
                     ("w1i", eng.mat1i)):
        xc = F.rand((mat.C, B * N // mat.C), rng, dev)
        gemm[key] = time_ms(lambda: mat.dot(xc, eng.c[key],
                                            eng.c[key + "_corr"]))
    s8 = eng.mat1._planes(xc, 0x80).view(torch.int8)
    mm_ms = time_ms(lambda: torch._int_mm(eng.c["w1i"], s8))
    six = 2 * gemm["w1"] + 2 * gemm["w2"] + gemm["w2i"] + gemm["w1i"]
    phase("time", f"digit GEMM {shape(eng.c['w1i'], s8)} with digit planes "
          f"and offset terms: " + ", ".join(f"{k} {v:.4f} ms"
                                             for k, v in gemm.items())
          + f"; the six of one mul {six:.4f} ms (_int_mm alone "
          f"{mm_ms:.4f} ms)  ({smi})")
    mul_ms = time_ms(lambda: eng.mul(a, b))
    plain_mul_ms = time_ms(lambda: plain.mul(a, b))
    phase("time", f"mul N={N} B={B}: kernel path {mul_ms:.3f} ms = "
          f"{B / mul_ms * 1e3:.1f} mults/s; plain path {plain_mul_ms:.3f} "
          f"ms = {B / plain_mul_ms * 1e3:.1f} mults/s  ({smi})")

    # -- 7. where the device time of one mul goes ---------------------------
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.mul(a, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / 3
    top = "; ".join(f"{e.key[:48]} x{e.count // 3} "
                    f"{e.self_device_time_total / 1e3 / 3:.3f} ms"
                    for e in rows[:8])
    phase("profile", f"mul N={N} B={B}: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (profiled), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; per mul: {top}  ({smi})")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0],
         "plain_ms": times[name][1]} for name in KERNELS]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
