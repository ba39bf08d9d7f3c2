#!/usr/bin/env python
"""Time two kernels through their public wrappers only, so that two
checkouts of the package can be compared in turns on one card: the
fused mod-mat kernel (``MxuModMatFused.apply``) on ``MatmulNTT``'s
column matrix at the main shape (R = C = 128, 10,240 columns: one level
of a deg-2^14 multiply at B = 80) beside ``MxuModMat.apply`` and
``MatmulNTT.mul`` on both kinds of level; and K7's wide path (k > 8
tables, ``sumcheck_prove_many``) over Goldilocks at nv = 16 with k = 9
and 16, and nv = 12 with k = 9.

For each K7 proof: its launches, wall time (CUDA events, median of 10
groups after two warm-ups), device busy time (torch.profiler) and the
wrapper's host time (no synchronisation).

Run on a machine with a CUDA card and nvcc, from the root of a checkout:
    python -m stark_rings_tpu_torch.examples.wrapper_times [mxu] [wide]
(both groups when none is named); to time another checkout's package,
put its root first on the path:
    PYTHONPATH=<other checkout> python \
        stark_rings_tpu_torch/examples/wrapper_times.py
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from stark_rings_tpu_torch.fields import GOLDILOCKS as F
from stark_rings_tpu_torch.mle import sumcheck_kernel as SK
from stark_rings_tpu_torch.ops import mxu_fused as MF
from stark_rings_tpu_torch.ops.mxu import MatmulNTT

__all__ = ["WIDE_SHAPES", "main", "time_ms", "wide_times"]

REPS = 10
WIDE_SHAPES = ((16, 9), (16, 16), (12, 9))   # (nv, k) over Goldilocks
MM_B = 80


def time_ms(fn, inner=1) -> float:
    """Median ms per call over REPS groups of ``inner`` calls (CUDA
    events), after two warm-up calls."""
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


def busy_ms(fn, n=20) -> float:
    """Device busy ms a call over ``n`` calls (torch.profiler), 0 when
    the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the window's first kernel goes unrecorded: let it be this one
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if "at::native" not in r.key]
    return sum(r.self_device_time_total for r in rows) / 1e3 / n


def host_us(fn, n=200) -> float:
    """Median µs of host time a call over 5 groups of ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def wide_times(dev, rng, shapes=WIDE_SHAPES) -> dict:
    """{(nv, k): (launches, wall ms, busy ms, host µs)} of one Goldilocks
    K7 proof of k tables at nv variables."""
    name = "sumcheck_prove_many_goldilocks"
    out = {}
    for nv, k in shapes:
        tables = [F.rand((1 << nv,), rng, dev) for _ in range(k)]
        chal = F.rand((nv,), rng, dev)

        def prove():
            return SK.sumcheck_prove_many(tables, chal)

        before = SK.LAUNCHES[name]
        prove()
        torch.cuda.synchronize()
        out[(nv, k)] = (SK.LAUNCHES[name] - before, time_ms(prove),
                        busy_ms(prove), host_us(prove))
    return out


def _mxu(dev, rng, card) -> None:
    mm = MatmulNTT(device=dev)
    cols = MM_B * mm.N2
    plain = mm.col_mat
    fused = MF.MxuModMatFused(plain.matrix(), device=dev)
    x = F.rand((plain.C, cols), rng, dev)
    if not torch.equal(fused.apply(x), plain.apply(x)):
        raise AssertionError("mxu_mod_mat differs from MxuModMat.apply")
    ms = time_ms(lambda: fused.apply(x), inner=10)
    level_ms = time_ms(lambda: plain.apply(x))
    fl = MatmulNTT(device=dev)
    for key in ("col_mat", "row_mat", "col_mat_inv", "row_mat_inv"):
        setattr(fl, key, MF.MxuModMatFused(getattr(mm, key).matrix(),
                                           device=dev))
    a, b = (F.rand((MM_B, mm.N), rng, dev) for _ in range(2))
    print(f"[mxu] mxu_mod_mat [{plain.R}, {plain.C}] x [{plain.C}, {cols}]: "
          f"kernel {ms:.4f} ms, MxuModMat.apply {level_ms:.4f} ms; "
          f"MatmulNTT.mul N={mm.N} B={MM_B}: MxuModMat levels "
          f"{time_ms(lambda: mm.mul(a, b)):.4f} ms, fused levels "
          f"{time_ms(lambda: fl.mul(a, b)):.4f} ms  ({card})", flush=True)


def main(groups=None) -> None:
    groups = set(groups or sys.argv[1:] or ("mxu", "wide"))
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(0)
    if "mxu" in groups:
        _mxu(dev, rng, card)
    if "wide" in groups:
        for (nv, k), (n, wall, busy, host) in wide_times(dev, rng).items():
            print(f"[wide] goldilocks nv={nv} k={k}: {n} launch(es) a "
                  f"proof, wall {wall:.4f} ms, busy {busy:.4f} ms, host "
                  f"{host:.2f} us  ({card})", flush=True)


if __name__ == "__main__":
    main()
