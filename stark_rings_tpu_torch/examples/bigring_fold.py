#!/usr/bin/env python
"""Big-ring folding combine with a cached challenge, the deg-2^16
fixed-operand pattern, through the port's surface (counterpart of
``examples/bigring_fold.py``).

A folding prover repeatedly computes  w' = c * w + v  where c is ONE
challenge ring element fixed for the whole round.  With ``precompute``,
c's forward transform is built once; every combine then costs one
forward transform, the fused end-fold and slot product (K2) and one
inverse.  Squaring (the folding cross terms) runs through the same
kernels.  Both are held to the radix ``NTTContext``.

Run:  python -m stark_rings_tpu_torch.examples.bigring_fold
      [--device cpu]   (the CUDA card at deg 2^16, B = 16 unless
      --device cpu, which runs deg 2^10, B = 4 on the kernels' twins)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import get_device
from ..fields import GOLDILOCKS as F
from ..ops.fold import Mxu2FusedNTT
from ..ops.ntt import NTTContext

__all__ = ["main"]


def main(device: str = "cuda", seed: int = 0) -> None:
    dev = get_device(device)
    logN, B = (16, 16) if dev.type == "cuda" else (10, 4)
    N = 1 << logN
    print(f"deg-2^{logN} goldilocks ring, batch {B}, device {dev}")

    tp = Mxu2FusedNTT(N, device=dev)
    rng = np.random.default_rng(seed)
    w, v = F.rand((B, N), rng, dev), F.rand((B, N), rng, dev)
    ch = F.rand((1, N), rng, dev)

    vc = tp.precompute(ch)          # the challenge's transform, once a round
    w1 = F.add(tp.mul_cached(w, vc), v)

    # against the independent radix NTT path (a general multiply)
    ctx = NTTContext(F, N, negacyclic=True, device=dev)
    want = F.add(ctx.mul(w, ch.expand(w.shape)), v)
    assert torch.equal(w1, want), "mismatch"
    print("combine w' = c*w + v exact vs the radix oracle")

    assert torch.equal(tp.square(w), ctx.mul(w, w))
    print("square exact vs the radix oracle")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(args.device, args.seed)
