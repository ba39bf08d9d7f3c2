#!/usr/bin/env python
"""An Ajtai-style lattice commitment over the goldilocks ring model,
driven through the port's surface (counterpart of
``examples/ajtai_commitment.py``):

    commit(s) = A s          A: n x m matrix of NTT-form ring elements
    opening check:  c == A s   and   ||s||_inf small

In one flow: ring CRT and slot-wise multiply, matrices over ring
elements, gadget decomposition (to make the witness short), the exact
norms on the device and on the host, and the invertible short
challenge.

Run:  python -m stark_rings_tpu_torch.examples.ajtai_commitment
      [--device cpu]   (the CUDA card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..decomp import (decomposition_max_length, gadget_decompose,
                      gadget_recompose)
from ..decomp.norms import l2_check, l2_norm_squared, linf_norm_exact
from ..linalg import Matrix, RingElems
from ..rings import get_ring
from ..rings.sampling import sample_short_invertible

__all__ = ["main"]


def main(device: str = "cuda", seed: int = 2024) -> None:
    ring = get_ring("goldilocks", device=device)
    f = ring.field
    e = RingElems(ring)
    rng = np.random.default_rng(seed)

    n, m = 4, 8          # commitment matrix shape (ring elements)
    b, k = 256, decomposition_max_length(f.q, 256)

    # the witness: an arbitrary message vector (coefficient form), made
    # SHORT by gadget decomposition: s = G^-1(msg), ||s||_inf <= b/2 and
    # msg = G s
    msg = ring.rand_coeff((m,), rng)
    s_short = gadget_decompose(f, msg, b, k)          # [m*k, D]
    assert linf_norm_exact(f, s_short) <= b // 2
    # the exact L2 check on the device: the gadget guarantees
    # ||s||_2^2 <= m*k*D*(b/2)^2
    beta_sq = m * k * ring.D * (b // 2) ** 2
    assert bool(l2_check(f, s_short, beta_sq)), "device L2 check failed"
    assert l2_norm_squared(f, s_short) <= beta_sq     # host cross-check
    assert torch.equal(gadget_recompose(f, s_short, b, k), msg)

    # commit in NTT form: c = A s with A of n x (m*k) (the decomposed basis)
    A = Matrix.rand(e, n, m * k, rng)
    s_ntt = ring.crt(s_short)
    c = A.mul_vec(s_ntt)
    print(f"commitment: {n} ring elements (D={ring.D}) on {e.device}, "
          f"witness {m * k} short elements, ||s||_inf <= {b // 2}")
    assert torch.equal(A.mul_vec(s_ntt), c)           # deterministic

    # folding-style challenge: a short invertible ring element; the folded
    # witness ch * s and the folded commitment ch * c agree:
    # A (ch s) == ch (A s)
    ch_ntt = ring.crt(sample_short_invertible(ring, rng, bound=2))
    s_folded = ring.ntt_mul(ch_ntt, s_ntt)
    assert torch.equal(A.mul_vec(s_folded), ring.ntt_mul(ch_ntt, c))
    print("homomorphism check (A(ch*s) == ch*(A s)): ok")

    # the folded witness's norm (exact, on the host), and the device L2
    # against the folding growth bound ||ch||_1 * D
    s_folded_coeff = ring.icrt(s_folded)
    norm = linf_norm_exact(f, s_folded_coeff)
    print(f"folded witness linf norm: {norm} (q ~ 2^{f.q.bit_length()})")
    fold_beta_sq = beta_sq * (2 * 2 + 1) ** 2 * ring.D ** 2
    okf = l2_check(f, s_folded_coeff, fold_beta_sq)
    print(f"device L2 bound check after folding: {bool(okf)}")
    print("demo ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    main(args.device, args.seed)
