#!/usr/bin/env python
"""One LatticeFold-style folding step with a Fiat-Shamir transcript,
driven through the port's surface (counterpart of
``examples/folding_step.py``):

    1. Two Ajtai commitments c_i = A s_i over the frog ring, the
       witnesses gadget-decomposed short.
    2. Every digit coefficient is range-checked on the device in one
       batched call (the monomial psi check, monomial.rs:82-93).
    3. A SHAKE-256 transcript absorbs the commitments (canonical
       base-field bytes) and squeezes the folding challenge r.
    4. Fold: s = s_0 + r s_1, c = c_0 + r c_1; c == A s by ring linearity
       (the homomorphism folding relies on), and a verifier replaying
       the transcript gets the same r.
    5. The same fold as the composed ``protocol.FoldingStep`` (challenge
       fold, ICRT, gadget decompose, device L2 check, CRT, digit
       commitment) on a full-range witness batch.

frog is a power-of-two cyclotomic (X^16 + 1), so the psi range check has
its (-d', d') completeness property (monomial.rs:120-134).

Run:  python -m stark_rings_tpu_torch.examples.folding_step
      [--device cpu]   (the CUDA card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..decomp import gadget_decompose
from ..linalg import Matrix, RingElems
from ..protocol import FoldingStep
from ..rings import get_ring
from ..rings.absorb import Transcript
from ..rings.monomial import psi_range_check_batched
from ..rings.sampling import sample_short

__all__ = ["main"]


def main(device: str = "cuda", seed: int = 7) -> None:
    ring = get_ring("frog", device=device)
    f = ring.field
    e = RingElems(ring)
    rng = np.random.default_rng(seed)
    n, m, base, k = 2, 3, 4, 16

    A = Matrix.rand(e, n, m * k, rng)

    tr = Transcript(b"folding-demo")
    commits, witnesses = [], []
    for i in range(2):
        s = sample_short(ring, (m,), rng, bound=1)       # coefficient form
        # short witnesses have every gadget digit in (-d', d')
        digits = gadget_decompose(f, s, base, k)         # [m*k, D]
        checks = psi_range_check_batched(ring, digits)
        assert bool(checks.all()), "witness out of range"
        s_ntt = ring.crt(digits)
        c = A.mul_vec(s_ntt)
        tr.absorb(b"commit", f, c)
        commits.append(c)
        witnesses.append(s_ntt)
        print(f"commitment {i}: range check ok over {checks.numel()} "
              "digits")

    # the folding challenge from the transcript (an NTT-form scalar)
    r_vals = tr.squeeze_field_elements(f, 1, ring.device)
    r_int = int(f.decode(r_vals)[0])
    r = ring.from_scalar_ntt(r_int)
    print("challenge r =", r_int)

    s_fold = ring.add(witnesses[0], ring.ntt_mul(
        r.expand(witnesses[1].shape), witnesses[1]))
    c_fold = ring.add(commits[0], ring.ntt_mul(r.expand(commits[1].shape),
                                               commits[1]))
    ok = torch.equal(A.mul_vec(s_fold), c_fold)
    print("folded opening verifies:", ok)
    assert ok
    # transcript determinism: a verifier replaying the absorbs gets r
    tv = Transcript(b"folding-demo")
    for c in commits:
        tv.absorb(b"commit", f, c)
    assert int(f.decode(tv.squeeze_field_elements(f, 1, ring.device))[0]) \
        == r_int
    print("verifier transcript replay matches")

    # -- the same fold as the composed FoldingStep --------------------------
    # k defaults to decomposition_max_length(q, base) = 32 here: the staged
    # part's k = 16 was enough only for its bound-1 SHORT witnesses; the
    # composed step decomposes a full-range folded witness
    fs = FoldingStep(ring, n_rows=n, wit_len=m, base=base)
    cP = fs.init_tables(rng)
    r_coeff = ring.from_scalar_coeff(r_int)
    rt = fs.precompute_challenge(r_coeff)
    W = 2
    s0t, s1t = fs.rand_witness(W, rng), fs.rand_witness(W, rng)
    c0t = fs.tm.to_t(ring.rand_ntt((W, n), rng))
    c1t = fs.tm.to_t(ring.rand_ntt((W, n), rng))
    o = fs.step(cP, s0t, s1t, c0t, c1t, rt)
    assert bool(o["ok_l2"].all()), "composed L2 check failed"
    # linearity of the composed fold (the staged path's check)
    s1 = fs.tm.from_t(s1t)
    want = ring.add(fs.tm.from_t(s0t), ring.ntt_mul(
        s1, ring.crt(r_coeff).expand(s1.shape)))
    assert torch.equal(fs.tm.from_t(o["s"]), want)
    print("composed folding step matches the staged fold; "
          f"digit commitment shape {tuple(o['cd'].shape)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    main(args.device, args.seed)
