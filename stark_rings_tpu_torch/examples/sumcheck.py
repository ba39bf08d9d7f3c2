#!/usr/bin/env python
"""The multilinear sumcheck protocol over Goldilocks, BabyBear or frog,
driven through the port's surface (counterpart of
``examples/sumcheck.py``, which runs it over Goldilocks).

Claim: S = sum_{x in {0,1}^n} g(x) * h(x) for multilinear g, h.  Each
round the prover sends the degree-2 univariate p_i(t) = sum_{x'} g(t, x')
h(t, x') as its values at t = 0, 1, 2, computed on the halved tables
(``mle.sumcheck``, variable 0 first); the SHAKE-256 transcript returns
the challenge r_i, and both sides reduce the claim to p_i(r_i).  The
verifier's final check evaluates g and h at the challenge point: over
Goldilocks through ``evaluate_goldilocks`` (kernel K5 when the tables
are on the card, its plain twin, the value ``DenseMLE.evaluate`` gives,
on the CPU), over the other fields through ``DenseMLE.evaluate`` (the
reference has no evaluation kernel for them).

Each round moves its three messages to the host once (to be absorbed)
and its challenge to the device once.

Run:  python -m stark_rings_tpu_torch.examples.sumcheck [--n-vars 14]
      [--field goldilocks|babybear|frog] [--device cpu]
      (the CUDA card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..fields import GOLDILOCKS, get_field
from ..linalg import FieldElems
from ..mle import DenseMLE
from ..mle.fix import evaluate_goldilocks
from ..mle.sumcheck import sumcheck_fold, sumcheck_round
from ..rings.absorb import Transcript

__all__ = ["prove", "verify", "main"]

_LABELS = (b"p0", b"p1", b"p2")


def _interp_at(f, p0, p1, p2, r):
    """The quadratic through (0,p0), (1,p1), (2,p2), evaluated at r."""
    dev = r.device
    inv2 = f.const(pow(2, f.q - 2, f.q), dev)
    one, two = f.const(1, dev), f.const(2, dev)
    l0 = f.mul(f.mul(f.sub(r, one), f.sub(r, two)), inv2)
    l1 = f.mul(r, f.sub(two, r))                       # -r(r-2)
    l2 = f.mul(f.mul(r, f.sub(r, one)), inv2)
    return f.add(f.add(f.mul(p0, l0), f.mul(p1, l1)), f.mul(p2, l2))


def _absorb_round(transcript, f, msg):
    """Absorb one round's (p0, p1, p2) after one copy to the host."""
    host = torch.stack(msg).cpu()
    for lbl, p in zip(_LABELS, host):
        transcript.absorb(lbl, f, p)


def prove(g_evals, h_evals, transcript, n_vars, f=GOLDILOCKS):
    """Run the prover over n_vars rounds on storage tables of the field
    ``f``; returns (claimed sum S, round messages [(p0, p1, p2)],
    challenges), all 0-d tensors on the tables' device."""
    if g_evals.shape != (1 << n_vars,) or h_evals.shape != g_evals.shape:
        raise ValueError(f"prove: tables must have 2^{n_vars} entries")
    S = f.sum(f.mul(g_evals, h_evals), axis=0)
    transcript.absorb(b"sum", f, S)
    G, H = g_evals, h_evals
    msgs, chals = [], []
    for _ in range(n_vars):
        p0, p1, p2, G0, H0, dG, dH = sumcheck_round(f, G, H)
        _absorb_round(transcript, f, (p0, p1, p2))
        (r,) = transcript.squeeze_field_elements(f, 1, G.device)
        G, H = sumcheck_fold(f, r, G0, H0, dG, dH)
        msgs.append((p0, p1, p2))
        chals.append(r)
    return S, msgs, chals


def verify(S, msgs, g_mle, h_mle, transcript):
    """Replay the transcript; True iff every round and the final MLE
    evaluation check pass (over the MLEs' field)."""
    f = g_mle.e.f
    transcript.absorb(b"sum", f, S)
    claim = S
    rs = []
    for p0, p1, p2 in msgs:
        if not bool(f.add(p0, p1) == claim):
            return False
        _absorb_round(transcript, f, (p0, p1, p2))
        (r,) = transcript.squeeze_field_elements(f, 1, S.device)
        rs.append(r)
        claim = _interp_at(f, p0, p1, p2, r)
    if f is GOLDILOCKS:
        gv = evaluate_goldilocks(g_mle.evals, rs)
        hv = evaluate_goldilocks(h_mle.evals, rs)
    else:
        gv, hv = g_mle.evaluate(rs), h_mle.evaluate(rs)
    return bool(claim == f.mul(gv, hv))


def main(n_vars: int = 14, device: str = "cuda", seed: int = 7,
         field: str = "goldilocks") -> None:
    F = get_field(field)
    rng = np.random.default_rng(seed)
    e = FieldElems(F, device)
    g = DenseMLE.rand(e, n_vars, rng)
    h = DenseMLE.rand(e, n_vars, rng)

    S, msgs, chals = prove(g.evals, h.evals, Transcript(b"sumcheck"),
                           n_vars, F)
    ok = verify(S, msgs, g, h, Transcript(b"sumcheck"))
    assert ok, "honest proof rejected"

    # soundness smoke test: tamper with one round message
    bad = [list(m) for m in msgs]
    bad[min(3, n_vars - 1)][1] = F.add(bad[min(3, n_vars - 1)][1],
                                       F.const(1, e.device))
    assert not verify(S, [tuple(m) for m in bad], g, h,
                      Transcript(b"sumcheck")), "tampered proof accepted"

    print(f"sumcheck over {n_vars} {field} vars on {e.device}: "
          f"S = {int(F.decode(S))}, verified = {ok}, tamper rejected")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-vars", type=int, default=14)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--field", default="goldilocks",
                    choices=["goldilocks", "babybear", "frog"])
    args = ap.parse_args()
    main(args.n_vars, args.device, args.seed, args.field)
