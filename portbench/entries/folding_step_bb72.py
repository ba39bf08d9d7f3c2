"""Entry: one LatticeFold-style folding step over the BabyBear ring
F_q[X]/(X^72 - X^36 + 1), q = 15 * 2^27 + 1: ``FoldingStep
.precompute_challenge(r)`` of a short challenge, then ``FoldingStep.step``
on W witnesses in the batch-trailing NTT-form layout ([72, W, L]
witnesses, [72, W, n] commitments, the Ajtai matrix [72, n, M]), all
int32 Montgomery storage words.  The call ends when its check bits
``ok_l2`` and ``ok_psi`` are on the host.

The traffic, the chaining and the witness classes are those of
``entries/folding_step.py`` (its generator deals the classes): call 2j
folds ``r_j s1_j`` in and call 2j+1 folds it out again with ``-r_j``;
``s1`` and ``c1`` cycle through a pool and ``r`` through a list, all
made from the seed on the device in set-up.  A challenge is a monomial
+-X^a, a in [0, 72); its product with a ternary ``s1`` has coefficients
in [-2, 2] at D = 72 as at D = 24 (X^72 = X^36 - 1: a coefficient of
X^a s1 gathers at most two of s1's), so folding moves every coefficient
by at most 2 and keeps each class in its range.  At D = 72 psi passes a
non-negative digit a exactly when a <= 35, so the mix plants its
out-of-range values at 40 or more.  The reference recomputes a checked
call's every output (``reference/cyclotomic72.py``).
"""

from __future__ import annotations

import torch

from portbench.harness import BENCH, load_module
from portbench.reference import babybear as bb
from portbench.reference.cyclotomic72 import D, Cyclotomic72, fold_step

_fold24 = load_module(BENCH / "entries" / "folding_step.py")
witnesses = _fold24.witnesses


def _uniform_words(gen, shape, device):
    """Storage words uniform over [0, q): every value once."""
    return torch.randint(0, bb.Q, shape, generator=gen, dtype=torch.int32,
                         device=device)


def challenges(gen, count, device):
    """[2, count, D] coefficient-form challenges (int32 storage),
    monomials +-X^a drawn from the seed; row 1 holds their negations."""
    places = torch.randint(0, D, (count, 1), generator=gen,
                           dtype=torch.int64, device=device)
    signs = 2 * torch.randint(0, 2, (count, 1), generator=gen,
                              dtype=torch.int64, device=device) - 1
    r = torch.zeros((count, D), dtype=torch.int64, device=device)
    r.scatter_(1, places, signs)
    return torch.stack([bb.from_signed(r), bb.from_signed(-r)]).to(
        torch.int32)


class Entry(_fold24.Entry):
    """The D = 24 entry's loop (inputs, call, finish, advance, check)
    over BabyBear inputs and the D = 72 reference."""

    def __init__(self, config, traffic, seed, device, program):
        if config["model"] != "babybear" or int(config["D"]) != D:
            raise ValueError("folding_step_bb72: the reference is the "
                             "BabyBear D = 72 model only")
        self.device = device
        n, L = int(config["n_rows"]), int(config["wit_len"])
        self.base, self.k = int(config["base"]), int(config["k"])
        M = L * self.k
        self.bound_sq = int(config["l2_bound_sq"])
        self.units = W = int(traffic["batch"])
        P, C = int(traffic["pool"]), int(traffic["challenges"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ref = ref = Cyclotomic72(device)

        def ntt(coeff):
            return ref.crt(bb.from_signed(coeff)).to(torch.int32)

        self.at = _uniform_words(gen, (D, n, M), device)
        self.s = ntt(witnesses(gen, traffic["witness_classes"], (D, W, L),
                               device))
        self.c = _uniform_words(gen, (D, W, n), device)
        self.s1 = torch.stack([
            ntt(_fold24._uniform(gen, -1, 1, (D, W, L), device))
            for _ in range(P)])
        self.c1 = _uniform_words(gen, (P, D, W, n), device)
        self.r = challenges(gen, C, device)
        if program == "program":
            from stark_rings_tpu_torch import get_ring
            from stark_rings_tpu_torch.protocol.folding import FoldingStep

            fs = FoldingStep(get_ring(config["model"], device=device), n, L,
                             base=self.base, k=self.k,
                             l2_bound_sq=self.bound_sq, psi_check=True)
            tables = {"Agt": self.at}

            def step(s0, s1, c0, c1, r):
                return fs.step(tables, s0, s1, c0, c1,
                               fs.precompute_challenge(r))
            self._step = step
        elif program == "control":
            def step(s0, s1, c0, c1, r):
                return self._reference_step(s0, s1, c0, c1, r, True)
            self._step = step
        else:
            raise ValueError(f"unknown program {program!r}")

    def _reference_step(self, s0, s1, c0, c1, r, truncated=False):
        return fold_step(self.ref, self.at, s0, s1, c0, c1, r,
                         self.base, self.k, self.bound_sq, truncated)
