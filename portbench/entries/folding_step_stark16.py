"""Entry: one LatticeFold-style folding step over the stark_prime ring
F_q[X]/(X^16 + 1), q = 2^251 + 17 * 2^192 + 1: ``FoldingStep
.precompute_challenge(r)`` of a short challenge, then ``FoldingStep.step``
on W witnesses in the batch-trailing NTT-form layout ([16, W, L, 8]
witnesses, [16, W, n, 8] commitments, the Ajtai matrix [16, n, M, 8]),
all int32 storage of eight u32 Montgomery limbs.  The call ends when its
check bits ``ok_l2`` and ``ok_psi`` are on the host.

The traffic, the chaining and the witness classes are those of
``entries/folding_step.py`` (its generator deals the classes): call 2j
folds ``r_j s1_j`` in and call 2j+1 folds it out again with ``-r_j``;
``s1`` and ``c1`` cycle through a pool and ``r`` through a list, all
made from the seed on the device in set-up.  A challenge is a monomial
+-X^a, a in [0, 16); X^16 = -1, so its product with a ternary ``s1`` is
ternary and folding moves every coefficient by at most 1, keeping each
class in its range.  At D = 16 psi passes a digit exactly when it lies
in [-7, 7], so the mix plants its out-of-range values at 16 or more.
The Ajtai matrix and the words of ``c`` and ``c1`` are drawn as 16-bit
limbs on the device and reduced mod q.  The reference recomputes a
checked call's every output (``reference/cyclotomic16.py``).
"""

from __future__ import annotations

import torch

from portbench.harness import BENCH, load_module
from portbench.reference import stark as sk
from portbench.reference.cyclotomic16 import D, Cyclotomic16, fold_step

_fold24 = load_module(BENCH / "entries" / "folding_step.py")
witnesses = _fold24.witnesses


def uniform_words(gen, shape, device, chunk: int = 1 << 22):
    """Storage words [*shape, 8] of values uniform below 2^252 taken mod
    q (so every value of F_q occurs), made in chunks of ``chunk``
    elements."""
    n = 1
    for s in shape:
        n *= s
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        x = torch.randint(0, 1 << 16, (m, sk.N), generator=gen,
                          dtype=torch.int64, device=device)
        x[:, sk.N - 1] &= 0xFFF
        out[s:s + m] = sk.to_storage(sk.reduce(x, 16))
    return out.reshape(tuple(shape) + (8,))


def challenges(gen, count, device):
    """[2, count, D, 8] coefficient-form challenges (storage), monomials
    +-X^a drawn from the seed; row 1 holds their negations."""
    places = torch.randint(0, D, (count, 1), generator=gen,
                           dtype=torch.int64, device=device)
    signs = 2 * torch.randint(0, 2, (count, 1), generator=gen,
                              dtype=torch.int64, device=device) - 1
    r = torch.zeros((count, D), dtype=torch.int64, device=device)
    r.scatter_(1, places, signs)
    return torch.stack([sk.value_storage(sk.from_signed(r)),
                        sk.value_storage(sk.from_signed(-r))])


class Entry(_fold24.Entry):
    """The D = 24 entry's loop (inputs, call, finish, advance, check)
    over stark_prime inputs and the D = 16 reference."""

    def __init__(self, config, traffic, seed, device, program):
        if config["model"] != "stark_prime" or int(config["D"]) != D:
            raise ValueError("folding_step_stark16: the reference is the "
                             "stark_prime D = 16 model only")
        self.device = device
        n, L = int(config["n_rows"]), int(config["wit_len"])
        self.base, self.k = int(config["base"]), int(config["k"])
        M = L * self.k
        self.bound_sq = int(config["l2_bound_sq"])
        self.units = W = int(traffic["batch"])
        P, C = int(traffic["pool"]), int(traffic["challenges"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ref = ref = Cyclotomic16(device)
        self.at = uniform_words(gen, (D, n, M), device)
        self.s = ref.ntt_of_signed(
            witnesses(gen, traffic["witness_classes"], (D, W, L), device))
        self.c = uniform_words(gen, (D, W, n), device)
        self.s1 = torch.stack([
            ref.ntt_of_signed(_fold24._uniform(gen, -1, 1, (D, W, L), device))
            for _ in range(P)])
        self.c1 = uniform_words(gen, (P, D, W, n), device)
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
