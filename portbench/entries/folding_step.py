"""Entry: one LatticeFold-style folding step over the Goldilocks ring
F_q[X]/(X^24 - X^12 + 1): ``FoldingStep.precompute_challenge(r)`` of a
short challenge, then ``FoldingStep.step`` on W witnesses in the
batch-trailing NTT-form layout ([24, W, L] witnesses, [24, W, n]
commitments, the Ajtai matrix [24, n, M]).  The call ends when its
check bits ``ok_l2`` and ``ok_psi`` are on the host.

The traffic is what a folding prover sends: low-norm witnesses and
short challenges.  Each witness belongs to one of the mix's classes,
which set the range of its coefficients and may plant one coefficient
outside psi's range, so that in every call some witnesses pass the L2
check and some fail it, and likewise psi; the classes are dealt to the
witness slots by a permutation drawn from the seed.  ``s1`` is ternary
and a challenge a monomial +-X^a, whose product with a ternary element
has coefficients in [-2, 2], so that folding keeps each class inside
its range.

Chaining: a call's ``s0`` is the previous call's folded witness ``s``
and its ``c0`` the previous call's digit commitment ``cd``.  Call 2j
folds in ``r_j s1_j`` and call 2j+1 folds it out again with ``-r_j``,
so the witnesses keep their classes' ranges however long the window;
``s1`` and ``c1`` cycle through a pool and ``r`` through a list, all
made from the seed on the device in set-up.  The reference recomputes
a checked call's every output (``reference/cyclotomic24.py``).
"""

from __future__ import annotations

import torch

from portbench.harness import mismatches, uniform_words
from portbench.reference import goldilocks as gl
from portbench.reference.cyclotomic24 import D, Cyclotomic24, fold_step


def _words(x):
    """Small signed integers -> field storage."""
    return torch.where(x < 0, x + gl.Q_W, x)


def _uniform(gen, lo, hi, shape, device):
    """Integers uniform in [lo, hi] (tensors broadcast over ``shape``)."""
    u = torch.randint(0, 1 << 30, shape, generator=gen, dtype=torch.int64,
                      device=device)
    return lo + u % (hi - lo + 1)


def witnesses(gen, classes, shape, device):
    """Coefficient-form witnesses [D, W, L] (signed): witness w's
    coefficients uniform in its class's ``s0`` range, and where the class
    has ``planted``, one coefficient at a seeded place set to a value
    uniform in that range."""
    d, W, L = shape
    spec = [c for c in classes for _ in range(int(c["count"]))]
    if len(spec) != W:
        raise ValueError(f"folding_step: the witness classes count "
                         f"{len(spec)} witnesses, the batch is {W}")
    spec = [spec[i] for i in torch.randperm(W, generator=gen,
                                            device=device).tolist()]

    def col(key, i):
        return torch.tensor([c.get(key, [0, 0])[i] for c in spec],
                            dtype=torch.int64, device=device)

    x = _uniform(gen, col("s0", 0)[:, None], col("s0", 1)[:, None],
                 (d, W, L), device)
    where = torch.randint(0, d * L, (W,), generator=gen, dtype=torch.int64,
                          device=device)
    value = _uniform(gen, col("planted", 0), col("planted", 1), (W,), device)
    planted = torch.tensor(["planted" in c for c in spec], device=device)
    flat = x.permute(1, 0, 2).reshape(W, d * L)
    w = torch.arange(W, device=device)
    flat[w, where] = torch.where(planted, value, flat[w, where])
    return flat.reshape(W, d, L).permute(1, 0, 2).contiguous()


def challenges(gen, count, device):
    """[2, count, D] coefficient-form challenges, monomials +-X^a drawn
    from the seed; row 1 holds their negations."""
    places = torch.randint(0, D, (count, 1), generator=gen,
                           dtype=torch.int64, device=device)
    signs = 2 * torch.randint(0, 2, (count, 1), generator=gen,
                              dtype=torch.int64, device=device) - 1
    r = torch.zeros((count, D), dtype=torch.int64, device=device)
    r.scatter_(1, places, signs)
    return torch.stack([_words(r), _words(-r)])


class Entry:
    def __init__(self, config, traffic, seed, device, program):
        if config["model"] != "goldilocks" or int(config["D"]) != D:
            raise ValueError("folding_step: the reference is the Goldilocks "
                             "D = 24 model only")
        self.device = device
        n, L = int(config["n_rows"]), int(config["wit_len"])
        self.base, self.k = int(config["base"]), int(config["k"])
        M = L * self.k
        self.bound_sq = int(config["l2_bound_sq"])
        self.units = W = int(traffic["batch"])
        P, C = int(traffic["pool"]), int(traffic["challenges"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.ref = ref = Cyclotomic24(device)
        self.at = uniform_words(gen, (D, n, M), device)
        self.s = ref.crt(_words(witnesses(gen, traffic["witness_classes"],
                                          (D, W, L), device)))
        self.c = uniform_words(gen, (D, W, n), device)
        s1 = _uniform(gen, -1, 1, (D, P, W, L), device)
        self.s1 = ref.crt(_words(s1)).transpose(0, 1).contiguous()
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

    def next_inputs(self, index):
        j, back = divmod(index, 2)
        return {"s0": self.s, "c0": self.c, "pool": j % self.s1.shape[0],
                "r": (back, j % self.r.shape[1])}

    def _args(self, inputs):
        p = inputs["pool"]
        return (inputs["s0"], self.s1[p], inputs["c0"], self.c1[p],
                self.r[inputs["r"]])

    def call(self, inputs):
        return self._step(*self._args(inputs))

    def finish(self, outputs):
        outputs["ok_l2"].cpu()
        outputs["ok_psi"].cpu()

    def advance(self, outputs):
        self.s, self.c = outputs["s"], outputs["cd"]

    def release(self):
        self._step = None
        self.s = self.c = None

    def check(self, inputs, outputs):
        return mismatches(outputs, self._reference_step(*self._args(inputs)))
