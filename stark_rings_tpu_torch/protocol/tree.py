"""Multi-level folding tree: 2^t witnesses folded pairwise to one
(counterpart of ``stark_rings_tpu/protocol/tree.py``).

Chains the composed :class:`~.folding.FoldingStep` (challenge fold,
ICRT, gadget decompose mod.rs:163-175, exact L2, CRT, Ajtai digit
commitment matrix.rs:148-188, psi range check monomial.rs:79-93) over a
binary tree of witnesses.  Each level folds witness pairs (2i, 2i+1)
with one fresh challenge and emits the step's outputs;
:meth:`FoldingTree.verify` re-checks every level through independent
paths (batch-leading ``Matrix.mul_vec`` for the commitments,
``gadget_recompose`` for the digits, the device L2 and psi bits) plus
the commitment homomorphism that links the levels.
"""

from __future__ import annotations

import numpy as np
import torch

from .folding import FoldingStep, ntt_matvec

__all__ = ["FoldingTree"]


def _is_negacyclic(ring) -> bool:
    """True iff X^D == -1 in the ring (power-of-two cyclotomic)."""
    xd = ring.spec.reduce([0] * ring.D + [1] + [0] * (ring.D - 2))
    want = [(ring.q - 1) % ring.q] + [0] * (ring.D - 1)
    return list(xd) == want


class FoldingTree:
    """Pairwise folding of a power-of-two witness batch down to one.

    Parameters mirror :class:`FoldingStep`; ``base`` defaults to 8 so
    balanced digits (|d| <= 4) sit inside every model's monomial range
    (-D/2, D/2).  ``psi_check=None`` turns the range check on exactly for
    power-of-two cyclotomics (X^D = -1), where ct(psi * exp(a)) == a holds
    on the whole (-d', d') window, negatives included (the reference's
    completeness domain, monomial.rs:120-134); on goldilocks and babybear
    negative digits honestly fail it, so verify would reject an honest
    prover there."""

    def __init__(self, ring, n_rows: int, wit_len: int, base: int = 8,
                 k: int | None = None, l2_bound_sq: int | None = None,
                 psi_check: bool | None = None):
        if psi_check is None:
            psi_check = _is_negacyclic(ring)
        self.fs = FoldingStep(ring, n_rows, wit_len, base=base, k=k,
                              l2_bound_sq=l2_bound_sq,
                              psi_check=psi_check)
        self.ring, self.f, self.tm = ring, ring.field, self.fs.tm
        self.n, self.L, self.M = self.fs.n, self.fs.L, self.fs.M

    # -- setup ------------------------------------------------------------
    def init_tables(self, rng: np.random.Generator):
        """The step's tables and the witness commitment matrix A_w [n, L]
        (the leaves' commitment scheme; digit commitments use the step's
        A_g [n, M]), transposed to [D, n, L]."""
        c = self.fs.init_tables(rng)
        Aw = self.ring.rand_ntt((self.n, self.L), rng)
        c["Awt"] = self.tm.to_t(Aw).contiguous()
        return c

    def commit_witnesses(self, c, wt, block: int | None = None):
        """cw = A_w @ w per witness: [D, W, L] -> [D, W, n]."""
        return ntt_matvec(self.f, self.tm, self.ring.E, c["Awt"], wt, block)

    def rand_witnesses(self, W: int, rng: np.random.Generator):
        return self.fs.rand_witness(W, rng)

    def precompute_challenges(self, rs):
        """One folding challenge per level (coefficient-form storage in)."""
        return [self.fs.precompute_challenge(r) for r in rs]

    # -- the composed prover ----------------------------------------------
    def prove(self, c, wt, ct, rts):
        """Fold W = 2^len(rts) witnesses to one.

        ``wt [D, W, L]`` NTT-form witnesses, ``ct [D, W, n]`` their
        commitments, ``rts`` the per-level challenges from
        :meth:`precompute_challenges`.  Returns (levels, wt, ct): each
        level's step outputs and the root witness and commitment
        [D, 1, ...]."""
        levels = []
        for rt in rts:
            out = self.fs.step(c, wt[:, 0::2], wt[:, 1::2],
                               ct[:, 0::2], ct[:, 1::2], rt)
            levels.append(out)
            wt, ct = out["s"], out["c"]
        return levels, wt, ct

    def prove_sharded(self, mesh, c, wt, ct, rts, axis: str = "x"):
        """The witness-sharded tree over ``mesh``: a level whose PAIR count
        P divides runs :meth:`FoldingStep.make_sharded_step_fn` (no
        traffic between shards), the smaller levels near the root the
        step on the mesh's first device.  ``wt`` and ``ct`` are whole
        tensors, or shard lists along the witness axis (axis 1).

        Witnesses shard in contiguous blocks of an even count, so every
        pair (2i, 2i+1) lies in one shard and a sharded level's outputs
        are the next level's shards as they stand.  Returns (levels, wt,
        ct) as :meth:`prove` does, each level's outputs gathered to
        whole tensors on the mesh's first device; bit-equal to
        :meth:`prove`."""
        from ..parallel.mesh import shard
        from .folding import _tables_on

        P, dev = mesh.size, mesh.devices[0]
        sfn = self.fs.make_sharded_step_fn(mesh, axis)
        local = self.fs.on_device(dev)

        def whole(shards, axis=1):
            return torch.cat([x.to(dev) for x in shards], dim=axis)

        sharded = isinstance(wt, (list, tuple))
        levels = []
        for rt in rts:
            W = sum(w.shape[1] for w in wt) if sharded else wt.shape[1]
            if (W // 2) % P == 0:
                if not sharded:
                    wt, ct = shard(wt, mesh, 1), shard(ct, mesh, 1)
                    sharded = True
                out = sfn(c, [w[:, 0::2] for w in wt],
                          [w[:, 1::2] for w in wt],
                          [x[:, 0::2] for x in ct],
                          [x[:, 1::2] for x in ct], rt)
                wt, ct = out["s"], out["c"]
                out = {k: whole(v, 0 if k.startswith("ok_") else 1)
                       for k, v in out.items()}
            else:
                if sharded:
                    wt, ct = whole(wt), whole(ct)
                    sharded = False
                out = local.step(_tables_on(c, dev), wt[:, 0::2], wt[:, 1::2],
                                 ct[:, 0::2], ct[:, 1::2], rt.to(dev))
                wt, ct = out["s"], out["c"]
            levels.append(out)
        if sharded:
            wt, ct = whole(wt), whole(ct)
        return levels, wt, ct

    # -- verifier ---------------------------------------------------------
    def verify(self, c, wt0, ct0, levels, rts) -> bool:
        """Re-check every level through independent paths:

        1. the device L2 and psi bits are all set;
        2. the digit commitment cd equals A_g @ digits recomputed through
           the batch-leading Matrix.mul_vec;
        3. the digits gadget-recompose to icrt(folded witness);
        4. commitment homomorphism: the folded commitment equals
           A_w @ (folded witness), linking each level to the last;
        5. the level inputs chain: level i folds level i-1's outputs.
        """
        from ..decomp import gadget_recompose
        from ..linalg import Matrix, RingElems

        ring, f, tm = self.ring, self.f, self.tm
        e = RingElems(ring)
        Aw = Matrix(e, tm.from_t(c["Awt"]))
        Ag = Matrix(e, tm.from_t(c["Agt"]))
        wt, ct = wt0, ct0
        for out, rt in zip(levels, rts):
            st, cf = out["s"], out["c"]
            dt, cd = out["digits"], out["cd"]
            if not bool(out["ok_l2"].all()):
                return False
            if "ok_psi" in out and not bool(out["ok_psi"].all()):
                return False
            # the challenge fold recomputed from the level's INPUTS
            want_s = f.add(wt[:, 0::2], tm.ntt_mul_bt(wt[:, 1::2], rt))
            want_c = f.add(ct[:, 0::2], tm.ntt_mul_bt(ct[:, 1::2], rt))
            if not (torch.equal(want_s, st) and torch.equal(want_c, cf)):
                return False
            dig_lead = tm.from_t(dt)         # [W, M, D]
            cd_lead = tm.from_t(cd)          # [W, n, D]
            s_lead = tm.from_t(st)           # [W, L, D]
            cf_lead = tm.from_t(cf)          # [W, n, D]
            for w in range(st.shape[1]):
                # the digit commitment against the linalg oracle
                dn = ring.crt(dig_lead[w])
                if not torch.equal(cd_lead[w], Ag.mul_vec(dn)):
                    return False
                # the digits recompose to the folded coefficient witness
                rec = gadget_recompose(f, dig_lead[w], self.fs.base,
                                       self.fs.k)
                if not torch.equal(rec, ring.icrt(s_lead[w])):
                    return False
                # homomorphism: the folded commitment commits the folded
                # witness under A_w
                if not torch.equal(cf_lead[w], Aw.mul_vec(s_lead[w])):
                    return False
            wt, ct = st, cf
        return True
