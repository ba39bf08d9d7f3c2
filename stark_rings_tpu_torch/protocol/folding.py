"""One LatticeFold-style folding step (counterpart of
``stark_rings_tpu/protocol/folding.py``).

Composes, in the batch-trailing layout (``ops/model_mul.TModelMul``):

    1. challenge fold      s = s0 + r*s1,  c = c0 + r*c1
                           (slot-wise; r's NTT form precomputed once)
    2. ICRT                folded witness back to coefficient form
    3. gadget decompose    [W, L] elements -> [W, L*k] short digits
                           (balanced_decomposition/mod.rs:163-175)
    4. norm check          exact L2 of the digit tensor per witness on
                           the device (decomp.norms.l2_check)
    5. CRT                 digits to NTT form
    6. Ajtai commit        cd = A_g @ digits over the ring
                           (matrix.rs:148-188)
    7. (optional) psi range check per digit coefficient
                           (monomial.rs:82-93), complete for power-of-two
                           cyclotomics

On the card each ICRT and CRT is one ``torch._int_mm`` and one fold
kernel: K3 (``fold_end``) for goldilocks, K4's ``bb_fold_end`` for
babybear, S3 (``limb_fold``) for stark_prime; frog folds in torch ops.
A step runs one ICRT and one CRT; the challenge's precompute one more
CRT.  Over goldilocks the challenge's two slot products and the commit
are the kernels of ``ops/slot.py`` on the card (two ``slot_mul``, one
``slot_matvec``), over babybear those of ``ops/slot_bb.py``.  Over both
fields decompose, the L2 sums and psi's checks are one kernel on the
card (``ops/digits.py``: ``step_digits``, ``bb_step_digits``), under the
``fold.decompose`` span; ``fold.l2`` and ``fold.psi`` then hold [W]
compares.  Every other stage is torch ops on the ring's device,
and over stark_prime every field product, add and subtract is kernel S1
or S2 (its limb axis trails every tensor: [D, W, L, 8]).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops.digits import check_psi, step_digits
from ..ops.model_mul import TModelMul
from ..spec.decomp import decomposition_max_length
from ..utils.trace import trace_span

__all__ = ["FoldingStep", "ntt_matvec"]


def ntt_matvec(f, tm, E, At, xt, block: int | None = None):
    """c[i] = sum_j A[i, j] * x[j] over NTT-form ring elements in the
    transposed layout: ``At [D, n, m(, L)]``, ``xt [D, W, m(, L)]`` ->
    [D, W, n(, L)] (matrix.rs:148-188 semantics; the limb axis trails for
    stark_prime).

    ``block``: m-blocked widened-word accumulation (the Matrix.mul_mat
    pattern) bounding the live product tensor; bit-equal to the
    unblocked contraction.  At E == 1 each block's products lie in a
    ``model.slot_product`` span and its widened sum, and the final fold
    mod q, in ``model.commit_acc`` (the spans of ``ops/slot.py``
    ``ext_matvec``, the E > 1 path)."""
    if E > 1:
        return tm.matvec_t(At, xt, block=block)   # block >= m: unblocked
    # slot field == base field: the slot product is the field's product
    m = At.shape[2]
    if block is None or block >= m:
        with trace_span("model.slot_product"):
            prod = f.mul(At[:, None], xt[:, :, None])
        return f.sum(prod, axis=3)
    acc = None
    for s in range(0, m, block):
        with trace_span("model.slot_product"):
            prod = f.mul(At[:, None, :, s:s + block],
                         xt[:, :, None, s:s + block])
        with trace_span("model.commit_acc"):
            w = f.widen(prod).sum(dim=3)
            acc = w if acc is None else acc + w
    with trace_span("model.commit_acc"):
        return f.reduce_words(acc)


class FoldingStep:
    """Composed folding step over a ring model.

    Parameters
    ----------
    ring : RingModel
    n_rows : commitment rows (Ajtai security parameter)
    wit_len : witness length L (ring elements per witness)
    base, k : gadget decomposition basis / digit count
               (k defaults to decomposition_max_length(q, base))
    l2_bound_sq : witness-norm bound beta^2 of the device check;
               defaults to the gadget guarantee L*k*D*(base/2)^2
               (digits are balanced, so |d| <= base/2 always holds; a
               protocol passes its real beta^2)
    psi_check : include the per-coefficient monomial range check

    Tables and witnesses live on the ring's device.
    """

    def __init__(self, ring, n_rows: int, wit_len: int, base: int = 256,
                 k: int | None = None, l2_bound_sq: int | None = None,
                 psi_check: bool = False):
        self.ring = ring
        self.f = ring.field
        self.tm = TModelMul(ring)
        self.n = int(n_rows)
        self.L = int(wit_len)
        self.base = int(base)
        kmax = decomposition_max_length(ring.q, base)
        if k is None:
            k = kmax
        # the step decomposes a FOLDED witness (full field range): a k
        # below the field's max digit count would drop its high digits
        assert k >= kmax, (
            f"k={k} < decomposition_max_length(q, {base})={kmax} would"
            " silently truncate the folded witness's digits")
        self.k = int(k)
        self.M = self.L * self.k
        if l2_bound_sq is None:
            l2_bound_sq = self.M * ring.D * (base // 2) ** 2
        self.l2_bound_sq = int(l2_bound_sq)
        self.psi_check = bool(psi_check)

    # -- setup ------------------------------------------------------------
    def init_tables(self, rng: np.random.Generator):
        """Random Ajtai matrix A_g [n, M] of NTT-form ring elements in the
        transposed layout [D, n, M], on the ring's device.  The CRT/ICRT
        run on the ring's own digit tables; a ``tm`` entry (device tables
        from ``ops.mxu2.from_jax_consts``, e.g. of the reference's
        ``consts()``) takes their place."""
        A = self.ring.rand_ntt((self.n, self.M), rng)
        return {"Agt": self.tm.to_t(A).contiguous()}

    def precompute_challenge(self, r):
        """NTT form of the folding challenge: coefficient-form storage
        [D(, L)] in, transposed NTT form [D, 1, 1(, L)] out; computed once
        per challenge and broadcast over the witness batch in every
        step."""
        with trace_span("fold.precompute"):
            ntt = self.tm.crt_t(self.tm.to_t(r)[:, None])
            return ntt[:, :, None]

    def rand_witness(self, W: int, rng: np.random.Generator):
        """NTT-form witness batch [D, W, L(, limbs)] (transposed)."""
        return self.tm.to_t(self.ring.rand_ntt((W, self.L), rng)).contiguous()

    #: storage words of one [N, E, E, block, W, n(, L)] slot-product
    #: tensor (the E-wide intermediate of ``TModelMul.matvec_t``, E times
    #: the reference's [D, W, n, M]; stark_prime's L = 8 limbs counted,
    #: which the reference's budget leaves out) tolerated before the
    #: commit blocks its contraction: 2^27 words, 1 GiB of int64.  A u64
    #: field product keeps several such tensors live: the bench shape
    #: (goldilocks n = 8, M = 8,192, W = 16: 75,497,472 words) stays on
    #: the unblocked path, as the reference keeps it; babybear's E = 9
    #: blocks there.  On the card the goldilocks commit is one
    #: ``slot_matvec`` launch (``ops/slot.py``) and the babybear commit one
    #: ``bb_slot_matvec`` launch (``ops/slot_bb.py``): neither builds such
    #: a tensor, both ignore the block, and no ``model.commit_acc`` span
    #: runs there.  The budget binds the other models, and every model on
    #: CPU tensors.
    _COMMIT_BUDGET_WORDS = 1 << 27

    def commit_block(self, W: int) -> int:
        """The contraction block the commit of W witnesses takes by
        default (M or more: unblocked)."""
        limbs = int(np.prod(self.f.limb_shape, dtype=np.int64))
        per = max(1, self.ring.D * self.ring.E * W * self.n * limbs)
        return max(1, self._COMMIT_BUDGET_WORDS // per)

    def commit(self, c, dt, block: int | None = None):
        """cd = A_g @ digits (NTT form, transposed): [D, W, M(, L)] ->
        [D, W, n(, L)].

        Peak memory is bounded: when the slot-product tensor would pass
        ``_COMMIT_BUDGET_WORDS`` words, the contraction runs M-blocked
        with exact widened-word accumulation (bit-equal)."""
        if block is None:
            block = self.commit_block(dt.shape[1])
        return ntt_matvec(self.f, self.tm, self.ring.E, c["Agt"], dt, block)

    # -- the composed step --------------------------------------------------
    def step(self, c, s0t, s1t, c0t, c1t, rt):
        """One folding step.

        Inputs (transposed layout): witnesses s0t/s1t [D, W, L],
        commitments c0t/c1t [D, W, n], the challenge rt from
        :meth:`precompute_challenge`.  Returns a dict with the folded
        witness ``s`` and commitment ``c``, the digit tensor ``digits``
        [D, W, M] and its commitment ``cd``, and the check bits ``ok_l2``
        (and ``ok_psi``) [W]."""
        with trace_span("fold.step"):
            f, tm = self.f, self.tm
            tmc = c.get("tm")
            with trace_span("fold.challenge"):
                st = f.add(s0t, tm.ntt_mul_bt(s1t, rt))
                ct = f.add(c0t, tm.ntt_mul_bt(c1t, rt))
            coeff = tm.icrt_t(st, tmc)                   # [D, W, L]
            # decompose and L2 (and psi's counts): one kernel over
            # Goldilocks and BabyBear on the card, torch ops otherwise
            dt, ok_l2, psi_fails = step_digits(
                self.ring, coeff, self.base, self.k, self.l2_bound_sq,
                self.psi_check)
            d_ntt = tm.crt_t(dt, tmc)
            with trace_span("fold.commit"):
                cd = self.commit(c, d_ntt)
            out = {"s": st, "c": ct, "digits": dt, "cd": cd, "ok_l2": ok_l2}
            if self.psi_check:
                with trace_span("fold.psi"):
                    # per coefficient of the digit tensor; all of (D, M) a
                    # witness
                    out["ok_psi"] = check_psi(self.ring, dt, psi_fails)
            return out

    # -- multi-device -------------------------------------------------------
    def on_device(self, device) -> "FoldingStep":
        """This step, or the same step over the ring model's tables on
        ``device``."""
        from ..parallel.mesh import ring_on

        ring = ring_on(self.ring, device)
        if ring is self.ring:
            return self
        other = copy.copy(self)
        other.ring, other.f, other.tm = ring, ring.field, TModelMul(ring)
        return other

    def make_sharded_step_fn(self, mesh, axis: str = "x"):
        """The witness-sharded step over ``mesh``: (c, s0t, s1t, c0t,
        c1t, rt) -> the step's dict, every entry a list of P shards.

        The witnesses and commitments are shard lists along the witness
        axis W (axis 1 of ``[D, W, ...]``: shard p ``[D, W_p, ...]``,
        ``shard(x, mesh, 1)``); the tables ``c`` and the challenge
        ``rt`` are replicated (one copy a shard device).  Every stage is
        elementwise over W or a per-witness reduction, so each shard
        runs :meth:`step` on its own block with no traffic between
        shards (rayon over witnesses, SURVEY section 2.5, across
        shards).  ``s``, ``c``, ``digits`` and ``cd`` come back sharded
        on axis 1, ``ok_l2`` and ``ok_psi`` on axis 0."""
        from ..parallel.mesh import check_shards, replicate

        dtype = self.f.dtype

        def call(c, s0t, s1t, c0t, c1t, rt):
            ins = [check_shards(mesh, x, dtype, what) for x, what in
                   ((s0t, "s0t"), (s1t, "s1t"), (c0t, "c0t"), (c1t, "c1t"))]
            steps, tabs, rts = {}, {}, replicate(rt, mesh)
            for dev in rts:
                steps[dev] = self.on_device(dev)
                tabs[dev] = _tables_on(c, dev)
            outs = [steps[x[0].device].step(tabs[x[0].device], *x,
                                            rts[x[0].device])
                    for x in zip(*ins)]
            return {key: [o[key] for o in outs] for key in outs[0]}
        return call


def _tables_on(c, device):
    """The step's tables ``c`` (tensors, or dicts of them) on ``device``."""
    if isinstance(c, dict):
        return {k: _tables_on(v, device) for k, v in c.items()}
    return c.to(device) if isinstance(c, torch.Tensor) else c
