"""Sharded dense MLE operations over a mesh of shards (counterpart of
``stark_rings_tpu/parallel/mle.py``).

The evaluations [2^nv] are sharded in contiguous blocks, so the TOP
log2(P) variables are the shard index (little-endian: variable 0 is the
least significant index bit, mle/dense.rs:171-199).  Hence:

* fixing the first k <= nv - log2(P) variables pairs adjacent entries,
  which never cross a shard: it is local;
* an evaluation binds each shard's nv - log2(P) low variables locally,
  gathers the P scalars and folds the top log2(P) variables;
* sums and inner products over the hypercube are local widened-word
  sums and one :func:`~.collectives.psum_words`;
* the sumcheck's first nv - log2(P) rounds bind low variables: each
  shard proves its own table for the given challenges, and round i's
  message is the sum mod q of the shards' round-i messages; the last
  log2(P) rounds run on the gathered [P] tables of the shards' finals.

On CUDA shards the local parts run on the port's kernels: a Goldilocks
evaluation is one K5 launch a shard (``mle/fix.py``
``evaluate_goldilocks``; it binds the variables in another order, which
gives the same value because the multilinear extension is unique), and
over Goldilocks, BabyBear and frog a shard's local rounds are one K7
launch (``mle/sumcheck_kernel.py`` ``sumcheck_prove_many``) on its
bit-reversed table: K7 proves in msb order, and msb proving on
``bit_reverse_table(T)`` gives exactly T's lsb messages and finals.  On
CPU shards the same wrappers run their twins.  The fixes and the other
fields' evaluations are torch lerps; stark_prime's local rounds are the
generic lsb prover (its field products kernel S1 on the card), as
``sumcheck_prove_many`` keeps it.
"""

from __future__ import annotations

import torch

from ..mle.fix import evaluate_goldilocks
from ..mle.sumcheck import (bit_reverse_table,
                            sumcheck_prove_many_with_challenges)
from ..mle.sumcheck_kernel import SUMCHECK_FIELDS, sumcheck_prove_many
from .collectives import psum_words
from .mesh import check_shards, gather, shard

__all__ = ["ShardedMLE"]


class ShardedMLE:
    """Sharded dense-MLE functions of ``num_vars`` variables over one
    field on ``mesh``.  Tables are P shards ``[2^nv / P (, L)]``
    (:meth:`shard`); points and challenges are storage tensors (0-d, or
    [8] for stark_prime), one an argument; a replicated result is one
    tensor on the mesh's first device."""

    def __init__(self, field, num_vars: int, mesh, axis: str = "x"):
        self.f = field
        self.nv = int(num_vars)
        self.mesh = mesh
        self.axis = axis
        self.P = mesh.size
        if self.P & (self.P - 1) or (1 << self.nv) % self.P:
            raise ValueError(f"P={self.P} shards must be a power of two "
                             f"dividing 2^{self.nv}")
        self.logP = self.P.bit_length() - 1
        self.n_local = self.nv - self.logP

    def spec(self):
        """Per axis of ``[2^nv(, L)]``: the mesh axis it is split over."""
        return (self.axis,) + (None,) * len(self.f.limb_shape)

    def shard(self, x, mesh=None):
        """``[2^nv(, L)]`` (numpy storage or a tensor) -> P shards."""
        return shard(x, mesh or self.mesh, 0, self.f)

    def gather(self, shards, device=None):
        return gather(shards, 0, device)

    # -- local bodies -----------------------------------------------------
    def _tables(self, shards, what):
        shards = check_shards(self.mesh, shards, self.f.dtype, what)
        want = (1 << self.n_local,) + self.f.limb_shape
        if any(tuple(s.shape) != want for s in shards):
            raise ValueError(f"{what}: shards must be {list(want)}")
        return shards

    def _points(self, points, n, what):
        if len(points) != n:
            raise ValueError(f"{what}: expected {n} points, got "
                             f"{len(points)}")
        return list(points)

    def _on_devices(self, points):
        """The points stacked once on each shard device: {device: [n(, L)]
        tensor}, or {device: []} for no point."""
        out = {}
        for d in self.mesh.devices:
            if d not in out:
                out[d] = torch.stack([r.to(d) for r in points]) \
                    if points else []
        return out

    def _fold(self, ev, points):
        """Bind the first len(points) variables: adjacent-pair lerps."""
        f = self.f
        for r in points:
            ev = f.add(ev[0::2], f.mul(r, f.sub(ev[1::2], ev[0::2])))
        return ev

    def _local_eval(self, ev, points):
        if self.f.name == "goldilocks" and len(points):
            return evaluate_goldilocks(ev, points)
        return self._fold(ev, points)[0]

    def _top(self, scalars):
        """The shards' scalars as one [P(, L)] table on the first device
        (shard s holds the assignment s of the top variables)."""
        dev = self.mesh.devices[0]
        return torch.stack([s.to(dev) for s in scalars])

    def _exact_sum(self, xs):
        """Sum mod q of every entry of the shards ``xs``."""
        f = self.f
        words = []
        for x in xs:
            w = f.widen(x)
            words.append(w.reshape(-1, w.shape[-1]).sum(dim=0))
        return f.reduce_words(psum_words(words))

    # -- the sharded functions ---------------------------------------------
    def make_fix_fn(self, k: int):
        """Fix the first k variables (k <= nv - log2 P): local; the
        result keeps the sharding."""
        if not 0 <= k <= self.n_local:
            raise ValueError(f"fix of {k} variables: at most nv - log2 P = "
                             f"{self.n_local}")

        def call(evals, *points):
            evals = self._tables(evals, "evals")
            pts = self._on_devices(self._points(points, k, "fix"))
            return [self._fold(x, pts[x.device]) for x in evals]
        return call

    def make_eval_fn(self):
        """Full evaluation at nv points: the local evaluation of each
        shard (K5 for Goldilocks), a gather and the top fold."""
        def call(evals, *points):
            evals = self._tables(evals, "evals")
            pts = self._points(points, self.nv, "eval")
            low = self._on_devices(pts[:self.n_local])
            top = [r.to(self.mesh.devices[0]) for r in pts[self.n_local:]]
            return self._fold(self._top([self._local_eval(x, low[x.device])
                                         for x in evals]), top)[0]
        return call

    def make_hypercube_sum_fn(self):
        """Sum over {0,1}^nv: local widened sums, psum_words, one fold."""
        def call(evals):
            return self._exact_sum(self._tables(evals, "evals"))
        return call

    def make_inner_product_fn(self):
        """<a, b> over the hypercube: local products and widened sums,
        psum_words, one fold."""
        def call(a, b):
            a, b = self._tables(a, "a"), self._tables(b, "b")
            return self._exact_sum([self.f.mul(x, y) for x, y in zip(a, b)])
        return call

    def _prove_local(self, tables, chal):
        """One shard's lsb rounds for the stacked challenges ``chal``:
        (msgs [n, k+1(, L)], k finals)."""
        f = self.f
        if f.name in SUMCHECK_FIELDS:
            return sumcheck_prove_many([bit_reverse_table(T) for T in tables],
                                       chal, f.name)
        return sumcheck_prove_many_with_challenges(f, tables, chal,
                                                   order="lsb")

    def _prove(self, shard_tables, challenges):
        f, nl = self.f, self.n_local
        pts = self._points(challenges, self.nv, "sumcheck")
        dev = self.mesh.devices[0]
        low = self._on_devices(pts[:nl])
        msgs, finals = None, []
        for tabs in zip(*shard_tables):
            m, fin = self._prove_local(list(tabs), low[tabs[0].device])
            m = m.to(dev)
            msgs = m if msgs is None else f.add(msgs, m)
            finals.append(fin)
        top = [self._top(col) for col in zip(*finals)]
        m_top, fin = sumcheck_prove_many_with_challenges(
            f, top, [r.to(dev) for r in pts[nl:]], order="lsb")
        return torch.cat([msgs, m_top]), fin

    def make_sumcheck_fn(self):
        """Product-claim sumcheck prover arithmetic for challenges given up
        front: (G shards, H shards, *challenges) -> (msgs [nv, 3],
        g(r), h(r)), equal to ``sumcheck_prove_with_challenges`` on the
        whole tables (lsb order)."""
        def call(G, H, *challenges):
            msgs, fin = self._prove([self._tables(G, "G"),
                                     self._tables(H, "H")], challenges)
            return msgs, fin[0], fin[1]
        return call

    def make_sumcheck_many_fn(self, k: int):
        """k-ary product sumcheck (degree-k rounds): (k table shard lists,
        *challenges) -> (msgs [nv, k+1], k finals), equal to
        ``sumcheck_prove_many_with_challenges`` on the whole tables."""
        if k < 1:
            raise ValueError(f"k = {k} tables: need at least one")

        def call(*args):
            if len(args) != k + self.nv:
                raise ValueError(f"expected {k} tables and {self.nv} "
                                 f"challenges, got {len(args)} operands")
            tables = [self._tables(T, f"table {j}")
                      for j, T in enumerate(args[:k])]
            return self._prove(tables, args[k:])
        return call
