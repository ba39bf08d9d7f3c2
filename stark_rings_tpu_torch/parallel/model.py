"""Data-parallel model-ring multiplies over a mesh of shards
(counterpart of ``stark_rings_tpu/parallel/model.py``).

The batch axis of the element vectors is sharded: each shard runs the
batch-trailing multiply (:class:`~..ops.model_mul.TModelMul`: CRT, slot
product, ICRT) on its own block, with no traffic between shards.  On
the card each shard's CRT and ICRT is one ``torch._int_mm`` and one
fold kernel: K3 (``fold_end``) for goldilocks, ``bb_fold_end`` for
babybear, S3 (``limb_fold``) for stark_prime; frog folds in torch ops.
Each shard device has its own ring tables (one set for P shards of one
card).
"""

from __future__ import annotations

from ..ops.model_mul import TModelMul
from .mesh import check_shards, gather, replicate, ring_on, shard

__all__ = ["ShardedModelMul"]


class ShardedModelMul:
    """Batch-sharded multiply of one ring model.

    Element vectors are batch-leading storage ``[B, D(, L)]``, given as P
    shards ``[B/P, D(, L)]`` (:meth:`shard`); each result equals
    ``ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))`` elementwise and
    keeps its operands' sharding."""

    def __init__(self, ring, mesh, axis: str = "x"):
        self.ring = ring
        self.mesh = mesh
        self.axis = axis
        self.tm = TModelMul(ring)
        self._tms = {}

    def spec(self):
        """Per axis of ``[B, D(, L)]``: the mesh axis it is split over."""
        return (self.axis, None) + (None,) * len(self.ring.field.limb_shape)

    def shard(self, x, mesh=None):
        """``[B, D(, L)]`` (numpy storage or a tensor) -> P batch shards."""
        return shard(x, mesh or self.mesh, 0, self.ring.field)

    def gather(self, shards, device=None):
        return gather(shards, 0, device)

    def _tm_on(self, dev):
        if dev not in self._tms:
            ring = ring_on(self.ring, dev)
            self._tms[dev] = self.tm if ring is self.ring else TModelMul(ring)
        return self._tms[dev]

    def _sharded(self, local):
        mesh, dtype = self.mesh, self.ring.field.dtype

        def call(a, b):
            a = check_shards(mesh, a, dtype, "a")
            b = check_shards(mesh, b, dtype, "b")
            return [local(self._tm_on(x.device), x, y)
                    for x, y in zip(a, b)]
        return call

    def make_mul_fn(self):
        """``[B, D(, L)] x [B, D(, L)] -> [B, D(, L)]``, batch sharded."""
        return self._sharded(lambda tm, a, b: tm.from_t(
            tm.mul_t(tm.to_t(a), tm.to_t(b))))

    def make_ntt_mul_fn(self):
        """The slot-wise NTT-form product (the folding prover's hot
        loop), batch sharded."""
        return self._sharded(lambda tm, a, b: tm.from_t(
            tm.ntt_mul_t(tm.to_t(a), tm.to_t(b))))

    def make_challenge_mul_fn(self):
        """w -> c*w for ONE replicated element c ``[1, D(, L)]`` (one
        tensor): the folding challenge multiply, batch sharded.  c's CRT
        runs once per shard device and its slots broadcast over the
        local batch, so each element pays one CRT less than in the
        general multiply."""
        mesh, dtype = self.mesh, self.ring.field.dtype

        def call(a, ch):
            a = check_shards(mesh, a, dtype, "a")
            fcs = {}
            for dev, c in replicate(ch, mesh).items():
                tm = self._tm_on(dev)
                fcs[dev] = tm.precompute_t(tm.to_t(c))
            out = []
            for x in a:
                tm = self._tm_on(x.device)
                out.append(tm.from_t(tm.mul_cached_t(tm.to_t(x),
                                                     fcs[x.device])))
            return out
        return call
