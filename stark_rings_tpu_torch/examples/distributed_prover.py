#!/usr/bin/env python
"""Sharded prover arithmetic on a mesh of P shards (counterpart of
``examples/distributed_prover.py``).

Drives the three sharded pieces a lattice folding / sumcheck prover
needs, all on one mesh (P shards of one card by default):

    1. Witness fold and constraint product (batch sharded, no traffic
       between shards): s = s0 + r*s1 and u = s *ring* t through
       ``ShardedModelMul``, each shard running the model multiply (on
       the card: ``torch._int_mm`` and the fold kernel K3).
    2. Commitment mat-vec (column sharded, one exact word sum):
       c = A s through ``ShardedMatVec``.
    3. Product-claim sumcheck over tables sharded across the mesh
       (``ShardedMLE.make_sumcheck_fn``: each shard's rounds on its own
       table, K7 on the card, then the top rounds on the gathered
       finals), its challenges squeezed from a SHAKE-256 transcript
       seeded by the commitment bytes.  The challenges are squeezed up
       front, as the reference does; ``examples/sumcheck.py`` shows the
       round-interleaved transcript.

The verifier then checks the chain p_i(0) + p_i(1) = claim_i and the
final claim g(r) * h(r) in Python ints.

Run:  python -m stark_rings_tpu_torch.examples.distributed_prover
      [--P 8] [--device cpu]   (the CUDA card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..linalg import RingElems
from ..parallel import (ShardedMatVec, ShardedMLE, ShardedModelMul,
                        make_mesh)
from ..rings import get_ring
from ..rings.absorb import Transcript

__all__ = ["main"]


def main(device: str = "cuda", P: int = 8, seed: int = 2024) -> None:
    mesh = make_mesh(P, device=device)
    ring = get_ring("goldilocks", device=mesh.devices[0])
    f = ring.field
    rng = np.random.default_rng(seed)

    # -- 1. batch-sharded witness fold and constraint product ----------------
    B = 64                       # witness length, sharded P ways
    s0, s1, t = (ring.rand_coeff((B,), rng) for _ in range(3))
    r = f.rand((), rng, ring.device)
    s = ring.add(s0, ring.scalar_mul(r, s1))
    smm = ShardedModelMul(ring, mesh)
    u = smm.make_mul_fn()(smm.shard(s), smm.shard(t))
    print(f"witness fold + sharded ring product: {P} shards of "
          f"{list(u[0].shape)}")

    # -- 2. column-sharded Ajtai commitment -----------------------------------
    n_rows = 4
    A = ring.rand_coeff((n_rows, B), rng)
    smv = ShardedMatVec(RingElems(ring), mesh)
    c = smv.make_matvec_fn()(*smv.shard(ring.crt(A), ring.crt(s)))
    print(f"sharded commitment: {list(c.shape)}")

    # -- 3. sharded sumcheck with transcript-squeezed challenges -------------
    tr = Transcript(b"distributed-prover-demo")
    tr.absorb(b"commitment", f, c)
    nv = 12
    G, H = (f.rand((1 << nv,), rng, ring.device) for _ in range(2))
    sm = ShardedMLE(f, nv, mesh)
    Gs, Hs = sm.shard(G), sm.shard(H)
    claimed = sm.make_inner_product_fn()(Gs, Hs)
    tr.absorb(b"claim", f, claimed)
    chals = [tr.squeeze_field_elements(f, 1, ring.device)[0]
             for _ in range(nv)]
    msgs, gv, hv = sm.make_sumcheck_fn()(Gs, Hs, *chals)

    # the verifier's chain: p(0) + p(1) == the previous claim, and the
    # final claim equals g(r) * h(r)
    q = f.q
    msgs = f.decode(msgs)
    cur = int(f.decode(claimed))
    half = pow(2, q - 2, q)
    for i, ri in enumerate(int(x) for x in f.decode(torch.stack(chals))):
        p0, p1, p2 = (int(msgs[i, j]) for j in range(3))
        assert (p0 + p1) % q == cur, f"round {i}"
        # the degree-2 message at the challenge, by Lagrange
        c2 = (p2 - 2 * p1 + p0) * half % q
        c1 = (p1 - p0 - c2) % q
        cur = (p0 + c1 * ri + c2 * ri * ri) % q
    assert int(f.decode(gv)) * int(f.decode(hv)) % q == cur, "final claim"
    print(f"sharded sumcheck verified: {nv} rounds on {P} shards, claim "
          f"{int(f.decode(claimed))}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--P", type=int, default=8, help="shards")
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    main(args.device, args.P, args.seed)
