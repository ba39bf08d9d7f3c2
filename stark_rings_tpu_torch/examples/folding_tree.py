#!/usr/bin/env python
"""A multi-level folding tree with its verifier, driven through the
port's surface (counterpart of ``examples/folding_tree.py``).

2^t witnesses are committed (Ajtai, matrix.rs:148-188), then folded
pairwise down to ONE witness: each level runs the composed
``FoldingStep`` (challenge fold, ICRT, gadget decompose mod.rs:163-175,
exact L2, CRT, digit commitment, psi range check monomial.rs:79-93) with
a fresh SHAKE-256 transcript challenge, and the verifier re-checks every
level through independent paths (the linalg commitment oracle,
gadget recompose, the homomorphism).

Model: frog, a power-of-two cyclotomic (X^16 + 1), so the psi range
check is complete on the balanced digit window and PASSES at every
level (on goldilocks and babybear negative digits honestly fail it;
``FoldingTree`` turns psi off there).

Run:  python -m stark_rings_tpu_torch.examples.folding_tree
      [--device cpu]   (the CUDA card unless --device cpu)
"""

from __future__ import annotations

import argparse

import numpy as np

from ..protocol import FoldingTree
from ..rings import get_ring
from ..rings.absorb import Transcript

__all__ = ["main"]


def main(device: str = "cuda", seed: int = 17) -> None:
    ring = get_ring("frog", device=device)
    rng = np.random.default_rng(seed)
    t, n, L = 2, 2, 3                       # 4 witnesses, tiny shapes
    W = 1 << t
    ft = FoldingTree(ring, n_rows=n, wit_len=L, base=8)
    assert ft.fs.psi_check, "frog is negacyclic: the psi check is live"

    c = ft.init_tables(rng)
    wt = ft.rand_witnesses(W, rng)
    ct = ft.commit_witnesses(c, wt)
    print(f"leaves: {W} witnesses of {L} ring elements, committed to {n} "
          f"rows, on {ring.device}")

    # Fiat-Shamir: absorb the leaf commitments, squeeze one challenge a
    # level (the verifier derives the same transcript)
    tr = Transcript(b"stark-rings-tpu/folding-tree")
    tr.absorb(b"leaf-commitments", ring.field, ct)
    rs = []
    for lvl in range(t):
        tr.absorb_bytes(b"level", bytes([lvl]))
        rs.append(tr.squeeze_ring_element(ring))
    rts = ft.precompute_challenges(rs)

    levels, root_w, root_c = ft.prove(c, wt, ct, rts)
    print(f"tree: {t} levels, root witness shape {tuple(root_w.shape)}")
    for lvl, out in enumerate(levels):
        print(f"  level {lvl}: {out['s'].shape[1]} folded witnesses, "
              f"ok_l2={out['ok_l2'].tolist()}, "
              f"ok_psi={out['ok_psi'].tolist()}")

    assert ft.verify(c, wt, ct, levels, rts), "verifier rejected"
    print("verifier: ACCEPT (commitment oracle, digit recompose, "
          "homomorphism, L2 + psi at every level)")

    # tamper: one digit commitment word off by one -> reject
    bad = [dict(o) for o in levels]
    cd = bad[1]["cd"].clone()
    cd.view(-1)[0] = ring.field.add(cd.view(-1)[:1],
                                    ring.field.const(1, cd.device))[0]
    bad[1]["cd"] = cd
    assert not ft.verify(c, wt, ct, bad, rts), "tamper undetected"
    print("verifier: REJECT on a tampered digit commitment")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    main(args.device, args.seed)
