"""Multilinear sumcheck prover arithmetic in plain tensor code
(counterpart of ``stark_rings_tpu/mle/sumcheck.py``).

For the product claim S = sum_x prod_i T_i(x), each round's message
p(0..k) and the table fold are batched field ops on the halved
evaluation tables.  The Fiat-Shamir transcript stays on the host
(:mod:`..rings.absorb`); the ``*_with_challenges`` provers run every
round for challenges given up front.  This is the generic prover: the
plain twin of the one-pass prover kernel K7 (:mod:`.sumcheck_kernel`).

Binding orders: ``"lsb"`` binds x_0 first (the reference's
``fix_variables`` convention); ``"msb"`` binds the top variable first
(contiguous halves).  msb-order proving on ``bit_reverse_table(T)``
gives exactly the lsb-order messages and finals for T.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["sumcheck_round", "sumcheck_fold",
           "sumcheck_prove_with_challenges", "sumcheck_round_many",
           "sumcheck_fold_many", "sumcheck_prove_many_with_challenges",
           "bit_reverse_table"]


def _halves(T, order):
    """The two cosets of the variable bound this round."""
    if order == "lsb":
        return T[0::2], T[1::2]
    if order != "msb":
        raise ValueError(f"order must be 'lsb' or 'msb', got {order!r}")
    h = T.shape[0] // 2
    return T[:h], T[h:]


@functools.lru_cache(maxsize=64)
def _bit_reversal(n: int, device: torch.device) -> torch.Tensor:
    """rev(i) for i < n = 2^nv, on ``device`` (built once per n and
    device: a sharded prover reverses every shard's tables)."""
    nv = n.bit_length() - 1
    i = torch.arange(n, device=device)
    rev = torch.zeros_like(i)
    for b in range(nv):
        rev |= ((i >> b) & 1) << (nv - 1 - b)
    return rev


def bit_reverse_table(T: torch.Tensor) -> torch.Tensor:
    """Little-endian bit-reversal permutation of a 2^nv table:
    out[rev(i)] = T[i].  Written as a gather, so any nv works."""
    n = T.shape[0]
    if n & (n - 1) or not n:
        raise ValueError(f"table length {n} is not a power of two")
    return T[_bit_reversal(n, T.device)]


def sumcheck_round(f, G, H, order: str = "lsb"):
    """One round's message for the product claim over tables G, H:
    returns (p0, p1, p2, G0, H0, dG, dH), p evaluated at t = 0, 1, 2,
    and what the fold needs."""
    G0, G1 = _halves(G, order)
    H0, H1 = _halves(H, order)
    dG, dH = f.sub(G1, G0), f.sub(H1, H0)
    p0 = f.sum(f.mul(G0, H0), axis=0)
    p1 = f.sum(f.mul(G1, H1), axis=0)
    p2 = f.sum(f.mul(f.add(G1, dG), f.add(H1, dH)), axis=0)
    return p0, p1, p2, G0, H0, dG, dH


def sumcheck_fold(f, r, G0, H0, dG, dH):
    """Bind the round variable to the challenge r: the halved tables."""
    return f.add(G0, f.mul(r, dG)), f.add(H0, f.mul(r, dH))


def sumcheck_prove_with_challenges(f, G, H, challenges, order: str = "lsb"):
    """Full prover for known challenges: (msgs [nv, 3], g(r), h(r)).
    With ``order="msb"`` challenge j binds variable nv-1-j."""
    msgs = []
    for r in challenges:
        p0, p1, p2, G0, H0, dG, dH = sumcheck_round(f, G, H, order)
        G, H = sumcheck_fold(f, r, G0, H0, dG, dH)
        msgs.append(torch.stack([p0, p1, p2]))
    return torch.stack(msgs), G[0], H[0]


# -- k-ary products (HyperPlonk shape) ------------------------------------


def sumcheck_round_many(f, tables, reduce=None, order: str = "lsb"):
    """One round for S = sum_x prod_i T_i(x): the degree-k message and
    the fold ingredients, (msgs [k+1], t0s, deltas).  ``reduce`` maps
    the product table to the message scalar (default: modular sum)."""
    if reduce is None:
        def reduce(x):
            return f.sum(x, axis=0)
    halves = [_halves(T, order) for T in tables]
    deltas = [f.sub(t1, t0) for t0, t1 in halves]

    def prod_sum(vals):
        acc = vals[0]
        for v in vals[1:]:
            acc = f.mul(acc, v)
        return reduce(acc)

    msgs = [prod_sum([t0 for t0, _ in halves]),
            prod_sum([t1 for _, t1 in halves])]
    cur = [t1 for _, t1 in halves]
    for _ in range(2, len(tables) + 1):
        cur = [f.add(c, d) for c, d in zip(cur, deltas)]
        msgs.append(prod_sum(cur))
    return msgs, [t0 for t0, _ in halves], deltas


def sumcheck_fold_many(f, r, t0s, deltas):
    return [f.add(t0, f.mul(r, d)) for t0, d in zip(t0s, deltas)]


def sumcheck_prove_many_with_challenges(f, tables, challenges,
                                        order: str = "lsb"):
    """k-ary product prover for known challenges: (msgs [nv, k+1],
    finals), the per-round messages p(0..k) and each table's fully bound
    value (a list of k scalars).  Axes after the first are carried
    along: tables [2^nv, W] prove W claims at once (msgs [nv, k+1, W]).
    With no challenge (nv = 0) the messages are an empty [0, k+1, ...]
    tensor and the finals the tables' single entries; the reference's
    ``jnp.stack`` of no rounds raises there."""
    msgs = []
    for r in challenges:
        round_msgs, t0s, deltas = sumcheck_round_many(f, tables,
                                                      order=order)
        tables = sumcheck_fold_many(f, r, t0s, deltas)
        msgs.append(torch.stack(round_msgs))
    if not msgs:
        return (tables[0].new_empty((0, len(tables) + 1)
                                    + tuple(tables[0].shape[1:])),
                [T[0] for T in tables])
    return torch.stack(msgs), [T[0] for T in tables]
