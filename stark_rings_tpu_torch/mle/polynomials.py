"""HyperPlonk-derived multilinear helpers (counterpart of
``stark_rings_tpu/mle/polynomials.py``; reference
polynomials/multilinear_polynomial.rs:19-286).

``rng`` is a numpy Generator for the random tables; the permutation
helpers only call ``rng.shuffle`` on a list.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense import DenseMLE
from .util import get_batched_nv

__all__ = [
    "random_mle_list", "random_zero_mle_list",
    "identity_permutation", "identity_permutation_mles",
    "random_permutation", "random_permutation_mles",
    "evaluate_opt", "fix_variables", "fix_last_variables",
    "merge_polynomials",
]


def random_mle_list(elems, nv, degree, rng):
    """(list of random MLEs, sum over the hypercube of their product)
    (multilinear_polynomial.rs:19-49): a k-ary product claim."""
    mles = [DenseMLE.rand(elems, nv, rng) for _ in range(degree)]
    prod = None
    for m in mles:
        prod = m.evals if prod is None else elems.mul(prod, m.evals)
    total = elems.f.sum(prod, 0) if degree else None
    return mles, total


def random_zero_mle_list(elems, nv, degree, rng):
    """degree MLEs whose pointwise product is zero (the first is all
    zero, multilinear_polynomial.rs:52-77)."""
    zero = DenseMLE(elems, nv, elems.zeros((1 << nv,)))
    rest = [DenseMLE.rand(elems, nv, rng) for _ in range(degree - 1)]
    return [zero] + rest


def identity_permutation(elems, num_vars, num_chunks):
    """[0, 1, ..., num_chunks*2^nv) as elements (mp.rs:79-82)."""
    n = num_chunks << num_vars
    return elems.f.from_uint(np.arange(n, dtype=np.uint64), elems.device)


def identity_permutation_mles(elems, num_vars, num_chunks):
    """(mp.rs:85-98)."""
    vals = identity_permutation(elems, num_vars, num_chunks)
    n = 1 << num_vars
    return [DenseMLE(elems, num_vars, vals[i * n:(i + 1) * n])
            for i in range(num_chunks)]


def random_permutation(elems, num_vars, num_chunks, rng):
    """Random permutation of the identity vector (mp.rs:100-113)."""
    n = num_chunks << num_vars
    perm = list(range(n))
    rng.shuffle(perm)
    return elems.f.from_uint(np.array(perm, dtype=np.uint64), elems.device)


def random_permutation_mles(elems, num_vars, num_chunks, rng):
    """(mp.rs:116-133)."""
    vals = random_permutation(elems, num_vars, num_chunks, rng)
    n = 1 << num_vars
    return [DenseMLE(elems, num_vars, vals[i * n:(i + 1) * n])
            for i in range(num_chunks)]


def fix_variables(mle: DenseMLE, points):
    """(mp.rs:140-174): the same as DenseMLE.fix_variables."""
    return mle.fix_variables(points)


def evaluate_opt(mle: DenseMLE, points):
    return mle.evaluate(points)


def fix_last_variables(mle: DenseMLE, points):
    """(mp.rs:251-268)."""
    return mle.fix_last_variables(points)


def merge_polynomials(polys):
    """Concatenate MLE evaluation tables and zero-pad to the batched nv
    (mp.rs:204-225)."""
    nv = polys[0].num_vars
    for p in polys:
        if p.num_vars != nv:
            raise ValueError("num_vars do not match for polynomials")
    e = polys[0].e
    merged_nv = get_batched_nv(nv, len(polys))
    evals = torch.cat([p.evals for p in polys], dim=0)
    total = 1 << merged_nv
    if evals.shape[0] < total:
        pad = e.zeros((total - evals.shape[0],)).to(evals.device)
        evals = torch.cat([evals, pad], dim=0)
    return DenseMLE(e, merged_nv, evals)
