"""Random ring-element sampling: uniform, short, and short invertible
elements (counterpart of ``stark_rings_tpu/rings/sampling.py``).

The eprint 2017/523 design point of the reference's rings is that each
has a ~2^128-size set of short invertible elements; a folding-scheme
prover samples from it with:

* ``rand_uniform``: uniform coefficients (reference ``rand``);
* ``sample_short``: coefficients from the balanced range [-bound, bound];
* ``is_invertible``: every CRT slot nonzero (a unit iff no slot is 0);
* ``sample_short_invertible``: a rejection loop.

The samplers draw from a numpy ``Generator``, as the rest of the port
does; the reference draws from a ``random.Random``, so one seed gives
other draws in the two packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rand_uniform", "sample_short", "is_invertible",
           "sample_short_invertible"]


def rand_uniform(ring, shape, rng: np.random.Generator):
    return ring.rand_coeff(shape, rng)


def sample_short(ring, shape, rng: np.random.Generator, bound: int):
    """Coefficient-form elements [*shape, D] with coefficients drawn
    uniformly from [-bound, bound]."""
    draw = rng.integers(-bound, bound, size=tuple(shape) + (ring.D,),
                        endpoint=True)
    return ring.encode_coeffs(draw.astype(object) % ring.q)


def is_invertible(ring, x_coeff):
    """True where the element is a unit, i.e. every CRT slot is nonzero:
    coefficient form [..., D] -> bool [...] on the ring's device."""
    slots = ring.crt(x_coeff).reshape(x_coeff.shape[:-1]
                                      + (ring.N, ring.E))
    return ~(slots == 0).all(dim=-1).any(dim=-1)


def sample_short_invertible(ring, rng: np.random.Generator, bound: int,
                            max_tries: int = 256):
    """Rejection-sample one short invertible element [D]."""
    for _ in range(max_tries):
        x = sample_short(ring, (), rng, bound)
        if bool(is_invertible(ring, x)):
            return x
    raise RuntimeError("no short invertible element found "
                       f"(bound={bound}, tries={max_tries})")
