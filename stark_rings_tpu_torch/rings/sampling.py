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
    coefficient form [..., D(, L)] -> bool [...] on the ring's device."""
    limb = ring.field.limb_shape
    batch = x_coeff.shape[:x_coeff.dim() - 1 - len(limb)]
    slots = ring.crt(x_coeff).reshape(batch + (ring.N, ring.E) + limb)
    zero = slots == 0
    for _ in range(1 + len(limb)):      # a slot is 0 when every coordinate is
        zero = zero.all(dim=-1)
    return ~zero.any(dim=-1)


def sample_short_invertible(ring, rng: np.random.Generator, bound: int,
                            max_tries: int = 256):
    """Rejection-sample one short invertible element [D]."""
    for _ in range(max_tries):
        x = sample_short(ring, (), rng, bound)
        if bool(is_invertible(ring, x)):
            return x
    raise RuntimeError("no short invertible element found "
                       f"(bound={bound}, tries={max_tries})")
