"""Monomial algebra (counterpart of ``stark_rings_tpu/rings/monomial.py``;
reference crates/ring/src/monomial.rs:17-93): monomials, the psi table,
exp / exp_signed, and the psi range check of monomial range proofs, one
value on the host or a whole tensor on the device."""

from __future__ import annotations

import numpy as np
import torch

from ..spec.field import sign as spec_sign, to_signed

__all__ = ["monomial", "unit_monomial", "zero_monomial", "psi", "exp",
           "exp_signed", "ct", "psi_range_check", "exp_batched",
           "psi_range_check_batched", "MonomialError"]


class MonomialError(ValueError):
    """Mirror of MonomialError (monomial.rs:6-12)."""


def monomial(ring, i: int, coeff: int = 1, shape=()):
    """coeff * X^i in coefficient form (monomial.rs:17-21)."""
    out = np.zeros(tuple(shape) + (ring.D,), dtype=object)
    out[..., i] = coeff % ring.q
    return ring.encode_coeffs(out)


def unit_monomial(ring, i: int, shape=()):
    return monomial(ring, i, 1, shape)


def zero_monomial(ring, shape=()):
    return ring.zeros(shape)


def _psi_int_coeffs(ring):
    """psi's integer coefficients: the one definition that :func:`psi`
    and :func:`_ct_psi_table` build from."""
    q, D = ring.q, ring.D
    out = [0] * D
    for i in range(1, D // 2):
        out[i] = (out[i] + i) % q
        out[D - i] = (out[D - i] - i) % q
    return out


def psi(ring):
    """psi = sum_{i in [1, d')} i (X^{-i} + X^i), d' = d/2
    (monomial.rs:36-48; X^{-i} contributes -X^{d-i})."""
    return ring.encode_coeffs(np.array(_psi_int_coeffs(ring), dtype=object))


def exp(ring, a: int):
    """exp(a) = X^{center(a)} if sign(a) = +1 else X^{d - center(a)}
    (monomial.rs:55-65), for a canonical base-field integer ``a``."""
    q, D = ring.q, ring.D
    centered = abs(to_signed(a, q))
    if spec_sign(a, q) == 1:
        if centered >= D:
            raise MonomialError(f"exponent {centered} out of monomial range")
        return unit_monomial(ring, centered)
    if centered > D:
        raise MonomialError(f"exponent {centered} out of monomial range")
    return unit_monomial(ring, (D - centered) % D)


def exp_signed(ring, a: int):
    """exp_signed(a) = sign(a) * X^{center(a)} (monomial.rs:71-76)."""
    q = ring.q
    centered = abs(to_signed(a, q))
    if centered >= ring.D:
        raise MonomialError(f"exponent {centered} out of monomial range")
    return monomial(ring, centered, spec_sign(a, q))


def ct(ring, x):
    """Constant term (CoeffRing::ct, poly_ring.rs:19-42)."""
    return ring.field.take_coeff(x, 0)


def psi_range_check(ring, a: int) -> bool:
    """ct(psi * exp(a)) == a  <=>  a in (-d', d')  (monomial.rs:82-93)."""
    try:
        b = exp(ring, a)
    except MonomialError:
        return False
    prod = ring.coeff_mul(psi(ring), b)
    return int(ring.field.decode(ct(ring, prod))) == a % ring.q


def _exp_pos_batched(ring, a):
    """Batched exp() exponent: storage [...] -> (pos int32 [...], valid).

    ``pos`` is the exponent exp(a) = X^pos would use; where the reference
    would panic (centered > D, or centered >= D with positive sign),
    ``valid`` is False and ``pos`` is garbage (callers mask).  As in the
    reference, the centered value is narrowed to 32 bits before the
    range test."""
    f, D = ring.field, ring.D
    vm = f.canon(a)                        # canonical |a|
    vneg = f.canon(f.neg(a))               # canonical q - a
    is_pos = f.geq(f.canon_const((ring.q - 1) // 2), vm)   # incl. a = 0
    centered = f.select(is_pos, vm, vneg)
    if f.limbed:                           # the low limb, if the rest is 0
        high_zero = (centered[..., 1:] == 0).all(dim=-1)
        sm = torch.where(high_zero, centered[..., 0], 0)
    else:
        high_zero = True
        sm = centered.to(torch.int32)
    pos = torch.where(is_pos, sm, torch.remainder(D - sm, D))
    valid = high_zero & torch.where(is_pos, sm < D, sm <= D)
    return pos, valid


def exp_batched(ring, a):
    """Batched exp(): storage [...] -> (monomials [..., D(, L)], valid
    [...]).

    The device-side mirror of :func:`exp` over a whole witness tensor:
    where the reference would panic, ``valid`` is False and the monomial
    is zero."""
    f, D = ring.field, ring.D
    pos, valid = _exp_pos_batched(ring, a)
    onehot = (torch.arange(D, dtype=torch.int32, device=a.device)
              == pos[..., None]) & valid[..., None]
    mono = f.select(onehot, f.ones((), a.device), f.zeros((), a.device))
    return mono, valid


def _ct_psi_table(ring):
    """Storage [D(, L)] table of ct(psi * X^p) for p in [0, D), on the
    ring's device.

    ct(psi * exp(a)) reads only the constant term of the product, and
    exp(a) is a monomial, so the D^2 schoolbook multiply of the naive
    check collapses to this table, built once per ring on the integer
    spec (``coeff_mul``)."""
    tbl = getattr(ring, "_ct_psi_cache", None)
    if tbl is None:
        D = ring.D
        psi_ints = _psi_int_coeffs(ring)
        rows = []
        for p in range(D):
            xp = [0] * D
            xp[p] = 1
            rows.append(ring.spec.coeff_mul(psi_ints, xp)[0])
        tbl = ring.field.encode(np.array(rows, dtype=object), ring.device)
        ring._ct_psi_cache = tbl
    return tbl


def psi_range_check_batched(ring, a):
    """Batched psi range check: storage tensor [...] -> bool [...], one
    graph over a whole witness tensor (monomial.rs:82-93 per element):
    valid(exp) and ct(psi * exp(a)) == a.

    ct(psi * X^pos) is read from :func:`_ct_psi_table` by an unrolled
    chain of D selects, the reference's form (its TPU gather measured
    about 30x slower inside a composed step).  Equal to the one-hot and
    ``coeff_mul`` formulation on every input, valid or not.  On the card
    the folding step's Goldilocks and BabyBear digits take the one-pass
    kernel of :mod:`..ops.digits` instead, which reads the same table
    from shared memory by the same formula; this chain is its twin and
    the path of every other field and of CPU tensors."""
    f = ring.field
    pos, valid = _exp_pos_batched(ring, a)
    tbl = _ct_psi_table(ring)
    pos_m = torch.remainder(pos, ring.D)
    c = tbl[0].expand(pos.shape + f.limb_shape)
    for p in range(1, ring.D):
        c = f.select(pos_m == p, tbl[p], c)
    eq = c == a
    return valid & (eq.all(dim=-1) if f.limbed else eq)
