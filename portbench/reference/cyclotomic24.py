"""The Goldilocks ring F_q[X]/(X^24 - X^12 + 1) and one folding step, in
plain PyTorch.

The CRT splits the ring into 8 slots of F_q[X]/(X^3 - 2^40) (the
upstream stark-rings Goldilocks model, crates/ring/src/cyclotomic_ring/
models/goldilocks/ntt.rs): the split of eprint 2019/040, two radix-2
layers, then one slot isomorphism a slot.  The stages below restate
that transform in Python ints; the benchmark probes them with the 24
unit vectors for its 24 x 24 CRT and ICRT matrices, and applies those
with the field ops of :mod:`.goldilocks`.

:func:`fold_step` is one LatticeFold-style folding step on NTT-form
witnesses and commitments in the batch-trailing layout ([D, W, ...]):
challenge fold, ICRT, balanced base-b decomposition, the exact L2 check,
CRT, the Ajtai commit and the psi range check of every digit.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

D, SLOTS, E = 24, 8, 3
ROOT = 1 << 40                     # a primitive 24th root of unity mod q
NR = ROOT                          # slot field F_q[X]/(X^3 - NR)


def _r(i: int) -> int:
    return pow(ROOT, i % 24, gl.Q)


def _bfly(c, off, half, tw):
    q = gl.Q
    for i in range(half):
        a, b = c[off + i], c[off + half + i]
        t = tw * b % q
        c[off + i], c[off + half + i] = (a + t) % q, (a - t) % q


def _gs_bfly(c, off, half, tw):
    q = gl.Q
    for i in range(half):
        a, b = c[off + i], c[off + half + i]
        c[off + i], c[off + half + i] = (a + b) % q, tw * (a - b) % q


def _scale(c, off, i1, k1, i2, k2):
    c[off + i1] = c[off + i1] * _r(k1) % gl.Q
    c[off + i2] = c[off + i2] * _r(k2) % gl.Q


def _swapscale(c, off, k1, k2):
    c1 = c[off + 1]
    c[off + 1] = c[off + 2] * _r(k1) % gl.Q
    c[off + 2] = c1 * _r(k2) % gl.Q


def crt_ints(coeffs):
    """Coefficients -> NTT form (8 slots of 3), Python ints."""
    q, c = gl.Q, [x % gl.Q for x in coeffs]
    z = _r(4)                      # X^24 - X^12 + 1 = (X^12 - z)(X^12 - z^5)
    for i in range(12):
        a, b = c[i], c[12 + i]
        t = z * b % q
        c[i], c[12 + i] = (a + t) % q, (a + b - t) % q
    _bfly(c, 0, 6, _r(2))
    _bfly(c, 12, 6, _r(10))
    for off, k in ((0, 1), (6, 7), (12, 5), (18, 11)):
        _bfly(c, off, 3, _r(k))
    # slots [1, 13, 7, 19, 5, 17, 11, 23] mapped onto F_q[X]/(X^3 - r)
    c[4] = (-c[4]) % q
    _scale(c, 6, 1, 2, 2, 4)
    _scale(c, 9, 1, 6, 2, 12)
    for off, k1, k2 in ((12, 3, 1), (15, 11, 5), (18, 7, 3), (21, 15, 7)):
        _swapscale(c, off, k1, k2)
    return c


def icrt_ints(evals):
    """NTT form -> coefficients, Python ints."""
    q, c = gl.Q, [x % gl.Q for x in evals]
    c[4] = (-c[4]) % q
    _scale(c, 6, 1, 22, 2, 20)
    _scale(c, 9, 1, 18, 2, 12)
    for off, k1, k2 in ((12, 23, 21), (15, 19, 13), (18, 21, 17),
                        (21, 17, 9)):
        _swapscale(c, off, k1, k2)
    for off, k in ((0, 23), (6, 17), (12, 19), (18, 13)):
        _gs_bfly(c, off, 3, _r(k))
    _gs_bfly(c, 0, 6, _r(22))
    _gs_bfly(c, 12, 6, _r(14))
    kappa = pow(2 * _r(4) - 1, q - 2, q)
    inv8, inv4 = pow(8, q - 2, q), pow(4, q - 2, q)
    for i in range(12):
        a, b = c[i], c[12 + i]
        kd = kappa * (a - b) % q
        c[i], c[12 + i] = inv8 * (a + b - kd) % q, inv4 * kd % q
    return c


def coeff_mul_ints(a, b):
    """Schoolbook product mod (X^24 - X^12 + 1, q), Python ints."""
    q = gl.Q
    prod = [0] * (2 * D - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            prod[i + j] = (prod[i + j] + x * y) % q
    for d in range(2 * D - 2, D - 1, -1):      # X^d = X^(d-12) - X^(d-24)
        prod[d - 12] = (prod[d - 12] + prod[d]) % q
        prod[d - 24] = (prod[d - 24] - prod[d]) % q
    return prod[:D]


def _probe(fn):
    cols = [fn([int(i == j) for i in range(D)]) for j in range(D)]
    return [[cols[j][i] for j in range(D)] for i in range(D)]


class Cyclotomic24:
    """The ring's maps and the step's stages on one device."""

    def __init__(self, device):
        self.device = device
        self.crt_m = self._matrix(_probe(crt_ints))
        self.icrt_m = self._matrix(_probe(icrt_ints))
        self.nr = gl.tensor([NR], device)
        psi = [0] * D                  # psi = sum_{0<i<12} i (X^i - X^(24-i))
        for i in range(1, D // 2):
            psi[i] = (psi[i] + i) % gl.Q
            psi[D - i] = (psi[D - i] - i) % gl.Q
        # ct(psi * X^p) for p in [0, 24)
        self.ct_psi = [coeff_mul_ints(psi, [int(i == p) for i in range(D)])[0]
                       for p in range(D)]

    def _matrix(self, rows):
        return torch.stack([gl.tensor(r, self.device) for r in rows])

    # -- linear maps over the leading axis ---------------------------------
    def apply(self, m, x, truncated=False):
        """m [D, D] @ x [D, ...] mod q."""
        shape = (D,) + (1,) * (x.dim() - 1)
        acc = None
        for j in range(D):
            t = gl.mul(m[:, j].reshape(shape), x[j:j + 1], truncated)
            acc = t if acc is None else gl.add(acc, t)
        return acc

    def crt(self, x, truncated=False):
        return self.apply(self.crt_m, x, truncated)

    def icrt(self, x, truncated=False):
        return self.apply(self.icrt_m, x, truncated)

    # -- products ------------------------------------------------------------
    def coeff_mul(self, a, b, truncated=False):
        """Coefficient-form products [D, ...] x [D, ...] (schoolbook)."""
        prod = torch.zeros((2 * D - 1,) + a.shape[1:], dtype=a.dtype,
                           device=a.device)
        for i in range(D):
            prod[i:i + D] = gl.add(prod[i:i + D],
                                   gl.mul(a[i:i + 1], b, truncated))
        for d in range(2 * D - 2, D - 1, -1):     # X^d = X^(d-12) - X^(d-24)
            prod[d - 12] = gl.add(prod[d - 12], prod[d])
            prod[d - 24] = gl.sub(prod[d - 24], prod[d])
        return prod[:D].clone()

    def slot_terms(self, a, b, truncated=False):
        """The 5 degree terms of each slot's product before X^3 = NR:
        list over slots of [t0, t1, t2, t3, t4] (broadcast shapes)."""
        out = []
        for s in range(SLOTS):
            x = [a[3 * s + i] for i in range(E)]
            y = [b[3 * s + i] for i in range(E)]
            t = [None] * (2 * E - 1)
            for i in range(E):
                for j in range(E):
                    p = gl.mul(x[i], y[j], truncated)
                    t[i + j] = p if t[i + j] is None else gl.add(t[i + j], p)
            out.append(t)
        return out

    def _wrap(self, t, truncated):
        """[t0..t4] -> (t0 + NR t3, t1 + NR t4, t2)."""
        nr = self.nr.reshape((1,) * t[3].dim())
        return [gl.add(t[0], gl.mul(nr, t[3], truncated)),
                gl.add(t[1], gl.mul(nr, t[4], truncated)), t[2]]

    def slot_mul(self, a, b, truncated=False):
        """NTT-form products [D, ...] x [D, ...] (broadcasting)."""
        out = []
        for t in self.slot_terms(a, b, truncated):
            out.extend(self._wrap(t, truncated))
        return torch.stack(out)

    def commit(self, at, dt, truncated=False):
        """cd[:, w, i] = sum_m A[:, i, m] * d[:, w, m] in NTT form:
        at [D, n, M], dt [D, W, M] -> [D, W, n]."""
        terms = self.slot_terms(at[:, None], dt[:, :, None], truncated)
        out = []
        for t in terms:                   # each term [W, n, M]
            summed = [gl.sum_mod(x, dim=-1) for x in t]
            out.extend(self._wrap(summed, truncated))
        return torch.stack(out)

    # -- the step's integer stages ----------------------------------------
    @staticmethod
    def decompose(coeff, base, k):
        """Balanced base-``base`` digits of each coefficient [D, W, L] ->
        [D, W, L * k] (digit j of column l at l * k + j), as field
        storage."""
        half = (gl.Q - 1) // 2
        neg = gl.ult(gl.tensor([half], coeff.device), coeff)
        cur = torch.where(neg, gl.Q_W - coeff, coeff)      # |signed| < 2^63
        digits = []
        for _ in range(k):
            m = cur % base
            d = torch.where(2 * m <= base, m, m - base)    # in (-b/2, b/2]
            cur = (cur - d) // base
            digits.append(torch.where(neg, -d, d))
        if bool((cur != 0).any()):
            raise ValueError("decompose: k digits do not cover the value")
        sd = torch.stack(digits, dim=-1).reshape(coeff.shape[:-1] + (-1,))
        return torch.where(sd < 0, sd + gl.Q_W, sd), sd

    @staticmethod
    def l2_ok(signed_digits, bound_sq):
        """sum over (D, M) of d^2 <= bound, per witness [W]."""
        sq = (signed_digits * signed_digits).sum(dim=(0, 2))
        return sq <= bound_sq

    def psi_ok(self, signed_digits):
        """Per witness: every digit a satisfies ct(psi * exp(a)) == a,
        where exp(a) = X^a for 0 <= a < D and X^(D - |a|) for
        -D <= a < 0 (monomial.rs:55-93); other digits fail."""
        a = signed_digits
        pos = torch.where(a >= 0, a, torch.remainder(D + a, D))
        valid = torch.where(a >= 0, a < D, -a <= D)
        tbl = torch.tensor([c - gl.Q if c > gl.Q // 2 else c
                            for c in self.ct_psi], dtype=torch.int64,
                           device=a.device)
        ok = valid & (tbl[pos.clamp(0, D - 1)] == a)
        return ok.all(dim=2).all(dim=0)


def fold_step(ring: Cyclotomic24, at, s0, s1, c0, c1, r, base, k,
              bound_sq, truncated=False):
    """One folding step (see the module docstring); r is the challenge
    in coefficient form [D].  Returns the step's outputs by name."""
    rt = ring.crt(r[:, None, None], truncated)           # [D, 1, 1]
    s = gl.add(s0, ring.slot_mul(s1, rt, truncated))
    c = gl.add(c0, ring.slot_mul(c1, rt, truncated))
    coeff = ring.icrt(s, truncated)
    digits, signed = ring.decompose(coeff, base, k)
    cd = ring.commit(at, ring.crt(digits, truncated), truncated)
    return {"s": s, "c": c, "digits": digits, "cd": cd,
            "ok_l2": ring.l2_ok(signed, bound_sq),
            "ok_psi": ring.psi_ok(signed)}
