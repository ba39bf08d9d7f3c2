"""The BabyBear ring F_q[X]/(X^72 - X^36 + 1) and one folding step, in
plain PyTorch.

X^72 - X^36 + 1 is Phi_216.  With r = 503591070, a primitive 24th root
of unity mod q (the NONRESIDUE of the upstream stark-rings BabyBear
model, crates/ring/src/cyclotomic_ring/models/babybear/mod.rs), it
splits into the eight factors X^9 - r^k, k in K_SLOTS, and the CRT
sends f to its eight residues, each carried onto the slot field
F_q[Y]/(Y^9 - r) by X -> r^a Y^t (9 a + t = k mod 24), its nine
coordinates stored in the order PERM (upstream babybear/ntt.rs: the
eprint 2019/040 split and two radix-2 layers, :143-317; the slot
isomorphisms, :348-578; ``permute_to_fq9_of_fq3``, the 3 x 3 transpose
that stores Fq9 as a cubic extension of Fq3, :580-588).

Two departures from upstream's code, none from its map: each residue
f mod (X^9 - r^k) is read off the coefficients directly (coefficient
i takes f_(i + 9 j) r^(k j)) instead of through the butterfly layers,
and the ICRT is the inverse of the CRT's matrix, solved mod q, instead
of upstream's inverse layers.  The benchmark probes the CRT with the 72
unit vectors for its 72 x 72 matrix and applies both matrices with the
field ops of :mod:`.babybear`, on storage words (the maps are linear,
so they act on the words as on the values).

:func:`fold_step` is one LatticeFold-style folding step on NTT-form
witnesses and commitments in the batch-trailing layout ([D, W, ...]):
challenge fold, ICRT, balanced base-b decomposition, the exact L2
check, CRT, the Ajtai commit and the psi range check of every digit.
Inputs and outputs are int32 storage words; the work is in int64.
"""

from __future__ import annotations

import torch

from . import babybear as bb

D, SLOTS, E = 72, 8, 9
ROOT = 503591070                   # r, a primitive 24th root of unity mod q
NR = ROOT                          # the slot field F_q[Y]/(Y^9 - NR)
K_SLOTS = (1, 13, 7, 19, 5, 17, 11, 23)
#: slot s: X -> r^a Y^t on F_q[X]/(X^9 - r^k), (a, t) with 9 a + t = k
SLOT_MAPS = ((0, 1), (1, 4), (0, 7), (2, 1), (0, 5), (1, 8), (1, 2), (2, 5))
PERM = (0, 3, 6, 1, 4, 7, 2, 5, 8)  # Y^i is stored at PERM[i]


def _r(i: int) -> int:
    return pow(ROOT, i % 24, bb.Q)


def crt_ints(coeffs):
    """Coefficients -> NTT form (8 slots of 9 stored words' values),
    Python ints."""
    q, f = bb.Q, [x % bb.Q for x in coeffs]
    out = []
    for k, (a, t) in zip(K_SLOTS, SLOT_MAPS):
        res = [sum(f[i + 9 * j] * _r(k * j) for j in range(D // E)) % q
               for i in range(E)]                   # f mod (X^9 - r^k)
        deg = [0] * E
        for i, c in enumerate(res):                 # X^i -> r^(a i) Y^(t i)
            deg[i * t % E] = c * _r(a * i + i * t // E) % q
        slot = [0] * E
        for i in range(E):
            slot[PERM[i]] = deg[i]
        out.extend(slot)
    return out


def coeff_mul_ints(a, b):
    """Schoolbook product mod (X^72 - X^36 + 1, q), Python ints."""
    q = bb.Q
    prod = [0] * (2 * D - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            prod[i + j] = (prod[i + j] + x * y) % q
    for d in range(2 * D - 2, D - 1, -1):      # X^d = X^(d-36) - X^(d-72)
        prod[d - 36] = (prod[d - 36] + prod[d]) % q
        prod[d - 72] = (prod[d - 72] - prod[d]) % q
    return prod[:D]


def probe(fn):
    """The D x D matrix of a linear map on D-lists of ints."""
    cols = [fn([int(i == j) for i in range(D)]) for j in range(D)]
    return [[cols[j][i] for j in range(D)] for i in range(D)]


def inverse_mod_q(m):
    """The inverse of a square matrix of ints mod q (Gauss-Jordan)."""
    q, n = bb.Q, len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for c in range(n):
        p = next(r for r in range(c, n) if a[r][c] % q)
        a[c], a[p] = a[p], a[c]
        inv = pow(a[c][c], -1, q)
        a[c] = [x * inv % q for x in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(x - f * y) % q for x, y in zip(a[r], a[c])]
    return [row[n:] for row in a]


class Cyclotomic72:
    """The ring's maps and the step's stages on one device."""

    def __init__(self, device):
        self.device = device
        crt = probe(crt_ints)
        self.crt_m = self._matrix(crt)
        self.icrt_m = self._matrix(inverse_mod_q(crt))
        self.perm = torch.tensor(PERM, device=device)
        psi = [0] * D                  # psi = sum_{0<i<36} i (X^i - X^(72-i))
        for i in range(1, D // 2):
            psi[i] = (psi[i] + i) % bb.Q
            psi[D - i] = (psi[D - i] - i) % bb.Q
        # ct(psi * X^p) for p in [0, 72)
        self.ct_psi = [coeff_mul_ints(psi, [int(i == p) for i in range(D)])[0]
                       for p in range(D)]

    def _matrix(self, rows):
        """Values (not words) of a D x D matrix, int64."""
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    # -- linear maps over the leading axis ---------------------------------
    def apply(self, m, x, truncated=False):
        """m [D, D] @ x [D, ...] mod q, on storage words."""
        shape = (D,) + (1,) * (x.dim() - 1)
        acc = None
        for j in range(D):
            t = bb.scale(x[j:j + 1], m[:, j].reshape(shape), truncated)
            acc = t if acc is None else acc + t       # < 72 q < 2^38
        return acc % bb.Q

    def crt(self, x, truncated=False):
        return self.apply(self.crt_m, x, truncated)

    def icrt(self, x, truncated=False):
        return self.apply(self.icrt_m, x, truncated)

    # -- products ------------------------------------------------------------
    def coeff_mul(self, a, b, truncated=False):
        """Coefficient-form products [D, ...] x [D, ...] (schoolbook)."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        prod = torch.zeros((2 * D - 1,) + shape, dtype=torch.int64,
                           device=a.device)
        for i in range(D):
            prod[i:i + D] = bb.add(prod[i:i + D],
                                   bb.mul(a[i:i + 1], b, truncated))
        for d in range(2 * D - 2, D - 1, -1):     # X^d = X^(d-36) - X^(d-72)
            prod[d - 36] = bb.add(prod[d - 36], prod[d])
            prod[d - 72] = bb.sub(prod[d - 72], prod[d])
        return prod[:D].clone()

    def _degrees(self, x):
        """[D, ...] storage -> [SLOTS, E, ...], each slot in degree
        order."""
        return x.reshape((SLOTS, E) + x.shape[1:])[:, self.perm]

    def _wrap(self, t, truncated):
        """The 17 degree sums [SLOTS, 17, ...] (below 2^63, unreduced) ->
        [D, ...] storage: Y^(9 + i) = NR Y^i, each slot's coordinates put
        back in the order PERM."""
        t = t % bb.Q
        deg = torch.cat([bb.add(t[:, :E - 1],
                                bb.scale(t[:, E:], NR, truncated)),
                         t[:, E - 1:E]], dim=1)
        out = torch.empty_like(deg)
        out[:, self.perm] = deg
        return out.reshape((D,) + deg.shape[2:])

    def slot_mul(self, a, b, truncated=False):
        """NTT-form products [D, ...] x [D, ...] (broadcasting)."""
        x, y = self._degrees(a), self._degrees(b)
        shape = torch.broadcast_shapes(x.shape[2:], y.shape[2:])
        t = torch.zeros((SLOTS, 2 * E - 1) + shape, dtype=torch.int64,
                        device=a.device)
        for i in range(E):
            t[:, i:i + E] += bb.mul(x[:, i:i + 1], y, truncated)
        return self._wrap(t, truncated)

    def commit(self, at, dt, truncated=False):
        """cd[:, w, i] = sum_m A[:, i, m] * d[:, w, m] in NTT form:
        at [D, n, M], dt [D, W, M] -> [D, W, n].  One slot and one degree
        of A at a time: the live product is [9, W, n, M]."""
        x, y = self._degrees(at), self._degrees(dt)
        n, W = at.shape[1], dt.shape[1]
        t = torch.zeros((SLOTS, 2 * E - 1, W, n), dtype=torch.int64,
                        device=at.device)
        for s in range(SLOTS):
            for i in range(E):
                p = bb.mul(x[s, i][None, None], y[s][:, :, None], truncated)
                t[s, i:i + E] += p.sum(dim=-1)     # < 9 M q < 2^63
        return self._wrap(t, truncated)

    # -- the step's integer stages ----------------------------------------
    @staticmethod
    def decompose(coeff, base, k):
        """Balanced base-``base`` digits of each coefficient [D, W, L] ->
        [D, W, L * k] (digit j of column l at l * k + j): (storage words,
        signed digits)."""
        v = bb.to_values(coeff)
        neg = v > (bb.Q - 1) // 2
        cur = torch.where(neg, bb.Q - v, v)
        digits = []
        for _ in range(k):
            m = cur % base
            d = torch.where(2 * m <= base, m, m - base)    # in (-b/2, b/2]
            cur = (cur - d) // base
            digits.append(torch.where(neg, -d, d))
        if bool((cur != 0).any()):
            raise ValueError("decompose: k digits do not cover the value")
        sd = torch.stack(digits, dim=-1).reshape(coeff.shape[:-1] + (-1,))
        return bb.from_signed(sd), sd

    @staticmethod
    def l2_ok(signed_digits, bound_sq):
        """sum over (D, M) of d^2 <= bound, per witness [W]."""
        sq = (signed_digits * signed_digits).sum(dim=(0, 2))
        return sq <= bound_sq

    def psi_ok(self, signed_digits):
        """Per witness: every digit a satisfies ct(psi * exp(a)) == a,
        where exp(a) = X^a for 0 <= a < D and X^(D - |a|) for
        -D <= a < 0 (upstream crates/ring/src/monomial.rs:55-93); other
        digits fail."""
        a = signed_digits
        pos = torch.where(a >= 0, a, torch.remainder(D + a, D))
        valid = torch.where(a >= 0, a < D, -a <= D)
        tbl = torch.tensor([c - bb.Q if c > bb.Q // 2 else c
                            for c in self.ct_psi], dtype=torch.int64,
                           device=a.device)
        ok = valid & (tbl[pos.clamp(0, D - 1)] == a)
        return ok.all(dim=2).all(dim=0)


def fold_step(ring: Cyclotomic72, at, s0, s1, c0, c1, r, base, k,
              bound_sq, truncated=False):
    """One folding step (see the module docstring); r is the challenge
    in coefficient form [D].  Returns the step's outputs by name, the
    words as int32."""
    rt = ring.crt(r[:, None, None], truncated)           # [D, 1, 1]
    s = bb.add(s0, ring.slot_mul(s1, rt, truncated))
    c = bb.add(c0, ring.slot_mul(c1, rt, truncated))
    coeff = ring.icrt(s, truncated)
    digits, signed = ring.decompose(coeff, base, k)
    cd = ring.commit(at, ring.crt(digits, truncated), truncated)
    words = {"s": s, "c": c, "digits": digits, "cd": cd}
    out = {key: v.to(torch.int32) for key, v in words.items()}
    out["ok_l2"] = ring.l2_ok(signed, bound_sq)
    out["ok_psi"] = ring.psi_ok(signed)
    return out
