"""The stark_prime ring F_q[X]/(X^16 + 1), q = 2^251 + 17 * 2^192 + 1,
and one folding step, in plain PyTorch.

X^16 + 1 is Phi_32, and q - 1 is divisible by 2^192, so the ring splits
fully into 16 slots of F_q: slot s holds f(w^e_s) for w = ROOT, the
primitive 32nd root of unity of the upstream stark-rings model
(crates/ring/src/cyclotomic_ring/models/stark_prime/ntt.rs:16-49,
``ROOTS_OF_UNITY_32[1]``), and e_s the odd exponents in upstream's slot
order SLOT_POWERS (``ntt.rs:57-64``: the order its four butterfly layers
leave the evaluations in).  A slot product is a product of F_q.

Departures from upstream's code, none from its map: each residue
f(w^e) is read off the coefficients directly (a 16 x 16 matrix over F_q)
instead of through the butterfly layers, and the ICRT is the inverse of
that matrix, solved mod q, instead of upstream's inverse layers.  The
matrices act on storage words as on values (they are F_q-linear).  A
matrix is applied as float64 matrix products over 16-bit limbs, exact
because every sum stays below 2^53, and then reduced by the field
reference (:mod:`.stark`).

:func:`fold_step` is one LatticeFold-style folding step on NTT-form
witnesses and commitments in the batch-trailing layout ([D, W, ..., 8]
int32 storage): challenge fold, ICRT, balanced base-2^16 decomposition,
the exact L2 check, the Ajtai commit of the digits' NTT form and the
psi range check of every digit.  Two more departures, exact mod q: the
commit cd[s] = sum_m A[s, m] crt(d)[s, m] is computed as sum_j
crt[s, j] (sum_m A[s, m] d[j, m]), the inner sums over the small signed
digits d taken exactly in float64 (below 2^49), so the digits' NTT form
is never built; and a storage product is an integer product scaled by
2^-256 mod q.
"""

from __future__ import annotations

import torch

from . import stark as sk

D = 16
#: w, a primitive 32nd root of unity mod q (upstream ntt.rs:18)
ROOT = 3409443867035641044245057348756544640549407421541289951053907001322227935403
#: slot s holds f(w^SLOT_POWERS[s]) (upstream ntt.rs:57-64)
SLOT_POWERS = (1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31)
#: columns a float64 matrix product takes at once (bounds its memory)
CHUNK = 1 << 18


def crt_ints(coeffs):
    """Coefficients -> NTT form, Python ints."""
    q = sk.Q
    return [sum(c * pow(ROOT, e * i, q) for i, c in enumerate(coeffs)) % q
            for e in SLOT_POWERS]


def coeff_mul_ints(a, b):
    """Schoolbook product mod (X^16 + 1, q), Python ints."""
    q = sk.Q
    out = [0] * D
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            k = i + j
            if k < D:
                out[k] = (out[k] + x * y) % q
            else:                            # X^16 = -1
                out[k - D] = (out[k - D] - x * y) % q
    return out


def inverse_mod_q(m):
    """The inverse of a square matrix of ints mod q (Gauss-Jordan)."""
    q, n = sk.Q, len(m)
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


def _scaled(m, c):
    return [[x * c % sk.Q for x in row] for row in m]


class Cyclotomic16:
    """The ring's maps and the step's stages on one device."""

    def __init__(self, device):
        self.device = device
        q = sk.Q
        self.crt_m = [[pow(ROOT, e * i, q) for i in range(D)]
                      for e in SLOT_POWERS]
        self.icrt_m = inverse_mod_q(self.crt_m)
        psi = [0] * D                  # psi = sum_{0<i<8} i (X^i - X^(16-i))
        for i in range(1, D // 2):
            psi[i] = (psi[i] + i) % q
            psi[D - i] = (psi[D - i] - i) % q
        # ct(psi * X^p) for p in [0, 16), as signed integers
        ct = [coeff_mul_ints(psi, [int(i == p) for i in range(D)])[0]
              for p in range(D)]
        self.ct_psi = [c - q if c > q // 2 else c for c in ct]
        self._digit_words = None

    # -- linear maps over the leading axis ---------------------------------
    def _limb_matrix(self, m):
        """[R, C, 16] int64 limbs of a matrix of Python ints."""
        return sk.to_limbs([list(row) for row in m], self.device)

    def apply(self, m, x, truncated=False):
        """m [R, C] (Python ints, values) @ x [C, ...] mod q on canonical
        limbs [C, ..., 16] -> [R, ..., 16].  One float64 product a chunk
        of columns: column (r, t) of the result sums m[r, j] limb a times
        x[j] limb b over a + b = t and j, each sum below 2^40."""
        ml = self._limb_matrix(m)                     # [R, C, 16]
        R, C = ml.shape[:2]
        width = sk.N if truncated else 2 * sk.N - 1
        big = torch.zeros((R, width, C, sk.N), dtype=torch.float64,
                          device=x.device)
        for b in range(sk.N):
            n = min(sk.N, width - b)
            big[:, b:b + n, :, b] = ml[:, :, :n].transpose(1, 2).double()
        big = big.reshape(R * width, C * sk.N)
        rest = x.shape[1:-1]
        xs = x.reshape(C, -1, sk.N).permute(0, 2, 1).reshape(C * sk.N, -1)
        out = []
        for s in range(0, xs.shape[1], CHUNK):
            cols = (big @ xs[:, s:s + CHUNK].double()).to(torch.int64)
            cols = cols.reshape(R, width, -1).permute(0, 2, 1)
            out.append(sk.reduce(cols, 41))
        return torch.cat(out, dim=1).reshape((R,) + rest + (sk.N,))

    def apply_small(self, m, x):
        """m [R, C] (Python ints) @ x [C, ...] mod q for small signed
        integers x (int64, |x| < 2^20) -> canonical limbs [R, ..., 16]."""
        ml = self._limb_matrix(m)                     # [R, C, 16]
        R, C = ml.shape[:2]
        big = ml.permute(0, 2, 1).reshape(R * sk.N, C).double()
        rest = x.shape[1:]
        xs = x.reshape(C, -1)
        out = []
        for s in range(0, xs.shape[1], CHUNK):
            cols = (big @ xs[:, s:s + CHUNK].double()).to(torch.int64)
            out.append(sk.reduce(cols.reshape(R, sk.N, -1).permute(0, 2, 1),
                                 41))
        return torch.cat(out, dim=1).reshape((R,) + rest + (sk.N,))

    def crt(self, x, truncated=False):
        """NTT form of coefficient-form storage [D, ..., 8] (storage)."""
        return sk.to_storage(self.apply(self.crt_m, sk.from_storage(x),
                                        truncated))

    def icrt(self, x, truncated=False):
        return sk.to_storage(self.apply(self.icrt_m, sk.from_storage(x),
                                        truncated))

    def ntt_of_signed(self, x):
        """The storage of the NTT form of small signed coefficients x
        [D, ...] (int64) -> int32 [D, ..., 8]."""
        return sk.to_storage(self.apply_small(_scaled(self.crt_m, sk.R), x))

    @staticmethod
    def slot_mul(a, b, truncated=False):
        """NTT-form products of storage [D, ..., 8] x [D, ..., 8]
        (broadcasting): each slot's field product, a b 2^-256 on the
        words."""
        p = sk.mul(sk.from_storage(a), sk.from_storage(b), truncated)
        return sk.to_storage(sk.scale(p, sk.R_INV))

    # -- the step's stages ---------------------------------------------------
    def fold(self, x0, x1, rt_value, truncated=False):
        """x0 + x1 r on storage [D, ...] for the challenge's NTT form
        given as values [D] (Python ints): x1's words times r is the
        storage of the product, one reduction with x0 added."""
        r = sk.to_limbs(list(rt_value), x1.device)
        r = r.reshape((D,) + (1,) * (x1.dim() - 2) + (sk.N,))
        cols = sk.conv(sk.from_storage(x1), r, truncated)
        cols[..., :sk.N] += sk.from_storage(x0)
        return sk.to_storage(sk.reduce(cols, 37))

    @staticmethod
    def decompose(values, base, k):
        """Balanced base-2^16 digits of canonical values [D, W, L, 16] ->
        signed digits int64 [D, W, L * k] (digit j of column l at l k +
        j): sign = [v > (q - 1)/2], the magnitude's limbs taken in turn,
        a limb m + carry above 2^15 giving m - 2^16 and a carry."""
        if base != 1 << 16 or k < sk.N:
            raise ValueError("decompose: the reference takes base 2^16 and "
                             "k >= 16")
        half = sk.to_limbs((sk.Q + 1) // 2, values.device)
        neg = sk._normalize(list((values - half).unbind(-1)), sk.N)[-1] >= 0
        q = sk.to_limbs(sk.Q, values.device)
        mag = torch.where(neg[..., None], sk.reduce(q - values, 17), values)
        digits, carry = [], torch.zeros_like(mag[..., 0])
        for j in range(sk.N):
            t = mag[..., j] + carry
            m = t & sk.M16
            low = 2 * m <= base
            digits.append(torch.where(low, m, m - base))
            carry = (t >> 16) + (~low).to(torch.int64)
        if bool((carry != 0).any()):
            raise ValueError("decompose: 16 digits do not cover the value")
        digits += [torch.zeros_like(carry)] * (k - sk.N)
        sd = torch.stack(digits, dim=-1)
        sd = torch.where(neg[..., None], -sd, sd)
        return sd.reshape(values.shape[:-2] + (-1,))

    def digit_words(self, sd):
        """Signed digits |d| <= 2^15 -> int32 storage [..., 8]."""
        if self._digit_words is None or \
                self._digit_words.device != sd.device:
            self._digit_words = sk.signed_storage_table(-(1 << 15), 1 << 15,
                                                        sd.device)
        return self._digit_words[sd + (1 << 15)]

    def commit(self, at, sd, truncated=False):
        """cd[s, w, i] = sum_m A[s, i, m] crt(d)[s, w, m] on storage: at
        [D, n, M, 8], signed digits sd [D, W, M] -> [D, W, n, 8].  The
        inner sums T[s, j, w, i] = sum_m A[s, i, m] d[j, w, m] are float64
        products of A's 16-bit limbs with the digits (each below 2^49),
        then cd[s] = sum_j crt[s, j] T[s, j]."""
        n, W = at.shape[1], sd.shape[1]
        dm = sd.reshape(D * W, -1).double().t()             # [M, D W]
        crt = self._limb_matrix(self.crt_m)                 # [D, D, 16]
        out = []
        for s in range(D):
            a = sk.from_storage(at[s]).permute(0, 2, 1).reshape(n * sk.N, -1)
            t = (a.double() @ dm).to(torch.int64)           # [(i, a), (j, w)]
            t = t.reshape(n, sk.N, D, W).permute(2, 3, 0, 1)  # [j, w, i, a]
            t = sk.reduce(t, 50)
            cols = sk.conv(crt[s].reshape(D, 1, 1, sk.N), t,
                           truncated).sum(dim=0)            # [w, i, cols]
            out.append(sk.reduce(cols, 41))
        return sk.to_storage(torch.stack(out))

    @staticmethod
    def l2_ok(sd, bound_sq):
        """sum over (D, M) of d^2 <= bound, per witness [W]."""
        return (sd * sd).sum(dim=(0, 2)) <= bound_sq

    def psi_ok(self, sd):
        """Per witness: every digit a satisfies ct(psi * exp(a)) == a,
        where exp(a) = X^a for 0 <= a < D and X^(D - |a|) for -D <= a < 0
        (upstream crates/ring/src/monomial.rs:55-93); other digits
        fail.  At D = 16 that passes exactly the digits in [-7, 7]."""
        a = sd
        pos = torch.where(a >= 0, a, torch.remainder(D + a, D))
        valid = torch.where(a >= 0, a < D, -a <= D)
        tbl = torch.tensor(self.ct_psi, dtype=torch.int64, device=a.device)
        ok = valid & (tbl[pos.clamp(0, D - 1)] == a)
        return ok.all(dim=2).all(dim=0)


def challenge_ntt(ring: Cyclotomic16, r):
    """The challenge's NTT form as values (Python ints), from its
    coefficient-form storage r [D, 8]: the words' CRT times 2^-256."""
    words = [sum(int(v & sk.M32) << (32 * j) for j, v in enumerate(row))
             for row in r.to(torch.int64).tolist()]
    return [sum(c * w for c, w in zip(row, words)) * sk.R_INV % sk.Q
            for row in ring.crt_m]


def fold_step(ring: Cyclotomic16, at, s0, s1, c0, c1, r, base, k,
              bound_sq, truncated=False):
    """One folding step (see the module docstring); r is the challenge
    in coefficient-form storage [D, 8].  Returns the step's outputs by
    name: the words as int32 [..., 8], the check bits as bool [W]."""
    rt = challenge_ntt(ring, r)
    s = ring.fold(s0, s1, rt, truncated)
    c = ring.fold(c0, c1, rt, truncated)
    values = ring.apply(_scaled(ring.icrt_m, sk.R_INV), sk.from_storage(s),
                        truncated)
    sd = ring.decompose(values, base, k)
    return {"s": s, "c": c, "digits": ring.digit_words(sd),
            "cd": ring.commit(at, sd, truncated),
            "ok_l2": ring.l2_ok(sd, bound_sq), "ok_psi": ring.psi_ok(sd)}
