"""Integer-exact spec of the four cyclotomic ring models.

Each model implements the partially-splitting CRT of the reference:

* goldilocks  — Fq[X]/(X^24 - X^12 + 1), q = 2^64 - 2^32 + 1,   8 slots of Fq3
  (reference: crates/ring/src/cyclotomic_ring/models/goldilocks/{mod,ntt}.rs)
* babybear    — Fq[X]/(X^72 - X^36 + 1), q = 15*2^27 + 1,        8 slots of Fq9
  (reference: models/babybear/{mod,ntt,fq9}.rs)
* frog        — Fq[X]/(X^16 + 1),        q = 15912092521325583641, 4 slots of Fq4
  (reference: models/frog_ring/{mod,ntt}.rs)
* stark_prime — Fq[X]/(X^16 + 1),        q = 2^251 + 17*2^192 + 1, 16 slots of Fq
  (reference: models/stark_prime/{mod,ntt}.rs)

The CRT is expressed as a list of in-place linear *stages* over a length-D list
of canonical ints; the runtime derives its vectorized stage tables from
these by probing with basis vectors (`..ops.stages`).

Only numeric constants (the base roots of unity, moduli and slot orderings)
are taken from the reference; everything else (inverses, root powers, the
derived stage tables) is recomputed here and cross-checked by the golden
vector tests in tests/test_spec_golden.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

from .field import modinv

StageFn = Callable[[List[int]], None]


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------


def _butterfly(c: List[int], off: int, half: int, tw: int, q: int) -> None:
    """CT butterfly block: (a, b) -> (a + tw*b, a - tw*b)."""
    for i in range(half):
        a, b = c[off + i], c[off + half + i]
        t = tw * b % q
        c[off + i] = (a + t) % q
        c[off + half + i] = (a - t) % q


def _gs_butterfly(c: List[int], off: int, half: int, tw: int, q: int) -> None:
    """GS butterfly block: (a, b) -> (a + b, tw*(a - b))."""
    for i in range(half):
        a, b = c[off + i], c[off + half + i]
        c[off + i] = (a + b) % q
        c[off + half + i] = tw * (a - b) % q


@dataclass
class SpecModel:
    name: str
    q: int                      # base prime
    D: int                      # degree of the cyclotomic polynomial
    N: int                      # number of CRT slots
    E: int                      # CRT slot extension degree (D == N*E)
    nr: int                     # slot field: Fq[X]/(X^E - nr), degree order
    root: int                   # base root of unity generating the tables
    root_order: int             # multiplicative order of `root`
    roots: List[int]            # roots[i] = root^i mod q
    slot_powers: List[int]      # slot s is "f mod X^E - root^slot_powers[s]"
    storage_perm: List[int]     # degree-order index -> stored index (per slot)
    crt_stages: List[StageFn]   # includes final homogenize
    icrt_stages: List[StageFn]  # includes initial dehomogenize
    n_raw_stages: int           # number of crt stages before homogenize
    has_middle_term: bool       # Phi = X^D - X^(D/2) + 1 (vs X^D + 1)

    # -- polynomial / ring level ------------------------------------------
    def reduce(self, coeffs: Sequence[int]) -> List[int]:
        """Reduce a coefficient list (len <= 2D) mod Phi(X).

        Mirrors `CyclotomicConfig::reduce_in_place`
        (goldilocks/mod.rs:75-98, frog_ring/mod.rs:78-85, ...).
        """
        q, D = self.q, self.D
        c = [x % q for x in coeffs] + [0] * max(0, 2 * D - len(coeffs))
        if self.has_middle_term:
            # X^(D+j)   =  X^(D/2+j) - X^j        (0 <= j < D/2)
            # X^(3D/2+j) = -X^j                   (0 <= j < D/2)
            h = D // 2
            out = list(c[:D])
            for j in range(h):
                out[j] = (out[j] - c[D + j] - c[D + h + j]) % q
            for j in range(h):
                out[h + j] = (out[h + j] + c[D + j]) % q
        else:
            out = [(c[j] - c[D + j]) % q for j in range(D)]
        return out

    def coeff_mul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Schoolbook poly mul + cyclotomic reduction (coeff_form.rs:54-67)."""
        q, D = self.q, self.D
        prod = [0] * (2 * D - 1)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    prod[i + j] = (prod[i + j] + ai * bj) % q
        return self.reduce(prod)

    def rot(self, a: Sequence[int]) -> List[int]:
        """Multiply by X (Cyclotomic::rot, goldilocks/mod.rs:138-149)."""
        q, D = self.q, self.D
        last = a[D - 1]
        out = [(-last) % q] + [x % q for x in a[: D - 1]]
        if self.has_middle_term:
            out[D // 2] = (out[D // 2] + last) % q
        return out

    # -- CRT level ---------------------------------------------------------
    def crt(self, coeffs: Sequence[int]) -> List[int]:
        assert len(coeffs) == self.D
        c = [x % self.q for x in coeffs]
        for stage in self.crt_stages:
            stage(c)
        return c

    def crt_raw(self, coeffs: Sequence[int]) -> List[int]:
        """CRT without the final homogenize (for golden-vector tests)."""
        c = [x % self.q for x in coeffs]
        for stage in self.crt_stages[: self.n_raw_stages]:
            stage(c)
        return c

    def icrt(self, evals: Sequence[int]) -> List[int]:
        assert len(evals) == self.D
        c = [x % self.q for x in evals]
        for stage in self.icrt_stages:
            stage(c)
        return c

    # -- slot (extension field) level ---------------------------------------
    def ext_mul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Multiply two slot elements held in *stored* coordinate order.

        Internally maps to degree order, multiplies mod X^E - nr, maps back.
        Matches arkworks tower multiplication (e.g. Fq9: babybear/ntt.rs
        test_fq9_multiplication shows Fq9 == Fq[X]/(X^9 - nr) up to
        `permute_to_fq9_of_fq3`).
        """
        q, E, nr, perm = self.q, self.E, self.nr, self.storage_perm
        ad = [a[perm[i]] for i in range(E)]
        bd = [b[perm[i]] for i in range(E)]
        prod = [0] * (2 * E - 1)
        for i, x in enumerate(ad):
            if x:
                for j, y in enumerate(bd):
                    prod[i + j] = (prod[i + j] + x * y) % q
        out = list(prod[:E])
        for j in range(E - 1):
            out[j] = (out[j] + nr * prod[E + j]) % q
        inv_perm = [0] * E
        for i, p in enumerate(perm):
            inv_perm[p] = i
        return [out[inv_perm[i]] for i in range(E)]

    def ntt_mul(self, a: Sequence[int], b: Sequence[int]) -> List[int]:
        """Slot-wise multiplication of two full NTT-form elements."""
        out: List[int] = []
        for s in range(self.N):
            sl = slice(s * self.E, (s + 1) * self.E)
            out.extend(self.ext_mul(list(a[sl]), list(b[sl])))
        return out

    def ext_from_scalar(self, v: int) -> List[int]:
        return [v % self.q] + [0] * (self.E - 1)


# ---------------------------------------------------------------------------
# goldilocks
# ---------------------------------------------------------------------------


def _build_goldilocks() -> SpecModel:
    q = 2**64 - 2**32 + 1
    D, N, E = 24, 8, 3
    # NONRESIDUE = 2^40 (goldilocks/mod.rs:42); roots[i] = NONRESIDUE^i.
    root = 2**40
    r = [pow(root, i, q) for i in range(24)]
    kappa = modinv(2 * r[4] - 1, q)     # goldilocks/ntt.rs:43 ("KAPPA")
    inv8 = modinv(8, q)                 # ntt.rs:45
    inv4 = modinv(4, q)                 # ntt.rs:47

    # ---- forward stages (ntt.rs:135-228) ----
    def s1(c: List[int]) -> None:
        # eprint 2019/040 split: X^24 - X^12 + 1 = (X^12 - z)(X^12 - z^5),
        # z = r[4]; f0 = a + z b ; f1 = a + (1 - z) b.
        z = r[4]
        for i in range(12):
            a, b = c[i], c[12 + i]
            t = z * b % q
            c[i] = (a + t) % q
            c[12 + i] = (a + b - t) % q

    def s2(c: List[int]) -> None:
        _butterfly(c, 0, 6, r[2], q)
        _butterfly(c, 12, 6, r[10], q)

    def s3(c: List[int]) -> None:
        _butterfly(c, 0, 3, r[1], q)
        _butterfly(c, 6, 3, r[7], q)
        _butterfly(c, 12, 3, r[5], q)
        _butterfly(c, 18, 3, r[11], q)

    # ---- slot isomorphisms (ntt.rs:326-437) ----
    # each maps Fq[X]/(X^3 - r^k) -> Fq[X]/(X^3 - r), slots in order
    # [1, 13, 7, 19, 5, 17, 11, 23].
    def _scale(c, off, i1, k1, i2=None, k2=None):
        c[off + i1] = c[off + i1] * r[k1] % q
        if i2 is not None:
            c[off + i2] = c[off + i2] * r[k2] % q

    def _swapscale(c, off, k1, k2):
        c1 = c[off + 1]
        c[off + 1] = c[off + 2] * r[k1] % q
        c[off + 2] = c1 * r[k2] % q

    def homogenize(c: List[int]) -> None:
        c[3 + 1] = (-c[3 + 1]) % q          # 13
        _scale(c, 6, 1, 2, 2, 4)            # 7
        _scale(c, 9, 1, 6, 2, 12)           # 19
        _swapscale(c, 12, 3, 1)             # 5
        _swapscale(c, 15, 11, 5)            # 17
        _swapscale(c, 18, 7, 3)             # 11
        _swapscale(c, 21, 15, 7)            # 23

    def dehomogenize(c: List[int]) -> None:
        c[3 + 1] = (-c[3 + 1]) % q          # 13
        _scale(c, 6, 1, 22, 2, 20)          # 7
        _scale(c, 9, 1, 18, 2, 12)          # 19
        _swapscale(c, 12, 23, 21)           # 5
        _swapscale(c, 15, 19, 13)           # 17
        _swapscale(c, 18, 21, 17)           # 11
        _swapscale(c, 21, 17, 9)            # 23

    # ---- inverse stages (ntt.rs:240-319) ----
    def is1(c: List[int]) -> None:
        _gs_butterfly(c, 0, 3, r[23], q)
        _gs_butterfly(c, 6, 3, r[17], q)
        _gs_butterfly(c, 12, 3, r[19], q)
        _gs_butterfly(c, 18, 3, r[13], q)

    def is2(c: List[int]) -> None:
        _gs_butterfly(c, 0, 6, r[22], q)
        _gs_butterfly(c, 12, 6, r[14], q)

    def is3(c: List[int]) -> None:
        for i in range(12):
            a, b = c[i], c[12 + i]
            kd = kappa * (a - b) % q
            c[i] = inv8 * (a + b - kd) % q
            c[12 + i] = inv4 * kd % q

    return SpecModel(
        name="goldilocks", q=q, D=D, N=N, E=E, nr=r[1], root=root,
        root_order=24, roots=r, slot_powers=[1, 13, 7, 19, 5, 17, 11, 23],
        storage_perm=[0, 1, 2],
        crt_stages=[s1, s2, s3, homogenize],
        icrt_stages=[dehomogenize, is1, is2, is3],
        n_raw_stages=3, has_middle_term=True,
    )


# ---------------------------------------------------------------------------
# babybear
# ---------------------------------------------------------------------------


def _build_babybear() -> SpecModel:
    q = 15 * 2**27 + 1  # 2013265921 (babybear/mod.rs:22)
    D, N, E = 72, 8, 9
    root = 503591070    # NONRESIDUE (babybear/mod.rs:40)
    r = [pow(root, i, q) for i in range(24)]
    kappa = modinv(2 * r[4] - 1, q)     # babybear/ntt.rs:137 (the inverse!)
    inv8 = modinv(8, q)
    inv4 = modinv(4, q)

    def s1(c: List[int]) -> None:
        z = r[4]
        for i in range(36):
            a, b = c[i], c[36 + i]
            t = z * b % q
            c[i] = (a + t) % q
            c[36 + i] = (a + b - t) % q

    def s2(c: List[int]) -> None:
        _butterfly(c, 0, 18, r[2], q)
        _butterfly(c, 36, 18, r[10], q)

    def s3(c: List[int]) -> None:
        _butterfly(c, 0, 9, r[1], q)
        _butterfly(c, 18, 9, r[7], q)
        _butterfly(c, 36, 9, r[5], q)
        _butterfly(c, 54, 9, r[11], q)

    # permute_to_fq9_of_fq3 (babybear/ntt.rs:580-588): the 3x3 transpose
    # between degree order (w^i) and CubicExt-of-Fp3 storage order.
    PERM_SWAPS = [(1, 3), (2, 6), (5, 7)]

    def _permute(c: List[int], off: int) -> None:
        for i, j in PERM_SWAPS:
            c[off + i], c[off + j] = c[off + j], c[off + i]

    # The eight slot isomorphisms (babybear/ntt.rs:348-578).  Scales in
    # degree coordinates followed/preceded by the storage permutation.
    def iso0(c, o):
        _permute(c, o)

    def iso13(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 7] * r[10] % q
        c[o + 7] = c[o + 4] * r[5] % q
        c[o + 4] = c1 * r[1] % q
        c2 = c[o + 2]
        c[o + 2] = c[o + 5] * r[7] % q
        c[o + 5] = c[o + 8] * r[11] % q
        c[o + 8] = c2 * r[2] % q
        c[o + 3] = c[o + 3] * r[4] % q
        c[o + 6] = c[o + 6] * r[8] % q
        _permute(c, o)

    def inv13(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 4] * r[23] % q
        c[o + 4] = c[o + 7] * r[19] % q
        c[o + 7] = c1 * r[14] % q
        c2 = c[o + 2]
        c[o + 2] = c[o + 8] * r[22] % q
        c[o + 8] = c[o + 5] * r[13] % q
        c[o + 5] = c2 * r[17] % q
        c[o + 3] = c[o + 3] * r[20] % q
        c[o + 6] = c[o + 6] * r[16] % q

    def iso7(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 4] * r[3] % q
        c[o + 4] = c[o + 7] * r[5] % q
        c[o + 7] = c1
        c2 = c[o + 2]
        c[o + 2] = c[o + 8] * r[6] % q
        c[o + 8] = c[o + 5] * r[3] % q
        c[o + 5] = c2 * r[1] % q
        c[o + 3] = c[o + 3] * r[2] % q
        c[o + 6] = c[o + 6] * r[4] % q
        _permute(c, o)

    def inv7(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 7]
        c[o + 7] = c[o + 4] * r[19] % q
        c[o + 4] = c1 * r[21] % q
        c2 = c[o + 2]
        c[o + 2] = c[o + 5] * r[23] % q
        c[o + 5] = c[o + 8] * r[21] % q
        c[o + 8] = c2 * r[18] % q
        c[o + 3] = c[o + 3] * r[22] % q
        c[o + 6] = c[o + 6] * r[20] % q

    def iso19(c, o):
        for i, k in ((1, 2), (2, 4), (3, 6), (4, 8), (5, 10), (7, 14), (8, 16)):
            c[o + i] = c[o + i] * r[k] % q
        c[o + 6] = (-c[o + 6]) % q
        _permute(c, o)

    def inv19(c, o):
        _permute(c, o)
        for i, k in ((1, 22), (2, 20), (3, 18), (4, 16), (5, 14), (7, 10), (8, 8)):
            c[o + i] = c[o + i] * r[k] % q
        c[o + 6] = (-c[o + 6]) % q

    def iso5(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 2] * r[1] % q
        c[o + 2] = c[o + 4] * r[2] % q
        c[o + 4] = c[o + 8] * r[4] % q
        c[o + 8] = c[o + 7] * r[3] % q
        c[o + 7] = c[o + 5] * r[2] % q
        c[o + 5] = c1
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[3] % q
        c[o + 6] = c3 * r[1] % q
        _permute(c, o)

    def inv5(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 5]
        c[o + 5] = c[o + 7] * r[22] % q
        c[o + 7] = c[o + 8] * r[21] % q
        c[o + 8] = c[o + 4] * r[20] % q
        c[o + 4] = c[o + 2] * r[22] % q
        c[o + 2] = c1 * r[23] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[23] % q
        c[o + 6] = c3 * r[21] % q

    def iso17(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 8] * r[15] % q
        c[o + 8] = c1 * r[1] % q
        c2 = c[o + 2]
        c[o + 2] = c[o + 7] * r[13] % q
        c[o + 7] = c2 * r[3] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[11] % q
        c[o + 6] = c3 * r[5] % q
        c4 = c[o + 4]
        c[o + 4] = c[o + 5] * r[9] % q
        c[o + 5] = c4 * r[7] % q
        _permute(c, o)

    def inv17(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 8] * r[23] % q
        c[o + 8] = c1 * r[9] % q
        c2 = c[o + 2]
        c[o + 2] = c[o + 7] * r[21] % q
        c[o + 7] = c2 * r[11] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[19] % q
        c[o + 6] = c3 * r[13] % q
        c4 = c[o + 4]
        c[o + 4] = c[o + 5] * r[17] % q
        c[o + 5] = c4 * r[15] % q

    def iso11(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 5] * r[6] % q
        c[o + 5] = c[o + 7] * r[8] % q
        c[o + 7] = c[o + 8] * r[9] % q
        c[o + 8] = c[o + 4] * r[4] % q
        c[o + 4] = c[o + 2] * r[2] % q
        c[o + 2] = c1 * r[1] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[7] % q
        c[o + 6] = c3 * r[3] % q
        _permute(c, o)

    def inv11(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 2] * r[23] % q
        c[o + 2] = c[o + 4] * r[22] % q
        c[o + 4] = c[o + 8] * r[20] % q
        c[o + 8] = c[o + 7] * r[15] % q
        c[o + 7] = c[o + 5] * r[16] % q
        c[o + 5] = c1 * r[18] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[21] % q
        c[o + 6] = c3 * r[17] % q

    def iso23(c, o):
        c1 = c[o + 1]
        c[o + 1] = c[o + 2] * r[5] % q
        c[o + 2] = c[o + 4] * r[10] % q
        c[o + 4] = c[o + 8] * r[20] % q
        c[o + 8] = c[o + 7] * r[17] % q
        c[o + 7] = (-c[o + 5]) % q
        c[o + 5] = c1 * r[2] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[15] % q
        c[o + 6] = c3 * r[7] % q
        _permute(c, o)

    def inv23(c, o):
        _permute(c, o)
        c1 = c[o + 1]
        c[o + 1] = c[o + 5] * r[22] % q
        c[o + 5] = (-c[o + 7]) % q
        c[o + 7] = c[o + 8] * r[7] % q
        c[o + 8] = c[o + 4] * r[4] % q
        c[o + 4] = c[o + 2] * r[14] % q
        c[o + 2] = c1 * r[19] % q
        c3 = c[o + 3]
        c[o + 3] = c[o + 6] * r[17] % q
        c[o + 6] = c3 * r[9] % q

    ISOS = [iso0, iso13, iso7, iso19, iso5, iso17, iso11, iso23]
    INVS = [iso0, inv13, inv7, inv19, inv5, inv17, inv11, inv23]

    def homogenize(c: List[int]) -> None:
        for s, f in enumerate(ISOS):
            f(c, 9 * s)

    def dehomogenize(c: List[int]) -> None:
        for s, f in enumerate(INVS):
            f(c, 9 * s)

    def is1(c: List[int]) -> None:
        _gs_butterfly(c, 0, 9, r[23], q)
        _gs_butterfly(c, 18, 9, r[17], q)
        _gs_butterfly(c, 36, 9, r[19], q)
        _gs_butterfly(c, 54, 9, r[13], q)

    def is2(c: List[int]) -> None:
        _gs_butterfly(c, 0, 18, r[22], q)
        _gs_butterfly(c, 36, 18, r[14], q)

    def is3(c: List[int]) -> None:
        for i in range(36):
            a, b = c[i], c[36 + i]
            kd = kappa * (a - b) % q
            c[i] = inv8 * (a + b - kd) % q
            c[36 + i] = inv4 * kd % q

    # storage order: 3x3 transpose (fixed points 0,4,8)
    perm = [0, 3, 6, 1, 4, 7, 2, 5, 8]

    return SpecModel(
        name="babybear", q=q, D=D, N=N, E=E, nr=r[1], root=root,
        root_order=24, roots=r, slot_powers=[1, 13, 7, 19, 5, 17, 11, 23],
        storage_perm=perm,
        crt_stages=[s1, s2, s3, homogenize],
        icrt_stages=[dehomogenize, is1, is2, is3],
        n_raw_stages=3, has_middle_term=True,
    )


# ---------------------------------------------------------------------------
# frog
# ---------------------------------------------------------------------------


def _build_frog() -> SpecModel:
    q = 15912092521325583641  # frog_ring/mod.rs:22
    D, N, E = 16, 4, 4
    root = 2755067726615789629  # ROOTS_OF_UNITY_8[1] (frog_ring/ntt.rs:17)
    r = [pow(root, i, q) for i in range(8)]
    inv4 = modinv(4, q)

    def s1(c: List[int]) -> None:
        _butterfly(c, 0, 8, r[2], q)

    def s2(c: List[int]) -> None:
        _butterfly(c, 0, 4, r[1], q)
        _butterfly(c, 8, 4, r[3], q)

    # slot isomorphisms (frog_ring/ntt.rs:199-267); slot order [1, 5, 3, 7]
    def iso1(c, o):  # degree -> storage: swap coords 1 and 2
        c[o + 1], c[o + 2] = c[o + 2], c[o + 1]

    def iso5(c, o):
        c2 = c[o + 2]
        c[o + 2] = r[1] * c[o + 1] % q
        c[o + 1] = r[2] * c2 % q
        c[o + 3] = c[o + 3] * r[3] % q

    def inv5(c, o):
        c2 = c[o + 2]
        c[o + 2] = r[6] * c[o + 1] % q
        c[o + 1] = r[7] * c2 % q
        c[o + 3] = c[o + 3] * r[5] % q

    def iso3(c, o):
        c3 = c[o + 3]
        c[o + 3] = (-c[o + 1]) % q
        c[o + 1] = r[1] * c[o + 2] % q
        c[o + 2] = r[6] * c3 % q

    def inv3(c, o):
        c3 = c[o + 3]
        c[o + 3] = r[2] * c[o + 2] % q
        c[o + 2] = r[7] * c[o + 1] % q
        c[o + 1] = (-c3) % q

    def iso7(c, o):
        c3 = c[o + 3]
        c[o + 3] = r[1] * c[o + 1] % q
        c[o + 1] = r[3] * c[o + 2] % q
        c[o + 2] = r[5] * c3 % q

    def inv7(c, o):
        c3 = c[o + 3]
        c[o + 3] = r[3] * c[o + 2] % q
        c[o + 2] = r[5] * c[o + 1] % q
        c[o + 1] = r[7] * c3 % q

    def homogenize(c: List[int]) -> None:
        iso1(c, 0)
        iso5(c, 4)
        iso3(c, 8)
        iso7(c, 12)

    def dehomogenize(c: List[int]) -> None:
        iso1(c, 0)
        inv5(c, 4)
        inv3(c, 8)
        inv7(c, 12)

    def is1(c: List[int]) -> None:
        _gs_butterfly(c, 0, 4, r[7], q)
        _gs_butterfly(c, 8, 4, r[5], q)

    def is2(c: List[int]) -> None:
        for i in range(8):
            a, b = c[i], c[8 + i]
            c[i] = inv4 * (a + b) % q
            c[8 + i] = inv4 * r[6] % q * (a - b) % q

    return SpecModel(
        name="frog", q=q, D=D, N=N, E=E, nr=r[1], root=root,
        root_order=8, roots=r, slot_powers=[1, 5, 3, 7],
        storage_perm=[0, 2, 1, 3],
        crt_stages=[s1, s2, homogenize],
        icrt_stages=[dehomogenize, is1, is2],
        n_raw_stages=2, has_middle_term=False,
    )


# ---------------------------------------------------------------------------
# stark prime (fully splitting)
# ---------------------------------------------------------------------------


def _build_stark() -> SpecModel:
    q = 2**251 + 17 * 2**192 + 1  # stark_prime/mod.rs:22
    D, N, E = 16, 16, 1
    # ROOTS_OF_UNITY_32[1] (stark_prime/ntt.rs:18)
    root = 3409443867035641044245057348756544640549407421541289951053907001322227935403
    r = [pow(root, i, q) for i in range(32)]
    inv16 = modinv(16, q)

    def s1(c: List[int]) -> None:
        _butterfly(c, 0, 8, r[8], q)

    def s2(c: List[int]) -> None:
        _butterfly(c, 0, 4, r[4], q)
        _butterfly(c, 8, 4, r[12], q)

    def s3(c: List[int]) -> None:
        _butterfly(c, 0, 2, r[2], q)
        _butterfly(c, 4, 2, r[10], q)
        _butterfly(c, 8, 2, r[6], q)
        _butterfly(c, 12, 2, r[14], q)

    LAST = [1, 9, 5, 13, 3, 11, 7, 15]

    def s4(c: List[int]) -> None:
        for blk, k in enumerate(LAST):
            _butterfly(c, 2 * blk, 1, r[k], q)

    def is1(c: List[int]) -> None:
        for blk, k in enumerate(LAST):
            _gs_butterfly(c, 2 * blk, 1, r[32 - k], q)

    def is2(c: List[int]) -> None:
        _gs_butterfly(c, 0, 2, r[30], q)
        _gs_butterfly(c, 4, 2, r[22], q)
        _gs_butterfly(c, 8, 2, r[26], q)
        _gs_butterfly(c, 12, 2, r[18], q)

    def is3(c: List[int]) -> None:
        _gs_butterfly(c, 0, 4, r[28], q)
        _gs_butterfly(c, 8, 4, r[20], q)

    def is4(c: List[int]) -> None:
        for i in range(8):
            a, b = c[i], c[8 + i]
            c[i] = inv16 * (a + b) % q
            c[8 + i] = inv16 * r[24] % q * (a - b) % q

    return SpecModel(
        name="stark_prime", q=q, D=D, N=N, E=E, nr=0, root=root,
        root_order=32, roots=r,
        slot_powers=[1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
        storage_perm=[0],
        crt_stages=[s1, s2, s3, s4],
        icrt_stages=[is1, is2, is3, is4],
        n_raw_stages=4, has_middle_term=False,
    )


MODELS: Dict[str, SpecModel] = {}
for _b in (_build_goldilocks, _build_babybear, _build_frog, _build_stark):
    _m = _b()
    MODELS[_m.name] = _m


def get_model(name: str) -> SpecModel:
    return MODELS[name]
