"""Cyclotomic ring models as batched integer-tensor ops (counterpart of
``stark_rings_tpu/rings/ring.py``; L2 of the reference).

A :class:`RingModel` binds one spec model (goldilocks, babybear, frog,
stark_prime) to its prime field and to one device, and exposes the
reference's
`Ring`/`PolyRing` surface as functional, batched tensor ops:

* coefficient form: storage ``[..., D]`` (``[..., D, 8]`` for
  stark_prime's limbs, as everywhere below); schoolbook multiply and
  cyclotomic reduction (reference coeff_form.rs:54-67 and the models'
  ``reduce_in_place``).
* NTT/CRT form: the same shape, slot-major ``N x E``; the slot-wise
  extension-field product (ntt_form.rs:159-189) through precomputed
  gather and factor tables.
* ``crt``/``icrt``: one D x D digit GEMM and its bucket fold
  (:mod:`..ops.mxu_dense`; the fold is K3's kernel for goldilocks,
  K4's ``bb_fold_end`` for babybear and S3's ``limb_fold`` for
  stark_prime on the card).  The chain of 2-term
  stages derived from the integer spec (goldilocks/ntt.rs:68-127 etc.)
  stays as the oracle (``crt_staged``, ``use_dense_crt = False``).

A vector of ring elements is a leading batch axis; the reference's
``elementwise_crt`` / ``Flatten`` casts (crt.rs:10-49, flatten.rs:10-44)
are reshapes.  Every table lives on the ring's device, the CUDA card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..device import get_device
from ..fields import get_field
from ..ops.dense_linear import probe_dense_matrix
from ..ops.mxu_dense import prescaled_dense
from ..ops.stages import derive_linear_table, derive_stage_tables
from ..spec import MODELS, SpecModel

__all__ = ["RingModel", "get_ring", "RINGS"]


class RingModel:
    """One cyclotomic ring model: Fq[X]/Phi(X) with its CRT machinery,
    on one device."""

    #: class-wide switch: apply CRT/ICRT as the one dense digit GEMM
    #: (ops/mxu_dense.py) instead of the chained butterfly stages
    use_dense_crt: bool = True

    def __init__(self, spec: SpecModel, field, device="cuda"):
        if field.q != spec.q:
            raise ValueError(f"field {field.name} does not match model "
                             f"{spec.name}")
        self.spec = spec
        self.field = field
        self.device = get_device(device)
        self.name = spec.name
        self.q = spec.q
        self.D = spec.D
        self.N = spec.N
        self.E = spec.E

    # ------------------------------------------------------------------
    # derived tables (built on first use, cached)
    # ------------------------------------------------------------------
    @cached_property
    def _stages(self):
        return derive_stage_tables(self.spec, self.field, self.device)

    @cached_property
    def _dense_crt(self):
        """(crt, icrt) as D x D digit-GEMM maps, probed from the integer
        spec (the composite of every butterfly layer and slot
        isomorphism)."""
        mc = probe_dense_matrix(self.spec.crt, self.D, self.D, self.q)
        mi = probe_dense_matrix(self.spec.icrt, self.D, self.D, self.q)
        return (prescaled_dense(self.field, mc, self.device),
                prescaled_dense(self.field, mi, self.device))

    @cached_property
    def _reduce_table(self):
        spec = self.spec

        def fold(c):
            r = spec.reduce(c)
            c[: len(r)] = r

        return derive_linear_table(fold, 2 * spec.D - 1, spec.D, self.field,
                                   3, self.device)

    @cached_property
    def _ext_tables(self):
        """Gather/factor tables of the slot-wise extension product.

        In degree coordinates c[k] = sum_i a[i] * b[(k-i) % E] * nr^[i>k]
        (X^E = nr), conjugated by the model's storage permutation (e.g.
        babybear's permute_to_fq9_of_fq3, ntt.rs:580-588).  Returns
        (perm, inv_perm, idx [E, E], fac storage [E, E])."""
        E, q, nr = self.E, self.q, self.spec.nr
        perm = np.asarray(self.spec.storage_perm, dtype=np.int64)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(E)
        idx = np.zeros((E, E), dtype=np.int64)
        fac = np.zeros((E, E), dtype=object)
        for i in range(E):
            for k in range(E):
                idx[i, k] = (k - i) % E
                fac[i, k] = nr % q if i > k else 1
        dev = self.device
        return (torch.from_numpy(perm).to(dev),
                torch.from_numpy(inv_perm).to(dev),
                torch.from_numpy(idx).to(dev), self.field.encode(fac, dev))

    @cached_property
    def _conv_tables(self):
        """Index/mask tables [D, 2D-1] of the schoolbook full product."""
        D = self.D
        L = 2 * D - 1
        k = np.arange(L)[None, :] - np.arange(D)[:, None]
        mask = (k >= 0) & (k < D)
        idx = np.where(mask, k, 0)
        return (torch.from_numpy(idx).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @cached_property
    def _frob_tables(self):
        """Per-slot Frobenius maps x -> x^(q^i), i = 1..E-1, as 1-term
        stages.

        In the slot field Fq[X]/(X^E - nr) Frobenius is the monomial map
        X^j -> nr^k X^r with j*q^i = E*k + r: a permutation and a
        diagonal scale, derived by probing the integer convention
        (storage_perm conjugation as in ``SpecModel.ext_mul``)."""
        spec, E, q, nr = self.spec, self.E, self.q, self.spec.nr
        perm = list(spec.storage_perm)
        inv_perm = [0] * E
        for i, p in enumerate(perm):
            inv_perm[p] = i
        tables = []
        for i in range(1, E):
            qi = q ** i

            def frob(c, qi=qi):
                ad = [c[perm[t]] for t in range(E)]
                out = [0] * E
                for j in range(E):
                    m = j * qi
                    out[m % E] = (out[m % E] + ad[j] * pow(nr, m // E, q)) % q
                c[:] = [out[inv_perm[t]] for t in range(E)]

            tables.append(derive_linear_table(frob, E, E, self.field, 1,
                                              self.device))
        return tables

    # ------------------------------------------------------------------
    # host conversions
    # ------------------------------------------------------------------
    def encode_coeffs(self, ints):
        """[..., D] python-int array -> storage on the ring's device."""
        arr = np.asarray(ints, dtype=object)
        if arr.shape[-1] != self.D:
            raise ValueError(f"last axis {arr.shape[-1]} != D = {self.D}")
        return self.field.encode(arr, self.device)

    def decode(self, x):
        return self.field.decode(x)

    def rand_coeff(self, shape, rng: np.random.Generator):
        """Uniform elements [*shape, D] drawn from the numpy Generator."""
        return self.field.rand(tuple(shape) + (self.D,), rng, self.device)

    rand_ntt = rand_coeff

    def zeros(self, shape=()):
        return self.field.zeros(tuple(shape) + (self.D,), self.device)

    def from_coeff_list(self, ints):
        """From<Vec<Fq>> semantics (coeff_form.rs:568-578): pad short
        lists with zeros, reduce longer ones mod Phi(X) (up to 2D)."""
        vals = [int(v) % self.q for v in ints]
        if len(vals) > 2 * self.D:
            raise ValueError(f"coefficient list of {len(vals)} is longer "
                             f"than 2D = {2 * self.D}")
        if len(vals) > self.D:
            vals = self.spec.reduce(vals)
        vals = vals + [0] * (self.D - len(vals))
        return self.encode_coeffs(np.array(vals, dtype=object))

    def rot_iter(self, x, count=None):
        """Cyclotomic::into_rot_iter (traits.rs:58-84): yields x, x*X,
        x*X^2, ... (count defaults to the cyclotomic degree)."""
        cur = x
        for _ in range(self.D if count is None else count):
            yield cur
            cur = self.rot(cur)

    def from_scalar_coeff(self, v, shape=()):
        """Coefficient-form constant polynomial (coeff_form.rs:556-561)."""
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0] = v % self.q
        return self.encode_coeffs(out)

    def from_scalar_ntt(self, v, shape=()):
        """NTT-form scalar: broadcast over the slots (ntt_form.rs:689-692)."""
        out = np.zeros(tuple(shape) + (self.D,), dtype=object)
        out[..., 0::self.E] = v % self.q
        return self.encode_coeffs(out)

    # ------------------------------------------------------------------
    # ring ops (batched over leading axes)
    # ------------------------------------------------------------------
    def add(self, a, b):
        return self.field.add(a, b)

    def sub(self, a, b):
        return self.field.sub(a, b)

    def neg(self, a):
        return self.field.neg(a)

    def scalar_mul(self, s, a):
        """Every coefficient times a base-field scalar (storage)."""
        return self.field.mul(s, a)

    def mul_consts(self) -> dict:
        """The CRT/ICRT digit tables as numpy arrays ``{"crt", "icrt"}``,
        byte-equal to the reference's ``mul_consts()``.
        ``ops.mxu2.from_jax_consts`` turns either package's into the
        device tables that :meth:`crt` / :meth:`icrt` take as ``c``."""
        crt, icrt = self._dense_crt
        return {"crt": crt.core.big, "icrt": icrt.core.big}

    def _dense(self, which: int, key: str, x, c):
        m = self._dense_crt[which]
        return m(x) if c is None else m(x, c[key], c.get(key + "_corr"))

    def crt(self, x, c=None):
        """coeff -> NTT form (reference crt.rs:55-63): one dense digit
        GEMM by default.  ``c``: device tables from
        ``from_jax_consts(mul_consts())`` in place of the ring's own."""
        if self.use_dense_crt:
            return self._dense(0, "crt", x, c)
        return self.crt_staged(x)

    def icrt(self, x, c=None):
        """NTT -> coeff form."""
        if self.use_dense_crt:
            return self._dense(1, "icrt", x, c)
        return self.icrt_staged(x)

    def crt_staged(self, x):
        """The chained butterfly-stage CRT (kept as the oracle)."""
        for st in self._stages[0]:
            x = st(x)
        return x

    def icrt_staged(self, x):
        for st in self._stages[1]:
            x = st(x)
        return x

    def ntt_mul(self, a, b):
        """Slot-wise extension-field product of NTT-form elements
        (ntt_form.rs:159-189; ``mul`` and ``mul_unchecked`` agree)."""
        f = self.field
        if self.E == 1:
            return f.mul(a, b)
        perm, inv_perm, idx, fac = self._ext_tables
        N, E = self.N, self.E
        a_deg = f.take_coeff(a.reshape(a.shape[:-1] + (N, E)), perm)
        b_deg = f.take_coeff(b.reshape(b.shape[:-1] + (N, E)), perm)
        # bg[..., n, i, k] = b_deg[..., n, (k-i) % E]
        scaled = f.mul(fac, f.take_coeff(b_deg, idx))
        c_deg = f.sum(f.mul(a_deg[..., :, None], scaled), axis=-2)
        c = f.take_coeff(c_deg, inv_perm)
        return c.reshape(c.shape[:-2] + (self.D,))

    mul_unchecked = ntt_mul

    def coeff_mul(self, a, b):
        """Schoolbook polynomial product and cyclotomic reduction
        (coeff_form.rs:54-67; the oracle for ntt_mul)."""
        f = self.field
        idx, mask = self._conv_tables
        bg = f.take_coeff(b, idx)                       # [..., D, 2D-1(, L)]
        bg = f.select(mask, bg, torch.zeros_like(bg))
        if f.limbed:
            conv = f.sum(f.mul(a[..., :, None, :], bg), axis=-3)
        else:
            conv = f.sum(f.mul(a[..., :, None], bg), axis=-2)
        return self._reduce_table(conv)

    def reduce(self, c):
        """Reduce a length-(2D-1) coefficient tensor mod Phi(X)."""
        return self._reduce_table(c)

    def rot(self, a):
        """Multiply by X in coefficient form (Cyclotomic::rot,
        goldilocks/mod.rs:138-149, frog_ring/mod.rs:125-133)."""
        f = self.field
        D, ax = self.D, f.coeff_axis
        last = a.narrow(ax, D - 1, 1)
        out = torch.cat([f.neg(last), a.narrow(ax, 0, D - 1)], dim=ax)
        if self.spec.has_middle_term:
            h = D // 2
            out = torch.cat([out.narrow(ax, 0, h),
                             f.add(out.narrow(ax, h, 1), last),
                             out.narrow(ax, h + 1, D - h - 1)], dim=ax)
        return out

    def pow_rot(self, a, k: int):
        """a * X^k (rot() iterated)."""
        for _ in range(k):
            a = self.rot(a)
        return a

    def ntt_pow(self, a, e: int):
        """Elementwise power in NTT form by slot-wise square and multiply."""
        if e < 0:
            raise ValueError("negative exponents: invert first")
        if e == 0:
            return self.from_scalar_ntt(1, self.batch_shape(a))
        acc = None
        base = a
        while e:
            if e & 1:
                acc = base if acc is None else self.ntt_mul(acc, base)
            e >>= 1
            if e:
                base = self.ntt_mul(base, base)
        return acc

    def _slotwise(self, fn, x):
        """Apply an E-coordinate map slot-wise over the D axis."""
        ys = fn(x.reshape(x.shape[:-1] + (self.N, self.E)))
        return ys.reshape(x.shape)

    def ntt_frobenius(self, a, i: int = 1):
        """Slot-wise Frobenius x -> x^(q^i) on NTT-form elements: a
        permutation and scale in each slot field."""
        if self.E == 1 or i % self.E == 0:
            return a
        return self._slotwise(self._frob_tables[(i % self.E) - 1], a)

    def ntt_inv(self, a):
        """Slot-wise inverse (slots must be nonzero), by the norm trick:
        with c = prod_{i=1..E-1} a^(q^i) (the conjugates, through the
        Frobenius tables), N(a) = a*c lies in Fq, so a^-1 = c * N(a)^-1:
        one base-field inversion."""
        f = self.field
        if self.E == 1:
            return f.inv(a)
        conj = None
        for tab in self._frob_tables:
            fa = self._slotwise(tab, a)
            conj = fa if conj is None else self.ntt_mul(conj, fa)
        norm = self.ntt_mul(a, conj)
        slots = norm.shape[:-1] + (self.N, self.E)
        # the norm lives in Fq: stored coordinate 0 of each slot
        inv_n0 = f.inv(norm.reshape(slots)[..., :1])
        return f.mul(conj.reshape(slots), inv_n0).reshape(a.shape)

    def batch_shape(self, x):
        """The batch axes of storage ``x`` (before the coefficient axis)."""
        return x.shape[:x.dim() - 1 - len(self.field.limb_shape)]

    # -- flatten (R10): Vec<Rq> <-> Vec<Fq> are reshapes -----------------
    def flatten(self, x):
        """[..., n, D(, L)] -> [..., n*D(, L)]."""
        limb = self.field.limb_shape
        lead = x.shape[:x.dim() - 2 - len(limb)]
        n = x.shape[x.dim() - 2 - len(limb)]
        return x.reshape(lead + (n * self.D,) + limb)

    def promote(self, x):
        """[..., n*D(, L)] -> [..., n, D(, L)]."""
        limb = self.field.limb_shape
        nd = x.shape[x.dim() - 1 - len(limb)]
        if nd % self.D:
            raise ValueError(f"coefficient axis {nd} is not a multiple "
                             f"of D = {self.D}")
        return x.reshape(self.batch_shape(x) + (nd // self.D, self.D)
                         + limb)


RINGS: dict = {}


def get_ring(name: str, device="cuda") -> RingModel:
    """The ring model called ``name`` on ``device``, built on first use
    and cached per (name, device)."""
    if name not in MODELS:
        raise KeyError(f"unknown ring model {name!r}")
    dev = get_device(device)
    key = (name, str(dev))
    if key not in RINGS:
        RINGS[key] = RingModel(MODELS[name], get_field(name), dev)
    return RINGS[key]
