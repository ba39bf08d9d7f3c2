"""Prime-field arithmetic on integer tensors: Goldilocks, BabyBear, frog
and the 252-bit stark prime.

Counterpart of ``stark_rings_tpu/fields/field.py`` (``_Goldilocks``,
``_BabyBear``, ``_Frog``, ``_Stark`` and ``_mul64_128``); see
:mod:`..device` for the storage.

* **Goldilocks** ``q = 2^64 - 2^32 + 1``: canonical values held as the
  u64 bit patterns of ``int64`` tensors, with the classic 128-bit
  reduction (2^64 = 2^32 - 1, 2^96 = -1 mod q).  torch has no unsigned
  64-bit arithmetic: add, sub and mul wrap mod 2^64 as u64 does, a
  logical right shift is an arithmetic shift followed by a mask, and an
  unsigned compare flips the sign bit of both sides first.  Constants
  above 2^63 are written as their int64 bit patterns (:func:`i64`).
* **BabyBear** ``q = 15 * 2^27 + 1``: Montgomery form with R = 2^32 in
  ``int32`` tensors (every stored value is below q < 2^31), single-word
  REDC on ``int64``.  Add and sub stay inside int32 by comparing
  ``a - (q - b)`` with zero.
* **frog** ``q = 15912092521325583641`` (a generic 64-bit prime above
  2^63): Montgomery form with R = 2^64 in ``int64`` tensors holding the
  u64 bit patterns, as Goldilocks; the REDC takes the high words of
  a*b and m*q and the carry of their low words, exactly as the
  reference's ``_mont_mul_raw``.
* **stark_prime** ``q = 2^251 + 17 * 2^192 + 1``: Montgomery form with
  R = 2^256 as eight little-endian u32 limbs, ``int32 [..., 8]``
  (``limb_shape = (8,)``, coefficient axis -2).  The CIOS product and
  add / sub are the CUDA kernels S1 and S2 of :mod:`..ops.stark` on the
  card and their plain twins (the reference's limb loops on int64 words)
  on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import (get_device, to_numpy_storage, to_numpy_u32,
                      to_torch, to_torch_u32)
from ..ops import stark as _ks

__all__ = ["Goldilocks", "GOLDILOCKS", "BabyBear", "BABYBEAR", "Frog",
           "FROG", "Stark", "STARK", "FIELDS", "get_field", "i64", "shr",
           "u64_lt"]

MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def i64(v: int) -> int:
    """u64 python int -> the python int with the same int64 bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def u64_lt(a, b) -> torch.Tensor:
    """Unsigned ``a < b`` on int64 bit patterns (tensors or int64 ints)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _mul64_128(a: torch.Tensor, b: torch.Tensor):
    """Full 64x64 -> 128-bit product as a ``(hi, lo)`` pair of u64 words."""
    a0 = a & MASK32
    a1 = shr(a, 32)
    b0 = b & MASK32
    b1 = shr(b, 32)
    ll = a0 * b0
    a1b0 = a1 * b0
    mid = a0 * b1 + shr(ll, 32) + (a1b0 & MASK32)
    hi = a1 * b1 + shr(a1b0, 32) + shr(mid, 32)
    lo = (mid << 32) | (ll & MASK32)
    return hi, lo


class _PrimeField:
    """What the fields share (the reference's ``Field``): host
    conversions built on the per-field :meth:`storage_np` and
    ``_scalar``, the canonical view and the widened words of word-sized
    storage, and the reductions and powers built on ``add`` and
    ``mul``."""

    name: str
    q: int
    bits: int
    dtype: torch.dtype
    limb_shape: tuple = ()
    limbed = False

    # -- host conversions ---------------------------------------------------
    def encode(self, ints, device="cuda") -> torch.Tensor:
        """python ints / object array -> storage tensor on ``device``."""
        return self._codec(self.storage_np(ints), device)

    def decode(self, x: torch.Tensor) -> np.ndarray:
        """storage -> numpy object array of canonical python ints."""
        host = to_numpy_storage(self.canon(x))
        out = np.empty(host.size, dtype=object)
        out[:] = [int(v) for v in host.reshape(-1)]
        return out.reshape(host.shape)

    def const(self, v: int, device="cuda") -> torch.Tensor:
        """One element in storage form, as a 0-d tensor."""
        return torch.tensor(self._scalar(v), dtype=self.dtype,
                            device=get_device(device))

    def zeros(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype,
                           device=get_device(device))

    def ones(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.full(tuple(shape), self._scalar(1), dtype=self.dtype,
                          device=get_device(device))

    # -- reductions and powers -----------------------------------------------
    def sum(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Modular sum over ``axis`` via a halving tree of ``add``s (an odd
        length parks its last entry and adds it at the end).  ``torch.sum``
        wraps and is not a field sum."""
        axis = axis % x.dim()
        if x.shape[axis] == 0:
            shape = x.shape[:axis] + x.shape[axis + 1:]
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        rem = None
        while x.shape[axis] > 1:
            n = x.shape[axis]
            if n % 2:
                tail = x.narrow(axis, n - 1, 1)
                rem = tail if rem is None else self.add(rem, tail)
                x = x.narrow(axis, 0, n - 1)
                n -= 1
            x = self.add(x.narrow(axis, 0, n // 2),
                         x.narrow(axis, n // 2, n // 2))
        if rem is not None:
            x = self.add(x, rem)
        return x.squeeze(axis)

    def dot(self, a, b, axis: int) -> torch.Tensor:
        """Modular inner product over ``axis``: sum(mul(a, b))."""
        return self.sum(self.mul(a, b), axis)

    def pow_const(self, x: torch.Tensor, e: int) -> torch.Tensor:
        """x**e for a static exponent (square and multiply)."""
        if e == 0:
            return self._one_like(x)
        acc = None
        base = x
        while e:
            if e & 1:
                acc = base if acc is None else self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse via Fermat (x != 0)."""
        return self.pow_const(x, self.q - 2)

    def square_table(self, g) -> list:
        """[g^(2^i) for i < bits] (Ring::pow_with_table's precompute,
        ring.rs:13-117)."""
        out = [g]
        for _ in range(self.bits - 1):
            out.append(self.mul(out[-1], out[-1]))
        return out

    def pow_with_table(self, table, e: int) -> torch.Tensor:
        """g^e from :meth:`square_table`'s table (static exponent)."""
        acc = None
        i = 0
        while e:
            if e & 1:
                acc = table[i] if acc is None else self.mul(acc, table[i])
            e >>= 1
            i += 1
        return acc if acc is not None else self._one_like(table[0])

    def _one_like(self, x: torch.Tensor) -> torch.Tensor:
        """The field's one in the storage shape of ``x``."""
        return torch.full_like(x, self._scalar(1))

    # -- host draws and bytes -------------------------------------------------
    def rand_ints(self, shape, rng: np.random.Generator):
        """Uniform canonical python ints drawn from the numpy Generator:
        an object array of ``shape`` (a python int for ``()``)."""
        draw = rng.integers(0, self.q, size=shape, dtype=np.uint64)
        if not shape:
            return int(draw)
        out = np.empty(draw.shape, dtype=object)
        out.reshape(-1)[:] = [int(v) for v in draw.reshape(-1)]
        return out

    def rand(self, shape, rng: np.random.Generator,
             device="cuda") -> torch.Tensor:
        """Uniform elements of ``shape``, encoded from :meth:`rand_ints`
        (the fields draw their storage directly)."""
        return self.encode(self.rand_ints(shape, rng), device)

    def from_random_bytes(self, data: bytes):
        """FromRandomBytes semantics (ring.rs:119-135): the first
        ceil(bits / 8) bytes little-endian; None if the value is >= q."""
        nb = (self.bits + 7) // 8
        if len(data) < nb:
            return None
        v = int.from_bytes(data[:nb], "little")
        return v if v < self.q else None

    # -- coefficient axis and predicates --------------------------------------
    coeff_axis = -1

    def take_coeff(self, x: torch.Tensor, idx) -> torch.Tensor:
        """Gather along the coefficient axis: ``x[..., idx]`` for an
        integer index array of any shape (a 0-d index drops the axis)."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                  device=x.device)
        return x[..., idx]

    @staticmethod
    def select(cond, a, b) -> torch.Tensor:
        return torch.where(cond, a, b)

    @staticmethod
    def is_zero(x) -> torch.Tensor:
        return x == 0

    @staticmethod
    def geq(a, b) -> torch.Tensor:
        """a >= b on canonical values (below 2^31: a signed compare)."""
        return a >= b

    # -- canonical view: storage <-> canonical values, the identity for
    # fields stored without a Montgomery factor
    @staticmethod
    def canon(x):
        return x

    @staticmethod
    def from_canon(u):
        return u

    def canon_const(self, v: int) -> int:
        """The canonical value ``v mod q`` as it is stored by
        :meth:`canon` (NOT in Montgomery form), for comparisons with
        ``canon`` output."""
        return self._raw(v % self.q)

    # -- widened accumulation -------------------------------------------------
    # Big modular sums widen storage to base-2^32 words (int64 tensors
    # holding u64 sums), add them with plain integer adds (exact for up to
    # 2^32 addends) and fold back mod q once: sum_j d_j 2^(32 j) mod q.
    @property
    def n_words(self) -> int:
        return 1 if self.bits <= 32 else 2

    def widen(self, x: torch.Tensor) -> torch.Tensor:
        """storage -> int64 [..., n_words]: the u32 words of the stored
        bits."""
        if self.n_words == 1:
            return (x.to(torch.int64) & MASK32)[..., None]
        return torch.stack([x & MASK32, shr(x, 32)], dim=-1)

    def reduce_words(self, words: torch.Tensor) -> torch.Tensor:
        """int64 [..., W] of unnormalized base-2^32 words (u64 bits) ->
        storage mod q.  The words are normalized to digits below 2^32,
        and digit j is multiplied by 2^(32 j) S mod q, S being the
        Montgomery factor (1 for Goldilocks): the product of the raw
        digit and that constant is the raw value d_j 2^(32 j) mod q."""
        digits = []
        carry = torch.zeros_like(words[..., 0])
        for j in range(words.shape[-1]):
            s = words[..., j] + carry
            digits.append(s & MASK32)
            carry = shr(s, 32)
        for _ in range(2):
            digits.append(carry & MASK32)
            carry = shr(carry, 32)
        S = getattr(self, "R", 1) % self.q
        acc = None
        for j, d in enumerate(digits):
            c = self._raw_tensor((1 << (32 * j)) * S % self.q, d.device)
            term = self.mul(self._lift32(d), c)
            acc = term if acc is None else self.add(acc, term)
        return acc

    def segment_sum(self, values: torch.Tensor, seg_ids,
                    num_segments: int) -> torch.Tensor:
        """Modular segment sum over the leading axis: storage [n, ...] and
        segment ids [n] in [0, num_segments) (a tensor or array of ints;
        duplicates add, absent segments are zero) -> [num_segments, ...].
        The widened words are added by one int64 ``index_add_``: u64
        bits that wrap as the reference's ``uint64`` accumulators do,
        exact on the card in any order of the atomics."""
        w = self.widen(values)
        ids = torch.as_tensor(seg_ids, device=w.device)
        acc = torch.zeros((num_segments,) + tuple(w.shape[1:]),
                          dtype=torch.int64, device=w.device)
        acc.index_add_(0, ids, w)
        return self.reduce_words(acc)

    def _lift32(self, d: torch.Tensor) -> torch.Tensor:
        """int64 words below 2^32 -> storage holding that raw integer."""
        return d.to(self.dtype)

    def _raw_tensor(self, v: int, device) -> torch.Tensor:
        """The storage whose bits are the canonical value ``v`` (not
        Montgomery form), as a tensor on ``device``."""
        return torch.tensor(self._raw(v), dtype=self.dtype, device=device)


class _U64Field(_PrimeField):
    """What Goldilocks and frog share: u64 bit patterns in ``int64``
    storage, and add, sub and neg mod a q above 2^63 with unsigned
    compares (a sum that wraps past 2^64 also reduces by q)."""

    bits = 64
    dtype = torch.int64
    _Q: int              # q's int64 bit pattern

    @staticmethod
    def _codec(arr, device):
        return to_torch(arr, device)

    @staticmethod
    def _raw(v: int) -> int:
        """The storage word whose u64 bits are ``v`` (an int64 int)."""
        return i64(v)

    def geq(self, a, b) -> torch.Tensor:
        """Unsigned a >= b on canonical values (u64 bits)."""
        return ~u64_lt(a, b)

    def rand(self, shape, rng: np.random.Generator,
             device="cuda") -> torch.Tensor:
        """Uniform elements: draws from ``rng`` in [0, q), taken as
        storage (canonical, or Montgomery form, a bijection of [0, q))."""
        return to_torch(rng.integers(0, self.q, size=shape, dtype=np.uint64),
                        device)

    # -- elementwise ops -----------------------------------------------------
    def add(self, a, b):
        s = a + b
        red = u64_lt(s, a) | ~u64_lt(s, self._Q)
        return torch.where(red, s - self._Q, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(u64_lt(a, b), d + self._Q, d)

    def neg(self, a):
        return torch.where(a == 0, a, self._Q - a)


class Goldilocks(_U64Field):
    """q = 2^64 - 2^32 + 1, canonical values in [0, q) as int64 bits."""

    name = "goldilocks"
    q = 2**64 - 2**32 + 1

    _Q = i64(q)          # q's int64 bit pattern (= -(2^32 - 1))
    _EPS = MASK32        # 2^64 mod q

    # -- host conversions ---------------------------------------------------
    def _scalar(self, v: int) -> int:
        return i64(int(v) % self.q)

    def storage_np(self, ints) -> np.ndarray:
        """python ints / object array -> canonical numpy uint64 storage."""
        arr = np.asarray(ints, dtype=object)
        flat = np.array([int(v) % self.q for v in arr.reshape(-1)],
                        dtype=np.uint64)
        return flat.reshape(arr.shape)

    def from_uint(self, x, device="cuda") -> torch.Tensor:
        """numpy unsigned ints below q -> storage on ``device``."""
        return to_torch(np.asarray(x, dtype=np.uint64), device)

    def reduce_u64(self, x):
        """Any u64 bits -> canonical (for lazy accumulations)."""
        return torch.where(u64_lt(x, self._Q), x, x - self._Q)

    # -- multiplication ------------------------------------------------------
    def _reduce128(self, hi, lo):
        """(hi*2^64 + lo) mod q via 2^64 = 2^32 - 1, 2^96 = -1."""
        hi_hi = shr(hi, 32)
        hi_lo = hi & MASK32
        t0 = lo - hi_hi
        t0 = torch.where(u64_lt(lo, hi_hi), t0 - self._EPS, t0)
        t1 = hi_lo * self._EPS
        t2 = t0 + t1
        t2 = torch.where(u64_lt(t2, t1), t2 + self._EPS, t2)
        return torch.where(u64_lt(t2, self._Q), t2, t2 - self._Q)

    def mul(self, a, b):
        hi, lo = _mul64_128(a, b)
        return self._reduce128(hi, lo)


class BabyBear(_PrimeField):
    """q = 15 * 2^27 + 1 in Montgomery form (R = 2^32), int32 storage."""

    name = "babybear"
    q = 15 * 2**27 + 1
    bits = 31
    dtype = torch.int32

    R = 1 << 32
    QINV = (-pow(q, -1, R)) % R      # -q^-1 mod 2^32, the REDC constant
    _R1 = R % q                      # Montgomery form of 1
    _R2 = R * R % q                  # REDC(u * R2) = Montgomery form of u

    # -- host conversions ---------------------------------------------------
    def _scalar(self, v: int) -> int:
        return int(v) % self.q * self._R1 % self.q

    @staticmethod
    def _codec(arr, device):
        return to_torch_u32(arr, device)

    @staticmethod
    def _raw(v: int) -> int:
        """The storage word whose bits are ``v`` (< q < 2^31)."""
        return v

    def storage_np(self, ints) -> np.ndarray:
        """python ints / object array -> numpy uint32 Montgomery storage,
        byte-equal to the reference's ``encode``."""
        arr = np.asarray(ints, dtype=object)
        flat = np.array([self._scalar(v) for v in arr.reshape(-1)],
                        dtype=np.uint32)
        return flat.reshape(arr.shape)

    def rand(self, shape, rng: np.random.Generator,
             device="cuda") -> torch.Tensor:
        """Uniform elements: draws from ``rng`` in [0, q), taken as
        storage (Montgomery form is a bijection of [0, q))."""
        return to_torch_u32(rng.integers(0, self.q, size=shape,
                                         dtype=np.uint32), device)

    def from_uint(self, x, device="cuda") -> torch.Tensor:
        """numpy unsigned ints (< 2^32) -> storage of x mod q."""
        v = np.asarray(x, dtype=np.uint64) % np.uint64(self.q)
        mont = v * np.uint64(self._R1) % np.uint64(self.q)   # < 2^62
        return to_torch_u32(mont.astype(np.uint32), device)

    # -- Montgomery arithmetic ------------------------------------------------
    def _redc(self, u: torch.Tensor) -> torch.Tensor:
        """REDC of u64 bit patterns (int64): (u + m q) / 2^32 with
        m = u * (-q^-1) mod 2^32, then one conditional subtract; the
        sum wraps mod 2^64 as the reference's u64 does.  int64 result."""
        m = ((u & MASK32) * self.QINV) & MASK32
        t = shr(u + m * self.q, 32)
        return torch.where(t >= self.q, t - self.q, t)

    def mont_mul(self, a, b) -> torch.Tensor:
        """REDC(a * b) for any u32 bit patterns (int32), as int32 bits."""
        u = (a.to(torch.int64) & MASK32) * (b.to(torch.int64) & MASK32)
        return self._redc(u).to(torch.int32)

    def mul(self, a, b):
        return self.mont_mul(a, b)

    def add(self, a, b):
        d = a - (self.q - b)           # in (-q, q): no int32 overflow
        return torch.where(d < 0, d + self.q, d)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.q, d)

    def neg(self, a):
        return torch.where(a == 0, a, self.q - a)

    def canon(self, x):
        """Montgomery storage -> canonical values (int32)."""
        return self._redc(x.to(torch.int64) & MASK32).to(torch.int32)

    def from_canon(self, u):
        """Canonical values (int32) -> Montgomery storage."""
        return self._redc((u.to(torch.int64) & MASK32)
                          * self._R2).to(torch.int32)


class Frog(_U64Field):
    """q = 15912092521325583641 in Montgomery form (R = 2^64), int64
    storage of the u64 words."""

    name = "frog"
    q = 15912092521325583641

    R = 1 << 64
    _Q = i64(q)
    _QP = i64(-pow(q, -1, R))        # -q^-1 mod 2^64, the REDC constant
    _R1 = R % q                      # Montgomery form of 1
    _R2 = i64(R * R % q)             # REDC(u * R2) = Montgomery form of u

    # -- host conversions ---------------------------------------------------
    def _scalar(self, v: int) -> int:
        return i64(int(v) % self.q * self._R1 % self.q)

    def storage_np(self, ints) -> np.ndarray:
        """python ints / object array -> numpy uint64 Montgomery storage,
        byte-equal to the reference's ``encode``."""
        arr = np.asarray(ints, dtype=object)
        flat = np.array([self._scalar(v) for v in arr.reshape(-1)],
                        dtype=np.int64)
        return flat.view(np.uint64).reshape(arr.shape)

    def from_uint(self, x, device="cuda") -> torch.Tensor:
        """numpy unsigned ints (any u64) -> storage of x mod q."""
        return self._mont_mul_raw(to_torch(np.asarray(x, dtype=np.uint64),
                                           device), self._R2)

    # -- Montgomery arithmetic ------------------------------------------------
    def _mont_mul_raw(self, a, b):
        """a*b*2^-64 mod q: REDC of the 128-bit product.  With m = lo *
        (-q^-1) mod 2^64, lo + lo(m*q) is 0 mod 2^64 and carries exactly
        when lo != 0; the high words hi + hi(m*q) + carry are reduced by
        q once if they wrapped past 2^64 or reached q (the reference's
        ``_mont_mul_raw``, bit for bit on any u64 inputs)."""
        hi, lo = _mul64_128(a, b)
        m = lo * self._QP                # wraps mod 2^64 as u64 does
        mq_hi, _ = _mul64_128(m, self._Q)
        t = hi + mq_hi
        wrapped = u64_lt(t, hi)
        t2 = t + (lo != 0).to(torch.int64)
        wrapped = wrapped | u64_lt(t2, t)
        return torch.where(wrapped | ~u64_lt(t2, self._Q), t2 - self._Q, t2)

    def mul(self, a, b):
        return self._mont_mul_raw(a, b)

    def canon(self, x):
        """Montgomery storage -> canonical values."""
        return self._mont_mul_raw(x, 1)

    def from_canon(self, u):
        """Canonical values -> Montgomery storage."""
        return self._mont_mul_raw(u, self._R2)


class Stark(_PrimeField):
    """q = 2^251 + 17 * 2^192 + 1 in Montgomery form (R = 2^256): eight
    little-endian u32 limbs on a trailing axis of ``int32`` storage
    (the reference's ``uint32 [..., 8]``, bit for bit).

    ``mul``, ``add`` and ``sub`` are the kernels S1 and S2 of
    ``ops/stark.py`` on CUDA tensors and their plain twins on CPU
    tensors; everything else is built on them or is host code."""

    name = "stark_prime"
    q = 2**251 + 17 * 2**192 + 1
    bits = 252
    dtype = torch.int32
    N_LIMBS = 8
    limb_shape = (8,)
    limbed = True
    coeff_axis = -2

    R = 1 << 256
    _R1 = R % q                      # Montgomery form of 1
    _R2 = R * R % q                  # mul(u, R2) = Montgomery form of u

    # -- host conversions ---------------------------------------------------
    @staticmethod
    def limbs_np(vals) -> np.ndarray:
        """Python ints below 2^256 -> numpy uint32 [n, 8] little-endian
        limbs."""
        data = b"".join(int(v).to_bytes(32, "little") for v in vals)
        return np.frombuffer(data, dtype="<u4").reshape(-1, 8).copy()

    @staticmethod
    def _codec(arr, device):
        return to_torch_u32(arr, device)

    def storage_np(self, ints) -> np.ndarray:
        """python ints / object array -> numpy uint32 [..., 8] Montgomery
        limbs, byte-equal to the reference's ``encode``."""
        arr = np.asarray(ints, dtype=object)
        q, R1 = self.q, self._R1
        flat = self.limbs_np(int(v) % q * R1 % q for v in arr.reshape(-1))
        return flat.reshape(arr.shape + (8,))

    def const(self, v: int, device="cuda") -> torch.Tensor:
        """One element in storage form, a [8] tensor."""
        return self.encode(np.array(int(v), dtype=object), device)

    def _raw_tensor(self, v: int, device) -> torch.Tensor:
        return to_torch_u32(self.limbs_np([v % self.q])[0], device)

    def zeros(self, shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(shape) + (8,), dtype=self.dtype,
                           device=get_device(device))

    def ones(self, shape=(), device="cuda") -> torch.Tensor:
        return self.const(1, device).expand(tuple(shape) + (8,)).contiguous()

    def _one_like(self, x: torch.Tensor) -> torch.Tensor:
        return self.const(1, x.device).expand(x.shape).contiguous()

    def canon_const(self, v: int) -> torch.Tensor:
        """The canonical limbs of ``v mod q`` (NOT Montgomery form), a CPU
        [8] tensor; :meth:`geq` moves it to the other operand's device."""
        return self._raw_tensor(v, "cpu")

    def decode(self, x: torch.Tensor) -> np.ndarray:
        """storage -> numpy object array of canonical python ints."""
        host = to_numpy_u32(self.canon(x))
        rows = host.reshape(-1, 8).astype("<u4")
        out = np.empty(rows.shape[0], dtype=object)
        out[:] = [int.from_bytes(r.tobytes(), "little") for r in rows]
        return out.reshape(host.shape[:-1])

    def _draw(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """n uniform canonical values as uint32 [n, 8] limbs: 252-bit
        draws from ``rng``, those >= q drawn again."""
        q_limbs = self.limbs_np([self.q])[0]
        out = np.empty((0, 8), dtype=np.uint32)
        while out.shape[0] < n:
            m = 2 * (n - out.shape[0]) + 8
            d = rng.integers(0, 1 << 32, size=(m, 8), dtype=np.uint64)
            d = d.astype(np.uint32)
            d[:, 7] &= np.uint32((1 << (self.bits - 224)) - 1)
            lt = np.zeros(m, dtype=bool)
            decided = np.zeros(m, dtype=bool)
            for j in reversed(range(8)):
                lt |= ~decided & (d[:, j] < q_limbs[j])
                decided |= d[:, j] != q_limbs[j]
            out = np.concatenate([out, d[lt]])
        return out[:n]

    def rand_ints(self, shape, rng: np.random.Generator):
        """Uniform canonical python ints drawn from the numpy Generator:
        an object array of ``shape`` (a python int for ``()``)."""
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        rows = self._draw(n, rng)
        out = np.empty(n, dtype=object)
        out[:] = [int.from_bytes(r.tobytes(), "little") for r in rows]
        return out.reshape(shape) if shape else out[0]

    def rand(self, shape, rng: np.random.Generator,
             device="cuda") -> torch.Tensor:
        """Uniform elements: canonical draws in [0, q) taken as storage
        (Montgomery form is a bijection of [0, q))."""
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        return to_torch_u32(self._draw(n, rng).reshape(tuple(shape) + (8,)),
                            device)

    def from_uint(self, x, device="cuda") -> torch.Tensor:
        """Unsigned ints below 2^32 (numpy, or an integer tensor) ->
        storage of x mod q: the raw limbs times R^2 mod q."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, dtype=np.int64)).to(
                get_device(device))
        return self.mul(self._lift32(x.to(torch.int64) & MASK32),
                        self._raw_tensor(self._R2, x.device))

    # -- limb axis ------------------------------------------------------------
    def take_coeff(self, x: torch.Tensor, idx) -> torch.Tensor:
        """Gather along the coefficient axis, one in from the limbs."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                                  device=x.device)
        return x[..., idx, :]

    @staticmethod
    def select(cond, a, b) -> torch.Tensor:
        """where(cond, a, b) with ``cond`` broadcast over the limbs."""
        return torch.where(cond[..., None], a, b)

    @staticmethod
    def is_zero(x) -> torch.Tensor:
        return (x == 0).all(dim=-1)

    def geq(self, a, b) -> torch.Tensor:
        """a >= b on canonical limbs, lexicographic from the top limb."""
        if a.device != b.device:
            a, b = (a.to(b.device), b) if a.dim() < b.dim() else \
                (a, b.to(a.device))
        a64 = a.to(torch.int64) & MASK32
        b64 = b.to(torch.int64) & MASK32
        ge = decided = None
        for j in reversed(range(8)):
            gt, lt = a64[..., j] > b64[..., j], a64[..., j] < b64[..., j]
            if ge is None:
                ge, decided = gt, gt | lt
            else:
                ge = ge | (~decided & gt)
                decided = decided | gt | lt
        return ge | ~decided

    # -- widened accumulation -------------------------------------------------
    n_words = 8

    def widen(self, x: torch.Tensor) -> torch.Tensor:
        """storage -> int64 [..., 8]: the limbs are the base-2^32 words."""
        return x.to(torch.int64) & MASK32

    def _lift32(self, d: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(d.shape + (8,), dtype=self.dtype, device=d.device)
        out[..., 0] = _ks.i32_bits(d & MASK32)
        return out

    # -- arithmetic (kernels S1 and S2 on the card) ----------------------------
    @staticmethod
    def add(a, b):
        return _ks.stark_add(a, b)

    @staticmethod
    def sub(a, b):
        return _ks.stark_sub(a, b)

    @staticmethod
    def mul(a, b):
        return _ks.stark_mul(a, b)

    def neg(self, a):
        q = self._raw_tensor(self.q, a.device)
        return self.select(self.is_zero(a), torch.zeros_like(a),
                           self.sub(q, a))

    def canon(self, x):
        """Montgomery storage -> canonical limbs: x * 1 * 2^-256."""
        return self.mul(x, self._raw_tensor(1, x.device))

    def from_canon(self, u):
        """Canonical limbs -> Montgomery storage."""
        return self.mul(u, self._raw_tensor(self._R2, u.device))


GOLDILOCKS = Goldilocks()
BABYBEAR = BabyBear()
FROG = Frog()
STARK = Stark()
FIELDS = {"goldilocks": GOLDILOCKS, "babybear": BABYBEAR, "frog": FROG,
          "stark_prime": STARK}


def get_field(name: str):
    """The field called ``name`` (the reference's ``get_field``)."""
    if name in FIELDS:
        return FIELDS[name]
    raise KeyError(f"unknown field {name!r}")
