"""Power-of-two (nega)cyclic radix-2/4 NTT for any degree and any ported
field (counterpart of ``stark_rings_tpu/ops/ntt.py``); the 8-limb
stark_prime's limb axis trails the coefficient axis.

The recursion X^{2t} - z^2 = (X^t - z)(X^t + z) runs as log2(N) radix-2
levels, two at a time (radix 4), each one reshape and a few broadcast
field ops over the whole batch.  Outputs are in the reference's **leaf
order** (``leaf_exps``), with no bit reversal; the slot product and the
inverse use the same order, so ring multiplication is exact.

The stage tables are built on the host with Python ints and uploaded
once; the reference builds them on its device by log-doubling powers of
psi.  Only the values matter, and they are equal.  The transforms use
butterflies alone (no digit GEMM), which makes this the independent
oracle engine of the digit-GEMM multipliers.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..device import get_device
from ..fields import get_field

__all__ = ["NTTContext", "get_ntt", "find_primitive_root"]


def _is_prime(n: int) -> bool:
    """Miller-Rabin on the first twelve prime bases (exact below 3.3e24,
    far past the cofactors of q - 1 this module factors)."""
    if n < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
    if n in bases:
        return True
    if any(n % p == 0 for p in bases):
        return False
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _split(n: int) -> int:
    """A nontrivial factor of the odd composite n (Pollard's rho)."""
    c = 1
    while True:
        x = y = 2
        d = 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d
        c += 1


def _factorize(n: int):
    """The distinct prime factors of n, in increasing order: trial
    division by small primes, then Pollard's rho on what is left (plain
    trial division of stark_prime's q - 1 runs to 9.9e7)."""
    fs = set()
    for p in range(2, 1000):
        while n % p == 0:
            fs.add(p)
            n //= p
    todo = [n] if n > 1 else []
    while todo:
        m = todo.pop()
        if _is_prime(m):
            fs.add(m)
        else:
            d = _split(m)
            todo += [d, m // d]
    return sorted(fs)


@lru_cache(maxsize=None)
def find_primitive_root(q: int) -> int:
    """Smallest generator of F_q^* (host, cached)."""
    fs = _factorize(q - 1)
    g = 2
    while True:
        if all(pow(g, (q - 1) // p, q) != 1 for p in fs):
            return g
        g += 1


def _powers(base: int, n: int, q: int) -> list[int]:
    out, v = [], 1
    for _ in range(n):
        out.append(v)
        v = v * base % q
    return out


class NTTContext:
    """(Nega)cyclic NTT of fixed size N over one field, on ``device``."""

    def __init__(self, field, N: int, negacyclic: bool = True,
                 device="cuda"):
        if N < 2 or N & (N - 1):
            raise ValueError(f"N={N} must be a power of two >= 2")
        order = 2 * N
        if (field.q - 1) % order:
            raise ValueError(f"{field.name}: 2N={order} must divide q-1")
        self.f = field
        self.N = N
        self.negacyclic = negacyclic
        self.logN = N.bit_length() - 1
        self.device = get_device(device)
        g = find_primitive_root(field.q)
        self.psi_int = pow(g, (field.q - 1) // order, field.q)
        self.psi_inv_int = pow(self.psi_int, order - 1, field.q)

        # stage exponent lists (host ints; exponents are mod 2N)
        blocks = [N if negacyclic else 0]
        self.stage_exps: list[list[int]] = []
        while len(blocks) < N:
            self.stage_exps.append([e // 2 for e in blocks])
            blocks = [v for e in blocks for v in (e // 2, e // 2 + N)]
        # leaf i evaluates at psi^{blocks[i]} (for cyclic: omega^{b/2})
        self.leaf_exps = blocks
        self._tables = None

    def tables(self):
        """(forward stage tables, inverse stage tables, 1/N) in storage
        form on the device, built on first use."""
        if self._tables is None:
            f, q, dev = self.f, self.f.q, self.device
            fwd_pows = _powers(self.psi_int, 2 * self.N, q)
            inv_pows = _powers(self.psi_inv_int, 2 * self.N, q)
            fwd = [f.encode([fwd_pows[e] for e in ex], dev)
                   for ex in self.stage_exps]
            inv = [f.encode([inv_pows[e] for e in ex], dev)
                   for ex in self.stage_exps]
            self._tables = (fwd, inv, f.const(pow(self.N, q - 2, q), dev))
        return self._tables

    # -- shape helpers -----------------------------------------------------
    def _split(self, x, m: int, k: int):
        """[..., N(, L)] -> the k parts of each of the m blocks,
        [..., m, t(, L)]."""
        limb = self.f.limb_shape
        nd = len(limb)
        view = x.reshape(x.shape[:x.dim() - 1 - nd]
                         + (m, k, self.N // (k * m)) + limb)
        return tuple(view.select(view.dim() - 2 - nd, i) for i in range(k))

    def _merge(self, parts):
        limb = self.f.limb_shape
        nd = len(limb)
        view = torch.stack(parts, dim=-2 - nd)
        return view.reshape(view.shape[:view.dim() - 3 - nd] + (self.N,)
                            + limb)

    # -- transforms --------------------------------------------------------
    def forward(self, x):
        """coeff -> leaf-order evaluations; batched over leading axes."""
        f = self.f
        fwd, _, _ = self.tables()
        s = 0
        if self.logN % 2:
            a, b = self._split(x, 1, 2)
            wb = f.mul(fwd[0][:, None], b)
            x = self._merge((f.add(a, wb), f.sub(a, wb)))
            s = 1
        while s < self.logN:
            m = 1 << s
            w = fwd[s][:, None]
            w0 = fwd[s + 1][0:2 * m:2, None]
            w1 = fwd[s + 1][1:2 * m:2, None]
            p0, p1, p2, p3 = self._split(x, m, 4)
            wb0 = f.mul(w, p2)
            wb1 = f.mul(w, p3)
            u0a, u0b = f.add(p0, wb0), f.add(p1, wb1)
            u1a, u1b = f.sub(p0, wb0), f.sub(p1, wb1)
            t0 = f.mul(w0, u0b)
            t1 = f.mul(w1, u1b)
            x = self._merge((f.add(u0a, t0), f.sub(u0a, t0),
                             f.add(u1a, t1), f.sub(u1a, t1)))
            s += 2
        return x

    def inverse(self, x):
        """leaf-order evaluations -> coeff."""
        f = self.f
        _, inv, n_inv = self.tables()
        s = self.logN - 2
        while s >= self.logN % 2:
            m = 1 << s
            w = inv[s][:, None]
            w0 = inv[s + 1][0:2 * m:2, None]
            w1 = inv[s + 1][1:2 * m:2, None]
            y0, y1, y2, y3 = self._split(x, m, 4)
            u0a = f.add(y0, y1)
            u0b = f.mul(w0, f.sub(y0, y1))
            u1a = f.add(y2, y3)
            u1b = f.mul(w1, f.sub(y2, y3))
            x = self._merge((f.add(u0a, u1a), f.add(u0b, u1b),
                             f.mul(w, f.sub(u0a, u1a)),
                             f.mul(w, f.sub(u0b, u1b))))
            s -= 2
        if self.logN % 2:
            a, b = self._split(x, 1, 2)
            x = self._merge((f.add(a, b),
                             f.mul(inv[0][:, None], f.sub(a, b))))
        return f.mul(x, n_inv)

    def mul(self, a, b):
        """Negacyclic/cyclic ring multiply: NTT -> pointwise -> INTT."""
        return self.inverse(self.f.mul(self.forward(a), self.forward(b)))

    def square(self, a):
        """a*a with ONE forward transform."""
        fa = self.forward(a)
        return self.inverse(self.f.mul(fa, fa))

    def pointwise(self, fa, fb):
        return self.f.mul(fa, fb)


_CTX = {}


def get_ntt(field_name: str, N: int, negacyclic: bool = True,
            device="cuda") -> NTTContext:
    key = (field_name, N, negacyclic, str(get_device(device)))
    if key not in _CTX:
        _CTX[key] = NTTContext(get_field(field_name), N, negacyclic, device)
    return _CTX[key]
