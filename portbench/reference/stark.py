"""The Starknet prime q = 2^251 + 17 * 2^192 + 1 in plain PyTorch ops,
on the program's storage words.

The encoding.  q is the modulus of the upstream stark-rings stark_prime
model (crates/ring/src/cyclotomic_ring/models/stark_prime/mod.rs:20-24,
the Cairo / Starknet felt252 prime), which keeps its elements as
arkworks' ``Fp256`` does: the Montgomery residue v * 2^256 mod q (R =
2^256) in little-endian limbs.  The program stores that residue as eight
u32 limbs in an int32 tensor [..., 8] (limbs at or above 2^31 read as
negative int32); :func:`from_storage` and :func:`to_storage` convert.
Every linear map with value (not storage) coefficients acts on the
storage words as on the values, since storage is the value times R.

The arithmetic is this file's own: a value is sixteen 16-bit limbs in
an int64 tensor [..., 16], so that every limb product (below 2^32) and
every sum of up to 2^31 of them is exact in int64, and a product of two
values is a schoolbook convolution of their limbs into 31 columns.
:func:`reduce` takes any signed columns back to the canonical limbs of
the value mod q through q's sparse form: 2^251 = -(17 * 2^192 + 1) mod
q, so the part H above 2^251 folds in as -H (17 * 2^192 + 1), which is
limb-aligned (192 = 12 * 16) and shrinks the value by about 55 bits a
round; once |H| < 2^50 one fold leaves the value in (-q, 2q) and one
conditional add or subtract of q ends it.  Nothing here is a
Montgomery REDC: the factor 2^-256 of a storage product is one more
product by the constant 2^-256 mod q.

Departures from upstream, none from its values: limbs of 16 bits in
int64 instead of arkworks' four u64 limbs; the reduction above instead
of arkworks' Montgomery multiplication; products of storage words
taken as integers and then scaled by 2^-256 mod q.

``truncated=True`` keeps only the low 16 columns of a product's
convolution (the product at half its width): the control that the
benchmark's comparison has to reject.

This file is the benchmark's yardstick: it imports nothing of the
program under test.
"""

from __future__ import annotations

import torch

Q = 2**251 + 17 * 2**192 + 1
R = (1 << 256) % Q                 # the storage word of 1
R_INV = pow(1 << 256, -1, Q)       # 2^-256 mod q
N = 16                             # 16-bit limbs of a value
M16 = 0xFFFF
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# ints and limbs
# ---------------------------------------------------------------------------

def to_limbs(ints, device="cpu") -> torch.Tensor:
    """Python ints in [0, 2^256) (a list, nested lists, or one int) ->
    int64 [..., 16] limbs."""
    if isinstance(ints, int):
        return torch.tensor([(ints >> (16 * j)) & M16 for j in range(N)],
                            dtype=torch.int64, device=device)
    return torch.stack([to_limbs(v, device) for v in ints])


def from_limbs(x: torch.Tensor):
    """int64 [..., n] limbs (any n, each in [0, 2^16)) -> Python ints
    (nested lists, or one int for [n])."""
    if x.dim() == 1:
        return sum(int(v) << (16 * j) for j, v in enumerate(x.tolist()))
    return [from_limbs(r) for r in x]


def from_storage(x: torch.Tensor) -> torch.Tensor:
    """Program storage int32 [..., 8] -> the stored integer (the
    Montgomery residue, not the value) as limbs int64 [..., 16]."""
    w = x.to(torch.int64) & M32
    return torch.stack([w & M16, w >> 16], dim=-1).reshape(
        x.shape[:-1] + (N,))


def to_storage(v: torch.Tensor) -> torch.Tensor:
    """Limbs int64 [..., 16] of an integer below 2^256 -> int32 [..., 8]
    u32 limbs of program storage."""
    w = v.reshape(v.shape[:-1] + (8, 2))
    u = w[..., 0] | (w[..., 1] << 16)
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


# ---------------------------------------------------------------------------
# reduction
# ---------------------------------------------------------------------------

def _normalize(cols: list, n: int) -> list:
    """Signed columns (int64 tensors, sum_j c_j 2^(16 j)) -> max(n,
    len(cols)) limbs in [0, 2^16) and last a signed top word: the same
    integer, two's complement above the limbs (the top word is 0 or -1
    where the limbs cover the value's bits)."""
    out, carry = [], None
    for j in range(max(n, len(cols))):
        t = cols[j] if j < len(cols) else torch.zeros_like(cols[0])
        if carry is not None:
            t = t + carry
        out.append(t & M16)
        carry = t >> 16                       # floor: signed carries
    return out + [carry]


def reduce(cols: torch.Tensor, col_bits: int) -> torch.Tensor:
    """int64 [..., n] signed base-2^16 columns, each |c| < 2^col_bits
    (col_bits <= 61) -> the canonical limbs [..., 16] of their value mod
    q."""
    c = list(cols.unbind(-1))
    zero = torch.zeros_like(c[0])
    bits = col_bits + 16 * (len(c) - 1) + 1      # |value| < 2^bits
    while bits > 251:
        limbs = _normalize(c, max(16, (bits + 15) // 16))
        # value = H 2^251 + lo with 0 <= lo < 2^251; H's columns, each
        # below 2^22 in size (the top one signed)
        lo = limbs[:15] + [limbs[15] & 0x7FF]
        h = [limbs[15] >> 11] + [x << 5 for x in limbs[16:]]
        h = [h[0] + h[1]] + h[2:]
        # lo - H (17 2^192 + 1): columns below 2^27 in size
        c = lo + [zero] * max(0, 12 + len(h) - N)
        for i, hi in enumerate(h):
            c[i] = c[i] - hi
            c[12 + i] = c[12 + i] - 17 * hi
        if bits - 251 <= 50:     # |H| 17 2^192 < 2^248: in (-2^248, 2q)
            break
        bits = max(251, bits - 54) + 1
    # one q in or out
    qc = to_limbs(Q, zero.device).tolist()
    limbs = _normalize(c, 17)
    neg = limbs[-1] < 0            # then value = lo - 2^256, lo + q >= 2^256
    x = _normalize([v + torch.where(neg, qc[j], 0)
                    for j, v in enumerate(limbs[:N])], N)[:N]
    d = _normalize([v - qc[j] for j, v in enumerate(x)], N)
    keep = d[-1] < 0                            # x < q
    return torch.stack([torch.where(keep, a, b) for a, b in zip(x, d[:N])],
                       dim=-1)


# ---------------------------------------------------------------------------
# field operations on canonical limbs
# ---------------------------------------------------------------------------

def conv(a: torch.Tensor, b: torch.Tensor, truncated: bool = False):
    """Schoolbook product columns of limbs [..., 16] x [..., 16]
    (broadcasting) -> int64 [..., 31] (each below 2^36), or the low 16
    columns only with ``truncated``."""
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    width = N if truncated else 2 * N - 1
    out = torch.zeros(shape + (width,), dtype=torch.int64, device=a.device)
    for i in range(N):
        n = min(N, width - i)
        out[..., i:i + n] += a[..., i:i + 1] * b[..., :n]
    return out


def mul(a, b, truncated: bool = False):
    """a b mod q on canonical limbs."""
    return reduce(conv(a, b, truncated), 36)


def add(a, b):
    return reduce(a + b, 17)


def sub(a, b):
    return reduce(a - b, 17)


def from_signed(x: torch.Tensor) -> torch.Tensor:
    """Integers |x| < 2^47 (int64 [...]) -> the canonical limbs of x mod
    q."""
    return reduce(torch.stack([x & M16, (x >> 16) & M16, x >> 32], dim=-1),
                  16)


def scale(x, c: int, truncated: bool = False):
    """c x mod q for a constant value c (a Python int)."""
    return mul(x, to_limbs(c % Q, x.device), truncated)


def to_values(x: torch.Tensor) -> torch.Tensor:
    """Program storage int32 [..., 8] -> canonical limbs of the value
    (storage times 2^-256 mod q)."""
    return scale(from_storage(x), R_INV)


def value_storage(v: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of a value -> its program storage int32 [..., 8]."""
    return to_storage(scale(v, R))


def signed_storage_table(lo: int, hi: int, device) -> torch.Tensor:
    """int32 [hi - lo + 1, 8]: the storage of every integer in [lo, hi]
    (row d - lo for d), from Python ints."""
    rows = []
    for d in range(lo, hi + 1):
        s = d % Q * R % Q
        rows.append([(s >> (32 * j)) & M32 for j in range(8)])
    t = torch.tensor(rows, dtype=torch.int64, device=device)
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)
