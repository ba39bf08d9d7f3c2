"""Negacyclic product in F_q[X]/(X^N + 1) over Goldilocks, in plain
PyTorch: twist by psi (a primitive 2N-th root of unity), radix-2 cyclic
NTT, slot products, inverse NTT, untwist with N^-1 folded in.

The roots come from the multiplicative generator 7 of F_q^*; the tables
are Python-int powers.  Rows are independent, so a batch [B, N] runs in
blocks of rows.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

GENERATOR = 7


def _powers(base: int, n: int) -> list[int]:
    out, x = [], 1
    for _ in range(n):
        out.append(x)
        x = x * base % gl.Q
    return out


class NegacyclicRef:
    """a * b mod (X^N + 1, q) for storage [B, N]."""

    def __init__(self, n: int, device):
        if n < 2 or n & (n - 1):
            raise ValueError(f"N = {n} is not a power of two >= 2")
        q = gl.Q
        psi = pow(GENERATOR, (q - 1) // (2 * n), q)
        if pow(psi, n, q) != q - 1:
            raise ValueError("psi is not a primitive 2N-th root of unity")
        omega = psi * psi % q
        n_inv = pow(n, q - 2, q)
        psi_inv = pow(psi, q - 2, q)
        self.n = n
        self.twist = gl.tensor(_powers(psi, n), device)
        self.untwist = gl.tensor([p * n_inv for p in _powers(psi_inv, n)],
                                 device)
        self.fwd = gl.tensor(_powers(omega, n // 2), device)
        self.inv = gl.tensor(_powers(pow(omega, q - 2, q), n // 2), device)
        bits = n.bit_length() - 1
        self.bitrev = torch.tensor(
            [int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)],
            dtype=torch.long, device=device)

    def _ntt(self, x, table, mul):
        rows, n = x.shape
        x = x[:, self.bitrev]
        half = 1
        while half < n:
            tw = table[:: n // (2 * half)][:half]
            y = x.view(rows, n // (2 * half), 2, half)
            u, v = y[:, :, 0], mul(y[:, :, 1], tw)
            x = torch.stack([gl.add(u, v), gl.sub(u, v)], dim=2)
            x = x.reshape(rows, n)
            half *= 2
        return x

    def mul(self, a, b, truncated: bool = False, block: int = 16):
        """Row-wise negacyclic products; ``truncated``: every field
        product at half width (the control)."""
        def fmul(x, y):
            return gl.mul(x, y, truncated)

        if a.shape != b.shape or a.shape[-1] != self.n:
            raise ValueError(f"operands {tuple(a.shape)}, {tuple(b.shape)}"
                             f" are not [B, {self.n}]")
        outs = []
        for s in range(0, a.shape[0], block):
            fa = self._ntt(fmul(a[s:s + block], self.twist), self.fwd, fmul)
            fb = self._ntt(fmul(b[s:s + block], self.twist), self.fwd, fmul)
            c = self._ntt(fmul(fa, fb), self.inv, fmul)
            outs.append(fmul(c, self.untwist))
        return torch.cat(outs)
