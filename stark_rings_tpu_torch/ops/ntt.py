"""Host-side NTT helpers (counterpart of ``stark_rings_tpu/ops/ntt.py``)."""

from __future__ import annotations

from functools import lru_cache

__all__ = ["find_primitive_root"]


def _factorize(n: int):
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            if not fs or fs[-1] != d:
                fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


@lru_cache(maxsize=None)
def find_primitive_root(q: int) -> int:
    """Smallest generator of F_q^* (host, cached)."""
    fs = _factorize(q - 1)
    g = 2
    while True:
        if all(pow(g, (q - 1) // p, q) != 1 for p in fs):
            return g
        g += 1
