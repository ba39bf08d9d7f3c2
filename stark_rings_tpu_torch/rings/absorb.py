"""Fiat-Shamir transcript over canonical field bytes (counterpart of
``stark_rings_tpu/rings/absorb.py``, with the scalar-field cases of
``stark_rings_tpu/utils/serialize.py`` ``elem_nbytes`` and
``elements_to_bytes``).

A field element serializes as its canonical integer, little-endian, in
ceil(bits / 8) bytes: 8 bytes for Goldilocks and frog, 4 for BabyBear,
32 for stark_prime (its eight canonical u32 limbs in order).
The Montgomery fields (BabyBear, frog) are converted to canonical values
first: their storage words are not the values, and writing them would
squeeze other challenges.  The transcript is a
SHAKE-256 sponge on the host; what it absorbs comes off device tensors
(one device-to-host copy per absorb), and the field elements it squeezes
go to the device asked for.  For the same absorbs it squeezes the same
bytes and the same elements as the JAX ``Transcript``.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from ..device import from_jax_storage, to_numpy_storage

__all__ = ["elem_nbytes", "elements_to_bytes", "to_absorb", "Transcript"]


def elem_nbytes(f) -> int:
    return (f.bits + 7) // 8


def elements_to_bytes(f, x, compress: bool = True) -> bytes:
    """Every element of ``x`` (a storage tensor, or the reference's numpy
    storage), row-major, canonical little-endian, no header.  Field
    elements have no compressed form: ``compress`` changes nothing
    (arkworks writes the same bytes in both modes)."""
    if not isinstance(x, torch.Tensor):
        x = from_jax_storage(f, x, "cpu")
    host = to_numpy_storage(f.canon(x))
    if f.limbed:        # 32 bytes an element: the limbs, least first
        return host.astype("<u4").tobytes()
    return host.astype(f"<u{elem_nbytes(f)}").tobytes()


def to_absorb(f, x) -> bytes:
    """Canonical LE bytes of every base-prime-field value in ``x``."""
    return elements_to_bytes(f, x)


class Transcript:
    """SHAKE-256 duplex-style Fiat-Shamir transcript."""

    def __init__(self, domain: bytes = b"stark-rings-tpu"):
        self._state = hashlib.shake_256()
        self._absorb_framed(b"domain", domain)
        self._counter = 0

    def _absorb_framed(self, label: bytes, data: bytes):
        self._state.update(struct.pack("<Q", len(label)) + label)
        self._state.update(struct.pack("<Q", len(data)) + data)

    def absorb_bytes(self, label: bytes, data: bytes):
        self._absorb_framed(label, data)

    def absorb(self, label: bytes, f, x):
        """Absorb a storage tensor's (or numpy storage's) canonical
        bytes."""
        self._absorb_framed(label, to_absorb(f, x))

    def squeeze_bytes(self, n: int) -> bytes:
        self._counter += 1
        h = self._state.copy()
        h.update(struct.pack("<Q", self._counter))
        return h.digest(n)

    def squeeze_field_elements(self, f, n: int, device="cuda"):
        """n uniform canonical field elements, by rejection sampling on
        the squeezed stream, as a storage tensor [n] on ``device``."""
        nb = elem_nbytes(f)
        out = []
        chunk = max(2 * n, 4)
        while len(out) < n:
            data = self.squeeze_bytes(chunk * nb)
            for i in range(chunk):
                if len(out) >= n:
                    break
                v = int.from_bytes(data[i * nb:(i + 1) * nb], "little")
                if v < f.q:
                    out.append(v)
        return f.encode(np.array(out, dtype=object), device)

    def squeeze_ring_element(self, ring, form: str = "coeff"):
        """One uniform ring element: D squeezed field elements as storage
        [D(, L)] on the ring's device (either form: the draw is uniform in
        both)."""
        return self.squeeze_field_elements(ring.field, ring.D, ring.device)
