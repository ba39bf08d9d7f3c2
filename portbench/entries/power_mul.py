"""Entry: the negacyclic multiply of a power-of-two Goldilocks ring,
``get_power_ring(field, log_n).mxu_ctx().mul(a, b)`` on [B, N] storage,
chained (``harness.ChainedProduct``).  The reference recomputes a
checked call's product by a plain NTT (``reference/negacyclic.py``)."""

from __future__ import annotations

from functools import cached_property

import torch

from portbench.harness import ChainedProduct, uniform_words
from portbench.reference.negacyclic import NegacyclicRef


class Entry(ChainedProduct):
    def __init__(self, config, traffic, seed, device, program):
        if config["field"] != "goldilocks":
            raise ValueError("power_mul: the reference is Goldilocks only")
        self.device = device
        self.n = n = 1 << int(config["log_n"])
        self.units = int(traffic["batch"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.a = uniform_words(gen, (self.units, n), device)
        self.pool = uniform_words(gen, (int(traffic["pool"]), self.units, n),
                                  device)
        if program == "program":
            from stark_rings_tpu_torch import get_power_ring

            ring = get_power_ring(config["field"], int(config["log_n"]),
                                  device=device)
            self._mul = ring.mxu_ctx().mul
        elif program == "control":
            self._mul = lambda a, b: self.ref.mul(a, b, truncated=True)
        else:
            raise ValueError(f"unknown program {program!r}")

    @cached_property
    def ref(self):
        """Built after the window (its tables are not set-up)."""
        return NegacyclicRef(self.n, self.device)

    def expected(self, a, b):
        return self.ref.mul(a, b)
