"""Entry: the batch-trailing model multiply of the Goldilocks ring
F_q[X]/(X^24 - X^12 + 1), ``TModelMul(get_ring(model)).mul_t(at, bt)``
on [24, B] coefficient storage, chained (``harness.ChainedProduct``).
The reference recomputes a checked call's product by schoolbook
multiplication mod X^24 - X^12 + 1 (``reference/cyclotomic24.py``)."""

from __future__ import annotations

from functools import cached_property

import torch

from portbench.harness import ChainedProduct, uniform_words
from portbench.reference.cyclotomic24 import D, Cyclotomic24


class Entry(ChainedProduct):
    def __init__(self, config, traffic, seed, device, program):
        if config["model"] != "goldilocks" or int(config["D"]) != D:
            raise ValueError("model_mul_t: the reference is the Goldilocks "
                             "D = 24 model only")
        self.device = device
        self.units = int(traffic["batch"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.a = uniform_words(gen, (D, self.units), device)
        self.pool = uniform_words(gen, (int(traffic["pool"]), D, self.units),
                                  device)
        if program == "program":
            from stark_rings_tpu_torch import get_ring
            from stark_rings_tpu_torch.ops.model_mul import TModelMul

            self._mul = TModelMul(get_ring(config["model"],
                                           device=device)).mul_t
        elif program == "control":
            self._mul = lambda a, b: self.ref.coeff_mul(a, b, truncated=True)
        else:
            raise ValueError(f"unknown program {program!r}")

    @cached_property
    def ref(self):
        """Built after the window (its tables are not set-up)."""
        return Cyclotomic24(self.device)

    def expected(self, a, b):
        return self.ref.coeff_mul(a, b)
