"""Pure-Python integer "spec" layer of the port: a copy of the
reference package's ``spec/`` that imports nothing but the standard
library.

It is the bit-exactness anchor of the ring models: a direct,
arbitrary-precision-integer implementation of the cyclotomic-ring
CRT/ICRT kernels, balanced decomposition and ring arithmetic with the
semantics of the Rust reference (NethermindEth/stark-rings).  The port
uses it to

* derive the constant tables the ring models apply on the device
  (:mod:`..ops.stages`, :mod:`..ops.dense_linear`,
  :mod:`..rings.ring`), and
* serve as a slow oracle in the tests, on the CPU and on the card.

Nothing in here runs on the hot path.
"""

from .field import modinv, modpow
from .models import MODELS, SpecModel, get_model

__all__ = ["modinv", "modpow", "MODELS", "SpecModel", "get_model"]
