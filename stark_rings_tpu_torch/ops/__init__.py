"""Ring-multiply engines and their kernels (counterpart of
``stark_rings_tpu/ops``): the CRT stage tables, the radix NTT, the
batch-trailing model multiply, and the hand kernels behind them.

The reference's names resolve on first access: the field layer imports
``ops.stark`` while it loads, and ``model_mul`` needs the loaded
fields, so importing them here eagerly would be circular."""

import importlib

_HOMES = {"StageTable": "stages", "derive_linear_table": "stages",
          "derive_stage_tables": "stages", "NTTContext": "ntt",
          "get_ntt": "ntt", "find_primitive_root": "ntt",
          "TModelMul": "model_mul"}

__all__ = list(_HOMES)


def __getattr__(name):
    if name in _HOMES:
        return getattr(importlib.import_module(f".{_HOMES[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_HOMES))
