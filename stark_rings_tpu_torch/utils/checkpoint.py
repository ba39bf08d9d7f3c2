"""Checkpoint and resume of storage tensors (counterpart of
``stark_rings_tpu/utils/checkpoint.py``).

One ``.npz`` holds named tensors as their canonical values (the
reference's numpy storage of ``canon``: u64 for Goldilocks and frog,
u32 for BabyBear, u32 [..., 8] limbs for the stark prime) and the field
name under ``__field__``.  The values do not depend on Montgomery
factors, which are derived again from the field name on load; the file
layout is the reference's, so a file saved by either package loads in
the other.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..device import from_jax_storage, get_device, to_numpy_storage
from ..fields import get_field

__all__ = ["save_tensors", "load_tensors"]


def save_tensors(path, field_name: str, **tensors):
    """Save named storage tensors (as canonical values) to one .npz;
    returns the path."""
    f = get_field(field_name)
    out = {k: to_numpy_storage(f.canon(v)) for k, v in tensors.items()}
    path = pathlib.Path(path)
    np.savez(path, __field__=np.array(field_name), **out)
    return path


def load_tensors(path, device="cuda"):
    """-> (field name, dict of storage tensors on ``device``)."""
    dev = get_device(device)
    with np.load(path, allow_pickle=False) as data:
        field_name = str(data["__field__"])
        f = get_field(field_name)
        out = {k: f.from_canon(from_jax_storage(f, data[k], dev))
               for k in data.files if k != "__field__"}
    return field_name, out
