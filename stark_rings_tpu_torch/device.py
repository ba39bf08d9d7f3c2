"""Device selection and the u64 storage codec.

A Goldilocks element is stored as a ``torch.int64`` tensor holding the
element's u64 bit pattern: torch's ``uint64`` lacks add, shift and
compare, while ``int64`` add and mul wrap mod 2^64 exactly as u64 does.
A numpy ``uint64`` array crosses over at zero cost through
``.view(np.int64)``; the CUDA kernels read the same bytes as
``uint64_t``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_device", "to_torch", "to_numpy_u64"]


def get_device(device: str | torch.device = "cpu") -> torch.device:
    """``torch.device(device)``, raising if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False)")
    return dev


def to_torch(x: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor on ``device`` with the same bits.

    No copy on the CPU when ``x`` is already a writable contiguous uint64
    array (the tensor then shares its memory)."""
    arr = np.ascontiguousarray(x, dtype=np.uint64)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int64)).to(get_device(device))


def to_numpy_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (u64 bit patterns) -> numpy uint64 array on the host."""
    if t.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint64)
