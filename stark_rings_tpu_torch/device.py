"""Device selection and the storage codecs.

Every entry point of the port runs on the CUDA card unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises,
and nothing falls back to the CPU.

Storage, per field:

* **Goldilocks** (q = 2^64 - 2^32 + 1): a ``torch.int64`` tensor holding
  each element's canonical u64 bit pattern.  torch's ``uint64`` lacks
  add, shift and compare, while ``int64`` add and mul wrap mod 2^64
  exactly as u64 does.  A numpy ``uint64`` array crosses over at zero
  cost through ``.view(np.int64)`` (:func:`to_torch`,
  :func:`to_numpy_u64`); the CUDA kernels read the same bytes as
  ``uint64_t``.
* **BabyBear** (q = 15 * 2^27 + 1): a ``torch.int32`` tensor holding the
  u32 Montgomery form (R = 2^32), exactly the reference's ``uint32``
  storage.  q < 2^31, so every stored value is a non-negative int32;
  products are taken after widening to ``int64`` (a*b < 2^62).  A numpy
  ``uint32`` array crosses over through ``.view(np.int32)``
  (:func:`to_torch_u32`, :func:`to_numpy_u32`); the kernels read
  ``uint32_t``.
* **frog** (q = 15912092521325583641): a ``torch.int64`` tensor holding
  the u64 Montgomery form (R = 2^64), the reference's ``uint64`` storage;
  it crosses over as Goldilocks does.
* **stark_prime** (q = 2^251 + 17 * 2^192 + 1): a ``torch.int32`` tensor
  ``[..., 8]`` holding the eight little-endian u32 limbs of the
  Montgomery form (R = 2^256), the reference's ``uint32 [..., 8]``; it
  crosses over as BabyBear does.  Widen a limb with ``& 0xFFFFFFFF``
  after the cast to ``int64``: a plain cast sign-extends limbs at or
  above 2^31.

:func:`from_jax_storage` maps the reference's numpy storage of any of
the four fields to the port's storage tensor, and
:func:`to_numpy_storage` maps it back.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_device", "to_torch", "to_numpy_u64", "to_torch_u32",
           "to_numpy_u32", "from_jax_storage", "to_numpy_storage"]


def get_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is False); "
                           "pass device='cpu' to run on the CPU")
    return dev


def _from_numpy(x: np.ndarray, udt, sdt, device) -> torch.Tensor:
    arr = np.ascontiguousarray(x, dtype=udt)   # 0-d comes back 1-d
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(sdt)).reshape(np.shape(x)).to(
        get_device(device))


def to_torch(x: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor on ``device`` with the same bits.

    No copy on the CPU when ``x`` is already a writable contiguous uint64
    array (the tensor then shares its memory)."""
    return _from_numpy(x, np.uint64, np.int64, device)


def to_numpy_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (u64 bit patterns) -> numpy uint64 array on the host."""
    if t.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def to_torch_u32(x: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """numpy uint32 array -> int32 tensor on ``device`` with the same bits
    (shares memory on the CPU, as :func:`to_torch`)."""
    return _from_numpy(x, np.uint32, np.int32, device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (u32 bit patterns) -> numpy uint32 array on the host."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def from_jax_storage(field, arr, device="cuda") -> torch.Tensor:
    """The reference's numpy storage of ``field`` (``uint64`` for
    Goldilocks and frog, ``uint32`` for BabyBear and the stark prime's
    limbs) -> the port's storage tensor on ``device``, the same bits."""
    if field.dtype == torch.int32:
        return to_torch_u32(arr, device)
    if field.dtype == torch.int64 and not field.limbed:
        return to_torch(arr, device)
    raise TypeError(f"no storage codec for field {field.name!r}")


def to_numpy_storage(t: torch.Tensor) -> np.ndarray:
    """A storage tensor -> the reference's numpy storage (u64 words for
    int64 tensors, u32 words for int32 ones)."""
    return to_numpy_u32(t) if t.dtype == torch.int32 else to_numpy_u64(t)
