"""K8: the twiddle-fused transpose exchange of the sharded four-step NTT
(counterpart of ``stark_rings_tpu/parallel/pallas_exchange.py``).

Sharded data is a list of P shard tensors (:mod:`.mesh`).  With
R1 = N1 / P and C = N2 / P:

* :func:`twiddle_exchange_fwd` takes shard s's [B, N1, C] columns after
  the column NTT and its twiddle table [N1, C], and returns shard d's
  [B, R1, N2] rows: ``all_to_all(f.mul(x, tw))``, rows split, columns
  concatenated;
* :func:`twiddle_exchange_inv` is the mirror: [B, R1, N2] rows and a
  [R1, N2] table in, [B, N1, C] columns out.

Batchless [N1, C] / [R1, N2] shards go through as B = 1.  The fields are
Goldilocks (canonical u64 in int64) and BabyBear (u32 Montgomery in
int32; the kernel's Montgomery product is the field's ``mul`` on that
storage, so the twiddle table is used as it is stored).

Dispatch, as every kernel wrapper of the port: CPU shards go to the
plain twins (``*_ref``: the field's ``mul``, then :func:`all_to_all`);
CUDA shards that all lie on one card go to ``csrc/exchange.cu``, one
launch per exchange, counted in ``LAUNCHES["twiddle_exchange_<fwd|inv>_
<field>"]``, or raise.  CUDA shards on several cards raise: K8 launched
per source device into peer memory is ROADMAP queue 1 step 6.  Nothing
falls back to the twin on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.field import FIELDS
from ..ops import _build

__all__ = ["twiddle_exchange_fwd", "twiddle_exchange_inv",
           "twiddle_exchange_fwd_ref", "twiddle_exchange_inv_ref",
           "all_to_all", "EXCHANGE_FIELDS", "LAUNCHES", "reset_launches"]

#: the fields K8 runs over (an in-kernel modmul on their storage)
EXCHANGE_FIELDS = ("goldilocks", "babybear")
_MAX_P = 64                 # shards per launch (the pointer tables)

LAUNCHES = {f"twiddle_exchange_{d}_{field}": 0
            for field in EXCHANGE_FIELDS for d in ("fwd", "inv")}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def all_to_all(xs, split_axis: int, concat_axis: int):
    """The block transpose of P shards: shard d of the result is the
    concatenation along ``concat_axis`` of block d of every shard, cut
    along ``split_axis`` (``jax.lax.all_to_all(..., tiled=True)``); block
    s of it lands on shard d's device."""
    P = len(xs)
    n = xs[0].shape[split_axis] // P
    return [torch.cat([x.narrow(split_axis, d * n, n).to(xs[d].device)
                       for x in xs], dim=concat_axis) for d in range(P)]


def twiddle_exchange_fwd_ref(xs, tws, field: str = "goldilocks"):
    """Plain twin of :func:`twiddle_exchange_fwd`."""
    f = FIELDS[field]
    return all_to_all([f.mul(x, t) for x, t in zip(xs, tws)], -2, -1)


def twiddle_exchange_inv_ref(ys, tws, field: str = "goldilocks"):
    """Plain twin of :func:`twiddle_exchange_inv`."""
    f = FIELDS[field]
    return all_to_all([f.mul(y, t) for y, t in zip(ys, tws)], -1, -2)


def _log2(name, what, n) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name}: {what} = {n} is not a power of two")
    return n.bit_length() - 1


def _exchange(name, xs, tws, field, inverse):
    """Check the shards, dispatch, and on the card launch K8 once."""
    if field not in EXCHANGE_FIELDS:
        raise ValueError(f"{name}: no exchange kernel for field {field!r} "
                         f"(have {list(EXCHANGE_FIELDS)})")
    f = FIELDS[field]
    xs, tws = list(xs), list(tws)
    P = len(xs)
    if not 1 <= P <= _MAX_P or len(tws) != P:
        raise ValueError(f"{name}: need 1 to {_MAX_P} shards and one "
                         f"twiddle table per shard, got {P} and {len(tws)}")
    nd = xs[0].dim()
    if nd not in (2, 3) or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: shards must share one [B, rows, cols] "
                         "or [rows, cols] shape")
    B, rows, cols = (1,) * (3 - nd) + tuple(xs[0].shape)
    if inverse:        # [B, R1, N2] rows, [R1, N2] twiddles
        N1, N2 = rows * P, cols
    else:              # [B, N1, C] columns, [N1, C] twiddles
        N1, N2 = rows, cols * P
    if N1 % P or N2 % P:
        raise ValueError(f"{name}: P = {P} must divide the rows and the "
                         "columns")
    for t in (*xs, *tws):
        if t.dtype != f.dtype:
            raise TypeError(f"{name}: {field} storage is {f.dtype}, got "
                            f"{t.dtype}")
    if any(tuple(t.shape) != (rows, cols) for t in tws):
        raise ValueError(f"{name}: twiddle tables must be [{rows}, {cols}]")
    name = f"{name}_{field}"
    devices = {t.device for t in (*xs, *tws)}
    types = {d.type for d in devices}
    if types == {"cpu"}:
        twin = twiddle_exchange_inv_ref if inverse \
            else twiddle_exchange_fwd_ref
        return twin(xs, tws, field)
    if types != {"cuda"}:
        raise ValueError(f"{name}: shards on {sorted(map(str, devices))}: "
                         "all on the CPU or all on CUDA")
    if len(devices) > 1:
        raise NotImplementedError(
            f"{name}: shards on several cards "
            f"{sorted(map(str, devices))}: K8 launched per source device "
            "into peer memory is not ported yet (ROADMAP queue 1 step 6)")
    if not all(t.is_contiguous() for t in (*xs, *tws)):
        raise ValueError(f"{name}: shards and twiddles must be contiguous")
    log_n1, log_n2, log_p = (_log2(name, w, n) for w, n in
                             (("N1", N1), ("N2", N2), ("P", P)))
    out_shape = (B, N1 // P if not inverse else N1,
                 N2 if not inverse else N2 // P)[3 - nd:]
    # every output is live before the launch: that is the reference's
    # barrier (pallas_exchange.py:101-107) in one process
    outs = torch.empty((P, *out_shape), dtype=f.dtype,
                       device=xs[0].device).unbind(0)
    ptrs = ctypes.c_void_p * P
    lib = _build.kernels()
    _build.launch(LAUNCHES, name, getattr(lib, f"srt_twiddle_exchange_"
                                          f"{field}"), xs[0].device,
                  ptrs(*[x.data_ptr() for x in xs]),
                  ptrs(*[t.data_ptr() for t in tws]),
                  ptrs(*[o.data_ptr() for o in outs]), P, B, log_n1, log_n2,
                  log_p, int(inverse))
    return list(outs)


def twiddle_exchange_fwd(xs, tws, field: str = "goldilocks"):
    """Fused (mid-twiddle * x) and transpose exchange, forward direction:
    P shards [B, N1, C] (or [N1, C]) and their twiddle tables [N1, C] ->
    P shards [B, N1/P, N2] (or [N1/P, N2])."""
    return _exchange("twiddle_exchange_fwd", xs, tws, field, False)


def twiddle_exchange_inv(ys, tws, field: str = "goldilocks"):
    """Fused (y * inverse twiddle) and transpose exchange, inverse
    direction: P shards [B, R1, N2] (or [R1, N2]) and their tables
    [R1, N2] -> P shards [B, R1*P, N2/P] (or [R1*P, N2/P])."""
    return _exchange("twiddle_exchange_inv", ys, tws, field, True)
