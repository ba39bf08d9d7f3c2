"""The folding step's digit stage as one hand-written CUDA kernel a field
(``csrc/digits.cu``): the balanced base-b digits of the folded witness,
each witness's exact L2 sum and the psi range check of every digit, in
one pass over the coefficients.  ``step_digits`` takes Goldilocks' u64
words, ``bb_step_digits`` BabyBear's u32 Montgomery words; both launch
from :func:`step_digits`, whose twin is :func:`step_digits_ref` with
:func:`check_psi`'s torch path.

The twin is the three stages as torch ops: :func:`..decomp.decompose`,
:func:`..decomp.norms.l2_check` and
:func:`..rings.monomial.psi_range_check_batched` (the reference's XLA
ops, ``decomp/balanced.py``, ``decomp/norms.py``, ``rings/monomial.py``).
:func:`step_digits` takes the kernel when :func:`uses_digit_kernel`
holds, which reads only the input: the field, the device, the base and
the shapes; every other input (frog, stark_prime, CPU tensors, a base
out of the kernel's range, sums that could pass 2^64) runs the twin.
The kernel writes the digits, each witness's L2 sum as a u64 word and
its count of coefficients with a digit that fails psi; two [W] compares
turn them into ``ok_l2`` and ``ok_psi``.  Integer sums are exact, so
every output equals the twin's bit for bit.  Every launch adds one to
``LAUNCHES[<kernel name>]``.
"""

from __future__ import annotations

import torch

from ..decomp import decompose
from ..decomp.norms import l2_check
from ..fields.field import BabyBear, Goldilocks, i64, u64_lt
from ..rings.monomial import _ct_psi_table, psi_range_check_batched
from ..utils.trace import trace_span
from . import _build

__all__ = ["uses_digit_kernel", "step_digits", "step_digits_ref",
           "check_psi", "l2_within", "LAUNCHES", "reset_launches"]

LAUNCHES = {"step_digits": 0, "bb_step_digits": 0}

SPAN = 1024                 # csrc/digits.cu: coefficients a block
MAX_K = 64                  # and digits a coefficient
TABLE_BYTES = 48 * 1024     # psi's table in a block's shared memory
U64_MAX = (1 << 64) - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def uses_digit_kernel(field, shape, device, base: int, k: int,
                      psi: bool) -> bool:
    """Whether the digit stage of coefficients of ``shape`` [D, W, L] on
    ``device`` runs on this module's kernels: Goldilocks or BabyBear
    storage on a CUDA device, an even base 2 <= b < 2^31, 1 <= k <= 64
    (a block stages its digits in shared memory; base 2 takes 63 on
    Goldilocks), every witness's L2 sum below 2^64 (D L k (b/2)^2 <
    2^64: every digit has |d| <= b/2), and with ``psi`` a D-word table
    of at most 48 KB."""
    if not isinstance(field, (Goldilocks, BabyBear)) or len(shape) != 3 \
            or torch.device(device).type != "cuda":
        return False
    D, _, L = shape
    return (base % 2 == 0 and 2 <= base < 2**31 and 1 <= k <= MAX_K
            and D * L * k * (base // 2) ** 2 <= U64_MAX
            and (not psi or D * field.dtype.itemsize <= TABLE_BYTES))


def step_digits_ref(ring, coeff, base: int, k: int, l2_bound_sq: int):
    """Plain twin of :func:`step_digits`: ``decompose`` and ``l2_check``
    in torch ops, each under its span; -> (dt, ok_l2, None), psi left to
    :func:`check_psi`."""
    f = ring.field
    with trace_span("fold.decompose"):
        # [D, W, L, k(, l)]; digit j of column l -> gadget column l*k + j
        # (mod.rs:163-175)
        dig = decompose(f, coeff, base, k)
        dt = dig.reshape(dig.shape[:2] + (coeff.shape[2] * k,)
                         + f.limb_shape)
    with trace_span("fold.l2"):
        ok_l2 = l2_check(f, dt, l2_bound_sq, axis=(0, 2))      # [W]
    return dt, ok_l2, None


def step_digits(ring, coeff, base: int, k: int, l2_bound_sq: int,
                psi: bool):
    """The step's digit stage: coeff [D, W, L] (the ICRT's storage words)
    -> (dt [D, W, L k] storage words, digit j of column l at l k + j;
    ok_l2 [W], ||digits of w||_2^2 <= ``l2_bound_sq``; the kernel's
    count [W] of coefficients with a digit that fails psi when ``psi``,
    else None).  :func:`check_psi` turns the third into ``ok_psi``.  The
    kernel's launch runs under the ``fold.decompose`` span, its [W]
    compare under ``fold.l2``."""
    f = ring.field
    if not uses_digit_kernel(f, tuple(coeff.shape), coeff.device, base, k,
                             psi):
        return step_digits_ref(ring, coeff, base, k, l2_bound_sq)
    name = "step_digits" if isinstance(f, Goldilocks) else "bb_step_digits"
    D, W, L = coeff.shape
    if coeff.dtype != f.dtype or D != ring.D:
        raise ValueError(f"{name}: expected {f.dtype} coefficients [{ring.D}"
                         f", W, L], got {coeff.dtype} {tuple(coeff.shape)}")
    chunks = -(-L // SPAN)
    if D * W * chunks >= 2**31:
        raise ValueError(f"{name}: shape {tuple(coeff.shape)} exceeds the "
                         "kernel's grid")
    dev = coeff.device
    with trace_span("fold.decompose"):
        coeff = coeff.contiguous()
        dt = torch.empty((D, W, L * k), dtype=f.dtype, device=dev)
        res = torch.empty((2, W), dtype=torch.int64, device=dev)
        if coeff.numel():
            tbl = _ct_psi_table(ring) if psi else None
            if psi and tbl.device != dev:
                raise ValueError(f"{name}: the psi table is on {tbl.device}, "
                                 f"the coefficients on {dev}")
            stream = torch._C._cuda_getCurrentRawStream(dev.index)
            tickets, _, partials, _ = _build.work(dev, stream, W,
                                                  2 * W * D * chunks)
            pow2 = base & (base - 1) == 0
            _build.launch(LAUNCHES, name,
                          getattr(_build.kernels(), "srt_" + name), dev,
                          coeff.data_ptr(), dt.data_ptr(),
                          tbl.data_ptr() if psi else 0, D, W, L, k, base,
                          base.bit_length() - 1 if pow2 else -1, int(psi),
                          partials, tickets, res.data_ptr(), stream=stream)
        else:
            res.zero_()
    with trace_span("fold.l2"):
        ok_l2 = l2_within(res[0], l2_bound_sq)
    return dt, ok_l2, (res[1] if psi else None)


def l2_within(sums, l2_bound_sq: int):
    """sum <= bound on the kernel's u64 sums (int64 words): a bound of
    2^64 or more always holds."""
    return ~u64_lt(i64(min(l2_bound_sq, U64_MAX)), sums)


def check_psi(ring, dt, fails):
    """ok_psi [W] of the step's digits dt [D, W, M]: every digit of a
    witness passes the psi range check (monomial.rs:82-93).  ``fails`` is
    :func:`step_digits`'s count of failing coefficients when the kernel
    ran, or None: then the check runs in torch ops
    (:func:`..rings.monomial.psi_range_check_batched`)."""
    if fails is not None:
        return fails == 0
    return psi_range_check_batched(ring, dt).all(dim=2).all(dim=0)
