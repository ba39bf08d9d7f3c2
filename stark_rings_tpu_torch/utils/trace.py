"""Tracing spans (counterpart of ``stark_rings_tpu/utils/trace.py``).

A span names a region of the host's work in the profiler's own timeline.
While no profiler records, :func:`trace_span` returns one shared no-op
context manager after one read of torch's Python-level profiler flag
(``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` and ``emit_nvtx`` set): no range, no NVTX
call, no clock read.  Asking torch's C++ for the profiler's state
instead cost about 0.5 µs more a span inside a multiply on the card's
host.  A profiler started from C++ alone leaves the flag unset and sees
no span.

While a profiler records, the span is a range in its CPU timeline, an
event beside the ``aten::`` ops and runtime calls inside it: its
children name it as their parent (``cpu_parent``), the kernels those
ops launch are tied to them, and the profiler's device activity shares
the range's clock.  Under ``torch.autograd.profiler.emit_nvtx`` torch
turns the range into an NVTX range for the CUDA tools.

The range is a function-scope record (``_RecordFunctionFast``), not a
``record_function`` user range: it leaves no device-side copy of itself
among the profiler's device events, so the device's busy time counts
kernels only, and it costs about a fifth of a user range while traced.

The program's spans, by layer (an outermost span is a call span: every
event under it belongs to that one call):

* calls: ``fold.step``, ``fold.precompute`` (``protocol/folding.py``),
  ``model.mul_t`` (``ops/model_mul.py``), ``mxu.mul`` (``ops/mxu2.py``,
  ``ops/fold.py``);
* the folding step's stages: ``fold.challenge``, ``fold.decompose``,
  ``fold.l2``, ``fold.commit``, ``fold.psi``;
* the model multiply's field arithmetic: ``model.crt``, ``model.icrt``,
  ``model.slot_product`` (every slot product, the E = 1 field products
  of stark_prime included: ``TModelMul.ntt_mul_t`` / ``ntt_mul_bt`` and
  each commit block's products in ``protocol/folding.py``
  ``ntt_matvec``), and ``model.commit_acc``, the blocked commit's
  accumulation (``ops/slot.py`` ``ext_matvec`` and ``ntt_matvec``'s
  E = 1 branch: each block's widened sum and the final fold mod q);
* the engine's transforms: ``mxu.forward``, ``mxu.pointwise``,
  ``mxu.inverse``;
* the digit GEMM's torch work: ``digits.planes``, ``digits.offsets``.

A compiled call (``ops/graphed.py``) runs its Python once, at capture:
its spans fire then, and its replays carry none.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace_span"]

_NO_SPAN = contextlib.nullcontext()


def trace_span(name: str):
    """Context manager naming the region ``name`` in the profiler's
    timeline while a profiler records; the shared no-op otherwise."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled \
        else _NO_SPAN
