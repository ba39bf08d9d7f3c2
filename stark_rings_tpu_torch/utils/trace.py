"""Tracing spans (counterpart of ``stark_rings_tpu/utils/trace.py``).

A span names a region in ``torch.profiler`` traces (its CPU timeline)
and, where CUDA is present, in NVTX as well (the CUDA tools' timelines);
with ``log`` it also reports the region's wall time.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["trace_span"]


@contextlib.contextmanager
def trace_span(name: str, log=None):
    """Context manager: names the region for the profiler and NVTX and,
    with ``log``, calls ``log(name, seconds)`` with its wall time.  The
    time is the host's: work still queued on the card is not waited
    for."""
    nvtx = torch.cuda.is_available()
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
    if log is not None:
        log(name, time.perf_counter() - t0)
