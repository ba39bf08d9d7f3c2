"""Compiled calls on the card: a function of tensors captured once as a
CUDA graph and replayed as one launch a call (the port's counterpart of
the reference's ``jax.jit`` around a whole multiply,
``Mxu2NTT.jit_mul`` and its kin in ``stark_rings_tpu/ops/mxu2.py``).

JAX traces a function once for each input signature and then runs it as
one dispatch, with the tables already on the device.  On the card the
counterpart is a CUDA graph: every kernel of the call (torch's, cuBLAS's
digit GEMMs and the hand kernels) recorded once and replayed with one
``cudaGraphLaunch``, no Python between them.

:class:`GraphSet` holds the graphs of one compiled call.  A function
wrapped by :meth:`GraphSet.wrap` (or by :func:`graphed`, which makes a
set of its own) does, for CUDA inputs:

* on the first call for an input signature (shapes, dtypes, device): one
  warm-up run on the set's side stream (the kernel library is built and
  loaded, cuBLAS gets its workspace, lazy tables reach the device), then
  static input buffers and one ``torch.cuda.CUDAGraph`` captured on that
  stream, into the set's one memory pool;
* on every call: the inputs copied into the static buffers, one replay,
  and a clone of the static output, so that a later call cannot
  overwrite a result (JAX returns a new array each call).

A capture or a replay that fails raises; a CUDA input never runs eagerly
instead.  CPU inputs run the function as it is: the CPU has no graphs,
and CPU tensors go to the plain twins everywhere in the port
(``ops/_build.py``).  Launch counts (``LAUNCHES`` of each kernel
module) see the warm-up and the capture, each once, and no replay; so
do the program's tracing spans (``utils/trace.py``): a replay carries
no span.

Memory: a graph holds its static inputs and output (contiguous copies of
the first call's shapes) and, in the set's pool, the intermediates of
one call; the set keeps them until it is dropped.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _build

__all__ = ["GraphSet", "Graphed", "graphed"]


class _Capture(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: list
    output: torch.Tensor


class GraphSet:
    """The graphs of one compiled call: every function wrapped by
    :meth:`wrap` captures into one memory pool, on one side stream a
    device, one graph for each input signature."""

    def __init__(self):
        self._pool = None
        self._streams = {}

    def wrap(self, fn: Callable) -> "Graphed":
        return Graphed(fn, self)

    def capture(self, fn: Callable, args) -> _Capture:
        """Warm ``fn`` up on ``args`` and capture it on static copies of
        them (the caller holds ``args[0]``'s device)."""
        dev = args[0].device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        inputs = [torch.empty(a.shape, dtype=a.dtype, device=dev)
                  for a in args]
        for s, a in zip(inputs, args):
            s.copy_(a)
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn(*inputs)
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=stream):
            output = fn(*inputs)
        if not isinstance(output, torch.Tensor):
            raise TypeError(f"a graphed function must return one tensor, "
                            f"got {type(output).__name__}")
        return _Capture(graph, inputs, output)


class Graphed:
    """``fn(*tensors) -> tensor`` as one graph replay a call on CUDA
    inputs, and as ``fn`` itself on CPU inputs (see the module)."""

    def __init__(self, fn: Callable, graphs: GraphSet):
        self.fn = fn
        self.graphs = graphs
        self.name = getattr(fn, "__name__", "graphed")
        self.captures: dict = {}

    def __call__(self, *args):
        if not args or not all(isinstance(a, torch.Tensor) for a in args):
            raise TypeError(f"{self.name}: takes one or more tensors")
        if not _build.on_cuda(self.name, *args):
            return self.fn(*args)
        dev = args[0].device
        key = (dev, *((tuple(a.shape), a.dtype) for a in args))
        with torch.cuda.device(dev):
            cap = self.captures.get(key)
            if cap is None:
                cap = self.captures[key] = self.graphs.capture(self.fn, args)
            for s, a in zip(cap.inputs, args):
                s.copy_(a)
            cap.graph.replay()
            return cap.output.clone()


def graphed(fn: Callable) -> Graphed:
    """``fn`` compiled with a graph set of its own (see the module)."""
    return GraphSet().wrap(fn)
