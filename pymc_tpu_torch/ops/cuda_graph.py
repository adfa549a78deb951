"""A function of one tensor replayed from a CUDA graph, one graph per input
shape.

A batched logp+grad of a model (`Model.logp_dlogp_fn`) is some 250 small
kernels whose launches cost the host ~8 ms while an H100 works for ~0.4 ms
(PERF.md §5). The samplers and the VI and MAP loops
call it thousands of times at one input shape, so it is captured once per
shape and replayed: the first call of a shape runs eagerly (the libraries
set up their handles), the second runs on a side stream and is then
captured on it, and every later call copies its input into the graph's
buffer, replays and returns copies of the outputs. A replay launches the
same kernels on the same inputs as the eager call.

The kernels of the port count their launches in their wrappers, which run
once, at capture, where the kernel does not run. So the capture's counts
are taken back and each replay adds them again: a count is still one per
kernel that ran. CPU tensors pass straight through to the function. A
function that copies from the host or syncs cannot be captured; a shape
whose capture fails runs eagerly, with a warning.
"""

from __future__ import annotations

import logging

import torch

from .linalg import cholesky_batched

__all__ = ["GraphedFunction"]

_log = logging.getLogger("pymc_tpu_torch")

# the kernel wrappers a logp+grad can reach
_COUNTED = (cholesky_batched,)


class _Graph:
    def __init__(self, fn, q):
        self.fn = fn
        self.q = q.clone()
        stream = torch.cuda.Stream(q.device)
        stream.wait_stream(torch.cuda.current_stream(q.device))
        with torch.cuda.stream(stream):
            first = fn(self.q)  # the call that captures is run here, eagerly
        before = [w.launches for w in _COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = fn(self.q)
        except RuntimeError as err:
            # a host copy or sync in fn cannot be captured: that shape runs
            # eagerly (the same kernels, each launched from the host)
            _log.warning(f"CUDA graph capture failed, running eagerly: {err}")
            self.graph = None
        finally:
            self.launches = [w.launches - b for w, b in zip(_COUNTED, before)]
            for w, n in zip(_COUNTED, self.launches):
                w.launches -= n
            torch.cuda.current_stream(q.device).wait_stream(stream)
        self.first = tuple(x.clone() for x in first)

    def __call__(self, q):
        if self.graph is None:
            return self.fn(q)
        self.q.copy_(q)
        self.graph.replay()
        for w, n in zip(_COUNTED, self.launches):
            w.launches += n
        return tuple(x.clone() for x in self.out)


class GraphedFunction:
    """fn(q) -> tuple of tensors, replayed from a CUDA graph per (shape,
    dtype, device) of q from the third call of that shape on."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = set()
        self.graphs = {}

    def __call__(self, q):
        if q.device.type != "cuda":
            return self.fn(q)
        key = (tuple(q.shape), q.dtype, q.device)
        graph = self.graphs.get(key)
        if graph is not None:
            return graph(q)
        if key not in self.seen:
            self.seen.add(key)
            return self.fn(q)
        self.graphs[key] = graph = _Graph(self.fn, q)
        first, graph.first = graph.first, None
        return first
