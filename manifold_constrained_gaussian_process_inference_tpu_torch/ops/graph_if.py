"""WHILE nodes in the CUDA graphs that PyTorch captures (csrc/graph_if.cu).

The JAX package's NUTS keeps its leaf loop on the device: the leaves of a
doubling run while ``(j < num_leaves) & any(alive)`` (a ``lax.while_loop``,
inference/nuts_batched.py). The port captures a doubling in a CUDA graph
(``inference/nuts_batched.LockstepTree``), and there the leaf pairs after
the first run under one WHILE conditional node: the device runs the node's
body again while its condition handle is non-zero, and the NUTS leaf's
commit kernel sets that handle (``ops/leaf.py``, L2: from its pair counter
and the chains' alive flags), upstream of the node for the first test and
inside the body for the next ones; the host reads nothing.

``WhileNodes.handle()`` creates a condition handle on the graph being
captured on the current stream (0 at every launch of the graph until a
kernel sets it); ``WhileNodes.loop(handle, body)`` adds a WHILE node on it
after the work captured so far, and captures ``body()`` into the node's
body from a side stream of its own. The capture's memory pool takes only
allocations made on its own capture, so the bodies allocate from a private
pool of their own (``torch.cuda.graph_pool_handle``), released when the
WhileNodes object goes; a body's allocations are reused at every iteration,
so nothing a body allocates may be read after its loop. PyTorch's own binding of conditional nodes is newer than
some of the versions the port runs on; this one needs only CUDA >= 12.4 and
the allocator's stream routing. A refused call raises; nothing falls back to
another schedule.

``probe(handle, counter, limit)`` launches a one-thread kernel that advances
a device counter and sets the handle to ``counter < limit``: the body with
which ``chip_smoke.py``'s [graph-if] holds a WHILE node against the host
loop and times its iterations. It is on no path of the port.

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import weakref
from pathlib import Path

import torch

from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "graph_if.cu"

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_band.build(SOURCE)))
        p, u, n = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_ulonglong)
        for name, args in (("graph_cond_handle", [p, n]), ("graph_while_begin", [p, u, p]),
                           ("graph_while_end", [p, n]), ("graph_capture_nodes", [p, n]),
                           ("graph_while_probe", [p, u, p, p])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _LIB = lib
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def capture_nodes(stream: torch.cuda.Stream) -> int:
    """Top-level nodes of the graph being captured on ``stream`` (a WHILE
    node counts one; its body's nodes are ``WhileNodes.body_nodes``)."""
    n = ctypes.c_ulonglong(0)
    _check(_library().graph_capture_nodes(stream.cuda_stream, ctypes.byref(n)),
           "graph_capture_nodes")
    return int(n.value)


def probe(handle: int, counter: torch.Tensor, limit: torch.Tensor) -> None:
    """On the current stream: counter += 1, then the handle set to
    ``counter < limit`` (one-element int32 CUDA tensors)."""
    for what, t in (("counter", counter), ("limit", limit)):
        if t.dtype != torch.int32 or t.numel() != 1 or not t.is_cuda:
            raise ValueError(f"probe: {what} must be one int32 on the card")
    stream = torch.cuda.current_stream(counter.device).cuda_stream
    _check(_library().graph_while_probe(stream, handle, counter.data_ptr(), limit.data_ptr()),
           "graph_while_probe")


def _release(device_index: int, pool, begins: list) -> None:
    for _ in range(begins[0]):
        torch._C._cuda_releasePool(device_index, pool)


class WhileNodes:
    """WHILE nodes on graphs captured on ``device``: their bodies' side
    stream and memory pool, and the count of nodes captured into bodies."""

    def __init__(self, device):
        device = torch.device(device)
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.device = torch.device("cuda", self.index)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.body_nodes = 0
        self._begins = [0]  # each routing of the pool holds a reference to it
        weakref.finalize(self, _release, self.index, self.pool, self._begins)

    def handle(self) -> int:
        """A new condition handle on the graph being captured on the current
        stream, 0 at every launch of the graph until a kernel sets it."""
        h = ctypes.c_ulonglong(0)
        _check(_library().graph_cond_handle(torch.cuda.current_stream(self.device).cuda_stream,
                                            ctypes.byref(h)), "graph_cond_handle")
        return int(h.value)

    def loop(self, handle: int, body) -> None:
        """Capture ``body()`` as the body of a WHILE node on ``handle`` after
        the work captured so far on the current stream."""
        lib = _library()
        capture = torch.cuda.current_stream(self.device)
        if self.stream.cuda_stream == capture.cuda_stream:
            # PyTorch's pool hands out its streams in turn, and a graph's
            # capture stream is one of them: the body may not be captured on
            # the stream that is capturing (CUDA error 401), so take the next
            self.stream = torch.cuda.Stream(self.device)
        _check(lib.graph_while_begin(capture.cuda_stream, handle, self.stream.cuda_stream),
               "graph_while_begin")
        n = ctypes.c_ulonglong(0)
        with torch.cuda.stream(self.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, self.pool)
            self._begins[0] += 1
            try:
                body()
            finally:
                torch._C._cuda_endAllocateToPool(self.index, self.pool)
                _check(lib.graph_while_end(self.stream.cuda_stream, ctypes.byref(n)),
                       "graph_while_end")
        self.body_nodes += int(n.value)
