"""IF nodes in the CUDA graphs that PyTorch captures (csrc/graph_if.cu).

The JAX package's NUTS keeps its lockstep loops on the device: the leaf
loop of a doubling runs while ``any(alive)`` (``lax.while_loop``,
inference/nuts_batched.py). The port captures a doubling in a CUDA graph
(``inference/nuts_batched.LockstepTree``), and there a leaf pair that no
chain needs is skipped by a conditional node: a one-thread kernel sets the
node's flag from a device bool at each replay, and the device runs or
skips the node's body, with no read on the host.

``IfNodes.body(pred)`` opens such a node on the graph being captured on the
current stream; what runs inside the ``with`` block is captured into the
node's body from a side stream of its own. The capture's memory pool takes
only allocations made on its own capture, so the bodies allocate from a
private pool of their own (``torch.cuda.graph_pool_handle``), released when
the IfNodes object goes. PyTorch's own binding of these nodes
(``CUDAGraph.begin_capture_to_if_node``) is newer than some of the versions
the port runs on; this one needs only CUDA >= 12.4 and the allocator's
stream routing.

``LAUNCHES`` counts the set kernel's launches: ``body`` adds one per IF
node it captures, and a graph's owner moves them to each replay, as the
band kernels' are (``LockstepTree._capture``, ``_replay``); the plain
version of the node is the host branch (``inference/nuts_batched._when``).

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
import weakref
from contextlib import contextmanager
from pathlib import Path

import torch

from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "graph_if.cu"
KERNEL = "graph_if_set_condition"

# Set-kernel launches since the last reset (captured ones, until moved to
# the replays that run them).
LAUNCHES = {KERNEL: 0}

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_band.build(SOURCE)))
        p, n = ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)
        for name, args in (("graph_if_begin", [p, p, p]), ("graph_if_end", [p, n]),
                           ("graph_capture_nodes", [p, n])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        _LIB = lib
    return _LIB


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def capture_nodes(stream: torch.cuda.Stream) -> int:
    """Top-level nodes of the graph being captured on ``stream`` (an IF
    node counts one; its body's nodes are ``IfNodes.body_nodes``)."""
    n = ctypes.c_ulonglong(0)
    _check(_library().graph_capture_nodes(stream.cuda_stream, ctypes.byref(n)),
           "graph_capture_nodes")
    return int(n.value)


def _release(device_index: int, pool, begins: list) -> None:
    for _ in range(begins[0]):
        torch._C._cuda_releasePool(device_index, pool)


class IfNodes:
    """IF nodes on graphs captured on ``device``: their bodies' side stream
    and memory pool, and the count of nodes captured into bodies."""

    def __init__(self, device):
        device = torch.device(device)
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.device = torch.device("cuda", self.index)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.body_nodes = 0
        self._begins = [0]  # each routing of the pool holds a reference to it
        weakref.finalize(self, _release, self.index, self.pool, self._begins)

    @contextmanager
    def body(self, pred: torch.Tensor):
        """Capture the ``with`` block as the body of an IF node on the
        one-element CUDA bool ``pred`` (read by the device at each replay)
        after the work captured so far on the current stream."""
        if pred.dtype != torch.bool or pred.numel() != 1 or pred.device != self.device:
            raise ValueError(f"an IF node's condition is one bool on {self.device}; got "
                             f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
        lib = _library()
        capture = torch.cuda.current_stream(self.device)
        _check(lib.graph_if_begin(capture.cuda_stream, pred.data_ptr(), self.stream.cuda_stream),
               "graph_if_begin")
        LAUNCHES[KERNEL] += 1
        n = ctypes.c_ulonglong(0)
        with torch.cuda.stream(self.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.index, self.pool)
            self._begins[0] += 1
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(self.index, self.pool)
                _check(lib.graph_if_end(self.stream.cuda_stream, ctypes.byref(n)),
                       "graph_if_end")
        self.body_nodes += int(n.value)
