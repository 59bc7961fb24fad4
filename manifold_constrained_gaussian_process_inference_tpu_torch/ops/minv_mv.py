"""The dense metric's product M^-1 g: the hand-written CUDA kernel
(csrc/minv_mv.cu), its plain version and the dispatch between them.

Counterpart of the JAX package's ``_minv_mv_b`` for a ``DenseMetric``
(inference/nuts_batched.py:63: ``p @ minv.T``, the rows of M^-1, which is
symmetric only up to rounding), which XLA compiles. ``inference/nuts.py``'s
``DenseMetric.velocity`` calls ``minv_mv``: on a CUDA tensor it launches the
kernel on the current stream (so that the NUTS tree's CUDA graphs capture
it) or raises, with no fallback; on a CPU tensor it runs the plain version,
``minv_mv_torch``, which the kernel is held against (``chip_smoke.py``'s
[leaf]).

The kernel computes in float64 on the FP64 tensor cores whatever the
storage type (a float32 output is the float64 sum rounded once), and sums
each output in an order fixed by dim alone (``split``: S contiguous ranges
of whole ``STEP``-wide steps, each range in ascending k, the ranges in
order), so a chain's bits do not depend on how many chains share its
launch.

``LAUNCHES`` counts the kernel's launches: the wrapper adds one per launch,
and the NUTS tree moves the launches its CUDA graphs captured to each
replay (``LockstepTree._capture``, ``_replay``), one per leaf run.

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "minv_mv.cu"
MINV_MV = "minv_mv"
# the kernel's k step, and the steps a range that its split aims at, at most
# MAX_SPLIT ranges (csrc/minv_mv.cu kStep, kStepsPerRange, kMaxSplit)
STEP, STEPS_PER_RANGE, MAX_SPLIT = 32, 5, 8

# Kernel launches since the last reset (captured ones, until moved to the
# replays that run them).
LAUNCHES = {MINV_MV: 0}

_LIB = None


def reset_launches() -> None:
    LAUNCHES[MINV_MV] = 0


def add_launches(added: dict) -> None:
    """Count launches made outside the wrapper (a CUDA-graph replay)."""
    for name, k in added.items():
        LAUNCHES[name] += k


def split(dim: int):
    """The kernel's summation order at ``dim``: (S, steps a range), the
    sum over k cut into S ranges of that many STEP-wide steps (the last
    shorter), as csrc/minv_mv.cu's split_for computes it."""
    steps = -(-dim // STEP)
    ranges = min(max(-(-steps // STEPS_PER_RANGE), 1), MAX_SPLIT)
    return ranges, -(-steps // ranges)


def minv_mv_torch(minv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version: M^-1 g for each row of g, ``g @ minv.T``."""
    return g @ minv.T


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_band.build(SOURCE)))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{MINV_MV}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.minv_mv_max_clusters_f32.argtypes = [ctypes.c_int] * 2
        lib.minv_mv_max_clusters_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def minv_mv_cuda(minv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel on the current stream: minv (dim, dim) and g (..., dim),
    float32 or float64, on one CUDA device; returns M^-1 g, g's shape."""
    lib = _library()
    dim = g.shape[-1]
    if (minv.shape != (dim, dim) or minv.dtype != g.dtype or minv.device != g.device
            or g.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"minv_mv_cuda: minv (dim, dim) and g (..., dim) of one float dtype on "
                         f"one device; got {minv.dtype} {tuple(minv.shape)} on {minv.device}, "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    minv, rows = minv.contiguous(), g.reshape(-1, dim).contiguous()
    out = torch.empty_like(rows)
    fn = getattr(lib, f"{MINV_MV}_{'f32' if g.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(minv.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.shape[0], dim, stream)
    if err != 0:
        raise RuntimeError(f"{MINV_MV} kernel launch failed: CUDA error {err}")
    LAUNCHES[MINV_MV] += 1
    return out.reshape(g.shape)


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version)."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"minv_mv: unsupported device {t.device}")
    return t.device.type == "cuda"


def minv_mv(minv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """M^-1 g: the kernel for a CUDA tensor, the plain version for a CPU
    one."""
    if _on_card(g):
        return minv_mv_cuda(minv, g)
    return minv_mv_torch(minv, g)


def max_clusters(n_chains: int, dim: int) -> int:
    """The clusters of a float32 launch at (n_chains, dim) that the card
    runs at once (cudaOccupancyMaxActiveClusters); a launch with more runs
    in waves."""
    n = _library().minv_mv_max_clusters_f32(n_chains, dim)
    if n < 0:
        raise RuntimeError(f"{MINV_MV}: occupancy query failed: CUDA error {-n}")
    return n


def product_work(n_chains: int, dim: int, itemsize: int):
    """(flop, bytes) the product must do and move: 2 C dim^2 multiply-adds'
    flop; minv and g read once, mg written once."""
    return 2 * n_chains * dim * dim, itemsize * (dim * dim + 2 * n_chains * dim)
