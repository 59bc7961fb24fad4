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

The kernel reads minv in a prepared layout (``prepare``: float64, padded
to whole ROWS x STEP blocks, each block in the DMMA's fragment order; its
plain version ``prepare_torch`` is that permutation), written by a small
kernel of its own once per metric: ``prepared(minv)`` keeps it on the
tensor and writes it again, in place, when minv's version moved (an
in-place write such as the NUTS tree's rewrite of its metric copy), so
CUDA graphs that captured a product read the new one by address.
``product(prep, g)`` runs the kernel on an operand prepared by the caller
(the whitening GEMMs of inference/whiten.py, on W and on W^T).

The kernel computes in float64 on the FP64 tensor cores whatever the
storage type (a float32 output is the float64 sum rounded once), and sums
each output in an order fixed by dim alone (``split``: S contiguous ranges
of whole ``STEP``-wide steps, each range in ascending k, the ranges in
order), so a chain's bits do not depend on how many chains share its
launch.

While the tracer (``utils/trace.py``) is on, the first product launched in
a ``trace.stage`` scope stamps that stage (the NUTS tree's value-and-grad
and metric product, ``inference/nuts_batched.py``): it runs the traced entry
point with the tracer's stamp buffer, which computes the same bits.

``LAUNCHES`` counts the kernels' launches: the product's (``MINV_MV``) and
the preparation's (``PREPARE``); the wrapper adds one per launch, and the
NUTS tree moves the product launches its CUDA graphs captured to each
replay (``LockstepTree._capture``, ``_replay``), one per leaf run.

The source is compiled at first use with nvcc for sm_90a into
``<package>/build/`` (``ops/cuda_band.build``) and bound with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..utils import trace
from . import cuda_band

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "minv_mv.cu"
MINV_MV, PREPARE = "minv_mv", "minv_mv_prepare"
# the kernel's k step, and the steps a range that its split aims at, at most
# MAX_SPLIT ranges; the rows of an output tile, which with STEP make a block
# of the prepared operand (csrc/minv_mv.cu kStep, kStepsPerRange, kMaxSplit,
# kRows)
STEP, STEPS_PER_RANGE, MAX_SPLIT, ROWS = 32, 7, 4, 32

# Kernel launches since the last reset (captured ones, until moved to the
# replays that run them).
LAUNCHES = {MINV_MV: 0, PREPARE: 0}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def prepared_size(dim: int) -> int:
    """Doubles of the prepared operand at ``dim``: (ceil(dim / STEP))^2
    blocks of ROWS x STEP."""
    steps = -(-dim // STEP)
    return steps * steps * ROWS * STEP


def prepare_torch(minv: torch.Tensor) -> torch.Tensor:
    """The plain version of the preparation: minv (dim, dim) as the kernel
    reads it, float64, flat, ``prep[rt][ks][kk][j][lane][e] = minv[32 rt +
    8 j + lane // 4][32 ks + 8 kk + lane % 4 + 4 e]``, zero past dim (the
    B fragments of the m16n8k8 DMMA, rows 8 j.. and k 8 kk.. of block
    (rt, ks))."""
    dim = minv.shape[0]
    steps = -(-dim // STEP)
    pad = torch.zeros((steps * ROWS, steps * STEP), dtype=torch.float64, device=minv.device)
    pad[:dim, :dim] = minv
    # rows (rt, j, group), k (ks, kk, e, quad) -> (rt, ks, kk, j, group, quad, e)
    blocks = pad.reshape(steps, 4, 8, steps, 4, 2, 4).permute(0, 3, 4, 1, 2, 6, 5)
    return blocks.reshape(-1)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(cuda_band.build(SOURCE)))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{MINV_MV}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"{MINV_MV}_traced_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"{PREPARE}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_int64] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.minv_mv_prepared_doubles.argtypes = [ctypes.c_int]
        lib.minv_mv_prepared_doubles.restype = ctypes.c_int64
        for name in ("minv_mv_max_clusters_f32", "minv_mv_chain_tile_f32"):
            getattr(lib, name).restype = ctypes.c_int
        lib.minv_mv_max_clusters_f32.argtypes = [ctypes.c_int] * 2
        lib.minv_mv_chain_tile_f32.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def _suffix(dtype: torch.dtype) -> str:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"minv_mv: float32 or float64 only, got {dtype}")
    return "f32" if dtype == torch.float32 else "f64"


def prepare(minv: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """minv (dim, dim), any strides, as the kernel reads it (see
    ``prepare_torch``), into ``out`` when given: on the card one launch of
    the preparation kernel on the current stream (counted), on the CPU the
    plain version."""
    dim = minv.shape[-1]
    if minv.shape != (dim, dim):
        raise ValueError(f"minv_mv.prepare: minv (dim, dim), got {tuple(minv.shape)}")
    if not _on_card(minv):
        plain = prepare_torch(minv)
        return plain if out is None else out.copy_(plain)
    lib = _library()
    suffix = _suffix(minv.dtype)
    if lib.minv_mv_prepared_doubles(dim) != prepared_size(dim):
        raise RuntimeError("minv_mv: the kernel's prepared size differs from prepared_size")
    if out is None:
        out = torch.empty(prepared_size(dim), dtype=torch.float64, device=minv.device)
    elif (out.shape != (prepared_size(dim),) or out.dtype != torch.float64
          or out.device != minv.device or not out.is_contiguous()):
        raise ValueError(f"minv_mv.prepare: out must be float64 ({prepared_size(dim)},) on "
                         f"{minv.device}")
    stream = torch.cuda.current_stream(minv.device).cuda_stream
    err = getattr(lib, f"{PREPARE}_{suffix}")(minv.data_ptr(), out.data_ptr(), dim,
                                               minv.stride(0), minv.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"{PREPARE} kernel launch failed: CUDA error {err}")
    LAUNCHES[PREPARE] += 1
    return out


def prepared(minv: torch.Tensor) -> torch.Tensor:
    """The prepared operand of ``minv``, kept on the tensor: made at the
    first call, written again in place (same address) when the tensor's
    version has moved since, else returned as it is."""
    held = getattr(minv, "_minv_mv_prepared", None)
    if held is not None and held[0] == minv._version:
        return held[1]
    prep = prepare(minv, None if held is None else held[1])
    minv._minv_mv_prepared = (minv._version, prep)
    return prep


def product(prep: torch.Tensor, g: torch.Tensor, stamp=None) -> torch.Tensor:
    """The kernel on the current stream: a prepared operand (``prepare``)
    of a (dim, dim) minv and g (..., dim), float32 or float64, on one CUDA
    device; returns M^-1 g, g's shape and dtype. ``stamp`` (address, the
    stage it closes, the stage it opens) runs the traced entry point; by
    default the tracer's open ``trace.stage`` scope, if any, gives it."""
    lib = _library()
    dim = g.shape[-1]
    suffix = _suffix(g.dtype)
    if (prep.shape != (prepared_size(dim),) or prep.dtype != torch.float64
            or prep.device != g.device or not prep.is_contiguous()):
        raise ValueError(f"minv_mv.product: a prepared operand of dim {dim} (float64, "
                         f"{prepared_size(dim)}) on {g.device}; got {prep.dtype} "
                         f"{tuple(prep.shape)} on {prep.device}")
    rows = g.reshape(-1, dim).contiguous()
    out = torch.empty_like(rows)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    address, prev, stage = trace.take_stage(g.device) if stamp is None else stamp
    if address is None:
        err = getattr(lib, f"{MINV_MV}_{suffix}")(prep.data_ptr(), rows.data_ptr(),
                                                   out.data_ptr(), rows.shape[0], dim, stream)
    else:
        err = getattr(lib, f"{MINV_MV}_traced_{suffix}")(
            prep.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.shape[0], dim, address,
            prev, stage, stream)
    if err != 0:
        raise RuntimeError(f"{MINV_MV} kernel launch failed: CUDA error {err}")
    LAUNCHES[MINV_MV] += 1
    return out.reshape(g.shape)


def minv_mv_cuda(minv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The kernel on the current stream: minv (dim, dim) and g (..., dim),
    float32 or float64, on one CUDA device; returns M^-1 g, g's shape. minv
    is prepared first where its prepared operand is missing or stale
    (``prepared``)."""
    dim = g.shape[-1]
    if (minv.shape != (dim, dim) or minv.dtype != g.dtype or minv.device != g.device
            or g.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"minv_mv_cuda: minv (dim, dim) and g (..., dim) of one float dtype on "
                         f"one device; got {minv.dtype} {tuple(minv.shape)} on {minv.device}, "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    return product(prepared(minv), g)


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


def chain_tile(n_chains: int) -> int:
    """The chain tile of a float32 launch at ``n_chains`` (the kernel's
    rule: one tile up to 128 chains)."""
    return _library().minv_mv_chain_tile_f32(n_chains)


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
