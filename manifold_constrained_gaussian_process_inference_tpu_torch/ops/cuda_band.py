"""Stacked banded matvecs in band storage: the hand-written CUDA kernel
(csrc/band_matvec.cu), its build, and its autograd wrappers.

Port of the JAX package's ops/pallas_band.py. ``band_matvec`` computes

    y[..., m, i] = sum_{k=-b..b} bands[m, b+k, i+k] * xs[..., m, i+k]

for xs (M, n) or (C, M, n) (more leading axes fold into C), with the
(M, 2b+1, n) bands shared across the chain axis, and ``band_matvec_pair``
applies two band stacks to one input in one launch (its backward sums the
two transposed products in one launch). On a CUDA tensor each launches
the kernel or raises; on a CPU tensor it runs the plain PyTorch version
(``ops/band.band_storage_matvec_torch`` and the pair forms beside it). The
gradient is the same contraction on the transposed storage
(``transpose_band_storage``); the bands get no gradient (they are static GP
data in MAGI). Any bandwidth runs: the kernel's shared memory is sized by
its chunk of diagonals, not by the band.

Which tile runs is decided here, by ``tile_for``, and passed to the
kernel: below ``ROW_TILE_BELOW`` chains the row tile (16 rows of every
chain a block, bound by the band's bytes), from it on the chain tile (a
tile of 32 or 64 chains a block); each in the Small order, or in float32
from a band width 2b+1 of ``LARGE_FROM_WIDTH`` on in the Large order. The
two tiles sum every output in the same order, so a chain's result does not
depend on how many chains share its launch.

The kernel is compiled at first use with the installed CUDA toolkit's
``nvcc`` for sm_90a into ``<package>/build/``, keyed by a hash of the
source, and bound with ctypes through its plain C interface.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .band import band_matvec_pair_t_torch, band_matvec_pair_torch, band_storage_matvec_torch

# The kernel's C entry points, each in _f32 and _f64, with their number of
# pointer arguments (then n_chains, n_mat, n, bandwidth, tile, stream).
N_POINTERS = {"band_matvec": 3, "band_matvec_pair": 5, "band_matvec_pair_t": 5}
# The kernel's tiles, numbered as its TileCode: the chain tile and the row
# tile, each in the Small or the Large summation order.
TILES = ("chain_small", "chain_large", "row_small", "row_large")
# The row tile runs below this many chains: up to the 8 it takes (the
# kernel's kRowMaxChains), where the C sweep of perf/band_timing.py found
# it ahead of the chain tile or within 3% (PERF.md).
ROW_TILE_BELOW = 9
# Band width 2b+1 from which float32 sums in the Large order (float64
# always in the Small one).
LARGE_FROM_WIDTH = 128

# Kernel launches since the last reset, by C entry point and by tile: each
# wrapper adds one to each per launch, and a CUDA-graph replay the launches
# it replays (parallel/chains.GraphedValueAndGrad).
KERNEL_LAUNCHES = dict.fromkeys(N_POINTERS, 0)
TILE_LAUNCHES = dict.fromkeys(TILES, 0)

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "band_matvec.cu"
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIB = None


def transpose_band_storage(band: np.ndarray, bandwidth: int) -> np.ndarray:
    """Band storage of A^T given band storage of A (host-side):
    bandT[b+k, j] = band[b-k, j-k]."""
    w, n = band.shape
    b = bandwidth
    out = np.zeros_like(band)
    for k in range(-b, b + 1):
        src = band[b - k]
        if k >= 0:
            out[b + k, k:] = src[: n - k]
        else:
            out[b + k, : n + k] = src[-k:]
    return out


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the port's "
            "CUDA sources cannot be built."
        )
    return found


def library_path(source: Path = SOURCE) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{key.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (the kernel's by default) if it has not been
    built yet; returns the shared library's path. Raises if nvcc fails."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # ptxas resource usage (registers, shared memory, spills) per kernel
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load(source: Path = SOURCE):
    """Build ``source`` and bind its C entry points."""
    lib = ctypes.CDLL(str(build(source)))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, k in N_POINTERS.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes = [p] * k + [i] * 5 + [p]
                fn.restype = i
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = load()
    return _LIB


def tile_for(n_chains: int, bandwidth: int, dtype: torch.dtype) -> str:
    """The tile a launch of ``n_chains`` chains at ``bandwidth`` runs: the
    row tile below ROW_TILE_BELOW chains, else the chain tile; in the Large
    order for float32 at 2b+1 >= LARGE_FROM_WIDTH, else the Small one."""
    kind = "row" if n_chains < ROW_TILE_BELOW else "chain"
    large = dtype == torch.float32 and 2 * bandwidth + 1 >= LARGE_FROM_WIDTH
    return f"{kind}_{'large' if large else 'small'}"


def launches() -> int:
    """Kernel launches since the last reset, all entry points together."""
    return sum(KERNEL_LAUNCHES.values())


def counts() -> dict:
    """Every launch count: by entry point, then by tile."""
    return {**KERNEL_LAUNCHES, **TILE_LAUNCHES}


def reset_launches() -> None:
    for table in (KERNEL_LAUNCHES, TILE_LAUNCHES):
        for name in table:
            table[name] = 0


def add_launches(added: dict) -> None:
    """Count launches made outside the wrappers (a CUDA-graph replay):
    entry point or tile names, as ``counts`` gives them."""
    for name, k in added.items():
        (KERNEL_LAUNCHES if name in KERNEL_LAUNCHES else TILE_LAUNCHES)[name] += k


def _checked(name, bands, xs, bandwidth):
    """Device, dtype, contiguity and shape checks of one launch; returns
    (n_chains, M, n)."""
    tensors = [*bands, *xs]
    dev = xs[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name} needs all tensors on one CUDA device; got "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or xs[0].dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64 of one dtype; got {dtypes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    m, w, n = bands[0].shape
    if (
        bandwidth < 0 or w != 2 * bandwidth + 1
        or any(t.shape != bands[0].shape for t in bands)
        or xs[0].dim() not in (2, 3) or xs[0].shape[-2:] != (m, n)
        or any(t.shape != xs[0].shape for t in xs)
    ):
        raise ValueError(
            f"{name}: shape mismatch: bands {[tuple(t.shape) for t in bands]}, xs "
            f"{[tuple(t.shape) for t in xs]}, bandwidth {bandwidth}"
        )
    return (xs[0].shape[0] if xs[0].dim() == 3 else 1), m, n


def _launch(name, tensors, dims, bandwidth, like) -> None:
    suffix = "f32" if like.dtype == torch.float32 else "f64"
    fn = getattr(_library(), f"{name}_{suffix}")
    tile = tile_for(dims[0], bandwidth, like.dtype)
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = fn(*(t.data_ptr() for t in tensors), *dims, bandwidth, TILES.index(tile), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch ({tile} tile) failed: CUDA error {err}")
    KERNEL_LAUNCHES[name] += 1
    TILE_LAUNCHES[tile] += 1


def band_matvec_cuda(bands: torch.Tensor, xs: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """y = A x on the current stream. bands (M, 2b+1, n), xs (M, n) or
    (C, M, n), contiguous, on one CUDA device, float32 or float64. The
    tile is ``tile_for(C, b, dtype)``: the row tile at C < ROW_TILE_BELOW,
    the chain tile from it on; each chain's output is the same bits
    either way."""
    dims = _checked("band_matvec_cuda", [bands], [xs], bandwidth)
    ys = torch.empty_like(xs)
    if ys.numel():
        _launch("band_matvec", [bands, xs, ys], dims, bandwidth, xs)
    return ys


def band_matvec_pair_cuda(bands_a, bands_b, xs, bandwidth: int):
    """(A x, B x) in one launch; shapes as ``band_matvec_cuda``."""
    dims = _checked("band_matvec_pair_cuda", [bands_a, bands_b], [xs], bandwidth)
    ya, yb = torch.empty_like(xs), torch.empty_like(xs)
    if xs.numel():
        _launch("band_matvec_pair", [bands_a, bands_b, xs, ya, yb], dims, bandwidth, xs)
    return ya, yb


def band_matvec_pair_t_cuda(bands_a, bands_b, xs_a, xs_b, bandwidth: int) -> torch.Tensor:
    """A x_a + B x_b in one launch; shapes as ``band_matvec_cuda``."""
    dims = _checked("band_matvec_pair_t_cuda", [bands_a, bands_b], [xs_a, xs_b], bandwidth)
    ys = torch.empty_like(xs_a)
    if ys.numel():
        _launch("band_matvec_pair_t", [bands_a, bands_b, xs_a, xs_b, ys], dims, bandwidth, xs_a)
    return ys


def _on_card(xs: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version)."""
    if xs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"band_matvec: unsupported device {xs.device}")
    return xs.device.type == "cuda"


def _apply(bands, xs, bandwidth):
    if _on_card(xs):
        return band_matvec_cuda(bands, xs.contiguous(), bandwidth)
    return band_storage_matvec_torch(bands, xs, bandwidth)


def _apply_pair(bands_a, bands_b, xs, bandwidth):
    if _on_card(xs):
        return band_matvec_pair_cuda(bands_a, bands_b, xs.contiguous(), bandwidth)
    return band_matvec_pair_torch(bands_a, bands_b, xs, bandwidth)


def _apply_pair_t(bands_a, bands_b, xs_a, xs_b, bandwidth):
    if _on_card(xs_a):
        return band_matvec_pair_t_cuda(
            bands_a, bands_b, xs_a.contiguous(), xs_b.contiguous(), bandwidth
        )
    return band_matvec_pair_t_torch(bands_a, bands_b, xs_a, xs_b, bandwidth)


class BandMatvec(torch.autograd.Function):
    """y = A x in band storage; dL/dx = A^T g through the transposed
    storage ``bands_t``; no gradient for either storage."""

    @staticmethod
    def forward(ctx, bands, bands_t, xs, bandwidth):
        ctx.save_for_backward(bands_t)
        ctx.bandwidth = bandwidth
        return _apply(bands, xs, bandwidth)

    @staticmethod
    def backward(ctx, grad_y):
        (bands_t,) = ctx.saved_tensors
        return None, None, _apply(bands_t, grad_y, ctx.bandwidth), None


class BandMatvecPair(torch.autograd.Function):
    """(A x, B x) in one launch; dL/dx = A^T g_a + B^T g_b in one launch,
    through the transposed storages; no gradient for the storages."""

    @staticmethod
    def forward(ctx, bands_a, bands_a_t, bands_b, bands_b_t, xs, bandwidth):
        ctx.save_for_backward(bands_a_t, bands_b_t)
        ctx.bandwidth = bandwidth
        return _apply_pair(bands_a, bands_b, xs, bandwidth)

    @staticmethod
    def backward(ctx, grad_a, grad_b):
        bands_a_t, bands_b_t = ctx.saved_tensors
        grad_x = _apply_pair_t(bands_a_t, bands_b_t, grad_a, grad_b, ctx.bandwidth)
        return None, None, None, None, grad_x, None


def _folded(xs):
    """xs (..., M, n) with the leading axes beyond one folded into one."""
    return xs.reshape(-1, *xs.shape[-2:]) if xs.dim() > 3 else xs


def band_matvec(bands, bands_t, xs, bandwidth: int) -> torch.Tensor:
    """Differentiable (in ``xs``) stacked band-storage matvec; see the
    module docstring. xs (..., M, n): leading axes beyond one are folded
    into the kernel's chain axis."""
    return BandMatvec.apply(bands, bands_t, _folded(xs), bandwidth).reshape(xs.shape)


def band_matvec_pair(bands_a, bands_a_t, bands_b, bands_b_t, xs, bandwidth: int):
    """(A x, B x), differentiable in ``xs``: one launch forward and one
    backward on a card. Shapes as ``band_matvec``."""
    ya, yb = BandMatvecPair.apply(bands_a, bands_a_t, bands_b, bands_b_t, _folded(xs), bandwidth)
    return ya.reshape(xs.shape), yb.reshape(xs.shape)
