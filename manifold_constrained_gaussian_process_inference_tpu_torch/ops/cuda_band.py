"""Stacked banded matvec in band storage: the hand-written CUDA kernel
(csrc/band_matvec.cu), its build, and its autograd wrapper.

Port of the JAX package's ops/pallas_band.py. ``band_matvec`` computes

    y[..., m, i] = sum_{k=-b..b} bands[m, b+k, i+k] * xs[..., m, i+k]

for xs (M, n) or (C, M, n) (more leading axes fold into C), with the
(M, 2b+1, n) bands shared across the chain axis. On a CUDA tensor it launches the kernel (or raises); on a CPU
tensor it runs the plain PyTorch twin ``ops/band.band_storage_matvec_torch``.
The gradient is the same contraction on the transposed storage
(``transpose_band_storage``); the bands get no gradient (they are static GP
data in MAGI).

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

from .band import band_storage_matvec_torch

# Kernel launches since the last reset: the wrapper adds one per launch,
# and a CUDA-graph replay the launches it replays
# (parallel/chains.GraphedValueAndGrad).
LAUNCHES = 0

# Bandwidth limit kept from the TPU kernel (pallas_band._PALLAS_MAX_BANDWIDTH).
MAX_BANDWIDTH = 64

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
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the band "
            "matvec kernel cannot be built."
        )
    return found


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"band_matvec_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel if this source has not been built yet; returns
    the shared library's path. Raises if nvcc fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # ptxas resource usage (registers, shared memory, spills) per kernel
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("band_matvec_f32", "band_matvec_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def band_matvec_cuda(bands: torch.Tensor, xs: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. bands (M, 2b+1, n),
    xs (M, n) or (C, M, n), both contiguous, on one CUDA device, float32 or
    float64."""
    global LAUNCHES
    if bands.device.type != "cuda" or xs.device != bands.device:
        raise ValueError(
            f"band_matvec_cuda needs both tensors on one CUDA device; got "
            f"{bands.device} and {xs.device}"
        )
    if bands.dtype != xs.dtype or xs.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"band_matvec_cuda takes float32 or float64 of one dtype; got "
            f"{bands.dtype} and {xs.dtype}"
        )
    if not (bands.is_contiguous() and xs.is_contiguous()):
        raise ValueError("band_matvec_cuda needs contiguous tensors")
    if not 0 <= bandwidth <= MAX_BANDWIDTH:
        raise ValueError(
            f"bandwidth {bandwidth} outside the kernel's range [0, {MAX_BANDWIDTH}]"
        )
    m, w, n = bands.shape
    if w != 2 * bandwidth + 1 or xs.dim() not in (2, 3) or xs.shape[-2:] != (m, n):
        raise ValueError(
            f"shape mismatch: bands {tuple(bands.shape)}, xs {tuple(xs.shape)}, "
            f"bandwidth {bandwidth}"
        )
    n_chains = xs.shape[0] if xs.dim() == 3 else 1
    ys = torch.empty_like(xs)
    if ys.numel() == 0:
        return ys
    lib = _library()
    fn = lib.band_matvec_f32 if xs.dtype == torch.float32 else lib.band_matvec_f64
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = fn(
        bands.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        n_chains, m, n, bandwidth, stream,
    )
    if err != 0:
        raise RuntimeError(f"band_matvec kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return ys


def _apply(bands: torch.Tensor, xs: torch.Tensor, bandwidth: int) -> torch.Tensor:
    if xs.device.type == "cuda":
        return band_matvec_cuda(bands, xs.contiguous(), bandwidth)
    if xs.device.type == "cpu":
        return band_storage_matvec_torch(bands, xs, bandwidth)
    raise ValueError(f"band_matvec: unsupported device {xs.device}")


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


def band_matvec(bands, bands_t, xs, bandwidth: int) -> torch.Tensor:
    """Differentiable (in ``xs``) stacked band-storage matvec; see the
    module docstring. xs (..., M, n): leading axes beyond one are folded
    into the kernel's chain axis."""
    if xs.dim() > 3:
        flat = xs.reshape(-1, *xs.shape[-2:])
        return BandMatvec.apply(bands, bands_t, flat, bandwidth).reshape(xs.shape)
    return BandMatvec.apply(bands, bands_t, xs, bandwidth)
