"""Band truncation and band storage (port of the JAX package's ops/band.py).

Entries outside the band are DROPPED (treated as zero). Band storage is a
(2b+1, n) layout of the diagonals: row ``b+k`` holds the diagonal with
offset k, indexed by its COLUMN, ``band[b+k, j] = A[j-k, j]``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def band_mask(n: int, lower: int, upper: int) -> np.ndarray:
    """Boolean (n, n) mask: entry (i, j) is kept iff -lower <= j-i <= upper."""
    idx = np.arange(n)
    off = idx[None, :] - idx[:, None]  # j - i
    return (off >= -lower) & (off <= upper)


def mat2band(mat, lower: int, upper: int):
    """Zero out entries outside the (lower, upper) band (numpy or torch)."""
    mask = band_mask(mat.shape[-1], lower, upper)
    if isinstance(mat, torch.Tensor):
        return torch.where(torch.as_tensor(mask, device=mat.device), mat, 0.0)
    return np.where(mask, mat, 0.0)


def dense_to_band_storage(mat: np.ndarray, bandwidth: int) -> np.ndarray:
    """Extract diagonals into a (2*bandwidth+1, n) band-storage layout:
    ``out[k, j] = mat[j - (k - bandwidth), j]`` where valid, else 0."""
    n = mat.shape[-1]
    out = np.zeros((2 * bandwidth + 1, n), dtype=mat.dtype)
    for k in range(-bandwidth, bandwidth + 1):
        diag = np.diagonal(mat, offset=k)  # mat[i, i + k]
        if k >= 0:
            out[k + bandwidth, k : k + diag.shape[0]] = diag
        else:
            out[k + bandwidth, : diag.shape[0]] = diag
    return out


def band_storage_matvec_torch(
    bands: torch.Tensor, xs: torch.Tensor, bandwidth: int
) -> torch.Tensor:
    """Plain PyTorch stacked band-storage matvec, the twin of the CUDA
    kernel in ops/cuda_band.py:

        y[..., m, i] = sum_{k=-b..b} bands[m, b+k, i+k] * xs[..., m, i+k]

    with zero terms where i+k lies outside [0, n). ``bands`` is (M, W, n);
    ``xs`` is (..., M, n) with the bands shared across the leading axes.

    Both operands are zero-padded by b on each side of the grid axis, so
    that term (i, k) reads padded position i + b + k; x's windows are an
    ``unfold`` and the bands' shifted diagonals a strided view of the
    padded storage (row b+k starting at column i+b+k), which makes the
    whole contraction one product and one sum over the W diagonals.
    """
    b = bandwidth
    m, w, n = bands.shape
    width = n + 2 * b
    x_win = F.pad(xs, (b, b)).unfold(-1, w, 1)  # (..., M, n, W): x[i+k]
    b_pad = F.pad(bands, (b, b)).contiguous()
    b_diag = b_pad.as_strided((m, n, w), (w * width, 1, width + 1))  # band[b+k, i+k]
    return torch.sum(b_diag * x_win, dim=-1)


def band_storage_matvec(band: torch.Tensor, x: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """The JAX package's name for ``band_storage_matvec_torch``, taking its
    operands too: one (2b+1, n) band storage with x (..., n), or the
    port's stacked (M, 2b+1, n) storage with xs (..., M, n)."""
    if band.dim() == 2:
        return band_storage_matvec_torch(band[None], x[..., None, :], bandwidth)[..., 0, :]
    return band_storage_matvec_torch(band, x, bandwidth)


def band_matvec_pair_torch(bands_a, bands_b, xs, bandwidth: int):
    """Plain version of the paired kernel: (A x, B x)."""
    return (band_storage_matvec_torch(bands_a, xs, bandwidth),
            band_storage_matvec_torch(bands_b, xs, bandwidth))


def band_matvec_pair_t_torch(bands_a, bands_b, xs_a, xs_b, bandwidth: int):
    """Plain version of the paired kernel's backward: A x_a + B x_b."""
    return (band_storage_matvec_torch(bands_a, xs_a, bandwidth)
            + band_storage_matvec_torch(bands_b, xs_b, bandwidth))
