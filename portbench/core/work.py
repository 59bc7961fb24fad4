"""The chip's published peaks and the primitives of every operation and
byte count; each per-layer metric's module composes its own counts from
them. Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67
TFLOP/s float32 outside the tensor cores and 3.35 TB/s of HBM, at the
card's full 700 W. Counts are at the configurations' float32, each input
byte read once and each output byte written once, a multiply-add two
operations; a part's least time is the larger of its operations over the
float32 peak and its bytes over the bandwidth. Frozen copies of the port's
counts (``ops/centered_vg.bound_work``, ``ops/minv_mv.product_work``,
``perf/band_timing.bound_ms``, ``ops/leaf.commit_bytes``)."""
from __future__ import annotations

import numpy as np

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
ITEMSIZE = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def band_terms(b: int, n: int) -> int:
    """Products y[i] += A[i, j] x[j] of a band of half-width b with both i
    and j on the grid."""
    i = np.arange(n)
    return int(np.sum(np.minimum(n - 1, i + b) - np.maximum(0, i - b) + 1))


def band_products(c: int, m: int, b: int, n: int, n_bands: int, n_in: int, n_out: int):
    """(flops, bytes) of one launch of n_bands banded products over C
    chains and M state dimensions: the bands read once, n_in inputs read
    and n_out outputs written."""
    flops = 2 * n_bands * c * m * band_terms(b, n)
    nbytes = ITEMSIZE * (n_bands * m * (2 * b + 1) * n + (n_in + n_out) * c * m * n)
    return flops, nbytes


def k1_launches(c: int, m: int, b: int, n: int):
    """The banded value-and-grad's four K1 launches: forward the pair (mphi
    x, GC^T x) and the single GK^T e; backward the single GK and the pair's
    transpose A^T y_a + B^T y_b."""
    return [band_products(c, m, b, n, 2, 1, 2), band_products(c, m, b, n, 1, 1, 1),
            band_products(c, m, b, n, 1, 1, 1), band_products(c, m, b, n, 2, 2, 1)]


def centered_vg(c: int, n: int, b: int, dim: int, m: int = 2, n_scalars: int = 15):
    """(flops, bytes) of one launch of the whitened FN value-and-grad: dpsi
    read, g_psi and lp written, six band storages and five (D, n) fields
    read once; six banded products per output row."""
    i = np.arange(n)
    terms = int(np.sum(np.minimum(b, n - 1 - i) + np.minimum(b, i) + 1))
    flops = 2 * 6 * c * m * terms
    nbytes = ITEMSIZE * (2 * c * dim + c + 6 * m * (2 * b + 1) * n + 5 * m * n + n_scalars)
    return flops, nbytes


def dense_product(c: int, dim: int, n_mats: int = 1):
    """(flops, bytes) of M^-1 g for C chains: n_mats (dim, dim) operands
    read once, g read and the product written."""
    return 2 * c * dim * dim, ITEMSIZE * (n_mats * dim * dim + 2 * c * dim)


def commit_bytes(c: int, dim: int, alive: float, metric: str) -> float:
    """Bytes of a leaf's commit after its value-and-grad, ``alive`` of C
    chains alive on average: per alive chain the leaf state read (p, v, g,
    mg of the current leaf, q, g and mg of the new one; a diagonal metric's
    row), the new state (five rows), rho and a checkpoint row (three rows)
    written; per chain not alive three rows read; per chain its next
    position written (``ops/leaf.commit_bytes`` at no take)."""
    per_alive = 4 + 3 + (metric == "diag") + 5 + 1 + 3
    return ITEMSIZE * ((alive * per_alive + 3 * (c - alive) + c) * dim + 2 * c + 9 * alive)
