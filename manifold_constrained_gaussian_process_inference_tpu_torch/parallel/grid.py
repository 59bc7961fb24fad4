"""Within-posterior (time-grid) sharding: one chain's value-and-grad split
over the ranks of a mesh (port of the JAX package's parallel/grid.py).

For long grids a single likelihood-and-gradient evaluation is split along
the time axis: every rank owns a contiguous block of the grid plus a static
halo of the band operators, evaluates its block's share of the three MAGI
terms and its gradient, and one ``psum`` of (value, gradient) gives every
rank the whole. Psi stays replicated: it is the sampler's state, and the
sampler runs redundantly on every rank from a generator seeded alike, so
the ranks stay identical.

The band operators are cut into blocks on the host in float64, with their
halos baked in (``make_grid_sharded_data``, the JAX package's layout):
columns outside the global grid are zero, which reproduces the band
truncation of ``ops/band.py``, so the sharded value and gradient are the
banded path's, summed in another order. The global terms (the sigma
normalizer, the transform Jacobians) ride on rank 0.

Band-storage indexing: bs[b+k, j] = A[j-k, j], and a matvec out[i] =
sum_k bs[b+k, i+k] v[i+k]. Output rows [s0, s0+m) need storage columns and
input entries [s0-b, s0+m+b). The haloed matvec of the JAX package,
out[j] = sum_k bs[b+k, j+b+k] v[j+b+k] over a local storage of length L,
is rows [b, L-b) of the ordinary banded matvec of that storage (no term of
those rows falls outside [0, L)), so it runs on ``ops/cuda_band``'s kernel
(K1), the backward on the local storage's transpose. mphi on the
(nloc+4b) block and GC^T, its storage zero-padded by b columns a side to
the same length, share one paired launch; GK^T is a single launch: the 2
single + 1 pair + 1 pair_t launches of a banded value-and-grad.

On the card the local part is replayed from a CUDA graph
(``parallel/chains.GraphedValueAndGrad`` captures ``local`` and runs
``reduce``, the psum, after each replay).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..inference.target import LOG_SIGMA_CLAMP, value_and_grad
from ..inference.transforms import constrain, transform_tensors
from ..ops.band import dense_to_band_storage
from ..ops.cuda_band import band_matvec, band_matvec_pair, transpose_band_storage
from ..ops.likelihood import LOG_2PI, _np64, _resolve_mean
from .mesh import GRID_AXIS, Mesh


def make_grid_mesh(n_devices=None, device=None) -> Mesh:
    """``Mesh.world`` along the grid axis (the JAX package's name)."""
    return Mesh.world(GRID_AXIS, n_devices, device)


class GridBlocks(NamedTuple):
    """Per-rank constant blocks, host float64 with a leading n_dev axis.

    Haloed band storages:
      mphi_h: (n_dev, D, 2b+1, nloc+4b) -- output rows [s-b, s+nloc+b)
      gkt_h:  (n_dev, D, 2b+1, nloc+2b) -- output rows [s, s+nloc)
      gct_h:  (n_dev, D, 2b+1, nloc+2b)
    Haloed pointwise data: tvec_h2, mu_h4, dotmu_h2, on the ranges their
    consumers need. Local observations: yobs_loc / mask_loc (n_dev, nloc, D).
    """

    mphi_h: np.ndarray
    gkt_h: np.ndarray
    gct_h: np.ndarray
    tvec_h2: np.ndarray
    mu_h4: np.ndarray
    dotmu_h2: np.ndarray
    yobs_loc: np.ndarray
    mask_loc: np.ndarray


class GridShardedData(NamedTuple):
    """Everything the sharded log-posterior closes over; ``dtype`` is the
    working dtype of the value-and-grad."""

    blocks: GridBlocks
    nobs: np.ndarray   # (D,) global finite-observation counts
    beta: np.ndarray   # (3,)
    n: int
    nloc: int
    bandwidth: int
    n_dev: int
    dtype: torch.dtype


def _slice_cols_with_zeros(arr: np.ndarray, start: int, width: int) -> np.ndarray:
    """arr[..., start:start+width] where out-of-range columns are zero."""
    out = np.zeros(arr.shape[:-1] + (width,), dtype=arr.dtype)
    lo, hi = max(start, 0), min(start + width, arr.shape[-1])
    if hi > lo:
        out[..., lo - start : hi - start] = arr[..., lo:hi]
    return out


def _slice_rows_with_edge(arr: np.ndarray, start: int, width: int) -> np.ndarray:
    """arr[start:start+width] along axis 0; out-of-range rows clamp to the
    nearest valid row (tvec and mu, so the ODE f sees finite inputs)."""
    idx = np.clip(np.arange(start, start + width), 0, arr.shape[0] - 1)
    return arr[idx]


def make_grid_sharded_data(
    yobs: np.ndarray,
    gp_cov,
    prior_temperature,
    n_dev: int,
    dtype=None,
    mu=None,
    dotmu=None,
) -> GridShardedData:
    """The per-rank blocks of all n_dev ranks, built on the host in float64
    (the JAX package's construction); ``dtype`` (default: gp_cov's) is the
    dtype the value-and-grad runs in."""
    if dtype is None:
        dtype = gp_cov.Cinv_band.dtype
    yobs = np.asarray(yobs, dtype=np.float64)
    mask = np.isfinite(yobs)
    n, d = yobs.shape
    b = int(gp_cov.bandsize)
    nloc = -(-n // n_dev)  # ceil: the last block zero-padded

    mu_np, dotmu_np = _resolve_mean(mu, n, d), _resolve_mean(dotmu, n, d)

    def storage(stack):
        return np.stack([dense_to_band_storage(a, b) for a in _np64(stack)])

    def storage_t(stack):
        return np.stack([transpose_band_storage(s, b) for s in storage(stack)])

    mphi_bs = storage(gp_cov.mphi_band)            # (D, 2b+1, n)
    gkt_bs = storage_t(gp_cov.Kinv_band_chol)
    gct_bs = storage_t(gp_cov.Cinv_band_chol)
    yobs_filled = np.where(mask, yobs, 0.0)
    maskf = mask.astype(np.float64)
    tvec_np = _np64(gp_cov.tvec)

    parts = {name: [] for name in GridBlocks._fields}
    for rank in range(n_dev):
        s = rank * nloc
        parts["mphi_h"].append(_slice_cols_with_zeros(mphi_bs, s - 2 * b, nloc + 4 * b))
        parts["gkt_h"].append(_slice_cols_with_zeros(gkt_bs, s - b, nloc + 2 * b))
        parts["gct_h"].append(_slice_cols_with_zeros(gct_bs, s - b, nloc + 2 * b))
        parts["tvec_h2"].append(_slice_rows_with_edge(tvec_np, s - b, nloc + 2 * b))
        parts["mu_h4"].append(_slice_rows_with_edge(mu_np, s - 2 * b, nloc + 4 * b))
        parts["dotmu_h2"].append(_slice_rows_with_edge(dotmu_np, s - b, nloc + 2 * b))
        parts["yobs_loc"].append(_slice_cols_with_zeros(yobs_filled.T, s, nloc).T)
        parts["mask_loc"].append(_slice_cols_with_zeros(maskf.T, s, nloc).T)
    return GridShardedData(
        blocks=GridBlocks(**{name: np.stack(p) for name, p in parts.items()}),
        nobs=mask.sum(axis=0).astype(np.float64),
        beta=np.asarray(prior_temperature, dtype=np.float64),
        n=n, nloc=nloc, bandwidth=b, n_dev=n_dev, dtype=dtype,
    )


class GridValueAndGrad:
    """The grid-sharded value-and-grad of one rank: psi (..., dim) ->
    (value (...), grad (..., dim)), the same on every rank. ``local`` is this
    rank's partial value and gradient (no collective), ``reduce`` their
    psum; a call is ``reduce(*local(psi))``."""

    def __init__(self, data: GridShardedData, system, sigma_init, sigma_is_fixed: bool,
                 mesh: Mesh, theta_transform=None):
        if data.n_dev != mesh.size:
            raise ValueError(f"grid data for {data.n_dev} ranks on a mesh of {mesh.size}")
        self.mesh = mesh
        self.n, self.nloc, self.b = data.n, data.nloc, data.bandwidth
        self.d = int(data.blocks.yobs_loc.shape[-1])
        self.k = system.theta_size
        self.sigma_is_fixed = sigma_is_fixed
        self.ode_f = system.f
        rank, b = mesh.rank, self.b

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=data.dtype, device=mesh.device)

        def transposed(bs):
            return np.stack([transpose_band_storage(s, b) for s in bs])

        blk = GridBlocks(*(a[rank] for a in data.blocks))
        # GC^T on the mphi block's length: b zero columns a side
        gct4 = np.pad(blk.gct_h, ((0, 0), (0, 0), (b, b)))
        self.mphi, self.mphi_t = put(blk.mphi_h), put(transposed(blk.mphi_h))
        self.gct4, self.gct4_t = put(gct4), put(transposed(gct4))
        self.gkt, self.gkt_t = put(blk.gkt_h), put(transposed(blk.gkt_h))
        self.tvec_h2 = put(blk.tvec_h2)
        self.mu_h4 = put(blk.mu_h4.T)              # (D, nloc+4b)
        self.dotmu_h2 = put(blk.dotmu_h2.T)        # (D, nloc+2b)
        self.yobs_loc = put(blk.yobs_loc.T)        # (D, nloc)
        self.mask_loc = put(blk.mask_loc.T)
        self.nobs, self.beta = put(data.nobs), put(data.beta)
        self.sigma_fixed = put(np.asarray(sigma_init, dtype=np.float64))
        self.theta_consts = (None if theta_transform is None
                             else transform_tensors(theta_transform, data.dtype, mesh.device))
        self.on_rank0 = 1.0 if rank == 0 else 0.0
        self.start = rank * data.nloc
        self.pad_hi = 2 * b + data.nloc * data.n_dev - data.n
        self.local = value_and_grad(self._local_logdensity)

    def _local_logdensity(self, psi: torch.Tensor) -> torch.Tensor:
        """This rank's share of the log-posterior at psi (..., dim)."""
        n, nloc, b, d, k = self.n, self.nloc, self.b, self.d, self.k
        lead = psi.shape[:-1]
        psi = psi.reshape(-1, psi.shape[-1])
        x = psi[:, : n * d].reshape(-1, d, n)      # (C, D, n)
        theta = psi[:, n * d : n * d + k]
        jac = torch.zeros(psi.shape[0], dtype=psi.dtype, device=psi.device)
        if self.theta_consts is not None:
            theta, tjac = constrain(self.theta_consts, theta)
            jac = jac + tjac
        if self.sigma_is_fixed:
            sigma = self.sigma_fixed
        else:
            clamped = torch.clamp(psi[:, n * d + k :], -LOG_SIGMA_CLAMP, LOG_SIGMA_CLAMP)
            sigma = torch.exp(clamped)
            jac = jac + torch.sum(clamped, dim=-1)
        # rows [s-2b, s+nloc+2b) of x, zero beyond the grid (the right pad
        # covers the last block's ceil-division slack too)
        xh4 = F.pad(x, (2 * b, self.pad_hi))[..., self.start : self.start + nloc + 4 * b]
        xh4c = xh4 - self.mu_h4
        xh2 = xh4[..., b : b + nloc + 2 * b]
        xloc = xh4[..., 2 * b : 2 * b + nloc]
        f_h2 = self.ode_f(xh2.transpose(-1, -2), theta, self.tvec_h2).transpose(-1, -2)
        mphi_x, gc_x = band_matvec_pair(self.mphi, self.mphi_t, self.gct4, self.gct4_t, xh4c, b)
        e_h2 = f_h2 - self.dotmu_h2 - mphi_x[..., b : b + nloc + 2 * b]
        gk_e = band_matvec(self.gkt, self.gkt_t, e_h2, b)[..., b : b + nloc]
        gc_x = gc_x[..., 2 * b : 2 * b + nloc]
        resid = self.mask_loc * (xloc - self.yobs_loc)
        sse = torch.sum(resid * resid, dim=-1)     # (C, D)
        qd = torch.sum(gk_e * gk_e, dim=-1)
        ql = torch.sum(gc_x * gc_x, dim=-1)
        sigma_sq = sigma * sigma
        ll_obs_local = -0.5 * torch.sum(sse / sigma_sq, dim=-1)
        norm = -0.5 * torch.sum(
            self.nobs * (LOG_2PI + torch.log(sigma_sq)) * (self.nobs > 0), dim=-1)
        beta_deriv, beta_level, beta_obs = self.beta.unbind()
        out = ((ll_obs_local + self.on_rank0 * norm) / beta_obs
               - 0.5 * torch.sum(qd, dim=-1) / beta_deriv
               - 0.5 * torch.sum(ql, dim=-1) / beta_level
               + self.on_rank0 * jac)
        return out.reshape(lead)

    def reduce(self, value: torch.Tensor, grad: torch.Tensor):
        """The ranks' partial values and gradients summed, in one all_reduce."""
        total = self.mesh.psum(torch.cat([value[..., None], grad], dim=-1))
        return total[..., 0], total[..., 1:]

    def __call__(self, psi: torch.Tensor):
        return self.reduce(*self.local(psi))


def make_grid_value_and_grad(
    data: GridShardedData,
    system,
    sigma_init,
    sigma_is_fixed: bool,
    mesh: Mesh,
    theta_transform=None,
) -> GridValueAndGrad:
    """The grid-sharded value-and-grad of the MAGI log-posterior over Psi
    (..., dim) on this rank: the Psi layout of ``MagiTarget.value_and_grad_fn``
    ([vec(X) column-major; theta; log_sigma?], log sigma clamped at +-15 with
    its Jacobian, the optional bounded theta transform). Every rank calls it
    with the same psi and gets the same result."""
    return GridValueAndGrad(data, system, sigma_init, sigma_is_fixed, mesh, theta_transform)


def make_grid_logdensity(
    data: GridShardedData,
    system,
    sigma_init,
    sigma_is_fixed: bool,
    mesh: Mesh,
    theta_transform=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Value-only variant of make_grid_value_and_grad."""
    vg = make_grid_value_and_grad(data, system, sigma_init, sigma_is_fixed, mesh, theta_transform)
    return lambda psi: vg(psi)[0]
