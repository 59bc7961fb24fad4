"""The MAGI log-posterior, the hot path (port of the JAX package's
ops/likelihood.py).

Every evaluation function takes states with leading batch axes written out:
x (..., n, D), theta (..., k), sigma (..., D) -> (...). The chain axis of
the sampler is such a leading axis. Gradients come from torch.autograd of
the scalar value, as the JAX package's come from reverse-mode autodiff.

Three tempered terms per dimension d:
  ll_obs   = -[ SSE_d / sigma_d^2 + N_d log(2 pi sigma_d^2) ] / 2   (finite obs only)
  ll_deriv = -(f_d - mphi_d x_d)^T Kinv_d (f_d - mphi_d x_d) / 2
  ll_level = -x_d^T Cinv_d x_d / 2
  ll = sum_d [ ll_obs/beta_obs + ll_deriv/beta_deriv + ll_level/beta_level ]
with beta = prior_temperature = [beta_deriv, beta_level, beta_obs]. The
quadratic forms are sums of squares through the banded Cholesky factors
(||GKt e||^2, ||GCt x||^2), which keeps them accurate in float32.

Contractions are torch.matmul/einsum in true float32 on a CUDA card: the
package pins TF32 off at import (see the package __init__), the counterpart
of the JAX package's Precision.HIGHEST.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .band import dense_to_band_storage
from .cuda_band import band_matvec, band_matvec_pair, transpose_band_storage
from .gp_cov import GPCov

LOG_2PI = float(np.log(2.0 * np.pi))


class LikelihoodData(NamedTuple):
    """Static tensors of the dense-layout likelihood.

    yobs_filled (n, D) observations with NaN -> 0; mask (n, D) 1.0 where
    finite; nobs (D,); tvec (n,); GKt (D, n, n) transposed banded Cholesky
    factor of Kinv_band; mphi_gct (2D, n, n) the fused stack [mphi; GCt];
    beta (3,) [beta_deriv, beta_level, beta_obs]; mu, dotmu (n, D) the GP
    prior mean and its derivative.
    """

    yobs_filled: torch.Tensor
    mask: torch.Tensor
    nobs: torch.Tensor
    tvec: torch.Tensor
    GKt: torch.Tensor
    mphi_gct: torch.Tensor
    beta: torch.Tensor
    mu: torch.Tensor
    dotmu: torch.Tensor


class BandedLikelihoodData(NamedTuple):
    """Band-storage variant: the (D, n, n) stacks become (D, 2b+1, n)
    diagonal storage (ops/band.py); *_t fields hold the transposed
    operators' storage for the backward pass of ``band_matvec``."""

    yobs_filled: torch.Tensor
    mask: torch.Tensor
    nobs: torch.Tensor
    tvec: torch.Tensor
    mphi_bs: torch.Tensor
    mphi_t_bs: torch.Tensor
    GKt_bs: torch.Tensor
    GK_bs: torch.Tensor
    GCt_bs: torch.Tensor
    GC_bs: torch.Tensor
    beta: torch.Tensor
    mu: torch.Tensor
    dotmu: torch.Tensor


def _resolve_mean(mean, n: int, d: int) -> np.ndarray:
    """A GP mean as an (n, D) float64 array: None -> zeros, (D,) -> tiled."""
    if mean is None:
        return np.zeros((n, d))
    arr = np.asarray(mean, dtype=np.float64)
    return np.broadcast_to(arr, (n, d)).copy() if arr.ndim == 1 else arr


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


def _common_fields(yobs, gp_cov: GPCov, prior_temperature, mu, dotmu, put):
    yobs = np.asarray(yobs, dtype=np.float64)
    mask = np.isfinite(yobs)
    n, d = yobs.shape
    return dict(
        yobs_filled=put(np.where(mask, yobs, 0.0)),
        mask=put(mask.astype(np.float64)),
        nobs=put(mask.sum(axis=0).astype(np.float64)),
        tvec=put(_np64(gp_cov.tvec)),
        beta=put(np.asarray(prior_temperature, dtype=np.float64)),
        mu=put(_resolve_mean(mu, n, d)),
        dotmu=put(_resolve_mean(dotmu, n, d)),
    )


def _putter(gp_cov: GPCov, dtype, device):
    dtype = gp_cov.Cinv_band.dtype if dtype is None else dtype
    device = gp_cov.Cinv_band.device if device is None else device
    return lambda a: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dtype, device=device
    )


def make_likelihood_data(
    yobs, gp_cov: GPCov, prior_temperature, dtype=None, device=None,
    mu=None, dotmu=None,
) -> LikelihoodData:
    """Masks, fills and the fused operator stacks. NaN observations are
    masked out. dtype/device default to those of ``gp_cov``."""
    put = _putter(gp_cov, dtype, device)
    gkt = np.swapaxes(_np64(gp_cov.Kinv_band_chol), -1, -2)
    mphi_gct = np.concatenate(
        [_np64(gp_cov.mphi_band), np.swapaxes(_np64(gp_cov.Cinv_band_chol), -1, -2)],
        axis=0,
    )
    return LikelihoodData(
        **_common_fields(yobs, gp_cov, prior_temperature, mu, dotmu, put),
        GKt=put(gkt), mphi_gct=put(mphi_gct),
    )


def make_banded_likelihood_data(
    yobs, gp_cov: GPCov, prior_temperature, dtype=None, device=None,
    mu=None, dotmu=None,
) -> BandedLikelihoodData:
    """Band storage of mphi, GK^T and GC^T and of their transposes, built on
    the host in float64 and emitted in the working dtype and device."""
    put = _putter(gp_cov, dtype, device)
    b = gp_cov.bandsize

    def storage(stack):
        return np.stack([dense_to_band_storage(a, b) for a in _np64(stack)])

    def storage_t(bs):
        return np.stack([transpose_band_storage(a, b) for a in bs])

    mphi_bs = storage(gp_cov.mphi_band)
    gk_bs = storage(gp_cov.Kinv_band_chol)  # lower factor GK
    gc_bs = storage(gp_cov.Cinv_band_chol)
    return BandedLikelihoodData(
        **_common_fields(yobs, gp_cov, prior_temperature, mu, dotmu, put),
        mphi_bs=put(mphi_bs), mphi_t_bs=put(storage_t(mphi_bs)),
        GKt_bs=put(storage_t(gk_bs)), GK_bs=put(gk_bs),
        GCt_bs=put(storage_t(gc_bs)), GC_bs=put(gc_bs),
    )


def _stack_matvec(stack: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[..., i, d] = sum_j stack[d, i, j] v[..., j, d]: one batched GEMM
    over the D operators."""
    return torch.einsum("dij,...jd->...id", stack, v)


def _combine(data, resid, gk_e, gc, sigma) -> torch.Tensor:
    """Tempered sum of the three terms from the observation residuals
    (..., n, D) and the factor products gk_e, gc (either layout: both grid
    and state axes are summed)."""
    beta_deriv, beta_level, beta_obs = data.beta.unbind()
    sigma_sq = sigma * sigma
    sse = torch.sum(resid * resid, dim=-2)  # (..., D)
    obs = torch.sum(sse / sigma_sq + data.nobs * (LOG_2PI + torch.log(sigma_sq)), dim=-1)
    quad = (
        torch.sum(gk_e * gk_e, dim=(-2, -1)) / beta_deriv
        + torch.sum(gc * gc, dim=(-2, -1)) / beta_level
    )
    return -0.5 * (obs / beta_obs + quad)


def log_posterior(x, theta, sigma, data: LikelihoodData, ode_f: Callable):
    """MAGI log-posterior (un-normalized) at x (..., n, D), theta (..., k),
    sigma (..., D); dense (D, n, n) layout."""
    f = ode_f(x, theta, data.tvec)
    xc = x - data.mu
    d = x.shape[-1]
    fused = _stack_matvec(data.mphi_gct, torch.cat([xc, xc], dim=-1))
    e_deriv = f - data.dotmu - fused[..., :d]
    gk_e = _stack_matvec(data.GKt, e_deriv)
    resid = data.mask * (x - data.yobs_filled)
    return _combine(data, resid, gk_e, fused[..., d:], sigma)


def log_posterior_banded(
    x, theta, sigma, data: BandedLikelihoodData, ode_f: Callable, bandwidth: int
):
    """log_posterior through band-storage matvecs (the CUDA kernel on a
    card, its plain version on the CPU): mphi x and GC^T x in one paired
    launch, then GK^T e, so two launches forward and two backward."""
    f = ode_f(x, theta, data.tvec)
    xct = (x - data.mu).transpose(-1, -2)  # (..., D, n)
    mphi_x, gc_x = band_matvec_pair(
        data.mphi_bs, data.mphi_t_bs, data.GCt_bs, data.GC_bs, xct, bandwidth
    )
    e_deriv = (f - data.dotmu).transpose(-1, -2) - mphi_x
    gk_e = band_matvec(data.GKt_bs, data.GK_bs, e_deriv, bandwidth)
    resid = data.mask * (x - data.yobs_filled)
    return _combine(data, resid, gk_e, gc_x, sigma)


class CenteredTerms(NamedTuple):
    """Constants of the mode-centered evaluation, computed on the host in
    float64 from the data's own (upcast) operators. With dx = x - x_ref
    every on-device operator product consumes only dx, so float32
    cancellation noise scales with the posterior width instead of |x|.
    All fields are (n, D) in the data's dtype and device."""

    x_ref: torch.Tensor   # the centering state
    r_ref: torch.Tensor   # x_ref - yobs_filled
    c_e: torch.Tensor     # dotmu + mphi (x_ref - mu)
    c_gc: torch.Tensor    # GCt (x_ref - mu)


def _band_storage_matvec_np(bs: np.ndarray, x: np.ndarray, b: int) -> np.ndarray:
    """Float64 host band-storage matvec: out[i] = sum_k bs[b+k, i+k] x[i+k]."""
    n = x.shape[0]
    out = np.zeros(n)
    for k in range(-b, b + 1):
        lo, hi = max(0, -k), min(n, n - k)
        out[lo:hi] += bs[b + k, lo + k : hi + k] * x[lo + k : hi + k]
    return out


def make_centered_terms(data, x_ref, bandwidth: int = 0) -> CenteredTerms:
    """Precompute the x_ref-dependent constants (host, float64)."""
    xr = np.asarray(x_ref, dtype=np.float64)
    xc = xr - _np64(data.mu)
    d = xr.shape[1]
    if isinstance(data, BandedLikelihoodData):
        mphi64, gct64 = _np64(data.mphi_bs), _np64(data.GCt_bs)
        c_mphi = np.stack(
            [_band_storage_matvec_np(mphi64[p], xc[:, p], bandwidth) for p in range(d)],
            axis=-1,
        )
        c_gc = np.stack(
            [_band_storage_matvec_np(gct64[p], xc[:, p], bandwidth) for p in range(d)],
            axis=-1,
        )
    else:
        stack64 = _np64(data.mphi_gct)
        c_mphi = np.einsum("dij,jd->id", stack64[:d], xc)
        c_gc = np.einsum("dij,jd->id", stack64[d:], xc)
    like = data.mask
    put = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return CenteredTerms(
        x_ref=put(xr),
        r_ref=put(xr - _np64(data.yobs_filled)),
        c_e=put(_np64(data.dotmu) + c_mphi),
        c_gc=put(c_gc),
    )


def log_posterior_centered(
    dx, theta, sigma, data, cent: CenteredTerms, ode_f: Callable, bandwidth: int = 0
):
    """log_posterior at x = x_ref + dx, dx (..., n, D), evaluated so that
    every operator product consumes only dx (see CenteredTerms). The banded
    branch runs its products on the (..., D, n) layout as
    ``log_posterior_banded`` does: mphi dx and GC^T dx paired, then GK^T e."""
    f = ode_f(cent.x_ref + dx, theta, data.tvec)
    d = dx.shape[-1]
    if isinstance(data, BandedLikelihoodData):
        dxt = dx.transpose(-1, -2)  # (..., D, n)
        mphi_dx, gc_dx = band_matvec_pair(
            data.mphi_bs, data.mphi_t_bs, data.GCt_bs, data.GC_bs, dxt, bandwidth
        )
        e = (f - cent.c_e).transpose(-1, -2) - mphi_dx
        gk_e = band_matvec(data.GKt_bs, data.GK_bs, e, bandwidth)
        gc = cent.c_gc.transpose(-1, -2) + gc_dx
    else:
        fused = _stack_matvec(data.mphi_gct, torch.cat([dx, dx], dim=-1))
        gk_e = _stack_matvec(data.GKt, f - cent.c_e - fused[..., :d])
        gc = cent.c_gc + fused[..., d:]
    resid = data.mask * (dx + cent.r_ref)
    return _combine(data, resid, gk_e, gc, sigma)


def log_likelihood_and_gradient_banded(
    x, theta, sigma, yobs, gp_cov: GPCov, ode_f: Callable,
    prior_temperature=(1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parity API: value and flat gradient of length n*D + k + D, laid out
    [vec(X) column-major; theta; sigma] with the sigma slot always present.
    The gradient is autograd of ``log_posterior``."""
    x = torch.as_tensor(x)
    data = make_likelihood_data(
        yobs, gp_cov, prior_temperature, dtype=x.dtype, device=x.device
    )
    args = [
        torch.as_tensor(a, dtype=x.dtype, device=x.device).detach().requires_grad_(True)
        for a in (x, theta, sigma)
    ]
    with torch.enable_grad():
        ll = log_posterior(*args, data, ode_f)
        gx, gt, gs = torch.autograd.grad(ll, args)
    flat = torch.cat([gx.transpose(-1, -2).reshape(-1), gt, gs])
    return ll.detach(), flat
