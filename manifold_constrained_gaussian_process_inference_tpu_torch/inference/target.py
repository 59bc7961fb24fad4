"""The MAGI posterior target: packing, unpacking, and the value-and-grad
function the sampler consumes (port of the JAX package's
inference/target.py).

Psi layout: [vec(X) column-major (n*D); theta (k); log_sigma (D) if sigma
is sampled]. Every function over Psi takes leading batch axes: psi
(..., dim) -> (...), so one call evaluates all chains.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.base import OdeSystem
from ..ops.gp_cov import GPCov
from ..ops.likelihood import (
    BandedLikelihoodData,
    log_posterior,
    log_posterior_banded,
    make_banded_likelihood_data,
    make_likelihood_data,
)
from .transforms import constrain, transform_tensors

LOG_SIGMA_CLAMP = 15.0

BAND_IMPLS = ("dense", "band")


def check_band_impl(band_impl: str) -> None:
    if band_impl == "pallas":
        raise ValueError(
            "band_impl='pallas' names the TPU kernel; in the PyTorch port the "
            "band-storage path is band_impl='band' (CUDA kernel on a card)."
        )
    if band_impl not in BAND_IMPLS:
        raise ValueError(f"unknown band_impl '{band_impl}'")


def value_and_grad(logdensity: Callable) -> Callable:
    """psi (..., dim) -> (logdensity (...), d logdensity / d psi (..., dim)).
    Batch entries are independent, so the gradient of the sum is the
    per-entry gradient."""

    def vg(psi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        psi = psi.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = logdensity(psi)
            (g,) = torch.autograd.grad(lp.sum(), psi)
        return lp.detach(), g

    return vg


@dataclasses.dataclass(frozen=True)
class MagiTarget:
    """The problem as the sampler sees it. ``sigma_init`` is the fixed
    sigma when ``sigma_is_fixed``, else only the initialization value."""

    system: OdeSystem
    data: object  # LikelihoodData | BandedLikelihoodData
    sigma_init: torch.Tensor
    n_times: int
    n_dims: int
    n_params_ode: int
    sigma_is_fixed: bool
    bandwidth: int = 0
    theta_transform: object = None
    # the transform's constants on the data's device (transforms.TransformTensors)
    theta_consts: object = None

    @classmethod
    def build(
        cls,
        yobs: np.ndarray,
        gp_cov: GPCov,
        system: OdeSystem,
        sigma_init,
        prior_temperature,
        sigma_is_fixed: bool,
        dtype=None,
        band_impl: str = "dense",
        theta_transform=None,
        gp_mean=None,
        gp_mean_deriv=None,
        device=None,
    ) -> "MagiTarget":
        """band_impl: "dense" (D, n, n) stacks, or "band" (D, 2b+1, n)
        storage through ops/cuda_band.band_matvec. dtype/device default to
        those of ``gp_cov``."""
        check_band_impl(band_impl)
        make = make_likelihood_data if band_impl == "dense" else make_banded_likelihood_data
        data = make(
            yobs, gp_cov, prior_temperature, dtype=dtype, device=device,
            mu=gp_mean, dotmu=gp_mean_deriv,
        )
        n, d = np.asarray(yobs).shape
        return cls(
            system=system,
            data=data,
            sigma_init=torch.as_tensor(
                np.asarray(sigma_init, dtype=np.float64),
                dtype=data.mask.dtype, device=data.mask.device,
            ),
            n_times=n,
            n_dims=d,
            n_params_ode=system.theta_size,
            sigma_is_fixed=sigma_is_fixed,
            bandwidth=gp_cov.bandsize,
            theta_transform=theta_transform,
            theta_consts=None if theta_transform is None else transform_tensors(
                theta_transform, data.mask.dtype, data.mask.device
            ),
        )

    @property
    def dimension(self) -> int:
        """Sampled dimension: n*D + k (+ D when sigma is sampled)."""
        dim = self.n_times * self.n_dims + self.n_params_ode
        return dim if self.sigma_is_fixed else dim + self.n_dims

    @property
    def banded(self) -> bool:
        return isinstance(self.data, BandedLikelihoodData)

    # -- packing ------------------------------------------------------------

    def pack(self, x, theta, log_sigma=None) -> torch.Tensor:
        """(..., n, D), (..., k), (..., D) -> psi (..., dim)."""
        x = torch.as_tensor(x)
        lead = x.shape[:-2]
        parts = [x.transpose(-1, -2).reshape(*lead, -1), torch.as_tensor(theta)]
        if not self.sigma_is_fixed:
            if log_sigma is None:
                raise ValueError("log_sigma required when sigma is sampled")
            parts.append(torch.as_tensor(log_sigma))
        return torch.cat(parts, dim=-1)

    def unpack(self, psi) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """psi (..., dim) -> (x (..., n, D), theta (..., k), log_sigma (..., D)
        or None)."""
        n, d, k = self.n_times, self.n_dims, self.n_params_ode
        lead = psi.shape[:-1]
        x = psi[..., : n * d].reshape(*lead, d, n).transpose(-1, -2)
        theta = psi[..., n * d : n * d + k]
        if self.sigma_is_fixed:
            return x, theta, None
        return x, theta, psi[..., n * d + k :]

    # -- densities ----------------------------------------------------------

    def constrained_theta_sigma(self, theta, log_sigma):
        """Apply the theta transform and the log-sigma map; returns
        (theta, sigma, log-Jacobian (...))."""
        jacs = []
        if self.theta_consts is not None:
            theta, theta_jac = constrain(self.theta_consts, theta)
            jacs.append(theta_jac)
        sigma = self.sigma_init
        if not self.sigma_is_fixed:
            clamped = torch.clamp(log_sigma, -LOG_SIGMA_CLAMP, LOG_SIGMA_CLAMP)
            sigma = torch.exp(clamped)
            jacs.append(torch.sum(clamped, dim=-1))
        if not jacs:
            jacs.append(torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device))
        return theta, sigma, jacs[0] if len(jacs) == 1 else jacs[0] + jacs[1]

    def logdensity_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Log-posterior over packed Psi (..., dim) -> (...). Sampled sigma
        is exp(clamp(log_sigma, +-15)) with the log-Jacobian sum(log_sigma)."""

        def logdensity(psi):
            x, theta, log_sigma = self.unpack(psi)
            theta, sigma, jac = self.constrained_theta_sigma(theta, log_sigma)
            if self.banded:
                ll = log_posterior_banded(
                    x, theta, sigma, self.data, self.system.f, self.bandwidth
                )
            else:
                ll = log_posterior(x, theta, sigma, self.data, self.system.f)
            return ll + jac

        return logdensity

    def value_and_grad_fn(self) -> Callable:
        """psi (..., dim) -> (value (...), grad (..., dim)). Non-finite
        values are returned as they are; NUTS treats them as divergences."""
        return value_and_grad(self.logdensity_fn())
