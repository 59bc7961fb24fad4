"""GP kernels and their analytic time-derivative cross-covariances (port of
the JAX package's ops/kernels.py): Matern-5/2, RBF and the general Matern
of any smoothness nu > 0 ("matern-<nu>").

Every function accepts numpy arrays (the float64 host setup path) or torch
tensors (the differentiable NLML objective); the math is elementwise.

Conventions:
- ``C[i, j]     = k(t_i, t_j)``
- ``Cprime[i,j] = d k(t_i, t_j) / d t_i``            (anti-symmetric, zero diag)
- ``Cdoubleprime[i,j] = d^2 k(t_i, t_j) / dt_i dt_j`` (symmetric)
"""
from __future__ import annotations

import math
import warnings
from typing import Tuple

import numpy as np
import scipy.special
import torch

SQRT5 = math.sqrt(5.0)

_SUPPORTED_KERNELS = ("matern52", "rbf")


def _xp(*arrays):
    """torch if any input is a tensor, else numpy."""
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


def matern52_k(r, variance, lengthscale):
    """Matern-5/2: sigma^2 (1 + sqrt5 r/l + 5 r^2/(3 l^2)) exp(-sqrt5 r/l)."""
    xp = _xp(r, variance, lengthscale)
    s = SQRT5 * r / lengthscale
    return variance * (1.0 + s + s * s / 3.0) * xp.exp(-s)


def rbf_k(r, variance, lengthscale):
    """Squared-exponential: sigma^2 exp(-r^2 / (2 l^2))."""
    xp = _xp(r, variance, lengthscale)
    return variance * xp.exp(-0.5 * (r / lengthscale) ** 2)


class BesselKv(torch.autograd.Function):
    """K_nu(z) for a fixed order nu, evaluated by ``scipy.special.kv`` on the
    host in float64 and returned in z's dtype and device. Its derivative is
    the recurrence d/dz K_nu(z) = -(K_{nu-1}(z) + K_{nu+1}(z)) / 2, itself
    made of this Function, so the NLML optimizer differentiates through a
    Matern kernel of any nu."""

    @staticmethod
    def forward(ctx, z, nu):
        ctx.save_for_backward(z)
        ctx.nu = nu
        host = scipy.special.kv(nu, z.detach().to("cpu", torch.float64).numpy())
        return torch.as_tensor(host, dtype=z.dtype, device=z.device)

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        nu = ctx.nu
        dk = -0.5 * (BesselKv.apply(z, nu - 1.0) + BesselKv.apply(z, nu + 1.0))
        return grad * dk, None


def _bessel_kv(nu: float, z):
    """K_nu(z): scipy on numpy inputs, ``BesselKv`` on tensors."""
    if isinstance(z, torch.Tensor):
        return BesselKv.apply(z, float(nu))
    return scipy.special.kv(nu, z)


def general_matern_k(r, variance, lengthscale, nu):
    """General Matern kernel for any nu > 0:

        k(r) = sigma^2 (2^{1-nu}/Gamma(nu)) z^nu K_nu(z),  z = sqrt(2 nu) r / l.

    Half-integer nu (1/2, 3/2, 5/2, ...) uses the exact closed form

        k(r) = sigma^2 exp(-z) (p!/(2p)!) sum_{i=0}^p (p+i)!/(i!(p-i)!) (2z)^{p-i}

    with p = nu - 1/2; other nu evaluate the modified Bessel function K_nu
    (``_bessel_kv``). ``nu`` is a Python number."""
    nu = float(nu)
    if nu <= 0:
        raise ValueError(f"Matern smoothness nu must be positive; got {nu}.")
    two_nu = 2.0 * nu
    p_float = nu - 0.5
    p = int(round(p_float))
    xp = _xp(r, variance, lengthscale)
    z = math.sqrt(two_nu) * r / lengthscale
    if abs(p_float - p) <= 1e-12 and p >= 0:
        prefac = math.factorial(p) / math.factorial(2 * p)
        acc = 0.0
        for i in range(p + 1):
            coef = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
            acc = acc + coef * (2.0 * z) ** (p - i)
        return variance * prefac * xp.exp(-z) * acc
    # K_nu diverges at z=0 while z^nu -> 0; the product's limit is
    # Gamma(nu) 2^{nu-1}, so k(0) = variance. The double where keeps both
    # the value and the gradient finite at r=0.
    z_safe = xp.where(z > 0, z, 1.0)
    coef = 2.0 ** (1.0 - nu) / math.gamma(nu)
    k_off = variance * coef * z_safe**nu * _bessel_kv(nu, z_safe)
    return xp.where(z > 0, k_off, variance)


def _tdiff(tvec):
    t = tvec.reshape(-1, 1)
    return t - t.T  # (n, n), entry [i, j] = t_i - t_j


def parse_kernel_type(kernel_type: str):
    """Normalize a kernel spec: "matern52" | "rbf" | "matern-<nu>" (general
    Matern with nu > 0, e.g. "matern-1.5", "matern-2.3"). Returns
    (name, nu_or_None)."""
    if kernel_type in _SUPPORTED_KERNELS:
        return kernel_type, None
    if kernel_type.startswith("matern-"):
        nu = float(kernel_type.split("-", 1)[1])
        if nu <= 0:
            raise ValueError(f"Matern nu must be positive; got {nu}.")
        return "matern", nu
    raise ValueError(
        f"Unsupported kernel type '{kernel_type}'. Supported: "
        f"{_SUPPORTED_KERNELS} or 'matern-<nu>' with nu > 0."
    )


def kernel_matrix(kernel_type: str, tvec, variance, lengthscale):
    """Dense covariance C[i,j] = k(|t_i - t_j|)."""
    name, nu = parse_kernel_type(kernel_type)
    r = abs(_tdiff(tvec))
    if name == "matern52":
        return matern52_k(r, variance, lengthscale)
    if name == "rbf":
        return rbf_k(r, variance, lengthscale)
    return general_matern_k(r, variance, lengthscale, nu)


def matern52_cov_blocks(tvec, variance, lengthscale) -> Tuple:
    """C, Cprime, Cdoubleprime for the Matern-5/2 kernel."""
    xp = _xp(tvec, variance, lengthscale)
    l = lengthscale
    dt = _tdiff(tvec)
    d = abs(dt)
    sgn = xp.sign(dt)
    e = xp.exp(-SQRT5 * d / l)

    c = matern52_k(d, variance, lengthscale)

    base = 5.0 * d / (3.0 * l**2) + 5.0 * SQRT5 * d * d / (3.0 * l**3)
    cprime = -sgn * variance * e * base
    cdouble = variance * (
        -SQRT5 / l * e * base + e * (5.0 / (3.0 * l**2) + 10.0 * SQRT5 * d / (3.0 * l**3))
    )
    return c, cprime, cdouble


def rbf_cov_blocks(tvec, variance, lengthscale) -> Tuple:
    """C, Cprime, Cdoubleprime for the RBF kernel:
    Cprime = -C dt / l^2, Cdoubleprime = C (1/l^2 - dt^2 / l^4)."""
    dt = _tdiff(tvec)
    c = rbf_k(abs(dt), variance, lengthscale)
    l2 = lengthscale**2
    cprime = -c * dt / l2
    cdouble = c * (1.0 / l2 - dt * dt / (l2 * l2))
    return c, cprime, cdouble


def cov_blocks(kernel_type: str, tvec, variance, lengthscale) -> Tuple:
    """C, Cprime, Cdoubleprime for a kernel type. A kernel without analytic
    derivative blocks (the general Matern) gets zero Cprime and
    Cdoubleprime, with a warning; Kphi then collapses to jitter*I
    downstream, as in the JAX package."""
    if kernel_type == "matern52":
        return matern52_cov_blocks(tvec, variance, lengthscale)
    if kernel_type == "rbf":
        return rbf_cov_blocks(tvec, variance, lengthscale)
    warnings.warn(
        f"Time-derivative blocks not implemented for kernel "
        f"'{kernel_type}'; derivatives set to zero (Kphi -> jitter*I).",
        stacklevel=2,
    )
    xp = _xp(tvec, variance, lengthscale)
    c = kernel_matrix(kernel_type, tvec, variance, lengthscale)
    z = xp.zeros_like(c)
    return c, z, z
