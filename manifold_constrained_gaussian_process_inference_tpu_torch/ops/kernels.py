"""GP kernels and their analytic time-derivative cross-covariances (port of
the JAX package's ops/kernels.py; Matern-5/2 only, the other kernels wait
for ROADMAP item M14).

Every function accepts numpy arrays (the float64 host setup path) or torch
tensors (the differentiable NLML objective); the math is elementwise.

Conventions:
- ``C[i, j]     = k(t_i, t_j)``
- ``Cprime[i,j] = d k(t_i, t_j) / d t_i``            (anti-symmetric, zero diag)
- ``Cdoubleprime[i,j] = d^2 k(t_i, t_j) / dt_i dt_j`` (symmetric)
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

SQRT5 = math.sqrt(5.0)

_SUPPORTED_KERNELS = ("matern52",)


def _xp(*arrays):
    """torch if any input is a tensor, else numpy."""
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


def matern52_k(r, variance, lengthscale):
    """Matern-5/2: sigma^2 (1 + sqrt5 r/l + 5 r^2/(3 l^2)) exp(-sqrt5 r/l)."""
    xp = _xp(r, variance, lengthscale)
    s = SQRT5 * r / lengthscale
    return variance * (1.0 + s + s * s / 3.0) * xp.exp(-s)


def _tdiff(tvec):
    t = tvec.reshape(-1, 1)
    return t - t.T  # (n, n), entry [i, j] = t_i - t_j


def parse_kernel_type(kernel_type: str):
    """Normalize a kernel spec. Returns (name, nu_or_None). The JAX
    package's "rbf" and "matern-<nu>" are not ported yet."""
    if kernel_type in _SUPPORTED_KERNELS:
        return kernel_type, None
    if kernel_type == "rbf" or kernel_type.startswith("matern-"):
        raise NotImplementedError(
            f"kernel '{kernel_type}' is not ported yet (ROADMAP M14)."
        )
    raise ValueError(
        f"Unsupported kernel type '{kernel_type}'. Supported: {_SUPPORTED_KERNELS}."
    )


def kernel_matrix(kernel_type: str, tvec, variance, lengthscale):
    """Dense covariance C[i,j] = k(|t_i - t_j|)."""
    parse_kernel_type(kernel_type)
    return matern52_k(abs(_tdiff(tvec)), variance, lengthscale)


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


def cov_blocks(kernel_type: str, tvec, variance, lengthscale) -> Tuple:
    """Dispatch to the analytic C/C'/C'' construction for a kernel type."""
    parse_kernel_type(kernel_type)
    return matern52_cov_blocks(tvec, variance, lengthscale)
