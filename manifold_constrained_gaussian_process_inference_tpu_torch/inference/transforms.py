"""Bounded-parameter reparameterization (Stan-style) for theta (port of the
JAX package's inference/transforms.py):

  (lb, inf):   theta = lb + exp(z)                 log-jac = z
  (-inf, ub):  theta = ub - exp(z)                 log-jac = z
  (lb, ub):    theta = lb + (ub-lb) sigmoid(z)     log-jac = log(ub-lb)
                                                   + log_sigmoid(z)
                                                   + log_sigmoid(-z)
  (-inf, inf): theta = z                           log-jac = 0
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class ThetaTransform(NamedTuple):
    """Per-parameter branch selection (host-resolved)."""

    lb: np.ndarray
    ub: np.ndarray
    kind: np.ndarray  # 0 identity, 1 lower, 2 upper, 3 both


def make_theta_transform(lb, ub) -> ThetaTransform:
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    kind = np.zeros(lb.shape, dtype=np.int32)
    kind[np.isfinite(lb) & ~np.isfinite(ub)] = 1
    kind[~np.isfinite(lb) & np.isfinite(ub)] = 2
    kind[np.isfinite(lb) & np.isfinite(ub)] = 3
    return ThetaTransform(lb=lb, ub=ub, kind=kind)


class TransformTensors(NamedTuple):
    """A ThetaTransform's constants as tensors on the sampling device, made
    once so that evaluating the transform copies nothing from the host."""

    lb: torch.Tensor
    ub: torch.Tensor
    width: torch.Tensor
    kind: torch.Tensor
    uniform_kind: int  # the kind shared by every parameter, or -1 if mixed


def transform_tensors(tr: ThetaTransform, dtype, device) -> TransformTensors:
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    both = np.isfinite(tr.lb) & np.isfinite(tr.ub)
    return TransformTensors(
        lb=put(np.where(np.isfinite(tr.lb), tr.lb, 0.0)),
        ub=put(np.where(np.isfinite(tr.ub), tr.ub, 0.0)),
        width=put(np.where(both, tr.ub - tr.lb, 1.0)),
        kind=torch.as_tensor(tr.kind, device=device),
        uniform_kind=int(tr.kind[0]) if np.all(tr.kind == tr.kind[0]) else -1,
    )


def constrain(tr, z: torch.Tensor):
    """z (..., k) -> (theta (..., k), log_jacobian (...)). ``tr`` is a
    ThetaTransform or its TransformTensors on z's device."""
    if isinstance(tr, ThetaTransform):
        tr = transform_tensors(tr, z.dtype, z.device)
    lb, ub, width, kind, uniform = tr
    # one branch for all parameters (FN: every rate bounded below) takes
    # three operations instead of the masked selection over all branches
    if uniform == 0:
        return z, torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
    if uniform in (1, 2):
        theta = lb + torch.exp(z) if uniform == 1 else ub - torch.exp(z)
        return theta, torch.sum(z, dim=-1)

    ez = torch.exp(z)
    theta = torch.where(
        kind == 1, lb + ez,
        torch.where(kind == 2, ub - ez,
                    torch.where(kind == 3, lb + width * torch.sigmoid(z), z)),
    )
    log_jac = torch.where(
        (kind == 1) | (kind == 2), z,
        torch.where(
            kind == 3,
            torch.log(width) + F.logsigmoid(z) + F.logsigmoid(-z),
            torch.zeros_like(z),
        ),
    )
    return theta, torch.sum(log_jac, dim=-1)


def unconstrain(tr: ThetaTransform, theta: np.ndarray) -> np.ndarray:
    """theta -> z (host, float64). Values at or outside the bounds are
    nudged inside first."""
    theta = np.asarray(theta, dtype=np.float64).copy()
    z = theta.copy()
    for i, k in enumerate(tr.kind):
        if k == 1:
            z[i] = np.log(max(theta[i] - tr.lb[i], 1e-10))
        elif k == 2:
            z[i] = np.log(max(tr.ub[i] - theta[i], 1e-10))
        elif k == 3:
            w = tr.ub[i] - tr.lb[i]
            u = np.clip((theta[i] - tr.lb[i]) / w, 1e-10, 1 - 1e-10)
            z[i] = np.log(u) - np.log1p(-u)
    return z


def constrain_np(tr: ThetaTransform, z: np.ndarray) -> np.ndarray:
    """Host-side constrain for sample arrays; z may have leading axes."""
    z = np.asarray(z, dtype=np.float64)
    theta = z.copy()
    for i, k in enumerate(tr.kind):
        if k == 1:
            theta[..., i] = tr.lb[i] + np.exp(z[..., i])
        elif k == 2:
            theta[..., i] = tr.ub[i] - np.exp(z[..., i])
        elif k == 3:
            w = tr.ub[i] - tr.lb[i]
            theta[..., i] = tr.lb[i] + w / (1.0 + np.exp(-z[..., i]))
    return theta
