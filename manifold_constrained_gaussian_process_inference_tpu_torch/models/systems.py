"""Benchmark ODE systems (port of the JAX package's models/systems.py).

FitzHugh-Nagumo only; the other models wait for ROADMAP item M14. Every
function broadcasts over leading batch axes: x (..., n, D) with
theta (..., k).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import OdeSystem, register

_INF = np.inf


def _params(theta, count):
    # (..., k) -> k tensors of shape (..., 1), broadcasting against (..., n)
    return tuple(theta[..., i, None] for i in range(count))


# ---------------------------------------------------------------------------
# FitzHugh-Nagumo (2 states V, R; 3 params a, b, c)
# ---------------------------------------------------------------------------

def fn_f(x, theta, tvec):
    v, r = x[..., 0], x[..., 1]
    a, b, c = _params(theta, 3)
    dv = c * (v - v**3 / 3.0 + r)
    dr = -1.0 / c * (v - a + b * r)
    return torch.stack([dv, dr], dim=-1)


def fn_f_dx(x, theta, tvec):
    """J[..., i, p, j] = df_p/dx_j."""
    v = x[..., 0]
    a, b, c = _params(theta, 3)
    c = c.expand_as(v)
    row0 = torch.stack([c * (1.0 - v**2), c], dim=-1)
    row1 = torch.stack([-1.0 / c, (-b / c).expand_as(v)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def fn_f_dtheta(x, theta, tvec):
    """J[..., i, p, m] = df_p/dtheta_m."""
    v, r = x[..., 0], x[..., 1]
    a, b, c = _params(theta, 3)
    zero = torch.zeros_like(v)
    row0 = torch.stack([zero, zero, v - v**3 / 3.0 + r], dim=-1)
    row1 = torch.stack(
        [(1.0 / c).expand_as(v), -r / c, (v - a + b * r) / c**2], dim=-1
    )
    return torch.stack([row0, row1], dim=-2)


FN_SYSTEM = register(
    OdeSystem(
        f=fn_f, f_dx=fn_f_dx, f_dtheta=fn_f_dtheta,
        theta_lower_bound=[0.0, 0.0, 0.0],
        theta_upper_bound=[_INF, _INF, _INF],
        theta_size=3, name="fn",
    )
)
