"""ODE system contract (port of the JAX package's models/base.py).

``f(x, theta, tvec)`` is vectorized over the time grid and over any
leading batch axes: x (..., n, D), theta (..., k), tvec (n,) -> (..., n, D).
Jacobians not supplied by hand default to ``torch.func.jacfwd`` of ``f`` at
each grid point, with the same leading axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

OdeF = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OdeSystem:
    """An ODE system for MAGI inference.

    - ``f(x, theta, tvec)``: (n, D), (k,), (n,) -> (n, D)
    - ``f_dx``: -> (n, D, D), entry [i, p, j] = df_p/dx_j
    - ``f_dtheta``: -> (n, D, k), entry [i, p, m] = df_p/dtheta_m
    """

    f: OdeF
    theta_lower_bound: np.ndarray
    theta_upper_bound: np.ndarray
    theta_size: int
    f_dx: Optional[OdeF] = None
    f_dtheta: Optional[OdeF] = None
    name: str = "ode"

    def __post_init__(self):
        object.__setattr__(
            self, "theta_lower_bound",
            np.asarray(self.theta_lower_bound, dtype=np.float64),
        )
        object.__setattr__(
            self, "theta_upper_bound",
            np.asarray(self.theta_upper_bound, dtype=np.float64),
        )
        if self.f_dx is None:
            object.__setattr__(self, "f_dx", _autodiff_dx(self.f))
        if self.f_dtheta is None:
            object.__setattr__(self, "f_dtheta", _autodiff_dtheta(self.f))


def _rows(x, theta, tvec):
    """The leading axes and the grid folded into one row axis: x (..., n, D),
    theta (..., k), tvec (n,) -> lead, n, (R, D), (R, k), (R,)."""
    lead = torch.broadcast_shapes(x.shape[:-2], theta.shape[:-1])
    n, d = x.shape[-2:]
    k = theta.shape[-1]
    return (
        lead, n,
        x.expand(*lead, n, d).reshape(-1, d),
        theta[..., None, :].expand(*lead, n, k).reshape(-1, k),
        tvec.expand(*lead, n).reshape(-1),
    )


def _autodiff_dx(f: OdeF) -> OdeF:
    def f_dx(x, theta, tvec):
        lead, n, xs, ths, ts = _rows(x, theta, tvec)

        def single(xi, thi, ti):
            return torch.func.jacfwd(lambda u: f(u[None, :], thi, ti[None])[0])(xi)

        out = torch.func.vmap(single)(xs, ths, ts)
        return out.reshape(*lead, n, *out.shape[1:])

    return f_dx


def _autodiff_dtheta(f: OdeF) -> OdeF:
    def f_dtheta(x, theta, tvec):
        lead, n, xs, ths, ts = _rows(x, theta, tvec)

        def single(xi, thi, ti):
            return torch.func.jacfwd(lambda th: f(xi[None, :], th, ti[None])[0])(thi)

        out = torch.func.vmap(single)(xs, ths, ts)
        return out.reshape(*lead, n, *out.shape[1:])

    return f_dtheta


_REGISTRY = {}


def register(system: OdeSystem) -> OdeSystem:
    _REGISTRY[system.name] = system
    return system


def get_system(name: str) -> OdeSystem:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown ODE system '{name}'. Registered: {sorted(_REGISTRY)}"
        ) from None


def registered_systems() -> Sequence[str]:
    return sorted(_REGISTRY)
