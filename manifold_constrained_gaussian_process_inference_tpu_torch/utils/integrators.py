"""Fixed-step RK4 for test and example data generation (port of the JAX
package's utils/integrators.py). Integration is never part of inference."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def rk4_integrate(
    f_single: Callable,
    x0,
    t0: float,
    t1: float,
    theta,
    n_steps: int = 4000,
) -> tuple:
    """Integrate dx/dt = f(x, theta, t) with classical RK4 in float64.

    ``f_single(x (D,), theta, t) -> (D,)``. Returns (ts (n_steps+1,),
    xs (n_steps+1, D)) as tensors.
    """
    x = torch.as_tensor(np.asarray(x0, dtype=np.float64))
    h = (t1 - t0) / n_steps
    ts = t0 + h * torch.arange(n_steps + 1, dtype=torch.float64)
    out = [x]
    for t in ts[:-1]:
        k1 = f_single(x, theta, t)
        k2 = f_single(x + 0.5 * h * k1, theta, t + 0.5 * h)
        k3 = f_single(x + 0.5 * h * k2, theta, t + 0.5 * h)
        k4 = f_single(x + h * k3, theta, t + h)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(x)
    return ts, torch.stack(out)


def integrate_system(system, x0, t0, t1, theta, n_steps: int = 4000):
    """RK4 over an OdeSystem (whose f is grid-vectorized)."""
    theta = torch.as_tensor(np.asarray(theta, dtype=np.float64))

    def f_single(x, th, t):
        return system.f(x[None, :], th, t.reshape(1))[0]

    return rk4_integrate(f_single, x0, t0, t1, theta, n_steps)


def sample_on_grid(ts, xs, t_query):
    """Linear interpolation of a dense solution onto query times (host)."""
    ts = np.asarray(ts)
    xs = np.asarray(xs)
    t_query = np.asarray(t_query)
    return np.stack(
        [np.interp(t_query, ts, xs[:, d]) for d in range(xs.shape[1])], axis=-1
    )
