"""Stan-style warmup adaptation (port of the JAX package's
inference/adapt.py): dual-averaging step size and windowed Welford
moments, as elementwise tensor updates that batch over a leading chain axis.

Dual averaging (Hoffman & Gelman 2014, Algorithm 6): gamma=0.05, t0=10,
kappa=0.75, mu = log(10 * eps0). Windows (Stan): init_buffer=75, expanding
windows 25, 50, 100, ..., term_buffer=50.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor      # current log step size
    log_eps_avg: torch.Tensor  # averaged iterate (used after warmup)
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor        # steps since (re)start


def da_init(eps0: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(eps0)
    z = torch.zeros_like(log_eps)
    return DualAveragingState(
        log_eps=log_eps, log_eps_avg=log_eps, h_bar=z,
        mu=math.log(10.0) + log_eps, count=z,
    )


def da_update(
    state: DualAveragingState, accept_prob: torch.Tensor, target_accept: float,
    gamma: float = 0.05, t0: float = 10.0, kappa: float = 0.75,
) -> DualAveragingState:
    t = state.count + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target_accept - accept_prob)
    log_eps = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_bar, state.mu, t)


def da_restart(state: DualAveragingState) -> DualAveragingState:
    """Restart after a metric update, re-centering mu on the current step
    size (Stan's behavior)."""
    return da_init(torch.exp(state.log_eps))


class WelfordState(NamedTuple):
    count: torch.Tensor  # (...)
    mean: torch.Tensor   # (..., dim)
    m2: torch.Tensor     # (..., dim)


def welford_init(dim: int, dtype, device="cpu", batch=()) -> WelfordState:
    z = lambda *s: torch.zeros((*batch, *s), dtype=dtype, device=device)
    return WelfordState(count=z(), mean=z(dim), m2=z(dim))


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_variance_regularized(state: WelfordState) -> torch.Tensor:
    """Stan's shrunk variance: (n/(n+5)) var + 1e-3 (5/(n+5))."""
    n = state.count[..., None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    w = n / (n + 5.0)
    return w * var + 1e-3 * (1.0 - w)


def build_window_schedule(
    n_adapts: int, init_buffer: int = 75, term_buffer: int = 50,
    base_window: int = 25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side schedule over warmup steps: (in_window, window_end) boolean
    arrays of length n_adapts. Short warmups collapse to a single window."""
    in_window = np.zeros(n_adapts, dtype=bool)
    window_end = np.zeros(n_adapts, dtype=bool)
    if n_adapts <= 0:
        return in_window, window_end
    if n_adapts < init_buffer + term_buffer + base_window:
        start = min(init_buffer, max(n_adapts // 4, 1))
        end = max(n_adapts - max(n_adapts // 10, 1), start + 1)
        end = min(end, n_adapts)
        in_window[start:end] = True
        window_end[end - 1] = True
        return in_window, window_end
    start = init_buffer
    last = n_adapts - term_buffer
    size = base_window
    while start < last:
        end = start + size
        if end + 2 * size > last:  # the final window absorbs the remainder
            end = last
        in_window[start:end] = True
        window_end[end - 1] = True
        start = end
        size *= 2
    return in_window, window_end
