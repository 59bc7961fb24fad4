"""The GP smoothing that picks phi where the configuration does not give
it, written plainly for the benchmark's check of the port: for each state
dimension, the negative log marginal likelihood of its observations under
a zero-mean GP with the Matern-5/2 kernel and white noise,

  NLML(v, l, s) = 1/2 [ log|K + (s^2 + jitter) I| + y^T (K + (s^2 + jitter) I)^-1 y
                        + N log 2 pi ],   K = k_{v,l}(t_obs, t_obs),

minimized over (log v, log l, log s) by L-BFGS-B (scipy), with the
gradient by autograd, from several lengthscales, keeping the best. phi_d is
(v, l) at the minimum; s is the noise's first guess, which the sampler
re-draws when sigma is sampled.

``gap`` judges a phi: per dimension, the NLML minimized over s alone at
that phi, less the minimum over all three. It imports nothing of the port
and nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

LENGTH_STARTS = (0.02, 0.05, 0.1, 0.2, 0.5)  # first lengthscales, shares of the time range


def nlml(log_params: torch.Tensor, t: torch.Tensor, y: torch.Tensor, jitter: float):
    """NLML of one dimension's observations y (N,) at times t (N,)."""
    v, l, s = torch.exp(log_params[0]), torch.exp(log_params[1]), torch.exp(log_params[2])
    d = torch.abs(t[:, None] - t[None, :])
    u = np.sqrt(5.0) * d / l
    k = v * (1.0 + u + u * u / 3.0) * torch.exp(-u)
    k = k + (s * s + jitter) * torch.eye(t.shape[0], dtype=t.dtype, device=t.device)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(y[:, None], chol)
    return 0.5 * (2.0 * torch.log(torch.diagonal(chol)).sum() + (y[:, None] * alpha).sum()
                  + t.shape[0] * np.log(2.0 * np.pi))


def _minimize(fun, x0, dtype):
    """L-BFGS-B on fun (torch, 1-D) from x0, in ``dtype``; a step where the
    covariance has no Cholesky factor reads +inf. Returns (x, value)."""

    def f(x):
        xt = torch.tensor(x, dtype=dtype, requires_grad=True)
        try:
            val = fun(xt)
        except RuntimeError:  # not positive definite
            return np.inf, np.zeros_like(x)
        val.backward()
        v, g = val.item(), xt.grad.detach().double().numpy()
        if not (np.isfinite(v) and np.isfinite(g).all()):
            return np.inf, np.zeros_like(x)
        return v, g

    res = scipy.optimize.minimize(f, np.asarray(x0, np.float64), jac=True, method="L-BFGS-B",
                                  options=dict(maxiter=2000, ftol=1e-15, gtol=1e-10))
    return res.x, float(res.fun)


def _observed(t, y, d):
    keep = np.isfinite(y[:, d])
    return t[keep], y[keep, d]


def fit(t: np.ndarray, y: np.ndarray, jitter: float, dtype=torch.float64):
    """The reference's phi (2, D) and per-dimension NLML minima (D,), from
    y (n, D) with NaN where unobserved at times t (n,), computed in
    ``dtype`` (float64; float32 for the control)."""
    n_dims = y.shape[1]
    phi, best = np.zeros((2, n_dims)), np.zeros(n_dims)
    for d in range(n_dims):
        td, yd = _observed(np.asarray(t, np.float64), np.asarray(y, np.float64), d)
        tt, yt = (torch.as_tensor(a, dtype=dtype) for a in (td, yd))
        span = float(td.max() - td.min())
        fun = lambda x: nlml(x, tt, yt, jitter)  # noqa: E731
        starts = [[np.log(np.var(yd)), np.log(share * span), np.log(0.1 * np.std(yd))]
                  for share in LENGTH_STARTS]
        x, val = min((_minimize(fun, x0, dtype) for x0 in starts), key=lambda r: r[1])
        phi[:, d], best[d] = np.exp(x[:2]), val
    return phi, best


def gap(phi: np.ndarray, t: np.ndarray, y: np.ndarray, jitter: float, best: np.ndarray):
    """Per dimension (D,): the float64 NLML at ``phi`` (2, D), minimized over
    the noise alone, less the reference's minimum ``best`` (nats)."""
    out = np.zeros(y.shape[1])
    for d in range(y.shape[1]):
        td, yd = _observed(np.asarray(t, np.float64), np.asarray(y, np.float64), d)
        tt, yt = (torch.as_tensor(a, dtype=torch.float64) for a in (td, yd))
        lv, ll = (float(np.log(phi[i, d])) for i in range(2))
        fun = lambda x: nlml(torch.stack([torch.as_tensor(lv, dtype=torch.float64),  # noqa: E731
                                          torch.as_tensor(ll, dtype=torch.float64), x[0]]),
                             tt, yt, jitter)
        _, val = min((_minimize(fun, [np.log(s * np.std(yd))], torch.float64)
                      for s in (0.01, 0.1, 0.5)), key=lambda r: r[1])
        out[d] = val - best[d]
    return out
