"""GP hyperparameter initialization: the negative log marginal likelihood
batched over state dimensions, minimized with L-BFGS (port of the JAX
package's inference/nlml.py).

  NLML = 0.5 * ( log|K + sigma^2 I| + y^T (K + sigma^2 I)^{-1} y + N log 2pi )

over log-parameters [log variance, log lengthscale, log sigma]. NaN
observations use the masked-covariance identity K_eff = M K M + (I - M),
y_eff = M y, which gives the subset's log-determinant and quadratic form
with static shapes. Non-PD covariances get a large penalty; invalid optima
fall back to the initial guess.

The JAX package runs optax.lbfgs per dimension under vmap; here the D
independent objectives are summed and minimized by torch.optim.LBFGS with a
strong-Wolfe line search. The sum is separable, so the optimum is the same
per dimension; iterates differ.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..ops import kernels as K

logger = logging.getLogger(__name__)

_BIG = 1e10
_LOG_PARAM_CLIP = 12.0


def negative_log_marginal_likelihood(
    log_params: torch.Tensor,
    y_filled: torch.Tensor,
    mask: torch.Tensor,
    tvec: torch.Tensor,
    kernel_type: str,
    jitter: float = 1e-6,
) -> torch.Tensor:
    """NLML per dimension: log_params (D, 3), y_filled and mask (D, n)
    (NaN -> 0, 1.0 at finite observations), tvec (n,) -> (D,)."""
    lp = torch.clamp(log_params, -_LOG_PARAM_CLIP, _LOG_PARAM_CLIP)
    variance = torch.exp(lp[:, 0])[:, None, None]
    lengthscale = torch.exp(lp[:, 1])[:, None, None]
    sigma_sq = torch.exp(2.0 * lp[:, 2])[:, None, None]
    n = tvec.shape[0]
    eye = torch.eye(n, dtype=tvec.dtype, device=tvec.device)
    n_valid = mask.sum(dim=-1)

    kmat = K.kernel_matrix(kernel_type, tvec, variance, lengthscale)  # (D, n, n)
    k_full = kmat + (sigma_sq + jitter) * eye
    k_eff = mask[:, :, None] * mask[:, None, :] * k_full + torch.diag_embed(1.0 - mask)

    # Probe, then re-factor a safe matrix so the rejected branch's gradient
    # stays finite.
    _, info = torch.linalg.cholesky_ex(k_eff)
    ok = info == 0
    chol = torch.linalg.cholesky(torch.where(ok[:, None, None], k_eff, eye))

    y = (y_filled * mask)[:, :, None]
    alpha = torch.cholesky_solve(y, chol)
    quad = (y * alpha).sum(dim=(-2, -1))
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(dim=-1)
    nll = 0.5 * (logdet + quad + n_valid * math.log(2.0 * math.pi))
    nll = torch.where(torch.isfinite(nll), nll, torch.full_like(nll, _BIG))
    return torch.where(ok & (n_valid > 0), nll, torch.full_like(nll, _BIG))


def default_initial_guesses(y_obs: np.ndarray, t_obs: np.ndarray) -> np.ndarray:
    """Data-driven initial guesses per dimension (D, 3) in log scale:
    [log var(y), log(time_range/10), log(1.4826 * MAD)]."""
    y_obs = np.asarray(y_obs, dtype=np.float64)
    t_obs = np.asarray(t_obs, dtype=np.float64)
    n, d = y_obs.shape
    time_range = float(t_obs.max() - t_obs.min())
    out = np.zeros((d, 3))
    for dim in range(d):
        valid = y_obs[:, dim][np.isfinite(y_obs[:, dim])]
        out[dim, 1] = np.log(max(time_range / 10.0, 1e-2))
        if valid.size > 1:
            var_y = float(np.var(valid, ddof=1))
            data_range = float(valid.max() - valid.min())
            mad = float(np.median(np.abs(valid - np.median(valid))) * 1.4826)
            out[dim, 0] = np.log(max(var_y, 1e-4))
            out[dim, 2] = np.log(max(mad, 1e-3 * data_range, 1e-4))
        else:
            out[dim, 0] = 0.0
            out[dim, 2] = np.log(0.1)
    return out


def optimize_gp_hyperparameters(
    y_obs: np.ndarray,
    t_obs: np.ndarray,
    kernel_type: str,
    initial_log_params: np.ndarray | None = None,
    jitter: float = 1e-6,
    max_iters: int = 100,
    ftol: float = 1e-8,
    gtol: float = 1e-8,
    show_trace: bool = False,
) -> np.ndarray:
    """Optimize (variance, lengthscale, sigma) for every dimension at once
    (host, float64). Returns (D, 3) in the original scale; a dimension whose
    optimum is non-finite or non-positive falls back to exp(initial guess).

    ``ftol``/``gtol`` are the L-BFGS stopping tolerances on the change of
    the objective and on the gradient's inf-norm; ``show_trace`` logs the
    objective after every iteration."""
    y_obs = np.asarray(y_obs, dtype=np.float64)
    t_obs = np.asarray(t_obs, dtype=np.float64)
    if initial_log_params is None:
        initial_log_params = default_initial_guesses(y_obs, t_obs)
    initial_log_params = np.asarray(initial_log_params, dtype=np.float64)
    mask = np.isfinite(y_obs)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    y_t, m_t, t_t = f64(np.where(mask, y_obs, 0.0).T), f64(mask.T.astype(float)), f64(t_obs)

    def objective(lp):
        return negative_log_marginal_likelihood(lp, y_t, m_t, t_t, kernel_type, jitter)

    params = f64(initial_log_params).clone().requires_grad_(True)
    opt = torch.optim.LBFGS(
        [params], lr=1.0, max_iter=int(max_iters), tolerance_grad=gtol,
        tolerance_change=ftol, history_size=10, line_search_fn="strong_wolfe",
    )
    trace = []

    def closure():
        opt.zero_grad()
        loss = objective(params).sum()
        loss.backward()
        trace.append(float(loss.detach()))
        return loss

    if max_iters > 0:
        opt.step(closure)
    if show_trace:
        logger.info("NLML (summed over dims) trace: %s", np.array2string(
            np.asarray(trace), precision=6, threshold=20, edgeitems=5))
    best_lp = params.detach().numpy()
    with torch.no_grad():
        best_v = objective(params).numpy()
        init_v = objective(f64(initial_log_params)).numpy()
    # keep the guess for a dimension the optimizer made worse
    worse = ~(best_v <= init_v)
    best_lp = np.where(worse[:, None], initial_log_params, best_lp)
    best_v = np.where(worse, init_v, best_v)

    result = np.exp(best_lp)
    bad = (
        ~np.isfinite(result).all(axis=1)
        | (result <= 0).any(axis=1)
        | ~np.isfinite(best_v)
        | (best_v >= _BIG * 0.5)
    )
    result[bad] = np.exp(initial_log_params)[bad]
    return result
