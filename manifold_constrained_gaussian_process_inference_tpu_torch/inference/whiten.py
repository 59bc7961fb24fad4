"""Laplace whitening of the full sampled vector Psi (port of the JAX
package's inference/whiten.py).

Sample zeta with Psi = center + W zeta, W = L^{-T}, P = L L^T, where P is a
precision of the posterior at its mode: the exact Hessian (production) or
the Gauss-Newton approximation (fallback, and the MAP optimizer's
curvature):

  P_xx      = blockdiag_d(Cinv_d)/b_lvl + B' Kblk B /b_drv + diag(mask)/(s0^2 b_obs)
  P_x,theta = B' Kblk B_th / b_drv
  P_th,th   = B_th' Kblk B_th / b_drv  (+ unit ridge)
  P_ss      = diag(2 nobs / b_obs + 1)

with B = J0 - M (pointwise ODE Jacobian minus block-diagonal mphi) and B_th
the theta-Jacobian, chain-ruled through the bounded theta transform. The
map is linear and fixed, so the posterior is preserved exactly.

Setup (MAP, Hessian, factorizations) runs on the host in float64 (numpy,
scipy and a float64 CPU replica of the target); only the whitened,
mode-centered value-and-grad (``make_centered_whitened_vg``) runs on the
sampling device.
"""
from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
from scipy.linalg import cho_solve, cho_solve_banded, cholesky_banded

from ..ops import centered_vg
from ..ops.likelihood import log_posterior_centered, make_centered_terms
from .target import value_and_grad
from .transforms import constrain_np

logger = logging.getLogger(__name__)

HESSIAN_BATCH = 128  # Hessian columns per batched jvp-of-grad


class PsiWhitener(NamedTuple):
    W: torch.Tensor        # (dim, dim): psi = center + W zeta
    L_T: torch.Tensor      # (dim, dim): zeta = L^T (psi - center)
    center: torch.Tensor   # (dim,)

    @classmethod
    def from_numpy(cls, W, L_T, center, dtype=torch.float64, device="cpu"):
        # row-major whatever the numpy layout: a product's rounding depends on
        # its operands' layout, and a broadcast over a mesh is row-major
        put = lambda a: torch.as_tensor(
            np.array(a, dtype=np.float64, order="C"), dtype=dtype, device=device
        )
        return cls(W=put(W), L_T=put(L_T), center=put(center))


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


def _theta_dz(theta_transform, z_theta: np.ndarray) -> np.ndarray:
    """|d theta / d z| at z_theta for the bounded reparameterization."""
    out = np.ones_like(z_theta)
    if theta_transform is None:
        return out
    for i, kind in enumerate(theta_transform.kind):
        if kind in (1, 2):
            out[i] = np.exp(z_theta[i])
        elif kind == 3:
            w = theta_transform.ub[i] - theta_transform.lb[i]
            s = 1.0 / (1.0 + np.exp(-z_theta[i]))
            out[i] = w * s * (1.0 - s)
    return out


def make_precision_cache(gp_cov, yobs, target, prior_temperature) -> dict:
    """Psi-independent pieces of the GN precision: the ODE Jacobian only
    enters as diagonal blocks, so J'KJ / J'KM / M'KJ are row and column
    scalings of these constant banded matrices and M'KM is constant."""
    mask = np.isfinite(np.asarray(yobs))
    n, d = mask.shape
    cinv = _np64(gp_cov.Cinv_band)
    kinv = _np64(gp_cov.Kinv_band)
    mphi = _np64(gp_cov.mphi_band)
    km = np.stack([kinv[p] @ mphi[p] for p in range(d)])
    mkm = np.stack([mphi[p].T @ km[p] for p in range(d)])
    return dict(
        beta=np.asarray(prior_temperature, dtype=np.float64), mask=mask,
        n=n, d=d, k=target.n_params_ode,
        cinv=cinv, kinv=kinv, mphi=mphi, km=km, mkm=mkm,
        tvec=_np64(gp_cov.tvec),
        nobs=mask.sum(axis=0).astype(np.float64),
        bandsize=int(getattr(gp_cov, "bandsize", n - 1)),
    )


def build_precision(
    gp_cov, yobs, target, psi_center: np.ndarray, prior_temperature, cache=None
) -> np.ndarray:
    """Gauss-Newton precision of the log-posterior at psi_center (host,
    float64). ``target`` supplies the system, the transform and the
    layout."""
    if cache is None:
        cache = make_precision_cache(gp_cov, yobs, target, prior_temperature)
    beta, mask = cache["beta"], cache["mask"]
    n, d, k = cache["n"], cache["d"], cache["k"]
    kinv, cinv = cache["kinv"], cache["cinv"]
    mphi, km, mkm = cache["mphi"], cache["km"], cache["mkm"]
    nd = n * d
    psi_center = np.asarray(psi_center, dtype=np.float64)
    dim = psi_center.shape[0]

    x_c = psi_center[:nd].reshape(d, n).T
    z_theta = psi_center[nd : nd + k]
    theta_c = (
        constrain_np(target.theta_transform, z_theta)
        if target.theta_transform is not None else z_theta
    )
    if target.sigma_is_fixed:
        sigma_c = _np64(target.sigma_init)
    else:
        sigma_c = np.exp(np.clip(psi_center[nd + k :], -15, 15))

    args = [torch.as_tensor(a) for a in (x_c, theta_c, cache["tvec"])]
    j0 = _np64(target.system.f_dx(*args))       # (n, D, D): df_q/dx_p
    jth = _np64(target.system.f_dtheta(*args))  # (n, D, k)
    jth = jth * _theta_dz(target.theta_transform, z_theta)[None, None, :]

    prec = np.zeros((dim, dim))
    pxx = np.empty((d, n, d, n))
    for p in range(d):
        for j in range(d):
            acc = np.zeros((n, n))
            for q in range(d):  # J'KJ
                acc += j0[:, q, p][:, None] * kinv[q] * j0[:, q, j][None, :]
            acc -= j0[:, j, p][:, None] * km[j]        # J'KM
            acc -= km[p].T * j0[:, p, j][None, :]      # M'KJ
            if p == j:
                acc += mkm[p]                          # M'KM
            pxx[p, :, j, :] = acc
    prec[:nd, :nd] = pxx.reshape(nd, nd) / beta[0]
    for p in range(d):
        sl = slice(p * n, (p + 1) * n)
        prec[sl, sl] += cinv[p] / beta[1]
    prec[np.arange(nd), np.arange(nd)] += (
        mask.T.reshape(-1) / np.repeat(sigma_c**2, n) / beta[2]
    )

    kbth = np.stack([kinv[q] @ jth[:, q, :] for q in range(d)])  # (d, n, k)
    cross = np.concatenate(
        [
            sum(j0[:, q, p][:, None] * kbth[q] for q in range(d))
            - mphi[p].T @ kbth[p]
            for p in range(d)
        ],
        axis=0,
    ) / beta[0]
    prec[:nd, nd : nd + k] += cross
    prec[nd : nd + k, :nd] += cross.T
    prec[nd : nd + k, nd : nd + k] += sum(
        jth[:, q, :].T @ kbth[q] for q in range(d)
    ) / beta[0]
    if not target.sigma_is_fixed:
        prec[nd + k :, nd + k :] = np.diag(2.0 * cache["nobs"] / beta[2] + 1.0)
    # unit ridge on the theta block: flat theta directions get z-scale 1
    prec[range(nd, nd + k), range(nd, nd + k)] += 1.0
    return 0.5 * (prec + prec.T)


def _robust_chol(prec: np.ndarray) -> np.ndarray:
    dim = prec.shape[0]
    scale = float(np.max(np.diag(prec)))
    for trial in range(12):
        jitter = 0.0 if trial == 0 else scale * 10.0 ** (trial - 14)
        try:
            return np.linalg.cholesky(prec + jitter * np.eye(dim))
        except np.linalg.LinAlgError:
            continue
    wv, vec = np.linalg.eigh(prec)
    wv = np.maximum(wv, scale * 1e-12)
    return np.linalg.cholesky((vec * wv) @ vec.T)


def _whitener_from_chol(chol, psi_center, dtype, device) -> PsiWhitener:
    return PsiWhitener.from_numpy(
        np.linalg.inv(chol).T, chol.T, psi_center, dtype=dtype, device=device
    )


def build_psi_whitener(
    gp_cov, yobs, target, psi_center, prior_temperature, dtype, device="cpu"
) -> PsiWhitener:
    """Whitener from the Gauss-Newton precision at psi_center."""
    psi_center = np.asarray(psi_center, dtype=np.float64)
    prec = build_precision(gp_cov, yobs, target, psi_center, prior_temperature)
    return _whitener_from_chol(_robust_chol(prec), psi_center, dtype, device)


def make_exact_hessian_fn(target):
    """Dense-Hessian evaluator for ``target``'s log-density (float64 when
    the target is): batched jvp-of-grad through torch.func, HESSIAN_BATCH
    columns per batch."""
    logdensity = target.logdensity_fn()
    grad_fn = torch.func.grad(logdensity)

    def hvp_batch(psi, vs):
        return torch.func.vmap(lambda v: torch.func.jvp(grad_fn, (psi,), (v,))[1])(vs)

    def hessian(psi_center: np.ndarray) -> np.ndarray:
        like = target.data.mask
        psi = torch.as_tensor(
            np.asarray(psi_center, dtype=np.float64), dtype=like.dtype, device=like.device
        )
        eye = torch.eye(psi.shape[0], dtype=psi.dtype, device=psi.device)
        cols = [
            _np64(hvp_batch(psi, eye[s : s + HESSIAN_BATCH]))
            for s in range(0, psi.shape[0], HESSIAN_BATCH)
        ]
        return np.concatenate(cols, axis=0)

    return hessian


def exact_hessian(target, psi_center: np.ndarray) -> np.ndarray:
    """Dense exact Hessian of the target's log-density at psi_center."""
    return make_exact_hessian_fn(target)(psi_center)


def build_psi_whitener_exact(
    target, psi_center, dtype, eig_floor: float = 1.0, device="cpu"
) -> PsiWhitener:
    """Whitener from the exact Hessian at psi_center (eigenvalues floored
    at ``eig_floor``, so flat directions keep unit z-scale). At the mode the
    Gauss-Newton precision drops the residual-curvature term, which
    dominates on dense grids; the exact build is the production default."""
    psi_center = np.asarray(psi_center, dtype=np.float64)
    hess = exact_hessian(target, psi_center)
    prec = -0.5 * (hess + hess.T)
    wv, vec = np.linalg.eigh(prec)
    prec_psd = (vec * np.maximum(wv, eig_floor)) @ vec.T
    chol = _robust_chol(0.5 * (prec_psd + prec_psd.T))
    return _whitener_from_chol(chol, psi_center, dtype, device)


def _dense_free_solve(damped: np.ndarray, g: np.ndarray, free_idx):
    """Reduced Newton step on the free coordinates, dense path."""
    step = np.zeros(g.shape[0])
    chol = _robust_chol(damped[np.ix_(free_idx, free_idx)])
    step[free_idx] = cho_solve((chol, True), g[free_idx])
    return step


def _banded_schur_solve(
    damped: np.ndarray, g: np.ndarray, n: int, d: int, bandsize: int,
    free_mask: np.ndarray,
):
    """Newton step exploiting the x block's band structure: in time-major
    order the GN x block has lower bandwidth D*3*bandsize + (D-1), so a
    banded Cholesky (scipy) replaces the dense one; the free trailing block
    (theta, log sigma) is folded in by a Schur complement. Raises
    ``np.linalg.LinAlgError`` if a factorization fails."""
    nd = n * d
    tail_idx = nd + np.where(free_mask[nd:])[0]
    perm = np.arange(nd).reshape(d, n).T.reshape(-1)
    axx = damped[:nd, :nd][np.ix_(perm, perm)]
    bw = min(nd - 1, 3 * bandsize * d + (d - 1))
    ab = np.zeros((bw + 1, nd))
    for r in range(bw + 1):
        ab[r, : nd - r] = np.diagonal(axx, offset=-r)
    chol_b = cholesky_banded(ab, lower=True)
    inv_perm = np.empty(nd, dtype=np.int64)
    inv_perm[perm] = np.arange(nd)

    def solve_x(rhs):
        return cho_solve_banded((chol_b, True), rhs[perm])[inv_perm]

    y0 = solve_x(g[:nd])
    step = np.zeros(damped.shape[0])
    if len(tail_idx) == 0:
        step[:nd] = y0
        return step
    c = damped[:nd, tail_idx]
    y_c = np.column_stack([solve_x(c[:, j]) for j in range(len(tail_idx))])
    schur = damped[np.ix_(tail_idx, tail_idx)] - c.T @ y_c
    chol_s = np.linalg.cholesky(0.5 * (schur + schur.T))
    step_s = cho_solve((chol_s, True), g[tail_idx] - c.T @ y0)
    step[:nd] = y0 - y_c @ step_s
    step[tail_idx] = step_s
    return step


def _newton_step(damped, g, n, d, bandsize, free_mask):
    """Reduced Newton step over the free coordinates: banded + Schur when
    every x coordinate is free, a small dense solve otherwise (and as the
    fallback when the banded factorization fails)."""
    nd = n * d
    x_free = free_mask[:nd]
    free_idx = np.where(free_mask)[0]
    if x_free.all():
        try:
            return _banded_schur_solve(damped, g, n, d, bandsize, free_mask)
        except np.linalg.LinAlgError:
            pass
    return _dense_free_solve(damped, g, free_idx)


def gauss_newton_map(
    vg, gp_cov, yobs, target, psi0, prior_temperature, n_newton: int = 200,
    tol: float = 1e-4, freeze=None, min_improvement: float = 0.05,
    warn_on_cap: bool = True,
) -> np.ndarray:
    """MAP by damped (Levenberg-Marquardt) Gauss-Newton with backtracking:
    step = P(psi)^{-1} grad on the free coordinates (``freeze``: a slice or
    boolean mask of coordinates kept at their start). ``vg`` maps a psi
    tensor to (value, grad). Host loop, float64."""
    like = target.data.mask
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    psi = np.asarray(psi0, dtype=np.float64)
    v, g = vg(as_t(psi))
    v = float(v)
    v_start = v
    lam = 0.0
    it = -1
    cache = make_precision_cache(gp_cov, yobs, target, prior_temperature)
    n_, d_ = cache["n"], cache["d"]
    free_mask = np.ones(psi.shape[0], dtype=bool)
    if freeze is not None:
        free_mask[freeze] = False
    n_stalled = 0
    for it in range(n_newton):
        prec = build_precision(gp_cov, yobs, target, psi, prior_temperature, cache=cache)
        diag_scale = float(np.median(np.diag(prec)))
        g_np = _np64(g)
        improved = False
        for _lm in range(12):
            damped = prec + lam * diag_scale * np.eye(prec.shape[0]) if lam > 0 else prec
            step = _newton_step(damped, g_np, n_, d_, cache["bandsize"], free_mask)
            alpha = 1.0
            for _ in range(20):
                cand = psi + alpha * step
                v_new, g_new = vg(as_t(cand))
                v_new = float(v_new)
                if np.isfinite(v_new) and v_new > v:
                    gain = v_new - v
                    psi, v, g = cand, v_new, g_new
                    improved = True
                    break
                alpha *= 0.5
            if improved:
                if alpha == 1.0:
                    lam = lam / 3.0 if lam > 1e-9 else 0.0
                elif alpha < 0.25:
                    lam = max(lam * 4.0, 1e-6)
                break
            lam = max(lam * 10.0, 1e-6)
        if not improved:
            break
        if lam == 0.0 and alpha == 1.0 and gain < min_improvement:
            break
        if lam == 0.0 and np.linalg.norm(alpha * step) < tol * (1.0 + np.linalg.norm(psi)):
            break
        # stall stop under chronic damping: five sub-threshold gains in a row
        n_stalled = n_stalled + 1 if gain < min_improvement else 0
        if n_stalled >= 5:
            break
    logger.info(
        "Gauss-Newton MAP: log-posterior %.4g -> %.4g (%d iterations)",
        v_start, v, it + 1,
    )
    if it + 1 >= n_newton and warn_on_cap:
        logger.warning(
            "Gauss-Newton MAP hit the iteration cap before converging "
            "(final lp %.4g); the whitener will be built off-mode.", v,
        )
    return psi


def make_centered_whitened_vg(target, whitener: PsiWhitener):
    """Whitened value-and-grad over zeta (..., dim) with the x block
    evaluated mode-centered: dx = (W zeta)_x is used directly (never
    psi - center) and the center's operator products are float64 host
    constants (ops/likelihood.CenteredTerms). One (C, dim) x (dim, dim) GEMM
    per evaluation maps the chains' zeta to psi offsets, and one maps the
    gradient back.

    A target that ``ops/centered_vg.takes`` (banded FN) runs
    ``make_centered_whitened_vg_kernel``, every other one
    ``make_centered_whitened_vg_autograd``. The returned function's
    ``route`` says which: "kernel" or "autograd"."""
    if centered_vg.takes(target):
        return make_centered_whitened_vg_kernel(target, whitener)
    return make_centered_whitened_vg_autograd(target, whitener)


def make_centered_whitened_vg_kernel(target, whitener: PsiWhitener):
    """``make_centered_whitened_vg`` for a banded FN target: between the two
    GEMMs the analytic forward and backward of ``ops/centered_vg``, one
    kernel launch on the card, its plain version on the CPU."""
    params = centered_vg.make_params(target, whitener.center)
    w_t, w = whitener.W.T, whitener.W

    def vg(zeta):
        dpsi = zeta @ w_t
        lp, g_psi = centered_vg.centered_fn_vg(dpsi.reshape(-1, dpsi.shape[-1]), params)
        return lp.reshape(dpsi.shape[:-1]), (g_psi @ w).reshape(dpsi.shape)

    vg.route = "kernel"
    return vg


def make_centered_whitened_vg_autograd(target, whitener: PsiWhitener):
    """``make_centered_whitened_vg`` through torch.autograd of
    ``ops/likelihood.log_posterior_centered``: any target (the dense
    layout, every model family, banded or not). It is the kernel route's
    oracle in the tests."""
    n, d, k = target.n_times, target.n_dims, target.n_params_ode
    nd = n * d
    center = whitener.center
    x_ref = _np64(center[:nd]).reshape(d, n).T
    cent = make_centered_terms(target.data, x_ref, target.bandwidth)
    w_t = whitener.W.T

    def logdensity_z(zeta):
        dpsi = zeta @ w_t
        lead = dpsi.shape[:-1]
        dx = dpsi[..., :nd].reshape(*lead, d, n).transpose(-1, -2)
        tail = center[nd:] + dpsi[..., nd:]  # theta, then log sigma if sampled
        theta = tail[..., :k]
        log_sigma = None if target.sigma_is_fixed else tail[..., k:]
        theta, sigma, jac = target.constrained_theta_sigma(theta, log_sigma)
        ll = log_posterior_centered(
            dx, theta, sigma, target.data, cent, target.system.f, target.bandwidth
        )
        return ll + jac

    vg = value_and_grad(logdensity_z)
    vg.route = "autograd"
    return vg


def wrap_value_and_grad(vg, whitener: PsiWhitener):
    """vg over psi -> vg over zeta, psi = center + W zeta (zeta (dim,) or
    (C, dim)), by the chain rule: g_zeta = W^T g_psi. The production path
    evaluates the mode-centered target instead (make_centered_whitened_vg)."""

    def vg_zeta(zeta):
        psi = whitener.center + zeta @ whitener.W.T
        value, g_psi = vg(psi)
        return value, g_psi @ whitener.W

    return vg_zeta


def zeta_to_psi_np(whitener: PsiWhitener, zeta: np.ndarray) -> np.ndarray:
    """Host back-transform: (..., dim) zeta -> psi."""
    return np.asarray(zeta, dtype=np.float64) @ _np64(whitener.W).T + _np64(whitener.center)


def psi_to_zeta_np(whitener: PsiWhitener, psi: np.ndarray) -> np.ndarray:
    return (np.asarray(psi, dtype=np.float64) - _np64(whitener.center)) @ _np64(whitener.L_T).T
