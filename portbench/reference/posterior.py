"""The MAGI log-posterior, written plainly from its definition (Yang, Wong
& Kou, PNAS 2021), for the benchmark's check of the port.

It imports nothing of the port and nothing of JAX: numpy for the one-time
GP operators (float64), torch for the batched log-density and its gradient
by autograd, in the dtype the caller asks for (float64 for the reference,
float32 with TF32 products for the control).

For each state dimension d, with the Matern-5/2 kernel of variance and
lengthscale phi_d on the grid t:

  C = k(t, t),  C' = dk/ds,  C'' = d2k/ds dt,  Cinv = (C + jitter I)^-1
  mphi = C' Cinv,  Kinv = (C'' - mphi C'^T + jitter I)^-1

each precision truncated to a band of half-width b (the band widened, as
the MAGI reference does, while the truncation loses definiteness by more
than 1% of its diagonal), and

  log p = -1/2 sum_d [ (f_d - mphi_d x_d)^T Kinv_d (f_d - mphi_d x_d) / beta_deriv
                       + x_d^T Cinv_d x_d / beta_level
                       + (SSE_d / sigma_d^2 + N_d log(2 pi sigma_d^2)) / beta_obs ]
          + log|d theta / d z| + sum(log sigma)   (sigma sampled)

over psi = [vec(x) dimension by dimension; z(theta); log sigma], with theta
= lb + exp(z) for a parameter bounded below when theta is constrained, and
sigma = exp(clamp(log sigma, -15, 15)). The whitened sampler's coordinates
zeta map to psi = center + W zeta; a linear map adds a constant to log p,
which the sampler drops, so log p(zeta) is log p(psi) and its gradient is
W^T grad_psi.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

SQRT5 = np.sqrt(5.0)
LOG_2PI = float(np.log(2.0 * np.pi))
LOG_SIGMA_CLAMP = 15.0
BAND_REPAIR_TOL = 1e-2


# -- ODE right-hand sides, x (..., n, D), theta (..., k) --------------------


def fitzhugh_nagumo(x, theta):
    v, r = x[..., 0], x[..., 1]
    a, b, c = (theta[..., i, None] for i in range(3))
    return torch.stack([c * (v - v ** 3 / 3.0 + r), -(v - a + b * r) / c], dim=-1)


def hes1_log(x, theta):
    """log-Hes1 over (log P, log M, log H), theta (a, b, c, d, e, f, gamma)."""
    t1, t2, t3, t4, t5, f_h, gamma = (theta[..., i, None] for i in range(7))
    p, m, h = (torch.exp(x[..., i]) for i in range(3))
    one_p2 = 1.0 + p * p
    return torch.stack([-t1 * h + t2 * m / p - t3,
                        -t4 + t5 / (one_p2 * m),
                        -t1 * p + f_h / (one_p2 * h) - gamma], dim=-1)


def hes1_log_fixed_f(x, theta):
    """log-Hes1 with f fixed at 20 (theta: a, b, c, d, e, gamma)."""
    twenty = torch.full_like(theta[..., :1], 20.0)
    return hes1_log(x, torch.cat([theta[..., :5], twenty, theta[..., 5:]], dim=-1))


SYSTEMS = {"fn": (fitzhugh_nagumo, 3), "hes1log": (hes1_log, 7),
           "hes1log_fixf": (hes1_log_fixed_f, 6)}


# -- the GP operators (numpy, float64) ---------------------------------------


def matern52_blocks(t: np.ndarray, variance: float, lengthscale: float):
    """C, C' = dk(t_i, t_j)/dt_i and C'' = d2k/dt_i dt_j of Matern-5/2."""
    dt = t[:, None] - t[None, :]
    d = np.abs(dt)
    s = SQRT5 * d / lengthscale
    e = np.exp(-s)
    c = variance * (1.0 + s + s * s / 3.0) * e
    # dk/dr = -variance (5 r / (3 l^2)) (1 + sqrt5 r / l) e^{-sqrt5 r / l}
    dk_dr = -variance * (5.0 * d / (3.0 * lengthscale ** 2)) * (1.0 + s) * e
    c1 = np.sign(dt) * dk_dr
    # d2k/dt_i dt_j = -d2k/dr2
    d2k_dr2 = -variance * (5.0 / (3.0 * lengthscale ** 2)) * (1.0 + s - s * s) * e
    c2 = -d2k_dr2
    return c, c1, c2


def _spd_inverse(a: np.ndarray, jitter: float) -> np.ndarray:
    """Inverse of a symmetric matrix through its Cholesky factor; the
    diagonal is raised by jitter x 10^k until the factor exists."""
    a = 0.5 * (a + a.T)
    eye = np.eye(a.shape[0])
    for k in range(8):
        try:
            low = np.linalg.cholesky(a + (0.0 if k == 0 else jitter * 10.0 ** (k - 1)) * eye)
        except np.linalg.LinAlgError:
            continue
        inv_low = np.linalg.inv(low)
        return inv_low.T @ inv_low
    raise np.linalg.LinAlgError("the GP covariance is not positive definite")


def _band(a: np.ndarray, b: int) -> np.ndarray:
    i = np.arange(a.shape[0])
    return np.where(np.abs(i[:, None] - i[None, :]) <= b, a, 0.0)


def _definite_band(a_band: np.ndarray):
    """The band-truncated precision as the quadratic form uses it, and the
    relative diagonal shift that made it definite (0 when it already is):
    the diagonal raised by scale x 1e-14 x 10^k, then, failing that, by
    |lambda_min| + scale x 1e-10."""
    n = a_band.shape[0]
    scale = float(np.max(np.abs(np.diagonal(a_band)))) or 1.0
    eye = np.eye(n)
    for k in range(10):
        shift = 0.0 if k == 0 else scale * 1e-14 * 10.0 ** (k - 1)
        try:
            np.linalg.cholesky(a_band + shift * eye)
        except np.linalg.LinAlgError:
            continue
        return a_band + shift * eye, shift / scale
    sym = 0.5 * (a_band + a_band.T)
    shift = max(0.0, -float(np.linalg.eigvalsh(sym).min())) + scale * 1e-10
    return sym + shift * eye, shift / scale


def gp_operators(t: np.ndarray, phi: np.ndarray, bandsize: int, jitter: float,
                 escalate: bool = True):
    """(mphi_band, Kinv_band, Cinv_band) stacks (D, n, n) and the band used."""
    n = t.shape[0]
    b = max(min(int(bandsize), n - 1), 0)
    dense = []
    for d in range(phi.shape[1]):
        c, c1, c2 = matern52_blocks(t, float(phi[0, d]), float(phi[1, d]))
        cinv = _spd_inverse(0.5 * (c + c.T) + jitter * np.eye(n), jitter)
        mphi = c1 @ cinv
        kphi = c2 - mphi @ c1.T
        kinv = _spd_inverse(0.5 * (kphi + kphi.T) + jitter * np.eye(n), jitter)
        dense.append((mphi, kinv, cinv))
    while True:
        parts = [(_band(m, b), *_definite_band(_band(k, b)), *_definite_band(_band(ci, b)))
                 for m, k, ci in dense]
        worst = max(max(p[2], p[4]) for p in parts)
        if not escalate or worst <= BAND_REPAIR_TOL or b >= n - 1:
            break
        b = min(max(2 * b, b + 10), n - 1)
    return (np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts]),
            np.stack([p[3] for p in parts]), b)


# -- the posterior ------------------------------------------------------------


@dataclass
class Posterior:
    """The MAGI posterior of one data set, batched over chains."""

    system: str
    y: np.ndarray               # (n, D), NaN where unobserved
    t: np.ndarray               # (n,)
    phi: np.ndarray             # (2, D)
    sigma: Optional[np.ndarray]  # (D,) when fixed, None when sampled
    prior_temperature: tuple
    theta_lower: np.ndarray     # (k,)
    theta_constrained: bool
    bandsize: int
    jitter: float

    def __post_init__(self):
        self.f, self.k = SYSTEMS[self.system]
        self.n, self.d = self.y.shape
        self.mphi, self.kinv, self.cinv, self.band = gp_operators(
            np.asarray(self.t, np.float64), np.asarray(self.phi, np.float64), self.bandsize,
            self.jitter)
        self.dim = self.n * self.d + self.k + (0 if self.sigma is not None else self.d)
        self._cache = {}

    def _tensors(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._cache:
            put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
            mask = np.isfinite(self.y)
            self._cache[key] = dict(
                mphi=put(self.mphi), kinv=put(self.kinv), cinv=put(self.cinv),
                y=put(np.where(mask, self.y, 0.0)), mask=put(mask.astype(np.float64)),
                nobs=put(mask.sum(0).astype(np.float64)),
                beta=[float(b) for b in self.prior_temperature],
                lb=put(self.theta_lower),
                sigma=None if self.sigma is None else put(self.sigma))
        return self._cache[key]

    def log_density(self, psi: torch.Tensor) -> torch.Tensor:
        """log p(psi), psi (C, dim) -> (C,)."""
        c = self._tensors(psi.dtype, psi.device)
        n, d, k = self.n, self.d, self.k
        x = psi[:, : n * d].reshape(-1, d, n).transpose(1, 2)  # (C, n, D)
        z = psi[:, n * d: n * d + k]
        if self.theta_constrained:
            theta, jac = c["lb"] + torch.exp(z), z.sum(-1)
        else:
            theta, jac = z, torch.zeros_like(z[:, 0])
        if self.sigma is None:
            log_sigma = torch.clamp(psi[:, n * d + k:], -LOG_SIGMA_CLAMP, LOG_SIGMA_CLAMP)
            sigma, jac = torch.exp(log_sigma), jac + log_sigma.sum(-1)
        else:
            sigma = c["sigma"].expand(psi.shape[0], d)
        xd = x.transpose(1, 2)                                    # (C, D, n)
        e = self.f(x, theta).transpose(1, 2) - torch.einsum("dij,cdj->cdi", c["mphi"], xd)
        deriv = (e * torch.einsum("dij,cdj->cdi", c["kinv"], e)).sum((1, 2))
        level = (xd * torch.einsum("dij,cdj->cdi", c["cinv"], xd)).sum((1, 2))
        resid = c["mask"] * (x - c["y"])
        sse = (resid * resid).sum(1)                              # (C, D)
        obs = (sse / sigma ** 2 + c["nobs"] * (LOG_2PI + 2.0 * torch.log(sigma))).sum(-1)
        b_deriv, b_level, b_obs = c["beta"]
        return -0.5 * (deriv / b_deriv + level / b_level + obs / b_obs) + jac

    def value_and_grad(self, psi: torch.Tensor):
        psi = psi.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = self.log_density(psi)
            (g,) = torch.autograd.grad(lp.sum(), psi)
        return lp.detach(), g.detach()


class Whitened:
    """log p over the sampler's coordinates zeta, psi = center + W zeta."""

    def __init__(self, posterior: Posterior, w: torch.Tensor, center: torch.Tensor):
        self.posterior, self.w, self.center = posterior, w, center

    def __call__(self, zeta: torch.Tensor):
        lp, g = self.posterior.value_and_grad(self.center + zeta @ self.w.T)
        return lp, g @ self.w


class Tempered:
    """(beta lp, beta g) with one inverse temperature per chain."""

    def __init__(self, vg, beta: torch.Tensor):
        self.vg, self.beta = vg, beta

    def __call__(self, q):
        lp, g = self.vg(q)
        return lp * self.beta, g * self.beta[:, None]
