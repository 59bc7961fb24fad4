"""Benchmark ODE systems (port of the JAX package's models/systems.py):
FitzHugh-Nagumo, Hes1, log-Hes1 (with its fixed-gamma and fixed-f
variants), HIV (log states) and protein transduction. FN and Hes1 carry
analytic Jacobians; the rest take ``models/base.py``'s ``torch.func``
defaults. Every function broadcasts over leading batch axes: x (..., n, D)
with theta (..., k).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import OdeSystem, register

_INF = np.inf


def _params(theta, count):
    # (..., k) -> k tensors of shape (..., 1), broadcasting against (..., n)
    return tuple(theta[..., i, None] for i in range(count))


def _jacobian(rows):
    """Entries [p][j] (tensors broadcasting to one shape (..., n)) -> the
    Jacobian (..., n, P, J)."""
    width = len(rows[0])
    flat = torch.broadcast_tensors(*(e for row in rows for e in row))
    return torch.stack(
        [torch.stack(flat[r * width : (r + 1) * width], dim=-1) for r in range(len(rows))],
        dim=-2,
    )


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


# ---------------------------------------------------------------------------
# Hes1 (3 states P, M, H; 7 params)
# ---------------------------------------------------------------------------

def hes1_f(x, theta, tvec):
    p, m, h = x[..., 0], x[..., 1], x[..., 2]
    t1, t2, t3, t4, t5, t6, t7 = _params(theta, 7)
    one_p2 = 1.0 + p**2
    dp = -t1 * p * h + t2 * m - t3 * p
    dm = -t4 * m + t5 / one_p2
    dh = -t1 * p * h + t6 / one_p2 - t7 * h
    return torch.stack([dp, dm, dh], dim=-1)


def hes1_f_dx(x, theta, tvec):
    p, m, h = x[..., 0], x[..., 1], x[..., 2]
    t1, t2, t3, t4, t5, t6, t7 = _params(theta, 7)
    one_p2 = 1.0 + p**2
    zero = torch.zeros_like(p)
    return _jacobian([
        [-t1 * h - t3, t2, -t1 * p],
        [-t5 * 2.0 * p / one_p2**2, -t4, zero],
        [-t1 * h - t6 * 2.0 * p / one_p2**2, zero, -t1 * p - t7],
    ])


def hes1_f_dtheta(x, theta, tvec):
    p, m, h = x[..., 0], x[..., 1], x[..., 2]
    one_p2 = 1.0 + p**2
    zero = torch.zeros_like(p)
    return _jacobian([
        [-p * h, m, -p, zero, zero, zero, zero],
        [zero, zero, zero, -m, 1.0 / one_p2, zero, zero],
        [-p * h, zero, zero, zero, zero, 1.0 / one_p2, -h],
    ])


HES1_SYSTEM = register(
    OdeSystem(
        f=hes1_f, f_dx=hes1_f_dx, f_dtheta=hes1_f_dtheta,
        theta_lower_bound=np.zeros(7),
        theta_upper_bound=np.full(7, _INF),
        theta_size=7, name="hes1",
    )
)


# ---------------------------------------------------------------------------
# log-Hes1 (states log P, log M, log H) and its fixed-gamma / fixed-f forms
# ---------------------------------------------------------------------------

def _hes1log(x, t1, t2, t3, t4, t5, f_h, gamma):
    p, m, h = (torch.exp(x[..., i]) for i in range(3))
    one_p2 = 1.0 + p**2
    dlp = -t1 * h + t2 * m / p - t3
    dlm = -t4 + t5 / (one_p2 * m)
    dlh = -t1 * p + f_h / (one_p2 * h) - gamma
    return torch.stack([dlp, dlm, dlh], dim=-1)


def hes1log_f(x, theta, tvec):
    return _hes1log(x, *_params(theta, 7))


def hes1log_fixg_f(x, theta, tvec):
    """gamma fixed at 0.3 (6 params)."""
    return _hes1log(x, *_params(theta, 6), 0.3)


def hes1log_fixf_f(x, theta, tvec):
    """f fixed at 20.0 (6 params; the last is gamma)."""
    t1, t2, t3, t4, t5, gamma = _params(theta, 6)
    return _hes1log(x, t1, t2, t3, t4, t5, 20.0, gamma)


HES1LOG_SYSTEM = register(
    OdeSystem(
        f=hes1log_f,
        theta_lower_bound=np.zeros(7),
        theta_upper_bound=np.full(7, _INF),
        theta_size=7, name="hes1log",
    )
)

HES1LOG_FIXG_SYSTEM = register(
    OdeSystem(
        f=hes1log_fixg_f,
        theta_lower_bound=np.zeros(6),
        theta_upper_bound=np.full(6, _INF),
        theta_size=6, name="hes1log_fixg",
    )
)

HES1LOG_FIXF_SYSTEM = register(
    OdeSystem(
        f=hes1log_fixf_f,
        theta_lower_bound=np.zeros(6),
        theta_upper_bound=np.full(6, _INF),
        theta_size=6, name="hes1log_fixf",
    )
)


# ---------------------------------------------------------------------------
# HIV (log states log T, log Tm, log Tw, log Tmw; 9 params; 1e-6 scale)
# ---------------------------------------------------------------------------

def hiv_f(x, theta, tvec):
    t_, tm, tw, tmw = (torch.exp(x[..., i]) for i in range(4))
    p = _params(theta, 9)
    sf = 1e-6
    d1 = p[0] - sf * p[1] * tm - sf * p[2] * tw - sf * p[3] * tmw
    d2 = p[6] + sf * p[1] * t_ - sf * p[4] * tw + sf * 0.25 * p[3] * tmw * t_ / tm
    d3 = p[7] + sf * p[2] * t_ - sf * p[5] * tm + sf * 0.25 * p[3] * tmw * t_ / tw
    d4 = p[8] + 0.5 * sf * p[3] * t_ + (sf * p[4] + sf * p[5]) * tw * tm / tmw
    return torch.stack([d1, d2, d3, d4], dim=-1)


HIV_SYSTEM = register(
    OdeSystem(
        f=hiv_f,
        theta_lower_bound=np.full(9, -_INF),
        theta_upper_bound=np.full(9, _INF),
        theta_size=9, name="hiv",
    )
)


# ---------------------------------------------------------------------------
# Protein transduction (5 states S, dS, R, RS, RPP; 6 params)
# ---------------------------------------------------------------------------

def ptrans_f(x, theta, tvec):
    s, r, rs, rpp = x[..., 0], x[..., 2], x[..., 3], x[..., 4]
    p = _params(theta, 6)
    mm = p[4] * rpp / (p[5] + rpp)
    d1 = -p[0] * s - p[1] * s * r + p[2] * rs
    d2 = p[0] * s
    d3 = -p[1] * s * r + p[2] * rs + mm
    d4 = p[1] * s * r - p[2] * rs - p[3] * rs
    d5 = p[3] * rs - mm
    return torch.stack([d1, d2, d3, d4, d5], dim=-1)


PTRANS_SYSTEM = register(
    OdeSystem(
        f=ptrans_f,
        theta_lower_bound=np.zeros(6),
        theta_upper_bound=np.full(6, _INF),
        theta_size=6, name="ptrans",
    )
)
