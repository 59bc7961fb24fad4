"""The data of each configuration: frozen copies of the port's generators
(``perf/workload.fn_bench_workload`` and ``hes1_workload``), a classical
RK4 in float64 of the full system at the true parameters, observed with
seeded noise.

The data set is the configuration's published problem: its noise is drawn
from the configuration's own ``data.seed`` (the production protocol's 42
for FitzHugh-Nagumo, the Hes1 example's 0), so that every run of a cell
samples the same posterior and the same work; ``--seed`` drives the run's
own randomness (the chains' start jitter, the momenta, the tree's
uniforms). A configuration file names its generator (``data.generator``)
and its parameters; ``make(config)`` returns (y (n, D) with NaN where
unobserved, t (n,), truth).
"""
from __future__ import annotations

import math

import numpy as np


def _fn(x, theta):
    v, r = x
    a, b, c = theta
    return (c * (v - v ** 3 / 3.0 + r), -(v - a + b * r) / c)


def _hes1log(x, theta):
    t1, t2, t3, t4, t5, f_h, gamma = theta
    p, m, h = (math.exp(v) for v in x)
    one_p2 = 1.0 + p * p
    return (-t1 * h + t2 * m / p - t3, -t4 + t5 / (one_p2 * m),
            -t1 * p + f_h / (one_p2 * h) - gamma)


RHS = {"fn": _fn, "hes1log": _hes1log}


def _rk4(system: str, x0, t_end: float, theta, n_steps: int):
    """RK4 of the full system from 0 to t_end: (ts (n_steps + 1,), xs)."""
    f, th = RHS[system], [float(v) for v in theta]
    h = t_end / n_steps
    x = [float(v) for v in x0]
    out = [x]
    for _ in range(n_steps):
        k1 = f(x, th)
        k2 = f([a + 0.5 * h * b for a, b in zip(x, k1)], th)
        k3 = f([a + 0.5 * h * b for a, b in zip(x, k2)], th)
        k4 = f([a + h * b for a, b in zip(x, k3)], th)
        x = [a + (h / 6.0) * (b1 + 2 * b2 + 2 * b3 + b4)
             for a, b1, b2, b3, b4 in zip(x, k1, k2, k3, k4)]
        out.append(x)
    return h * np.arange(n_steps + 1), np.asarray(out)


def _on(ts, xs, t):
    return np.stack([np.interp(t, ts, xs[:, d]) for d in range(xs.shape[1])], axis=-1)


def fn_grid(seed: int, p: dict):
    """FitzHugh-Nagumo at the true theta, ``n_obs`` noisy observations on
    [0, t_end] (sd ``noise``) on a grid with 2^fill - 1 points between
    observations."""
    rng = np.random.default_rng(seed)
    ts, xs = _rk4(p["system"], p["x0"], p["t_end"], p["theta"], p["rk4_steps"])
    t_obs = np.linspace(0.0, p["t_end"], p["n_obs"])
    y_obs = _on(ts, xs, t_obs) + p["noise"] * rng.normal(size=(p["n_obs"], len(p["x0"])))
    ins = 2 ** p["fill"] - 1
    segs = [np.linspace(t_obs[i], t_obs[i + 1], ins + 2)[:-1] for i in range(p["n_obs"] - 1)]
    t = np.concatenate(segs + [t_obs[-1:]])
    y = np.full((len(t), len(p["x0"])), np.nan)
    y[:: ins + 1] = y_obs
    return y, t, {"theta": np.asarray(p["theta"], np.float64), "x": _on(ts, xs, t)}


def alternating(seed: int, p: dict):
    """The MAGI paper's Hes1 design: the full system at the true theta on a
    grid of spacing ``grid_spacing``; every ``obs_spacing`` the observed
    components in turn (``observed``), one per time, noise sd ``noise``;
    the others never observed."""
    rng = np.random.default_rng(seed)
    ts, xs = _rk4(p["system"], p["x0"], p["t_end"], p["theta"], p["rk4_steps"])
    t = np.arange(0.0, p["t_end"] + 1e-9, p["grid_spacing"])
    x = _on(ts, xs, t)
    y = np.full(x.shape, np.nan)
    for i, ti in enumerate(t):
        k = round(ti / p["obs_spacing"])
        if abs(ti - k * p["obs_spacing"]) < 1e-9:
            d = p["observed"][k % len(p["observed"])]
            y[i, d] = x[i, d] + rng.normal() * p["noise"]
    return y, t, {"theta": np.asarray(p["theta_inferred"], np.float64), "x": x}


GENERATORS = {"fn_grid": fn_grid, "alternating": alternating}


def make(config: dict):
    data = config["data"]
    return GENERATORS[data["generator"]](int(data["seed"]), data)
