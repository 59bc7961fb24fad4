"""The FitzHugh-Nagumo bench workload and the slice's likelihood, the
model-family workloads and config 3's log-Hes1 data, shared by
``chip_smoke.py``, the tests and the measurement scripts of this
subpackage."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SEED = 42
THETA_TRUE = np.array([0.2, 0.2, 3.0])
SIGMA_TRUE = 0.2
# GP hyperparameters of the likelihood checks (NLML gives about these).
PHI = np.array([[2.0, 2.0], [1.5, 1.5]])
TEMPS = (1.0, 1.0, 1.0)


def fn_bench_workload(n_obs=100, t_end=20.0, fill=2, seed=SEED):
    """bench.py's workload, generated with the port's integrators: FN at
    the true theta, 100 noisy observations on [0, 20] (noise sd 0.2), on a
    grid with 2**fill - 1 points between observations (fill=2: n = 397;
    fill=5: n = 3169)."""
    from ..models import FN_SYSTEM
    from ..utils.integrators import integrate_system, sample_on_grid

    rng = np.random.default_rng(seed)
    ts, xs = integrate_system(FN_SYSTEM, [-1.0, 1.0], 0.0, t_end, THETA_TRUE, 4000)
    t_obs = np.linspace(0.0, t_end, n_obs)
    y_at_obs = sample_on_grid(ts.numpy(), xs.numpy(), t_obs) + SIGMA_TRUE * rng.normal(
        size=(n_obs, 2)
    )
    ins = 2**fill - 1
    segs = [np.linspace(t_obs[i], t_obs[i + 1], ins + 2)[:-1] for i in range(n_obs - 1)]
    t_grid = np.concatenate(segs + [t_obs[-1:]])
    y_grid = np.full((len(t_grid), 2), np.nan)
    y_grid[:: ins + 1] = y_at_obs
    return y_grid, t_grid


class SliceLikelihood(NamedTuple):
    """The slice's whitened, mode-centered likelihood at the bench
    workload: float64 covariances on the host, the theta transform, the GN
    whitener at the interpolated start, and ``vg(device, impl)``."""

    cov64: object
    whitener: object
    dimension: int
    target: object  # (cov, impl) -> MagiTarget

    def vg(self, impl: str, dtype=torch.float32, device="cuda"):
        from ..inference.whiten import make_centered_whitened_vg

        cov = self.cov64.to(dtype=dtype, device=device)
        wh = type(self.whitener)(*(a.to(dtype=dtype, device=device) for a in self.whitener))
        return make_centered_whitened_vg(self.target(cov, impl), wh)


def slice_likelihood(y, t, bandsize: int, auto_escalate: bool = True) -> SliceLikelihood:
    """The likelihood at ``bandsize``, escalated as ``build_gp_cov`` settles
    it unless ``auto_escalate`` is False."""
    from ..inference.solve import _init_x_interpolation
    from ..inference.target import MagiTarget
    from ..inference.transforms import make_theta_transform, unconstrain
    from ..inference.whiten import build_psi_whitener
    from ..models import FN_SYSTEM
    from ..ops.gp_cov import build_gp_cov

    cov64 = build_gp_cov("matern52", PHI, t, bandsize=bandsize,
                         auto_escalate_bandsize=auto_escalate)
    tr = make_theta_transform(FN_SYSTEM.theta_lower_bound, FN_SYSTEM.theta_upper_bound)
    sigma0 = np.array([SIGMA_TRUE, SIGMA_TRUE])

    def target(cov, impl):
        return MagiTarget.build(y, cov, FN_SYSTEM, sigma0, TEMPS, False,
                                band_impl=impl, theta_transform=tr)

    t64 = target(cov64, "dense")
    x0 = _init_x_interpolation(y, t)
    center = np.concatenate([x0.T.reshape(-1), unconstrain(tr, THETA_TRUE), np.log(sigma0)])
    wh = build_psi_whitener(cov64, y, t64, center, TEMPS, torch.float64)
    return SliceLikelihood(cov64, wh, t64.dimension, target)


# The model-family workloads of the JAX package's end-to-end tests
# (tests/test_model_families_e2e.py): system name, initial state, true
# theta, t_end, observations, noise sd, RK4 steps, and the solve_magi
# options (phi and sigma fixed). ``positive``: theta must stay positive.
FAMILY_CASES = {
    "ptrans": dict(
        x0=[1.0, 0.0, 1.0, 0.0, 0.0], theta=[0.07, 0.6, 0.05, 0.3, 0.017, 0.3],
        t_end=60.0, n_obs=15, noise=0.01, n_steps=3000, positive=True,
        config=dict(niter_hmc=60, seed=2, theta_constrained=True, map_init_iterations=100),
        phi=(0.5, 20.0),
    ),
    "hiv": dict(
        x0=list(np.log([600.0, 30.0, 20.0, 8.0])),
        theta=[36.0, 0.108, 0.5, 1e3, 1e3, 1e3, -0.2, -0.3, -0.5],
        t_end=0.1, n_obs=12, noise=0.05, n_steps=2000, positive=False,
        config=dict(niter_hmc=40, seed=3, map_init_iterations=50),
        phi=(10.0, 0.1),
    ),
    "hes1log_fixg": dict(
        x0=list(np.log([1.439, 2.037, 17.904])), theta=[0.022, 0.3, 0.031, 0.028, 0.5, 20.0],
        t_end=120.0, n_obs=13, noise=0.1, n_steps=3000, positive=True,
        config=dict(niter_hmc=40, seed=4, theta_constrained=True, map_init_iterations=100,
                    gp_mean="observed"),
        phi=(1.0, 40.0),
    ),
}


def family_problem(name: str, seed: int = 0):
    """(system, y, t, solve_magi options) of one FAMILY_CASES workload:
    RK4 truth at the true theta, noisy observations on a uniform grid, with
    sigma and phi fixed as in the JAX package's test."""
    from ..models import get_system
    from ..utils.integrators import integrate_system, sample_on_grid

    case = FAMILY_CASES[name]
    system = get_system(name)
    rng = np.random.default_rng(seed)
    ts, xs = integrate_system(system, case["x0"], 0.0, case["t_end"],
                              np.asarray(case["theta"]), case["n_steps"])
    t = np.linspace(0.0, case["t_end"], case["n_obs"])
    d = len(case["x0"])
    y = sample_on_grid(ts.numpy(), xs.numpy(), t) + rng.normal(size=(case["n_obs"], d)) * case["noise"]
    variance, lengthscale = case["phi"]
    options = dict(case["config"], sigma=np.full(d, case["noise"]),
                   phi=np.vstack([np.full(d, variance), np.full(d, lengthscale)]))
    return system, y, t, options


# Config 3 of docs/BENCHMARKS.md (the recipe of examples/hes1_example.py and
# benchmarks/run_baseline_configs.py): log-Hes1 on the MAGI paper's design,
# P and M observed in alternation every 15 minutes on [0, 240], H never
# observed, noise sd 0.15 on the log scale; inference runs the fixed-f
# variant (6 parameters) with phi and sigma given.
HES1_THETA_TRUE = np.array([0.022, 0.3, 0.031, 0.028, 0.5, 20.0, 0.3])
HES1_THETA_TRUE_FIXF = np.array([0.022, 0.3, 0.031, 0.028, 0.5, 0.3])
HES1_X0 = np.log(np.array([1.439, 2.037, 17.904]))
HES1_NOISE_SD = 0.15
HES1_CONFIG3 = dict(
    niter_hmc=8000, step_size_factor=0.05, sampler="pt-nuts", pt_temps=10, pt_replicas=4,
    x_whitened=True, target_accept_ratio=0.95, mass_matrix="dense-pooled",
    phi=np.array([[2.0, 1.5, 12.0], [55.0, 55.0, 55.0]]), sigma=np.full(3, HES1_NOISE_SD),
    map_init_iterations=3000, map_init_lr=0.02, theta_constrained=True, chunk_size=500,
)


def hes1_workload(t_end=240.0, obs_spacing=15.0, grid_spacing=7.5, seed=0):
    """(t_grid, y, x_truth) of config 3, generated with the port's
    integrators: RK4 truth of the full log-Hes1 system (8000 steps) on a
    grid of spacing 7.5 (n = 33); P at t = 0, 30, 60, ..., M at t = 15, 45,
    ..., H never; NaN where unobserved."""
    from ..models import HES1LOG_SYSTEM
    from ..utils.integrators import integrate_system, sample_on_grid

    rng = np.random.default_rng(seed)
    ts, xs = integrate_system(HES1LOG_SYSTEM, HES1_X0, 0.0, t_end, HES1_THETA_TRUE, 8000)
    t_grid = np.arange(0.0, t_end + 1e-9, grid_spacing)
    x_truth = sample_on_grid(ts.numpy(), xs.numpy(), t_grid)
    y = np.full((len(t_grid), 3), np.nan)
    for i, t in enumerate(t_grid):
        k = round(t / obs_spacing)
        if abs(t - k * obs_spacing) < 1e-9:
            dim = 0 if k % 2 == 0 else 1
            y[i, dim] = x_truth[i, dim] + rng.normal() * HES1_NOISE_SD
    return t_grid, y, x_truth
