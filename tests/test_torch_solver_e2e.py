"""PyTorch port, solve_magi at the library's defaults (one chain, the
diagonal Welford metric, raw Psi) on the CPU: mirrors of the eight fast
cases of the JAX package's tests/test_solver.py, with the same data,
configurations and assertions, and the port's diagnostics carry every key
of the JAX package's for the same configuration."""
import warnings

import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.config import MagiConfig as JConfig
from manifold_constrained_gaussian_process_inference_tpu.inference.solve import (
    solve_magi as j_solve_magi,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import MagiError
from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
    integrate_system,
    sample_on_grid,
)

torch.set_num_threads(1)
PHI = np.array([[1.0, 1.0], [1.5, 1.5]])


def _config(**kw):
    return mt.MagiConfig(device="cpu", **kw)


def _fn_data(n_obs=41, t_end=10.0, sigma=0.2, seed=123):
    """The JAX test's FN data (fill=0): RK4 truth plus seeded noise."""
    rng = np.random.default_rng(seed)
    theta_true = np.array([0.2, 0.2, 3.0])
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, t_end, theta_true, 4000)
    t_obs = np.linspace(0.0, t_end, n_obs)
    x_at_obs = sample_on_grid(ts.numpy(), xs.numpy(), t_obs)
    return t_obs, x_at_obs + rng.normal(size=x_at_obs.shape) * sigma, theta_true, x_at_obs


def test_fixed_phi_sigma_smoke():
    t_grid, y_grid, _, _ = _fn_data(n_obs=9, t_end=4.0)
    y_grid[3, 0] = np.nan
    n, d = y_grid.shape
    res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
        niter_hmc=40, burnin_ratio=0.5, sigma=[0.2, 0.2], phi=PHI, band_size=20, seed=1,
    ))
    assert res.theta.shape == (20, 3)
    assert res.x_sampled.shape == (20, n, d)
    assert res.sigma.shape == (20, d)
    assert np.allclose(res.sigma, 0.2)
    assert res.phi.shape == (2, d)
    assert res.lp.shape == (20,)
    for a in (res.theta, res.x_sampled, res.lp):
        assert np.all(np.isfinite(a))
    diag = res.diagnostics
    assert diag["sigma_is_fixed"] and diag["n_chains"] == 1
    assert diag["inv_mass"].shape == (1, 2 * n + 3) and diag["step_size"].shape == (1,)


def test_initial_params_override():
    t_grid, y_grid, _, x_at_obs = _fn_data(n_obs=9, t_end=4.0)
    psi0 = np.concatenate([x_at_obs.T.reshape(-1), [-0.5, 0.2, 3.0], np.log([0.2, 0.2])])
    res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
        niter_hmc=20, burnin_ratio=0.5, seed=3, gp_optim_iterations=20,
    ), initial_params=psi0)
    assert res.theta.shape == (10, 3)
    assert np.all(np.isfinite(res.theta))


def test_multichain_solve():
    t_grid, y_grid, _, _ = _fn_data(n_obs=9, t_end=4.0)
    res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
        niter_hmc=40, burnin_ratio=0.5, n_chains=4, seed=5, sigma=[0.2, 0.2], phi=PHI,
    ))
    diag = res.diagnostics
    assert res.theta.shape == (4 * 20, 3)
    assert diag["n_chains"] == 4
    assert diag["lp_per_chain"].shape == (4, 20)
    assert diag["theta_per_chain"].shape == (4, 20, 3)
    assert diag["final_psi"].shape[0] == 4
    assert diag["inv_mass"].shape == (4, 2 * 9 + 3)
    assert not np.allclose(diag["theta_per_chain"][0], diag["theta_per_chain"][1])


def test_unsupported_kernel_falls_back_and_diagnostics_keys_match_jax(caplog):
    """kernel="cosine" warns and runs as matern52; the port's diagnostics
    have every key of the JAX package's for this configuration."""
    t_grid, y_grid, _, _ = _fn_data(n_obs=7, t_end=3.0)
    kw = dict(niter_hmc=10, kernel="cosine", seed=2, sigma=[0.2, 0.2], phi=PHI)
    with caplog.at_level("WARNING"):
        res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(**kw))
    assert "Defaulting to matern52" in caplog.text
    assert np.all(np.isfinite(res.theta))
    want = j_solve_magi(y_grid, t_grid, J_FN, JConfig(**kw)).diagnostics
    assert set(want) <= set(res.diagnostics), set(want) - set(res.diagnostics)
    for key in set(want) - {"final_key", "sampling_time_s", "total_time_s"}:
        assert np.shape(res.diagnostics[key]) == np.shape(want[key]), key


def test_band_impl_band_through_solver():
    t_grid, y_grid, _, _ = _fn_data(n_obs=9, t_end=4.0)
    res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
        niter_hmc=20, band_size=4, band_impl="band", seed=4, sigma=[0.2, 0.2], phi=PHI,
    ))
    assert np.all(np.isfinite(res.x_sampled))
    assert res.diagnostics["band_impl"] == "band"


def test_exogenous_x_and_theta_init():
    t_grid, y_grid, _, x_at_obs = _fn_data(n_obs=9, t_end=4.0)
    res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
        niter_hmc=20, seed=9, sigma=[0.2, 0.2], phi=PHI, x_init=x_at_obs,
        theta_init=[-1.0, 0.2, 3.0],
    ))
    assert np.all(np.isfinite(res.theta))
    with pytest.raises(MagiError):
        mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
            niter_hmc=10, x_init=x_at_obs[:3], sigma=[0.2, 0.2], phi=PHI))
    with pytest.raises(MagiError):
        mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
            niter_hmc=10, theta_init=[0.1], sigma=[0.2, 0.2], phi=PHI))


def test_derivative_fallback_kernel_runs():
    """kernel="matern-1.5": C computed, derivative blocks zero, Kphi is
    jitter * I; the solve still runs."""
    t_grid, y_grid, _, _ = _fn_data(n_obs=7, t_end=3.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = mt.solve_magi(y_grid, t_grid, mt.FN_SYSTEM, _config(
            niter_hmc=10, kernel="matern-1.5", seed=5, sigma=[0.2, 0.2], phi=PHI))
    assert np.all(np.isfinite(res.lp))


def test_dimension_errors():
    t = np.linspace(0, 1, 5)
    y = np.zeros((5, 2))
    with pytest.raises(MagiError):
        mt.solve_magi(y, t[:4], mt.FN_SYSTEM, _config(niter_hmc=10))
    with pytest.raises(MagiError):
        mt.solve_magi(y, t, mt.FN_SYSTEM, _config(niter_hmc=10, sigma=[0.1], phi=np.ones((2, 2))))
    with pytest.raises(MagiError):
        mt.solve_magi(y, t, mt.FN_SYSTEM, _config(niter_hmc=10), initial_params=np.zeros(3))
