"""PyTorch port, orchestration: the NLML initialization reaches the JAX
package's optimum, solve_magi runs the production recipe (128-chain
pooled, whitened) end to end on the CPU with band_impl="band" and keeps the
result contract, and so does every other sampler and metric. The default
path's cases are in tests/test_torch_solver_e2e.py; the envelope's, the
profiler's and the mesh checkpoints' in tests/test_torch_envelope.py,
tests/test_torch_api.py and tests/test_torch_mesh_checkpoint.py."""
import dataclasses

import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu import config as jconfig
from manifold_constrained_gaussian_process_inference_tpu.inference import nlml as jnlml
from manifold_constrained_gaussian_process_inference_tpu.inference import solve as jsolve
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import nlml as tnlml
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import solve as tsolve
from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
    integrate_system,
    sample_on_grid,
)

torch.set_num_threads(1)
THETA_TRUE = np.array([0.2, 0.2, 3.0])


def _fn_data(n_obs=21, t_end=8.0, noise=0.1, seed=0):
    rng = np.random.default_rng(seed)
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, t_end, THETA_TRUE, 800)
    t = np.linspace(0.0, t_end, n_obs)
    return sample_on_grid(ts.numpy(), xs.numpy(), t) + noise * rng.normal(size=(n_obs, 2)), t


def _nlml_data(seed=0, n=30):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 6, n)
    y = np.stack([np.sin(t), 0.5 * np.cos(2 * t)], -1) + 0.1 * rng.normal(size=(n, 2))
    y[[3, 11, 17], 0] = np.nan
    return y, t


def test_nlml_objective_matches_jax():
    y, t = _nlml_data()
    mask = np.isfinite(y)
    lps = np.random.default_rng(1).normal(size=(2, 3)) * 0.5
    got = tnlml.negative_log_marginal_likelihood(
        torch.as_tensor(lps), torch.as_tensor(np.where(mask, y, 0.0).T),
        torch.as_tensor(mask.T.astype(float)), torch.as_tensor(t), "matern52",
    ).numpy()
    for d in range(2):
        want = float(jnlml.negative_log_marginal_likelihood(
            lps[d], np.where(mask, y, 0.0)[:, d], mask[:, d].astype(float), t, "matern52",
        ))
        np.testing.assert_allclose(got[d], want, rtol=1e-10)
    np.testing.assert_array_equal(
        tnlml.default_initial_guesses(y, t), jnlml.default_initial_guesses(y, t)
    )


def test_nlml_optimum_matches_jax():
    y, t = _nlml_data(seed=2)
    got = tnlml.optimize_gp_hyperparameters(y, t, "matern52")
    want = jnlml.optimize_gp_hyperparameters(y, t, "matern52")
    mask = np.isfinite(y)

    def nlml(params, d):
        return float(jnlml.negative_log_marginal_likelihood(
            np.log(params[d]), np.where(mask, y, 0.0)[:, d], mask[:, d].astype(float), t,
            "matern52",
        ))

    for d in range(2):
        assert nlml(got, d) <= nlml(want, d) + 1e-6 * abs(nlml(want, d))
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_nlml_falls_back_on_degenerate_dimension():
    y, t = _nlml_data(seed=3)
    y[:, 1] = np.nan
    got = tnlml.optimize_gp_hyperparameters(y, t, "matern52", max_iters=20)
    guess = np.exp(tnlml.default_initial_guesses(y, t))
    np.testing.assert_allclose(got[1], guess[1])
    assert np.isfinite(got).all() and (got > 0).all()


def test_initializers_match_jax():
    y, t = _nlml_data(seed=4)
    np.testing.assert_array_equal(tsolve._init_x_interpolation(y, t), jsolve._init_x_interpolation(y, t))
    np.testing.assert_array_equal(
        tsolve._init_theta_from_bounds(mt.FN_SYSTEM), jsolve._init_theta_from_bounds(J_FN)
    )


def test_config_keys_match_jax():
    j_fields = {f.name: f.default for f in dataclasses.fields(jconfig.MagiConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(mt.MagiConfig)}
    assert set(t_fields) == set(j_fields) | {"device"}
    for name, default in j_fields.items():
        if name != "dtype":
            assert t_fields[name] == default, name
    cfg = mt.MagiConfig(sigma=[0.1, 0.1], phi=np.ones((2, 2)), device="cpu")
    assert cfg.sigma_is_fixed and cfg.resolved_dtype() == torch.float64
    assert mt.MagiConfig(device="cuda").resolved_dtype() == torch.float32
    assert not mt.MagiConfig(sigma=[0.1, 0.1]).sigma_is_fixed


@pytest.fixture(scope="module")
def solved():
    y, t = _fn_data()
    config = mt.MagiConfig(
        niter_hmc=120, burnin_ratio=0.5, step_size_factor=0.06, n_chains=4,
        mass_matrix="dense-pooled", chain_init_jitter=0.05, x_whitened=True,
        theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125, seed=7,
        chunk_size=40, band_impl="band", device="cpu",
    )
    return mt.solve_magi(y, t, mt.FN_SYSTEM, config), y, t


def test_solve_magi_band_result_contract(solved):
    res, y, t = solved
    n_keep, n, k = 4 * 60, y.shape[0], 3
    assert res.keys() == ("theta", "x_sampled", "sigma", "phi", "lp")
    assert res.theta.shape == (n_keep, k)
    assert res.x_sampled.shape == (n_keep, n, 2)
    assert res.sigma.shape == (n_keep, 2)
    assert res.phi.shape == (2, 2)
    assert res.lp.shape == (n_keep,)
    for a in (res.theta, res.x_sampled, res.sigma, res.lp):
        assert np.isfinite(a).all()
    d = res.diagnostics
    assert d["band_impl"] == "band" and d["n_chains"] == 4 and d["device"] == "cpu"
    assert d["theta_per_chain"].shape == (4, 60, k)
    assert d["lp_per_chain"].shape == (4, 60)
    assert set(d["phase_times_s"]) == {"nlml_s", "gn_map_s", "whitener_s", "warmup_s",
                                       "sampling_s"}
    assert d["host_syncs"] > 0 and d["lockstep_leaves"] >= d["transitions"] == 120
    assert (res.theta > 0).all()  # theta_constrained keeps the rates positive


def test_solve_magi_band_loose_recovery(solved):
    res, y, t = solved
    assert np.all(np.abs(res.theta.mean(0) - THETA_TRUE) < np.array([0.2, 0.3, 0.8]))
    assert np.all(np.abs(res.sigma.mean(0) - 0.1) < 0.08)
    x_mean = res.x_sampled.mean(0)
    assert np.sqrt(np.nanmean((x_mean - y) ** 2)) < 0.3


def test_pallas_band_impl_names_band():
    y, t = _fn_data()
    config = mt.MagiConfig(mass_matrix="dense-pooled", x_whitened=True, device="cpu",
                           band_impl="pallas", niter_hmc=4, gp_optim_iterations=2)
    with pytest.raises(ValueError, match="'band'"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, config)


def _jax_auto_band_impl(config, n_times, n_dims, bandsize):
    """The JAX package's band_impl="auto" rule (its solve.py) off a TPU,
    with its own constant."""
    from manifold_constrained_gaussian_process_inference_tpu.ops.pallas_band import (
        _PALLAS_MAX_BANDWIDTH,
    )

    eff_batch = (config.pt_temps * config.pt_replicas if config.sampler == "pt-nuts"
                 else config.n_chains)
    if n_times <= 1024 or (eff_batch >= 8 and n_dims * 6 * n_times * n_times * 4 <= 2 << 30):
        return "dense"
    return "dense" if bandsize > _PALLAS_MAX_BANDWIDTH else "band"


@pytest.mark.parametrize("device,n,chains,band,want", [
    ("cpu", 397, 128, 40, "dense"),
    ("cuda", 397, 128, 40, "dense"),
    ("cuda", 3169, 1, 40, "band"),
    ("cuda", 3169, 1, 80, "dense"),
    ("cuda", 3169, 128, 40, "dense"),
    ("cpu", 1500, 1, 40, "band"),
    # parallel tempering batches pt_temps * pt_replicas chains, whatever n_chains says
    ("cpu", 1500, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 40, "dense"),
    ("cuda", 1500, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 40, "dense"),
    ("cpu", 1500, dict(sampler="pt-nuts", n_chains=16, pt_temps=3, pt_replicas=2), 40, "band"),
    ("cpu", 1500, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 80, "dense"),
    ("cpu", 1500, dict(sampler="nuts", n_chains=16, pt_temps=1, pt_replicas=1), 40, "dense"),
])
def test_auto_band_policy(device, n, chains, band, want):
    options = chains if isinstance(chains, dict) else dict(n_chains=chains)
    config = mt.MagiConfig(**options)
    assert tsolve.resolve_band_impl(config, n, 2, band, torch.device(device)) == want
    if device == "cpu":  # the JAX package's rule off a TPU gives the same string
        assert _jax_auto_band_impl(jconfig.MagiConfig(**options), n, 2, band) == want
    explicit = mt.MagiConfig(band_impl="band")
    assert tsolve.resolve_band_impl(explicit, n, 2, band, torch.device(device)) == "band"


def test_default_device_is_the_card():
    """MagiConfig() resolves to the card; without one, a default-device
    solve_magi raises instead of running on the CPU."""
    assert mt.MagiConfig().resolved_device().type == "cuda"
    assert mt.default_device().type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    y, t = _fn_data()
    config = mt.MagiConfig(mass_matrix="dense-pooled", x_whitened=True, niter_hmc=4)
    with pytest.raises(tsolve.MagiError, match='device="cpu"'):
        mt.solve_magi(y, t, mt.FN_SYSTEM, config)


def test_tf32_is_refused():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(tsolve.MagiError, match="TF32"):
            tsolve._check_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tsolve._check_precision()


@pytest.mark.parametrize("options,n_chains", [
    (dict(sampler="pt-nuts", pt_temps=3, pt_replicas=1), 1),
    (dict(sampler="pt-nuts", pt_temps=2, pt_replicas=1, mass_matrix="dense-pooled"), 1),
    (dict(sampler="pt-nuts", pt_temps=3, pt_replicas=3, mass_matrix="dense-pooled"), 3),
    (dict(sampler="chees", n_chains=4, chees_criterion="chees"), 4),
    (dict(sampler="chees", n_chains=4, chees_criterion="snaper"), 4),
])
def test_solve_magi_runs_every_sampler(options, n_chains):
    """Every sampler and metric through solve_magi on the CPU keeps the
    result contract: (C, S) per-chain arrays, PT's per-rung stacks and
    swap statistics, ChEES's trajectory length."""
    y, t = _fn_data(n_obs=9, t_end=4.0)
    config = mt.MagiConfig(niter_hmc=40, seed=3, sigma=[0.1, 0.1], x_whitened=True,
                           phi=np.array([[1.0, 1.0], [1.5, 1.5]]), device="cpu", **options)
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    d = res.diagnostics
    assert d["n_chains"] == n_chains and d["theta_per_chain"].shape == (n_chains, 20, 3)
    assert d["lp_per_chain"].shape == d["accept_prob"].shape == (n_chains, 20)
    for a in (res.theta, res.x_sampled, res.lp):
        assert np.isfinite(a).all()
    if options["sampler"] == "pt-nuts":
        k = options["pt_temps"]
        assert d["accept_prob_per_rung"].shape[-1] == k and len(d["temperatures"]) == k
        assert len(d["swap_acceptance_per_pair"]) == k - 1 and 0 <= d["swap_acceptance"] <= 1
    else:
        assert d["trajectory_length"] > 0 and d["trajectory_warmup_trace"].shape == (20,)
