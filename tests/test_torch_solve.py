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
from manifold_constrained_gaussian_process_inference_tpu_torch.perf import layout_sweep
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
    assert set(d["phase_times_s"]) == {"nlml_s", "gp_target_s", "gn_map_s", "whitener_s",
                                       "sampler_setup_s", "warmup_s", "sampling_s", "results_s"}
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
    # the card: dense only for a band that is wide (b > n/8), long (b >= 64)
    # and batched (9 chains or more) while the dense stacks fit in 2 GiB
    ("cuda", 397, 128, 40, "band"),
    ("cuda", 3169, 1, 40, "band"),
    ("cuda", 3169, 1, 80, "band"),
    ("cuda", 3169, 128, 40, "band"),
    ("cuda", 3169, 128, 160, "band"),
    ("cuda", 512, 128, 64, "band"),
    ("cuda", 511, 128, 64, "dense"),
    ("cuda", 397, 128, 63, "band"),
    ("cuda", 397, 128, 64, "dense"),
    ("cuda", 319, 128, 40, "band"),
    ("cuda", 15, 1, 14, "band"),
    ("cuda", 15, 128, 14, "band"),
    ("cuda", 397, 8, 160, "band"),
    ("cuda", 397, 9, 160, "dense"),
    ("cuda", 6688, 128, 1000, "dense"),
    ("cuda", 6689, 128, 1000, "band"),
    ("cpu", 1500, 1, 40, "band"),
    # parallel tempering batches pt_temps * pt_replicas chains, whatever n_chains says
    ("cpu", 1500, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 40, "dense"),
    ("cuda", 1500, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 40, "band"),
    ("cuda", 397, dict(sampler="pt-nuts", n_chains=1, pt_temps=8, pt_replicas=4), 160, "dense"),
    ("cuda", 397, dict(sampler="pt-nuts", n_chains=16, pt_temps=4, pt_replicas=2), 160, "band"),
    # config 3: 10 rungs x 4 replicas at n = 33, b = 20
    ("cuda", 33, dict(sampler="pt-nuts", n_chains=1, pt_temps=10, pt_replicas=4), 20, "band"),
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


# The layout sweep on the H100 (perf/layout_sweep.py; PERF.md §6):
# (n, M, b, chains, ms per replayed value-and-grad on band (the mean of its
# two turns), on dense): FN at n = 199 to 3169, then the model families'
# and config 3's grids.
LAYOUT_SWEEP = [
    (199, 2, 20, 1, 0.2296, 0.2405), (199, 2, 20, 8, 0.2771, 0.3028),
    (199, 2, 20, 40, 0.2547, 0.2810), (199, 2, 20, 128, 0.2666, 0.2927),
    (397, 2, 20, 1, 0.2278, 0.2455), (397, 2, 20, 8, 0.2523, 0.2808),
    (397, 2, 20, 40, 0.2727, 0.3161), (397, 2, 20, 128, 0.2954, 0.3574),
    (793, 2, 80, 1, 0.2386, 0.2624), (793, 2, 80, 8, 0.2816, 0.3251),
    (793, 2, 80, 40, 0.3774, 0.4430), (793, 2, 80, 128, 0.4120, 0.4945),
    (1585, 2, 160, 1, 0.2813, 0.3487), (1585, 2, 160, 8, 0.3870, 0.4968),
    (1585, 2, 160, 40, 0.5118, 0.6939), (1585, 2, 160, 128, 0.5950, 0.8494),
    (3169, 2, 160, 1, 0.3967, 0.5496), (3169, 2, 160, 8, 0.6049, 0.9630),
    (3169, 2, 160, 40, 0.6947, 1.2972), (3169, 2, 160, 128, 1.0346, 1.9290),
    (1585, 2, 40, 1, 0.2531, 0.3412), (1585, 2, 40, 8, 0.3576, 0.5018),
    (1585, 2, 40, 40, 0.4308, 0.6908), (1585, 2, 40, 128, 0.5356, 0.8606),
    (1585, 2, 80, 1, 0.2669, 0.3387), (1585, 2, 80, 8, 0.3688, 0.4994),
    (1585, 2, 80, 40, 0.4677, 0.6932), (1585, 2, 80, 128, 0.5815, 0.8598),
    (1585, 2, 160, 1, 0.2769, 0.3500), (1585, 2, 160, 8, 0.3879, 0.5012),
    (1585, 2, 160, 40, 0.5154, 0.6917), (1585, 2, 160, 128, 0.6108, 0.8715),
    (199, 2, 32, 1, 0.2286, 0.2437), (199, 2, 32, 8, 0.2846, 0.3073),
    (199, 2, 32, 9, 0.2858, 0.3117), (199, 2, 32, 12, 0.2820, 0.3064),
    (199, 2, 32, 16, 0.2555, 0.2781), (199, 2, 32, 24, 0.2652, 0.2904),
    (199, 2, 32, 40, 0.2574, 0.2819), (199, 2, 32, 128, 0.2783, 0.3066),
    (199, 2, 48, 1, 0.2296, 0.2404), (199, 2, 48, 8, 0.2887, 0.3100),
    (199, 2, 48, 9, 0.2871, 0.3114), (199, 2, 48, 12, 0.2905, 0.3123),
    (199, 2, 48, 16, 0.2585, 0.2763), (199, 2, 48, 24, 0.2714, 0.2946),
    (199, 2, 48, 40, 0.2620, 0.2827), (199, 2, 48, 128, 0.2758, 0.2994),
    (199, 2, 64, 1, 0.2513, 0.2429), (199, 2, 64, 8, 0.2878, 0.3041),
    (199, 2, 64, 9, 0.3159, 0.3084), (199, 2, 64, 12, 0.3196, 0.3081),
    (199, 2, 64, 16, 0.2933, 0.2774), (199, 2, 64, 24, 0.3002, 0.2874),
    (199, 2, 64, 40, 0.2977, 0.2839), (199, 2, 64, 128, 0.3159, 0.2974),
    (199, 2, 80, 1, 0.2470, 0.2407), (199, 2, 80, 8, 0.2890, 0.3055),
    (199, 2, 80, 9, 0.3267, 0.3116), (199, 2, 80, 12, 0.3262, 0.3079),
    (199, 2, 80, 16, 0.3102, 0.2885), (199, 2, 80, 24, 0.3067, 0.2864),
    (199, 2, 80, 40, 0.3115, 0.2872), (199, 2, 80, 128, 0.3321, 0.3071),
    (397, 2, 64, 1, 0.2271, 0.2439), (397, 2, 64, 8, 0.2644, 0.2803),
    (397, 2, 64, 9, 0.2888, 0.2813), (397, 2, 64, 12, 0.2955, 0.2821),
    (397, 2, 64, 16, 0.2930, 0.2837), (397, 2, 64, 24, 0.2960, 0.3023),
    (397, 2, 64, 40, 0.3108, 0.3148), (397, 2, 64, 128, 0.3351, 0.3443),
    (397, 2, 80, 1, 0.2388, 0.2499), (397, 2, 80, 8, 0.2629, 0.2753),
    (397, 2, 80, 9, 0.3056, 0.2817), (397, 2, 80, 12, 0.3089, 0.2885),
    (397, 2, 80, 16, 0.3006, 0.2857), (397, 2, 80, 24, 0.3047, 0.3093),
    (397, 2, 80, 40, 0.3281, 0.3179), (397, 2, 80, 128, 0.3446, 0.3497),
    (397, 2, 160, 1, 0.2376, 0.2396), (397, 2, 160, 8, 0.2760, 0.2743),
    (397, 2, 160, 9, 0.3376, 0.2820), (397, 2, 160, 12, 0.3442, 0.2882),
    (397, 2, 160, 16, 0.3513, 0.2892), (397, 2, 160, 24, 0.3455, 0.3066),
    (397, 2, 160, 40, 0.3721, 0.3269), (397, 2, 160, 128, 0.3912, 0.3468),
    (15, 5, 14, 1, 0.2584, 0.2720), (15, 5, 14, 8, 0.2979, 0.3332),
    (15, 5, 14, 9, 0.2923, 0.3094), (15, 5, 14, 12, 0.2997, 0.3157),
    (15, 5, 14, 16, 0.2944, 0.3094), (15, 5, 14, 24, 0.2978, 0.3111),
    (15, 5, 14, 40, 0.3041, 0.3192), (15, 5, 14, 128, 0.3144, 0.3294),
    (12, 4, 11, 1, 0.3214, 0.3300), (12, 4, 11, 8, 0.3343, 0.3497),
    (12, 4, 11, 9, 0.3401, 0.3545), (12, 4, 11, 12, 0.3561, 0.3702),
    (12, 4, 11, 16, 0.3586, 0.3716), (12, 4, 11, 24, 0.3585, 0.3712),
    (12, 4, 11, 40, 0.3826, 0.3902), (12, 4, 11, 128, 0.3837, 0.4038),
    (13, 3, 12, 1, 0.2326, 0.2452), (13, 3, 12, 8, 0.2338, 0.2473),
    (13, 3, 12, 9, 0.2386, 0.2554), (13, 3, 12, 12, 0.2526, 0.2630),
    (13, 3, 12, 16, 0.2486, 0.2633), (13, 3, 12, 24, 0.2514, 0.2662),
    (13, 3, 12, 40, 0.2597, 0.2757), (13, 3, 12, 128, 0.2651, 0.2825),
    (33, 3, 20, 1, 0.2213, 0.2312), (33, 3, 20, 8, 0.2483, 0.2603),
    (33, 3, 20, 9, 0.2533, 0.2713), (33, 3, 20, 12, 0.2511, 0.2692),
    (33, 3, 20, 16, 0.2604, 0.2784), (33, 3, 20, 24, 0.2604, 0.2784),
    (33, 3, 20, 40, 0.2588, 0.2804), (33, 3, 20, 128, 0.2600, 0.2737),
]


def test_auto_band_follows_the_layout_sweep():
    """On the card "auto" picks, at every point of the sweep, the layout
    that was faster there or one within 5% of it."""
    for n, m, b, chains, band_ms, dense_ms in LAYOUT_SWEEP:
        pick = tsolve.resolve_band_impl(mt.MagiConfig(n_chains=chains), n, m, b,
                                        torch.device("cuda"))
        took = band_ms if pick == "band" else dense_ms
        assert took <= 1.05 * min(band_ms, dense_ms), (n, b, chains, pick)


@pytest.mark.parametrize("name", layout_sweep.PROBLEMS)
def test_layout_sweep_problem_points(name):
    """The sweep's points below n = 199 build solve_magi's raw target of a
    model family or of config 3 at the grid and band that chip_smoke.py
    holds K1's row tile to at one chain; its band and dense layouts give
    one value and gradient (float64, CPU)."""
    import chip_smoke as smoke
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import band_timing

    config, cov64, build, center = layout_sweep.problem_targets(name)
    shape = (cov64.phi.shape[0], cov64.bandsize, cov64.tvec.shape[0])
    assert shape in (*smoke.FAMILY_SHAPES, band_timing.SHAPES["pt"][1:])
    psi = torch.as_tensor(center + np.random.default_rng(0).normal(size=(3, center.size)) * 0.01)
    (v_band, g_band), (v_dense, g_dense) = (
        build(impl, torch.float64, "cpu").value_and_grad_fn()(psi) for impl in ("band", "dense"))
    np.testing.assert_allclose(v_band.numpy(), v_dense.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_band.numpy(), g_dense.numpy(), rtol=1e-9,
                               atol=1e-12 * float(g_dense.abs().max()))


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
