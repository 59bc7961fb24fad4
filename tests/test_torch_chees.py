"""PyTorch port, ChEES-HMC: halton, the adaptation update, the metric
refresh and the batched leapfrog equal the JAX package's (exact or rtol
1e-12); the draw-free transition core fed the JAX package's own momenta
and accept uniforms reproduces its transition (rtol 1e-10) under both
criteria; n_steps is read once per iteration; and the sampler mirrors the
JAX package's statistical tests (correlated Gaussian recovery, the SNAPER
principal component, iterate averaging). solve_magi with sampler="chees"
starts from the JAX package's setup and lands within 5 Monte Carlo
standard errors of its posterior means."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu import MagiConfig as JConfig
from manifold_constrained_gaussian_process_inference_tpu import solve_magi as j_solve
from manifold_constrained_gaussian_process_inference_tpu.inference import adapt as ja
from manifold_constrained_gaussian_process_inference_tpu.inference import chees as jch
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import adapt as ta
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import chees as tch
from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import ess

torch.set_num_threads(1)
DIM = 5
_A = np.random.default_rng(11).normal(size=(DIM, DIM))
COV = _A @ _A.T / DIM + 0.5 * np.eye(DIM)
PREC = np.linalg.inv(COV)
MU = np.arange(DIM, dtype=float) * 0.5


def _vg_t(q):
    g = -(q - torch.as_tensor(MU)) @ torch.as_tensor(PREC)
    return 0.5 * ((q - torch.as_tensor(MU)) * g).sum(-1), g


_vg_j = jax.vmap(jax.value_and_grad(lambda q: -0.5 * (q - MU) @ PREC @ (q - MU)))


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(want, dtype=float),
                               rtol=rtol, atol=rtol * 1e-3)


def test_halton_matches_jax():
    """Exact for i in 0..1000."""
    want = np.asarray(jax.jit(jax.vmap(jch.halton))(jnp.arange(1001, dtype=jnp.int32)))
    np.testing.assert_array_equal([tch.halton(i) for i in range(1001)], want)


def _adapt_pair(dim, rng):
    eps0 = 0.1
    a_t = tch.CheesAdaptState(
        da=ta.da_init(torch.tensor(eps0, dtype=torch.float64)),
        traj_length=torch.tensor(1.0, dtype=torch.float64),
        traj_adam_m=torch.tensor(0.0, dtype=torch.float64),
        traj_adam_v=torch.tensor(0.0, dtype=torch.float64),
        traj_count=torch.tensor(0.0, dtype=torch.float64),
        welford_count=torch.tensor(0.0, dtype=torch.float64),
        welford_mean=torch.zeros(dim, dtype=torch.float64),
        welford_m2=torch.zeros(dim, dtype=torch.float64),
        inv_mass=torch.ones(dim, dtype=torch.float64),
        pc=torch.full((dim,), 1.0 / np.sqrt(dim), dtype=torch.float64),
        log_t_ema=torch.tensor(0.0, dtype=torch.float64),
    )
    a_j = jch.CheesAdaptState(*(jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), f)
                                for f in a_t))
    a_j = a_j._replace(da=ja.DualAveragingState(*(jnp.asarray(x.numpy()) for x in a_t.da)))
    return a_t, a_j


def _adapt_equal(a_t, a_j, rtol):
    for name, g, w in zip(a_t._fields, a_t, a_j):
        if name == "da":
            for gg, ww in zip(g, w):
                _close(gg.numpy(), ww, rtol)
        else:
            _close(g.numpy(), w, rtol)


def test_chees_adapt_update_and_refresh_match_jax():
    """rtol 1e-12 over 60 updates with varied acceptance and gradients
    (non-finite ones included) and a metric refresh every 20."""
    rng = np.random.default_rng(0)
    c = 8
    a_t, a_j = _adapt_pair(DIM, rng)
    scales = np.linspace(0.5, 3.0, DIM)
    for it in range(60):
        qs = rng.normal(size=(c, DIM)) * scales
        acc = rng.uniform(0.2, 1.0, size=c)
        grad = rng.normal() * 3.0 if it % 13 else np.inf
        eps = 0.05 + 0.01 * (it % 7)
        info_t = {"accept_prob": torch.as_tensor(acc),
                  "chees_grad": torch.tensor(grad, dtype=torch.float64)}
        info_j = {"accept_prob": jnp.asarray(acc), "chees_grad": jnp.asarray(grad)}
        a_t = tch.chees_adapt_update(a_t, torch.as_tensor(qs), info_t, 0.8,
                                     torch.tensor(eps, dtype=torch.float64), t_ema_rate=0.05)
        a_j = jch.chees_adapt_update(a_j, jnp.asarray(qs), info_j, 0.8, jnp.asarray(eps),
                                     t_ema_rate=0.05)
        if it % 20 == 19:
            a_t, a_j = tch.chees_refresh_mass(a_t), jch.chees_refresh_mass(a_j)
        _adapt_equal(a_t, a_j, 1e-12)


def test_leapfrog_batch_matches_jax():
    rng = np.random.default_rng(1)
    c = 6
    qs, ps = rng.normal(size=(c, DIM)), rng.normal(size=(c, DIM))
    _, grads = _vg_t(torch.as_tensor(qs))
    inv_mass = rng.uniform(0.5, 2.0, size=DIM)
    got = tch._leapfrog_batch(_vg_t, torch.as_tensor(qs), torch.as_tensor(ps), grads,
                              torch.tensor(0.13, dtype=torch.float64), torch.as_tensor(inv_mass), 9)
    want = jch._leapfrog_batch(_vg_j, jnp.asarray(qs), jnp.asarray(ps), jnp.asarray(grads.numpy()),
                               jnp.asarray(0.13), jnp.asarray(inv_mass), 9)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)


@pytest.mark.parametrize("criterion", ["chees", "snaper"])
def test_chees_core_fed_jax_draws_matches_jax_transition(criterion):
    """The JAX package's momenta and accept uniforms, from the key splits of
    its chees.py:193-216, through the port's draw-free core: positions,
    log-densities, acceptance and the criterion gradient at rtol 1e-10."""
    rng = np.random.default_rng(2)
    c = 16
    qs = rng.normal(size=(c, DIM)) * 1.5 + MU
    logps, grads = _vg_j(jnp.asarray(qs))
    state = jch.CheesState(qs=jnp.asarray(qs), logps=logps, grads=grads,
                           keys=jax.random.split(jax.random.PRNGKey(4), c), iteration=jnp.int32(5))
    eps, traj = 0.55, 2.3
    inv_mass = rng.uniform(0.5, 2.0, size=DIM)
    pc = rng.normal(size=DIM)
    pc /= np.linalg.norm(pc)
    pc_j = jnp.asarray(pc) if criterion == "snaper" else None
    new_j, info_j = jch.chees_transition(_vg_j, state, jnp.asarray(eps), jnp.asarray(inv_mass),
                                         jnp.asarray(traj), pc=pc_j)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(state.keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (DIM,), jnp.float64))(ks[:, 1])
    accept_u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(ks[:, 2])
    f64 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float64)
    n_steps, u = tch.n_leapfrog_steps(f64(traj), f64(eps), tch.halton(5))
    assert n_steps == int(info_j["num_leapfrog"][0])
    qs_t, logps_t, _, info_t = tch.chees_core(
        _vg_t, f64(qs), f64(logps), f64(grads), f64(z), f64(accept_u), f64(eps), f64(inv_mass),
        n_steps, u, pc=f64(pc) if criterion == "snaper" else None)
    _close(qs_t.numpy(), new_j.qs, 1e-10)
    _close(logps_t.numpy(), new_j.logps, 1e-10)
    _close(info_t["accept_prob"].numpy(), info_j["accept_prob"], 1e-10)
    _close(info_t["chees_grad"].numpy(), info_j["chees_grad"], 1e-10)
    np.testing.assert_array_equal(info_t["diverging"].numpy(), np.asarray(info_j["diverging"]))
    assert 0 < int(info_t["accepted"].sum()) < c


def test_n_steps_read_once_per_iteration(monkeypatch):
    calls = []
    real = tch.n_leapfrog_steps
    monkeypatch.setattr(tch, "n_leapfrog_steps", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, info = tch.run_chees(_vg_t, torch.zeros((4, DIM), dtype=torch.float64),
                            torch.Generator().manual_seed(0), n_samples=30, n_adapts=15,
                            chunk_size=10)
    assert len(calls) == info["transitions"] == info["host_syncs"] == 30
    # every chain runs every iteration's steps; on the CPU the value-and-grad
    # runs once at the start and once per step
    assert info["lockstep_leaves"] > int(info["num_leapfrog"][0].sum())
    assert info["vg_evals"] == 1 + info["lockstep_leaves"]
    assert (info["num_leapfrog"] == info["num_leapfrog"][:1]).all()


def test_correlated_gaussian_recovery():
    d = 4
    rng = np.random.default_rng(1)
    a = rng.normal(size=(d, d))
    covm = a @ a.T + d * np.eye(d)
    prec = torch.as_tensor(np.linalg.inv(covm))
    mu = torch.arange(d, dtype=torch.float64)

    def vg(q):
        g = -(q - mu) @ prec
        return 0.5 * ((q - mu) * g).sum(-1), g

    samples, info = tch.run_chees(vg, torch.zeros((12, d), dtype=torch.float64),
                                  torch.Generator().manual_seed(0), n_samples=1600, n_adapts=800)
    s = samples.reshape(-1, d)
    sd = np.sqrt(np.diag(covm))
    assert np.all(np.abs(s.mean(0) - np.arange(d)) < 0.2 * sd)
    assert np.all(np.abs(s.var(0) / np.diag(covm) - 1.0) < 0.25)
    assert info["num_leapfrog"].mean() > 1.5
    assert 0.5 < info["accept_prob"].mean() <= 1.0
    ratio = info["inv_mass"] / np.diag(covm)
    assert np.all(ratio > 0.3) and np.all(ratio < 3.0)
    assert info["trajectory_warmup_trace"].shape == (800,)


def test_snaper_pc_estimate_is_principal_direction():
    dim, c = 8, 16
    rng = np.random.default_rng(2)
    scales = np.ones(dim)
    scales[3] = 10.0
    adapt, _ = _adapt_pair(dim, rng)
    info = {"accept_prob": torch.ones(c, dtype=torch.float64),
            "chees_grad": torch.tensor(0.0, dtype=torch.float64)}
    for _ in range(200):
        qs = torch.as_tensor(rng.normal(size=(c, dim)) * scales)
        adapt = tch.chees_adapt_update(adapt, qs, info, 0.75, torch.tensor(0.1, dtype=torch.float64))
    assert abs(abs(float(adapt.pc[3])) - 1.0) < 0.05


def test_traj_iterate_averaging_and_refresh_reset():
    """The sampling T is the EMA of the warmup iterates, and a metric
    refresh restarts the trajectory Adam state but keeps T and its EMA."""
    dim, c = 4, 8
    rng = np.random.default_rng(0)
    adapt, _ = _adapt_pair(dim, rng)
    rate, ema_ref = 0.25, 0.0
    for _ in range(30):
        info = {"accept_prob": torch.full((c,), 0.8, dtype=torch.float64),
                "chees_grad": torch.tensor(2.0, dtype=torch.float64)}
        adapt = tch.chees_adapt_update(adapt, torch.as_tensor(rng.normal(size=(c, dim))), info,
                                       0.75, torch.tensor(0.05, dtype=torch.float64),
                                       t_ema_rate=rate)
        ema_ref = ema_ref + rate * (float(torch.log(adapt.traj_length)) - ema_ref)
    assert float(adapt.traj_length) > 1.05
    np.testing.assert_allclose(float(adapt.log_t_ema), ema_ref, rtol=1e-12)
    assert float(torch.exp(adapt.log_t_ema)) < float(adapt.traj_length)
    refreshed = tch.chees_refresh_mass(adapt._replace(
        welford_count=torch.tensor(10.0, dtype=torch.float64),
        welford_m2=torch.full((dim,), 9.0, dtype=torch.float64)))
    assert float(refreshed.traj_adam_m) == float(refreshed.traj_adam_v) == 0.0
    assert float(refreshed.traj_count) == 0.0
    assert float(refreshed.traj_length) == float(adapt.traj_length)
    assert float(refreshed.log_t_ema) == float(adapt.log_t_ema)


def test_chees_refuses_the_chain_mesh_and_unknown_criterion():
    """An unknown trajectory criterion raises (the chain mesh takes
    checkpoints now: tests/test_torch_mesh_checkpoint.py)."""
    z = torch.zeros((2, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="criterion"):
        tch.run_chees(_vg_t, z, torch.Generator(), 4, 2, criterion="nuts")


# -- the chain mesh: ranks spawned over gloo on the CPU -----------------------

CHEES_DRYRUN = dict(n_samples=3, n_adapts=1, initial_step_size=0.01)
# warmup with a window end (the metric refresh) and the trajectory adapting
CHEES_SHORT = dict(n_samples=40, n_adapts=30, initial_step_size=0.1)
CHEES_GAUSS = dict(n_samples=300, n_adapts=150, initial_step_size=0.1)


def _chees_mesh_job(rank):
    """ChEES on a mesh of one rank and on all four, against the unsharded
    run; the unsharded references are spread over the ranks."""
    import torch.distributed as dist

    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        CHAIN_AXIS, Mesh, dryrun, make_chain_mesh,
    )

    world = dist.get_world_size()
    solo = [dist.new_group([r]) for r in range(world)][rank]
    one = Mesh(CHAIN_AXIS, device="cpu", group=solo)
    four = make_chain_mesh(world, device="cpu")
    target, psi0, _, _ = dryrun._fn_problem(11, 5.0, torch.float64, "cpu")
    vg = target.value_and_grad_fn()
    psi8 = torch.as_tensor(psi0).expand(8, -1).contiguous()
    z8 = torch.zeros((8, DIM), dtype=torch.float64)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    out = {}
    if rank < 2:
        criterion = ("snaper", "chees")[rank]
        out["one"] = tuple(tch.run_chees(vg, psi8, gen(8), criterion=criterion, mesh=m,
                                         **CHEES_SHORT) for m in (None, one))
    if rank == 2:
        out["dryrun_ref"] = tch.run_chees(vg, psi8, gen(3), **CHEES_DRYRUN)[0]
    if rank == 3:
        out["gauss_ref"] = tch.run_chees(_vg_t, z8, gen(9), **CHEES_GAUSS)[0]
    out["dryrun"] = tch.run_chees(vg, psi8, gen(3), mesh=four, **CHEES_DRYRUN)[0]
    out["gauss"] = tch.run_chees(_vg_t, z8, gen(9), mesh=four, **CHEES_GAUSS)
    return out


@pytest.fixture(scope="module")
def chees_ranks():
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import dryrun

    return dryrun.run_ranks(_chees_mesh_job, 4)


CHEES_INFO_KEYS = ("lp", "accept_prob", "num_leapfrog", "diverging", "step_size", "inv_mass",
                   "trajectory_length", "final_psi", "trajectory_warmup_trace")


@pytest.mark.parametrize("rank", [0, 1])
def test_chees_mesh_of_one_equals_unsharded(chees_ranks, rank):
    """Bit for bit under SNAPER (rank 0) and ChEES (rank 1)."""
    (s_ref, i_ref), (s, info) = chees_ranks[rank]["one"]
    np.testing.assert_array_equal(s, s_ref)
    for key in CHEES_INFO_KEYS:
        np.testing.assert_array_equal(info[key], i_ref[key], err_msg=key)


def test_chees_four_ranks_match_unsharded(chees_ranks):
    """Per chain at the dry run's protocol (<= 1e-10); on the Gaussian the
    same draws on every rank, and means and standard deviations within the
    JAX package's chain-sharding bars of the unsharded run's."""
    ref, got = chees_ranks[2]["dryrun_ref"], chees_ranks[0]["dryrun"]
    assert got.shape == ref.shape == (8, 2, 27)
    assert np.abs(got - ref).max() <= 1e-10
    s, info = chees_ranks[0]["gauss"]
    for other in chees_ranks[1:]:
        np.testing.assert_array_equal(other["dryrun"], got)
        np.testing.assert_array_equal(other["gauss"][0], s)
        for key in CHEES_INFO_KEYS:
            np.testing.assert_array_equal(other["gauss"][1][key], info[key], err_msg=key)
    a = chees_ranks[3]["gauss_ref"].reshape(-1, DIM)
    b = s.reshape(-1, DIM)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 0.15 * np.sqrt(np.diag(COV)))
    assert np.all(np.abs(a.std(0) - b.std(0)) < 0.2 * np.sqrt(np.diag(COV)))


def test_solve_magi_chees_matches_jax_setup_and_posterior(monkeypatch):
    """Both packages on one small FN problem (whitened, theta constrained,
    8 chains, SNAPER): the chains' start psi0 and the whitened target at it
    agree at rtol 1e-10, and the theta posterior means are within 5 Monte
    Carlo SE of each other."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2))
    opts = dict(niter_hmc=200, seed=2, sampler="chees", n_chains=8, x_whitened=True,
                theta_constrained=True, chain_init_jitter=0.05, sigma=[0.2, 0.2],
                phi=np.array([[1.0, 1.0], [1.5, 1.5]]), chunk_size=100)
    got, want = {}, {}
    for module, store in ((tch, got), (jch, want)):
        real = module.run_chees

        def spy(vg, psi0, *args, _real=real, _store=store, **kwargs):
            _store.update(vg=vg, psi0=psi0)
            return _real(vg, psi0, *args, **kwargs)

        monkeypatch.setattr(module, "run_chees", spy)
    res_t = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(device="cpu", **opts))
    res_j = j_solve(y, t, J_FN, JConfig(**opts))
    psi_t = got["psi0"].numpy()
    np.testing.assert_allclose(psi_t, np.asarray(want["psi0"]), rtol=1e-10, atol=1e-12)
    v_t, g_t = got["vg"](got["psi0"])
    v_j, g_j = jax.vmap(want["vg"])(want["psi0"])
    _close(v_t.numpy(), v_j, 1e-10)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10 * float(np.abs(g_j).max()))
    se2 = 0.0
    for res in (res_t, res_j):
        tpc = res.diagnostics["theta_per_chain"]
        assert tpc.shape == (8, 100, 3)
        assert "trajectory_length" in res.diagnostics
        se2 = se2 + res.theta.var(0) / np.array([ess(tpc[:, :, j]) for j in range(3)])
    gap = np.abs(res_t.theta.mean(0) - res_j.theta.mean(0))
    assert np.all(gap < 5.0 * np.sqrt(se2)), (gap, np.sqrt(se2))
