"""PyTorch port, parallel tempering: the ladders, the ladder adaptation and
the per-rung pooled metric equal the JAX package's; the swap sweep equals a
numpy transcription of the JAX package's sweep; one PT transition of R*K
chains is one batched NUTS call; the tempered value-and-grad reads the live
ladder; and the sampler mirrors the JAX package's statistical tests (exact
on a Gaussian, crosses modes where NUTS cannot, the ladder adapts, replica
shapes, the pooled dense metric on a correlated Gaussian). solve_magi with
sampler="pt-nuts" starts from the JAX package's setup and lands within
5 Monte Carlo standard errors of its posterior means."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu import MagiConfig as JConfig
from manifold_constrained_gaussian_process_inference_tpu import solve_magi as j_solve
from manifold_constrained_gaussian_process_inference_tpu.inference import nuts as jn
from manifold_constrained_gaussian_process_inference_tpu.inference import tempering as jt
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
from manifold_constrained_gaussian_process_inference_tpu.parallel import chains as jc
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import nuts as tn
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import tempering as tt
from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import ess

torch.set_num_threads(1)


def _gauss_vg(q):
    return -0.5 * (q * q).sum(-1), -q


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("k,t_max", [(1, 8.0), (2, 4.0), (5, 16.0), (10, 64.0)])
def test_ladders_match_jax(k, t_max):
    """Exact: geometric and auto ladders."""
    np.testing.assert_array_equal(tt.geometric_ladder(k, t_max), jt.geometric_ladder(k, t_max))
    for dim in (1, 105, 799):
        np.testing.assert_array_equal(tt.auto_ladder(k, dim), jt.auto_ladder(k, dim))


def test_adapt_ladder_matches_jax():
    """Exact on random swap counts, including pairs under min_tries."""
    rng = np.random.default_rng(0)
    for trial in range(50):
        k = int(rng.integers(1, 11))
        inv_temps = 1.0 / tt.auto_ladder(k, int(rng.integers(2, 200)))
        n_try = rng.integers(0 if trial % 5 == 0 else 10, 200, size=k)
        n_acc = (n_try * rng.uniform(size=k)).astype(int)
        np.testing.assert_array_equal(tt.adapt_ladder(inv_temps, n_acc, n_try),
                                      jt.adapt_ladder(inv_temps, n_acc, n_try))


def _numpy_swap_sweep(qs, lp, grads, div, inv_temps, u, iteration):
    """A numpy transcription of the JAX package's tempering.py:176-203 for
    one replica (plus the counters of :201-203)."""
    k_temps = len(inv_temps)
    start = iteration % 2                                        # :177
    idx = np.arange(k_temps)                                     # :178
    is_left = (idx % 2) == (start % 2)                           # :179
    partner = np.where(is_left, idx + 1, idx - 1)                # :180
    valid = (partner >= 0) & (partner < k_temps)                 # :181
    partner = np.clip(partner, 0, k_temps - 1)                   # :182
    lp_partner = lp[partner]                                     # :184
    delta = (inv_temps - inv_temps[partner]) * (lp_partner - lp)  # :185
    u_pair = np.where(is_left, u, u[partner])                    # :187
    do_swap = valid & (np.log(u_pair) < delta)                   # :188
    qs = np.where(do_swap[:, None], qs[partner], qs)             # :190
    grads = np.where(do_swap[:, None], grads[partner], grads)    # :191
    lp = np.where(do_swap, lp_partner, lp)                       # :192
    div = np.where(do_swap, div[partner], div)                   # :198
    return qs, lp, grads, div, valid & is_left, do_swap & is_left  # :202-203


@pytest.mark.parametrize("k_temps", [1, 2, 5, 6])
def test_swap_sweep_matches_numpy_transcription(k_temps):
    """Exact, both parities, several replicas; lp gaps of either sign so
    that some swaps are accepted and some refused."""
    rng = np.random.default_rng(k_temps)
    n_rep, dim = 3, 4
    for iteration in (0, 1, 2, 7):
        qs = rng.normal(size=(n_rep, k_temps, dim))
        grads = rng.normal(size=(n_rep, k_temps, dim))
        lp = rng.normal(size=(n_rep, k_temps)) * 3.0
        div = rng.uniform(size=(n_rep, k_temps)) < 0.3
        u = rng.uniform(size=(n_rep, k_temps))
        inv_temps = 1.0 / tt.geometric_ladder(k_temps, 8.0)
        got = tt.swap_sweep(*(torch.as_tensor(a) for a in (qs, lp, grads, div, inv_temps, u)),
                            iteration)
        for r in range(n_rep):
            want = _numpy_swap_sweep(qs[r], lp[r], grads[r], div[r], inv_temps, u[r], iteration)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[r].numpy(), w)


def test_rung_dense_metric_applies_each_rungs_factor():
    """rtol 1e-12: chain c gets rung (c mod K)'s factor."""
    rng = np.random.default_rng(1)
    n_rep, k, dim = 3, 4, 5
    mats = [rng.normal(size=(k, dim, dim)) for _ in range(3)]
    metric = tn.RungDenseMetric(*(torch.as_tensor(m) for m in mats))
    x = rng.normal(size=(n_rep * k, dim))
    for got, m in ((metric.momentum(torch.as_tensor(x)), mats[2]),
                   (metric.velocity(torch.as_tensor(x)), mats[0])):
        want = np.stack([m[c % k] @ x[c] for c in range(n_rep * k)])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_pooled_rung_metrics_match_jax():
    """rtol 1e-12: per-rung pooled metrics against JAX
    pooled_dense_metric_from_samples per rung (tempering.py:454-497), with
    one rung over half divergent (keeps its previous metric) and one with
    under 5 draws."""
    rng = np.random.default_rng(2)
    lw, n_rep, k, dim = 40, 3, 4, 6
    buf = rng.normal(size=(lw, n_rep, k, dim)) * np.linspace(0.5, 2.0, dim)
    dbuf = rng.uniform(size=(lw, n_rep, k)) < 0.05
    dbuf[:, :, 2] = rng.uniform(size=(lw, n_rep)) < 0.8
    dbuf[2:, :, 3] = True
    a = rng.normal(size=(k, dim, dim))
    prev_minv = a @ np.swapaxes(a, 1, 2) / dim + np.eye(dim)
    prev_t = tn.RungDenseMetric(*(torch.as_tensor(prev_minv) for _ in range(3)))
    got = tt.pooled_rung_metrics(buf, dbuf, prev_t, torch.float64)
    for k_i in range(k):
        prev_chol64 = np.linalg.cholesky(prev_minv[k_i])
        prev_k = jn.DenseMetric(minv=jnp.asarray(prev_minv[k_i]), chol_minv=jnp.asarray(prev_chol64),
                                p_chol=jnp.asarray(np.linalg.inv(prev_chol64).T))
        d_k = dbuf[:, :, k_i]
        if d_k.mean() > 0.5:
            want = prev_k
        else:
            want = jc.pooled_dense_metric_from_samples(buf[:, :, k_i, :][~d_k], dim, jnp.float64,
                                                       prev_k)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[k_i].numpy(), np.asarray(w), rtol=1e-12, atol=1e-15)


def test_one_batched_transition_per_pt_iteration(monkeypatch):
    """One PT iteration of R*K chains is one nuts_transition_batched call
    over all of them, with per-chain step sizes."""
    calls = []
    real = tt.nuts_transition_batched

    def spy(vg_b, q, *args, **kwargs):
        calls.append((q.shape, args[2].shape))
        return real(vg_b, q, *args, **kwargs)

    monkeypatch.setattr(tt, "nuts_transition_batched", spy)
    for mm in ("diag", "dense-pooled"):
        calls.clear()
        _, info = tt.run_parallel_tempering(_gauss_vg, torch.zeros(3, dtype=torch.float64),
                                            _gen(0), n_samples=40, n_adapts=20, n_temps=4,
                                            n_replicas=2, mass_matrix=mm)
        assert len(calls) == info["transitions"] == 40
        assert all(shape == (8, 3) and eps == (8,) for shape, eps in calls)


def test_tempered_value_and_grad_reads_the_live_ladder(monkeypatch):
    """The inverse temperatures are read from the buffer at every call, so
    an in-place ladder update (as on a CUDA graph) is seen: after a run
    whose ladder adapted, the run's tempered value-and-grad gives the raw
    value times the final ladder, not the start ladder."""
    beta = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64)
    vg_t = tt.TemperedValueAndGrad(_gauss_vg, beta)
    q = torch.ones((3, 2), dtype=torch.float64)
    beta.copy_(torch.tensor([1.0, 0.2, 0.1], dtype=torch.float64))
    v, g = vg_t(q)
    np.testing.assert_array_equal(v.numpy(), [-1.0, -0.2, -0.1])
    np.testing.assert_array_equal(g.numpy(), -np.array([[1.0, 1.0], [0.2, 0.2], [0.1, 0.1]]))
    built = []
    real = tt._tempered_vg

    def keep(vg, beta, example):
        out = real(vg, beta, example)
        built.append(out[0])
        return out

    monkeypatch.setattr(tt, "_tempered_vg", keep)
    _, info = tt.run_parallel_tempering(_gauss_vg, torch.zeros(2, dtype=torch.float64), _gen(1),
                                        n_samples=300, n_adapts=200, n_temps=4, max_temp=64.0)
    assert not np.allclose(info["temperatures"], tt.geometric_ladder(4, 64.0))
    (run_vg_t,) = built
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 2)))
    want = _gauss_vg(q)[0].numpy() / info["temperatures"]
    np.testing.assert_allclose(run_vg_t(q)[0].numpy(), want, rtol=1e-15)


def test_pt_exact_on_gaussian():
    """With any ladder the T = 1 chain samples the exact target."""
    s, info = tt.run_parallel_tempering(_gauss_vg, torch.zeros(3, dtype=torch.float64), _gen(1),
                                        n_samples=2000, n_adapts=700, n_temps=4, max_temp=8.0)
    assert s.shape == (1300, 3)
    assert abs(s.mean()) < 0.12
    assert np.all(np.abs(s.var(0) - 1.0) < 0.25)
    for key in ("accept_prob", "tree_depth", "num_leapfrog"):
        assert info[key].shape == (1300, 4)
    assert 0.5 < info["accept_prob"].mean() < 1.0 - 1e-6


def _bimodal_vg(sep):
    mu = torch.tensor([sep / 2.0, 0.0], dtype=torch.float64)

    def vg(q):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            a = -0.5 * ((q - mu) ** 2).sum(-1)
            b = -0.5 * ((q + mu) ** 2).sum(-1)
            lp = torch.logaddexp(a, b) - np.log(2.0)
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    return vg


def test_pt_crosses_modes_where_nuts_cannot():
    vg = _bimodal_vg(10.0)
    q0 = torch.tensor([5.0, 0.0], dtype=torch.float64)
    s_nuts, _ = tn.run_nuts(lambda q: tuple(a[0] for a in vg(q[None])), q0, _gen(0), 600, 200,
                            max_depth=6)
    assert np.mean(s_nuts[:, 0] < 0) < 0.05
    s_pt, info = tt.run_parallel_tempering(vg, q0, _gen(0), n_samples=1300, n_adapts=500,
                                           n_temps=6, max_temp=64.0, chunk_size=1500, max_depth=6)
    frac_left = float(np.mean(s_pt[:, 0] < 0))
    assert 0.15 < frac_left < 0.85
    assert info["swap_acceptance"] > 0.1
    assert abs(s_pt[s_pt[:, 0] < 0, 0].mean() + 5.0) < 0.5
    assert abs(s_pt[s_pt[:, 0] > 0, 0].mean() - 5.0) < 0.5


def test_pt_ladder_adaptation_on_a_heavy_tailed_target():
    """Warmup ladder adaptation moves the temperatures off the geometric
    start and does not lower the worst pair's swap acceptance."""
    def vg(q):
        return -2.0 * torch.log1p(0.5 * q * q).sum(-1), -2.0 * q / (1.0 + 0.5 * q * q)

    # depth 5 bounds the hot rungs' trees on the heavy tails (the ladder
    # adaptation does not depend on it)
    common = dict(n_samples=700, n_adapts=500, n_temps=6, max_temp=64.0, chunk_size=400,
                  max_depth=4)
    q0 = torch.zeros(10, dtype=torch.float64)
    _, info_ad = tt.run_parallel_tempering(vg, q0, _gen(3), ladder_adapt=True, **common)
    _, info_fr = tt.run_parallel_tempering(vg, q0, _gen(3), ladder_adapt=False, **common)
    assert info_ad["swap_acceptance_per_pair"].min() >= info_fr["swap_acceptance_per_pair"].min() - 0.02
    assert not np.allclose(info_ad["temperatures"], info_fr["temperatures"], rtol=1e-6)
    np.testing.assert_allclose(info_fr["temperatures"], tt.geometric_ladder(6, 64.0))
    assert np.all(np.isfinite(info_ad["temperatures"]))


def test_pt_replicas_shapes_and_exactness():
    s, info = tt.run_parallel_tempering(_gauss_vg, torch.zeros(3, dtype=torch.float64), _gen(7),
                                        n_samples=1500, n_adapts=600, n_temps=4, max_temp=8.0,
                                        n_replicas=3)
    assert s.shape == (3, 900, 3)
    assert not np.allclose(s[0], s[1])
    for r in range(3):
        assert abs(s[r].mean()) < 0.2
        assert np.all(np.abs(s[r].var(0) - 1.0) < 0.35)
    assert info["lp"].shape == (900, 3)
    assert info["diverging"].shape == (900, 3, 4)
    assert info["final_psi"].shape == (3, 4, 3)
    assert info["step_size"].shape == (3, 4)
    assert 0.0 <= info["swap_acceptance"] <= 1.0


def test_pt_pooled_dense_metric_on_correlated_gaussian():
    dim, rho = 8, 0.95
    cov = np.full((dim, dim), rho) + (1 - rho) * np.eye(dim)
    prec = torch.as_tensor(np.linalg.inv(cov))

    def vg(q):
        g = -q @ prec
        return 0.5 * (q * g).sum(-1), g

    s, info = tt.run_parallel_tempering(vg, torch.zeros(dim, dtype=torch.float64), _gen(3),
                                        n_samples=1200, n_adapts=600, n_temps=4, max_temp=8.0,
                                        n_replicas=2, mass_matrix="dense-pooled")
    assert info["metric"] == "dense-pooled" and info["inv_mass"].shape == (4, dim, dim)
    flat = s.reshape(-1, dim)
    assert np.all(np.abs(flat.mean(0)) < 0.3)
    assert abs(np.cov(flat.T)[0, 1] - rho) < 0.2
    assert info["inv_mass"][0][0, 1] > 0.3


# -- the replica mesh: ranks spawned over gloo on the CPU ---------------------

PT_DRYRUN = dict(n_samples=3, n_adapts=1, n_temps=3, max_temp=4.0, initial_step_size=0.01,
                 max_depth=4, n_replicas=4, ladder_adapt=False, mass_matrix="dense-pooled")
# warmup with a window end (the pooled rung metric) and ladder updates
PT_SHORT = dict(n_samples=50, n_adapts=40, n_temps=3, max_temp=4.0, initial_step_size=0.05,
                max_depth=5, n_replicas=4, chunk_size=20)


def _pt_mesh_job(rank):
    """PT on a mesh of one rank and on all four, against the unsharded run;
    the unsharded references are spread over the ranks."""
    import torch.distributed as dist

    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import dryrun

    world = dist.get_world_size()
    solo = [dist.new_group([r]) for r in range(world)][rank]
    one = tt.Mesh(tt.REPLICA_AXIS, device="cpu", group=solo)
    four = tt.make_replica_mesh(world, device="cpu")
    target, psi0, _, _ = dryrun._fn_problem(11, 5.0, torch.float64, "cpu")
    vg, psi0 = target.value_and_grad_fn(), torch.as_tensor(psi0)
    out = {}
    if rank < 2:
        metric = ("dense-pooled", "diag")[rank]
        kw = dict(PT_SHORT, mass_matrix=metric)
        out["one"] = tuple(tt.run_parallel_tempering(vg, psi0, _gen(6), mesh=m, **kw)
                           for m in (None, one))
    if rank == 2:
        out["dryrun_ref"] = tt.run_parallel_tempering(vg, psi0, _gen(2), **PT_DRYRUN)[0]
    pooled = dict(PT_SHORT, mass_matrix="dense-pooled")
    if rank == 3:
        out["short_ref"] = tt.run_parallel_tempering(vg, psi0, _gen(6), **pooled)
    out["dryrun"] = tt.run_parallel_tempering(vg, psi0, _gen(2), mesh=four, **PT_DRYRUN)[0]
    out["short"] = tt.run_parallel_tempering(vg, psi0, _gen(6), mesh=four, **pooled)
    return out


@pytest.fixture(scope="module")
def pt_ranks():
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import dryrun

    return dryrun.run_ranks(_pt_mesh_job, 4)


PT_INFO_KEYS = ("lp", "diverging", "accept_prob", "tree_depth", "num_leapfrog", "step_size",
                "inv_mass", "final_psi", "temperatures", "swap_acceptance_per_pair")


@pytest.mark.parametrize("rank", [0, 1])
def test_pt_mesh_of_one_equals_unsharded(pt_ranks, rank):
    """Bit for bit, pooled (rank 0) and diag (rank 1): draws, ladder, metric."""
    (s_ref, i_ref), (s, info) = pt_ranks[rank]["one"]
    np.testing.assert_array_equal(s, s_ref)
    for key in PT_INFO_KEYS:
        np.testing.assert_array_equal(info[key], i_ref[key], err_msg=key)


def test_pt_four_ranks_match_unsharded_per_replica(pt_ranks):
    """The dry run's protocol (<= 1e-10 per replica), and the same gathered
    result on every rank; over 50 iterations with the ladder and the pooled
    rung metric adapting, the ladder equals the unsharded run's and the
    draws stay finite."""
    ref = pt_ranks[2]["dryrun_ref"]
    got = pt_ranks[0]["dryrun"]
    assert got.shape == ref.shape == (4, 2, 27)
    assert np.abs(got - ref).max() <= 1e-10
    s_ref, i_ref = pt_ranks[3]["short_ref"]
    s, info = pt_ranks[0]["short"]
    assert s.shape == s_ref.shape == (4, 10, 27) and np.isfinite(s).all()
    np.testing.assert_array_equal(info["temperatures"], i_ref["temperatures"])
    assert not np.allclose(info["temperatures"], tt.geometric_ladder(3, 4.0))
    assert info["inv_mass"].shape == (3, 27, 27)
    for other in pt_ranks[1:]:
        np.testing.assert_array_equal(other["dryrun"], got)
        np.testing.assert_array_equal(other["short"][0], s)
        for key in PT_INFO_KEYS:
            np.testing.assert_array_equal(other["short"][1][key], info[key], err_msg=key)


def _fn_problem():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    return np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2)), t


def _capture(module, monkeypatch, store):
    real = module.run_parallel_tempering

    def spy(vg, psi0, *args, **kwargs):
        store.update(vg=vg, psi0=psi0, n_temps=kwargs["n_temps"])
        return real(vg, psi0, *args, **kwargs)

    monkeypatch.setattr(module, "run_parallel_tempering", spy)


def test_solve_magi_pt_matches_jax_setup_and_posterior(monkeypatch):
    """Both packages on one small FN problem (whitened, theta constrained,
    pooled dense PT, 2 replicas of 3 rungs): the start psi0, the whitened
    target at the start and at random zetas (its centre and factor) agree
    at rtol 1e-10 and the start ladders exactly; the theta posterior means
    are within 5 Monte Carlo SE of each other."""
    y, t = _fn_problem()
    opts = dict(niter_hmc=200, seed=2, sampler="pt-nuts", pt_temps=3, pt_replicas=2,
                mass_matrix="dense-pooled", x_whitened=True, theta_constrained=True,
                sigma=[0.2, 0.2], phi=np.array([[1.0, 1.0], [1.5, 1.5]]), chunk_size=100)
    got, want = {}, {}
    _capture(tt, monkeypatch, got)
    _capture(jt, monkeypatch, want)
    res_t = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(device="cpu", **opts))
    res_j = j_solve(y, t, J_FN, JConfig(**opts))
    psi_t, psi_j = got["psi0"].numpy(), np.asarray(want["psi0"])
    np.testing.assert_allclose(psi_t, psi_j, rtol=1e-10, atol=1e-12)
    dim = psi_t.shape[-1]
    zetas = np.concatenate([psi_t[None], np.random.default_rng(3).normal(size=(2, dim)) * 0.3])
    v_t, g_t = got["vg"](torch.as_tensor(zetas))
    for z, v, g in zip(zetas, v_t.numpy(), g_t.numpy()):
        v_j, g_j = want["vg"](jnp.asarray(z))
        np.testing.assert_allclose(v, float(v_j), rtol=1e-10)
        np.testing.assert_allclose(g, np.asarray(g_j), rtol=1e-10, atol=1e-10 * np.abs(g).max())
    np.testing.assert_array_equal(tt.auto_ladder(got["n_temps"], dim),
                                  jt.auto_ladder(want["n_temps"], dim))
    for res in (res_t, res_j):
        d = res.diagnostics
        assert d["theta_per_chain"].shape == (2, 100, 3)
        assert d["accept_prob_per_rung"].shape == (100, 2, 3)
        assert set(d) >= {"swap_acceptance", "swap_acceptance_per_pair", "temperatures"}
    se2 = 0.0
    for res in (res_t, res_j):
        tpc = res.diagnostics["theta_per_chain"]
        ess_j = np.array([ess(tpc[:, :, j]) for j in range(3)])
        se2 = se2 + res.theta.var(0) / ess_j
    gap = np.abs(res_t.theta.mean(0) - res_j.theta.mean(0))
    assert np.all(gap < 5.0 * np.sqrt(se2)), (gap, np.sqrt(se2))
