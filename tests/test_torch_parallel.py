"""PyTorch port, chain sharding over torch.distributed (the JAX package's
tests/test_parallel.py and its dry run): ranks are spawned over gloo on the
CPU, float64. A mesh of one rank equals the unsharded run bit for bit
(run_chains under both metrics, solve_magi with pooled NUTS and ChEES); on
four ranks two executions are bitwise equal, every rank returns the same
gathered result (solve_magi under every sampler too, which every rank
also runs on the same target and whitener), each chain equals the
unsharded run's at the dry run's protocol (<= 1e-10), means and standard
deviations on a Gaussian agree with the unsharded run as in the JAX
package's tests, and a chain count that is not a multiple of the mesh size
raises the JAX package's ValueError."""
import hashlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
    CHAIN_AXIS,
    Mesh,
    make_chain_mesh,
    run_chains,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import dryrun
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.chees import run_chees
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.tempering import (
    run_parallel_tempering,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
    make_centered_whitened_vg,
)

torch.set_num_threads(1)

N_RANKS = 4
DRYRUN = dict(n_samples=3, n_adapts=1, initial_step_size=0.01, max_depth=4)
# long enough for a window end of the pooled metric
SHORT = dict(n_samples=30, n_adapts=20, initial_step_size=0.05, max_depth=5)
GAUSS = dict(n_samples=400, n_adapts=200)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _gauss_vg(q):
    return -0.5 * (q * q).sum(-1), -q


def _fn_vg():
    """The JAX dry run's small FN target (n=11, dim 27) and its start."""
    target, psi0, _, _ = dryrun._fn_problem(11, 5.0, torch.float64, "cpu")
    return target.value_and_grad_fn(), torch.as_tensor(psi0)


def _fingerprint(samples, info) -> str:
    """A hash of the draws and every per-chain array of a run's info."""
    h = hashlib.sha256(np.ascontiguousarray(samples).tobytes())
    for name in ("lp", "accept_prob", "num_leapfrog", "tree_depth", "diverging", "step_size",
                 "inv_mass", "final_psi", "warmup_diverging"):
        h.update(np.ascontiguousarray(info[name]).tobytes())
    return h.hexdigest()


def _solve_problem():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2))
    return y, t


SOLVE_CASES = {
    "nuts-pooled": dict(n_chains=8, mass_matrix="dense-pooled", step_jitter=0.125),
    "nuts-diag": dict(n_chains=8),
    "pt-nuts": dict(sampler="pt-nuts", pt_temps=3, pt_replicas=4, mass_matrix="dense-pooled",
                    max_tree_depth=6),
    "chees": dict(sampler="chees", n_chains=8),
}
ONE_SOLVE_CASES = ("nuts-pooled", "chees")


def _solve_res(case, mesh):
    y, t = _solve_problem()
    config = mt.MagiConfig(niter_hmc=20, seed=3, sigma=[0.2, 0.2], phi=np.array([[1.0, 1.0],
                           [1.5, 1.5]]), x_whitened=True, theta_constrained=True,
                           chain_init_jitter=0.05, device="cpu", **SOLVE_CASES[case])
    return mt.solve_magi(y, t, mt.FN_SYSTEM, config, mesh=mesh)


def _draws(res):
    return np.concatenate([res.theta.ravel(), res.x_sampled.ravel(), res.sigma.ravel(),
                           res.lp.ravel()])


def _solve(case, mesh):
    return _draws(_solve_res(case, mesh))


def _sampled_on(res) -> str:
    """A hash of what this rank sampled, taken before any gather: its
    target's tensors, its whitener, and the value-and-grad they make at a
    point common to every rank."""
    target, whitener = res.diagnostics["target"], res.diagnostics["whitener"]
    z = torch.as_tensor(np.random.default_rng(1).normal(scale=0.1, size=(3, target.dimension)))
    parts = [*target.data, target.sigma_init, *whitener,
             *make_centered_whitened_vg(target, whitener)(z)]
    h = hashlib.sha256()
    for a in parts:
        if torch.is_tensor(a):
            h.update(np.ascontiguousarray(a.numpy()).tobytes())
    return h.hexdigest()


def _ranks_job(rank):
    """Everything the tests read, on one rank of a 4-rank gloo world. The
    runs that need no other rank (a mesh of one, the unsharded references)
    are spread over the ranks."""
    world = dist.get_world_size()
    solo = [dist.new_group([r]) for r in range(world)][rank]
    one = Mesh(CHAIN_AXIS, device="cpu", group=solo)
    four = make_chain_mesh(world, device="cpu")
    vg, psi0 = _fn_vg()
    psi8 = psi0.expand(8, -1).contiguous()
    out = {"mesh_names": (four.axis_names, four.size, four.rank, repr(one))}
    # a mesh of one rank against the unsharded run, bit for bit
    if rank < 2:
        metric = ("dense-pooled", "diag")[rank]
        kw = dict(SHORT, mass_matrix=metric)
        a = run_chains(vg, psi8[:4], _gen(5), **kw)
        b = run_chains(vg, psi8[:4], _gen(5), mesh=one, **kw)
        out[f"one_{metric}"] = (_fingerprint(*a), _fingerprint(*b))
    if rank == 2:
        for case in ONE_SOLVE_CASES:
            out[f"one_solve_{case}"] = (_solve(case, None), _solve(case, one))
    if rank == 3:
        for metric in ("dense-pooled", "diag"):
            z = torch.zeros((8, 3), dtype=torch.float64)
            out[f"gauss_ref_{metric}"] = run_chains(_gauss_vg, z, _gen(4), mass_matrix=metric,
                                                    **GAUSS)[0]
    # four ranks at the dry run's protocol, twice, against the unsharded run
    for metric in ("dense-pooled", "diag"):
        kw = dict(DRYRUN, mass_matrix=metric)
        first = run_chains(vg, psi8, _gen(7), mesh=four, **kw)
        again = run_chains(vg, psi8, _gen(7), mesh=four, **kw)
        out[f"four_{metric}"] = (_fingerprint(*first), _fingerprint(*again))
        if rank == 0:
            ref, _ = run_chains(vg, psi8, _gen(7), **kw)
            out[f"delta_{metric}"] = float(np.abs(first[0] - ref).max())
            out[f"shape_{metric}"] = first[0].shape
    # a 3-dim Gaussian, as the JAX package's statistical tests
    for metric in ("dense-pooled", "diag"):
        z = torch.zeros((8, 3), dtype=torch.float64)
        s, info = run_chains(_gauss_vg, z, _gen(4), mesh=four, mass_matrix=metric, **GAUSS)
        out[f"gauss_{metric}"] = (s, info["inv_mass"])
    # solve_magi sharded over four ranks, every sampler
    for case in SOLVE_CASES:
        res = _solve_res(case, four)
        out[f"four_solve_{case}"] = (hashlib.sha256(_draws(res).tobytes()).hexdigest(),
                                     _sampled_on(res))
    # chain counts that do not split over the mesh
    z6 = torch.zeros((6, 2), dtype=torch.float64)
    errors = []
    for call in (lambda: run_chains(_gauss_vg, z6, _gen(0), n_samples=4, n_adapts=2, mesh=four),
                 lambda: run_chees(_gauss_vg, z6, _gen(0), 4, 2, mesh=four),
                 lambda: run_parallel_tempering(_gauss_vg, z6[0], _gen(0), 4, 2, n_temps=2,
                                                n_replicas=6, mesh=four)):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def ranks():
    return dryrun.run_ranks(_ranks_job, N_RANKS)


@pytest.mark.parametrize("rank,metric", [(0, "dense-pooled"), (1, "diag")])
def test_mesh_of_one_equals_unsharded_run_chains(ranks, rank, metric):
    unsharded, sharded = ranks[rank][f"one_{metric}"]
    assert sharded == unsharded


@pytest.mark.parametrize("case", ONE_SOLVE_CASES)
def test_mesh_of_one_equals_unsharded_solve_magi(ranks, case):
    unsharded, sharded = ranks[2][f"one_solve_{case}"]
    assert np.isfinite(unsharded).all()
    np.testing.assert_array_equal(sharded, unsharded)


@pytest.mark.parametrize("metric", ["dense-pooled", "diag"])
def test_four_ranks_bitwise_deterministic_and_the_same_on_every_rank(ranks, metric):
    prints = [r[f"four_{metric}"] for r in ranks]
    assert all(first == again for first, again in prints)
    assert len({first for first, _ in prints}) == 1


@pytest.mark.parametrize("metric", ["dense-pooled", "diag"])
def test_four_ranks_match_unsharded_per_chain_at_the_dryrun_protocol(ranks, metric):
    assert ranks[0][f"shape_{metric}"] == (8, 2, 27)
    assert ranks[0][f"delta_{metric}"] <= 1e-10


@pytest.mark.parametrize("metric", ["dense-pooled", "diag"])
def test_four_ranks_statistically_equivalent_on_a_gaussian(ranks, metric):
    """The JAX package's bars: |mean diff| < 0.15, |std diff| < 0.2."""
    s, inv_mass = ranks[0][f"gauss_{metric}"]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[f"gauss_{metric}"][0], s)
    a = ranks[3][f"gauss_ref_{metric}"].reshape(-1, 3)
    b = s.reshape(-1, 3)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 0.15)
    assert np.all(np.abs(a.std(0) - b.std(0)) < 0.2)
    if metric == "dense-pooled":
        assert inv_mass.shape == (3, 3)
        np.testing.assert_allclose(inv_mass, inv_mass.T, atol=1e-12)
        assert np.all(np.linalg.eigvalsh(inv_mass) > 0)
    else:
        assert inv_mass.shape == (8, 3)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_magi_sharded_over_four_ranks_the_same_on_every_rank(ranks, case):
    assert len({r[f"four_solve_{case}"] for r in ranks}) == 1


def test_counts_not_a_multiple_of_the_mesh_size_raise(ranks):
    for r in ranks:
        assert r["errors"] == ["n_chains=6 must be a multiple of mesh size 4",
                               "n_chains=6 must be a multiple of mesh size 4",
                               "n_replicas=6 must be a multiple of mesh size 4"]


def test_mesh_names_its_axis_rank_and_size(ranks):
    for rank, r in enumerate(ranks):
        names, size, mesh_rank, solo = r["mesh_names"]
        assert names == (CHAIN_AXIS,) and size == N_RANKS and mesh_rank == rank
        assert solo == "Mesh('chains', rank 0 of 1, gloo, cpu)"


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh(CHAIN_AXIS, device="cpu")


def test_dryrun_multichip_passes(capsys):
    deltas = dryrun.dryrun_multichip(N_RANKS, device="cpu")
    assert "dryrun_multichip OK" in capsys.readouterr().out
    for what in ("chains", "grid_value", "pt", "chees"):
        assert deltas[what] <= 1e-10
    assert deltas["grid_grad"] <= 1e-10
