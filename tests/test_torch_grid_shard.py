"""PyTorch port, time-grid sharding (parallel/grid.py) against the JAX
package's tests/test_grid_shard.py: the per-rank blocks equal the JAX
package's ``make_grid_sharded_data`` exactly; the grid-sharded
value-and-grad on 4 gloo ranks (CPU, float64) equals the JAX package's
``make_grid_value_and_grad`` on a 4-device mesh of the conftest's CPU
devices and the port's own banded target to rtol 1e-10, on every rank
alike, in the JAX tests' five cases (sigma sampled and fixed, a grid that
does not split evenly, a band wider than a block, the theta transform); and
NUTS runs on it, the same on every rank."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_transform,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
from manifold_constrained_gaussian_process_inference_tpu.ops.gp_cov import build_gp_cov
from manifold_constrained_gaussian_process_inference_tpu.parallel import grid as jg
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import run_nuts
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import dryrun
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import grid as tg

torch.set_num_threads(1)

N_RANKS = 4
TEMPS = np.array([1.0, 1.0, 2.0])
SIGMA = np.array([0.2, 0.2])
# the JAX tests' cases; the halo case's grid is cut so that its band is
# wider than a block on 4 ranks, as the JAX test's is on 8 devices
CASES = {
    "sigma_sampled": dict(n=64, bandsize=8, sigma_sampled=True),
    "sigma_fixed": dict(n=64, bandsize=8, sigma_sampled=False),
    "padding": dict(n=61, bandsize=8, sigma_sampled=True),
    "halo_spans_shards": dict(n=32, bandsize=10, sigma_sampled=True),
    "theta_transform": dict(n=64, bandsize=8, sigma_sampled=True, transform=True),
}


def _problem(n, bandsize, seed=0):
    """The JAX test's data (NaN observations included) and its GP setup."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 20.0, n)
    y = np.stack([2.0 * np.sin(0.8 * t), 1.0 + 0.5 * np.cos(0.8 * t)], axis=-1)
    y = y + 0.2 * rng.normal(size=(n, 2))
    y[1::3, 0] = np.nan
    y[::4, 1] = np.nan
    cov = build_gp_cov("matern52", np.array([[2.0, 2.0], [1.5, 1.5]]), t, bandsize=bandsize,
                       complexity=2, jitter=1e-6)
    return y, cov


def _psi(y, sigma_sampled, seed=1):
    rng = np.random.default_rng(seed)
    x0 = np.where(np.isfinite(y), y, 0.0) + 0.05 * rng.normal(size=y.shape)
    parts = [x0.T.reshape(-1), np.array([0.25, 0.2, 2.8])]
    if sigma_sampled:
        parts.append(np.log([0.2, 0.25]))
    return np.concatenate(parts)


def _inputs(case):
    """(y, JAX cov, psi (3, dim): three nearby states)."""
    y, cov = _problem(CASES[case]["n"], CASES[case]["bandsize"])
    base = _psi(y, CASES[case]["sigma_sampled"])
    offsets = np.random.default_rng(2).normal(size=(3, base.size)) * 0.01
    return y, cov, base + offsets * np.arange(3)[:, None]


def _jax_grid_vg(case):
    y, cov, psis = _inputs(case)
    tr = j_transform(J_FN.theta_lower_bound, J_FN.theta_upper_bound) \
        if CASES[case].get("transform") else None
    data = jg.make_grid_sharded_data(y, cov, TEMPS, N_RANKS)
    vg = jax.jit(jg.make_grid_value_and_grad(
        data, J_FN, SIGMA, sigma_is_fixed=not CASES[case]["sigma_sampled"],
        mesh=jg.make_grid_mesh(N_RANKS), theta_transform=tr))
    out = [vg(jnp.asarray(p)) for p in psis]
    return np.array([float(v) for v, _ in out]), np.stack([np.asarray(g) for _, g in out])


def _grid_job(rank, inputs):
    """The port's grid value-and-grad of every case on this rank, its
    launches on the CPU (none: the plain versions run), and a short NUTS
    run on the first case."""
    mesh = tg.make_grid_mesh(N_RANKS, device="cpu")
    out = {}
    for case, (y, cov_t, psis) in inputs.items():
        tr = (make_theta_transform(mt.FN_SYSTEM.theta_lower_bound,
                                   mt.FN_SYSTEM.theta_upper_bound)
              if CASES[case].get("transform") else None)
        data = tg.make_grid_sharded_data(y, cov_t, TEMPS, N_RANKS)
        vg = tg.make_grid_value_and_grad(data, mt.FN_SYSTEM, SIGMA,
                                         sigma_is_fixed=not CASES[case]["sigma_sampled"],
                                         mesh=mesh, theta_transform=tr)
        v, g = vg(torch.as_tensor(psis))
        v0, g0 = vg(torch.as_tensor(psis[0]))  # no chain axis
        out[case] = (v.numpy(), g.numpy(), v0.numpy(), g0.numpy(), data.nloc, data.bandwidth)
        if case == "sigma_sampled":
            gen = torch.Generator().manual_seed(0)
            samples, info = run_nuts(vg, torch.as_tensor(psis[0]), gen, n_samples=8, n_adapts=4,
                                     initial_step_size=1e-3, max_depth=4)
            out["nuts"] = (samples, info["step_size"])
    return out


@pytest.fixture(scope="module")
def grid_ranks():
    inputs = {case: (y, GPCov.from_numpy(cov), psis)
              for case, (y, cov, psis) in ((c, _inputs(c)) for c in CASES)}
    return dryrun.run_ranks(_grid_job, N_RANKS, args=(inputs,))


@pytest.mark.parametrize("case", ["sigma_sampled", "padding", "halo_spans_shards"])
def test_grid_blocks_equal_jax_blocks(case):
    y, cov, _ = _inputs(case)
    want = jg.make_grid_sharded_data(y, cov, TEMPS, N_RANKS)
    got = tg.make_grid_sharded_data(y, GPCov.from_numpy(cov), TEMPS, N_RANKS)
    assert (got.n, got.nloc, got.bandwidth, got.n_dev) == (want.n, want.nloc, want.bandwidth,
                                                           want.n_dev)
    for name in tg.GridBlocks._fields:
        np.testing.assert_array_equal(getattr(got.blocks, name),
                                      np.asarray(getattr(want.blocks, name)), err_msg=name)
    np.testing.assert_array_equal(got.nobs, np.asarray(want.nobs))
    np.testing.assert_array_equal(got.beta, np.asarray(want.beta))
    assert got.dtype == torch.float64


@pytest.mark.parametrize("case", list(CASES))
def test_grid_value_and_grad_matches_jax_on_four_ranks(grid_ranks, case):
    v_j, g_j = _jax_grid_vg(case)
    v, g, v0, g0, nloc, b = grid_ranks[0][case]
    if case == "halo_spans_shards":
        assert b > nloc
    np.testing.assert_allclose(v, v_j, rtol=1e-10)
    np.testing.assert_allclose(g, g_j, rtol=1e-10, atol=1e-10)
    # one state without a chain axis: the batched value to rounding
    np.testing.assert_allclose(v0, v[0], rtol=1e-12)
    np.testing.assert_allclose(g0, g[0], rtol=1e-12, atol=1e-12 * np.abs(g_j).max())
    for other in grid_ranks[1:]:
        for a, b_ in zip(other[case][:4], (v, g, v0, g0)):
            np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("case", ["sigma_sampled", "theta_transform"])
def test_grid_value_and_grad_matches_the_ports_banded_target(grid_ranks, case):
    y, cov, psis = _inputs(case)
    tr = (make_theta_transform(mt.FN_SYSTEM.theta_lower_bound, mt.FN_SYSTEM.theta_upper_bound)
          if CASES[case].get("transform") else None)
    target = mt.MagiTarget.build(y, GPCov.from_numpy(cov), mt.FN_SYSTEM, SIGMA, TEMPS,
                                 not CASES[case]["sigma_sampled"], band_impl="band",
                                 theta_transform=tr)
    v_ref, g_ref = (a.numpy() for a in target.value_and_grad_fn()(torch.as_tensor(psis)))
    v, g = grid_ranks[0][case][:2]
    np.testing.assert_allclose(v, v_ref, rtol=1e-10)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-10)


def test_nuts_runs_on_the_grid_value_and_grad(grid_ranks):
    samples, step = grid_ranks[0]["nuts"]
    assert samples.shape == (4, 2 * 64 + 3 + 2)
    assert np.all(np.isfinite(samples)) and np.isfinite(step)
    for other in grid_ranks[1:]:
        np.testing.assert_array_equal(other["nuts"][0], samples)


def test_grid_data_for_another_mesh_size_raises(grid_ranks):
    y, cov, _ = _inputs("sigma_sampled")
    data = tg.make_grid_sharded_data(y, GPCov.from_numpy(cov), TEMPS, 3)
    assert data.n_dev == 3 and data.nloc == 22
    with pytest.raises(RuntimeError, match="init_process_group"):
        tg.make_grid_mesh(3, device="cpu")
