"""The plain reference against the port on the CPU in float64, at a small
size: the GP operators and the band rule, the log-density and its
gradient on the raw and whitened coordinates, one NUTS transition (with
its acceptance statistic) and one tempering iteration drawn from the same
generator, and the GP smoothing that picks phi, with ``nlml_gap``
separating the port's optimum from its float32 control and from an
optimizer stopped early."""
from __future__ import annotations

import numpy as np
import pytest
import torch

PKG = "manifold_constrained_gaussian_process_inference_tpu_torch"


def _fn_problem(n_obs=21, fill=0, seed=3):
    from portbench.core import data

    cfg = {"data": {"seed": seed, "generator": "fn_grid", "system": "fn", "x0": [-1.0, 1.0],
                    "theta": [0.2, 0.2, 3.0], "t_end": 20.0, "n_obs": n_obs, "noise": 0.2,
                    "fill": fill, "rk4_steps": 2000}}
    return data.make(cfg)


def _port_target(y, t, phi, band, temps=(1.0, 1.0, 1.0), constrained=True):
    import importlib

    mt = importlib.import_module(PKG)
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import MagiTarget
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
        make_theta_transform)
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import build_gp_cov

    cov = build_gp_cov("matern52", phi, t, bandsize=band)
    tr = make_theta_transform(mt.FN_SYSTEM.theta_lower_bound, mt.FN_SYSTEM.theta_upper_bound)
    return cov, MagiTarget.build(y, cov, mt.FN_SYSTEM, np.full(2, 0.2), temps, False,
                                 band_impl="band", theta_transform=tr if constrained else None)


@pytest.mark.parametrize("band,constrained,temps", [(20, True, (1.0, 1.0, 1.0)),
                                                    (4, False, (1.0, 1.0, 5.0))])
def test_log_density_matches_the_port(band, constrained, temps):
    from portbench.reference.posterior import Posterior

    y, t, _ = _fn_problem()
    phi = np.array([[2.0, 1.8], [1.5, 1.2]])
    cov, target = _port_target(y, t, phi, band, temps, constrained)
    post = Posterior("fn", y, t, phi, None, temps, np.zeros(3), constrained, band, 1e-6)
    assert post.band == cov.bandsize
    rng = np.random.default_rng(0)
    x0 = np.nan_to_num(y, nan=0.0) + 0.1 * rng.normal(size=y.shape)
    psi = np.concatenate([x0.T.reshape(-1), [np.log(0.2), np.log(0.2), np.log(3.0)],
                          np.log([0.2, 0.25])])[None] + 0.01 * rng.normal(size=(3, post.dim))
    q = torch.as_tensor(psi)
    lp, g = target.value_and_grad_fn()(q)
    lp_ref, g_ref = post.value_and_grad(q)
    assert torch.allclose(lp, lp_ref, rtol=1e-10, atol=1e-8)
    assert torch.allclose(g, g_ref, rtol=1e-9, atol=1e-8)


def test_transition_matches_the_port():
    """One NUTS transition of 4 chains under a dense metric: the reference
    draws from the same generator state and lands where the port does."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts import DenseMetric
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.nuts_batched import (
        nuts_transition_batched)
    from portbench.reference import nuts as ref
    from portbench.reference.posterior import Posterior

    y, t, _ = _fn_problem()
    phi = np.array([[2.0, 1.8], [1.5, 1.2]])
    _, target = _port_target(y, t, phi, 20)
    post = Posterior("fn", y, t, phi, None, (1.0, 1.0, 1.0), np.zeros(3), True, 20, 1e-6)
    rng = np.random.default_rng(1)
    x0 = np.nan_to_num(y, nan=0.0)
    base = np.concatenate([x0.T.reshape(-1), [np.log(0.2), np.log(0.2), np.log(3.0)],
                           np.log([0.2, 0.2])])
    q = torch.as_tensor(base[None] + 0.01 * rng.normal(size=(4, post.dim)))
    a = rng.normal(size=(post.dim, post.dim)) * 0.01
    minv = torch.as_tensor(np.eye(post.dim) * 1e-3 + a @ a.T * 1e-2)
    chol = torch.linalg.cholesky(minv)
    metric = DenseMetric(minv, chol, torch.linalg.inv(chol).T)
    vg = target.value_and_grad_fn()
    lp, g = vg(q)
    eps = torch.full((4,), 0.05, dtype=torch.float64)
    gen = torch.Generator().manual_seed(123)
    state = gen.get_state()
    q1, lp1, g1, stats = nuts_transition_batched(vg, q, lp, g, eps, metric, gen, max_depth=6)
    draws = ref.GeneratorDraws(state, "cpu", torch.float64, 4, post.dim)
    res = ref.transition(post.value_and_grad, q, lp, g, eps, ref.Dense(minv), draws, 6)
    assert torch.equal(res.depth.to(stats.tree_depth.dtype), stats.tree_depth)
    assert torch.allclose(res.q, q1, rtol=0, atol=1e-9)
    assert not ref.moved_apart(q1, res.q, q).any()
    # the acceptance statistic ``accept_shortfall`` averages
    assert torch.allclose(res.accept, stats.accept_prob.to(res.accept.dtype), rtol=1e-9, atol=0)


def test_swap_sweep_matches_the_port():
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.tempering import (
        swap_sweep)
    from portbench.reference import nuts as ref

    g = torch.Generator().manual_seed(5)
    r, k, dim = 2, 5, 3
    q = torch.randn((r, k, dim), generator=g, dtype=torch.float64)
    lp = -torch.rand((r, k), generator=g, dtype=torch.float64) * 3
    grads = torch.randn((r, k, dim), generator=g, dtype=torch.float64)
    inv_temps = torch.tensor([1.0, 0.7, 0.5, 0.3, 0.2], dtype=torch.float64)
    u = torch.rand((r, k), generator=g, dtype=torch.float64)
    for parity in (0, 1):
        port = swap_sweep(q, lp, grads, torch.zeros((r, k), dtype=torch.bool), inv_temps, u,
                          parity)
        mine = ref.swap_sweep(q, lp, grads, inv_temps, u, parity)
        for a, b in zip(port[:3], mine):
            assert torch.equal(a, b)


def test_moved_apart_separates_rounding_from_another_leaf():
    from portbench.reference.nuts import moved_apart

    start = torch.zeros((3, 4), dtype=torch.float64)
    ref = torch.ones((3, 4), dtype=torch.float64)
    prog = ref.clone()
    prog[1] += 1e-6
    prog[2] = 0.5
    assert moved_apart(prog, ref, start).tolist() == [False, False, True]


def test_gp_smoothing_matches_the_port_and_judges_its_phi():
    """The reference's phi is the port's NLML optimum; ``nlml_gap`` reads
    nought to rounding there, more for the float32 control and far more for
    an optimizer stopped after one step."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import nlml as port
    from portbench.reference import nlml as ref

    y, t, _ = _fn_problem(n_obs=41)
    phi, best = ref.fit(t, y, 1e-6)

    def port_phi(iters):
        guess = port.default_initial_guesses(y, t)
        return port.optimize_gp_hyperparameters(y, t, "matern52", guess, 1e-6,
                                                max_iters=iters)[:, :2].T

    assert np.allclose(port_phi(100), phi, rtol=1e-4)
    sound = ref.gap(port_phi(100), t, y, 1e-6, best).sum()
    control = ref.gap(ref.fit(t, y, 1e-6, torch.float32)[0], t, y, 1e-6, best).sum()
    early = ref.gap(port_phi(1), t, y, 1e-6, best).sum()
    assert -1e-9 < sound < 1e-8 < control < 1e-3 < early
