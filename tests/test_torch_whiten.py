"""PyTorch port, whitening: the Gauss-Newton precision, the staged MAP
optimizer, the exact Hessian, both whiteners and the mode-centered whitened
value-and-grad equal the JAX package's at float64 (rel 1e-8) on the small
FN problem of tests/test_whiten.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import whiten as jw
from manifold_constrained_gaussian_process_inference_tpu.inference.solve import (
    _init_x_interpolation,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_make_tr,
    unconstrain,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import whiten as tw
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform as t_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.models import FN_SYSTEM as T_FN
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov

torch.set_num_threads(1)
TEMPS = (1.0, 1.0, 1.0)
RTOL = 1e-8


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.max(np.abs(got - want)) <= rtol * max(np.max(np.abs(want)), 1e-300)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n = 21
    t = np.linspace(0, 6, n)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(n, 2))
    cov_j = jm.build_gp_cov("matern52", np.array([[1.5, 1.5], [1.2, 1.2]]), t, bandsize=20)
    cov_t = GPCov.from_numpy(cov_j)
    lb, ub = J_FN.theta_lower_bound, J_FN.theta_upper_bound
    kw = dict(sigma_init=np.array([0.2, 0.2]), prior_temperature=TEMPS, sigma_is_fixed=False)
    tj = JTarget.build(y, cov_j, J_FN, theta_transform=j_make_tr(lb, ub), **kw)
    tt = TTarget.build(y, cov_t, T_FN, theta_transform=t_make_tr(lb, ub), **kw)
    x0 = _init_x_interpolation(y, t)
    psi0 = np.concatenate([
        x0.T.reshape(-1), unconstrain(j_make_tr(lb, ub), np.array([0.2, 0.2, 3.0])),
        np.log([0.2, 0.2]),
    ])
    vg_j = jax.jit(tj.value_and_grad_fn())
    map_j = jw.gauss_newton_map(vg_j, cov_j, y, tj, psi0, TEMPS)
    return dict(y=y, cov_j=cov_j, cov_t=cov_t, tj=tj, tt=tt, psi0=psi0, vg_j=vg_j,
                map_j=map_j, nd=2 * n)


def test_gn_precision_matches_jax(problem):
    p = problem
    got = tw.build_precision(p["cov_t"], p["y"], p["tt"], p["psi0"], TEMPS)
    want = jw.build_precision(p["cov_j"], p["y"], p["tj"], p["psi0"], TEMPS)
    _close(got, want, 1e-12)


def test_gauss_newton_map_matches_jax(problem):
    p = problem
    got = tw.gauss_newton_map(p["tt"].value_and_grad_fn(), p["cov_t"], p["y"], p["tt"],
                              p["psi0"], TEMPS)
    _close(got, p["map_j"])
    v_got, _ = p["vg_j"](jnp.asarray(got))
    v_start, _ = p["vg_j"](jnp.asarray(p["psi0"]))
    assert float(v_got) > float(v_start)


def test_theta_only_prestage_matches_jax(problem):
    p = problem
    freeze = np.ones(p["psi0"].shape[0], dtype=bool)
    freeze[p["nd"] : p["nd"] + 3] = False
    got = tw.gauss_newton_map(p["tt"].value_and_grad_fn(), p["cov_t"], p["y"], p["tt"],
                              p["psi0"], TEMPS, freeze=freeze, n_newton=50, warn_on_cap=False)
    want = jw.gauss_newton_map(p["vg_j"], p["cov_j"], p["y"], p["tj"], p["psi0"], TEMPS,
                               freeze=freeze, n_newton=50, warn_on_cap=False)
    _close(got, want)
    np.testing.assert_array_equal(got[freeze], p["psi0"][freeze])


def test_exact_hessian_and_whitener_match_jax(problem):
    p = problem
    _close(tw.exact_hessian(p["tt"], p["map_j"]), jw.exact_hessian(p["tj"], p["map_j"]))
    got = tw.build_psi_whitener_exact(p["tt"], p["map_j"], torch.float64)
    want = jw.build_psi_whitener_exact(p["tj"], p["map_j"], jnp.float64)
    for name in ("W", "L_T", "center"):
        _close(getattr(got, name).numpy(), getattr(want, name))


def test_gn_whitener_matches_jax(problem):
    p = problem
    got = tw.build_psi_whitener(p["cov_t"], p["y"], p["tt"], p["map_j"], TEMPS, torch.float64)
    want = jw.build_psi_whitener(p["cov_j"], p["y"], p["tj"], p["map_j"], TEMPS, jnp.float64)
    for name in ("W", "L_T", "center"):
        _close(getattr(got, name).numpy(), getattr(want, name))


@pytest.mark.parametrize("band_impl", ["dense", "band"])
def test_centered_whitened_vg_matches_jax(problem, band_impl):
    p = problem
    lb, ub = J_FN.theta_lower_bound, J_FN.theta_upper_bound
    kw = dict(sigma_init=np.array([0.2, 0.2]), prior_temperature=TEMPS, sigma_is_fixed=False,
              band_impl=band_impl)
    # the JAX reference is its dense form either way: its banded form (which
    # its own tests hold equal to the dense one) unrolls 2b+1 = 41 rolls per
    # matvec here and is slow to evaluate on the CPU
    tj = JTarget.build(p["y"], p["cov_j"], J_FN, theta_transform=j_make_tr(lb, ub),
                       **{**kw, "band_impl": "dense"})
    tt = TTarget.build(p["y"], p["cov_t"], T_FN, theta_transform=t_make_tr(lb, ub), **kw)
    wh_j = jw.build_psi_whitener_exact(p["tj"], p["map_j"], jnp.float64)
    wh_t = tw.PsiWhitener.from_numpy(wh_j.W, wh_j.L_T, wh_j.center)
    zetas = np.random.default_rng(2).normal(size=(4, p["psi0"].shape[0])) * 0.5
    v_t, g_t = tw.make_centered_whitened_vg(tt, wh_t)(torch.as_tensor(zetas))
    vg_j = jax.jit(jw.make_centered_whitened_vg(tj, wh_j))
    for c in range(4):
        v_j, g_j = vg_j(jnp.asarray(zetas[c]))
        np.testing.assert_allclose(float(v_t[c]), float(v_j), rtol=1e-10)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j), rtol=1e-10, atol=1e-8)
    psis = tw.zeta_to_psi_np(wh_t, zetas)
    np.testing.assert_allclose(psis, jw.zeta_to_psi_np(wh_j, zetas), rtol=1e-12)
    np.testing.assert_allclose(tw.psi_to_zeta_np(wh_t, psis), zetas, atol=1e-8)


def test_banded_schur_step_equals_dense_solve(problem):
    p = problem
    prec = tw.build_precision(p["cov_t"], p["y"], p["tt"], p["map_j"], TEMPS)
    g = np.random.default_rng(3).normal(size=prec.shape[0])
    free = np.ones(prec.shape[0], dtype=bool)
    free[-2:] = False
    got = tw._banded_schur_solve(prec, g, 21, 2, 20, free)
    want = jw._banded_schur_solve(prec, g, 21, 2, 20, free)
    dense = np.zeros_like(g)
    idx = np.where(free)[0]
    dense[idx] = np.linalg.solve(prec[np.ix_(idx, idx)], g[idx])
    _close(got, want, 1e-12)
    _close(got, dense, 1e-8)
