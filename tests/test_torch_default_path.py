"""PyTorch port, the default path's target and warm start: the raw-Psi
value-and-grad (``MagiTarget.value_and_grad_fn``, no whitening, no
mode-centering) of FN, hes1log_fixg, hiv and ptrans, on the dense and the
band layout, with and without the theta transform and a GP mean, equals the
JAX package's at rtol 1e-10 (gradients also atol 1e-8), at one chain (C = 1)
and unbatched; and ``map_warm_start`` (Adam, optax's update) returns the
JAX package's Psi within rtol 1e-8 after 100 steps on the same target."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import solve as jsolve
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu.models import base as jbase
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import solve as tsolve
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform as t_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    unconstrain,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.models import base as tbase
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import build_gp_cov
from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
    FAMILY_CASES,
    family_problem,
)

torch.set_num_threads(1)
TEMPS = (1.0, 1.0, 2.0)


def _fn_problem():
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 6.0, 19)
    y = np.stack([2.0 * np.sin(t), np.cos(t)], -1) + 0.1 * rng.normal(size=(19, 2))
    y[4, 0] = np.nan
    return tbase.get_system("fn"), y, t, [0.2, 0.2, 3.0], np.array([[2.0, 2.0], [1.5, 1.5]])


def _problem(name):
    """(system, y, t, a theta inside the bounds, phi)."""
    if name == "fn":
        return _fn_problem()
    system, y, t, options = family_problem(name)
    return system, y, t, FAMILY_CASES[name]["theta"], options["phi"]


def _targets(name, band_impl, variant):
    system, y, t, theta, phi = _problem(name)
    n, d = y.shape
    kw = dict(prior_temperature=TEMPS, sigma_is_fixed=False, sigma_init=np.full(d, 0.1))
    if variant == "transformed":
        lb, ub = system.theta_lower_bound, system.theta_upper_bound
        # a constant GP mean for two systems, a whole trajectory for the others
        mean = (np.nanmean(y, 0) if name in ("fn", "hiv")
                else np.linspace(0.0, 1.0, n)[:, None] * np.nanmean(y, 0))
        kw_j, kw_t = dict(kw, gp_mean=mean), dict(kw, gp_mean=mean)
        # hiv's theta is unbounded, so its transform is the identity; the JAX
        # package's gives a NaN gradient for its theta ~1e3 (exp overflow in
        # an unselected branch; ROADMAP Queue 3)
        if np.isfinite(lb).any() or np.isfinite(ub).any():
            kw_j["theta_transform"] = j_make_tr(lb, ub)
            kw_t["theta_transform"] = t_make_tr(lb, ub)
    else:
        kw_j = kw_t = kw
    cov_j = jm.build_gp_cov("matern52", phi, t, bandsize=4, complexity=2, jitter=1e-6)
    cov_t = build_gp_cov("matern52", phi, t, bandsize=4, complexity=2, jitter=1e-6)
    tj = JTarget.build(y, cov_j, jbase.get_system(name), band_impl=band_impl, **kw_j)
    tt = TTarget.build(y, cov_t, system, band_impl=band_impl, **kw_t)
    rng = np.random.default_rng(7)
    x = np.where(np.isfinite(y), y, 0.0) + 0.05 * rng.normal(size=y.shape)
    th = np.asarray(theta, dtype=np.float64) * np.exp(0.05 * rng.normal(size=len(theta)))
    if tt.theta_transform is not None:
        th = unconstrain(tt.theta_transform, th)
    psi = np.concatenate([x.T.reshape(-1), th, np.log(np.full(d, 0.1))])
    return tj, tt, psi


@pytest.mark.parametrize("variant", ["plain", "transformed"])
@pytest.mark.parametrize("band_impl", ["dense", "band"])
@pytest.mark.parametrize("name", ["fn", "hes1log_fixg", "hiv", "ptrans"])
def test_raw_value_and_grad_matches_jax(name, band_impl, variant):
    tj, tt, psi = _targets(name, band_impl, variant)
    assert tt.dimension == tj.dimension == psi.shape[0]
    jv, jg = tj.value_and_grad_fn()(jnp.asarray(psi))
    vg = tt.value_and_grad_fn()
    for arg, take in ((torch.as_tensor(psi), lambda a: a), (torch.as_tensor(psi[None]),
                                                            lambda a: a[0])):
        tv, tg = vg(arg)
        assert tv.shape == arg.shape[:-1] and tg.shape == arg.shape
        np.testing.assert_allclose(take(tv).numpy(), float(jv), rtol=1e-10)
        np.testing.assert_allclose(take(tg).numpy(), np.asarray(jg), rtol=1e-10, atol=1e-8)


@pytest.mark.parametrize("name,constrained", [("fn", False), ("ptrans", True)])
def test_map_warm_start_matches_jax(name, constrained):
    """100 Adam steps from the same start on the same target: the same Psi
    (float64), theta kept inside its bounds."""
    tj, tt, psi0 = _targets(name, "dense", "transformed" if constrained else "plain")
    system = tt.system
    nd, k = tt.n_times * tt.n_dims, system.theta_size
    if constrained:
        lb, ub = np.full(k, -np.inf), np.full(k, np.inf)
    else:
        lb, ub = system.theta_lower_bound, system.theta_upper_bound
    args = (psi0, 100, 0.01, slice(nd, nd + k), lb, ub)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jsolve.map_warm_start(tj.value_and_grad_fn(), *args, jnp.float64)
    got = tsolve.map_warm_start(tt.value_and_grad_fn(), *args, torch.float64)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert not np.allclose(got, psi0)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert np.all(got[nd : nd + k] > lb)


def test_map_warm_start_clips_theta_and_rejects_non_finite_steps():
    """Adam towards (3, -5) with theta (the second slot) bounded to [0, 1]
    and a gradient that turns NaN once the first slot passes 1: theta ends
    at its strict margin, and the first slot stops at the first point past
    1 (every later step is non-finite and rejected)."""
    target = torch.tensor([3.0, -5.0], dtype=torch.float64)

    def vg(psi):
        g = -2.0 * (psi - target)
        g = torch.where(psi[0] > 1.0, torch.full_like(g, float("nan")), g)
        return -((psi - target) ** 2).sum(-1), g

    got = tsolve.map_warm_start(vg, np.array([0.2, 0.5]), 100, 0.05, slice(1, 2),
                                np.array([0.0]), np.array([1.0]), torch.float64)
    assert np.isfinite(got).all()
    assert 1.0 < got[0] < 1.06
    assert got[1] == 1e-4  # lb + 1e-4 * min(ub - lb, 1)
