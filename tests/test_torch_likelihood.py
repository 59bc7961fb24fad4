"""PyTorch port, likelihood: value and gradient of log_posterior,
log_posterior_banded, log_posterior_centered (dense and banded branches)
and log_likelihood_and_gradient_banded equal the JAX package's at float64
(value rel 1e-10; gradient atol 1e-8, plus rel 1e-12 because raw-state
gradients reach ~1e5 at n = 397, where 1e-8 is below float64 resolution
of the summation), on the band-impl test problem and on
the n = 397 bench grid, and the chain axis matches per-chain evaluation.
The banded forms run mphi and GC^T as one paired band call and GK^T as one
single call, forward and backward, and take a bandwidth above 64.

At n = 397 the port's banded forms are held against the JAX package's dense
forms, which its own tests hold equal to its banded forms
(tests/test_band_impl.py): its banded path unrolls 2b+1 = 81 rolls per
matvec there and takes minutes to evaluate on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
from manifold_constrained_gaussian_process_inference_tpu.ops import likelihood as jl
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform as t_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.models import FN_SYSTEM as T_FN
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import likelihood as tl
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov

torch.set_num_threads(1)
TEMPS = (1.0, 1.0, 2.0)
GRAD_RTOL = 1e-12


def _bench_grid(n_obs=100, t_end=20.0):
    t_obs = np.linspace(0.0, t_end, n_obs)
    segs = [np.linspace(t_obs[i], t_obs[i + 1], 5)[:-1] for i in range(n_obs - 1)]
    return np.concatenate(segs + [t_obs[-1:]])


def _make(case):
    rng = np.random.default_rng(3)
    if case == "small":
        t = np.linspace(0, 8, 40)
        phi, band = np.array([[1.5, 1.5], [1.0, 1.0]]), 6
    else:
        t = _bench_grid()
        phi, band = np.array([[1.9893, 0.631], [1.125, 2.5398]]), 20
    n = t.shape[0]
    truth = np.stack([np.sin(t), np.cos(t)], -1)
    y = truth + 0.15 * rng.normal(size=(n, 2))
    y[5, 0] = np.nan
    if case == "n397":
        y[1::4] = np.nan  # observations on every fourth grid point only
    cov_j = jm.build_gp_cov("matern52", phi, t, bandsize=band, complexity=2, jitter=1e-6)
    xs = truth[None] + 0.05 * rng.normal(size=(3, n, 2))
    thetas = np.array([0.2, 0.2, 3.0]) + 0.05 * rng.normal(size=(3, 3))
    sigmas = np.array([0.2, 0.25]) * np.exp(0.1 * rng.normal(size=(3, 2)))
    return y, cov_j, GPCov.from_numpy(cov_j), xs, thetas, sigmas


@pytest.fixture(scope="module", params=["small", "n397"])
def problem(request):
    return _make(request.param)


def _jax_banded(case_y):
    """Whether the JAX reference takes its banded form (small problem) or
    its dense form (n = 397)."""
    return case_y.shape[0] < 100


def _jax_vg(fn, x, theta, sigma):
    v, g = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(theta), jnp.asarray(sigma)
    )
    return float(v), [np.asarray(a) for a in g]


def _torch_vg(fn, x, theta, sigma):
    args = [torch.as_tensor(a).requires_grad_(True) for a in (x, theta, sigma)]
    v = fn(*args)
    grads = torch.autograd.grad(v.sum(), args)
    return v.detach().numpy(), [g.numpy() for g in grads]


def _check(tv, tg, jv, jg):
    np.testing.assert_allclose(tv, jv, rtol=1e-10)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=1e-8)


def test_log_posterior_dense(problem):
    y, cov_j, cov_t, xs, thetas, sigmas = problem
    dj = jl.make_likelihood_data(y, cov_j, TEMPS)
    dt = tl.make_likelihood_data(y, cov_t, TEMPS)
    for c in range(2):
        jv, jg = _jax_vg(lambda x, th, s: jl.log_posterior(x, th, s, dj, J_FN.f),
                         xs[c], thetas[c], sigmas[c])
        tv, tg = _torch_vg(lambda x, th, s: tl.log_posterior(x, th, s, dt, T_FN.f),
                           xs[c], thetas[c], sigmas[c])
        _check(tv, tg, jv, jg)


def test_log_posterior_banded(problem):
    y, cov_j, cov_t, xs, thetas, sigmas = problem
    b = cov_t.bandsize
    dt = tl.make_banded_likelihood_data(y, cov_t, TEMPS)
    if _jax_banded(y):
        dj = jl.make_banded_likelihood_data(y, cov_j, TEMPS)
        ref = lambda x, th, s: jl.log_posterior_banded(x, th, s, dj, J_FN.f, b)
    else:
        dj = jl.make_likelihood_data(y, cov_j, TEMPS)
        ref = lambda x, th, s: jl.log_posterior(x, th, s, dj, J_FN.f)
    jv, jg = _jax_vg(ref, xs[0], thetas[0], sigmas[0])
    tv, tg = _torch_vg(lambda x, th, s: tl.log_posterior_banded(x, th, s, dt, T_FN.f, b),
                       xs[0], thetas[0], sigmas[0])
    _check(tv, tg, jv, jg)


@pytest.mark.parametrize("banded", [False, True])
def test_log_posterior_centered(problem, banded):
    y, cov_j, cov_t, xs, thetas, sigmas = problem
    b = cov_t.bandsize
    make_j = (jl.make_banded_likelihood_data if banded and _jax_banded(y)
              else jl.make_likelihood_data)
    make_t = tl.make_banded_likelihood_data if banded else tl.make_likelihood_data
    dj, dt = make_j(y, cov_j, TEMPS), make_t(y, cov_t, TEMPS)
    x_ref = xs[2]
    cj, ct = jl.make_centered_terms(dj, x_ref, b), tl.make_centered_terms(dt, x_ref, b)
    for name in jl.CenteredTerms._fields:
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1e-12, atol=1e-12)
    dx = xs[0] - x_ref
    jv, jg = _jax_vg(lambda d, th, s: jl.log_posterior_centered(d, th, s, dj, cj, J_FN.f, b),
                     dx, thetas[0], sigmas[0])
    tv, tg = _torch_vg(lambda d, th, s: tl.log_posterior_centered(d, th, s, dt, ct, T_FN.f, b),
                       dx, thetas[0], sigmas[0])
    _check(tv, tg, jv, jg)
    # the chain axis: all three states at once equal one at a time
    dxs = xs - x_ref
    tv3, tg3 = _torch_vg(lambda d, th, s: tl.log_posterior_centered(d, th, s, dt, ct, T_FN.f, b),
                         dxs, thetas, sigmas)
    for c in range(3):
        jv, jg = _jax_vg(lambda d, th, s: jl.log_posterior_centered(d, th, s, dj, cj, J_FN.f, b),
                         dxs[c], thetas[c], sigmas[c])
        _check(tv3[c], [g[c] for g in tg3], jv, jg)


def test_parity_api_matches_jax(problem):
    y, cov_j, cov_t, xs, thetas, sigmas = problem
    jv, jflat = jl.log_likelihood_and_gradient_banded(
        jnp.asarray(xs[0]), jnp.asarray(thetas[0]), jnp.asarray(sigmas[0]), y, cov_j, J_FN.f,
        TEMPS,
    )
    tv, tflat = tl.log_likelihood_and_gradient_banded(
        torch.as_tensor(xs[0]), thetas[0], sigmas[0], y, cov_t, T_FN.f, TEMPS,
    )
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-10)
    np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), rtol=GRAD_RTOL, atol=1e-8)


@pytest.mark.parametrize("band_impl", ["dense", "band"])
@pytest.mark.parametrize("sigma_fixed,transformed", [(False, True), (True, False)])
def test_target_value_and_grad_matches_jax(problem, band_impl, sigma_fixed, transformed):
    y, cov_j, cov_t, xs, thetas, sigmas = problem
    lb, ub = J_FN.theta_lower_bound, J_FN.theta_upper_bound
    kw = dict(sigma_init=np.array([0.2, 0.25]), prior_temperature=TEMPS,
              sigma_is_fixed=sigma_fixed, band_impl=band_impl)
    tj = JTarget.build(y, cov_j, J_FN, theta_transform=j_make_tr(lb, ub) if transformed else None,
                       **{**kw, "band_impl": band_impl if _jax_banded(y) else "dense"})
    tt = TTarget.build(y, cov_t, T_FN, theta_transform=t_make_tr(lb, ub) if transformed else None,
                       **kw)
    assert tt.dimension == tj.dimension
    parts = [xs[:, :, :].transpose(0, 2, 1).reshape(3, -1), np.log(thetas)]
    if not sigma_fixed:
        parts.append(np.log(sigmas))
    psis = np.concatenate(parts, axis=1)
    tv, tg = tt.value_and_grad_fn()(torch.as_tensor(psis))
    vg_j = tj.value_and_grad_fn()
    for c in range(3):
        jv, jg = vg_j(jnp.asarray(psis[c]))
        np.testing.assert_allclose(tv[c].numpy(), float(jv), rtol=1e-10)
        np.testing.assert_allclose(tg[c].numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=1e-8)
    x, theta, log_sigma = tt.unpack(torch.as_tensor(psis))
    np.testing.assert_array_equal(x.numpy(), xs)
    np.testing.assert_array_equal(tt.pack(x, theta, log_sigma).numpy(), psis)


@pytest.mark.parametrize("centered", [False, True])
def test_banded_branches_run_two_band_calls_each_way(monkeypatch, centered):
    """The banded likelihood makes one paired call (mphi and GC^T on one
    input) and one single call (GK^T) forward, and one of each backward:
    four kernel launches per value-and-grad on a card."""
    y, cov_j, cov_t, xs, thetas, sigmas = _make("small")
    b = cov_t.bandsize
    dt = tl.make_banded_likelihood_data(y, cov_t, TEMPS)
    calls = []
    for name in ("_apply", "_apply_pair", "_apply_pair_t"):
        fn = getattr(cuda_band, name)
        monkeypatch.setattr(cuda_band, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    if centered:
        ct = tl.make_centered_terms(dt, xs[2], b)
        fn = lambda x, th, s: tl.log_posterior_centered(x - ct.x_ref, th, s, dt, ct, T_FN.f, b)
    else:
        fn = lambda x, th, s: tl.log_posterior_banded(x, th, s, dt, T_FN.f, b)
    _torch_vg(fn, xs[:2], thetas[:2], sigmas[:2])
    assert sorted(calls) == ["_apply", "_apply", "_apply_pair", "_apply_pair_t"]


def test_banded_likelihood_above_bandwidth_64_matches_jax():
    """Band storage at a bandwidth the TPU kernel did not take (70) equals
    the JAX package's dense form on the same banded operators."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 8, 150)
    truth = np.stack([np.sin(t), np.cos(t)], -1)
    y = truth + 0.15 * rng.normal(size=truth.shape)
    y[1::3] = np.nan
    cov_j = jm.build_gp_cov("matern52", np.array([[1.5, 1.5], [1.0, 1.0]]), t, bandsize=70,
                            complexity=2, jitter=1e-6)
    cov_t = GPCov.from_numpy(cov_j)
    assert cov_t.bandsize == 70
    x = truth + 0.05 * rng.normal(size=truth.shape)
    theta, sigma = np.array([0.2, 0.2, 3.0]), np.array([0.2, 0.25])
    dj = jl.make_likelihood_data(y, cov_j, TEMPS)
    dt = tl.make_banded_likelihood_data(y, cov_t, TEMPS)
    jv, jg = _jax_vg(lambda a, th, s: jl.log_posterior(a, th, s, dj, J_FN.f), x, theta, sigma)
    tv, tg = _torch_vg(lambda a, th, s: tl.log_posterior_banded(a, th, s, dt, T_FN.f, 70),
                       x, theta, sigma)
    _check(tv, tg, jv, jg)


def test_pallas_name_is_refused():
    y, _, cov_t, *_ = _make("small")
    with pytest.raises(ValueError, match="'band'"):
        TTarget.build(y, cov_t, T_FN, np.array([0.2, 0.2]), TEMPS, False, band_impl="pallas")
