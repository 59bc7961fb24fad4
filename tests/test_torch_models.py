"""PyTorch port, models: every system's right-hand side and Jacobians
(analytic for FN and Hes1, torch.func defaults for the rest) equal the JAX
package's to 1e-12 (float64), batched over chains."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.models import systems as jsys
from manifold_constrained_gaussian_process_inference_tpu_torch.models import base as tbase
from manifold_constrained_gaussian_process_inference_tpu_torch.models import systems as tsys

torch.set_num_threads(1)


def _inputs(seed=0, n=17):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 2)), np.array([0.2, 0.3, 2.5]) + 0.1 * rng.normal(size=3), \
        np.linspace(0.0, 4.0, n)


@pytest.mark.parametrize("name", ["fn_f", "fn_f_dx", "fn_f_dtheta"])
def test_fn_matches_jax(name):
    x, theta, t = _inputs()
    want = np.asarray(getattr(jsys, name)(jnp.asarray(x), jnp.asarray(theta), jnp.asarray(t)))
    got = getattr(tsys, name)(torch.as_tensor(x), torch.as_tensor(theta), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["fn_f", "fn_f_dx", "fn_f_dtheta"])
def test_fn_batched_over_chains(name):
    xs, thetas = [], []
    for seed in range(3):
        x, theta, t = _inputs(seed)
        xs.append(x)
        thetas.append(theta)
    fn = getattr(tsys, name)
    tt = torch.as_tensor(t)
    got = fn(torch.as_tensor(np.stack(xs)), torch.as_tensor(np.stack(thetas)), tt)
    for c in range(3):
        one = fn(torch.as_tensor(xs[c]), torch.as_tensor(thetas[c]), tt)
        np.testing.assert_allclose(got[c].numpy(), one.numpy(), rtol=1e-14, atol=1e-14)


def test_autodiff_default_jacobians_match_analytic():
    system = tbase.OdeSystem(
        f=tsys.fn_f, theta_lower_bound=[0, 0, 0], theta_upper_bound=[np.inf] * 3,
        theta_size=3, name="fn-autodiff-test",
    )
    x, theta, t = (torch.as_tensor(a) for a in _inputs(4))
    np.testing.assert_allclose(
        system.f_dx(x, theta, t).numpy(), tsys.fn_f_dx(x, theta, t).numpy(), atol=1e-12
    )
    np.testing.assert_allclose(
        system.f_dtheta(x, theta, t).numpy(), tsys.fn_f_dtheta(x, theta, t).numpy(), atol=1e-12
    )


def test_registry_has_fn():
    assert tbase.get_system("fn") is tsys.FN_SYSTEM
    assert "fn" in tbase.registered_systems()
    with pytest.raises(KeyError):
        tbase.get_system("no-such-system")


# name -> (D, lower and upper end of the random theta)
SYSTEMS = {"hes1": (3, 0.2, 1.0), "hes1log": (3, 0.2, 1.0), "hes1log_fixg": (3, 0.2, 1.0),
           "hes1log_fixf": (3, 0.2, 1.0), "hiv": (4, -1.0, 1.0), "ptrans": (5, 0.2, 1.0)}


def test_registry_matches_jax():
    from manifold_constrained_gaussian_process_inference_tpu.models import base as jbase

    assert tbase.registered_systems() == jbase.registered_systems()
    for name in SYSTEMS:
        t, j = tbase.get_system(name), jbase.get_system(name)
        assert t.theta_size == j.theta_size and t.name == name
        np.testing.assert_array_equal(t.theta_lower_bound, j.theta_lower_bound)
        np.testing.assert_array_equal(t.theta_upper_bound, j.theta_upper_bound)


@pytest.mark.parametrize("attr", ["f", "f_dx", "f_dtheta"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_system_matches_jax_batched_over_chains(name, attr):
    from manifold_constrained_gaussian_process_inference_tpu.models import base as jbase

    d, lo, hi = SYSTEMS[name]
    system_t, system_j = tbase.get_system(name), jbase.get_system(name)
    rng = np.random.default_rng(5)
    xs = 0.5 * rng.normal(size=(3, 9, d))
    thetas = rng.uniform(lo, hi, size=(3, system_t.theta_size))
    t = np.linspace(0.0, 2.0, 9)
    got = getattr(system_t, attr)(torch.as_tensor(xs), torch.as_tensor(thetas), torch.as_tensor(t))
    shared = getattr(system_t, attr)(torch.as_tensor(xs), torch.as_tensor(thetas[0]),
                                     torch.as_tensor(t))
    for c in range(3):
        want = np.asarray(getattr(system_j, attr)(jnp.asarray(xs[c]), jnp.asarray(thetas[c]),
                                                  jnp.asarray(t)))
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-12, atol=1e-12)
        one = getattr(system_t, attr)(torch.as_tensor(xs[c]), torch.as_tensor(thetas[0]),
                                      torch.as_tensor(t))
        np.testing.assert_allclose(shared[c].numpy(), one.numpy(), rtol=1e-14, atol=1e-14)


def test_rk4_matches_jax():
    from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
    from manifold_constrained_gaussian_process_inference_tpu.utils import integrators as ji
    from manifold_constrained_gaussian_process_inference_tpu_torch.utils import integrators as ti

    theta = np.array([0.2, 0.2, 3.0])
    ts_j, xs_j = ji.integrate_system(J_FN, [-1.0, 1.0], 0.0, 5.0, theta, 500)
    ts_t, xs_t = ti.integrate_system(tsys.FN_SYSTEM, [-1.0, 1.0], 0.0, 5.0, theta, 500)
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), rtol=1e-13)
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-10, atol=1e-12)
    tq = np.linspace(0.1, 4.9, 13)
    np.testing.assert_allclose(
        ti.sample_on_grid(ts_t.numpy(), xs_t.numpy(), tq),
        ji.sample_on_grid(ts_j, xs_j, tq), rtol=1e-10, atol=1e-12,
    )
