"""PyTorch port, the whitened FN value-and-grad's kernel route
(ops/centered_vg.py): on the CPU its plain version (the kernel's analytic
forward and backward in torch operations) equals the JAX package's
make_centered_whitened_vg to rtol 1e-10 (gradient atol 1e-8) and the
port's autograd route to rtol 1e-12 (atol 1e-12 of max |g|), float64, on
small FN problems (n = 21, b = 20; n = 41, b = 10) over sigma sampled and
fixed, theta bounded and not, two prior temperatures, a mask with
unobserved points and C = 1 and 4; the clamp's gradient beyond
|log sigma| = 15; non-finite values where f overflows; the dispatch rule;
and solve_magi on the route. On a card (tests marked ``cuda``) the kernel
equals its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import whiten as jw
from manifold_constrained_gaussian_process_inference_tpu.inference.target import (
    MagiTarget as JTarget,
)
from manifold_constrained_gaussian_process_inference_tpu.inference.transforms import (
    make_theta_transform as j_make_tr,
    unconstrain,
)
from manifold_constrained_gaussian_process_inference_tpu.models import FN_SYSTEM as J_FN
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import whiten as tw
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
    _init_x_interpolation,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import (
    MagiTarget as TTarget,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
    make_theta_transform as t_make_tr,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.models import (
    FN_SYSTEM as T_FN,
    HES1_SYSTEM,
)
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import centered_vg as cv
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band
from manifold_constrained_gaussian_process_inference_tpu_torch.ops.gp_cov import GPCov

torch.set_num_threads(1)
THETA = np.array([0.2, 0.2, 3.0])
SIGMA = np.array([0.2, 0.2])
# (n, b, sigma sampled, theta bounded below, prior temperature, unobserved, C)
CASES = {
    "sampled-bounded": (21, 20, True, True, (1.0, 1.0, 1.0), False, 4),
    "fixed-bounded": (21, 20, False, True, (1.0, 1.0, 1.0), False, 1),
    "sampled-free-tempered": (21, 20, True, False, (2.0, 0.5, 1.5), False, 4),
    "fixed-free-masked": (21, 20, False, False, (1.0, 1.0, 1.0), True, 4),
    "sampled-bounded-masked-tempered": (41, 10, True, True, (2.0, 0.5, 1.5), True, 1),
    "fixed-free-n41": (41, 10, False, False, (2.0, 0.5, 1.5), False, 4),
}


def _problem(name):
    """Both packages' targets and one whitener (the JAX package's GN
    whitener at the interpolated start) for one case."""
    n, b, sampled, bounded, temps, masked, c = CASES[name]
    rng = np.random.default_rng(n + b)
    t = np.linspace(0, 6, n)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(n, 2))
    if masked:
        y[1::3, 0] = np.nan
        y[::4, 1] = np.nan
    cov_j = jm.build_gp_cov("matern52", np.array([[1.5, 1.5], [1.2, 1.2]]), t, bandsize=b)
    cov_t = GPCov.from_numpy(cov_j)
    lb, ub = J_FN.theta_lower_bound, J_FN.theta_upper_bound
    kw = dict(sigma_init=SIGMA, prior_temperature=temps, sigma_is_fixed=not sampled)
    tr_j = j_make_tr(lb, ub) if bounded else None
    tj = JTarget.build(y, cov_j, J_FN, theta_transform=tr_j, band_impl="dense", **kw)
    tt = TTarget.build(y, cov_t, T_FN, theta_transform=t_make_tr(lb, ub) if bounded else None,
                       band_impl="band", **kw)
    z_theta = unconstrain(tr_j, THETA) if bounded else THETA
    center = np.concatenate([_init_x_interpolation(y, t).T.reshape(-1), z_theta]
                            + ([np.log(SIGMA)] if sampled else []))
    wh_j = jw.build_psi_whitener(cov_j, y, tj, center, temps, jnp.float64)
    wh_t = tw.PsiWhitener.from_numpy(wh_j.W, wh_j.L_T, wh_j.center)
    zetas = np.random.default_rng(2).normal(size=(c, center.shape[0])) * 0.5
    return dict(tj=tj, tt=tt, wh_j=wh_j, wh_t=wh_t, zetas=zetas, cov_t=cov_t, y=y, t=t,
                center=center)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _problem(request.param)


def _close_to_autograd(got, want):
    """rtol 1e-12, the gradient with atol 1e-12 of its largest entry."""
    (v, g), (v_a, g_a) = got, want
    np.testing.assert_allclose(v.numpy(), v_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=1e-12,
                               atol=1e-12 * float(g_a.abs().max()))


def test_plain_version_matches_jax(case):
    vg = tw.make_centered_whitened_vg(case["tt"], case["wh_t"])
    assert vg.route == "kernel"
    v_t, g_t = vg(torch.as_tensor(case["zetas"]))
    vg_j = jax.jit(jw.make_centered_whitened_vg(case["tj"], case["wh_j"]))
    for c, zeta in enumerate(case["zetas"]):
        v_j, g_j = vg_j(jnp.asarray(zeta))
        np.testing.assert_allclose(float(v_t[c]), float(v_j), rtol=1e-10)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j), rtol=1e-10, atol=1e-8)


def test_plain_version_matches_autograd(case):
    zetas = torch.as_tensor(case["zetas"])
    kernel = tw.make_centered_whitened_vg(case["tt"], case["wh_t"])
    autograd = tw.make_centered_whitened_vg_autograd(case["tt"], case["wh_t"])
    assert autograd.route == "autograd"
    _close_to_autograd(kernel(zetas), autograd(zetas))
    # one zeta without a chain axis
    _close_to_autograd(kernel(zetas[0]), autograd(zetas[0]))


@pytest.mark.parametrize("log_sigma", [16.0, -16.5])
def test_clamped_log_sigma_matches_autograd(log_sigma):
    """Beyond |log sigma| = 15 the clamp holds sigma: the log-sigma
    gradient is 0 there, as torch.clamp's, and the rest still agrees."""
    p = _problem("sampled-bounded")
    wh, tt = p["wh_t"], p["tt"]
    psi = np.tile(p["center"], (3, 1))
    psi[:, -2] = log_sigma
    psi[1, -1] = -log_sigma
    zetas = torch.as_tensor(tw.psi_to_zeta_np(wh, psi))
    _close_to_autograd(tw.make_centered_whitened_vg(tt, wh)(zetas),
                       tw.make_centered_whitened_vg_autograd(tt, wh)(zetas))
    params = cv.make_params(tt, wh.center)
    _, g_psi = cv.centered_fn_vg_torch(torch.as_tensor(psi - p["center"]), params)
    assert (g_psi[:, -2] == 0).all() and (g_psi[1, -1] == 0).all() and (g_psi[0, -1] != 0)


def test_overflowing_f_is_not_finite_on_both_routes():
    p = _problem("fixed-free-masked")
    wh, tt = p["wh_t"], p["tt"]
    psi = np.tile(p["center"], (2, 1))
    psi[1, :5] = 1e120  # V**3 overflows float64
    zetas = torch.as_tensor(tw.psi_to_zeta_np(wh, psi))
    for make in (tw.make_centered_whitened_vg, tw.make_centered_whitened_vg_autograd):
        v, _ = make(tt, wh)(zetas)
        assert np.isfinite(float(v[0])) and not np.isfinite(float(v[1]))


def _route(target):
    wh = tw.PsiWhitener.from_numpy(np.eye(target.dimension), np.eye(target.dimension),
                                   np.zeros(target.dimension))
    return tw.make_centered_whitened_vg(target, wh).route


@pytest.mark.parametrize("change,want", [
    (None, "kernel"),
    ("dense", "autograd"),
    ("hes1", "autograd"),
    ("oversize", "autograd"),
    ("long-grid", "autograd"),
    ("two-sided-theta", "autograd"),
])
def test_dispatch_rule(change, want):
    """Banded FN takes the kernel route; the dense layout, another system,
    a chain state beyond a block's shared memory, a grid beyond MAX_TERMS
    terms an operator and a transform other than the identity or a lower
    bound take autograd."""
    p = _problem("sampled-bounded")
    kw = dict(sigma_init=SIGMA, prior_temperature=(1.0, 1.0, 1.0), sigma_is_fixed=False,
              theta_transform=t_make_tr(T_FN.theta_lower_bound, T_FN.theta_upper_bound))
    target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="band", **kw)
    if change == "dense":
        target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="dense", **kw)
    elif change == "hes1":
        target = dataclasses.replace(target, system=HES1_SYSTEM)
    elif change == "oversize":
        n_max = max(n for n in range(1, 8000)
                    if cv.shared_bytes(n, 8) <= cv.MAX_SHARED_BYTES)
        assert cv.takes(dataclasses.replace(target, n_times=n_max, bandwidth=0))
        target = dataclasses.replace(target, n_times=n_max + 1, bandwidth=0)
    elif change == "long-grid":
        n_max = cv.MAX_TERMS // 81
        assert cv.takes(dataclasses.replace(target, n_times=n_max, bandwidth=40))
        target = dataclasses.replace(target, n_times=n_max + 1, bandwidth=40)
    elif change == "two-sided-theta":
        target = TTarget.build(p["y"], p["cov_t"], T_FN, band_impl="band", **{
            **kw, "theta_transform": t_make_tr([0.0, 0.0, 0.0], [1.0, 1.0, 10.0])})
    assert cv.takes(target) == (want == "kernel")
    if change not in ("oversize", "long-grid"):
        assert _route(target) == want


def test_kernel_source_agrees_with_the_wrapper():
    """The kernel's constants (threads, sums, tail offset, argument
    counts) and its shared-memory formula are the wrapper's."""
    import re

    src = cv.SOURCE.read_text()
    const = lambda name: int(re.search(rf"{name} = (\d+)", src).group(1))  # noqa: E731
    assert const("kThreads") == cv.THREADS
    assert const("kSums") == cv.N_SUMS
    assert const("kTail") == cv.TAIL
    assert const("kNPointers") == len(cv.POINTERS)
    assert const("kNInts") == len(cv.INTS)
    assert "kSums + kParams + kWarps * 7" in src and cv.N_PARTIALS == 7
    assert cv.shared_bytes(397, 4) == 8 * (8 + 8 + 16 * 7) + 4 * 8 * 397


def test_card_entry_refuses_a_cpu_tensor():
    """The kernel's entry point takes CUDA tensors only: a CPU tensor is
    refused before any build, never run through the plain version."""
    p = _problem("fixed-free-n41")
    params = cv.make_params(p["tt"], p["center"])
    dpsi = torch.as_tensor(p["zetas"] @ p["wh_t"].W.numpy().T)
    with pytest.raises(ValueError, match="CUDA device"):
        cv.centered_fn_vg_cuda(dpsi, params)


def test_cpu_route_launches_no_kernel():
    """The plain version runs on CPU tensors; the launch count stays."""
    p = _problem("fixed-free-n41")
    before = dict(cuda_band.KERNEL_LAUNCHES)
    tw.make_centered_whitened_vg(p["tt"], p["wh_t"])(torch.as_tensor(p["zetas"]))
    assert cuda_band.KERNEL_LAUNCHES == before


def test_solve_magi_runs_the_kernel_route():
    """solve_magi on whitened banded FN (the CPU) takes the route and meets
    tests/test_torch_solve.py's loose recovery bars."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
        integrate_system, sample_on_grid,
    )

    rng = np.random.default_rng(0)
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, 8.0, THETA, 800)
    t = np.linspace(0.0, 8.0, 21)
    y = sample_on_grid(ts.numpy(), xs.numpy(), t) + 0.1 * rng.normal(size=(21, 2))
    config = mt.MagiConfig(
        niter_hmc=120, burnin_ratio=0.5, step_size_factor=0.06, n_chains=4,
        mass_matrix="dense-pooled", chain_init_jitter=0.05, x_whitened=True,
        theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125, seed=7,
        chunk_size=40, band_impl="band", device="cpu",
    )
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    assert res.diagnostics["vg_route"] == "kernel"
    assert np.all(np.abs(res.theta.mean(0) - THETA) < np.array([0.2, 0.3, 0.8]))
    assert np.all(np.abs(res.sigma.mean(0) - 0.1) < 0.08)
    assert np.sqrt(np.nanmean((res.x_sampled.mean(0) - y) ** 2)) < 0.3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sampled-bounded", "fixed-free-masked"])
def test_cuda_kernel_matches_the_plain_version(cuda_device, name):
    p = _problem(name)
    tt = dataclasses.replace(p["tt"], data=type(p["tt"].data)(
        *(a.to(cuda_device) for a in p["tt"].data)))
    params = cv.make_params(tt, p["center"])
    dpsi = torch.as_tensor(p["zetas"] @ p["wh_t"].W.numpy().T, device=cuda_device)
    before = cuda_band.KERNEL_LAUNCHES[cv.NAME]
    got = cv.centered_fn_vg(dpsi, params)
    want = cv.centered_fn_vg_torch(dpsi, params)
    torch.cuda.synchronize()
    assert cuda_band.KERNEL_LAUNCHES[cv.NAME] == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
