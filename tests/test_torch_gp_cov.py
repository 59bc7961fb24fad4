"""PyTorch port, GP setup: kernels (Matern-5/2, RBF, general Matern of any
nu with its Bessel-K autograd Function), band utilities and every GPCov
field equal the JAX package's to rel 1e-10, on the band-impl test problem
and on the n = 397 bench grid (where the band escalates 20 -> 40), and the
NLML objective for every kernel."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.ops import band as jband
from manifold_constrained_gaussian_process_inference_tpu.ops import gp_cov as jgp
from manifold_constrained_gaussian_process_inference_tpu.ops import kernels as jk
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import band as tband
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import gp_cov as tgp
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

FIELDS = [f for f in jgp.GPCov._fields if f != "bandsize"]


def _bench_grid(n_obs=100, t_end=20.0, fill=2):
    t_obs = np.linspace(0.0, t_end, n_obs)
    ins = 2**fill - 1
    segs = [np.linspace(t_obs[i], t_obs[i + 1], ins + 2)[:-1] for i in range(n_obs - 1)]
    return np.concatenate(segs + [t_obs[-1:]])


CASES = {
    # test_band_impl.py::problem
    "band-impl-problem": (np.linspace(0, 8, 40), np.array([[1.5, 1.5], [1.0, 1.0]]), 6),
    # n = 397 bench grid with NLML-scale hyperparameters: escalates 20 -> 40
    "bench-n397": (_bench_grid(), np.array([[1.9893, 0.631], [1.125, 2.5398]]), 20),
}


def _assert_fields_equal(got, want):
    assert got.bandsize == want.bandsize
    for name in FIELDS:
        w = np.asarray(getattr(want, name), dtype=np.float64)
        g = getattr(got, name).numpy()
        scale = max(np.max(np.abs(w)), 1e-300)
        assert np.max(np.abs(g - w)) <= 1e-10 * scale, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_gp_cov_matches_jax(case):
    t, phi, band = CASES[case]
    want = jm.build_gp_cov("matern52", phi, t, bandsize=band, complexity=2, jitter=1e-6)
    got = tgp.build_gp_cov("matern52", phi, t, bandsize=band, complexity=2, jitter=1e-6)
    _assert_fields_equal(got, want)
    if case == "bench-n397":
        assert got.bandsize == 40


def test_gp_cov_from_numpy_and_to():
    t, phi, band = CASES["band-impl-problem"]
    want = jm.build_gp_cov("matern52", phi, t, bandsize=band)
    got = tgp.GPCov.from_numpy(want)
    _assert_fields_equal(got, want)
    f32 = got.to(dtype=torch.float32)
    assert f32.Kinv.dtype == torch.float32 and f32.bandsize == got.bandsize
    assert got.n_times == 40 and got.n_dims == 2


def test_matern52_blocks_match_jax():
    t = np.linspace(0, 5, 23)
    for got, want in zip(tk.matern52_cov_blocks(t, 1.7, 0.8), jk.matern52_cov_blocks(t, 1.7, 0.8)):
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        tk.kernel_matrix("matern52", t, 1.7, 0.8), jk.kernel_matrix("matern52", t, 1.7, 0.8),
        rtol=1e-13,
    )
    np.testing.assert_allclose(
        tk.cov_blocks("matern52", t, 1.7, 0.8)[2], jk.cov_blocks("matern52", t, 1.7, 0.8)[2],
        rtol=1e-13,
    )


def test_kernel_matrix_torch_inputs_match_numpy():
    t = np.linspace(0, 5, 11)
    got = tk.kernel_matrix("matern52", torch.as_tensor(t), torch.tensor(1.3, dtype=torch.float64),
                           torch.tensor(0.7, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), tk.kernel_matrix("matern52", t, 1.3, 0.7), rtol=1e-14)


def test_parse_kernel_type():
    for name in ("matern52", "rbf", "matern-1.5", "matern-2.3", "matern-0.5"):
        assert tk.parse_kernel_type(name) == jk.parse_kernel_type(name)
    for bad in ("cosine", "matern-0", "matern--1"):
        with pytest.raises(ValueError):
            tk.parse_kernel_type(bad)


KERNELS = ["rbf", "matern-1.5", "matern-2.3"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_cov_blocks_match_jax(kernel):
    t = np.linspace(0, 5, 23)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tk.cov_blocks(kernel, t, 1.7, 0.8)
    # the general Matern has no derivative blocks: zeros, with a warning
    assert bool(caught) == kernel.startswith("matern-")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jk.cov_blocks(kernel, t, 1.7, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-14)
    if kernel.startswith("matern-"):
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("kernel", KERNELS)
def test_build_gp_cov_matches_jax_for_kernel(kernel):
    t, phi, band = CASES["band-impl-problem"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jm.build_gp_cov(kernel, phi, t, bandsize=band, complexity=2, jitter=1e-6)
        got = tgp.build_gp_cov(kernel, phi, t, bandsize=band, complexity=2, jitter=1e-6)
    _assert_fields_equal(got, want)
    if kernel.startswith("matern-"):  # Kphi collapses to jitter * I
        np.testing.assert_array_equal(got.Kphi.numpy(), np.stack([1e-6 * np.eye(len(t))] * 2))
        assert not got.mphi.numpy().any()


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.0, 2.3, 3.7])
def test_general_matern_matches_jax(nu):
    r = np.linspace(0, 3, 17)
    want = np.asarray(jk.general_matern_k(r, 0.8, 1.1, nu))
    np.testing.assert_allclose(tk.general_matern_k(r, 0.8, 1.1, nu), want, rtol=1e-12)
    got_t = tk.general_matern_k(torch.as_tensor(r), 0.8, 1.1, nu)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-12)
    assert tk.general_matern_k(0.0 * r, 0.8, 1.1, nu)[0] == 0.8
    with pytest.raises(ValueError):
        tk.general_matern_k(r, 1.0, 1.0, -1.0)


def test_bessel_function_gradcheck():
    z = torch.linspace(0.3, 4.0, 9, dtype=torch.float64, requires_grad=True)
    for nu in (0.7, 2.3):
        assert torch.autograd.gradcheck(lambda a: tk.BesselKv.apply(a, nu), (z,))
    # through the kernel, including r = 0 (the double where keeps it finite)
    log_ell = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    t = torch.linspace(0.0, 2.0, 7, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda le: tk.kernel_matrix("matern-2.0", t, 1.0, torch.exp(le)).sum(), (log_ell,)
    )
    c = tk.kernel_matrix("matern-2.0", t, 1.0, torch.exp(log_ell))
    (g,) = torch.autograd.grad(c.sum(), log_ell)
    jv, jg = jax.value_and_grad(
        lambda le: jnp.sum(jk.kernel_matrix("matern-2.0", jnp.asarray(t.numpy()), 1.0, jnp.exp(le)))
    )(jnp.asarray(0.1))
    np.testing.assert_allclose(float(c.sum().detach()), float(jv), rtol=1e-12)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-10)


@pytest.mark.parametrize("kernel", ["rbf", "matern-2.0"])
def test_nlml_matches_jax_for_kernel(kernel):
    from manifold_constrained_gaussian_process_inference_tpu.inference import nlml as jnlml
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference import nlml as tnlml

    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, 31)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.1 * rng.normal(size=(31, 2))
    lps = np.log(np.array([[1.0, 1.5, 0.1], [0.7, 2.0, 0.2]]))
    got = tnlml.negative_log_marginal_likelihood(
        torch.as_tensor(lps), torch.as_tensor(y.T), torch.ones(2, 31, dtype=torch.float64),
        torch.as_tensor(t), kernel,
    ).numpy()
    for d in range(2):
        want = float(jnlml.negative_log_marginal_likelihood(lps[d], y[:, d], np.ones(31), t,
                                                              kernel))
        np.testing.assert_allclose(got[d], want, rtol=1e-10)
    out = tnlml.optimize_gp_hyperparameters(y[:, :1], t, kernel, max_iters=20)
    assert out.shape == (1, 3) and np.all(np.isfinite(out)) and np.all(out > 0)


def test_band_utilities_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(15, 15))
    np.testing.assert_array_equal(tband.band_mask(15, 2, 3), jband.band_mask(15, 2, 3))
    np.testing.assert_array_equal(tband.mat2band(a, 3, 3), jband.mat2band(a, 3, 3))
    np.testing.assert_array_equal(
        tband.mat2band(torch.as_tensor(a), 3, 3).numpy(), jband.mat2band(a, 3, 3)
    )
    for b in (0, 3, 20):
        np.testing.assert_array_equal(
            tband.dense_to_band_storage(a, b), jband.dense_to_band_storage(a, b)
        )


@pytest.mark.parametrize("jitter", [1e-6, 1e-2])
def test_spd_helpers_match_jax(jitter):
    rng = np.random.default_rng(1)
    m = rng.normal(size=(12, 12))
    spd = m @ m.T + 0.1 * np.eye(12)
    for got, want in zip(tgp.robust_spd_inverse(spd, jitter), jgp.robust_spd_inverse(spd, jitter)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    indef = tband.mat2band(np.linalg.inv(spd), 2, 2)
    got_l, got_s = tgp.banded_cholesky(indef, 2)
    want_l, want_s = jgp.banded_cholesky(indef, 2)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-12, atol=1e-14)
    assert got_s == want_s
