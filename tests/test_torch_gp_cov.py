"""PyTorch port, GP setup: kernels, band utilities and every GPCov field
equal the JAX package's to rel 1e-10, on the band-impl test problem and on
the n = 397 bench grid (where the band escalates 20 -> 40)."""
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
    assert tk.parse_kernel_type("matern52") == ("matern52", None)
    for name in ("rbf", "matern-1.5"):
        with pytest.raises(NotImplementedError, match="M14"):
            tk.parse_kernel_type(name)
    with pytest.raises(ValueError):
        tk.parse_kernel_type("cosine")


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
