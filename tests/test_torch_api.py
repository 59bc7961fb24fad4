"""PyTorch port, the public API: every name the JAX package's packages
export imports from the same path in the port, ``wrap_value_and_grad``
and ``band_storage_matvec`` match the JAX package's (rtol 1e-12), the
non-finite guards of utils/debugging.py pass values through and report a
NaN, and ``profile_dir`` leaves a torch.profiler trace of the sampling
phase and the port's tracer's spans (a Chrome trace) in its directory."""
import importlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu as jm
from manifold_constrained_gaussian_process_inference_tpu.inference import whiten as jw
from manifold_constrained_gaussian_process_inference_tpu.ops import band as jband
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import whiten as tw
from manifold_constrained_gaussian_process_inference_tpu_torch.ops import band as tband
from manifold_constrained_gaussian_process_inference_tpu_torch.utils import debugging

torch.set_num_threads(1)
JAX, PORT = jm.__name__, mt.__name__
RTOL = 1e-12
# the JAX package's top-level names it loads on first use (its __getattr__)
LAZY = ("solve_magi", "MagiResult", "magi_summary", "results_to_chain", "plot_magi")


def _public(module) -> set:
    """A module's public names that are not modules (submodules differ:
    the port has ops/cuda_band.py where the JAX package has
    ops/pallas_band.py)."""
    return {name for name in dir(module) if not name.startswith("_")
            and not isinstance(getattr(module, name), types.ModuleType)}


@pytest.mark.parametrize("path", ["", ".inference", ".ops", ".parallel", ".models",
                                  ".postprocess"])
def test_every_exported_name_imports_from_the_same_path(path):
    jmod = importlib.import_module(JAX + path)
    tmod = importlib.import_module(PORT + path)
    want = _public(jmod) | (set(LAZY) if not path else set())
    missing = sorted(name for name in want if not hasattr(tmod, name))
    assert not missing, f"{PORT + path} lacks {missing}"
    if path == ".inference":
        assert len(want) == 26 and tmod.run_nuts_sampler is tmod.run_nuts


@pytest.mark.parametrize("path,names", [
    (".utils.debugging", ("nan_guard", "checkify_value_and_grad")),
    (".inference.whiten", ("wrap_value_and_grad", "zeta_to_psi_np", "psi_to_zeta_np")),
    (".ops.band", ("band_storage_matvec", "dense_to_band_storage", "mat2band", "band_mask")),
    (".parallel.chains", ("CurvatureEnvelope", "run_chains", "make_chain_mesh",
                          "pooled_dense_metric_from_moments")),
])
def test_module_names_import_from_the_same_path(path, names):
    for name in names:
        assert hasattr(importlib.import_module(JAX + path), name)
        assert hasattr(importlib.import_module(PORT + path), name), f"{PORT + path}.{name}"


def test_lazy_top_level_names():
    assert mt.plot_magi is importlib.import_module(PORT + ".postprocess").plot_magi
    assert mt.magi_summary is importlib.import_module(PORT + ".postprocess").magi_summary
    with pytest.raises(AttributeError):
        mt.no_such_name  # noqa: B018


def _scaled_sin(xp):
    s = xp.asarray(np.linspace(0.5, 2.0, 6))

    def vg(psi):
        value = -0.5 * (s * psi * psi).sum(-1) + xp.sin(psi).sum(-1)
        return value, -s * psi + xp.cos(psi)

    return vg


def test_wrap_value_and_grad_matches_jax():
    rng = np.random.default_rng(0)
    w = np.eye(6) + 0.3 * rng.normal(size=(6, 6))
    center = rng.normal(size=6)
    zeta = rng.normal(size=(3, 6))
    jwhite = jw.PsiWhitener(W=jnp.asarray(w), L_T=jnp.asarray(np.linalg.inv(w)),
                            center=jnp.asarray(center))
    twhite = tw.PsiWhitener.from_numpy(w, np.linalg.inv(w), center)
    jvg = jw.wrap_value_and_grad(_scaled_sin(jnp), jwhite)
    tvg = tw.wrap_value_and_grad(_scaled_sin(torch), twhite)
    v_t, g_t = tvg(torch.as_tensor(zeta))
    for c in range(3):  # the JAX package's takes one zeta at a time
        v_j, g_j = jvg(jnp.asarray(zeta[c]))
        np.testing.assert_allclose(float(v_t[c]), float(v_j), rtol=RTOL)
        np.testing.assert_allclose(g_t[c].numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-14)
    v_1, g_1 = tvg(torch.as_tensor(zeta[0]))
    np.testing.assert_allclose(g_1.numpy(), g_t[0].numpy(), rtol=RTOL, atol=1e-14)


def test_band_storage_matvec_matches_jax():
    rng = np.random.default_rng(1)
    n, b = 30, 4
    a = rng.normal(size=(n, n)) * (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b)
    band = jband.dense_to_band_storage(a, b)
    x = rng.normal(size=(3, n))
    # the JAX package's takes one x (its rolls flatten a batch)
    want = np.stack([np.asarray(jband.band_storage_matvec(jnp.asarray(band), jnp.asarray(row), b))
                     for row in x])
    got = tband.band_storage_matvec(torch.as_tensor(band), torch.as_tensor(x), b).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(got, x @ a.T, rtol=1e-10, atol=1e-12)
    stacked = tband.band_storage_matvec(torch.as_tensor(band)[None], torch.as_tensor(x)[:, None],
                                        b)[:, 0]
    np.testing.assert_array_equal(stacked.numpy(), got)


def _vg_with_nan(psi):
    value = -0.5 * (psi * psi).sum(-1)
    grad = -psi.clone()
    bad = psi[..., 0] > 10.0
    value = torch.where(bad, torch.nan, value)
    grad[bad, 1] = torch.inf
    return value, grad


def test_nan_guard_passes_values_through_and_counts_a_nan():
    guarded = debugging.nan_guard(_vg_with_nan, name="test")
    clean = torch.zeros((3, 2), dtype=torch.float64)
    for _ in range(2):
        v, g = guarded(clean)
        assert torch.equal(v, _vg_with_nan(clean)[0]) and torch.equal(g, -clean)
    assert guarded.report() == {"n_bad": 0, "n_bad_grad": 0}
    dirty = torch.tensor([[11.0, 1.0], [0.5, 0.5], [12.0, 0.0]], dtype=torch.float64)
    v, g = guarded(dirty)
    want_v, want_g = _vg_with_nan(dirty)
    torch.testing.assert_close(v, want_v, equal_nan=True, rtol=0, atol=0)
    torch.testing.assert_close(g, want_g, equal_nan=True, rtol=0, atol=0)
    assert guarded.report() == {"n_bad": 2, "n_bad_grad": 2}


def test_nan_guard_passes_values_through_like_the_jax_package():
    """tests/test_checkpoint.py's test_nan_guard_passthrough in the port."""
    from manifold_constrained_gaussian_process_inference_tpu.utils.debugging import (
        nan_guard as jnan_guard,
    )

    psi = np.array([1.0, -2.0, 0.5])
    jv, jg = jnan_guard(jax.value_and_grad(lambda p: -0.5 * jnp.sum(p ** 2)))(jnp.asarray(psi))
    tv, tg = debugging.nan_guard(lambda p: (-0.5 * (p * p).sum(-1), -p))(torch.as_tensor(psi))
    assert float(tv) == float(jv)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_checkify_value_and_grad_reports_a_nan():
    checked = debugging.checkify_value_and_grad(_vg_with_nan)
    err, (v, g) = checked(torch.zeros((2, 2), dtype=torch.float64))
    assert err.get() is None
    err.throw()
    err, (v, g) = checked(torch.tensor([[11.0, 0.0], [0.0, 0.0]], dtype=torch.float64))
    assert err.get() == "non-finite log-density; non-finite gradient entries"
    assert torch.isnan(v[0]) and torch.isinf(g[0, 1])
    with pytest.raises(FloatingPointError, match="non-finite log-density"):
        err.throw()


def test_profile_dir_leaves_a_trace_of_the_sampling_phase(tmp_path):
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2))
    base = dict(niter_hmc=20, seed=3, sigma=[0.2, 0.2], phi=np.array([[1.0, 1.0], [1.5, 1.5]]),
                x_whitened=True, device="cpu", n_chains=2, mass_matrix="dense-pooled")
    prof = str(tmp_path / "prof")
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**base, profile_dir=prof))
    files = sorted(os.listdir(prof))
    assert len(files) == 2 and files[0].startswith("magi_rank0.")
    assert files[0].endswith(".pt.trace.json")
    with open(os.path.join(prof, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # beside it the port's tracer's spans, one Chrome trace
    assert files[1] == "magi_spans_rank0.json"
    with open(os.path.join(prof, files[1])) as f:
        spans = json.load(f)
    names = {e["name"] for e in spans["traceEvents"] if e["ph"] == "X"}
    assert {"warmup", "sampling", "transition", "transition.prologue", "doubling.launch",
            "doubling.readout", "sample_step"} <= names
    assert spans["otherData"]["sections"]["all"]["transitions"] == 20
    # tracing changes no draw
    plain = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(**base))
    np.testing.assert_array_equal(res.theta, plain.theta)
    np.testing.assert_array_equal(res.lp, plain.lp)
