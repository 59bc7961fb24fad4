"""PyTorch port, the remaining model families end to end on the CPU:
mirrors of the JAX package's tests/test_model_families_e2e.py (ptrans, hiv,
hes1log_fixg with the MAP warm start, theta constrained and
gp_mean="observed"), on the same data (``perf/workload.family_problem``,
checked against the JAX test's generator) and under the same assertions."""
import numpy as np
import pytest
import torch

import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
    FAMILY_CASES,
    family_problem,
)

torch.set_num_threads(1)


def test_family_data_matches_the_jax_test():
    import test_model_families_e2e as jtest

    from manifold_constrained_gaussian_process_inference_tpu.models import base as jbase

    for name, case in FAMILY_CASES.items():
        _, y, t, options = family_problem(name)
        t_j, y_j = jtest._make_data(jbase.get_system(name), case["x0"], case["theta"],
                                    case["t_end"], case["n_obs"], case["noise"],
                                    n_steps=case["n_steps"])
        np.testing.assert_allclose(t, t_j, rtol=1e-14)
        np.testing.assert_allclose(y, y_j, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_family_e2e_smoke(name):
    system, y, t, options = family_problem(name)
    res = mt.solve_magi(y, t, system, mt.MagiConfig(device="cpu", **options))
    n_keep = options["niter_hmc"] // 2
    assert res.theta.shape == (n_keep, system.theta_size)
    for a in (res.theta, res.x_sampled, res.lp):
        assert np.all(np.isfinite(a))
    if FAMILY_CASES[name]["positive"]:
        assert np.all(res.theta > 0)
    assert res.diagnostics["phase_times_s"]["map_s"] > 0
