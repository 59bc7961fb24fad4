"""The JAX package at chip_smoke.py's cuts of config 3 (parallel tempering,
[pt]) and config 7 (ChEES under SNAPER, [chees]), on the smoke's own data:
the reference readings that the smoke's mixing bars at those cuts are set
from (PERF.md).

    python -m tests.test_torch_reference_cuts {pt,chees} SEED [SEED ...]

runs the JAX package's ``solve_magi`` on the CPU in float64 with the
smoke's configuration and sampler seed SEED (the data stay the smoke's) and
prints one JSON line per run: for pt, theta RMSE, unobserved-H RMSE, pooled
swap acceptance, cold-rung accept and divergent share; for chees, max
split R-hat of theta, theta RMSE, trajectory length, accept and divergent
share. Each line carries its wall time. The test below holds the runs to
the smoke's configurations, so that the readings stay those of its cuts.
"""
import json
import os
import sys
import time

import numpy as np

import chip_smoke as smoke


def _data(kind):
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import workload

    if kind == "pt":
        t, y, x_truth = workload.hes1_workload(seed=smoke.PT_SEED)
        return y, t, x_truth
    y, t = workload.fn_bench_workload()
    return y, t, None


def _config(kind, y, t, seed):
    return smoke.pt_config(seed) if kind == "pt" else smoke.chees_config(y, t, seed)


def reference_run(kind: str, seed: int) -> dict:
    """One run of the JAX package at the smoke's cut of config 3 or 7."""
    import manifold_constrained_gaussian_process_inference_tpu as jmagi
    from manifold_constrained_gaussian_process_inference_tpu.models import (
        FN_SYSTEM, HES1LOG_FIXF_SYSTEM,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        HES1_THETA_TRUE_FIXF, THETA_TRUE,
    )

    y, t, x_truth = _data(kind)
    config = jmagi.MagiConfig(**_config(kind, y, t, seed))
    t0 = time.perf_counter()
    res = jmagi.solve_magi(y, t, HES1LOG_FIXF_SYSTEM if kind == "pt" else FN_SYSTEM, config)
    d = res.diagnostics
    out = dict(kind=kind, seed=seed, niter_hmc=config.niter_hmc,
               wall_s=time.perf_counter() - t0,
               accept=float(np.mean(d["accept_prob"])),
               divergent_share=float(np.mean(d["diverging"])))
    if kind == "pt":
        out.update(theta_rmse=smoke.rmse(res.theta.mean(0), HES1_THETA_TRUE_FIXF),
                   h_rmse=smoke.rmse(res.x_sampled[:, :, 2].mean(0), x_truth[:, 2]),
                   swap_acceptance=float(d["swap_acceptance"]))
    else:
        out.update(max_rhat=smoke.max_rhat(d["theta_per_chain"]),
                   theta_rmse=smoke.rmse(res.theta.mean(0), THETA_TRUE),
                   trajectory_length=float(d["trajectory_length"]))
    return out


def test_reference_runs_take_the_smokes_configs():
    """Both packages' MagiConfig take the smoke's [pt] and [chees]
    arguments and hold them alike, at the smoke's cuts."""
    import manifold_constrained_gaussian_process_inference_tpu as jmagi
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt

    for kind, niter in (("pt", smoke.PT_NITER), ("chees", smoke.CHEES_NITER)):
        y, t, _ = _data(kind)
        args = _config(kind, y, t, seed=3)
        j, p = jmagi.MagiConfig(**args), mt.MagiConfig(**args, device="cpu")
        assert j.niter_hmc == p.niter_hmc == niter and j.seed == p.seed == 3
        for name, value in args.items():
            np.testing.assert_array_equal(getattr(j, name), value, err_msg=name)
            np.testing.assert_array_equal(getattr(p, name), value, err_msg=name)
    assert smoke.pt_config()["sampler"] == "pt-nuts" and smoke.pt_config()["seed"] == smoke.PT_SEED
    assert smoke.chees_config(y, t, 0)["n_chains"] == smoke.CHEES_CHAINS


if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    kind, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    for s in seeds:
        print(json.dumps(reference_run(kind, s)), flush=True)
