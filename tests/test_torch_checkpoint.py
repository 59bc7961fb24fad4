"""PyTorch port, checkpoint/resume: the checkpoint round-trips; a run
resumed from a checkpoint equals the uninterrupted run bit for bit (NUTS
after a sampling chunk, the pooled NUTS warmup killed midway, PT under
both metrics, ChEES, and NUTS through solve_magi); a checkpoint of another
dimension, schedule or device type is refused, and so is the JAX
package's; and a JAX package checkpoint converted by from_jax_checkpoint
resumes in both packages with the same frozen step sizes, metrics, ladder
and trajectory length."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manifold_constrained_gaussian_process_inference_tpu.inference import checkpoint as jck
from manifold_constrained_gaussian_process_inference_tpu.inference import chees as jch
from manifold_constrained_gaussian_process_inference_tpu.inference import tempering as jt
import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.config import MagiError
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import checkpoint as ck
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import chees as tch
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import tempering as tt
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains as tc

torch.set_num_threads(1)
A = np.array([[1.0, 0.8], [0.8, 1.0]])
PREC = np.linalg.inv(A)


def _vg(q):
    g = -q @ torch.as_tensor(PREC)
    return 0.5 * (q * g).sum(-1), g


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _snapshot(monkeypatch, module, name, want):
    """Wrap ``module.name`` (a checkpoint writer) so that the first
    checkpoint accepted by ``want`` is kept; returns the dict it lands in."""
    real = getattr(module, name)
    kept = {}

    def capture(path, ckpt):
        if "ckpt" not in kept and want(ckpt):
            kept["ckpt"] = ckpt
        real(path, ckpt)

    monkeypatch.setattr(module, name, capture)
    return kept


def test_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    state, _ = ck.generator_state(_gen(3))
    ckpt = ck.SamplerCheckpoint(
        psi=rng.normal(size=(2, 3)), step_size=np.array([0.5, 0.6]), inv_mass=np.ones((2, 3)),
        rng_state=state, rng_device="cpu", n_samples_drawn=40, meta={"metric": "diag"},
        phase="warmup", state={"logp": rng.normal(size=2), "grad": rng.normal(size=(2, 3))},
        warmup={"pos": 25, "carry": {n: rng.normal(size=2) for n in ck.WARMUP_CARRY_FIELDS},
                "metric_minv": np.eye(3), "metric_chol": np.eye(3), "metric_pchol": np.eye(3),
                "moments": [tuple(rng.normal(size=s) for s in ((), (3,), (3, 3), (), ()))] * 2,
                "div": rng.uniform(size=(2, 25)) < 0.1},
    )
    ck.save_checkpoint(str(tmp_path / "c.npz"), ckpt)
    back = ck.load_checkpoint(str(tmp_path / "c.npz"))
    for field in ("psi", "step_size", "inv_mass", "rng_state"):
        np.testing.assert_array_equal(getattr(back, field), getattr(ckpt, field))
    assert (back.rng_device, back.n_samples_drawn, back.meta, back.phase) == \
        ("cpu", 40, {"metric": "diag"}, "warmup")
    for name in ("logp", "grad"):
        np.testing.assert_array_equal(back.state[name], ckpt.state[name])
    assert back.warmup["pos"] == 25 and len(back.warmup["moments"]) == 2
    for name in ck.WARMUP_CARRY_FIELDS:
        np.testing.assert_array_equal(back.warmup["carry"][name], ckpt.warmup["carry"][name])
    for got, want in zip(back.warmup["moments"][1], ckpt.warmup["moments"][1]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(back.warmup["div"], ckpt.warmup["div"])
    gen = ck.restore_generator(back.rng_state, back.rng_device, "cpu")
    np.testing.assert_array_equal(torch.rand(4, generator=gen), torch.rand(4, generator=_gen(3)))


@pytest.mark.parametrize("mass_matrix,jitter", [("diag", 0.0), ("dense-pooled", 0.25)])
def test_nuts_sampling_resume_is_bit_identical(monkeypatch, tmp_path, mass_matrix, jitter):
    """Killed after its first sampling chunk, resumed for the rest: the
    draws, lp and stats equal the uninterrupted run's exactly."""
    psi0 = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 2)) * 0.1)
    kw = dict(n_samples=140, n_adapts=80, chunk_size=20, mass_matrix=mass_matrix,
              step_jitter=jitter)
    kept = _snapshot(monkeypatch, ck, "save_checkpoint", lambda c: c.phase == "sampling")
    s_full, info = tc.run_chains(_vg, psi0, _gen(7), jitter_rng=np.random.default_rng(5),
                                 checkpoint_path=str(tmp_path / "full.npz"), **kw)
    first = kept["ckpt"]
    assert first.n_samples_drawn == 3 * 20
    ck.save_checkpoint(str(tmp_path / "snap.npz"), first)
    s_res, info_res, last = ck.run_chains_resumed(_vg, ck.load_checkpoint(str(tmp_path / "snap.npz")),
                                                  40, dtype=torch.float64, device="cpu",
                                                  chunk_size=20)
    np.testing.assert_array_equal(s_full[:, 20:], s_res)
    for key in ("lp", "accept_prob", "num_leapfrog", "diverging"):
        np.testing.assert_array_equal(info[key][:, 20:], info_res[key])
    for key in ("step_size", "inv_mass", "final_psi"):
        np.testing.assert_array_equal(info[key], info_res[key])
    assert last.n_samples_drawn == 3 * 60
    np.testing.assert_array_equal(last.psi, info["final_psi"])


def test_pooled_warmup_resume_is_bit_identical(monkeypatch, tmp_path):
    """Killed mid-warmup (a window's moments half accumulated), resumed
    with the same arguments: bit-identical draws, step sizes, metric,
    warmup divergences and lp; a different n_adapts or chunk_size, or a
    sampling-phase checkpoint, is refused."""
    psi0 = torch.as_tensor(np.random.default_rng(1).normal(size=(4, 2)) * 0.1)
    # windows end at 100 and 150: chunks end at 30, 60, 75, 100, 130, 150, ...
    kw = dict(n_samples=260, n_adapts=200, mass_matrix="dense-pooled", chunk_size=30,
              step_jitter=0.25)
    kept = _snapshot(monkeypatch, ck, "save_checkpoint",
                     lambda c: c.phase == "warmup" and 100 < c.warmup["pos"] < 150)
    s_full, info_full = tc.run_chains(_vg, psi0, _gen(7), checkpoint_path=str(tmp_path / "f.npz"),
                                      **kw)
    ck.save_checkpoint(str(tmp_path / "mid.npz"), kept["ckpt"])
    mid = ck.load_checkpoint(str(tmp_path / "mid.npz"))
    assert mid.phase == "warmup" and mid.meta["n_adapts"] == 200
    assert mid.warmup["pos"] == 130 and len(mid.warmup["moments"]) == 1
    s_res, info_res = tc.run_chains(_vg, psi0, _gen(123), resume_ckpt=mid, **kw)
    np.testing.assert_array_equal(s_full, s_res)
    for key in ("step_size", "inv_mass", "warmup_diverging", "lp"):
        np.testing.assert_array_equal(info_full[key], info_res[key])
    for change in (dict(n_adapts=150), dict(chunk_size=40)):
        with pytest.raises(MagiError, match="n_adapts|chunk_size"):
            tc.run_chains(_vg, psi0, _gen(7), resume_ckpt=mid, **{**kw, **change})
    with pytest.raises(ValueError, match="mid-warmup"):
        ck.run_chains_resumed(_vg, mid, 10, device="cpu")
    sampling = ck.load_checkpoint(str(tmp_path / "f.npz"))
    with pytest.raises(ValueError, match="warmup-phase"):
        tc.run_chains(_vg, psi0, _gen(7), resume_ckpt=sampling, **kw)


@pytest.mark.parametrize("mass_matrix,n_rep", [("diag", 1), ("dense-pooled", 2)])
def test_pt_resume_is_bit_identical(monkeypatch, tmp_path, mass_matrix, n_rep):
    kw = dict(n_samples=150, n_adapts=90, n_temps=3, max_temp=8.0, chunk_size=20,
              n_replicas=n_rep, mass_matrix=mass_matrix)
    kept = _snapshot(monkeypatch, tt, "save_pt_checkpoint", lambda c: True)
    s_full, info = tt.run_parallel_tempering(_vg, torch.zeros(2, dtype=torch.float64), _gen(3),
                                             checkpoint_path=str(tmp_path / "pt.npz"), **kw)
    tt.save_pt_checkpoint(str(tmp_path / "snap.npz"), kept["ckpt"])
    snap = tt.load_pt_checkpoint(str(tmp_path / "snap.npz"))
    assert int(snap["n_samples_drawn"]) == 20
    s_res, info_res, last = tt.run_parallel_tempering_resumed(
        _vg, snap, 40, chunk_size=20, dtype=torch.float64, device="cpu")
    axis = 0 if n_rep == 1 else 1
    np.testing.assert_array_equal(np.take(s_full, np.arange(20, 60), axis=axis), s_res)
    for key in ("lp", "diverging", "accept_prob"):
        np.testing.assert_array_equal(info[key][20:], info_res[key])
    for key in ("swap_acceptance_per_pair", "temperatures", "step_size", "inv_mass", "final_psi"):
        np.testing.assert_array_equal(info[key], info_res[key])
    assert int(last["n_samples_drawn"]) == 60


def test_chees_resume_is_bit_identical(monkeypatch, tmp_path):
    kept = _snapshot(monkeypatch, ck, "save_checkpoint", lambda c: True)
    s_full, info = tch.run_chees(_vg, torch.zeros((6, 2), dtype=torch.float64), _gen(4),
                                 n_samples=160, n_adapts=100, chunk_size=20,
                                 checkpoint_path=str(tmp_path / "ch.npz"))
    snap = kept["ckpt"]
    assert snap.meta["sampler"] == "chees" and snap.meta["iteration"] == 120
    assert snap.meta["trajectory_length"] == info["trajectory_length"]
    ck.save_checkpoint(str(tmp_path / "snap.npz"), snap)
    s_res, info_res, last = tch.run_chees_resumed(
        _vg, ck.load_checkpoint(str(tmp_path / "snap.npz")), 40, chunk_size=20,
        dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(s_full[:, 20:], s_res)
    for key in ("lp", "accept_prob", "num_leapfrog"):
        np.testing.assert_array_equal(info[key][:, 20:], info_res[key])
    assert last.meta["iteration"] == 160 and last.n_samples_drawn == 6 * 60


def _fn_problem():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    return np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2)), t


FN_BASE = dict(sigma=[0.2, 0.2], phi=np.array([[1.0, 1.0], [1.5, 1.5]]), device="cpu")


def test_solve_magi_resume_equals_uninterrupted(tmp_path):
    """A checkpointed run plus a resumed leg through solve_magi equals the
    uninterrupted run bit for bit (the JAX package's same test allows
    1e-9; here the resumed leg restores lp and gradients instead of
    re-evaluating them). A path and a loaded object resume identically."""
    y, t = _fn_problem()
    base = dict(seed=3, n_chains=2, chain_init_jitter=0.1, mass_matrix="dense-pooled",
                x_whitened=True, **FN_BASE)
    res_long = mt.solve_magi(y, t, mt.FN_SYSTEM,
                             mt.MagiConfig(niter_hmc=60, burnin_ratio=1 / 3, **base))
    path = str(tmp_path / "resume.npz")
    short = mt.MagiConfig(niter_hmc=40, burnin_ratio=0.5, checkpoint_path=path, **base)
    res_short = mt.solve_magi(y, t, mt.FN_SYSTEM, short)
    more = dataclasses.replace(short, niter_hmc=20, checkpoint_path=None)
    res_more = mt.solve_magi(y, t, mt.FN_SYSTEM, more, resume=path)
    th_long = res_long.diagnostics["theta_per_chain"]
    np.testing.assert_array_equal(th_long[:, :20], res_short.diagnostics["theta_per_chain"])
    np.testing.assert_array_equal(th_long[:, 20:], res_more.diagnostics["theta_per_chain"])
    np.testing.assert_array_equal(res_long.diagnostics["lp_per_chain"][:, 20:],
                                  res_more.diagnostics["lp_per_chain"])
    res_obj = mt.solve_magi(y, t, mt.FN_SYSTEM, more, resume=ck.load_checkpoint(path))
    np.testing.assert_array_equal(res_more.theta, res_obj.theta)
    # a finished result makes a checkpoint too
    from_result = ck.checkpoint_from_result(res_long)
    assert from_result.meta["metric"] == "dense-pooled"
    res_next = mt.solve_magi(y, t, mt.FN_SYSTEM, more, resume=from_result)
    assert res_next.theta.shape == (40, 3) and np.isfinite(res_next.theta).all()


def test_solve_magi_warmup_resume_and_other_samplers(monkeypatch, tmp_path):
    """A warmup checkpoint resumes through solve_magi bit for bit; PT and
    ChEES (whitened) resumed through solve_magi after their first sampling
    chunk give the rest of the uninterrupted run's theta bit for bit; a
    warmup checkpoint is refused for another sampler."""
    y, t = _fn_problem()
    cfg = mt.MagiConfig(niter_hmc=60, seed=11, n_chains=2, chain_init_jitter=0.1,
                        mass_matrix="dense-pooled", chunk_size=10, step_jitter=0.25,
                        checkpoint_path=str(tmp_path / "wu.npz"), **FN_BASE)
    kept = _snapshot(monkeypatch, ck, "save_checkpoint",
                     lambda c: c.phase == "warmup" and 0 < c.warmup["pos"] < 30)
    res_full = mt.solve_magi(y, t, mt.FN_SYSTEM, cfg)
    ck.save_checkpoint(str(tmp_path / "mid.npz"), kept["ckpt"])
    res_res = mt.solve_magi(y, t, mt.FN_SYSTEM, cfg, resume=str(tmp_path / "mid.npz"))
    np.testing.assert_array_equal(res_full.diagnostics["theta_per_chain"],
                                  res_res.diagnostics["theta_per_chain"])
    np.testing.assert_array_equal(res_full.diagnostics["lp_per_chain"],
                                  res_res.diagnostics["lp_per_chain"])
    with pytest.raises(MagiError, match="warmup-phase"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(cfg, sampler="chees"),
                      resume=kept["ckpt"])
    for sampler, extra, module, writer in (
            ("pt-nuts", dict(pt_temps=3, pt_replicas=2), tt, "save_pt_checkpoint"),
            ("chees", dict(n_chains=4), ck, "save_checkpoint")):
        path = str(tmp_path / f"{sampler}.npz")
        c = mt.MagiConfig(niter_hmc=40, seed=5, sampler=sampler, checkpoint_path=path,
                          chunk_size=10, x_whitened=True, **extra, **FN_BASE)
        first = _snapshot(monkeypatch, module, writer, lambda c: True)
        res_full = mt.solve_magi(y, t, mt.FN_SYSTEM, c)
        res = mt.solve_magi(y, t, mt.FN_SYSTEM,
                            dataclasses.replace(c, niter_hmc=10, checkpoint_path=None),
                            resume=first["ckpt"])
        n = 2 if sampler == "pt-nuts" else 4
        assert res.diagnostics["theta_per_chain"].shape == (n, 10, 3)
        np.testing.assert_array_equal(res_full.diagnostics["theta_per_chain"][:, 10:],
                                      res.diagnostics["theta_per_chain"])
        np.testing.assert_array_equal(res_full.diagnostics["lp_per_chain"][:, 10:],
                                      res.diagnostics["lp_per_chain"])
        assert ("swap_acceptance" in res.diagnostics) == (sampler == "pt-nuts")


def test_resume_refusals(tmp_path):
    """Dimension mismatch, another device type's random state, and the JAX
    package's checkpoints (file or object, NUTS or PT) are refused with a
    MagiError."""
    y, t = _fn_problem()
    cfg = mt.MagiConfig(niter_hmc=10, **FN_BASE)
    state, _ = ck.generator_state(_gen(0))
    bad_dim = ck.SamplerCheckpoint(psi=np.zeros((1, 7)), step_size=np.array([0.5]),
                                   inv_mass=np.ones((1, 7)), rng_state=state, rng_device="cpu")
    with pytest.raises(MagiError, match="dimension"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, cfg, resume=bad_dim)
    other_device = dataclasses.replace(bad_dim, psi=np.zeros((1, 21)), inv_mass=np.ones((1, 21)),
                                       rng_device="cuda")
    with pytest.raises(MagiError, match="device type"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, cfg, resume=other_device)
    j_ckpt = jck.SamplerCheckpoint(psi=np.zeros((1, 21)), step_size=np.array([0.5]),
                                   inv_mass=np.ones((1, 21)),
                                   key=np.asarray(jax.random.split(jax.random.PRNGKey(0), 1)))
    jck.save_checkpoint(str(tmp_path / "jax.npz"), j_ckpt)
    with pytest.raises(MagiError, match="JAX package"):
        ck.load_checkpoint(str(tmp_path / "jax.npz"))
    with pytest.raises(MagiError, match="JAX package"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, cfg, resume=str(tmp_path / "jax.npz"))
    with pytest.raises(MagiError, match="JAX package"):
        mt.solve_magi(y, t, mt.FN_SYSTEM, cfg, resume=j_ckpt)
    np.savez(str(tmp_path / "jax_pt.npz"), qs=np.zeros((3, 21)), key=np.zeros(2, np.uint32))
    with pytest.raises(MagiError, match="JAX package"):
        tt.load_pt_checkpoint(str(tmp_path / "jax_pt.npz"))


def _jax_vg():
    prec = jnp.asarray(PREC)
    return jax.value_and_grad(lambda q: -0.5 * q @ prec @ q)


def test_jax_checkpoints_carry_across():
    """NUTS (diag and dense), PT (per-rung dense) and ChEES checkpoints of
    the JAX package, converted with from_jax_checkpoint: the port's
    resumed runs hold the same frozen step sizes, metrics, ladder, swap
    counters and trajectory length as the JAX package's resumed runs."""
    rng = np.random.default_rng(0)
    vg_j = _jax_vg()
    keys = lambda c: np.asarray(jax.random.split(jax.random.PRNGKey(1), c))
    common = dict(dtype=torch.float64, device="cpu")
    for inv_mass, meta in ((rng.uniform(0.5, 2.0, size=(3, 2)), None),
                           (A * 0.7, {"metric": "dense-pooled"})):
        j = jck.SamplerCheckpoint(psi=rng.normal(size=(3, 2)), step_size=np.array([0.4, 0.5, 0.6]),
                                  inv_mass=inv_mass, key=keys(3), n_samples_drawn=30, meta=meta)
        _, info_j, _ = jck.run_chains_resumed(vg_j, j, 5)
        _, info_t, new = ck.run_chains_resumed(_vg, ck.from_jax_checkpoint(j, seed=2), 5, **common)
        np.testing.assert_array_equal(info_t["step_size"], np.asarray(info_j["step_size"]))
        np.testing.assert_array_equal(info_t["inv_mass"], np.asarray(info_j["inv_mass"]))
        assert new.n_samples_drawn == 30 + 15
    k, r = 3, 2
    minv = np.stack([A * s for s in (1.0, 1.5, 2.0)])
    pt = dict(qs=rng.normal(size=(r, k, 2)), lp=np.zeros((r, k)),
              eps=rng.uniform(0.2, 0.5, size=(r, k)), inv_mass=np.ones((r, k, 2)),
              inv_temps=np.tile(1.0 / tt.geometric_ladder(k, 4.0), (r, 1)),
              n_swap_accept=np.tile([3, 4, 0], (r, 1)).astype(np.int32),
              n_swap_try=np.tile([9, 9, 0], (r, 1)).astype(np.int32),
              iteration=np.full(r, 7, np.int32), key=keys(r), n_samples_drawn=np.asarray(20),
              metric_minv=minv)
    _, info_j, ck_j = jt.run_parallel_tempering_resumed(vg_j, pt, 4)
    _, info_t, ck_t = tt.run_parallel_tempering_resumed(_vg, ck.from_jax_checkpoint(pt, seed=2), 4,
                                                        **common)
    np.testing.assert_array_equal(info_t["temperatures"], info_j["temperatures"])
    # the JAX package's resumed info reports the unused diagonal; its new
    # checkpoint holds the per-rung metric, which the port reports
    np.testing.assert_array_equal(info_t["inv_mass"], np.asarray(ck_j["metric_minv"]))
    for key in ("inv_temps", "metric_minv"):
        np.testing.assert_array_equal(ck_t[key], np.asarray(ck_j[key]))
    # the port holds the checkpoint's eps; the JAX package's resumed PT
    # re-derives it as exp(log(eps)) through da_init, within 1 ulp
    np.testing.assert_array_equal(info_t["step_size"], pt["eps"])
    np.testing.assert_array_max_ulp(info_t["step_size"], np.asarray(info_j["step_size"]), 1)
    assert (np.asarray(ck_t["n_swap_try"]) >= pt["n_swap_try"]).all()
    j = jch.chees_checkpoint(
        jch.CheesState(qs=jnp.asarray(rng.normal(size=(4, 2))), logps=jnp.zeros(4),
                       grads=jnp.zeros((4, 2)), keys=jnp.asarray(keys(4)), iteration=jnp.int32(9)),
        jch.CheesAdaptState(*([None] * 11))._replace(traj_adam_m=0.1, traj_adam_v=0.2,
                                                     traj_count=3.0),
        jnp.asarray(0.3), jnp.asarray([0.9, 1.1]), jnp.asarray(1.7), n_samples_drawn=40)
    _, info_j, ck_j = jch.run_chees_resumed(vg_j, j, 5)
    _, info_t, ck_t = tch.run_chees_resumed(_vg, ck.from_jax_checkpoint(j, seed=2), 5, **common)
    assert info_t["trajectory_length"] == info_j["trajectory_length"]
    np.testing.assert_array_equal(info_t["step_size"], np.asarray(info_j["step_size"]))
    np.testing.assert_array_equal(info_t["inv_mass"], np.asarray(info_j["inv_mass"]))
    assert ck_t.meta["iteration"] == ck_j.meta["iteration"] == 14
    with pytest.raises(MagiError, match="warmup"):
        ck.from_jax_checkpoint(dataclasses.replace(j, phase="warmup"), seed=0)
