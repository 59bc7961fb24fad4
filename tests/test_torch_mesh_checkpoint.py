"""PyTorch port, checkpoints under a mesh (M17): ranks spawned over gloo on
the CPU, float64, on the small whitened FN problem of
tests/test_torch_parallel.py. A pooled NUTS warmup killed mid-way and
resumed through ``solve_magi(mesh=..., resume=...)`` equals the
uninterrupted sharded run bit for bit (theta, x, lp). Diag NUTS, pooled PT
and ChEES write sampling checkpoints under the mesh that hold the same
fields and generator state as the unsharded run's, values within 1e-10
(the unsharded run applies its value-and-grad in the ranks' row blocks: a
product rounds a row by the batch's size, and 26 NUTS iterations carry a
1e-16 difference to 1e-4);
every rank builds the same checkpoint (its generator in the same state),
rank 0 alone writes it, whole; every rank resumes it unsharded, as the JAX
package does, to the same result, and that result equals a
single-process resume from the same file bit for bit. The curvature
envelope under the chain mesh: rank 0 alone probes (the other ranks never
call the Hessian), the run matches the unsharded one, and a warmup
checkpoint holding its probes resumes under the mesh bit for bit."""
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import manifold_constrained_gaussian_process_inference_tpu_torch as mt
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import checkpoint as ck
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import chees as tch
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import solve as tsolve
from manifold_constrained_gaussian_process_inference_tpu_torch.inference import tempering as tt
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import chains as tc
from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
    dryrun,
    make_chain_mesh,
)

torch.set_num_threads(1)

N_RANKS = 4
NITER, CHUNK = 40, 6  # 20 warmup (one window; chunks 6, 6, 6, 2) and 20 draws
MORE = NITER // 2 - CHUNK  # the resumed leg's draws: the rest of the run
VALUE_TOL = 1e-10
SAMPLING_CASES = {
    "nuts-diag": dict(n_chains=8),
    "pt-nuts": dict(sampler="pt-nuts", pt_temps=3, pt_replicas=4, mass_matrix="dense-pooled",
                    max_tree_depth=6),
    "chees": dict(sampler="chees", n_chains=8),
}


def _problem():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4, 9)
    y = np.stack([np.sin(t), np.cos(t)], -1) + 0.2 * rng.normal(size=(9, 2))
    return y, t


def _config(path, **options):
    return mt.MagiConfig(niter_hmc=NITER, chunk_size=CHUNK, seed=3, sigma=[0.2, 0.2],
                         phi=np.array([[1.0, 1.0], [1.5, 1.5]]), x_whitened=True,
                         theta_constrained=True, chain_init_jitter=0.05, device="cpu",
                         checkpoint_path=path, **options)


def _draws(res):
    """(theta, x, lp) per chain."""
    d = res.diagnostics
    c = d["n_chains"]
    return (d["theta_per_chain"], res.x_sampled.reshape(c, -1, *res.x_sampled.shape[1:]),
            d["lp_per_chain"])


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _arrays(ckpt) -> dict:
    """A checkpoint's arrays by name (a SamplerCheckpoint or PT's dict)."""
    if isinstance(ckpt, dict):
        return {k: np.asarray(v) for k, v in ckpt.items()}
    out = {f: np.asarray(getattr(ckpt, f)) for f in ("psi", "step_size", "inv_mass", "rng_state")}
    out.update({f"st_{k}": np.asarray(v) for k, v in (ckpt.state or {}).items()})
    out["n_samples_drawn"] = np.asarray(ckpt.n_samples_drawn)
    return out


class _Recorder:
    """Wraps the samplers' checkpoint writer: records every checkpoint this
    rank built (a digest of its arrays) and, on the rank that writes, keeps
    a copy of the first one ``want`` accepts under ``keep``."""

    MODULES = (tc, tt, tch)

    def __init__(self):
        self.real = tc.write_checkpoint
        self.built, self.keep, self.want = [], None, None

    def __enter__(self):
        def write(mesh, path, ckpt, save=None):
            self.built.append(_digest(*_arrays(ckpt).values()))
            if self.keep and (mesh is None or mesh.rank == 0) and (
                    not os.path.exists(self.keep)) and self.want(ckpt):
                (save or ck.save_checkpoint)(self.keep, ckpt)
            self.real(mesh, path, ckpt, save)

        for module in self.MODULES:
            module.write_checkpoint = write
        return self

    def __exit__(self, *exc):
        for module in self.MODULES:
            module.write_checkpoint = self.real


class _vg_in_row_blocks:
    """solve_magi's sampler value-and-grad applied to ``n`` row blocks of
    its (C, dim) input: the batch each rank's value-and-grad sees under a
    mesh of ``n`` (a BLAS product may round a row by the batch's size)."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.real = tsolve.make_centered_whitened_vg

        def make(target, whitener):
            vg = self.real(target, whitener)

            def blocked(z):
                parts = [vg(block) for block in z.chunk(self.n)]
                return tuple(torch.cat(col) for col in zip(*parts))

            return blocked

        tsolve.make_centered_whitened_vg = make
        return self

    def __exit__(self, *exc):
        tsolve.make_centered_whitened_vg = self.real


def _is_sampling(ckpt) -> bool:
    return isinstance(ckpt, dict) or ckpt.phase == "sampling"


def _is_mid_warmup(ckpt) -> bool:
    return not isinstance(ckpt, dict) and ckpt.phase == "warmup" and \
        0 < ckpt.warmup["pos"] < NITER // 2


def _load(path, sampler):
    return tt.load_pt_checkpoint(path) if sampler == "pt-nuts" else ck.load_checkpoint(path)


def _pocket_vg(q):
    """tests/test_envelope.py's pocket target (z2 | z1 ~ N(0, 1/g(z1)))."""
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        g = 1.0 + 999.0 * torch.sigmoid((q[..., 0] - 1.2) / 0.4)
        lp = -0.5 * q[..., 0] ** 2 - 0.5 * g * q[..., 1] ** 2 + 0.5 * torch.log(g)
        (grad,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), grad


def _pocket_envelope(asked):
    def hess(z):
        asked.append(np.array(z))
        return -torch.func.hessian(lambda x: _pocket_vg_value(x))(torch.as_tensor(z)).numpy()

    return tc.CurvatureEnvelope(hess, logp_fn=lambda z: float(_pocket_vg_value(
        torch.as_tensor(z))), max_div_frac=0.5)


def _pocket_vg_value(q):
    g = 1.0 + 999.0 * torch.sigmoid((q[..., 0] - 1.2) / 0.4)
    return -0.5 * q[..., 0] ** 2 - 0.5 * g * q[..., 1] ** 2 + 0.5 * torch.log(g)


ENVELOPE_RUN = dict(n_samples=210, n_adapts=200, chunk_size=25, initial_step_size=0.2,
                    mass_matrix="dense-pooled", target_accept=0.8)


def _envelope_runs(rank, mesh, tmp):
    """The envelope sharded (with checkpoints, one kept after a probe), the
    same run resumed from the kept checkpoint under the mesh, and on rank 0
    the run unsharded."""
    psi0 = torch.as_tensor(0.1 * np.random.default_rng(0).standard_normal((8, 2)))
    kept = f"{tmp}/envelope_kept.npz"

    def with_probes(ckpt):
        return (not isinstance(ckpt, dict) and ckpt.phase == "warmup"
                and 0 < ckpt.warmup["pos"] < 200 and bool(ckpt.warmup["envelope"]
                                                             and ckpt.warmup["envelope"]["points"]))

    asked = []
    env = _pocket_envelope(asked)
    with _Recorder() as rec:
        rec.keep, rec.want = kept, with_probes
        s, info = tc.run_chains(_pocket_vg, psi0, torch.Generator().manual_seed(1),
                                envelope=env, mesh=mesh,
                                checkpoint_path=f"{tmp}/envelope.npz", **ENVELOPE_RUN)
    dist.barrier()
    resumed, info_r = tc.run_chains(_pocket_vg, psi0, torch.Generator().manual_seed(1),
                                    envelope=_pocket_envelope([]), mesh=mesh,
                                    resume_ckpt=ck.load_checkpoint(kept), **ENVELOPE_RUN)
    env_keys = ("envelope_points", "envelope_boost_dirs", "envelope_boost_max")
    out = dict(samples=s, info=[info[k] for k in env_keys], asked=len(asked), resumed=resumed,
               info_resumed=[info_r[k] for k in env_keys], inv_mass=info["inv_mass"],
               points=env.points)
    if rank == 0:
        env_plain = _pocket_envelope([])
        plain, info_p = tc.run_chains(_pocket_vg, psi0, torch.Generator().manual_seed(1),
                                      envelope=env_plain, **ENVELOPE_RUN)
        out.update(plain=plain, info_plain=[info_p[k] for k in env_keys],
                   inv_mass_plain=info_p["inv_mass"], points_plain=env_plain.points)
    return out


def _ranks_job(rank, tmp):
    """Every run the tests read, on one rank of a 4-rank gloo world."""
    mesh = make_chain_mesh(dist.get_world_size(), device="cpu")
    rmesh = tt.make_replica_mesh(dist.get_world_size(), device="cpu")
    y, t = _problem()
    out = {}

    # the pooled NUTS warmup, uninterrupted and killed after a warmup chunk
    pooled = _config(f"{tmp}/pooled.npz", n_chains=8, mass_matrix="dense-pooled",
                     step_jitter=0.125)
    kept = f"{tmp}/pooled_kept.npz"
    with _Recorder() as rec:
        rec.keep, rec.want = kept, _is_mid_warmup
        full = mt.solve_magi(y, t, mt.FN_SYSTEM, pooled, mesh=mesh)
    dist.barrier()
    resumed = mt.solve_magi(y, t, mt.FN_SYSTEM,
                            dataclasses.replace(pooled, checkpoint_path=f"{tmp}/pooled_r.npz"),
                            mesh=mesh, resume=kept)
    out["pooled"] = dict(full=_draws(full), resumed=_draws(resumed), built=rec.built,
                         pos=ck.load_checkpoint(kept).warmup["pos"],
                         final_key=full.diagnostics["final_key"])

    # sampling checkpoints: sharded, and (spread over the ranks) unsharded
    for i, (case, options) in enumerate(SAMPLING_CASES.items()):
        case_mesh = rmesh if options.get("sampler") == "pt-nuts" else mesh
        config = _config(f"{tmp}/{case}.npz", **options)
        kept = f"{tmp}/{case}_kept.npz"
        with _Recorder() as rec:
            rec.keep, rec.want = kept, _is_sampling
            sharded = mt.solve_magi(y, t, mt.FN_SYSTEM, config, mesh=case_mesh)
        dist.barrier()
        leg = dataclasses.replace(config, niter_hmc=MORE, checkpoint_path=f"{tmp}/{case}_r.npz")
        every = mt.solve_magi(y, t, mt.FN_SYSTEM, leg, mesh=case_mesh, resume=kept)
        res = dict(sharded=_draws(sharded), built=rec.built, resumed=_draws(every),
                   final_key=sharded.diagnostics["final_key"],
                   kept=_arrays(_load(kept, options.get("sampler"))))
        if rank == i:
            plain_kept = f"{tmp}/{case}_plain_kept.npz"
            with _Recorder() as rec_plain, _vg_in_row_blocks(N_RANKS):
                rec_plain.keep, rec_plain.want = plain_kept, _is_sampling
                plain = mt.solve_magi(
                    y, t, mt.FN_SYSTEM,
                    dataclasses.replace(config, checkpoint_path=f"{tmp}/{case}_plain.npz"))
            alone = mt.solve_magi(y, t, mt.FN_SYSTEM, dataclasses.replace(
                leg, checkpoint_path=f"{tmp}/{case}_alone.npz"), resume=kept)
            res.update(plain=_draws(plain), alone=_draws(alone),
                       plain_kept=_arrays(_load(plain_kept, options.get("sampler"))))
        out[case] = res
    out["envelope"] = _envelope_runs(rank, mesh, tmp)
    dist.barrier()
    out["files"] = sorted(os.listdir(tmp))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return dryrun.run_ranks(_ranks_job, N_RANKS, args=(str(tmp_path_factory.mktemp("ckpt")),))


def test_pooled_warmup_killed_and_resumed_under_the_mesh_equals_the_uninterrupted_run(ranks):
    for r in ranks:
        p = r["pooled"]
        assert 0 < p["pos"] < NITER // 2
        for name, full, resumed in zip(("theta", "x", "lp"), p["full"], p["resumed"]):
            assert np.isfinite(full).all()
            np.testing.assert_array_equal(resumed, full, err_msg=name)


@pytest.mark.parametrize("case", ["pooled", *SAMPLING_CASES])
def test_every_rank_builds_the_same_checkpoints_and_generator_state(ranks, case):
    """The checkpoints every rank built (gathered carry and its own
    generator's state) are identical, and so are the ranks' final
    generator states."""
    built = [r[case]["built"] for r in ranks]
    assert built[0] and all(b == built[0] for b in built)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case]["final_key"], ranks[0][case]["final_key"])


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_mesh_checkpoint_matches_the_unsharded_runs(ranks, case):
    i = list(SAMPLING_CASES).index(case)
    got, want = ranks[i][case]["kept"], ranks[i][case]["plain_kept"]
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["rng_state"], want["rng_state"])
    for name, a in want.items():
        assert got[name].shape == a.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[name], a, rtol=VALUE_TOL, atol=VALUE_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], a, err_msg=name)
    for sharded, plain in zip(ranks[i][case]["sharded"], ranks[i][case]["plain"]):
        np.testing.assert_allclose(sharded, plain, rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_every_rank_resumes_the_mesh_checkpoint_to_the_same_result(ranks, case):
    first = ranks[0][case]["resumed"]
    assert first[0].shape[1] == MORE and all(np.isfinite(a).all() for a in first)
    for r in ranks[1:]:
        for a, b in zip(r[case]["resumed"], first):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_mesh_resume_equals_a_single_process_resume(ranks, case):
    i = list(SAMPLING_CASES).index(case)
    for a, b in zip(ranks[i][case]["resumed"], ranks[i][case]["alone"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(SAMPLING_CASES))
def test_resumed_leg_continues_the_sharded_run(ranks, case):
    """The resumed leg's draws continue the run that wrote the checkpoint:
    per chain within 1e-10 of the sharded run's last draws (the leg is
    unsharded, so only rounding separates them)."""
    r = ranks[0][case]
    for resumed, full in zip(r["resumed"], r["sharded"]):
        np.testing.assert_allclose(resumed, full[:, -MORE:], rtol=VALUE_TOL, atol=VALUE_TOL)


def test_checkpoint_files_are_whole(ranks):
    """Rank 0 wrote every file whole: no temporary file is left behind."""
    files = ranks[0]["files"]
    assert files and not [f for f in files if f.endswith(".tmp")]


def test_envelope_under_the_mesh_probes_on_rank_0_and_matches_the_unsharded_run(ranks):
    """Rank 0 alone calls the Hessian; every rank returns the same draws
    and envelope readings; against the unsharded run (whose pooled moments
    sum in another order, so the chains part after a few windows) the same
    number of probes and boosted directions, and the first probe at the
    same point (1e-8)."""
    e0 = ranks[0]["envelope"]
    assert e0["asked"] == e0["info"][0] >= 1 and e0["info"][1] >= 1
    for r in ranks[1:]:
        assert r["envelope"]["asked"] == 0
        assert r["envelope"]["info"] == e0["info"]
        np.testing.assert_array_equal(r["envelope"]["samples"], e0["samples"])
    assert e0["info"][:2] == e0["info_plain"][:2]
    np.testing.assert_allclose(e0["points"][0], e0["points_plain"][0], rtol=1e-8, atol=1e-8)


def test_envelope_warmup_checkpoint_resumes_under_the_mesh(ranks):
    for r in ranks:
        e = r["envelope"]
        np.testing.assert_array_equal(e["resumed"], e["samples"])
        assert e["info_resumed"] == e["info"]
