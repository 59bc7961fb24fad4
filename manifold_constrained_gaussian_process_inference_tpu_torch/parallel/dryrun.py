"""Multi-rank dry run of the port's sharded paths (the counterpart of the
JAX package's ``__graft_entry__.py::dryrun_multichip``), and ``run_ranks``,
which starts the ranks of a torch.distributed world for it, for the tests
and for the smoke.

    python -m manifold_constrained_gaussian_process_inference_tpu_torch.parallel.dryrun 4 [cpu]

runs the four stages of the JAX package's dry run on 4 gloo ranks, all on
the card (``default_device()``) or, given ``cpu``, on the CPU: NUTS chains,
a grid-sharded value-and-grad (and NUTS on it), PT replica ladders and
ChEES chains, each sharded against the same call unsharded, and prints the
deltas.
"""
from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import default_device, default_dtype

# The JAX package's dry-run bound on every sharded-vs-unsharded delta.
DRYRUN_TOL = 1e-4


def _rank_entry(rank, world, backend, tmp, fn, args, threads, timeout_s):
    torch.set_num_threads(threads)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
    )
    out = fn(rank, *args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, args=(), backend: str = "gloo", threads: int = 1,
              timeout_s: float = 600.0):
    """``fn(rank, *args)`` on ``world`` ranks spawned by torch.multiprocessing,
    each in a fresh process group (``backend``, a FileStore in a temporary
    directory: no network). Returns the ranks' return values in rank order.
    ``fn`` must be importable by the spawned processes (a module-level
    function). A rank that raises fails the call: the other ranks are
    stopped and the error raised here."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_entry, args=(world, backend, tmp, fn, tuple(args), threads, timeout_s),
                 nprocs=world, join=True)
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _fn_problem(n_obs: int, t_end: float, dtype, device, bandsize: int = 20):
    """The JAX dry run's problem: synthetic observations around an FN-like
    limit cycle, phi fixed, sigma sampled; (target, psi0)."""
    from ..inference.target import MagiTarget
    from ..models import FN_SYSTEM
    from ..ops.gp_cov import build_gp_cov

    rng = np.random.default_rng(0)
    t = np.linspace(0.0, t_end, n_obs)
    y = np.stack([2.0 * np.sin(0.8 * t), 1.0 + 0.5 * np.cos(0.8 * t)], axis=-1)
    y = y + 0.2 * rng.normal(size=(n_obs, 2))
    cov = build_gp_cov("matern52", np.array([[2.0, 2.0], [1.5, 1.5]]), t, bandsize=bandsize,
                       complexity=2, jitter=1e-6).to(dtype=dtype, device=device)
    target = MagiTarget.build(y, cov, FN_SYSTEM, sigma_init=np.array([0.2, 0.2]),
                              prior_temperature=np.array([1.0, 1.0, 1.0]), sigma_is_fixed=False)
    psi0 = np.concatenate([y.T.reshape(-1), [0.2, 0.2, 3.0], np.log([0.2, 0.2])])
    return target, psi0, y, cov


def _max_delta(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _dryrun_rank(rank: int, device: str) -> dict:
    """The four stages on one rank; rank 0 also runs each call unsharded and
    returns the deltas."""
    from ..inference.chees import run_chees
    from ..inference.nuts import run_nuts
    from ..inference.target import MagiTarget
    from ..inference.tempering import make_replica_mesh, run_parallel_tempering
    from ..models import FN_SYSTEM
    from .chains import make_chain_mesh, run_chains
    from .grid import make_grid_mesh, make_grid_sharded_data, make_grid_value_and_grad

    dtype = default_dtype(device)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    target, psi0, _, _ = _fn_problem(11, 5.0, dtype, device)
    vg = target.value_and_grad_fn()
    mesh = make_chain_mesh(device=device)
    n_dev = mesh.size
    n_chains = n_dev  # one chain per rank; multiples also run
    psi0s = put(np.tile(psi0, (n_chains, 1)))
    out = {}

    # Stage 1: NUTS chains sharded over the ranks
    kw = dict(n_samples=2, n_adapts=1, initial_step_size=0.01, max_depth=4, mass_matrix="diag")
    samples, info = run_chains(vg, psi0s, gen(0), mesh=mesh, **kw)
    assert samples.shape == (n_chains, 1, psi0.shape[0]), samples.shape
    assert np.all(np.isfinite(info["lp"]))
    if rank == 0:
        ref, _ = run_chains(vg, psi0s, gen(0), **kw)
        out["chains"] = _max_delta(samples, ref)

    # Stage 2: one chain's value-and-grad sharded over the time grid
    n_grid = 3 * n_dev + 1  # not a multiple of the mesh size: the pad path
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 5.0, n_grid)
    y = np.stack([2.0 * np.sin(0.8 * t), 1.0 + 0.5 * np.cos(0.8 * t)], axis=-1)
    y = y + 0.2 * rng.normal(size=(n_grid, 2))
    from ..ops.gp_cov import build_gp_cov

    cov = build_gp_cov("matern52", np.array([[2.0, 2.0], [1.5, 1.5]]), t, bandsize=4,
                       complexity=2, jitter=1e-6).to(dtype=dtype, device=device)
    gmesh = make_grid_mesh(device=device)
    gdata = make_grid_sharded_data(y, cov, np.array([1.0, 1.0, 1.0]), n_dev)
    gvg = make_grid_value_and_grad(gdata, FN_SYSTEM, np.array([0.2, 0.2]), sigma_is_fixed=False,
                                   mesh=gmesh)
    psi_g = put(np.concatenate([y.T.reshape(-1), [0.2, 0.2, 3.0], np.log([0.2, 0.2])]))
    ref_target = MagiTarget.build(y, cov, FN_SYSTEM, sigma_init=np.array([0.2, 0.2]),
                                  prior_temperature=np.array([1.0, 1.0, 1.0]),
                                  sigma_is_fixed=False, band_impl="band")
    v_ref, g_ref = (a.double().cpu().numpy() for a in ref_target.value_and_grad_fn()(psi_g))
    v_sh, g_sh = (a.double().cpu().numpy() for a in gvg(psi_g))
    d_gval = abs(float(v_sh) - float(v_ref))
    # relative: the gradient reaches ~1e5 at this synthetic start
    d_ggrad = float(np.max(np.abs(g_sh - g_ref) / (1e-3 + np.abs(g_ref))))
    assert d_gval < DRYRUN_TOL * max(1.0, abs(float(v_ref))), f"grid-sharded value off by {d_gval}"
    assert d_ggrad < DRYRUN_TOL, f"grid-sharded grad rel err {d_ggrad}"
    g_samples, _ = run_nuts(gvg, psi_g, gen(1), n_samples=2, n_adapts=1,
                            initial_step_size=0.01, max_depth=4)
    assert np.all(np.isfinite(g_samples))
    out.update(grid_value=d_gval, grid_grad=d_ggrad, n_grid=n_grid)

    # Stage 3: PT replica ladders sharded over the ranks, pooled dense metric
    rmesh = make_replica_mesh(device=device)
    kw = dict(n_samples=3, n_adapts=1, n_temps=3, max_temp=4.0, initial_step_size=0.01,
              max_depth=4, n_replicas=n_dev, ladder_adapt=False, mass_matrix="dense-pooled")
    pt_samples, _ = run_parallel_tempering(vg, put(psi0), gen(2), mesh=rmesh, **kw)
    assert pt_samples.shape == (n_dev, 2, psi0.shape[0]), pt_samples.shape
    assert np.all(np.isfinite(pt_samples))
    if rank == 0:
        pt_ref, _ = run_parallel_tempering(vg, put(psi0), gen(2), **kw)
        out["pt"] = _max_delta(pt_samples, pt_ref)

    # Stage 4: ChEES chains sharded over the ranks, psum-coupled adaptation
    kw = dict(n_samples=3, n_adapts=1, initial_step_size=0.01)
    ch_samples, _ = run_chees(vg, psi0s, gen(3), mesh=mesh, **kw)
    assert ch_samples.shape == (n_chains, 2, psi0.shape[0]), ch_samples.shape
    assert np.all(np.isfinite(ch_samples))
    if rank == 0:
        ch_ref, _ = run_chees(vg, psi0s, gen(3), **kw)
        out["chees"] = _max_delta(ch_samples, ch_ref)
    out.update(n_chains=n_chains, dim=int(psi0.shape[0]))
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX package's ``dryrun_multichip`` on ``n_devices`` gloo ranks,
    all on ``device`` (None = ``default_device()``, the card): chains, grid,
    PT replicas and ChEES, each sharded against unsharded within
    DRYRUN_TOL. Prints the deltas; returns them."""
    device = str(torch.device(device) if device is not None else default_device())
    d = run_ranks(_dryrun_rank, n_devices, args=(device,))[0]
    for what in ("chains", "pt", "chees"):
        assert d[what] < DRYRUN_TOL, f"sharded {what} diverge from the unsharded run: {d[what]}"
    print(
        f"dryrun_multichip OK: {d['n_chains']} chains over {n_devices} ranks "
        f"(psi dim {d['dim']}); grid-sharded chain over {n_devices} ranks "
        f"(n={d['n_grid']}); {n_devices} PT replica ladders over {n_devices} ranks "
        f"(3 rungs each, pooled dense metric); {d['n_chains']} ChEES chains over "
        f"{n_devices} ranks (psum-coupled adaptation). Sharded-vs-unsharded parity deltas: "
        f"chains {d['chains']:.2e}, grid value {d['grid_value']:.2e} grad "
        f"{d['grid_grad']:.2e}, PT {d['pt']:.2e}, ChEES {d['chees']:.2e}",
        flush=True,
    )
    return d


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else None)
