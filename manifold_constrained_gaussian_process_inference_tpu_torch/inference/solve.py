"""solve_magi, the end-to-end MAGI orchestrator (port of the JAX package's
inference/solve.py):

  NLML init of (phi, sigma) -> x init by interpolation -> theta init from
  bounds -> GP covariances -> target -> optional Adam MAP warm start
  (``map_init_iterations``) -> with ``x_whitened``, staged Gauss-Newton MAP
  and exact-Hessian Laplace whitening (float64, host) -> the sampler on the
  sampling device: C batched NUTS chains under per-chain diagonal metrics
  (``mass_matrix="diag"``, the default) or a pooled dense metric,
  parallel-tempering NUTS (``sampler="pt-nuts"``) or ChEES-HMC
  (``sampler="chees"``) -> results

The defaults (one chain, diag, raw Psi) are the JAX package's. Every
sampler writes checkpoints (``checkpoint_path``) and resumes from them
(``resume``). Under a ``mesh`` (``parallel/mesh.py``) every rank calls
solve_magi with the same data and config: rank 0 runs the setup (NLML, MAP
warm start, Gauss-Newton MAP, whitener) and broadcasts what feeds the
sampler, the sampler is sharded over the ranks, and every rank returns the
same gathered result; rank 0 writes the checkpoints, and a resumed
sampling leg runs unsharded on every rank, as in the JAX package.
``divergence_envelope`` folds exact float64 Hessian probes at divergent
warmup steps into the pooled metric (parallel/chains.py
CurvatureEnvelope); ``profile_dir`` traces the sampling phase with
torch.profiler and the port's tracer (``utils/trace.py``).

``diagnostics["phase_times_s"]`` times the phases with the tracer's
``phase`` spans, recorded whether it is on or not: ``nlml_s``,
``gp_target_s`` (x and theta init, the GP covariances, the target, Psi_0),
``map_s``, ``gn_map_s``, ``whitener_s``, ``sampler_setup_s`` (the envelope,
the starts, a resume's checkpoint, and the sampler's time outside its warmup
and sampling), ``warmup_s``, ``sampling_s`` (the sampler's own) and
``results_s``; they sum to ``total_time_s`` but for the argument checks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import MagiConfig, MagiError
from ..models.base import OdeSystem
from ..ops.gp_cov import build_gp_cov
from ..ops.kernels import parse_kernel_type
from ..parallel.chains import CurvatureEnvelope, run_chains
from ..parallel.mesh import broadcast_tensors
from ..utils import trace
from .nlml import default_initial_guesses, optimize_gp_hyperparameters
from .target import MagiTarget, check_band_impl
from .transforms import constrain_np, make_theta_transform, unconstrain
from .whiten import (
    PsiWhitener,
    build_psi_whitener,
    build_psi_whitener_exact,
    gauss_newton_map,
    make_centered_whitened_vg,
    make_exact_hessian_fn,
    zeta_to_psi_np,
)

logger = logging.getLogger(__name__)

# Offset added to config.seed for each host numpy stream, so the streams
# stay distinct: chain-start jitter (as in the JAX package) and the
# step-jitter multipliers (the JAX package seeds those from its PRNG keys).
INIT_JITTER_SEED_OFFSET = 1
STEP_JITTER_SEED_OFFSET = 2
# The JAX package's auto policy puts a band above this on the dense layout
# (its solve.py: past it dense einsums won on the TPU even sequentially, and
# the Pallas kernel stopped compiling); the port's rule off the card keeps
# it. An explicit band_impl="band" runs at any bandwidth.
AUTO_BAND_MAX_BANDWIDTH = 64
# On the card dense is ahead only for a band that is wide, long and batched
# (the layout sweep, perf/layout_sweep.py; PERF.md §6, H100):
# - wide, b > n / AUTO_WIDE_BAND_DIVISOR: band was ahead at every chain
#   count at b/n = 0.1 (n = 793 to 3169, b = 80 and 160); at b/n = 0.16
#   (n = 397, b = 64) dense was ahead at 9 to 16 chains and within 3% at
#   more;
# - long, b >= AUTO_DENSE_MIN_BANDWIDTH: at n = 199 band was ahead at b = 32
#   and 48 at every chain count, dense from b = 64 at 9 chains and more; the
#   model families' grids (b = 11 to 14) and config 3's (b = 20) ran band
#   ahead at every chain count from 1 to 128;
# - batched, AUTO_DENSE_MIN_BATCH chains or more: at 8 chains band was
#   ahead, or dense within 1%, at every wide point; at 9 dense was ahead by
#   8% (n = 397, b = 80) and 20% (b = 160).
AUTO_WIDE_BAND_DIVISOR = 8
AUTO_DENSE_MIN_BANDWIDTH = 64
AUTO_DENSE_MIN_BATCH = 9
# optax.adam's defaults, which the JAX package's MAP warm start uses.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class MagiResult:
    """(theta, x_sampled, sigma, phi, lp) plus diagnostics. Chains are
    concatenated along the sample axis; per-chain arrays are in
    ``diagnostics``."""

    theta: np.ndarray       # (S, k)
    x_sampled: np.ndarray   # (S, n, D)
    sigma: np.ndarray       # (S, D)
    phi: np.ndarray         # (2, D)
    lp: np.ndarray          # (S,)
    diagnostics: Dict

    def keys(self):
        return ("theta", "x_sampled", "sigma", "phi", "lp")


def _init_x_interpolation(y_obs: np.ndarray, t_obs: np.ndarray) -> np.ndarray:
    """Linear interpolation of the observations onto the grid, extended
    linearly past the ends; constant for <2 observations, zeros for none."""
    n, d = y_obs.shape
    x0 = np.zeros((n, d))
    for dim in range(d):
        idx = np.flatnonzero(np.isfinite(y_obs[:, dim]))
        if idx.size == 0:
            logger.warning("No observations in dimension %d; x init = 0.", dim)
            continue
        tv, uniq = np.unique(t_obs[idx], return_index=True)
        yv = y_obs[idx, dim][uniq]
        if tv.size < 2:
            x0[:, dim] = yv[0]
            continue
        vals = np.interp(t_obs, tv, yv)
        left, right = t_obs < tv[0], t_obs > tv[-1]
        if left.any():
            vals[left] = yv[0] + (yv[1] - yv[0]) / (tv[1] - tv[0]) * (t_obs[left] - tv[0])
        if right.any():
            vals[right] = yv[-1] + (yv[-1] - yv[-2]) / (tv[-1] - tv[-2]) * (t_obs[right] - tv[-1])
        x0[:, dim] = vals
    return x0


def _init_theta_from_bounds(system: OdeSystem) -> np.ndarray:
    """Bounds-midpoint initialization with nudging and clamping."""
    lb, ub = system.theta_lower_bound, system.theta_upper_bound
    theta = np.zeros(system.theta_size)
    for i in range(system.theta_size):
        lo, hi = lb[i], ub[i]
        if np.isfinite(lo) and np.isfinite(hi):
            theta[i] = 0.5 * (lo + hi)
        elif np.isfinite(lo):
            theta[i] = lo + abs(lo) * 0.1 + 0.1
        elif np.isfinite(hi):
            theta[i] = hi - abs(hi) * 0.1 - 0.1
        if np.isfinite(lo) and theta[i] <= lo:
            theta[i] = lo + 1e-4 * (min(1.0, hi - lo) if np.isfinite(hi) else 1.0)
        if np.isfinite(hi) and theta[i] >= hi:
            theta[i] = hi - 1e-4 * (min(1.0, hi - lo) if np.isfinite(lo) else 1.0)
        theta[i] = np.clip(theta[i], lo, hi)
    return theta


def map_warm_start(
    vg,
    psi0: np.ndarray,
    n_iters: int,
    lr: float,
    theta_slice: slice,
    theta_lb: np.ndarray,
    theta_ub: np.ndarray,
    dtype,
    device="cpu",
) -> np.ndarray:
    """Adam ascent on the log-posterior from ``psi0``, with optax.adam's
    update on the negated gradient (b1=0.9, b2=0.999, eps=1e-8,
    eps_root=0). After each step theta is clipped into its bounds with a
    strict margin (1/theta-style terms stay finite); a step with a
    non-finite coordinate is rejected (the moments still advance, as in the
    JAX package). Returns the best Psi seen, float64 numpy. The loop stays
    on ``device``: the best-value test is a ``torch.where``, and only the
    start and end values are read on the host."""
    put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
    both = np.isfinite(theta_lb) & np.isfinite(theta_ub)
    margin = np.where(both, 1e-4 * np.minimum(theta_ub - theta_lb, 1.0), 1e-4)
    lo, hi = put(theta_lb) + put(margin), put(theta_ub) - put(margin)
    psi = put(psi0)
    m, nu = torch.zeros_like(psi), torch.zeros_like(psi)
    v0, _ = vg(psi)
    best_psi, best_v = psi, v0
    for t in range(1, n_iters + 1):
        v, g = vg(psi)
        better = v > best_v
        best_psi = torch.where(better, psi, best_psi)
        best_v = torch.where(better, v, best_v)
        m = (1.0 - ADAM_B1) * -g + ADAM_B1 * m
        nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        m_hat = m / (1.0 - ADAM_B1**t)
        nu_hat = nu / (1.0 - ADAM_B2**t)
        new = psi + -lr * (m_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        new[theta_slice] = torch.clamp(new[theta_slice], lo, hi)
        psi = torch.where(torch.isfinite(new).all(), new, psi)
    v_f, _ = vg(psi)
    out = torch.where(v_f > best_v, psi, best_psi)
    logger.info("MAP warm start: log-posterior %.4g -> %.4g (%d Adam steps)",
                float(v0), float(torch.maximum(v_f, best_v)), n_iters)
    return out.to("cpu", torch.float64).numpy()


def envelope_probes(target_h: MagiTarget, whitener: PsiWhitener):
    """The curvature envelope's ``hess_fn`` and ``logp_fn`` in the
    sampler's coordinates z: the float64 host target ``target_h`` at
    psi = center + W z, its exact Hessian conjugated through the whitener
    as the local precision W^T (-(H + H^T)/2) W (the JAX package's solve.py
    wiring). The whitener's factors are widened to float64 on the host."""
    hess_psi = make_exact_hessian_fn(target_h)
    logdensity = target_h.logdensity_fn()
    w64 = whitener.W.double().cpu().numpy()
    c64 = whitener.center.double().cpu().numpy()
    like = target_h.data.mask

    def hess_z(z):
        h = hess_psi(c64 + w64 @ np.asarray(z, dtype=np.float64))
        pz = w64.T @ (-0.5 * (h + h.T)) @ w64
        return 0.5 * (pz + pz.T)

    def logp_z(z):
        psi = c64 + w64 @ np.asarray(z, dtype=np.float64)
        with torch.no_grad():
            return float(logdensity(torch.as_tensor(psi, dtype=like.dtype, device=like.device)))

    return hess_z, logp_z


@contextlib.contextmanager
def _trace_sampling(profile_dir, device, mesh):
    """The JAX package's ``jax.profiler.trace(profile_dir)`` around the
    sampling phase, as ``torch.profiler``: CPU activity, and the card's
    under CUDA, written when the scope ends as one trace file per rank
    (``magi_rank<r>.<timestamp>.pt.trace.json``, Chrome trace format,
    readable by Perfetto or TensorBoard) into ``profile_dir``. Beside it the
    port's tracer over the same scope (started here unless it is on), whose
    spans go to ``magi_spans_rank<r>.json`` (Chrome trace format: the host
    spans and the device's graph replays and eager spans on one timeline,
    the stage sums inside the doubling graphs, which the profiler does not
    see inside a WHILE node's body, in ``otherData``)."""
    if not profile_dir:
        yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    rank = 0 if mesh is None else mesh.rank
    started = not trace.enabled()
    if started:
        trace.start(device)
    try:
        with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir, worker_name=f"magi_rank{rank}"),
        ):
            yield
    finally:
        if started:
            trace.stop()
    trace.write_chrome(os.path.join(profile_dir, f"magi_spans_rank{rank}.json"), rank)


def _from_root(mesh, compute, *like):
    """``compute()`` (a tuple of float64 host arrays) on rank 0, broadcast
    to every rank of the mesh (the others pass arrays ``like`` it); just
    ``compute()`` without a mesh."""
    if mesh is None:
        return compute()
    out = compute() if mesh.rank == 0 else like
    return tuple(mesh.broadcast_np(np.asarray(a, dtype=np.float64)) for a in out)


def _normalize_pt(s_pt: np.ndarray, info: dict):
    """PT results in run_chains' (C, S) layout: the cold (T = 1) rung of
    each replica is one posterior chain; the per-rung accept and depth
    stacks stay under ``*_per_rung``. accept_prob, tree_depth and
    num_leapfrog are rung-ordered while diverging travels with the swapped
    positions (tempering.py). Returns (samples (C, S, dim), info, C)."""
    info = dict(info)
    info["accept_prob_per_rung"] = info["accept_prob"]
    info["tree_depth_per_rung"] = info["tree_depth"]
    if s_pt.ndim == 2:  # one ladder: (S, dim)
        samples, info["lp"] = s_pt[None], info["lp"][None]
        for key in ("diverging", "num_leapfrog", "accept_prob", "tree_depth"):
            info[key] = info[key][:, 0][None]
        info["final_psi"] = info["final_psi"][:1]
    else:  # (R, S, dim)
        samples, info["lp"] = s_pt, info["lp"].T
        for key in ("diverging", "num_leapfrog", "accept_prob", "tree_depth"):
            info[key] = info[key][:, :, 0].T
        info["final_psi"] = info["final_psi"][:, 0]
    info["energy"] = np.zeros_like(info["lp"])
    info["warmup_diverging"] = np.zeros((samples.shape[0], 0))
    return samples, info, samples.shape[0]


def _load_resume(resume, config: MagiConfig, dimension: int, mesh=None):
    """A checkpoint given by path or object, refused when it is the JAX
    package's or its dimension is not the target's. Under a mesh rank 0's
    copy goes to every rank, so no rank reads another file state."""
    from .checkpoint import check_port_checkpoint, load_checkpoint
    from .tempering import load_pt_checkpoint

    if isinstance(resume, str) and (mesh is None or mesh.rank == 0):
        load = load_pt_checkpoint if config.sampler == "pt-nuts" else load_checkpoint
        resume = load(resume)
    if mesh is not None:
        resume = mesh.broadcast_object(resume)
    check_port_checkpoint(resume)
    ck_dim = int(np.asarray(resume["qs"] if isinstance(resume, dict) else resume.psi).shape[-1])
    if ck_dim != dimension:
        raise MagiError(
            f"resume checkpoint dimension {ck_dim} does not match the target dimension "
            f"{dimension}; the resumed call must use the same data and config as the original run."
        )
    return resume


def _run_resumed(vg, ckpt, config: MagiConfig, dtype, device, mesh=None):
    """A resumed sampling leg through the sampler's resumed runner, in the
    (C, S) layout of the fresh runs. Returns (samples, info, n_chains).
    Under a mesh every rank runs the whole leg unsharded, as the JAX
    package does, and rank 0 alone writes its checkpoints."""
    writer = mesh is None or mesh.rank == 0
    common = dict(chunk_size=config.chunk_size, dtype=dtype, device=device,
                  checkpoint_path=config.checkpoint_path if writer else None,
                  progress=config.verbose)
    if config.sampler == "chees":
        from .chees import run_chees_resumed

        samples, info, _ = run_chees_resumed(vg, ckpt, config.niter_hmc, **common)
        return samples, info, samples.shape[0]
    if config.sampler == "pt-nuts":
        from .tempering import run_parallel_tempering_resumed

        s_pt, info, _ = run_parallel_tempering_resumed(
            vg, ckpt, config.niter_hmc, max_depth=config.max_tree_depth, **common)
        return _normalize_pt(s_pt, info)
    from .checkpoint import run_chains_resumed

    samples, info, _ = run_chains_resumed(vg, ckpt, config.niter_hmc,
                                          max_depth=config.max_tree_depth, **common)
    return samples, info, samples.shape[0]


def _check_device(device: torch.device) -> None:
    """The card must be there when the config asks for it (the default)."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MagiError(
            f"device {device} requested (the default) but torch finds no CUDA "
            "card; pass MagiConfig(device=\"cpu\") to run on the CPU."
        )


def _check_precision() -> None:
    """Float32 contractions must stay true float32 (no TF32)."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise MagiError(
            "TF32 is on; the MAGI operators need true float32 contractions. "
            "Set torch.backends.cuda.matmul.allow_tf32 = False, "
            "torch.backends.cudnn.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')."
        )


def resolve_gp_mean(gp_mean, y_obs: np.ndarray):
    """``gp_mean`` as the target takes it: "observed" becomes each
    component's mean observation (0 where it has none)."""
    if not isinstance(gp_mean, str):
        return gp_mean
    if gp_mean != "observed":
        raise MagiError(f"unknown gp_mean mode '{gp_mean}'")
    return np.array([
        float(col[np.isfinite(col)].mean()) if np.isfinite(col).any() else 0.0
        for col in y_obs.T
    ])


def resolve_band_impl(config: MagiConfig, n_times: int, n_dims: int,
                      bandsize: int, device: torch.device) -> str:
    """``band_impl="auto"``. Off the card, the JAX package's policy off a
    TPU (dense for n <= 1024, for an effective batch >= 8 while the dense
    stacks fit in 2 GiB, and for b > 64; else band). On the card, the rule
    of the layout sweep on the H100 (ms per replayed value-and-grad, n = 12
    to 3169, 1 to 128 chains; PERF.md §6): dense for a band that is
    wide, long and batched (the constants above) while the dense stacks fit
    in 2 GiB; else band."""
    if config.band_impl != "auto":
        check_band_impl(config.band_impl)
        return config.band_impl
    # the chains one value-and-grad evaluates: PT batches every rung of
    # every replica, whatever n_chains says
    eff_batch = (config.pt_temps * config.pt_replicas if config.sampler == "pt-nuts"
                 else config.n_chains)
    dense_fits = n_dims * 6 * n_times * n_times * 4 <= 2 << 30
    if device.type == "cuda":
        wide = AUTO_WIDE_BAND_DIVISOR * bandsize > n_times
        long = bandsize >= AUTO_DENSE_MIN_BANDWIDTH
        batched = eff_batch >= AUTO_DENSE_MIN_BATCH
        return "dense" if wide and long and batched and dense_fits else "band"
    if n_times <= 1024 or (eff_batch >= 8 and dense_fits) or bandsize > AUTO_BAND_MAX_BANDWIDTH:
        return "dense"
    return "band"


def _gn_stages(make_target_vg, gp_cov, y_obs, psi, prior_temps, theta_freeze, freeze, nd):
    """Staged Gauss-Newton MAP: a theta-only pre-stage against the frozen
    interpolated X (lands theta in the data basin), then full stages, first
    at beta_obs = 1 when the target tempers the observations."""
    stages = [prior_temps]
    if prior_temps[2] > 1.001:
        stages = [np.array([prior_temps[0], prior_temps[1], 1.0]), prior_temps]
    vg_0, target_0 = make_target_vg(stages[0])
    psi = gauss_newton_map(
        vg_0, gp_cov, y_obs, target_0, psi, stages[0], freeze=theta_freeze,
        n_newton=50, warn_on_cap=False,
    )
    budget = 200 if nd <= 1000 else 600
    for stage_temps in stages:
        vg_s, target_s = make_target_vg(stage_temps)
        psi = gauss_newton_map(
            vg_s, gp_cov, y_obs, target_s, psi, stage_temps, freeze=freeze,
            n_newton=budget,
        )
    return psi


def solve_magi(
    y_obs: np.ndarray,
    t_obs: np.ndarray,
    ode_system: OdeSystem,
    config: Optional[MagiConfig] = None,
    initial_params: Optional[np.ndarray] = None,
    mesh=None,
    resume=None,
) -> MagiResult:
    """Solve the MAGI inference problem; see MagiConfig for the options.
    ``initial_params`` optionally supplies Psi_0 = [vec(x); theta;
    log(sigma)]. ``resume``: a checkpoint (path or object) of an earlier
    call with the same data and config; a sampling-phase checkpoint
    continues sampling for ``niter_hmc`` more draws per chain, a
    warmup-phase one (NUTS under the pooled dense metric) continues that
    run's warmup.

    ``mesh`` (``parallel.make_chain_mesh`` or ``inference.tempering.
    make_replica_mesh``) shards the sampler's axis over the ranks: NUTS
    chains (``n_chains`` a multiple of the mesh size), PT replica ladders
    (``pt_replicas``) or ChEES chains. Every rank calls with the same data
    and config and gets the same result: rank 0 runs the host setup (NLML,
    GP covariances, MAP warm start, Gauss-Newton, whitener) and broadcasts
    it. The diagnostics' counts (transitions, host_syncs, tree_reads,
    doublings, lockstep_leaves, chain_leaves, graph_capture_s) are the
    rank's own. Under a mesh rank 0 writes the
    checkpoints of every chain; a warmup checkpoint resumes sharded (each
    rank takes its block), a sampling checkpoint unsharded on every rank."""
    config = config or MagiConfig()
    if config.sampler not in ("nuts", "pt-nuts", "chees"):
        raise MagiError(f"unknown sampler '{config.sampler}'")
    _check_precision()
    t_start = time.perf_counter()
    phase_times = {}
    y_obs = np.asarray(y_obs, dtype=np.float64)
    t_obs = np.asarray(t_obs, dtype=np.float64)
    if y_obs.ndim != 2:
        raise MagiError(f"y_obs must be (n_times, n_dims); got {y_obs.shape}")
    n_times, n_dims = y_obs.shape
    if t_obs.shape != (n_times,):
        raise MagiError("t_obs length must match y_obs rows")
    k = ode_system.theta_size
    nd = n_times * n_dims
    device = config.resolved_device()
    _check_device(device)
    dtype = config.resolved_dtype()
    if mesh is not None and mesh.device.type != device.type:
        raise MagiError(f"the mesh's device {mesh.device} is not the config's device {device}")

    try:
        parse_kernel_type(config.kernel)
    except ValueError:
        logger.warning("Unsupported kernel type '%s'. Defaulting to matern52.", config.kernel)
        config = dataclasses.replace(config, kernel="matern52")
    logger.info("MAGI solve: n=%d, D=%d, k=%d, kernel=%s, device=%s, dtype=%s",
                n_times, n_dims, k, config.kernel, device, dtype)

    # --- sigma fixed or sampled ---
    sigma_exo = np.asarray(config.sigma, dtype=np.float64) if config.sigma_provided else np.array([])
    phi_exo = np.asarray(config.phi, dtype=np.float64) if config.phi_provided else np.zeros((2, 0))
    sigma_is_fixed = config.sigma_is_fixed
    if sigma_is_fixed:
        if sigma_exo.shape != (n_dims,):
            raise MagiError(f":sigma must have length {n_dims}; got {sigma_exo.shape}")
        if phi_exo.shape != (2, n_dims):
            raise MagiError(f":phi must be (2, {n_dims}) when sigma is fixed; got {phi_exo.shape}")
    elif sigma_exo.size and not phi_exo.size:
        logger.warning("sigma provided without phi: sigma treated as unknown and re-initialized.")

    # --- phi / sigma initialization ---
    with trace.phase(phase_times, "nlml_s"):
        if phi_exo.size and sigma_is_fixed:
            phi_all, sigma_init = phi_exo, sigma_exo
        else:
            def nlml():
                guesses = default_initial_guesses(y_obs, t_obs)
                if phi_exo.size:
                    guesses[:, 0] = np.log(np.maximum(phi_exo[0], 1e-10))
                    guesses[:, 1] = np.log(np.maximum(phi_exo[1], 1e-10))
                optimized = optimize_gp_hyperparameters(
                    y_obs, t_obs, config.kernel, initial_log_params=guesses,
                    jitter=config.jitter, max_iters=config.gp_optim_iterations,
                    ftol=config.gp_optim_ftol, gtol=config.gp_optim_gtol,
                    show_trace=config.gp_optim_show_trace,
                )
                return (phi_exo if phi_exo.size else optimized[:, :2].T,
                        np.maximum(optimized[:, 2], 1e-8))

            phi_all, sigma_init = _from_root(mesh, nlml, np.zeros((2, n_dims)), np.zeros(n_dims))
    logger.info("phi:\n%s\ninitial sigma: %s%s", np.round(phi_all, 4),
                np.round(sigma_init, 4), " (fixed)" if sigma_is_fixed else "")
    if not (np.isfinite(phi_all).all() and (phi_all > 0).all()):
        raise MagiError(f"Invalid GP hyperparameters: {phi_all}")

    # --- x / theta init, GP covariances, the target, Psi_0 ---
    with trace.phase(phase_times, "gp_target_s"):
        if config.x_init is not None and np.asarray(config.x_init).size:
            x_init = np.asarray(config.x_init, dtype=np.float64)
            if x_init.shape != (n_times, n_dims):
                raise MagiError(f":xInit must be ({n_times}, {n_dims}); got {x_init.shape}")
        else:
            x_init = _init_x_interpolation(y_obs, t_obs)
        lo, hi = ode_system.theta_lower_bound, ode_system.theta_upper_bound
        if config.theta_init is not None and len(np.atleast_1d(config.theta_init)):
            theta_init = np.asarray(config.theta_init, dtype=np.float64)
            if theta_init.shape != (k,):
                raise MagiError(f":thetaInit must have length {k}")
            if (theta_init < lo).any() or (theta_init > hi).any():
                logger.warning("thetaInit outside bounds; clamping.")
                theta_init = np.clip(theta_init, lo, hi)
        else:
            theta_init = _init_theta_from_bounds(ode_system)

        # --- GP covariances: float64 on the host; the sampling copy is cast.
        # Under a mesh rank 0's bundle goes to every rank: the host float64
        # factorizations need not round alike on every rank's host ---
        gp_cov64 = None
        if mesh is None or mesh.rank == 0:
            gp_cov64 = build_gp_cov(
                config.kernel, phi_all, t_obs, bandsize=config.band_size, complexity=2,
                jitter=config.jitter, auto_escalate_bandsize=config.band_auto_escalate,
            )
        if mesh is not None:
            gp_cov64 = mesh.broadcast_object(gp_cov64)
        gp_cov = gp_cov64.to(dtype=dtype, device=device)

        prior_temps = np.asarray(config.prior_temperature, dtype=np.float64)
        if prior_temps.shape != (3,):
            logger.warning("priorTemperature should be [beta_deriv, beta_level, beta_obs]; "
                           "broadcasting scalar.")
            prior_temps = np.full(3, float(np.atleast_1d(prior_temps)[0]))
        band_impl = resolve_band_impl(config, n_times, n_dims, gp_cov.bandsize, device)
        logger.info("band_impl: %s (bandsize %d)", band_impl, gp_cov.bandsize)

        theta_transform = None
        if config.theta_constrained:
            theta_transform = make_theta_transform(lo, hi)

        gp_mean = resolve_gp_mean(config.gp_mean, y_obs)

        def build_target(cov, temps, impl):
            return MagiTarget.build(
                y_obs, cov, ode_system, sigma_init, temps, sigma_is_fixed,
                band_impl=impl, theta_transform=theta_transform, gp_mean=gp_mean,
            )

        target = build_target(gp_cov, prior_temps, band_impl)

        # --- Psi_0 ---
        if initial_params is not None:
            psi0 = np.asarray(initial_params, dtype=np.float64).copy()
            if psi0.shape != (target.dimension,):
                raise MagiError(
                    f"initial_params must have length {target.dimension} "
                    f"(sigma {'fixed' if sigma_is_fixed else 'sampled'}); got {psi0.shape}"
                )
            th = psi0[nd : nd + k]
            if (th < lo).any() or (th > hi).any():
                logger.warning("theta part of initial_params outside bounds; clamping.")
                psi0[nd : nd + k] = np.clip(th, lo, hi)
        else:
            parts = [x_init.T.reshape(-1), theta_init]
            if not sigma_is_fixed:
                parts.append(np.log(np.maximum(sigma_init, 1e-8)))
            psi0 = np.concatenate(parts)
        if theta_transform is not None:
            psi0[nd : nd + k] = unconstrain(theta_transform, psi0[nd : nd + k])
        logger.info("Sampling dimension: %d", psi0.shape[0])

    # --- optional Adam MAP warm start, in the working dtype on the device ---
    if config.map_init_iterations > 0:
        if theta_transform is None:
            map_lb, map_ub = lo, hi
        else:  # the theta slot holds unconstrained values
            map_lb, map_ub = np.full(k, -np.inf), np.full(k, np.inf)
        with trace.phase(phase_times, "map_s"):
            (psi0,) = _from_root(mesh, lambda: (map_warm_start(
                target.value_and_grad_fn(), psi0, config.map_init_iterations, config.map_init_lr,
                slice(nd, nd + k), map_lb, map_ub, dtype, device,
            ),), psi0)

    whitener = target_h = None
    if config.x_whitened:
        # --- staged Gauss-Newton MAP on a float64 dense CPU replica ---
        freeze = None if sigma_is_fixed else slice(nd + k, target.dimension)
        theta_freeze = np.ones(target.dimension, dtype=bool)
        theta_freeze[nd : nd + k] = False

        def make_target_vg(stage_temps):
            t_s = build_target(gp_cov64, stage_temps, "dense")
            return t_s.value_and_grad_fn(), t_s

        with trace.phase(phase_times, "gn_map_s"):
            (psi0,) = _from_root(mesh, lambda: (_gn_stages(
                make_target_vg, gp_cov64, y_obs, psi0, prior_temps, theta_freeze, freeze, nd),),
                psi0)

        # --- exact-Hessian whitener at the mode (GN precision as fallback) ---
        with trace.phase(phase_times, "whitener_s"):
            if mesh is None or mesh.rank == 0:
                target_h = build_target(gp_cov64, prior_temps, "dense")
                try:
                    whitener = build_psi_whitener_exact(target_h, psi0, dtype, device=device)
                except (np.linalg.LinAlgError, RuntimeError):
                    logger.warning("exact-Hessian whitener failed; using the GN precision.")
                    whitener = build_psi_whitener(
                        gp_cov64, y_obs, target_h, psi0, prior_temps, dtype, device=device
                    )
            else:
                dim = target.dimension
                empty = lambda *shape: torch.empty(shape, dtype=dtype, device=device)  # noqa: E731
                whitener = PsiWhitener(W=empty(dim, dim), L_T=empty(dim, dim), center=empty(dim))
            whitener = broadcast_tensors(mesh, whitener)
            vg = make_centered_whitened_vg(target, whitener)
            start = np.zeros(target.dimension)  # zeta = 0 is the mode
    else:
        # raw Psi: the target's own value-and-grad, no mode-centering
        vg = target.value_and_grad_fn()
        start = psi0

    # --- the divergence-informed curvature envelope: exact float64 Hessian
    # probes at divergent warmup steps, on the host replica target_h (rank
    # 0's; the other ranks never probe); the sampler's starts ---
    with trace.phase(phase_times, "sampler_setup_s"):
        envelope = None
        if config.divergence_envelope and config.sampler == "nuts":
            if config.mass_matrix != "dense-pooled" or whitener is None:
                logger.warning(
                    "divergence_envelope requires sampler='nuts' with "
                    "mass_matrix='dense-pooled' and x_whitened=True; disabled."
                )
            else:
                probes = envelope_probes(target_h, whitener) if target_h is not None else (None,)
                envelope = CurvatureEnvelope(*probes, max_points=config.envelope_max_points)

        n_chains = int(config.n_chains)
        n_adapts = int(np.floor(config.niter_hmc * config.burnin_ratio))
        starts = np.tile(start, (n_chains, 1))
        if config.chain_init_jitter > 0 and n_chains > 1:
            rng_init = np.random.default_rng(config.seed + INIT_JITTER_SEED_OFFSET)
            starts[1:] += config.chain_init_jitter * rng_init.standard_normal(starts[1:].shape)
        generator = torch.Generator(device=device).manual_seed(int(config.seed))
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        warmup_resume = None
        if resume is not None:
            resume = _load_resume(resume, config, target.dimension, mesh)
            if getattr(resume, "phase", "sampling") == "warmup":
                if config.sampler != "nuts" or config.mass_matrix != "dense-pooled":
                    raise MagiError(
                        "warmup-phase checkpoints resume only for sampler='nuts' with "
                        "mass_matrix='dense-pooled'; other samplers restart warmup."
                    )
                warmup_resume, resume = resume, None
    # --- the sampler on the sampling device ---
    with trace.timed("phase.sampler") as sampler, _trace_sampling(config.profile_dir, device,
                                                                    mesh):
        if resume is not None:
            samples, info, n_chains = _run_resumed(vg, resume, config, dtype, device, mesh)
            if mesh is not None:  # rank 0's checkpoint file is complete
                mesh.barrier()
        elif config.sampler == "chees":
            from .chees import run_chees

            samples, info = run_chees(
                vg, put(starts), generator, n_samples=config.niter_hmc, n_adapts=n_adapts,
                initial_step_size=config.step_size_factor, target_accept=config.target_accept_ratio,
                chunk_size=config.chunk_size, progress=config.verbose,
                criterion=config.chees_criterion, checkpoint_path=config.checkpoint_path,
                mesh=mesh,
            )
        elif config.sampler == "pt-nuts":
            from .tempering import run_parallel_tempering

            if n_chains != 1:
                logger.warning("sampler='pt-nuts' runs pt_replicas independent temperature "
                               "ladders; n_chains=%d ignored.", n_chains)
            s_pt, info = run_parallel_tempering(
                vg, put(starts[0]), generator, n_samples=config.niter_hmc, n_adapts=n_adapts,
                n_temps=config.pt_temps, max_temp=config.pt_max_temp,
                initial_step_size=config.step_size_factor, target_accept=config.target_accept_ratio,
                max_depth=config.max_tree_depth, chunk_size=config.chunk_size,
                progress=config.verbose, ladder_adapt=config.pt_ladder_adapt,
                checkpoint_path=config.checkpoint_path, n_replicas=int(config.pt_replicas),
                mass_matrix=config.mass_matrix, mesh=mesh,
            )
            samples, info, n_chains = _normalize_pt(s_pt, info)
        else:
            samples, info = run_chains(
                vg,
                put(starts),
                generator,
                n_samples=config.niter_hmc,
                n_adapts=n_adapts,
                initial_step_size=config.step_size_factor,
                target_accept=config.target_accept_ratio,
                max_depth=config.max_tree_depth,
                chunk_size=config.chunk_size,
                progress=config.verbose,
                mass_matrix=config.mass_matrix,
                step_jitter=config.step_jitter,
                step_jitter_low=config.step_jitter_low,
                jitter_rng=np.random.default_rng(config.seed + STEP_JITTER_SEED_OFFSET),
                checkpoint_path=config.checkpoint_path,
                resume_ckpt=warmup_resume,
                envelope=envelope,
                mesh=mesh,
            )
    phase_times["warmup_s"] = info["warmup_time_s"]
    phase_times["sampling_s"] = info["sampling_time_s"]
    # the sampler's own set-up (its graph captures outside warmup, its results)
    phase_times["sampler_setup_s"] += max(
        sampler.seconds - info["warmup_time_s"] - info["sampling_time_s"], 0.0)

    # --- results ---
    with trace.phase(phase_times, "results_s"):
        n_keep = samples.shape[1]
        if whitener is not None and n_keep:
            # one (C, dim) product per draw: a BLAS product's rounding of a row
            # can depend on how many rows it is given, and a resumed leg holds
            # fewer draws than the uninterrupted run it must equal bit for bit
            samples = np.stack(
                [zeta_to_psi_np(whitener, samples[:, s]) for s in range(n_keep)], axis=1
            )
        flat = samples.reshape(n_chains * n_keep, -1)
        x_samples = flat[:, :nd].reshape(-1, n_dims, n_times).transpose(0, 2, 1)
        theta_samples = flat[:, nd : nd + k]
        if theta_transform is not None:
            theta_samples = constrain_np(theta_transform, theta_samples)
        if sigma_is_fixed:
            sigma_samples = np.tile(sigma_init, (flat.shape[0], 1))
        else:
            sigma_samples = np.exp(flat[:, nd + k :])
        n_div = int(np.sum(info["diverging"]))
        if n_div:
            logger.warning("%d divergent transitions after warmup.", n_div)

    diagnostics = {
        "accept_prob": info["accept_prob"],
        "num_leapfrog": info["num_leapfrog"],
        "tree_depth": info["tree_depth"],
        "diverging": info["diverging"],
        "energy": info["energy"],
        "step_size": info["step_size"],
        "inv_mass": info["inv_mass"],
        "n_divergent": n_div,
        "n_chains": n_chains,
        "final_psi": info["final_psi"],  # the sampler's coordinates (zeta when whitened)
        "final_key": info["final_key"],
        "lp_per_chain": info["lp"],
        "theta_per_chain": theta_samples.reshape(n_chains, n_keep, k),
        "sampling_time_s": info["sampling_time_s"],
        "phase_times_s": phase_times,
        "total_time_s": time.perf_counter() - t_start,
        "gradient_evals": float(np.sum(info["num_leapfrog"])),
        "transitions": info["transitions"],
        "host_syncs": info["host_syncs"],
        "tree_reads": info["tree_reads"],
        "doublings": info["doublings"],
        "graph_capture_s": info["graph_capture_s"],
        "lockstep_leaves": info["lockstep_leaves"],
        "chain_leaves": info["chain_leaves"],
        "sigma_is_fixed": sigma_is_fixed,
        "sampler": config.sampler,
        "band_impl": band_impl,
        "bandsize": int(gp_cov.bandsize),
        # what the sampler ran on: its value-and-grad is
        # make_centered_whitened_vg(target, whitener), or the target's own
        # without a whitener; its route: "kernel" or "autograd" (whitened),
        # "raw"
        "target": target,
        "whitener": whitener,
        "vg_route": getattr(vg, "route", None) if whitener is not None else "raw",
        "device": str(device),
        "dtype": str(dtype),
    }
    for key in ("metric", "vg_evals", "trajectory_length",
                "trajectory_warmup_trace", "swap_acceptance", "swap_acceptance_per_pair",
                "temperatures", "accept_prob_per_rung", "tree_depth_per_rung",
                "envelope_points", "envelope_boost_dirs", "envelope_boost_max",
                "envelope_probe_seconds"):
        if key in info:
            diagnostics[key] = info[key]
    return MagiResult(
        theta=theta_samples,
        x_sampled=x_samples,
        sigma=sigma_samples,
        phi=np.asarray(phi_all),
        lp=info["lp"].reshape(-1),
        diagnostics=diagnostics,
    )
