"""ChEES-HMC (port of the JAX package's inference/chees.py): jittered HMC
whose trajectory length adapts by Adam ascent on the ChEES criterion
(Hoffman, Radul & Sountsov 2021) or on SNAPER's principal-component
projection (Sountsov & Hoffman 2021).

Every chain runs the same number of leapfrog steps in an iteration, so the
C chains are one (C, dim) batch with no lockstep waste. The step count
n_steps = clip(ceil(T * u / eps), 1, MAX_LEAPFROG), with u the iteration's
Halton value, is read on the host once per iteration; the steps then run
back to back as half-kick, drift, value-and-grad, half-kick, with no branch
per step. On the card the whole step is replayed from one CUDA graph
(``Leapfrog``). The cross-chain statistics (centring means, the criterion
gradient, the harmonic-mean acceptance, Welford moments and the principal
component) stay on the device.

The transition is split into a draw-free core (``chees_core``: the momenta
and accept uniforms are inputs) and the draws (``chees_transition``), so a
test can feed the core the JAX package's own draws.

Under a chain mesh (``parallel/chains.make_chain_mesh``) each rank runs a
block of the chains, and every cross-chain mean or sum becomes a
``pmean``/``psum`` over the ranks (exact for equal blocks, which the
divisibility check enforces), so every rank adapts the same step size,
trajectory length, metric and principal component, and reads the same
n_steps. Each rank draws the random numbers of all chains and keeps its
block, as the NUTS transition does.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import default_device, default_dtype
from ..parallel.chains import GRAPH_WARMUP_CALLS, Counts, capture_graph, write_checkpoint
from ..parallel.mesh import Mesh, gather_rows, local_draw
from . import checkpoint as ckpt_io
from .adapt import DualAveragingState, build_window_schedule, da_init, da_update
from .nuts import NutsStats
from .nuts_batched import add_kernel_launches

logger = logging.getLogger(__name__)

MAX_LEAPFROG = 1000
MAX_DELTA_ENERGY = 1000.0


def _gmean(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Mean over the (possibly sharded) chain axis: the block mean, then its
    pmean over the ranks."""
    m = torch.mean(x, dim=0)
    return m if mesh is None else mesh.pmean(m)


def _gsum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum over the (possibly sharded) chain axis."""
    s = torch.sum(x, dim=0)
    return s if mesh is None else mesh.psum(s)


def halton(i: int, base: int = 2) -> float:
    """Radical-inverse (van der Corput) value of index i + 1 in ``base``,
    over 31 digits, in float64 (the JAX package's arithmetic)."""
    ii = (int(i) + 1) & 0xFFFFFFFF
    f = 1.0 / base
    val = 0.0
    for _ in range(31):
        val = val + (ii % base) * f
        f = f / base
        ii = ii // base
    return val


class CheesState(NamedTuple):
    qs: torch.Tensor      # (C, dim)
    logps: torch.Tensor   # (C,)
    grads: torch.Tensor   # (C, dim)
    iteration: int        # host: drives the Halton jitter


class CheesAdaptState(NamedTuple):
    da: DualAveragingState        # step size (scalar)
    traj_length: torch.Tensor     # current T (unjittered mean length)
    traj_adam_m: torch.Tensor
    traj_adam_v: torch.Tensor
    traj_count: torch.Tensor
    welford_count: torch.Tensor
    welford_mean: torch.Tensor    # (dim,)
    welford_m2: torch.Tensor      # (dim,)
    inv_mass: torch.Tensor        # (dim,)
    pc: torch.Tensor              # (dim,) running principal component (SNAPER)
    log_t_ema: torch.Tensor       # iterate average of log T, carried into sampling


def chees_init(vg_b: Callable, qs: torch.Tensor, initial_step_size: float,
               initial_traj_length: float | None = None):
    """Evaluate the start positions; start the adaptation with T at 32
    steps' worth unless given, a unit metric and a uniform principal
    component."""
    dtype, device = qs.dtype, qs.device
    dim = qs.shape[1]
    logps, grads = vg_b(qs)
    t0 = initial_traj_length if initial_traj_length else initial_step_size * 32.0
    scalar = lambda v: torch.tensor(v, dtype=dtype, device=device)
    zero = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    adapt = CheesAdaptState(
        da=da_init(scalar(initial_step_size)),
        traj_length=scalar(t0),
        traj_adam_m=zero(), traj_adam_v=zero(), traj_count=zero(),
        welford_count=zero(), welford_mean=zero(dim), welford_m2=zero(dim),
        inv_mass=torch.ones(dim, dtype=dtype, device=device),
        pc=torch.full((dim,), 1.0 / np.sqrt(dim), dtype=dtype, device=device),
        log_t_ema=torch.log(scalar(t0)),
    )
    return CheesState(qs=qs, logps=logps, grads=grads, iteration=0), adapt


def _leapfrog_step(vg_b, qs, ps, grads, eps, inv_mass):
    """One batched leapfrog step, in the JAX package's operation order."""
    ps_half = ps + 0.5 * eps * grads
    qs_new = qs + eps * inv_mass[None, :] * ps_half
    logps_new, grads_new = vg_b(qs_new)
    ps_new = ps_half + 0.5 * eps * grads_new
    return qs_new, ps_new, grads_new, logps_new


def _leapfrog_batch(vg_b, qs, ps, grads, eps, inv_mass, n_steps: int):
    """n_steps batched leapfrog steps of all chains. Returns (qs, ps, grads,
    logps) at the end (logps zero when n_steps is 0)."""
    logps = torch.zeros(qs.shape[0], dtype=qs.dtype, device=qs.device)
    for _ in range(n_steps):
        qs, ps, grads, logps = _leapfrog_step(vg_b, qs, ps, grads, eps, inv_mass)
    return qs, ps, grads, logps


class Leapfrog:
    """``_leapfrog_batch`` at fixed (C, dim): eager on the CPU; on the card
    one step (value-and-grad included) is captured in a CUDA graph over
    static buffers, and n steps are n replays. eps and the inverse mass are
    buffers of the graph, updated in place."""

    def __init__(self, vg_b, qs: torch.Tensor):
        self.vg_b = vg_b
        self.graph = None
        self.eager_calls = 0
        if qs.device.type != "cuda":
            return
        c, dim = qs.shape
        self.q, self.p, self.g = (qs.detach().clone() for _ in range(3))
        self.lp = torch.zeros(c, dtype=qs.dtype, device=qs.device)
        self.eps = torch.zeros((), dtype=qs.dtype, device=qs.device)
        self.inv_mass = torch.ones(dim, dtype=qs.dtype, device=qs.device)
        self.graph, self.launches, _ = capture_graph(self._step, qs.device)
        self.eager_calls = GRAPH_WARMUP_CALLS

    def _step(self):
        out = _leapfrog_step(self.vg_b, self.q, self.p, self.g, self.eps, self.inv_mass)
        for buf, value in zip((self.q, self.p, self.g, self.lp), out):
            buf.copy_(value)

    def __call__(self, qs, ps, grads, eps, inv_mass, n_steps: int):
        if self.graph is None:
            return _leapfrog_batch(self.vg_b, qs, ps, grads, eps, inv_mass, n_steps)
        for buf, value in zip((self.q, self.p, self.g, self.eps, self.inv_mass),
                              (qs, ps, grads, eps, inv_mass)):
            buf.copy_(value)
        for _ in range(n_steps):
            self.graph.replay()
        add_kernel_launches({k: n * n_steps for k, n in self.launches.items()})
        return self.q.clone(), self.p.clone(), self.g.clone(), self.lp.clone()


def n_leapfrog_steps(traj_length, eps, u: float, max_leapfrog: int = MAX_LEAPFROG):
    """(n_steps read on the host, the jitter u as a tensor):
    clip(ceil(T * u / eps), 1, max_leapfrog) in the working dtype."""
    u_t = torch.as_tensor(u, dtype=eps.dtype, device=eps.device)
    n = torch.ceil(traj_length * u_t / eps)
    return int(torch.nan_to_num(n, nan=1.0).clamp(1, max_leapfrog)), u_t


def chees_core(vg_b, qs, logps, grads, z, accept_u, eps, inv_mass, n_steps: int, u, pc=None,
               leapfrog=None, mesh=None):
    """The draw-free ChEES transition: momenta p = z / sqrt(inv_mass) from
    standard normals ``z`` (C, dim), ``n_steps`` leapfrog steps, accept by
    ``accept_u`` (C,); the criterion gradient (ChEES, or SNAPER with a unit
    vector ``pc``) from the proposals and cross-chain means (over all the
    mesh's chains), scaled by the jitter ``u``. Returns (qs, logps, grads,
    info)."""
    c = qs.shape[0]
    ps = z / torch.sqrt(inv_mass)[None, :]
    h0 = -logps + 0.5 * torch.sum(ps * ps * inv_mass[None, :], dim=1)
    run = leapfrog or (lambda *a: _leapfrog_batch(vg_b, *a))
    qs_new, ps_new, grads_new, logps_new = run(qs, ps, grads, eps, inv_mass, n_steps)
    h1 = -logps_new + 0.5 * torch.sum(ps_new * ps_new * inv_mass[None, :], dim=1)
    delta = h1 - h0
    log_accept = torch.where(torch.isnan(delta), -torch.inf, -delta)
    accept_prob = torch.exp(torch.clamp(log_accept, max=0.0))
    accept = accept_u < accept_prob
    qs_out = torch.where(accept[:, None], qs_new, qs)
    logps_out = torch.where(accept, logps_new, logps)
    grads_out = torch.where(accept[:, None], grads_new, grads)

    qc = qs - _gmean(qs, mesh)[None, :]
    qnc = qs_new - _gmean(qs_new, mesh)[None, :]
    vs_new = ps_new * inv_mass[None, :]
    if pc is None:
        dsq = torch.sum(qnc * qnc, dim=1) - torch.sum(qc * qc, dim=1)
        proj = torch.sum(qnc * vs_new, dim=1)
    else:
        a0, a1 = qc @ pc, qnc @ pc
        dsq = a1 * a1 - a0 * a0
        proj = a1 * (vs_new @ pc)
    w = accept_prob * dsq * proj
    chees_grad = _gsum(w, mesh) / (_gsum(accept_prob, mesh) + 1e-6) * u
    info = {
        "accept_prob": accept_prob,
        "accepted": accept,
        "num_leapfrog": torch.full((c,), n_steps, dtype=torch.int32, device=qs.device),
        "energy": h0,
        "diverging": delta > MAX_DELTA_ENERGY,
        "chees_grad": chees_grad,
        "traj_actual": n_steps * eps,
        "n_steps": n_steps,
    }
    return qs_out, logps_out, grads_out, info


def chees_transition(vg_b, state: CheesState, eps, inv_mass, traj_length, generator,
                     max_leapfrog: int = MAX_LEAPFROG, pc=None, leapfrog=None, mesh=None):
    """One jittered-HMC iteration of all chains (of this rank's block under
    a mesh): draws the momenta and the accept uniforms from ``generator``,
    reads n_steps once. Returns (new_state, info)."""
    c, dim = state.qs.shape
    dtype, device = state.qs.dtype, state.qs.device
    n_steps, u = n_leapfrog_steps(traj_length, eps, halton(state.iteration), max_leapfrog)
    z = local_draw(torch.randn, generator, (c, dim), 0, mesh, dtype, device)
    accept_u = local_draw(torch.rand, generator, (c,), 0, mesh, dtype, device)
    qs, logps, grads, info = chees_core(vg_b, state.qs, state.logps, state.grads, z, accept_u,
                                        eps, inv_mass, n_steps, u, pc=pc, leapfrog=leapfrog,
                                        mesh=mesh)
    return CheesState(qs=qs, logps=logps, grads=grads, iteration=state.iteration + 1), info


def chees_adapt_update(adapt: CheesAdaptState, qs, info, target_accept: float, eps,
                       adam_lr: float = 0.025, t_ema_rate: float = 0.01,
                       mesh: Mesh | None = None) -> CheesAdaptState:
    """Warmup update: dual averaging on the harmonic-mean acceptance, Adam
    on log T along the criterion gradient (step clipped to +-0.1, T kept in
    [4 eps, MAX_LEAPFROG eps]), its iterate average, Welford over all
    chains' draws and one Oja step of the principal component. Under a
    mesh every cross-chain reduction is a psum/pmean over the ranks."""
    c = qs.shape[0] * (1 if mesh is None else mesh.size)
    c_glob = torch.tensor(float(c), dtype=qs.dtype, device=qs.device)
    hmean = 1.0 / _gmean(1.0 / torch.clamp(info["accept_prob"], min=1e-10), mesh)
    da = da_update(adapt.da, hmean, target_accept)

    g = info["chees_grad"] * adapt.traj_length
    g = torch.where(torch.isfinite(g), g, 0.0)
    b1, b2 = 0.9, 0.95
    t = adapt.traj_count + 1.0
    m = b1 * adapt.traj_adam_m + (1 - b1) * g
    v = b2 * adapt.traj_adam_v + (1 - b2) * g * g
    mhat = m / (1 - torch.pow(b1, t))
    vhat = v / (1 - torch.pow(b2, t))
    step = torch.clamp(adam_lr * mhat / (torch.sqrt(vhat) + 1e-8), -0.1, 0.1)
    log_t = torch.log(adapt.traj_length) + step
    traj_length = torch.minimum(torch.maximum(torch.exp(log_t), 4.0 * eps), eps * MAX_LEAPFROG)
    log_t_ema = adapt.log_t_ema + t_ema_rate * (torch.log(traj_length) - adapt.log_t_ema)

    count = adapt.welford_count + c_glob
    delta = qs - adapt.welford_mean[None, :]
    mean = adapt.welford_mean + _gsum(delta, mesh) / count
    m2 = adapt.welford_m2 + _gsum(delta * (qs - mean[None, :]), mesh)

    qc = qs - mean[None, :]
    su = qc.T @ (qc @ adapt.pc)
    sigma_u = (su if mesh is None else mesh.psum(su)) / c_glob
    eta = 1.0 / torch.sqrt(t + 10.0)
    pc_new = adapt.pc + eta * sigma_u
    norm = torch.sqrt(torch.sum(pc_new * pc_new))
    pc_new = torch.where(norm > 1e-12, pc_new / norm, adapt.pc)
    pc_new = torch.where(torch.all(torch.isfinite(pc_new)), pc_new, adapt.pc)
    return CheesAdaptState(
        da=da, traj_length=traj_length, traj_adam_m=m, traj_adam_v=v, traj_count=t,
        welford_count=count, welford_mean=mean, welford_m2=m2, inv_mass=adapt.inv_mass,
        pc=pc_new, log_t_ema=log_t_ema,
    )


def chees_refresh_mass(adapt: CheesAdaptState) -> CheesAdaptState:
    """At a window end: the inverse metric from the accumulated Welford
    moments (Stan's shrinkage), the moments reset, dual averaging and the
    trajectory Adam restarted (T itself and its average stay)."""
    n = adapt.welford_count
    var = adapt.welford_m2 / torch.clamp(n - 1.0, min=1.0)
    w = n / (n + 5.0)
    inv_mass = torch.where(n > 1.0, w * var + 1e-3 * (1.0 - w), adapt.inv_mass)
    zero = torch.zeros_like(adapt.traj_adam_m)
    return adapt._replace(
        welford_count=torch.zeros_like(adapt.welford_count),
        welford_mean=torch.zeros_like(adapt.welford_mean),
        welford_m2=torch.zeros_like(adapt.welford_m2),
        inv_mass=inv_mass,
        da=da_init(torch.exp(adapt.da.log_eps)),
        traj_adam_m=zero, traj_adam_v=zero, traj_count=zero,
    )


def chees_checkpoint(state: CheesState, adapt: CheesAdaptState, eps, inv_mass, traj_length,
                     generator, n_samples_drawn: int = 0,
                     mesh: Mesh | None = None) -> ckpt_io.SamplerCheckpoint:
    """A sampling-phase SamplerCheckpoint for ChEES: the frozen step size,
    metric and trajectory length, the Halton index and the trajectory Adam
    state in ``meta`` (the JAX package's keys), and the log-densities,
    gradients and principal component in ``state``; under a chain mesh
    every rank's chains, gathered (every rank must call it)."""
    if mesh is not None:
        state = state._replace(**{name: gather_rows(mesh, getattr(state, name))
                                  for name in ("qs", "logps", "grads")})
    rng_state, rng_device = ckpt_io.generator_state(generator)
    return ckpt_io.SamplerCheckpoint(
        psi=state.qs.cpu().numpy(),
        step_size=np.atleast_1d(eps.cpu().numpy()),
        inv_mass=np.atleast_2d(inv_mass.cpu().numpy()),
        rng_state=rng_state, rng_device=rng_device,
        n_samples_drawn=int(n_samples_drawn),
        meta={
            "sampler": "chees",
            "trajectory_length": float(traj_length),
            "iteration": int(state.iteration),
            "traj_adam_m": float(adapt.traj_adam_m),
            "traj_adam_v": float(adapt.traj_adam_v),
            "traj_count": float(adapt.traj_count),
        },
        state={"logp": state.logps.cpu().numpy(), "grad": state.grads.cpu().numpy(),
               "pc": adapt.pc.cpu().numpy()},
    )


def _sample(vg_b, leapfrog, state, adapt, eps, inv_mass, traj, generator, n_keep, chunk_size,
            counts, progress, t0, checkpoint_path, drawn0=0, mesh=None):
    """The sampling phase at frozen eps, metric and T. Returns (state,
    per-chunk host arrays (C, L, ...), last checkpoint or None)."""
    names = ("samples", "lp", "accept_prob", "num_leapfrog", "diverging")
    parts = {name: [] for name in names}
    c = state.qs.shape[0]
    pos, last = 0, None
    while pos < n_keep:
        length = min(chunk_size, n_keep - pos)
        cols = {name: [] for name in names}
        for _ in range(length):
            state, info = chees_transition(vg_b, state, eps, inv_mass, traj, generator,
                                           leapfrog=leapfrog, mesh=mesh)
            counts.add(_step_stats(info))
            for name, value in zip(names, (state.qs, state.logps, info["accept_prob"],
                                           info["num_leapfrog"], info["diverging"])):
                cols[name].append(value)
        for name in names:
            parts[name].append(torch.stack(cols[name], dim=1).cpu().numpy())
        pos += length
        if checkpoint_path:
            c_all = c * (1 if mesh is None else mesh.size)
            last = chees_checkpoint(state, adapt, eps, inv_mass, traj, generator,
                                    drawn0 + c_all * pos, mesh)
            write_checkpoint(mesh, checkpoint_path, last)
        if progress:
            logger.info("chees sampling %d/%d (%.1fs)", pos, n_keep, time.perf_counter() - t0)
    return state, parts, last


def _step_stats(info) -> NutsStats:
    """An iteration's counts for ``parallel.chains.Counts``: one host read
    (n_steps), n_steps leapfrog steps run by every chain."""
    return NutsStats(accept_prob=info["accept_prob"], num_leapfrog=info["num_leapfrog"],
                     tree_depth=None, diverging=info["diverging"], energy=info["energy"],
                     step_size=None, host_syncs=1, lockstep_leaves=info["n_steps"])


def _info(state, parts, eps, inv_mass, traj, generator, counts, vg_evals, mesh=None, **extra):
    if mesh is not None:  # every chain's draws and state, on every rank
        parts = {name: [mesh.gather_np(p) for p in chunks] for name, chunks in parts.items()}
        state = state._replace(qs=mesh.all_gather(state.qs))
    c, dim = state.qs.shape
    cat = lambda name, empty: (np.concatenate(parts[name], axis=1) if parts[name] else empty)
    lp = cat("lp", np.zeros((c, 0)))
    leap = cat("num_leapfrog", np.zeros((c, 0), dtype=np.int32))
    return cat("samples", np.zeros((c, 0, dim))), dict(
        lp=lp,
        accept_prob=cat("accept_prob", np.zeros((c, 0))),
        num_leapfrog=leap,
        tree_depth=np.zeros_like(leap),
        diverging=cat("diverging", np.zeros((c, 0), dtype=bool)),
        energy=np.zeros_like(lp),
        step_size=eps.cpu().numpy(),
        inv_mass=inv_mass.cpu().numpy(),
        trajectory_length=float(traj),
        final_psi=state.qs.cpu().numpy(),
        final_key=generator.get_state().numpy(),
        warmup_diverging=np.zeros((c, 0)),
        vg_evals=vg_evals,
        **counts.info(),
        **extra,
    )


def run_chees(
    vg: Callable,
    psi0: torch.Tensor,
    generator: torch.Generator,
    n_samples: int,
    n_adapts: int,
    initial_step_size: float = 0.1,
    target_accept: float = 0.75,
    chunk_size: int = 2000,
    progress: bool = False,
    init_jitter: float = 1e-3,
    initial_traj_length: float | None = None,
    adapt_trajectory: bool = True,
    criterion: str = "snaper",
    checkpoint_path: str | None = None,
    mesh: Mesh | None = None,
):
    """Run C ChEES-HMC chains from psi0 (C, dim); ``vg`` maps (C, dim) ->
    ((C,), (C, dim)); random numbers come from ``generator``. Returns
    (samples (C, S, dim) numpy, info dict).

    ``init_jitter`` disperses chains 1..C-1 around psi0 (the criterion is a
    cross-chain statistic). ``criterion``: "snaper" (default) or "chees".
    ``adapt_trajectory=False`` pins T at its start value. The metric
    refreshes at the Stan window ends. ``checkpoint_path``: a
    SamplerCheckpoint after every sampling chunk (``run_chees_resumed``).

    ``mesh`` (``parallel/chains.make_chain_mesh``): every rank calls with
    the same arguments (psi0 of all C chains, a generator seeded alike) and
    runs C/size chains (C must be a multiple of the mesh size); each returns
    the draws of all C chains, with the rank's own counts; rank 0 writes
    the checkpoints."""
    if criterion not in ("chees", "snaper"):
        raise ValueError(f"unknown trajectory criterion '{criterion}'")
    c, dim = psi0.shape
    n_keep = n_samples - n_adapts
    if mesh is not None:
        mesh.check_divides(c, "n_chains")
    if init_jitter > 0 and c > 1:
        noise = init_jitter * torch.randn(psi0.shape, generator=generator, dtype=psi0.dtype,
                                          device=psi0.device)
        psi0 = torch.cat([psi0[:1], psi0[1:] + noise[1:]])
    if mesh is not None:
        psi0 = psi0[mesh.block(c)]
    t0 = time.perf_counter()
    state, adapt = chees_init(vg, psi0, initial_step_size, initial_traj_length)
    leapfrog = Leapfrog(vg, psi0)
    t_pinned = adapt.traj_length
    _, window_end = build_window_schedule(n_adapts)
    use_pc = criterion == "snaper"
    # iterate-averaging rate of log T: ~1/8 of warmup
    t_ema_rate = 1.0 / max(n_adapts / 8.0, 50.0)
    counts = Counts()
    ttrace = []
    for pos in range(n_adapts):
        eps = torch.exp(adapt.da.log_eps)
        state, info = chees_transition(vg, state, eps, adapt.inv_mass, adapt.traj_length,
                                       generator, pc=adapt.pc if use_pc else None,
                                       leapfrog=leapfrog, mesh=mesh)
        counts.add(_step_stats(info))
        adapt = chees_adapt_update(adapt, state.qs, info, target_accept, eps,
                                   t_ema_rate=t_ema_rate, mesh=mesh)
        if not adapt_trajectory:
            adapt = adapt._replace(traj_length=t_pinned, log_t_ema=torch.log(t_pinned))
        if window_end[pos]:
            adapt = chees_refresh_mass(adapt)
        ttrace.append(adapt.traj_length)
        if progress and (pos + 1) % chunk_size == 0:
            logger.info("chees warmup %d/%d (%.1fs)", pos + 1, n_adapts,
                        time.perf_counter() - t0)
    eps_final = torch.exp(adapt.da.log_eps_avg)
    inv_mass_final = adapt.inv_mass
    traj_final = torch.exp(adapt.log_t_ema)
    warmup_time = time.perf_counter() - t0
    t1 = time.perf_counter()
    state, parts, _ = _sample(vg, leapfrog, state, adapt, eps_final, inv_mass_final, traj_final,
                              generator, n_keep, chunk_size, counts, progress, t0,
                              checkpoint_path, mesh=mesh)
    vg_evals = 1 + leapfrog.eager_calls + counts.lockstep_leaves
    return _info(
        state, parts, eps_final, inv_mass_final, traj_final, generator, counts, vg_evals, mesh,
        trajectory_warmup_trace=(torch.stack(ttrace).cpu().numpy() if ttrace else np.zeros(0)),
        warmup_time_s=warmup_time, sampling_time_s=time.perf_counter() - t1,
    )


def run_chees_resumed(
    vg: Callable,
    ckpt,
    n_samples: int,
    chunk_size: int = 2000,
    dtype=None,
    device=None,
    checkpoint_path: str | None = None,
    progress: bool = False,
):
    """Continue ChEES sampling from a checkpoint: frozen step size, metric
    and trajectory length, the Halton sequence and the generator where they
    stopped. Returns (samples (C, S, dim), info, new_checkpoint)."""
    if not (ckpt.meta and ckpt.meta.get("sampler") == "chees"):
        raise ValueError("not a ChEES checkpoint (meta.sampler != 'chees')")
    ckpt_io.check_port_checkpoint(ckpt)
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    generator = ckpt_io.restore_generator(ckpt.rng_state, ckpt.rng_device, device)
    state_arrays = ckpt.state or {}
    qs = put(ckpt.psi)
    c, dim = qs.shape
    eps = put(ckpt.step_size).reshape(())
    inv_mass = put(ckpt.inv_mass).reshape(dim)
    traj = put(ckpt.meta["trajectory_length"])
    t0 = time.perf_counter()
    resumed_evals = 0
    if "logp" in state_arrays and "grad" in state_arrays:
        logps, grads = put(state_arrays["logp"]), put(state_arrays["grad"])
    else:  # a converted JAX checkpoint: evaluate at the saved positions
        logps, grads = vg(qs)
        resumed_evals = 1
    state = CheesState(qs=qs, logps=logps, grads=grads,
                       iteration=int(ckpt.meta.get("iteration", 0)))
    scalar = lambda key: put(float(ckpt.meta.get(key, 0.0)))
    adapt = CheesAdaptState(
        da=da_init(eps), traj_length=traj, traj_adam_m=scalar("traj_adam_m"),
        traj_adam_v=scalar("traj_adam_v"), traj_count=scalar("traj_count"),
        welford_count=put(0.0), welford_mean=torch.zeros_like(inv_mass),
        welford_m2=torch.zeros_like(inv_mass), inv_mass=inv_mass,
        pc=(put(state_arrays["pc"]) if "pc" in state_arrays
            else torch.full((dim,), 1.0 / np.sqrt(dim), dtype=dtype, device=device)),
        log_t_ema=torch.log(traj),
    )
    leapfrog = Leapfrog(vg, qs)
    counts = Counts()
    drawn0 = int(ckpt.n_samples_drawn)
    state, parts, last = _sample(vg, leapfrog, state, adapt, eps, inv_mass, traj, generator,
                                 n_samples, chunk_size, counts, progress, t0, checkpoint_path,
                                 drawn0)
    if last is None:
        last = chees_checkpoint(state, adapt, eps, inv_mass, traj, generator,
                                drawn0 + c * n_samples)
    vg_evals = resumed_evals + leapfrog.eager_calls + counts.lockstep_leaves
    samples, info = _info(state, parts, eps, inv_mass, traj, generator, counts, vg_evals,
                          warmup_time_s=0.0, sampling_time_s=time.perf_counter() - t0)
    return samples, info, last
