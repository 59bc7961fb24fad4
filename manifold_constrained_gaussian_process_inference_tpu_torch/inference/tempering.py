"""Parallel tempering over a temperature ladder of NUTS chains (port of the
JAX package's inference/tempering.py).

The MAGI posterior can be multimodal, and single-temperature chains do not
cross between basins. Here the chain axis becomes a ladder: rung k samples
lp(psi) / T_k with T_0 = 1 < T_1 < ..., and adjacent rungs swap states with
the Metropolis rule

  P(swap i<->j) = min(1, exp((1/T_i - 1/T_j)(lp_j - lp_i)))

in a deterministic even-odd sweep, so hot chains ferry states across
barriers to the cold chain. R independent ladders (replicas) run side by
side; only the T = 1 rung's draws are posterior samples.

The JAX package vmaps its single-chain NUTS over rungs and replicas. Here
the R*K chains are one (C, dim) batch laid out replica-major (chain
c = r*K + k is rung k of replica r), and one PT transition is ONE call of
``nuts_transition_batched``: per-chain step sizes (C,), a per-chain
``DiagMetric`` or the per-rung ``RungDenseMetric``, and the tempered
value-and-grad (v * beta_c, g * beta_c), on one ``LockstepTree`` for the
whole run (on the card, one CUDA graph per doubling). The inverse
temperatures beta live in a device buffer that the tempered value-and-grad
reads; on the card that function is captured in CUDA graphs (its own and
the tree's), so a ladder update writes the buffer in place and the graphs
see it. Log-densities and gradients are un-tempered after the transition,
as in the JAX package.

Under a replica mesh (``make_replica_mesh``) each rank runs R/size whole
ladders, so swaps stay on the rank. Between sub-chunks the swap counters
are summed over the ranks and the pooled metric's window draws gathered,
so every rank adapts the same ladder and the same per-rung metric (rank
0's metric is broadcast); the ladder buffer that each rank's graph reads
is the rank's own, updated in place. A checkpoint holds every replica:
the ranks gather their ladders and rank 0 writes the file.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import MagiError, default_device, default_dtype
from ..parallel.chains import (
    GRAPH_WARMUP_CALLS,
    Counts,
    GraphedValueAndGrad,
    dense_metric_from_minv,
    pooled_dense_metric_from_samples,
    write_checkpoint,
)
from ..parallel.mesh import REPLICA_AXIS, Mesh, broadcast_tensors, gather_rows, local_draw
from . import checkpoint as ckpt_io
from .adapt import (
    DualAveragingState,
    WelfordState,
    build_window_schedule,
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update,
    welford_variance_regularized,
)
from .nuts import DenseMetric, DiagMetric, RungDenseMetric
from .nuts_batched import LockstepTree, nuts_transition_batched

logger = logging.getLogger(__name__)


def make_replica_mesh(n_devices=None, device=None) -> Mesh:
    """``Mesh.world`` along the replica axis (the JAX package's name)."""
    return Mesh.world(REPLICA_AXIS, n_devices, device)


def geometric_ladder(n_temps: int, t_max: float = 32.0) -> np.ndarray:
    """T_k = t_max^(k/(K-1)): [1, ..., t_max]."""
    if n_temps == 1:
        return np.ones(1)
    return t_max ** (np.arange(n_temps) / (n_temps - 1))


def auto_ladder(n_temps: int, dim: int) -> np.ndarray:
    """Dimension-aware geometric ladder, the warmup's starting point: swap
    acceptance between adjacent temperatures behaves like
    exp(-(dT/T)^2 dim / 2), so the spacing is 1 + sqrt(2/dim)."""
    spacing = 1.0 + np.sqrt(2.0 / max(dim, 1))
    return spacing ** np.arange(n_temps)


def adapt_ladder(
    inv_temps: np.ndarray,
    n_acc: np.ndarray,
    n_try: np.ndarray,
    min_tries: int = 10,
) -> np.ndarray:
    """Re-place the interior rungs so every adjacent pair carries an equal
    share of the communication barrier (Syed et al. 2021): the cumulative
    barrier is the trapezoid sum of the measured per-pair rejection rates,
    and new rungs sit (in log inverse temperature) at equal barrier
    levels. Endpoints stay fixed; pairs with fewer than ``min_tries``
    attempts leave the ladder unchanged."""
    k = len(inv_temps)
    if k < 3:
        return inv_temps
    tries = np.asarray(n_try, dtype=np.float64)[: k - 1]
    acc = np.asarray(n_acc, dtype=np.float64)[: k - 1]
    if np.any(tries < min_tries):
        return inv_temps
    r = np.clip(1.0 - acc / tries, 0.02, 0.98)
    lam = np.concatenate([[0.0], np.cumsum(r)])
    logb = np.log(np.asarray(inv_temps, dtype=np.float64))  # decreasing
    new_logb = np.interp(np.linspace(0.0, lam[-1], k), lam, logb)
    new_logb[0], new_logb[-1] = logb[0], logb[-1]
    return np.exp(new_logb)


class TemperedValueAndGrad:
    """(v * beta, g * beta) of ``vg`` with a per-chain inverse temperature
    ``beta`` (C,), read from the buffer at every call."""

    def __init__(self, vg: Callable, beta: torch.Tensor):
        self.vg, self.beta = vg, beta

    def __call__(self, q):
        v, g = self.vg(q)
        return v * self.beta, g * self.beta[:, None]


class PTCarry(NamedTuple):
    qs: torch.Tensor             # (C, dim), C = R*K replica-major
    lp: torch.Tensor             # (C,) untempered log-posterior
    grads: torch.Tensor          # (C, dim) untempered gradients
    da: DualAveragingState       # (C,)
    welford: WelfordState        # (C,) / (C, dim)
    inv_mass: torch.Tensor       # (C, dim)
    inv_temps: torch.Tensor      # (K,): the ladder adapts during warmup
    n_swap_accept: torch.Tensor  # (R, K) per-pair counts at the LEFT index
    n_swap_try: torch.Tensor     # (R, K)
    iteration: int               # host: the sweep parity


def swap_sweep(qs, lp, grads, diverging, inv_temps, u, iteration: int):
    """One deterministic even-odd swap sweep over every replica's ladder
    (the JAX package's tempering.py:176-203): pairs (k, k+1) with k of the
    iteration's parity; both members share the left member's uniform; the
    swap is accepted when log u < (beta_i - beta_j)(lp_j - lp_i) on the
    untempered lp; positions, gradients, lp and the divergence flags move
    together. ``qs``/``grads`` (R, K, dim), ``lp``/``diverging``/``u``
    (R, K), ``inv_temps`` (K,). Returns the swapped (qs, lp, grads,
    diverging) and the pair tries and accepts, counted at the left index."""
    k = inv_temps.shape[0]
    idx = torch.arange(k, device=lp.device)
    is_left = (idx % 2) == (iteration % 2)
    partner = torch.where(is_left, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner < k)
    partner = partner.clamp(0, k - 1)
    lp_partner = lp[:, partner]
    delta = (inv_temps - inv_temps[partner]) * (lp_partner - lp)
    u_pair = torch.where(is_left, u, u[:, partner])
    do_swap = valid & (torch.log(u_pair) < delta)
    sw = do_swap[..., None]
    return (
        torch.where(sw, qs[:, partner], qs),
        torch.where(do_swap, lp_partner, lp),
        torch.where(sw, grads[:, partner], grads),
        torch.where(do_swap, diverging[:, partner], diverging),
        (valid & is_left).expand_as(do_swap),
        do_swap & is_left,
    )


def _pt_step(vg_t, beta, carry: PTCarry, eps, metric, generator, max_depth: int, mesh=None,
             tree=None):
    """K tempered NUTS transitions of every replica (of this rank's block
    under a mesh) as one batched call on ``tree``, then one swap sweep.
    Returns (carry, stats of the rung-ordered transitions, swap-permuted
    divergence flags (R, K))."""
    c, dim = carry.qs.shape
    k = carry.inv_temps.shape[0]
    q, lp_t, g_t, stats = nuts_transition_batched(
        vg_t, carry.qs, carry.lp * beta, carry.grads * beta[:, None], eps, metric, generator,
        max_depth=max_depth, mesh=mesh, tree=tree,
    )
    u = local_draw(torch.rand, generator, (c // k, k), 0, mesh, q.dtype, q.device)
    qs, lp, grads, div, tried, accepted = swap_sweep(
        q.view(-1, k, dim), (lp_t / beta).view(-1, k), (g_t / beta[:, None]).view(-1, k, dim),
        stats.diverging.view(-1, k), carry.inv_temps, u, carry.iteration,
    )
    carry = carry._replace(
        qs=qs.reshape(c, dim), lp=lp.reshape(c), grads=grads.reshape(c, dim),
        n_swap_try=carry.n_swap_try + tried, n_swap_accept=carry.n_swap_accept + accepted,
        iteration=carry.iteration + 1,
    )
    return carry, stats, div


def pooled_rung_metrics(buf: np.ndarray, dbuf: np.ndarray, prev: RungDenseMetric,
                        dtype) -> RungDenseMetric:
    """Per-rung dense metrics pooled across replicas from a window's draws
    (the JAX package's tempering.py:454-497): ``buf`` (L, R, K, dim) and
    ``dbuf`` (L, R, K) divergence flags, host arrays. Divergent draws are
    left out; a rung whose window mostly diverged keeps its previous
    metric (its Cholesky factors re-derived from M^-1 in float64)."""
    k_temps, dim = buf.shape[2], buf.shape[3]
    prev_minv = prev.minv.cpu().numpy()
    device = prev.minv.device
    rungs = []
    for k in range(k_temps):
        d_k = dbuf[:, :, k]
        prev_k = DenseMetric(*dense_metric_from_minv(prev_minv[k], dtype, device))
        frac = float(d_k.mean()) if d_k.size else 0.0
        if frac > 0.5:
            logger.warning("PT pooled metric rung %d: %.0f%% of window draws diverged; "
                           "keeping previous metric.", k, 100.0 * frac)
            rungs.append(prev_k)
        else:
            flat = buf[:, :, k, :][~d_k].astype(np.float64)
            rungs.append(pooled_dense_metric_from_samples(flat, dim, dtype, prev_k))
    return RungDenseMetric(*(torch.stack(parts) for parts in zip(*rungs)))


def _tempered_vg(vg, beta, example):
    """The tempered value-and-grad, replayed from a CUDA graph on the card
    (beta is captured by address). Returns (vg_t, eager calls made)."""
    vg_t = TemperedValueAndGrad(vg, beta)
    if example.device.type == "cuda":
        return GraphedValueAndGrad(vg_t, example), GRAPH_WARMUP_CALLS
    return vg_t, 0


def _pt_sample(vg_t, beta, carry, eps, metric, generator, n_keep, max_depth, chunk_size,
               counts, progress, t0, checkpoint_path, drawn0=0, mesh=None, tree=None):
    """The sampling phase at frozen step sizes, metrics and ladder; a PT
    checkpoint after every chunk when ``checkpoint_path`` is set. Returns
    (carry, per-chunk host arrays: cold-rung draws (L, R, dim), cold lp
    (L, R), divergence, leapfrog counts, accept rates, depths (L, R, K),
    the last checkpoint or None)."""
    k = carry.inv_temps.shape[0]
    n_rep = carry.qs.shape[0] // k
    parts = {name: [] for name in ("samples", "lp", "diverging", "num_leapfrog", "accept_prob",
                                   "tree_depth")}
    pos, last = 0, None
    while pos < n_keep:
        length = min(chunk_size, n_keep - pos)
        cols = {name: [] for name in parts}
        for _ in range(length):
            carry, stats, div = _pt_step(vg_t, beta, carry, eps, metric, generator, max_depth,
                                         mesh, tree)
            counts.add(stats)
            cols["samples"].append(carry.qs.view(n_rep, k, -1)[:, 0])
            cols["lp"].append(carry.lp.view(n_rep, k)[:, 0])
            cols["diverging"].append(div)
            for name in ("num_leapfrog", "accept_prob", "tree_depth"):
                cols[name].append(getattr(stats, name).view(n_rep, k))
        for name, col in cols.items():
            parts[name].append(torch.stack(col).cpu().numpy())
        counts.host_syncs += 1
        pos += length
        if checkpoint_path:
            last = pt_checkpoint(carry, eps, generator, drawn0 + pos, metric, mesh)
            write_checkpoint(mesh, checkpoint_path, last, save_pt_checkpoint)
        if progress:
            logger.info("PT sampling %d/%d (%.1fs)", pos, n_keep, time.perf_counter() - t0)
    return carry, parts, last


def _pt_info(carry, temperatures, parts, eps, generator, counts, vg_evals,
             warmup_time, sampling_time, metric):
    """The JAX package's PT info (replica axis squeezed when R = 1), with
    the port's counts."""
    k = carry.inv_temps.shape[0]
    n_rep = carry.qs.shape[0] // k
    acc = carry.n_swap_accept.double().sum(0).cpu().numpy()[: k - 1]
    tries = carry.n_swap_try.double().sum(0).cpu().numpy()[: k - 1]
    dim = carry.qs.shape[1]
    cat = lambda name, shape: np.concatenate(parts[name]) if parts[name] else np.zeros(shape)
    out = {name: cat(name, (0, n_rep, k)) for name in ("diverging", "num_leapfrog",
                                                         "accept_prob", "tree_depth")}
    out["lp"] = cat("lp", (0, n_rep))
    samples = cat("samples", (0, n_rep, dim))
    if n_rep == 1:
        out = {name: a[:, 0] for name, a in out.items()}
    sq = lambda a: a[0] if n_rep == 1 else a
    info = dict(
        out,
        swap_acceptance=float(acc.sum()) / max(float(tries.sum()), 1.0),
        swap_acceptance_per_pair=acc / np.maximum(tries, 1.0),
        temperatures=temperatures,
        step_size=sq(eps.view(n_rep, k).cpu().numpy()),
        inv_mass=sq(carry.inv_mass.view(n_rep, k, dim).cpu().numpy()),
        final_psi=sq(carry.qs.view(n_rep, k, dim).cpu().numpy()),
        final_key=generator.get_state().numpy(),
        warmup_time_s=warmup_time,
        sampling_time_s=sampling_time,
        vg_evals=vg_evals,
        **counts.info(),
    )
    if isinstance(metric, RungDenseMetric):
        info["metric"] = "dense-pooled"
        info["inv_mass"] = metric.minv.cpu().numpy()  # (K, dim, dim)
    samples = samples[:, 0] if n_rep == 1 else samples.transpose(1, 0, 2)
    return samples, info


def run_parallel_tempering(
    vg: Callable,
    psi0: torch.Tensor,
    generator: torch.Generator,
    n_samples: int,
    n_adapts: int,
    temperatures=None,
    n_temps: int = 8,
    max_temp=None,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    max_depth: int = 10,
    chunk_size: int = 1000,
    progress: bool = False,
    ladder_adapt: bool = True,
    checkpoint_path=None,
    n_replicas: int = 1,
    mass_matrix: str = "diag",
    mesh: Mesh | None = None,
):
    """PT-NUTS. ``vg`` maps (C, dim) -> ((C,), (C, dim)); ``psi0`` (dim,)
    (every rung of every replica starts there) or (R, dim). Random numbers
    come from ``generator`` on psi0's device. Returns (cold-rung samples,
    info): (S, dim) when ``n_replicas == 1``, else (R, S, dim).

    Warmup adapts per-chain dual averaging and, under ``mass_matrix=
    "diag"``, per-chain Welford metrics; under ``"dense-pooled"`` one dense
    metric per rung, pooled across replicas at each window end. The ladder
    spacing adapts on the host between sub-chunks during the first 3/4 of
    warmup (swap counts pooled across replicas; ``ladder_adapt=False``
    keeps the start ladder, ``auto_ladder`` unless ``temperatures`` or
    ``max_temp`` say otherwise). ``checkpoint_path``: a PT checkpoint after
    every sampling chunk.

    ``mesh`` (``make_replica_mesh``): every rank calls with the same
    arguments and runs n_replicas/size ladders (n_replicas must be a
    multiple of the mesh size); each returns the results of all replicas,
    with the rank's own counts; rank 0 writes the checkpoints."""
    if mass_matrix not in ("diag", "dense-pooled"):
        raise ValueError(f"unknown mass_matrix '{mass_matrix}'")
    dtype, device = psi0.dtype, psi0.device
    dim = psi0.shape[-1]
    n_rep = int(n_replicas)
    n_keep = n_samples - n_adapts
    if temperatures is None:
        temperatures = (geometric_ladder(n_temps, max_temp) if max_temp is not None
                        else auto_ladder(n_temps, dim))
    temperatures = np.asarray(temperatures, dtype=np.float64)
    k_temps = len(temperatures)
    psi0s = psi0.expand(n_rep, dim) if psi0.ndim == 1 else psi0
    if mesh is not None:
        mesh.check_divides(n_rep, "n_replicas")
        n_rep //= mesh.size
        psi0s = psi0s[mesh.block(psi0s.shape[0])]
    n_chains = n_rep * k_temps
    qs0 = psi0s.repeat_interleave(k_temps, dim=0).contiguous()
    counts = Counts()
    t0 = time.perf_counter()

    inv_temps = torch.as_tensor(1.0 / temperatures, dtype=dtype, device=device)
    beta = inv_temps.repeat(n_rep)
    lp0, g0 = vg(qs0)
    vg_t, eager_calls = _tempered_vg(vg, beta, qs0)
    tree = LockstepTree(vg_t, generator, max_depth, mesh=mesh)
    zeros_rk = torch.zeros((n_rep, k_temps), dtype=torch.int32, device=device)
    carry = PTCarry(
        qs=qs0, lp=lp0, grads=g0,
        da=da_init(torch.full((n_chains,), float(initial_step_size), dtype=dtype, device=device)),
        welford=welford_init(dim, dtype, device, batch=(n_chains,)),
        inv_mass=torch.ones((n_chains, dim), dtype=dtype, device=device),
        inv_temps=inv_temps, n_swap_accept=zeros_rk, n_swap_try=zeros_rk, iteration=0,
    )
    pooled = mass_matrix == "dense-pooled"
    if pooled:
        eye = torch.eye(dim, dtype=dtype, device=device).repeat(k_temps, 1, 1)
        metric = RungDenseMetric(minv=eye, chol_minv=eye, p_chol=eye)

    # Sub-chunk schedule of the JAX package: ladder updates at sub-chunk
    # ends (>= ~8 per warmup, frozen for its last quarter), and under the
    # pooled metric chunks also end at every window end.
    in_window, window_end = build_window_schedule(n_adapts)
    ladder_freeze_at = int(0.75 * n_adapts)
    adapt_seg = max(50, n_adapts // 10) if ladder_adapt else n_adapts
    we_bounds = np.where(window_end)[0] + 1
    win_qs, win_mask, win_div = [], [], []
    pos = 0
    while pos < n_adapts:
        limit = ladder_freeze_at if pos < ladder_freeze_at else n_adapts
        length = min(chunk_size, adapt_seg, limit - pos)
        if pooled:
            nxt = we_bounds[we_bounds > pos]
            if nxt.size:
                length = min(length, int(nxt[0]) - pos)
        qs_all, divs = [], []
        for t in range(pos, pos + length):
            step_metric = metric if pooled else DiagMetric(carry.inv_mass)
            carry, stats, div = _pt_step(vg_t, beta, carry, torch.exp(carry.da.log_eps),
                                         step_metric, generator, max_depth, mesh, tree)
            counts.add(stats)
            da = da_update(carry.da, stats.accept_prob, target_accept)
            welford, inv_mass = carry.welford, carry.inv_mass
            if not pooled:
                if in_window[t]:
                    welford = welford_update(welford, carry.qs)
                if window_end[t]:
                    inv_mass = welford_variance_regularized(welford)
                    welford = welford_init(dim, dtype, device, batch=(n_chains,))
            if window_end[t]:
                da = da_restart(da)
            carry = carry._replace(da=da, welford=welford, inv_mass=inv_mass)
            if pooled:
                qs_all.append(carry.qs.view(n_rep, k_temps, dim))
                divs.append(div)
        if pooled:
            win_qs.append(torch.stack(qs_all).cpu().numpy())      # (L, R, K, dim)
            win_mask.append(in_window[pos : pos + length])
            win_div.append(torch.stack(divs).cpu().numpy())       # (L, R, K)
            counts.host_syncs += 1
        pos += length
        if pooled and window_end[pos - 1]:
            keep = np.concatenate(win_mask)
            # all replicas' window draws, on every rank
            buf = gather_rows(mesh, np.concatenate(win_qs)[keep], axis=1)
            dbuf = gather_rows(mesh, np.concatenate(win_div)[keep], axis=1)
            metric = broadcast_tensors(mesh, pooled_rung_metrics(buf, dbuf.astype(bool), metric,
                                                                 dtype))
            win_qs, win_mask, win_div = [], [], []
        if ladder_adapt and pos <= ladder_freeze_at:
            old = carry.inv_temps.cpu().numpy().astype(np.float64)
            swaps = torch.stack([carry.n_swap_accept.sum(0), carry.n_swap_try.sum(0)])
            if mesh is not None:
                swaps = mesh.psum(swaps)
            acc, tries = swaps.cpu().numpy()
            new = adapt_ladder(old, acc, tries)
            counts.host_syncs += 1
            if not np.allclose(new, old):
                inv_temps = torch.as_tensor(new, dtype=dtype, device=device)
                beta.copy_(inv_temps.repeat(n_rep))  # in place: the graph reads it
                carry = carry._replace(inv_temps=inv_temps, n_swap_accept=zeros_rk,
                                       n_swap_try=zeros_rk)
                if progress:
                    logger.info("PT ladder adapted: T = %s", np.round(1.0 / new, 3))
        if progress:
            logger.info("PT warmup %d/%d (%.1fs)", pos, n_adapts, time.perf_counter() - t0)

    # swap statistics of the sampling phase only
    carry = carry._replace(n_swap_accept=zeros_rk, n_swap_try=zeros_rk)
    temperatures = 1.0 / carry.inv_temps.cpu().numpy().astype(np.float64)
    eps = torch.exp(carry.da.log_eps_avg)
    if not pooled:
        metric = DiagMetric(carry.inv_mass)
    warmup_time = time.perf_counter() - t0
    t1 = time.perf_counter()
    carry, parts, _ = _pt_sample(vg_t, beta, carry, eps, metric, generator, n_keep, max_depth,
                                 chunk_size, counts, progress, t0, checkpoint_path, mesh=mesh,
                                 tree=tree)
    sampling_time = time.perf_counter() - t1
    counts.capture_s += tree.capture_seconds
    vg_evals = 1 + eager_calls + counts.lockstep_leaves
    if mesh is not None:  # every replica's state and draws, on every rank
        carry = carry._replace(**{name: mesh.all_gather(getattr(carry, name)) for name in
                                  ("qs", "inv_mass", "n_swap_accept", "n_swap_try")})
        eps = mesh.all_gather(eps)
        parts = {name: [gather_rows(mesh, p, axis=1) for p in chunks]
                 for name, chunks in parts.items()}
    return _pt_info(carry, temperatures, parts, eps, generator, counts, vg_evals,
                    warmup_time, sampling_time, metric)


# ---------------------------------------------------------------------------
# Checkpoint / resume (post-warmup)
# ---------------------------------------------------------------------------


def pt_checkpoint(carry: PTCarry, eps, generator, n_samples_drawn: int = 0, metric=None,
                  mesh: Mesh | None = None) -> dict:
    """Everything needed to continue PT sampling, in the JAX package's keys
    (ladder-shaped arrays when R = 1, a leading replica axis otherwise):
    positions and untempered lp of every rung, per-chain step sizes and
    diagonal metrics, the ladder, swap counters and sweep parity; and the
    port's: the untempered gradients, the generator state, and under the
    pooled metric the per-rung dense factors (``metric_minv`` etc.). Under
    a replica mesh every rank's ladders, gathered (every rank must call
    it)."""
    if mesh is not None:
        carry = carry._replace(**{name: mesh.all_gather(getattr(carry, name)) for name in
                                  ("qs", "lp", "grads", "inv_mass", "n_swap_accept",
                                   "n_swap_try")})
        eps = mesh.all_gather(eps)
    k = carry.inv_temps.shape[0]
    n_rep = carry.qs.shape[0] // k
    sq = lambda a: a[0] if n_rep == 1 else a
    host = lambda t, *shape: t.reshape(n_rep, *shape).cpu().numpy()
    rng_state, rng_device = ckpt_io.generator_state(generator)
    out = dict(
        qs=sq(host(carry.qs, k, -1)),
        lp=sq(host(carry.lp, k)),
        grads=sq(host(carry.grads, k, -1)),
        eps=sq(host(eps, k)),
        inv_mass=sq(host(carry.inv_mass, k, -1)),
        inv_temps=sq(np.tile(carry.inv_temps.cpu().numpy(), (n_rep, 1))),
        n_swap_accept=sq(carry.n_swap_accept.cpu().numpy()),
        n_swap_try=sq(carry.n_swap_try.cpu().numpy()),
        iteration=sq(np.full(n_rep, carry.iteration, dtype=np.int32)),
        rng_state=rng_state,
        rng_device=np.asarray(rng_device),
        n_samples_drawn=np.asarray(n_samples_drawn),
    )
    if isinstance(metric, RungDenseMetric):
        out.update(metric_minv=metric.minv.cpu().numpy(),
                   metric_chol=metric.chol_minv.cpu().numpy(),
                   metric_pchol=metric.p_chol.cpu().numpy())
    return out


def save_pt_checkpoint(path: str, ckpt: dict) -> None:
    ckpt_io.savez_atomic(path, ckpt)


def load_pt_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    if "rng_state" not in out:
        raise MagiError(f"{path}: {ckpt_io.JAX_REFUSAL}")
    return out


def run_parallel_tempering_resumed(
    vg: Callable,
    ckpt: dict,
    n_samples: int,
    max_depth: int = 10,
    chunk_size: int = 1000,
    dtype=None,
    device=None,
    checkpoint_path=None,
    progress: bool = False,
):
    """Continue PT sampling from a checkpoint: frozen ladder, step sizes
    and metrics, the saved generator state, swap counters and sweep
    parity. Returns (cold-rung samples (S, dim) or (R, S, dim), info,
    new_checkpoint)."""
    ckpt_io.check_port_checkpoint(ckpt)
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    qs_np = np.asarray(ckpt["qs"])
    n_rep = qs_np.shape[0] if qs_np.ndim == 3 else 1
    k_temps, dim = qs_np.shape[-2:]
    n_chains = n_rep * k_temps
    put = lambda a, *shape: torch.as_tensor(np.asarray(a).reshape(*shape), dtype=dtype,
                                            device=device)
    generator = ckpt_io.restore_generator(ckpt["rng_state"], str(ckpt["rng_device"]), device)
    counts = Counts()
    t0 = time.perf_counter()
    qs = put(qs_np, n_chains, dim)
    inv_temps = put(ckpt["inv_temps"], n_rep, k_temps)[0].contiguous()
    beta = inv_temps.repeat(n_rep)
    resumed_evals = 0
    if "grads" in ckpt:
        lp, grads = put(ckpt["lp"], n_chains), put(ckpt["grads"], n_chains, dim)
    else:  # a converted JAX checkpoint: evaluate at the saved positions
        lp, grads = vg(qs)
        resumed_evals = 1
    vg_t, eager_calls = _tempered_vg(vg, beta, qs)
    counters = lambda name: torch.as_tensor(
        np.asarray(ckpt[name]).reshape(n_rep, k_temps), dtype=torch.int32, device=device)
    eps = put(ckpt["eps"], n_chains)
    carry = PTCarry(
        qs=qs, lp=lp, grads=grads, da=da_init(eps),
        welford=welford_init(dim, dtype, device, batch=(n_chains,)),
        inv_mass=put(ckpt["inv_mass"], n_chains, dim), inv_temps=inv_temps,
        n_swap_accept=counters("n_swap_accept"), n_swap_try=counters("n_swap_try"),
        iteration=int(np.asarray(ckpt["iteration"]).reshape(n_rep)[0]),
    )
    if "metric_minv" in ckpt:
        metric = RungDenseMetric(*dense_metric_from_minv(
            ckpt["metric_minv"], dtype, device, ckpt.get("metric_chol"), ckpt.get("metric_pchol")))
    else:
        metric = DiagMetric(carry.inv_mass)
    temperatures = 1.0 / np.asarray(ckpt["inv_temps"], dtype=np.float64).reshape(n_rep, k_temps)[0]
    drawn0 = int(ckpt.get("n_samples_drawn", 0))
    tree = LockstepTree(vg_t, generator, max_depth)
    carry, parts, last = _pt_sample(vg_t, beta, carry, eps, metric, generator, n_samples,
                                    max_depth, chunk_size, counts, progress, t0, checkpoint_path,
                                    drawn0, tree=tree)
    counts.capture_s += tree.capture_seconds
    if last is None:
        last = pt_checkpoint(carry, eps, generator, drawn0 + n_samples, metric)
    vg_evals = resumed_evals + eager_calls + counts.lockstep_leaves
    samples, info = _pt_info(carry, temperatures, parts, eps, generator, counts, vg_evals,
                             0.0, time.perf_counter() - t0, metric)
    return samples, info, last
