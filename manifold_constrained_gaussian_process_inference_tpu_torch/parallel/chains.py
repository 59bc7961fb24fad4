"""Multi-chain NUTS driver (port of the JAX package's parallel/chains.py
``run_chains``, without its mesh, envelope, checkpoint and resume
branches), under a shared pooled dense metric or per-chain diagonal ones.

All C chains advance together through ``inference/nuts_batched.py`` on one
device. Under ``mass_matrix="dense-pooled"`` warmup runs in chunks aligned
to the adaptation-window boundaries; the in-window draws of all chains
accumulate device-side moments (divergence-masked count, sum and sum of
outer products, in float64), and at each boundary the host turns them into
a regularized dense metric. Under ``mass_matrix="diag"`` each chain keeps
its own Welford moments and inverse mass on the device (Stan parity), and
warmup runs in chunks of ``chunk_size``. Sampling runs in chunks of
``chunk_size`` iterations; each chunk's draws are copied to the host when
it ends.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..inference.adapt import build_window_schedule
from ..inference.nuts import (
    DenseMetric,
    DiagMetric,
    SampleCarry,
    init_warmup_carry,
    make_sample_step,
    make_warmup_step,
)
from ..inference.nuts_batched import (
    init_warmup_carry_batched,
    make_sample_step_batched,
    make_warmup_step_pooled_batched,
)
from ..ops import cuda_band

logger = logging.getLogger(__name__)


def _chunk_lengths(total: int, chunk: int):
    out = []
    done = 0
    while done < total:
        step = min(chunk, total - done)
        out.append(step)
        done += step
    return out


def _window_aligned_chunks(window_end: np.ndarray, chunk: int):
    """Warmup chunk lengths ending exactly at every adaptation-window
    boundary, further split by ``chunk`` within long windows."""
    bounds = sorted(set(np.where(window_end)[0] + 1) | {len(window_end)})
    out = []
    prev = 0
    for b in bounds:
        if b > prev:
            out.extend(_chunk_lengths(b - prev, chunk))
            prev = b
    return out


def pooled_dense_metric_from_moments(moments, dim: int, dtype, prev: DenseMetric) -> DenseMetric:
    """DenseMetric from window moments: ``moments`` is a list of per-chunk
    tuples (cnt, s1, s2, n_win, n_div) -- the divergence-masked count, sum
    and sum of outer products of all chains' in-window draws, and the
    counts of in-window and of divergent in-window draws. Divergent draws
    are left out; a window where most draws diverged keeps ``prev``. The
    metric lands on ``prev``'s device."""
    cnt = float(sum(float(m[0]) for m in moments))
    n_win = float(sum(float(m[3]) for m in moments))
    n_div = float(sum(float(m[4]) for m in moments))
    if n_win > 0 and n_div / n_win > 0.5:
        logger.warning(
            "pooled dense metric: %.0f%% of window draws diverged; "
            "keeping previous metric.", 100.0 * n_div / n_win,
        )
        return prev
    if n_div > 0:
        logger.info(
            "pooled dense metric: dropping %.1f%% divergent window draws "
            "from the estimate.", 100.0 * n_div / max(n_win, 1.0),
        )
    if cnt < 5:
        return prev
    s1 = np.sum([np.asarray(m[1], np.float64) for m in moments], axis=0)
    s2 = np.sum([np.asarray(m[2], np.float64) for m in moments], axis=0)
    mean = s1 / cnt
    cov = (s2 - cnt * np.outer(mean, mean)) / (cnt - 1.0)
    return _metric_from_cov(cov, cnt, dim, dtype, prev)


def _pooled_dense_metric(
    window_qs, in_win_mask, dim: int, dtype, prev: DenseMetric, window_div=None
) -> DenseMetric:
    """DenseMetric from a window's draws held on the host: ``window_qs`` a
    list of (C, L, dim) chunks, ``in_win_mask`` the matching (L,) masks and
    ``window_div`` optional (C, L) divergence flags, with the same policies
    as ``pooled_dense_metric_from_moments``."""
    qs = np.concatenate(window_qs, axis=1)[:, np.concatenate(in_win_mask), :]
    if window_div is not None:
        keep = np.concatenate(in_win_mask)
        div = np.concatenate(window_div, axis=1)[:, keep].astype(bool)
        frac = float(div.mean()) if div.size else 0.0
        if frac > 0.5:
            logger.warning(
                "pooled dense metric: %.0f%% of window draws diverged; "
                "keeping previous metric.", 100.0 * frac,
            )
            return prev
        flat = qs[~div].astype(np.float64)
    else:
        flat = qs.reshape(-1, dim).astype(np.float64)
    if flat.shape[0] < 5:
        return prev
    return _metric_from_cov(np.cov(flat, rowvar=False), flat.shape[0], dim, dtype, prev)


def _metric_from_cov(cov: np.ndarray, n_s: float, dim: int, dtype, prev: DenseMetric) -> DenseMetric:
    """Covariance -> regularized DenseMetric (host, float64): shrink toward
    the identity (the whitened unit scale) with weight n_s/(n_s+dim); keep
    ``prev`` when the window barely moved (median variance < 1e-2) or the
    estimate cannot be factored."""
    median_var = float(np.median(np.diag(cov)))
    if median_var < 1e-2:
        logger.warning(
            "pooled dense metric: window variance degenerate (median diag "
            "%.2e); keeping previous metric.", median_var,
        )
        return prev
    w = n_s / (n_s + dim)
    reg = w * cov + (1.0 - w) * np.eye(dim)
    try:
        chol = np.linalg.cholesky(reg)
    except np.linalg.LinAlgError:
        reg = reg + 1e-6 * np.trace(reg) / dim * np.eye(dim)
        try:
            chol = np.linalg.cholesky(reg)
        except np.linalg.LinAlgError:
            return prev
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=prev.minv.device)
    return DenseMetric(minv=put(reg), chol_minv=put(chol), p_chol=put(np.linalg.inv(chol).T))


def jitter_multipliers(rng: np.random.Generator, length: int, prob: float, low: float) -> np.ndarray:
    """Shared per-iteration step-size multipliers for ``step_jitter``: 1.0
    with probability 1-prob, else log-uniform in [low, 1]. Drawn from a host
    Generator before the iterations run, so the step size never depends on
    the chains' state."""
    m = np.ones(length, dtype=np.float64)
    if prob > 0.0:
        hit = rng.random(length) < prob
        m[hit] = np.exp(np.log(low) * rng.random(int(hit.sum())))
    return m


# Eager calls of the value-and-grad before its CUDA graph is captured.
GRAPH_WARMUP_CALLS = 3


class GraphedValueAndGrad:
    """``vg`` replayed from a CUDA graph captured at the chains' fixed
    (C, dim) input shape.

    In eager PyTorch one value-and-grad of the production target issues
    ~200 kernels whose launch costs milliseconds of host time, against
    ~0.4 ms of device time (PERF.md); a replay issues them as one graph.
    The warm-up calls (on a side stream) run ``vg`` eagerly and count
    their band-matvec launches; the capture records the kernels without
    running them, so its launches are read (``kernel_launches``) and taken
    back out of ``cuda_band``'s counts; each replay adds them again.
    Outputs are cloned out of the graph's static buffers."""

    def __init__(self, vg, example: torch.Tensor, n_warmup: int = GRAPH_WARMUP_CALLS):
        self.static_in = example.detach().clone()
        side = torch.cuda.Stream(device=example.device)
        side.wait_stream(torch.cuda.current_stream(example.device))
        with torch.cuda.stream(side):
            for _ in range(n_warmup):
                vg(self.static_in)
        torch.cuda.current_stream(example.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = dict(cuda_band.KERNEL_LAUNCHES)
        with torch.cuda.graph(self.graph):
            self.static_lp, self.static_grad = vg(self.static_in)
        self.kernel_launches = {
            name: k - before[name] for name, k in cuda_band.KERNEL_LAUNCHES.items()
        }
        cuda_band.KERNEL_LAUNCHES.update(before)

    def __call__(self, zeta: torch.Tensor):
        self.static_in.copy_(zeta)
        self.graph.replay()
        cuda_band.add_launches(self.kernel_launches)
        return self.static_lp.clone(), self.static_grad.clone()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Counts:
    """Host counts of one run: transitions, device-to-host reads and
    batched leapfrog steps."""

    def __init__(self):
        self.transitions = self.host_syncs = self.lockstep_leaves = 0

    def add(self, stats) -> None:
        self.transitions += 1
        self.host_syncs += stats.host_syncs
        self.lockstep_leaves += stats.lockstep_leaves


def _warmup_pooled(vg, psi0, generator, n_adapts, chunk_size, initial_step_size,
                   target_accept, max_depth, progress, counts, t0):
    """Warmup under the pooled dense metric: chunks aligned to the window
    ends, in-window moments accumulated on the device, the metric
    re-estimated on the host at each window end. Returns (carry, metric,
    per-chunk (C, L) divergence flags)."""
    n_chains, dim = psi0.shape
    dtype, device = psi0.dtype, psi0.device
    f64 = dict(dtype=torch.float64, device=device)
    eye = torch.eye(dim, dtype=dtype, device=device)
    metric = DenseMetric(minv=eye, chol_minv=eye, p_chol=eye)
    carry = init_warmup_carry_batched(vg, psi0, initial_step_size)
    warmup_step = make_warmup_step_pooled_batched(vg, target_accept, max_depth, generator)
    in_window, window_end = build_window_schedule(n_adapts)
    div_chunks, window_moments = [], []
    pos = 0
    for length in _window_aligned_chunks(window_end, chunk_size):
        div = torch.zeros((n_chains, length), dtype=torch.bool, device=device)
        cnt, n_win, n_div = (torch.zeros((), **f64) for _ in range(3))
        s1 = torch.zeros(dim, **f64)
        s2 = torch.zeros((dim, dim), **f64)
        for t in range(length):
            carry, stats = warmup_step(carry, bool(window_end[pos + t]), metric)
            counts.add(stats)
            div[:, t] = stats.diverging
            if in_window[pos + t]:
                keep = (~stats.diverging).to(torch.float64)
                q64 = carry.chain.q.to(torch.float64)
                qm = q64 * keep[:, None]
                cnt += keep.sum()
                s1 += qm.sum(dim=0)
                s2 += qm.T @ q64
                n_win += n_chains
                n_div += stats.diverging.sum()
        div_chunks.append(div.cpu().numpy())
        window_moments.append(tuple(m.cpu().numpy() for m in (cnt, s1, s2, n_win, n_div)))
        counts.host_syncs += 1
        pos += length
        if window_end[pos - 1]:
            metric = pooled_dense_metric_from_moments(window_moments, dim, dtype, metric)
            window_moments = []
        if progress:
            logger.info("warmup %d/%d (%.1fs, pooled dense metric)",
                        pos, n_adapts, time.perf_counter() - t0)
    return carry, metric, div_chunks


def _warmup_diag(vg, psi0, generator, n_adapts, chunk_size, initial_step_size,
                 target_accept, max_depth, progress, counts, t0):
    """Warmup under per-chain diagonal metrics (Stan's windowed Welford
    adaptation, ``inference/nuts.make_warmup_step``), in chunks of
    ``chunk_size``. Returns (carry, per-chunk (C, L) divergence flags)."""
    carry = init_warmup_carry(vg, psi0, initial_step_size)
    warmup_step = make_warmup_step(vg, target_accept, max_depth, generator)
    in_window, window_end = build_window_schedule(n_adapts)
    div_chunks = []
    pos = 0
    for length in _chunk_lengths(n_adapts, chunk_size):
        div = torch.zeros((psi0.shape[0], length), dtype=torch.bool, device=psi0.device)
        for t in range(length):
            carry, stats = warmup_step(carry, bool(in_window[pos + t]), bool(window_end[pos + t]))
            counts.add(stats)
            div[:, t] = stats.diverging
        div_chunks.append(div.cpu().numpy())
        counts.host_syncs += 1
        pos += length
        if progress:
            logger.info("warmup %d/%d (%.1fs, diag metric)", pos, n_adapts,
                        time.perf_counter() - t0)
    return carry, div_chunks


def run_chains(
    vg,
    psi0: torch.Tensor,
    generator: torch.Generator,
    n_samples: int,
    n_adapts: int,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    max_depth: int = 10,
    chunk_size: int = 1000,
    progress: bool = False,
    mass_matrix: str = "dense-pooled",
    step_jitter: float = 0.0,
    step_jitter_low: float = 0.4,
    jitter_rng: np.random.Generator | None = None,
    resume_ckpt=None,
    envelope=None,
):
    """Run C NUTS chains from psi0 (C, dim) with Stan warmup. ``vg`` maps
    (C, dim) -> ((C,), (C, dim)). Random numbers come from ``generator``
    (on psi0's device) and the step-jitter multipliers from the host
    ``jitter_rng``. On a CUDA device ``vg`` is replayed from a CUDA graph
    (GraphedValueAndGrad), C = 1 included. Returns (samples (C, S, dim)
    numpy, info dict of numpy arrays with a leading chain axis).

    ``mass_matrix``: "dense-pooled", one dense metric shared by all chains
    and estimated from their pooled in-window draws (``step_jitter``
    applies here only); or "diag", per-chain diagonal Welford adaptation
    (Stan parity), where ``info["inv_mass"]`` is (C, dim). ``resume_ckpt`` and ``envelope`` are
    not ported (ROADMAP M13, M18)."""
    if mass_matrix not in ("dense-pooled", "diag"):
        raise ValueError(f"unknown mass_matrix '{mass_matrix}'")
    if mass_matrix == "diag":
        if envelope is not None:
            raise ValueError(
                "the curvature envelope folds into the dense-pooled metric; "
                "mass_matrix='diag' (Stan parity) does not support it."
            )
        if resume_ckpt is not None:
            raise ValueError(
                "warmup resume is implemented for mass_matrix='dense-pooled' "
                "(the production path); the diag path restarts warmup."
            )
        if step_jitter:
            raise ValueError(
                "step_jitter is implemented for mass_matrix='dense-pooled' "
                "(the production path); the diag path keeps Stan parity."
            )
    for given, what, item in ((resume_ckpt, "resume_ckpt", "M13"), (envelope, "envelope", "M18")):
        if given is not None:
            raise NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP {item}).")
    if jitter_rng is None:
        jitter_rng = np.random.default_rng(0)
    n_chains, dim = psi0.shape
    n_keep = n_samples - n_adapts
    dtype, device = psi0.dtype, psi0.device
    counts = _Counts()

    t0 = time.perf_counter()
    if device.type == "cuda":
        vg = GraphedValueAndGrad(vg, psi0)
    warm_args = (vg, psi0, generator, n_adapts, chunk_size, initial_step_size, target_accept,
                 max_depth)
    if mass_matrix == "diag":
        carry, warmup_div_chunks = _warmup_diag(*warm_args, progress, counts, t0)
        metric = DiagMetric(carry.inv_mass)
        diag_step = make_sample_step(vg, max_depth, generator)
        sample_step = lambda c, mult: diag_step(c)  # noqa: E731
    else:
        carry, metric, warmup_div_chunks = _warmup_pooled(*warm_args, progress, counts, t0)
        pooled_step = make_sample_step_batched(vg, max_depth, generator)
        sample_step = lambda c, mult: pooled_step(c, mult, metric)  # noqa: E731
    eps_final = torch.exp(carry.da.log_eps_avg)
    _sync(device)
    warmup_time = time.perf_counter() - t0

    t1 = time.perf_counter()
    scarry = SampleCarry(chain=carry.chain, eps=eps_final, inv_mass=carry.inv_mass)
    names = ("lp", "accept_prob", "num_leapfrog", "tree_depth", "diverging", "energy")
    out = {name: [] for name in ("samples",) + names}
    pos = 0
    for length in _chunk_lengths(n_keep, chunk_size):
        mults = jitter_multipliers(jitter_rng, length, step_jitter, step_jitter_low)
        qs = torch.empty((n_chains, length, dim), dtype=dtype, device=device)
        cols = {name: [] for name in names}
        for t in range(length):
            scarry, (q, logp, stats) = sample_step(scarry, float(mults[t]))
            counts.add(stats)
            qs[:, t] = q
            for name, value in zip(names, (logp, stats.accept_prob, stats.num_leapfrog,
                                           stats.tree_depth, stats.diverging, stats.energy)):
                cols[name].append(value)
        out["samples"].append(qs.cpu().numpy())
        for name in names:
            out[name].append(torch.stack(cols[name], dim=1).cpu().numpy())
        counts.host_syncs += 1
        pos += length
        if progress:
            logger.info("sampling %d/%d (%.1fs)", pos, n_keep, time.perf_counter() - t0)
    _sync(device)
    sampling_time = time.perf_counter() - t1

    cat = lambda parts: (
        np.concatenate(parts, axis=1) if parts else np.zeros((n_chains, 0))
    )
    info = {name: cat(out[name]) for name in names}
    info.update(
        step_size=eps_final.cpu().numpy(),
        inv_mass=(metric.minv if mass_matrix == "dense-pooled" else metric.inv_mass).cpu().numpy(),
        metric=mass_matrix,
        step_jitter=(float(step_jitter), float(step_jitter_low)),
        warmup_diverging=cat(warmup_div_chunks),
        final_psi=scarry.chain.q.cpu().numpy(),
        # the state of the one generator all chains draw from (the JAX
        # package returns each chain's PRNG key)
        final_key=generator.get_state().numpy(),
        warmup_time_s=warmup_time,
        sampling_time_s=sampling_time,
        transitions=counts.transitions,
        host_syncs=counts.host_syncs,
        lockstep_leaves=counts.lockstep_leaves,
    )
    return cat(out["samples"]), info
