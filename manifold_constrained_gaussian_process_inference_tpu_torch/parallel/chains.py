"""Multi-chain NUTS driver (port of the JAX package's parallel/chains.py
``run_chains``), under a shared pooled dense metric or per-chain diagonal
ones, and the divergence-informed curvature envelope of the pooled metric
(``CurvatureEnvelope``).

All C chains advance together through ``inference/nuts_batched.py`` on one
device, or, under a chain mesh (``make_chain_mesh``, ``parallel/mesh.py``),
each rank advances its block of C/size chains in its own lockstep: the
pooled window moments are summed over the ranks before the metric is
estimated (and rank 0's metric is broadcast), so every rank samples under
the same metric, and each rank returns the draws and statistics of all C
chains in chain order. Under ``mass_matrix="dense-pooled"`` warmup runs in
chunks aligned to the adaptation-window boundaries; the in-window draws of
all chains
accumulate device-side moments (divergence-masked count, sum and sum of
outer products, in float64), and at each boundary the host turns them into
a regularized dense metric. Under ``mass_matrix="diag"`` each chain keeps
its own Welford moments and inverse mass on the device (Stan parity), and
warmup runs in chunks of ``chunk_size``. Sampling runs in chunks of
``chunk_size`` iterations; each chunk's draws are copied to the host when
it ends.

With ``checkpoint_path`` a checkpoint (inference/checkpoint.py) is written
after every sampling chunk, and on the pooled dense path after every warmup
chunk too; ``resume_ckpt`` continues a pooled warmup from such a
checkpoint, bit for bit, and ``sample_from_checkpoint`` continues sampling.
Under a mesh the ranks gather the carry and rank 0 alone writes the file
(atomically); a barrier after each write keeps every rank behind a
complete file. The generators need no gathering: every rank draws every
random number of all chains (``mesh.local_draw``), so rank 0's generator
state is the run's.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import MagiError
from ..inference import checkpoint as ckpt_io
from ..inference.adapt import DualAveragingState, build_window_schedule
from ..inference.nuts import (
    ChainState,
    DenseMetric,
    DiagMetric,
    SampleCarry,
    WarmupCarry,
    init_warmup_carry,
    make_warmup_step,
)
from ..inference.nuts_batched import (
    LockstepTree,
    add_kernel_launches,
    init_warmup_carry_batched,
    kernel_launch_counts,
    make_sample_step_batched,
    make_warmup_step_pooled_batched,
)
from ..ops import cuda_band
from ..utils import trace
from .mesh import CHAIN_AXIS, Mesh, broadcast_tensors, gather_rows

logger = logging.getLogger(__name__)

def make_chain_mesh(n_devices=None, device=None) -> Mesh:
    """``Mesh.world`` along the chain axis (the JAX package's name)."""
    return Mesh.world(CHAIN_AXIS, n_devices, device)


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


def pooled_dense_metric_from_moments(moments, dim: int, dtype, prev: DenseMetric,
                                     envelope=None) -> DenseMetric:
    """DenseMetric from window moments: ``moments`` is a list of per-chunk
    tuples (cnt, s1, s2, n_win, n_div) -- the divergence-masked count, sum
    and sum of outer products of all chains' in-window draws, and the
    counts of in-window and of divergent in-window draws. Divergent draws
    are left out; a window where most draws diverged keeps ``prev``. The
    metric lands on ``prev``'s device. ``envelope`` (a CurvatureEnvelope)
    folds its probes into the shrunk covariance."""
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
    return _metric_from_cov(cov, cnt, dim, dtype, prev, envelope)


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
    return pooled_dense_metric_from_samples(flat, dim, dtype, prev)


def pooled_dense_metric_from_samples(flat: np.ndarray, dim: int, dtype,
                                     prev: DenseMetric) -> DenseMetric:
    """DenseMetric from pooled draws (n, dim) on the host, float64; fewer
    than 5 draws keep ``prev``."""
    if flat.shape[0] < 5:
        return prev
    return _metric_from_cov(np.cov(flat, rowvar=False), flat.shape[0], dim, dtype, prev)


def _metric_from_cov(cov: np.ndarray, n_s: float, dim: int, dtype, prev: DenseMetric,
                     envelope=None) -> DenseMetric:
    """Covariance -> regularized DenseMetric (host, float64): shrink toward
    the identity (the whitened unit scale) with weight n_s/(n_s+dim), then
    fold ``envelope``'s probes in; keep ``prev`` when the window barely
    moved (median variance < 1e-2) or the estimate cannot be factored."""
    median_var = float(np.median(np.diag(cov)))
    if median_var < 1e-2:
        logger.warning(
            "pooled dense metric: window variance degenerate (median diag "
            "%.2e); keeping previous metric.", median_var,
        )
        return prev
    w = n_s / (n_s + dim)
    reg = w * cov + (1.0 - w) * np.eye(dim)
    if envelope is not None:
        reg = envelope.fold(reg)
    try:
        chol = np.linalg.cholesky(reg)
    except np.linalg.LinAlgError:
        reg = reg + 1e-6 * np.trace(reg) / dim * np.eye(dim)
        try:
            chol = np.linalg.cholesky(reg)
        except np.linalg.LinAlgError:
            return prev
    # row-major factors, as every metric of a run (a product's rounding on
    # the card follows its operands' layout)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,  # noqa: E731
                                    device=prev.minv.device)
    return DenseMetric(minv=put(reg), chol_minv=put(chol), p_chol=put(np.linalg.inv(chol).T))


def _last_div_position(qs: torch.Tensor, div: torch.Tensor):
    """Each chain's row of ``qs`` (C, L, dim) at its last divergent step of
    a chunk (``div`` (C, L)): ((C, dim), (C,) has a divergence). A chain
    without one gets row 0, which ``has_div`` marks as unused. One masked
    argmax and a gather on the device; (C, dim) leaves it, not the chunk."""
    order = torch.arange(1, qs.shape[1] + 1, dtype=qs.dtype, device=qs.device)
    idx = torch.argmax(div.to(qs.dtype) * order, dim=1)
    q_ld = torch.take_along_dim(qs, idx[:, None, None], dim=1)[:, 0, :]
    return q_ld, div.any(dim=1)


class CurvatureEnvelope:
    """Divergence-informed curvature envelope of the pooled dense metric
    (the JAX package's parallel/chains.py CurvatureEnvelope; host numpy,
    float64).

    The pooled covariance measures the posterior's bulk; a localized pocket
    whose curvature exceeds the pooled precision in some direction makes
    the leapfrog unstable there at the step size adapted for the bulk.
    The envelope probes the local precision at positions where warmup
    chains diverged and takes the PSD-max of the pooled precision with each
    probe, P_env = max_PSD(P_pool, P_1, ...), so only the directions the
    pocket needs get more mass. The metric stays fixed after warmup, so
    sampling is a valid NUTS chain.

    ``hess_fn(z)`` returns the NEGATIVE Hessian of the log-density in the
    sampler's coordinates (solve_magi conjugates the exact float64 Hessian
    through the whitener); ``logp_fn(z)``, when given, places the probe by
    bisection between the divergent step's endpoints (``_probe_point``).
    After each warmup chunk the chain with the most divergences donates
    its last divergent step: at most one probe per chunk and
    ``max_points`` per run, only from chunks whose divergent share is in
    (0, ``max_div_frac``] (mass divergence means a wrong step size, not a
    pocket) and once one adaptation window has ended. ``lam_cap`` bounds a
    direction's boost, ``boost_margin`` gives boosted directions headroom
    and ``max_boost_dims`` keeps a probe's strongest directions only."""

    def __init__(self, hess_fn, logp_fn=None, max_points: int = 4, lam_cap: float = 1e4,
                 max_div_frac: float = 0.05, max_boost_dims: int = 16,
                 support_drop: float = 50.0, boost_margin: float = 16.0):
        self.hess_fn = hess_fn
        self.logp_fn = logp_fn
        self.max_points = int(max_points)
        self.lam_cap = float(lam_cap)
        self.max_div_frac = float(max_div_frac)
        self.max_boost_dims = int(max_boost_dims)
        self.support_drop = float(support_drop)
        self.boost_margin = float(boost_margin)
        self.points: list = []   # probed positions z, (dim,) float64
        self.precs: list = []    # their local precisions, (dim, dim) float64
        self.probe_seconds: list = []  # host seconds of each probe
        self.boost_dirs = 0      # diagnostics of the last fold
        self.boost_max = 1.0

    def _probe_point(self, edge: np.ndarray, leaf: np.ndarray) -> np.ndarray:
        """The farthest point from ``edge`` toward ``leaf`` whose
        log-density is within ``support_drop`` of the edge's, by halving
        (the edge alone underestimates the pocket; the exploded leaf sits
        where the curvature is huge in every direction). Without a
        ``logp_fn`` the edge itself."""
        if self.logp_fn is None:
            return edge
        d = leaf - edge
        d = np.where(np.isfinite(d), d, 0.0)
        # an exploded leaf can be far off: bound the segment to a multiple
        # of the whitened unit scale
        norm = float(np.linalg.norm(d))
        max_norm = 16.0 * np.sqrt(d.shape[0])
        if norm > max_norm:
            d *= max_norm / norm
        lp_edge = float(self.logp_fn(edge))
        t = 1.0
        for _ in range(10):
            zt = edge + t * d
            lp = float(self.logp_fn(zt))
            if np.isfinite(lp) and lp > lp_edge - self.support_drop:
                return zt
            t *= 0.5
        return edge

    def collect(self, q_lastdiv, has_div, div, past_first_window: bool) -> None:
        """Maybe probe one divergent step of a finished warmup chunk:
        ``q_lastdiv`` (C, 2, dim) each chain's last divergent step's (edge,
        leaf) (unused where ``has_div`` (C,) is False), ``div`` (C, L) the
        chunk's divergence flags."""
        if not past_first_window or len(self.points) >= self.max_points:
            return
        div = np.asarray(div, dtype=bool)
        if div.size == 0:
            return
        frac = float(div.mean())
        if frac <= 0.0 or frac > self.max_div_frac:
            return
        counts = div.sum(axis=1)
        i = int(np.argmax(counts))
        if not bool(np.asarray(has_div)[i]):
            return
        pair = np.asarray(q_lastdiv[i], dtype=np.float64)
        t0 = time.perf_counter()
        try:
            z = self._probe_point(pair[0], pair[1])
            prec = np.asarray(self.hess_fn(z), dtype=np.float64)
        except Exception:  # the JAX package's behaviour: a failed probe is skipped
            logger.warning("curvature envelope: Hessian probe failed; skipping point.")
            return
        self.probe_seconds.append(time.perf_counter() - t0)
        self.points.append(z)
        self.precs.append(0.5 * (prec + prec.T))
        logger.info("curvature envelope: probe %d at a divergent position (chain %d, %d "
                    "divergence(s) in chunk, |z| = %.1f, %.2f s).", len(self.points), i,
                    int(counts[i]), float(np.linalg.norm(z)), self.probe_seconds[-1])

    def fold(self, cov: np.ndarray) -> np.ndarray:
        """The covariance whose precision is the PSD-max of ``cov``'s and
        every probe's, by sequential congruence folds: with P = F F', probe
        P_i whitens to S_i = F^-1 P_i F^-T, its eigenvalues above 1 are
        boosted by ``boost_margin`` and capped at ``lam_cap`` (the rest
        become 1: directions the pooled metric dominates, and negative
        curvature, stay), the ``max_boost_dims`` largest kept, and F <- F Q
        sqrt(lam). ``cov`` itself when nothing is boosted.

        The kept directions are the top ``max_boost_dims`` by a stable sort,
        so ties at the cap cannot keep more (the JAX package's ``>=`` on the
        k-th value keeps every tie)."""
        if not self.precs:
            return cov
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            logger.warning("curvature envelope: pooled covariance not SPD; skipping fold.")
            return cov
        # P_pool = L^-T L^-1 = F F' with F = L^-T, F^-1 = L'
        f_inv = chol.T
        boost_dirs, boost_max = 0, 1.0
        for prec in self.precs:
            s = f_inv @ prec @ f_inv.T
            lam, q = np.linalg.eigh(0.5 * (s + s.T))
            lam_c = np.where(lam > 1.0, np.minimum(lam * self.boost_margin, self.lam_cap), 1.0)
            # a pocket is low-dimensional: a probe that boosts half the
            # space measured a pathological point
            if int(np.sum(lam_c > 1.0 + 1e-9)) > self.max_boost_dims:
                kept = np.zeros(lam_c.shape, dtype=bool)
                kept[np.argsort(lam_c, kind="stable")[-self.max_boost_dims:]] = True
                lam_c = np.where(kept, lam_c, 1.0)
            nb = int(np.sum(lam_c > 1.0 + 1e-9))
            if nb == 0:
                continue
            boost_dirs += nb
            boost_max = max(boost_max, float(lam_c.max()))
            f_inv = (q / np.sqrt(lam_c)).T @ f_inv
        self.boost_dirs, self.boost_max = boost_dirs, boost_max
        if boost_dirs == 0:
            return cov
        cov_env = f_inv.T @ f_inv
        logger.info("curvature envelope: boosted %d direction(s), max precision ratio %.1f.",
                    boost_dirs, boost_max)
        return 0.5 * (cov_env + cov_env.T)

    def state(self) -> dict:
        """The probes, for a warmup-phase checkpoint."""
        return {"points": [np.asarray(p) for p in self.points],
                "precs": [np.asarray(p) for p in self.precs]}

    def restore(self, st: dict) -> None:
        self.points = [np.asarray(p, dtype=np.float64) for p in st.get("points", [])]
        self.precs = [np.asarray(p, dtype=np.float64) for p in st.get("precs", [])]

    def info(self) -> dict:
        """The run info's envelope keys: the JAX package's three, and the
        host seconds of each probe this run made."""
        return {"envelope_points": len(self.points),
                "envelope_boost_dirs": int(self.boost_dirs),
                "envelope_boost_max": float(self.boost_max),
                "envelope_probe_seconds": list(self.probe_seconds)}


def dense_metric_from_minv(minv, dtype, device, chol=None, p_chol=None):
    """A DenseMetric (or, for a (K, dim, dim) stack, the factors of one
    per rung) from M^-1, row-major; the Cholesky factors are computed in
    float64 on the host unless given."""
    minv64 = np.asarray(minv, dtype=np.float64)
    if chol is None:
        chol = np.linalg.cholesky(minv64)
        p_chol = np.swapaxes(np.linalg.inv(chol), -1, -2)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return put(minv), put(chol), put(p_chol)


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
    their kernel launches; the capture records the kernels without
    running them, so its launches are read (``launches``: the band
    kernels' by entry point, ``kernel_launches``, and by tile,
    ``tile_launches``, and the whitening GEMMs' product kernel's,
    ``ops/minv_mv``) and taken back out of the counts; each replay adds
    them again.
    Outputs are cloned out of the graph's static buffers. Tensors that
    ``vg`` reads besides its input (parallel tempering's inverse
    temperatures) are captured by address: update them in place.

    A value-and-grad that ends in a collective (``parallel/grid.py``) has a
    ``local`` part and a ``reduce``: only the local part is captured (a
    collective cannot be), and ``reduce`` runs after each replay.

    ``eager`` is the captured function itself, which the NUTS tree's own
    graphs capture (``inference/nuts_batched.LockstepTree``): a replay
    cannot be captured inside another graph."""

    def __init__(self, vg, example: torch.Tensor, n_warmup: int = GRAPH_WARMUP_CALLS):
        self.static_in = example.detach().clone()
        local = getattr(vg, "local", vg)
        self.eager = local
        self.reduce = getattr(vg, "reduce", None)
        self.graph, self.launches, out = capture_graph(
            lambda: local(self.static_in), example.device, n_warmup)
        self.static_lp, self.static_grad = out

    @property
    def kernel_launches(self) -> dict:
        """Band-matvec launches per replay, by entry point."""
        return {name: self.launches[name] for name in cuda_band.KERNEL_LAUNCHES}

    @property
    def tile_launches(self) -> dict:
        """Band-matvec launches per replay, by tile."""
        return {name: self.launches[name] for name in cuda_band.TILE_LAUNCHES}

    def __call__(self, zeta: torch.Tensor):
        self.static_in.copy_(zeta)
        self.graph.replay()
        add_kernel_launches(self.launches)
        if self.reduce is not None:
            return self.reduce(self.static_lp, self.static_grad)
        return self.static_lp.clone(), self.static_grad.clone()


def capture_graph(fn, device, n_warmup: int = GRAPH_WARMUP_CALLS):
    """Run ``fn`` ``n_warmup`` times eagerly on a side stream, then capture
    one call in a CUDA graph. Returns (graph, kernel launches per replay
    as ``kernel_launch_counts`` gives them, the captured call's outputs);
    the capture's launches are taken back out of the counts."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(n_warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kernel_launch_counts()
    with torch.cuda.graph(graph):
        out = fn()
    launches = {name: k - before[name] for name, k in kernel_launch_counts().items()}
    add_kernel_launches({name: -k for name, k in launches.items()})
    return graph, launches, out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Counts:
    """Host counts of one run: transitions, device-to-host reads (all of
    them, ``host_syncs``, and the NUTS trees' own, ``tree_reads``), batched
    leapfrog steps (paid by every chain in lockstep) and, on the device, the
    leapfrog steps the chains' own trees needed (``chain_leaves``, summed
    over chains) and the doublings the trees ran (``doublings``: each
    transition's deepest chain); the host seconds spent capturing the NUTS
    trees' CUDA graphs (``capture_s``, inside the warmup and sampling
    times)."""

    def __init__(self):
        self.transitions = self.host_syncs = self.tree_reads = self.lockstep_leaves = 0
        self.chain_leaves = self.doublings = 0.0
        self.capture_s = 0.0

    def add(self, stats) -> None:
        self.transitions += 1
        self.host_syncs += stats.host_syncs
        self.lockstep_leaves += stats.lockstep_leaves
        self.chain_leaves = self.chain_leaves + stats.num_leapfrog.sum()
        if stats.tree_depth is not None:  # a NUTS tree
            self.tree_reads += stats.host_syncs
            self.doublings = self.doublings + stats.tree_depth.max()

    def info(self) -> dict:
        return dict(transitions=self.transitions, host_syncs=self.host_syncs,
                    tree_reads=self.tree_reads, lockstep_leaves=self.lockstep_leaves,
                    chain_leaves=float(self.chain_leaves), doublings=int(self.doublings),
                    graph_capture_s=self.capture_s)


def write_checkpoint(mesh: Mesh | None, path: str, ckpt, save=None) -> None:
    """Write a checkpoint that every rank has gathered: rank 0 alone writes
    it (atomically, ``inference/checkpoint.py``), and under a mesh every
    rank waits at a barrier until the file is complete."""
    if mesh is None or mesh.rank == 0:
        (save or ckpt_io.save_checkpoint)(path, ckpt)
    if mesh is not None:
        mesh.barrier()


def _restore_warmup(ckpt, n_adapts, chunk_size, chunks, generator, dtype, device, mesh=None,
                    envelope=None):
    """The pooled warmup's state from a warmup-phase checkpoint, after
    checking that it was written under this schedule; under a mesh the
    rank's block of the chains."""
    if getattr(ckpt, "phase", "sampling") != "warmup":
        raise ValueError(
            "resume_ckpt must be a warmup-phase checkpoint; "
            "post-warmup checkpoints resume via run_chains_resumed."
        )
    ckpt_io.check_port_checkpoint(ckpt)
    ckpt_io.check_warmup_schedule(ckpt, n_adapts, chunk_size)
    w = ckpt.warmup
    pos = int(w["pos"])
    if pos not in np.cumsum(chunks):
        raise MagiError(
            f"warmup checkpoint position {pos} does not align with the chunk schedule "
            f"for n_adapts={n_adapts}, chunk_size={chunk_size}."
        )
    ckpt_io.set_generator_state(generator, ckpt.rng_state, ckpt.rng_device)
    n_all = np.asarray(w["carry"]["q"]).shape[0]
    block = slice(None) if mesh is None else mesh.block(n_all)
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    c = {name: put(np.asarray(v)[block]) for name, v in w["carry"].items()}
    carry = WarmupCarry(
        chain=ChainState(q=c["q"], logp=c["logp"], grad=c["grad"]),
        da=DualAveragingState(c["log_eps"], c["log_eps_avg"], c["h_bar"], c["mu"], c["count"]),
    )
    metric = DenseMetric(*dense_metric_from_minv(w["metric_minv"], dtype, device,
                                                 w["metric_chol"], w["metric_pchol"]))
    moments = [tuple(np.asarray(p) for p in m) for m in w["moments"]]
    div = np.asarray(w["div"])[block]
    if envelope is not None and w.get("envelope") is not None:
        envelope.restore(w["envelope"])
    return carry, metric, moments, ([div] if div.size else []), pos


def _warmup_checkpoint(carry, metric, moments, div_chunks, pos, generator, meta, mesh=None,
                       envelope=None):
    """The warmup-phase checkpoint of every chain (gathered over the ranks
    of a mesh: every rank must call it)."""
    rows = lambda a: gather_rows(mesh, a)  # noqa: E731
    arrays = {name: rows(t).cpu().numpy() for name, t in
              dict(q=carry.chain.q, logp=carry.chain.logp, grad=carry.chain.grad,
                   **carry.da._asdict()).items()}
    div = rows(np.concatenate(div_chunks, axis=1) if div_chunks
               else np.zeros((carry.chain.q.shape[0], 0), dtype=bool))
    rng_state, rng_device = ckpt_io.generator_state(generator)
    return ckpt_io.SamplerCheckpoint(
        psi=arrays["q"], step_size=np.zeros(0),
        inv_mass=metric.minv.cpu().numpy(), rng_state=rng_state, rng_device=rng_device,
        meta=meta, phase="warmup",
        warmup={
            "pos": pos,
            "carry": {name: arrays[name] for name in ckpt_io.WARMUP_CARRY_FIELDS},
            "metric_minv": metric.minv.cpu().numpy(),
            "metric_chol": metric.chol_minv.cpu().numpy(),
            "metric_pchol": metric.p_chol.cpu().numpy(),
            "moments": list(moments),  # the live list grows after this chunk
            "div": div,
            "envelope": envelope.state() if envelope is not None else None,
        },
    )


def _psum_moments(mesh: Mesh, moments):
    """Window moments (cnt, s1, s2, n_win, n_div) summed over the ranks in
    one all_reduce."""
    flat = mesh.psum(torch.cat([m.reshape(-1) for m in moments]))
    parts = flat.split([m.numel() for m in moments])
    return tuple(p.reshape(m.shape) for p, m in zip(parts, moments))


def _collect_probe(envelope, edges, leaves, div, n_boundaries, mesh):
    """The envelope's collection after a warmup chunk: each chain's last
    divergent step (edge, leaf) from the chunk's (C, L, dim) stacks, and
    the chunk's divergence flags, gathered over the ranks of a mesh; rank 0
    alone probes (the other ranks never call ``hess_fn``)."""
    edge, has_div = _last_div_position(edges, div)
    leaf, _ = _last_div_position(leaves, div)
    q_ld = torch.stack([edge, leaf], dim=1)
    if mesh is not None:  # flags travel as bytes (gloo reduces no bool)
        q_ld, has_div, div = (mesh.all_gather(t) for t in (
            q_ld, has_div.to(torch.uint8), div.to(torch.uint8)))
    if mesh is None or mesh.rank == 0:
        envelope.collect(q_ld.cpu().numpy(), has_div.cpu().numpy(), div.cpu().numpy(),
                         past_first_window=n_boundaries >= 1)


def _warmup_pooled(vg, psi0, generator, n_adapts, chunk_size, initial_step_size,
                   target_accept, max_depth, progress, counts, t0, mesh=None, tree=None,
                   resume_ckpt=None, checkpoint_path=None, meta=None, envelope=None):
    """Warmup under the pooled dense metric: chunks aligned to the window
    ends, in-window moments accumulated on the device (and summed over the
    ranks of a mesh), the metric re-estimated on the host at each window
    end; a checkpoint after every chunk when ``checkpoint_path`` is set.
    With ``envelope`` each chain's last divergent step of a chunk is
    offered to it (rank 0's, under a mesh) and its probes are folded into
    every new metric, which rank 0 broadcasts; the transition tracks the
    divergent steps only in the chunks whose probes the envelope takes, after
    the first window end (tracking changes no draw), on a tree of their own.
    The other chunks run on ``tree``. Returns (carry, metric, per-chunk
    (C, L) divergence flags)."""
    n_chains, dim = psi0.shape
    dtype, device = psi0.dtype, psi0.device
    f64 = dict(dtype=torch.float64, device=device)
    in_window, window_end = build_window_schedule(n_adapts)
    chunks = _window_aligned_chunks(window_end, chunk_size)
    trees = {False: tree}
    if envelope is not None:
        trees[True] = LockstepTree(vg, generator, max_depth, mesh=mesh, track_div_leaf=True)
    steps = {track: make_warmup_step_pooled_batched(
        vg, target_accept, max_depth, generator, mesh, track_div_leaf=track, tree=t)
        for track, t in trees.items()}
    # only rank 0 probes and folds; the other ranks take its metric
    folding = envelope if mesh is None or mesh.rank == 0 else None
    resume_pos = 0
    if resume_ckpt is not None:
        carry, metric, window_moments, div_chunks, resume_pos = _restore_warmup(
            resume_ckpt, n_adapts, chunk_size, chunks, generator, dtype, device, mesh, folding)
    else:
        eye = torch.eye(dim, dtype=dtype, device=device)
        metric = DenseMetric(minv=eye, chol_minv=eye, p_chol=eye)
        carry = init_warmup_carry_batched(vg, psi0, initial_step_size)
        div_chunks, window_moments = [], []
    n_boundaries = int(np.sum(window_end[:resume_pos]))
    pos = 0
    for length in chunks:
        if pos + length <= resume_pos:
            pos += length  # run before the checkpoint
            continue
        div = torch.zeros((n_chains, length), dtype=torch.bool, device=device)
        track = envelope is not None and n_boundaries >= 1
        warmup_step = steps[track]
        if track:
            edges = torch.empty((n_chains, length, dim), dtype=dtype, device=device)
            leaves = torch.empty_like(edges)
        cnt, n_win, n_div = (torch.zeros((), **f64) for _ in range(3))
        s1 = torch.zeros(dim, **f64)
        s2 = torch.zeros((dim, dim), **f64)
        for t in range(length):
            carry, stats, *div_pair = warmup_step(carry, bool(window_end[pos + t]), metric)
            counts.add(stats)
            div[:, t] = stats.diverging
            if track:
                edges[:, t], leaves[:, t] = div_pair[0]
            if in_window[pos + t]:
                with trace.span("warmup.moments"):
                    keep = (~stats.diverging).to(torch.float64)
                    q64 = carry.chain.q.to(torch.float64)
                    qm = q64 * keep[:, None]
                    cnt += keep.sum()
                    s1 += qm.sum(dim=0)
                    s2 += qm.T @ q64
                    n_win += n_chains
                    n_div += stats.diverging.sum()
        with trace.span("warmup.readout"):
            div_chunks.append(div.cpu().numpy())
            moments = (cnt, s1, s2, n_win, n_div)
            if mesh is not None:
                moments = _psum_moments(mesh, moments)
            window_moments.append(tuple(m.cpu().numpy() for m in moments))
            counts.host_syncs += 1
        if track:
            _collect_probe(envelope, edges, leaves, div, n_boundaries, mesh)
        pos += length
        if window_end[pos - 1]:
            with trace.span("warmup.refit"):
                metric = pooled_dense_metric_from_moments(window_moments, dim, dtype, metric,
                                                          folding)
                # every rank samples under rank 0's metric, whatever its
                # host's linear algebra rounds differently
                metric = broadcast_tensors(mesh, metric)
            window_moments = []
            n_boundaries += 1
        if checkpoint_path:
            with trace.span("warmup.checkpoint"):
                write_checkpoint(mesh, checkpoint_path, _warmup_checkpoint(
                    carry, metric, window_moments, div_chunks, pos, generator, meta, mesh,
                    folding))
        if progress:
            logger.info("warmup %d/%d (%.1fs, pooled dense metric)",
                        pos, n_adapts, time.perf_counter() - t0)
    if envelope is not None:
        counts.capture_s += trees[True].capture_seconds
    return carry, metric, div_chunks


def _warmup_diag(vg, psi0, generator, n_adapts, chunk_size, initial_step_size,
                 target_accept, max_depth, progress, counts, t0, mesh=None, tree=None):
    """Warmup under per-chain diagonal metrics (Stan's windowed Welford
    adaptation, ``inference/nuts.make_warmup_step``), in chunks of
    ``chunk_size``, on ``tree``. Returns (carry, per-chunk (C, L)
    divergence flags)."""
    carry = init_warmup_carry(vg, psi0, initial_step_size)
    warmup_step = make_warmup_step(vg, target_accept, max_depth, generator, mesh, tree)
    in_window, window_end = build_window_schedule(n_adapts)
    div_chunks = []
    pos = 0
    for length in _chunk_lengths(n_adapts, chunk_size):
        div = torch.zeros((psi0.shape[0], length), dtype=torch.bool, device=psi0.device)
        for t in range(length):
            carry, stats = warmup_step(carry, bool(in_window[pos + t]), bool(window_end[pos + t]))
            counts.add(stats)
            div[:, t] = stats.diverging
        with trace.span("warmup.readout"):
            div_chunks.append(div.cpu().numpy())
            counts.host_syncs += 1
        pos += length
        if progress:
            logger.info("warmup %d/%d (%.1fs, diag metric)", pos, n_adapts,
                        time.perf_counter() - t0)
    return carry, div_chunks


SAMPLE_STATS = ("lp", "accept_prob", "num_leapfrog", "tree_depth", "diverging", "energy")


def _sample(vg, scarry, metric, generator, n_keep, max_depth, chunk_size, jitter_rng,
            step_jitter, step_jitter_low, counts, progress, t0, checkpoint_path=None,
            drawn0=0, mesh=None, tree=None):
    """The sampling phase at frozen step sizes and ``metric`` (shared dense
    or per-chain diagonal), in chunks of ``chunk_size``, on ``tree``; a
    checkpoint after every chunk when ``checkpoint_path`` is set. Returns
    (carry, samples (C, S, dim) numpy, dict of per-draw stats (C, S), the
    last checkpoint or None)."""
    n_chains, dim = scarry.chain.q.shape
    dense = isinstance(metric, DenseMetric)
    step = make_sample_step_batched(vg, max_depth, generator, mesh, tree)
    out = {name: [] for name in ("samples",) + SAMPLE_STATS}
    pos, last = 0, None
    for length in _chunk_lengths(n_keep, chunk_size):
        mults = jitter_multipliers(jitter_rng, length, step_jitter, step_jitter_low)
        qs = torch.empty((n_chains, length, dim), dtype=scarry.chain.q.dtype,
                         device=scarry.chain.q.device)
        cols = {name: [] for name in SAMPLE_STATS}
        for t in range(length):
            scarry, (q, logp, stats) = step(scarry, float(mults[t]) if dense else None, metric)
            counts.add(stats)
            qs[:, t] = q
            for name, value in zip(SAMPLE_STATS, (logp, stats.accept_prob, stats.num_leapfrog,
                                                  stats.tree_depth, stats.diverging, stats.energy)):
                cols[name].append(value)
        out["samples"].append(qs.cpu().numpy())
        for name in SAMPLE_STATS:
            out[name].append(torch.stack(cols[name], dim=1).cpu().numpy())
        counts.host_syncs += 1
        pos += length
        if checkpoint_path:
            n_all = n_chains * (1 if mesh is None else mesh.size)
            last = _sampling_checkpoint(scarry, metric, generator, jitter_rng, step_jitter,
                                        step_jitter_low, drawn0 + n_all * pos, mesh)
            write_checkpoint(mesh, checkpoint_path, last)
        if progress:
            logger.info("sampling %d/%d (%.1fs)", pos, n_keep, time.perf_counter() - t0)
    cat = lambda parts: np.concatenate(parts, axis=1) if parts else np.zeros((n_chains, 0))
    return scarry, cat(out["samples"]), {name: cat(out[name]) for name in SAMPLE_STATS}, last


def _sampling_checkpoint(scarry, metric, generator, jitter_rng, step_jitter, step_jitter_low,
                         n_drawn, mesh=None):
    """The sampling-phase checkpoint of every chain (gathered over the
    ranks of a mesh: every rank must call it)."""
    dense = isinstance(metric, DenseMetric)
    rows = lambda t: gather_rows(mesh, t).cpu().numpy()  # noqa: E731
    rng_state, rng_device = ckpt_io.generator_state(generator)
    state = {"logp": rows(scarry.chain.logp), "grad": rows(scarry.chain.grad)}
    if dense:
        state.update(metric_chol=metric.chol_minv.cpu().numpy(),
                     metric_pchol=metric.p_chol.cpu().numpy())
    return ckpt_io.SamplerCheckpoint(
        psi=rows(scarry.chain.q), step_size=rows(scarry.eps),
        inv_mass=metric.minv.cpu().numpy() if dense else rows(metric.inv_mass),
        rng_state=rng_state, rng_device=rng_device, n_samples_drawn=int(n_drawn),
        meta={"metric": "dense-pooled" if dense else "diag",
              "step_jitter": float(step_jitter), "step_jitter_low": float(step_jitter_low),
              "jitter_rng": jitter_rng.bit_generator.state},
        state=state,
    )


def _run_info(samples_stats, metric, mass_matrix, step_jitter, step_jitter_low, eps,
              scarry, generator, counts, warmup_div, warmup_time, sampling_time, mesh=None):
    """The info dict; under a mesh every per-chain array is gathered over
    the ranks (the counts stay the rank's own)."""
    rows = lambda a: gather_rows(mesh, a)  # noqa: E731
    info = {name: rows(a) for name, a in samples_stats.items()}
    info.update(
        step_size=rows(eps).cpu().numpy(),
        inv_mass=(metric.minv if mass_matrix == "dense-pooled"
                  else rows(metric.inv_mass)).cpu().numpy(),
        metric=mass_matrix,
        step_jitter=(float(step_jitter), float(step_jitter_low)),
        warmup_diverging=rows(warmup_div),
        final_psi=rows(scarry.chain.q).cpu().numpy(),
        # the state of the one generator all chains draw from (the JAX
        # package returns each chain's PRNG key)
        final_key=generator.get_state().numpy(),
        warmup_time_s=warmup_time,
        sampling_time_s=sampling_time,
        **counts.info(),
    )
    return info


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
    checkpoint_path: str | None = None,
    resume_ckpt=None,
    envelope=None,
    mesh: Mesh | None = None,
    batched_transition: bool = True,
):
    """Run C NUTS chains from psi0 (C, dim) with Stan warmup. ``vg`` maps
    (C, dim) -> ((C,), (C, dim)). Random numbers come from ``generator``
    (on psi0's device) and the step-jitter multipliers from the host
    ``jitter_rng``. On a CUDA device ``vg`` is replayed from a CUDA graph
    (GraphedValueAndGrad), C = 1 included, and the NUTS tree runs one CUDA
    graph per doubling (``LockstepTree``, shared by warmup and sampling).
    Returns (samples (C, S, dim) numpy, info dict of numpy arrays with a
    leading chain axis).

    ``mass_matrix``: "dense-pooled", one dense metric shared by all chains
    and estimated from their pooled in-window draws (``step_jitter``,
    warmup checkpoints and ``resume_ckpt`` apply here only); or "diag",
    per-chain diagonal Welford adaptation (Stan parity), where
    ``info["inv_mass"]`` is (C, dim). ``checkpoint_path``: a checkpoint
    after every sampling chunk (and every pooled warmup chunk).
    ``resume_ckpt``: a warmup-phase checkpoint of the same call to continue
    from. ``envelope`` (dense-pooled only): a ``CurvatureEnvelope``, whose
    probes of divergent warmup steps fold into the pooled metric at every
    window end; info then has ``envelope_points``, ``envelope_boost_dirs``
    and ``envelope_boost_max``.

    ``batched_transition``: the JAX package's switch between its
    hand-batched transition and a vmapped one, which give the same
    trajectories; the port has one tree code, the batched one, and keeps
    the switch for the JAX package's refusal of the envelope without it.

    ``mesh`` (``make_chain_mesh``): every rank calls run_chains with the
    same arguments (psi0 of all C chains, a generator seeded alike) and
    runs its block of C/size chains; C must be a multiple of the mesh size.
    Each rank returns the samples and per-chain info of all C chains; the
    counts in info are the rank's own. Checkpoints hold every chain (rank 0
    writes them) and ``resume_ckpt`` gives each rank its block."""
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
    if envelope is not None and not batched_transition:
        raise ValueError(
            "the curvature envelope needs the divergent-leaf positions "
            "only the batched transition tracks (nuts_batched "
            "track_div_leaf); run with batched_transition=True."
        )
    if mesh is not None:
        mesh.check_divides(psi0.shape[0], "n_chains")
        psi0 = psi0[mesh.block(psi0.shape[0])]
    if jitter_rng is None:
        jitter_rng = np.random.default_rng(0)
    n_keep = n_samples - n_adapts
    device = psi0.device
    counts = Counts()

    with trace.timed("warmup") as warmup:
        t0 = time.perf_counter()
        if device.type == "cuda":
            vg = GraphedValueAndGrad(vg, psi0)
        tree = LockstepTree(vg, generator, max_depth, mesh=mesh)
        warm_args = (vg, psi0, generator, n_adapts, chunk_size, initial_step_size, target_accept,
                     max_depth, progress, counts, t0, mesh, tree)
        if mass_matrix == "diag":
            carry, warmup_div_chunks = _warmup_diag(*warm_args)
            metric = DiagMetric(carry.inv_mass)
        else:
            meta = {"metric": "dense-pooled", "step_jitter": float(step_jitter),
                    "step_jitter_low": float(step_jitter_low), "n_adapts": int(n_adapts),
                    "chunk_size": int(chunk_size)}
            carry, metric, warmup_div_chunks = _warmup_pooled(
                *warm_args, resume_ckpt=resume_ckpt, checkpoint_path=checkpoint_path, meta=meta,
                envelope=envelope)
        eps_final = torch.exp(carry.da.log_eps_avg)
        _sync(device)

    with trace.timed("sampling") as sampling:
        scarry = SampleCarry(chain=carry.chain, eps=eps_final)
        scarry, samples, stats, _ = _sample(
            vg, scarry, metric, generator, n_keep, max_depth, chunk_size, jitter_rng,
            step_jitter, step_jitter_low, counts, progress, t0, checkpoint_path, mesh=mesh,
            tree=tree)
        _sync(device)
    counts.capture_s += tree.capture_seconds
    warmup_div = (np.concatenate(warmup_div_chunks, axis=1) if warmup_div_chunks
                  else np.zeros((psi0.shape[0], 0)))
    info = _run_info(stats, metric, mass_matrix, step_jitter, step_jitter_low, eps_final, scarry,
                     generator, counts, warmup_div, warmup.seconds, sampling.seconds, mesh)
    if envelope is not None:
        # rank 0 probed and folded: its readings are the run's
        env_info = envelope.info()
        info.update(env_info if mesh is None else mesh.broadcast_object(env_info))
    return gather_rows(mesh, samples), info


def sample_from_checkpoint(vg, ckpt, n_samples, max_depth, dtype, device, chunk_size,
                           checkpoint_path, progress):
    """Sampling continued from a sampling-phase NUTS checkpoint (see
    ``inference.checkpoint.run_chains_resumed``)."""
    generator = ckpt_io.restore_generator(ckpt.rng_state, ckpt.rng_device, device)
    meta, state = ckpt.meta or {}, ckpt.state or {}
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    psi = put(ckpt.psi)
    n_chains = psi.shape[0]
    if meta.get("metric") == "dense-pooled":
        metric = DenseMetric(*dense_metric_from_minv(
            ckpt.inv_mass, dtype, device, state.get("metric_chol"), state.get("metric_pchol")))
        mass_matrix = "dense-pooled"
    else:
        metric = DiagMetric(put(ckpt.inv_mass).expand(n_chains, -1))
        mass_matrix = "diag"
    jitter_rng = np.random.default_rng(0)
    if meta.get("jitter_rng"):
        jitter_rng.bit_generator.state = meta["jitter_rng"]
    step_jitter = float(meta.get("step_jitter", 0.0) or 0.0)
    step_jitter_low = float(meta.get("step_jitter_low", 0.4) or 0.4)
    counts = Counts()
    t0 = time.perf_counter()
    if device.type == "cuda":
        vg = GraphedValueAndGrad(vg, psi)
    if "logp" in state and "grad" in state:
        logp, grad = put(state["logp"]), put(state["grad"])
    else:
        logp, grad = vg(psi)
    eps = put(ckpt.step_size).expand(n_chains)
    scarry = SampleCarry(chain=ChainState(q=psi, logp=logp, grad=grad), eps=eps)
    tree = LockstepTree(vg, generator, max_depth)
    scarry, samples, stats, last = _sample(
        vg, scarry, metric, generator, n_samples, max_depth, chunk_size, jitter_rng,
        step_jitter, step_jitter_low, counts, progress, t0, checkpoint_path,
        drawn0=int(ckpt.n_samples_drawn), tree=tree)
    _sync(device)
    counts.capture_s += tree.capture_seconds
    if last is None:
        last = _sampling_checkpoint(scarry, metric, generator, jitter_rng, step_jitter,
                                    step_jitter_low, ckpt.n_samples_drawn + samples[:, :, 0].size)
    info = _run_info(stats, metric, mass_matrix, step_jitter, step_jitter_low, eps, scarry,
                     generator, counts, np.zeros((n_chains, 0)), 0.0, time.perf_counter() - t0)
    return samples, info, last
