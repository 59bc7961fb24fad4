"""NUTS types, metrics and the single-chain API (port of the JAX package's
inference/nuts.py).

The transition itself is ``inference/nuts_batched.py``'s, over an explicit
(C, dim) chain axis. A single chain is that transition at C = 1:
``nuts_transition`` and ``run_nuts`` are views of one chain over the
batched transition and over ``parallel/chains.run_chains``, not a second
recursive implementation (which would cost a host synchronisation per
leaf). The warmup and sampling steps here take carries with a leading
chain axis, C = 1 included.

Three metrics, one tree code: ``DenseMetric`` (a full M^-1 shared by all
chains), ``RungDenseMetric`` (one full M^-1 per tempering rung) and
``DiagMetric`` (a per-chain diagonal M^-1, Stan's
``DiagEuclideanMetric``). The transition only calls ``momentum(z)`` (a
draw p ~ N(0, M) from z ~ N(0, I)) and ``velocity(p)`` (M^-1 p), and the
leaf's kernel ``diagonal()`` (the diagonal metric's inverse mass, whose
product it computes itself; None for the other two: ops/leaf.py). A dense
metric's ``velocity`` is ops/minv_mv.py's product, a hand-written kernel on
the card; a per-rung one's stays an einsum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.minv_mv import minv_mv
from ..utils import trace
from .adapt import (
    DualAveragingState,
    WelfordState,
    da_init,
    da_restart,
    da_update,
    welford_init,
    welford_update,
    welford_variance_regularized,
)

MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


class DenseMetric(NamedTuple):
    """Full inverse-mass metric: M^-1, chol(M^-1) (lower) and the
    precomputed momentum factor p_chol = chol(M^-1)^-T (upper), so that a
    momentum draw p ~ N(0, M) is p = p_chol @ z, one matmul."""

    minv: torch.Tensor       # (dim, dim)
    chol_minv: torch.Tensor  # (dim, dim) lower
    p_chol: torch.Tensor     # (dim, dim) upper

    def momentum(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.p_chol.T

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        """M^-1 p, p @ minv.T: the kernel on the card, the plain product on
        the CPU (ops/minv_mv.py)."""
        return minv_mv(self.minv, p)

    def diagonal(self) -> None:
        return None


class RungDenseMetric(NamedTuple):
    """One full inverse-mass metric per temperature rung, shared by the
    replicas (parallel tempering under ``mass_matrix="dense-pooled"``):
    (K, dim, dim) stacks of ``DenseMetric``'s three factors. Chains are laid
    out replica-major, so chain c is on rung c mod K; ``momentum`` and
    ``velocity`` apply each rung's factor to its chains as one batched
    product over the (R, K, dim) view."""

    minv: torch.Tensor       # (K, dim, dim)
    chol_minv: torch.Tensor  # (K, dim, dim) lower
    p_chol: torch.Tensor     # (K, dim, dim) upper

    def _apply(self, mats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        k, dim = mats.shape[0], x.shape[-1]
        return torch.einsum("rkj,kij->rki", x.reshape(-1, k, dim), mats).reshape(x.shape)

    def momentum(self, z: torch.Tensor) -> torch.Tensor:
        return self._apply(self.p_chol, z)

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return self._apply(self.minv, p)

    def diagonal(self) -> None:
        return None


class DiagMetric(NamedTuple):
    """Diagonal inverse-mass metric: ``inv_mass`` (C, dim) per chain, or
    (dim,) shared; p = z / sqrt(inv_mass) and M^-1 p = inv_mass * p."""

    inv_mass: torch.Tensor

    def momentum(self, z: torch.Tensor) -> torch.Tensor:
        return z / torch.sqrt(self.inv_mass)

    def velocity(self, p: torch.Tensor) -> torch.Tensor:
        return self.inv_mass * p

    def diagonal(self) -> torch.Tensor:
        return self.inv_mass


class NutsStats(NamedTuple):
    """Per-chain statistics of one batched transition, plus two host
    counts of the lockstep loop: ``host_syncs`` (device-to-host reads) and
    ``lockstep_leaves`` (batched leapfrog steps run, paid by every
    chain)."""

    accept_prob: torch.Tensor
    num_leapfrog: torch.Tensor
    tree_depth: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor
    host_syncs: int = 0
    lockstep_leaves: int = 0


class ChainState(NamedTuple):
    """Chain positions with their log-densities and gradients, (C, ...)."""

    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class WarmupCarry(NamedTuple):
    """Warmup state: per-chain dual averaging, and under the diagonal
    metric the Welford moments of the current window and the inverse mass
    (C, dim); the pooled dense path leaves both None (its metric is the
    driver's)."""

    chain: ChainState
    da: DualAveragingState
    welford: Optional[WelfordState] = None
    inv_mass: Optional[torch.Tensor] = None


class SampleCarry(NamedTuple):
    chain: ChainState
    eps: torch.Tensor
    inv_mass: Optional[torch.Tensor] = None


def _popcount32(x: int) -> int:
    """Population count of a non-negative int (a leaf's index is a constant
    of its doubling in the port, so the JAX package's branchless SWAR form
    is unnecessary)."""
    return bin(int(x)).count("1")


def _leaf_idx_to_ckpt_idxs(n: int):
    """Checkpoint index range for the U-turn checks at leaf n (iterative
    NUTS): idx_max = popcount(n >> 1), idx_min = idx_max - (trailing ones
    of n) + 1."""
    idx_max = _popcount32(n >> 1)
    n_trail = _popcount32(((n + 1) & -(n + 1)) - 1)
    return idx_max - n_trail + 1, idx_max


# ---------------------------------------------------------------------------
# Warmup and sampling under the diagonal metric (carries with a chain axis)
# ---------------------------------------------------------------------------


def init_warmup_carry(vg_b, q0s: torch.Tensor, initial_step_size) -> WarmupCarry:
    """Evaluate the start positions (C, dim); start per-chain dual
    averaging, empty Welford moments (kept in the working dtype, as in the
    JAX package) and a unit inverse mass."""
    c, dim = q0s.shape
    logp0, grad0 = vg_b(q0s)
    eps0 = torch.full((c,), float(initial_step_size), dtype=q0s.dtype, device=q0s.device)
    return WarmupCarry(
        chain=ChainState(q=q0s, logp=logp0, grad=grad0),
        da=da_init(eps0),
        welford=welford_init(dim, q0s.dtype, q0s.device, batch=(c,)),
        inv_mass=torch.ones_like(q0s),
    )


def make_warmup_step(vg_b, target_accept: float, max_depth: int, generator: torch.Generator,
                     mesh=None, tree=None):
    """One warmup transition per chain under its own diagonal metric, with
    Stan's adaptation: dual averaging every step; the draw joins the
    window's Welford moments when ``in_win``, and at ``win_end`` the inverse
    mass becomes the regularized window variance, the moments restart and
    dual averaging restarts. The window flags are host booleans shared by
    all chains (``adapt.build_window_schedule``). Under a chain ``mesh``
    the carry holds this rank's block of chains. The transitions run on
    ``tree`` (a new ``nuts_batched.LockstepTree`` by default)."""
    from .nuts_batched import LockstepTree, nuts_transition_batched

    if tree is None:
        tree = LockstepTree(vg_b, generator, max_depth, mesh=mesh)

    def warmup_step(carry: WarmupCarry, in_win: bool, win_end: bool):
        chain = carry.chain
        with trace.span("warmup.transition"):
            q, logp, grad, stats = nuts_transition_batched(
                vg_b, chain.q, chain.logp, chain.grad, torch.exp(carry.da.log_eps),
                DiagMetric(carry.inv_mass), generator, max_depth=max_depth, mesh=mesh,
                tree=tree,
            )
            da = da_update(carry.da, stats.accept_prob, target_accept)
        welford, inv_mass = carry.welford, carry.inv_mass
        if in_win:
            with trace.span("warmup.moments"):
                welford = welford_update(welford, q)
        if win_end:
            with trace.span("warmup.refit"):
                inv_mass = welford_variance_regularized(welford)
                welford = welford_init(q.shape[1], q.dtype, q.device, batch=(q.shape[0],))
            da = da_restart(da)
        chain = ChainState(q=q, logp=logp, grad=grad)
        return WarmupCarry(chain=chain, da=da, welford=welford, inv_mass=inv_mass), stats

    return warmup_step


def make_sample_step(vg_b, max_depth: int, generator: torch.Generator):
    """One post-warmup transition per chain at its frozen step size and
    inverse mass (``carry.eps``, ``carry.inv_mass``)."""
    from .nuts_batched import make_sample_step_batched

    step = make_sample_step_batched(vg_b, max_depth, generator)

    def sample_step(carry: SampleCarry):
        return step(carry, None, DiagMetric(carry.inv_mass))

    return sample_step


# ---------------------------------------------------------------------------
# One chain: views over the batched transition and the chain driver
# ---------------------------------------------------------------------------


def _metric(inv_mass):
    """A DenseMetric as it is; a (dim,) tensor as the diagonal metric."""
    return inv_mass if isinstance(inv_mass, DenseMetric) else DiagMetric(inv_mass)


def _one_chain(vg):
    """(dim,) -> ((), (dim,)) as (1, dim) -> ((1,), (1, dim)). A
    value-and-grad that ends in a collective (``parallel/grid.py``) keeps its
    ``local`` part and ``reduce`` apart, so that the chain driver's CUDA
    graph captures the local part only."""

    def vg_b(q):
        logp, grad = vg(q[0])
        return logp[None], grad[None]

    if hasattr(vg, "reduce"):
        vg_b.local, vg_b.reduce = _one_chain(vg.local), vg.reduce
    return vg_b


def nuts_transition(vg, q, logp, grad, generator: torch.Generator, step_size, inv_mass,
                    max_depth: int = 10, max_delta_energy: float = MAX_DELTA_ENERGY):
    """One NUTS transition of one chain from (q (dim,), logp (), grad
    (dim,)) under ``inv_mass``, a (dim,) diagonal or a DenseMetric. ``vg``
    maps (dim,) -> ((), (dim,)). Returns (q', logp', grad', NutsStats) with
    per-chain statistics of shape (1,)."""
    from .nuts_batched import nuts_transition_batched

    q1, logp1, grad1, stats = nuts_transition_batched(
        _one_chain(vg), q[None], logp.reshape(1), grad[None], step_size, _metric(inv_mass),
        generator, max_depth=max_depth, max_delta_energy=max_delta_energy,
    )
    return q1[0], logp1[0], grad1[0], stats


def run_nuts(
    vg,
    q0: torch.Tensor,
    generator: torch.Generator,
    n_samples: int,
    n_adapts: int,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    max_depth: int = 10,
):
    """Single-chain NUTS with Stan warmup (diagonal Welford metric). ``vg``
    maps (dim,) -> ((), (dim,)); random numbers come from ``generator`` on
    q0's device. Returns (samples (n_samples - n_adapts, dim) numpy, info
    dict) with the JAX package's info keys and no chain axis.

    This is ``parallel/chains.run_chains(mass_matrix="diag")`` at C = 1."""
    from ..parallel.chains import run_chains

    samples, info = run_chains(
        _one_chain(vg), q0[None], generator, n_samples=n_samples, n_adapts=n_adapts,
        initial_step_size=initial_step_size, target_accept=target_accept,
        max_depth=max_depth, mass_matrix="diag", chunk_size=max(n_samples, 1),
    )
    per_chain = ("lp", "accept_prob", "num_leapfrog", "tree_depth", "diverging", "energy",
                 "step_size", "inv_mass", "warmup_diverging", "final_psi")
    return samples[0], {k: (np.asarray(v)[0] if k in per_chain else v) for k, v in info.items()}
