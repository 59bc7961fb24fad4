"""Batched NUTS transition over an explicit (C, dim) chain axis (port of
the JAX package's inference/nuts_batched.py).

Per chain the semantics are those of the JAX package: multinomial
trajectory sampling, biased progressive sampling across doublings, the
generalized U-turn criterion with the checkpointed sub-tree checks of
iterative NUTS, divergence at MAX_DELTA_ENERGY. The metric is a
``nuts.DenseMetric`` shared by all chains (``p @ minv.T``, momenta drawn as
``z @ p_chol.T``) or a per-chain ``nuts.DiagMetric`` (``inv_mass * p``,
``z / sqrt(inv_mass)``); the tree code only calls its ``momentum`` and
``velocity``.

The JAX package keeps both lockstep loops on the device. Eager PyTorch
cannot branch on device values without a host synchronisation, so the
loops are arranged around that cost:

- the leaf counter j and the doubling counter i are host integers; the
  checkpoint row a leaf writes or checks (popcount(j >> 1)) is therefore a
  host integer, and even leaves skip the U-turn sweep by a Python branch;
- a doubling runs its 2^i leaves as batched leapfrog steps with per-chain
  ``alive`` masks (a chain that diverged or turned stops committing
  state);
- the done flags are read on the host once per doubling, to stop when
  every chain is done, and the ``alive`` flags after every odd leaf of a
  doubling (where the U-turn checks run), to stop the doubling once no
  chain is still building it, as the JAX package's loop condition does.
  A transition that runs L batched leaves over d doublings costs about
  L/2 + d host synchronisations, counted in ``NutsStats.host_syncs``.
  Each batched leaf costs milliseconds of host time in eager PyTorch
  (PERF.md), so a read that skips the rest of a doubling is worth far
  more than the synchronisation it costs.

Leaf state is packed as one (C, 5, dim) tensor [q, p, v, grad, M^-1 grad]
so that each masked commit is one ``torch.where``. Random numbers come from
one ``torch.Generator`` on the chains' device.

``track_div_leaf`` (the curvature envelope's warmup, parallel/chains.py)
also records each chain's last divergent leapfrog step: the position it was
taken from (its edge) and the exploded leaf it produced. Off, the
transition issues exactly the operations it issues without the option; on,
it adds two masked copies per leaf and draws the same numbers.

Under a chain mesh (``parallel/mesh.py``) each rank runs the transition of
its block of chains in its own lockstep. Every rank draws each random
tensor for all chains and keeps its block (``mesh.local_draw``), and at the
end of a transition a rank that stopped doubling before the deepest rank
makes the draws of the doublings it skipped (one ``max`` over the ranks per
transition), so the generators stay in step and chain c draws what it
would draw unsharded.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..parallel.mesh import local_draw
from .adapt import da_init, da_restart, da_update
from .nuts import (
    MAX_DELTA_ENERGY,
    ChainState,
    NutsStats,
    SampleCarry,
    WarmupCarry,
    _leaf_idx_to_ckpt_idxs,
    _popcount32,
)

# rows of the packed leaf state
Q, P, V, G, MG = range(5)


def _rowdot(a, b):
    """Per-chain dot product: (C, dim) x (C, dim) -> (C,). An elementwise
    product summed along its rows rounds a row alike at any C; an einsum
    is a batched GEMM on the card, whose rounding of a row depends on the
    batch's size, so a chain would not compute the same energy in a shard
    of a mesh as in the whole batch."""
    return (a * b).sum(-1)


def _is_turning_b(p_left, v_left, p_right, v_right, rho):
    """(C,) generalized U-turn check with the boundary-momentum correction;
    v_* are the carried M^-1 p_*."""
    rho_c = rho - 0.5 * (p_left + p_right)
    return (_rowdot(v_left, rho_c) <= 0.0) | (_rowdot(v_right, rho_c) <= 0.0)


def _is_iterative_turning_b(p_leaf, v_leaf, rho_cum, ckpts):
    """U-turn checks of every sub-tree ending at this odd leaf, over the
    active checkpoint rows ``ckpts`` (C, R, 3, dim) = [p, v, rho]."""
    r, v_ck, rho_ck = ckpts.unbind(2)
    rho_c = rho_cum[:, None, :] - rho_ck + r - 0.5 * (r + p_leaf[:, None, :])
    t_left = (v_ck * rho_c).sum(-1) <= 0.0
    t_right = (rho_c * v_leaf[:, None, :]).sum(-1) <= 0.0
    return torch.any(t_left | t_right, dim=1)


class SubTree(NamedTuple):
    first: torch.Tensor       # (C, 5, dim) first leaf in build order
    last: torch.Tensor        # (C, 5, dim) last committed leaf
    rho: torch.Tensor         # (C, dim) sum of the committed momenta
    prop: torch.Tensor        # (C, 5, dim) proposal leaf
    logp_prop: torch.Tensor
    log_sum_w: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    leaves_run: int           # batched leapfrog steps run (host count)
    host_syncs: int
    # the divergent step's edge and exploded leaf (C, dim), when tracked
    div_edge: Optional[torch.Tensor] = None
    div_leaf: Optional[torch.Tensor] = None


def _build_subtree_b(
    vg_b, edge, num_leaves: int, eps_signed, metric, h0, alive0,
    generator, max_delta_energy, mesh=None, track_div_leaf: bool = False,
) -> SubTree:
    """``num_leaves`` leapfrog steps outward from ``edge`` for every chain
    alive in ``alive0``. A chain commits each leaf while alive and freezes
    at the leaf where it diverges or its sub-tree turns (so a tracked
    divergent step is written once per sub-tree)."""
    C, _, dim = edge.shape
    dtype, device = edge.dtype, edge.device
    n_rows = max(num_leaves.bit_length() - 1, 1)
    ckpts = torch.zeros((C, n_rows, 3, dim), dtype=dtype, device=device)
    u_leaf = local_draw(torch.rand, generator, (num_leaves, C), 1, mesh, dtype, device)
    half = (0.5 * eps_signed)[:, None]
    step = eps_signed[:, None]

    cur, first = edge, edge
    rho = torch.zeros((C, dim), dtype=dtype, device=device)
    prop = edge
    logp_prop = torch.zeros(C, dtype=dtype, device=device)
    log_sum_w = torch.full((C,), -torch.inf, dtype=dtype, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    n_leaves = torch.zeros(C, dtype=dtype, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    alive = alive0
    host_syncs = 0
    div_edge = div_leaf = None
    if track_div_leaf:
        div_edge = torch.zeros((C, dim), dtype=dtype, device=device)
        div_leaf = torch.zeros((C, dim), dtype=dtype, device=device)

    for j in range(num_leaves):
        q, p, v, g, mg = cur.unbind(1)
        p_half = p + half * g
        v_half = v + half * mg
        q_n = q + step * v_half
        logp_n, g_n = vg_b(q_n)
        mg_n = metric.velocity(g_n)
        p_n = p_half + half * g_n
        v_n = v_half + half * mg_n
        leaf = torch.stack([q_n, p_n, v_n, g_n, mg_n], dim=1)

        delta = -logp_n + 0.5 * _rowdot(p_n, v_n) - h0
        bad = ~(delta <= max_delta_energy)  # NaN -> True
        w = torch.where(bad, -torch.inf, -delta)
        accept = torch.where(bad, 0.0, torch.exp(torch.clamp(-delta, max=0.0)))
        lsw = torch.logaddexp(log_sum_w, w)
        take = alive & (u_leaf[j] < torch.exp(w - lsw))
        prop = torch.where(take[:, None, None], leaf, prop)
        logp_prop = torch.where(take, logp_n, logp_prop)

        alive3 = alive[:, None, None]
        rho = torch.where(alive[:, None], rho + p_n, rho)
        if j == 0:
            first = torch.where(alive3, leaf, first)
        if j % 2 == 0:
            row = _popcount32(j >> 1)
            ckpts[:, row] = torch.where(
                alive3, torch.stack([p_n, v_n, rho], dim=1), ckpts[:, row]
            )
            stop = bad
        else:
            lo, hi = _leaf_idx_to_ckpt_idxs(j)
            turned = _is_iterative_turning_b(p_n, v_n, rho, ckpts[:, lo : hi + 1])
            turning = torch.where(alive, turned, turning)
            stop = bad | turned

        if track_div_leaf:
            newly_bad = (alive & bad)[:, None]
            div_edge = torch.where(newly_bad, q, div_edge)
            div_leaf = torch.where(newly_bad, q_n, div_leaf)
        cur = torch.where(alive3, leaf, cur)
        log_sum_w = torch.where(alive, lsw, log_sum_w)
        sum_accept = sum_accept + torch.where(alive, accept, 0.0)
        n_leaves = n_leaves + alive
        diverging = diverging | (alive & bad)
        alive = alive & ~stop
        if j % 2 == 1 and j + 1 < num_leaves:
            host_syncs += 1
            if not bool(alive.any()):
                break

    return SubTree(
        first=first, last=cur, rho=rho, prop=prop, logp_prop=logp_prop,
        log_sum_w=log_sum_w, sum_accept=sum_accept, num_leaves=n_leaves,
        diverging=diverging, turning=turning, leaves_run=j + 1,
        host_syncs=host_syncs, div_edge=div_edge, div_leaf=div_leaf,
    )


def nuts_transition_batched(
    vg_b: Callable,
    q: torch.Tensor,         # (C, dim)
    logp: torch.Tensor,      # (C,)
    grad: torch.Tensor,      # (C, dim)
    step_size,               # scalar or (C,)
    metric,                  # DenseMetric or DiagMetric
    generator: torch.Generator,
    max_depth: int = 10,
    max_delta_energy: float = MAX_DELTA_ENERGY,
    mesh=None,
    track_div_leaf: bool = False,
):
    """One NUTS transition for all C chains under ``metric``.
    ``vg_b`` maps (C, dim) -> ((C,), (C, dim)). Under a chain ``mesh`` the
    C chains are this rank's block (see the module docstring). Returns
    (q', logp', grad', NutsStats), and with ``track_div_leaf`` a fifth
    output: (edge, leaf), each (C, dim), the two endpoints of each chain's
    divergent leapfrog step (zeros for a chain that did not diverge)."""
    C, dim = q.shape
    dtype, device = q.dtype, q.device
    eps = torch.as_tensor(step_size, dtype=dtype, device=device).expand(C)

    z = local_draw(torch.randn, generator, (C, dim), 0, mesh, dtype, device)
    p0 = metric.momentum(z)
    v0 = metric.velocity(p0)
    h0 = -logp + 0.5 * _rowdot(p0, v0)
    left = right = torch.stack([q, p0, v0, grad, metric.velocity(grad)], dim=1)
    rho = p0
    prop = left
    logp_prop = logp
    log_sum_w = torch.zeros(C, dtype=dtype, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    num_leaves = torch.zeros(C, dtype=dtype, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    depth = torch.zeros(C, dtype=torch.int32, device=device)
    done = torch.zeros(C, dtype=torch.bool, device=device)
    host_syncs = lockstep_leaves = doublings = 0
    if track_div_leaf:
        div_edge = torch.zeros((C, dim), dtype=dtype, device=device)
        div_leaf = torch.zeros((C, dim), dtype=dtype, device=device)

    for i in range(max_depth):
        if i > 0:
            host_syncs += 1
            if bool(done.all()):
                break
        doublings += 1
        upd = ~done
        u = local_draw(torch.rand, generator, (2, C), 1, mesh, dtype, device)
        go_right = u[0] < 0.5
        gr3 = go_right[:, None, None]
        direction = torch.where(go_right, 1.0, -1.0).to(dtype)
        sub = _build_subtree_b(
            vg_b, torch.where(gr3, right, left), 1 << i, direction * eps,
            metric, h0, upd, generator, max_delta_energy, mesh, track_div_leaf,
        )
        lockstep_leaves += sub.leaves_run
        host_syncs += sub.host_syncs
        valid = upd & ~(sub.diverging | sub.turning)
        take_new = valid & (
            u[1] < torch.exp(torch.clamp(sub.log_sum_w - log_sum_w, max=0.0))
        )
        prop = torch.where(take_new[:, None, None], sub.prop, prop)
        logp_prop = torch.where(take_new, sub.logp_prop, logp_prop)

        # the sub-tree's last leaf is the new outer edge in its direction
        new_left = torch.where(gr3, left, sub.last)
        new_right = torch.where(gr3, sub.last, right)
        new_rho = rho + sub.rho
        turning_combined = _is_turning_b(
            new_left[:, P], new_left[:, V], new_right[:, P], new_right[:, V], new_rho
        )
        valid3 = valid[:, None, None]
        left = torch.where(valid3, new_left, left)
        right = torch.where(valid3, new_right, right)
        rho = torch.where(valid[:, None], new_rho, rho)
        log_sum_w = torch.where(
            valid, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w
        )
        sum_accept = sum_accept + torch.where(upd, sub.sum_accept, 0.0)
        num_leaves = num_leaves + torch.where(upd, sub.num_leaves, 0.0)
        if track_div_leaf:
            # one divergent sub-tree at most per transition: done is set
            hit = (upd & sub.diverging)[:, None]
            div_edge = torch.where(hit, sub.div_edge, div_edge)
            div_leaf = torch.where(hit, sub.div_leaf, div_leaf)
        diverging = diverging | (upd & sub.diverging)
        done = done | (upd & (sub.diverging | sub.turning | turning_combined))
        depth = torch.where(upd, i + 1, depth)

    if mesh is not None:
        # the draws of the doublings the deepest rank ran and this one did not
        host_syncs += 1
        full = C * mesh.size
        for i in range(doublings, mesh.max_int(doublings)):
            torch.rand((2, full), generator=generator, dtype=dtype, device=device)
            torch.rand((1 << i, full), generator=generator, dtype=dtype, device=device)

    stats = NutsStats(
        accept_prob=sum_accept / torch.clamp(num_leaves, min=1.0),
        num_leapfrog=num_leaves,
        tree_depth=depth,
        diverging=diverging,
        energy=h0,
        step_size=eps,
        host_syncs=host_syncs,
        lockstep_leaves=lockstep_leaves,
    )
    if track_div_leaf:
        return prop[:, Q], logp_prop, prop[:, G], stats, (div_edge, div_leaf)
    return prop[:, Q], logp_prop, prop[:, G], stats


# ---------------------------------------------------------------------------
# Warmup under the shared dense metric; sampling under either metric
# ---------------------------------------------------------------------------


def init_warmup_carry_batched(vg_b, q0s: torch.Tensor, initial_step_size) -> WarmupCarry:
    """Evaluate the start positions and start per-chain dual averaging."""
    logp0, grad0 = vg_b(q0s)
    eps0 = torch.full((q0s.shape[0],), float(initial_step_size), dtype=q0s.dtype,
                      device=q0s.device)
    return WarmupCarry(chain=ChainState(q=q0s, logp=logp0, grad=grad0), da=da_init(eps0))


def make_warmup_step_pooled_batched(
    vg_b, target_accept: float, max_depth: int, generator: torch.Generator, mesh=None,
    track_div_leaf: bool = False,
):
    """Warmup transition with per-chain dual averaging of the step size
    (restarted at adaptation-window ends) under the shared metric, which
    the driver re-estimates between windows. Returns (carry, stats), and
    with ``track_div_leaf`` also the divergent step's (edge, leaf)."""

    def warmup_step(carry: WarmupCarry, win_end: bool, metric):
        chain = carry.chain
        q, logp, grad, stats, *div_pair = nuts_transition_batched(
            vg_b, chain.q, chain.logp, chain.grad, torch.exp(carry.da.log_eps),
            metric, generator, max_depth=max_depth, mesh=mesh, track_div_leaf=track_div_leaf,
        )
        da = da_update(carry.da, stats.accept_prob, target_accept)
        if win_end:
            da = da_restart(da)
        return (WarmupCarry(chain=ChainState(q=q, logp=logp, grad=grad), da=da), stats,
                *div_pair)

    return warmup_step


def make_sample_step_batched(vg_b, max_depth: int, generator: torch.Generator, mesh=None):
    """Post-warmup transition at the frozen per-chain step sizes, scaled by
    an optional step-size multiplier shared by all chains (``step_jitter``
    in parallel/chains.py), under ``metric``."""

    def sample_step(carry: SampleCarry, eps_mult, metric):
        chain = carry.chain
        eps = carry.eps if eps_mult is None else carry.eps * eps_mult
        q, logp, grad, stats = nuts_transition_batched(
            vg_b, chain.q, chain.logp, chain.grad, eps, metric, generator,
            max_depth=max_depth, mesh=mesh,
        )
        return carry._replace(chain=ChainState(q=q, logp=logp, grad=grad)), (q, logp, stats)

    return sample_step
