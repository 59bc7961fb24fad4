"""One NUTS transition of C chains and one parallel-tempering swap sweep,
written plainly for the benchmark's check of the port: the multinomial
No-U-Turn sampler with biased progressive sampling across doublings and
the generalized U-turn criterion checked on every balanced sub-tree
(iterative NUTS: Hoffman & Gelman 2014; Betancourt 2017; the checkpoint
scheme of NumPyro's iterative tree), divergence at an energy error of 1000.

It consumes random numbers in the port's order, from a source the caller
gives: per transition the momentum's normals (C, dim); per doubling i two
uniforms per chain (direction, merge) and one per leaf (2^i, C). Given the
same numbers, the same start and the same step sizes and metric, it makes
the same draw as a correct implementation, up to rounding at a decision's
margin. It imports nothing of the port and nothing of JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_DELTA_ENERGY = 1000.0


def rowdot(a, b):
    return (a * b).sum(-1)


class Dense:
    """A metric M^-1 shared by every chain (or one per rung: (K, dim, dim),
    chain c on rung c mod K). The momentum factor is worked out here from
    M^-1: p = L^-T z with L L^T = M^-1."""

    def __init__(self, minv: torch.Tensor):
        self.minv = minv
        chol = torch.linalg.cholesky(minv)
        eye = torch.eye(minv.shape[-1], dtype=minv.dtype, device=minv.device)
        self.p_chol = torch.linalg.solve_triangular(chol, eye.expand_as(minv), upper=False
                                                    ).transpose(-1, -2)

    def _apply(self, mats, x):
        if mats.dim() == 2:
            return x @ mats.T
        k = mats.shape[0]
        return torch.einsum("rkj,kij->rki", x.reshape(-1, k, x.shape[-1]), mats).reshape(x.shape)

    def momentum(self, z):
        return self._apply(self.p_chol, z)

    def velocity(self, p):
        return self._apply(self.minv, p)


class Diagonal:
    def __init__(self, inv_mass: torch.Tensor):
        self.inv_mass = inv_mass

    def momentum(self, z):
        return z / torch.sqrt(self.inv_mass)

    def velocity(self, p):
        return self.inv_mass * p


class GeneratorDraws:
    """The port's random numbers re-drawn from a saved torch.Generator
    state, in the chains' dtype on their device, handed over in ``out``."""

    def __init__(self, state: torch.Tensor, device, dtype, n_chains: int, dim: int,
                 out=torch.float64):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(state)
        self.kw = dict(generator=self.gen, dtype=dtype, device=device)
        self.c, self.dim, self.out = n_chains, dim, out

    def momentum(self):
        return torch.randn((self.c, self.dim), **self.kw).to(self.out)

    def doubling(self, i: int):
        u = torch.rand((2, self.c), **self.kw).to(self.out)
        return u, torch.rand((1 << i, self.c), **self.kw).to(self.out)

    def swap(self, n_replicas: int, n_temps: int):
        return torch.rand((n_replicas, n_temps), **self.kw).to(self.out)


class Result(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    depth: torch.Tensor
    n_leaves: torch.Tensor
    accept: torch.Tensor
    diverging: torch.Tensor


def _ckpt_rows(j: int):
    """Checkpoint rows of leaf j: an even leaf writes row popcount(j >> 1);
    an odd leaf checks the rows of every balanced sub-tree it closes."""
    hi = bin(j >> 1).count("1")
    trailing_ones = bin(((j + 1) & -(j + 1)) - 1).count("1")
    return hi - trailing_ones + 1, hi


def _turning(v_left, v_right, rho):
    return (rowdot(v_left, rho) <= 0.0) | (rowdot(v_right, rho) <= 0.0)


def transition(vg, q, logp, grad, eps, metric, draws, max_depth: int = 10) -> Result:
    """One transition of every chain from (q, logp, grad) at step sizes eps
    (C,), in float64. ``vg`` maps (C, dim) to ((C,), (C, dim))."""
    c, dim = q.shape
    z = draws.momentum()
    p0 = metric.momentum(z)
    v0 = metric.velocity(p0)
    h0 = -logp + 0.5 * rowdot(p0, v0)
    start = dict(q=q, p=p0, v=v0, g=grad, mg=metric.velocity(grad))
    left, right, prop = dict(start), dict(start), dict(start)
    logp_prop, rho = logp.clone(), p0.clone()
    log_sum_w = torch.zeros(c, dtype=q.dtype, device=q.device)
    sum_accept, n_leaves = torch.zeros_like(log_sum_w), torch.zeros_like(log_sum_w)
    diverging = torch.zeros(c, dtype=torch.bool, device=q.device)
    done = torch.zeros_like(diverging)
    depth = torch.zeros(c, dtype=torch.int64, device=q.device)
    ckpts = torch.zeros((c, max(max_depth - 1, 1), 3, dim), dtype=q.dtype, device=q.device)
    pick = lambda m, a, b: {k: torch.where(m[:, None], a[k], b[k]) for k in a}  # noqa: E731

    for i in range(max_depth):
        u, u_leaf = draws.doubling(i)
        right_way = u[0] < 0.5
        signed = torch.where(right_way, eps, -eps)
        half, step = (0.5 * signed)[:, None], signed[:, None]
        cur = pick(right_way, right, left)
        s_prop, s_logp = dict(cur), torch.zeros_like(logp)
        s_rho = torch.zeros_like(q)
        s_lsw = torch.full_like(logp, -torch.inf)
        s_acc, s_n = torch.zeros_like(logp), torch.zeros_like(logp)
        s_div, s_turn = torch.zeros_like(done), torch.zeros_like(done)
        alive = ~done
        for j in range(1 << i):
            if not bool(alive.any()):
                break
            q_n = cur["q"] + step * (cur["v"] + half * cur["mg"])
            logp_n, g_n = vg(q_n)
            mg_n = metric.velocity(g_n)
            p_n = cur["p"] + half * cur["g"] + half * g_n
            v_n = cur["v"] + half * cur["mg"] + half * mg_n
            leaf = dict(q=q_n, p=p_n, v=v_n, g=g_n, mg=mg_n)
            delta = -logp_n + 0.5 * rowdot(p_n, v_n) - h0
            bad = ~(delta <= MAX_DELTA_ENERGY)
            w = torch.where(bad, -torch.inf, -delta)
            accept = torch.where(bad, 0.0, torch.exp(torch.clamp(-delta, max=0.0)))
            lsw = torch.logaddexp(s_lsw, w)
            take = alive & (u_leaf[j] < torch.exp(w - lsw))
            s_prop = pick(take, leaf, s_prop)
            s_logp = torch.where(take, logp_n, s_logp)
            s_rho = torch.where(alive[:, None], s_rho + p_n, s_rho)
            lo, hi = _ckpt_rows(j)
            if j % 2 == 0:
                row = torch.stack([p_n, v_n, s_rho], dim=1)
                ckpts[:, hi] = torch.where(alive[:, None, None], row, ckpts[:, hi])
                stop = bad
            else:
                r, v_ck, rho_ck = ckpts[:, lo: hi + 1].unbind(2)
                rho_c = s_rho[:, None] - rho_ck + r - 0.5 * (r + p_n[:, None])
                turned = ((rowdot(v_ck, rho_c) <= 0.0)
                          | (rowdot(rho_c, v_n[:, None]) <= 0.0)).any(1)
                s_turn = torch.where(alive, turned, s_turn)
                stop = bad | turned
            cur = pick(alive, leaf, cur)
            s_lsw = torch.where(alive, lsw, s_lsw)
            s_acc = s_acc + torch.where(alive, accept, 0.0)
            s_n = s_n + alive.to(s_n.dtype)
            s_div = s_div | (alive & bad)
            alive = alive & ~stop
        # the sub-tree into the trajectory
        upd = ~done
        valid = upd & ~(s_div | s_turn)
        take = valid & (u[1] < torch.exp(torch.clamp(s_lsw - log_sum_w, max=0.0)))
        prop = pick(take, s_prop, prop)
        logp_prop = torch.where(take, s_logp, logp_prop)
        new_left, new_right = pick(right_way, left, cur), pick(right_way, cur, right)
        new_rho = rho + s_rho
        rho_c = new_rho - 0.5 * (new_left["p"] + new_right["p"])
        turned = _turning(new_left["v"], new_right["v"], rho_c)
        left, right = pick(valid, new_left, left), pick(valid, new_right, right)
        rho = torch.where(valid[:, None], new_rho, rho)
        log_sum_w = torch.where(valid, torch.logaddexp(log_sum_w, s_lsw), log_sum_w)
        sum_accept = sum_accept + torch.where(upd, s_acc, 0.0)
        n_leaves = n_leaves + torch.where(upd, s_n, 0.0)
        diverging = diverging | (upd & s_div)
        done = done | (upd & (s_div | s_turn | turned))
        depth = torch.where(upd, i + 1, depth)
        if bool(done.all()):
            break
    return Result(prop["q"], logp_prop, prop["g"], depth, n_leaves,
                  sum_accept / torch.clamp(n_leaves, min=1.0), diverging)


def swap_sweep(q, lp, grads, inv_temps, u, iteration: int):
    """One even-odd sweep over R ladders of K rungs: q, grads (R, K, dim),
    lp (R, K) untempered, u (R, K); pairs (k, k+1) with k of the sweep's
    parity swap when log u_k < (beta_k - beta_{k+1}) (lp_{k+1} - lp_k)."""
    k = inv_temps.shape[0]
    out_q, out_lp, out_g = q.clone(), lp.clone(), grads.clone()
    for left in range(iteration % 2, k - 1, 2):
        delta = (inv_temps[left] - inv_temps[left + 1]) * (lp[:, left + 1] - lp[:, left])
        swap = torch.log(u[:, left]) < delta
        for a, b in ((left, left + 1), (left + 1, left)):
            out_q[:, a] = torch.where(swap[:, None], q[:, b], q[:, a])
            out_lp[:, a] = torch.where(swap, lp[:, b], lp[:, a])
            out_g[:, a] = torch.where(swap[:, None], grads[:, b], grads[:, a])
    return out_q, out_lp, out_g


def moved_apart(q_prog, q_ref, q_start, share: float = 0.1):
    """Per chain: the program's draw is not the reference's, that is it
    lies farther from the reference's draw than ``share`` of the way the
    reference moved (a draw taken on the other side of a decision is a
    different leaf, a whole leapfrog step or more away; rounding leaves the
    two within 1e-3 of the move)."""
    gap = torch.linalg.vector_norm(q_prog - q_ref, dim=-1)
    move = torch.linalg.vector_norm(q_ref - q_start, dim=-1)
    return (gap > share * move) | ~torch.isfinite(gap)


def as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
