"""NUTS types and helpers shared by the batched transition (port of the
part of the JAX package's inference/nuts.py that inference/nuts_batched.py
imports). The single-chain ``nuts_transition``/``run_nuts`` path is not
ported yet (ROADMAP M12).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .adapt import DualAveragingState

MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


class DenseMetric(NamedTuple):
    """Full inverse-mass metric: M^-1, chol(M^-1) (lower) and the
    precomputed momentum factor p_chol = chol(M^-1)^-T (upper), so that a
    momentum draw p ~ N(0, M) is p = p_chol @ z, one matmul."""

    minv: torch.Tensor       # (dim, dim)
    chol_minv: torch.Tensor  # (dim, dim) lower
    p_chol: torch.Tensor     # (dim, dim) upper


class NutsStats(NamedTuple):
    """Per-chain statistics of one batched transition, plus two host
    counts of the lockstep loop: ``host_syncs`` (device-to-host reads of
    the done flags) and ``lockstep_leaves`` (batched leapfrog steps run,
    paid by every chain)."""

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
    chain: ChainState
    da: DualAveragingState


class SampleCarry(NamedTuple):
    chain: ChainState
    eps: torch.Tensor


def _popcount32(x: int) -> int:
    """Population count of a non-negative int (the leaf counter is a host
    integer in the port, so the JAX package's branchless SWAR form is
    unnecessary)."""
    return bin(int(x)).count("1")


def _leaf_idx_to_ckpt_idxs(n: int):
    """Checkpoint index range for the U-turn checks at leaf n (iterative
    NUTS): idx_max = popcount(n >> 1), idx_min = idx_max - (trailing ones
    of n) + 1."""
    idx_max = _popcount32(n >> 1)
    n_trail = _popcount32(((n + 1) & -(n + 1)) - 1)
    return idx_max - n_trail + 1, idx_max
