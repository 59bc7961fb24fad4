"""Typed configuration for the MAGI solver (PyTorch port).

The same keys and defaults as the JAX package's ``MagiConfig``
(manifold_constrained_gaussian_process_inference_tpu/config.py), plus
``device``: the torch device the sampling hot path runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class MagiError(RuntimeError):
    """An input or a checkpoint the solver refuses (``inference.solve`` and
    ``inference.checkpoint`` raise it)."""


def default_device() -> torch.device:
    """The first CUDA card. The port's entry points run on the card unless
    the caller asks for the CPU (``device="cpu"``); without a card,
    ``solve_magi`` raises rather than fall back to the CPU."""
    return torch.device("cuda")


def default_dtype(device) -> torch.dtype:
    """Working dtype of the sampling hot path: float32 on a CUDA card
    (production), float64 on the CPU (parity and tests). GP covariance
    setup always runs in float64 on the host regardless of this value."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


@dataclasses.dataclass(frozen=True)
class MagiConfig:
    """Solver configuration; see the JAX package's MagiConfig for the
    meaning of every field. ``device`` (None = ``default_device()``) and
    ``dtype`` (None = ``default_dtype(device)``) select where and in which
    precision the sampler runs."""

    kernel: str = "matern52"
    niter_hmc: int = 20000
    burnin_ratio: float = 0.5
    step_size_factor: float = 0.01
    band_size: int = 20
    prior_temperature: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    sigma: Optional[Sequence[float]] = None
    phi: Optional[np.ndarray] = None
    x_init: Optional[np.ndarray] = None
    theta_init: Optional[Sequence[float]] = None
    target_accept_ratio: float = 0.8
    jitter: float = 1e-6
    gp_optim_iterations: int = 100
    gp_optim_ftol: float = 1e-8
    gp_optim_gtol: float = 1e-8
    gp_optim_show_trace: bool = False
    verbose: bool = False

    n_chains: int = 1
    max_tree_depth: int = 10
    seed: int = 0
    sampler: str = "nuts"
    chees_criterion: str = "snaper"
    pt_temps: int = 8
    pt_max_temp: Optional[float] = None
    pt_ladder_adapt: bool = True
    pt_replicas: int = 1
    dtype: Optional[torch.dtype] = None
    mass_matrix: str = "diag"
    # "dense": (D, n, n) stacks; "band": (D, 2b+1, n) band storage through
    # ops/cuda_band.band_matvec; "auto": see inference/solve.py.
    band_impl: str = "auto"
    band_auto_escalate: bool = True
    chunk_size: int = 1000
    chain_init_jitter: float = 0.0
    step_jitter: float = 0.0
    step_jitter_low: float = 0.4
    divergence_envelope: bool = False
    envelope_max_points: int = 4
    profile_dir: Optional[str] = None
    checkpoint_path: Optional[str] = None
    map_init_iterations: int = 0
    map_init_lr: float = 0.01
    theta_constrained: bool = False
    x_whitened: bool = False
    gp_mean: object = None
    device: Optional[str] = None

    def resolved_device(self) -> torch.device:
        return torch.device(self.device) if self.device is not None else default_device()

    def resolved_dtype(self) -> torch.dtype:
        if self.dtype is not None:
            return self.dtype
        return default_dtype(self.resolved_device())

    @property
    def sigma_provided(self) -> bool:
        return self.sigma is not None and len(np.atleast_1d(self.sigma)) > 0

    @property
    def phi_provided(self) -> bool:
        return self.phi is not None and np.asarray(self.phi).size > 0

    @property
    def sigma_is_fixed(self) -> bool:
        """Sigma is fixed iff BOTH sigma and phi are provided."""
        return self.sigma_provided and self.phi_provided
