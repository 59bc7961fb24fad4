"""Checkpoint / resume for long MCMC runs (port of the JAX package's
inference/checkpoint.py).

The sampler state of every chain -- positions, adapted step sizes and
inverse metrics, and the random state -- round-trips through one ``.npz``
file, so a run split across batch jobs or a lost machine continues where it
stopped. The port draws every random number from one ``torch.Generator``
(the JAX package splits per-chain threefry keys), so a checkpoint stores
``generator.get_state()`` and the generator's device type. A resumed run on
the same device type replays the uninterrupted run bit for bit: it also
restores the log-densities and gradients at the saved positions rather than
re-evaluating them, and the host stream of the step-jitter multipliers.

A checkpoint of another device type is refused, and so is a JAX package
checkpoint (its (C, 2) uint32 keys cannot seed a torch generator):
``from_jax_checkpoint`` converts one explicitly, starting the random state
from a given seed.

Protocol:
  result = solve_magi(..., config with checkpoint_path=path)
  solve_magi(..., resume=path)        # or resume=load_checkpoint(path)
  run_chains_resumed(vg, load_checkpoint(path), n_more)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np
import torch

from ..config import MagiError, default_device, default_dtype

# The warmup carry of the pooled dense NUTS path, saved field by field.
WARMUP_CARRY_FIELDS = ("q", "logp", "grad", "log_eps", "log_eps_avg", "h_bar", "mu", "count")
JAX_REFUSAL = (
    "this checkpoint was written by the JAX package (PRNG keys, no torch generator "
    "state); the port does not re-seed it silently. Convert it with "
    "inference.checkpoint.from_jax_checkpoint(ckpt, seed)."
)


@dataclasses.dataclass
class SamplerCheckpoint:
    """Everything needed to continue a run.

    ``phase`` is "sampling" (warmup finished; ``step_size`` and
    ``inv_mass`` are the frozen adapted values) or "warmup" (the run
    stopped during the warmup of the pooled dense NUTS path): ``warmup``
    then holds the iteration index ``pos``, the warmup carry by field name
    (``carry``: WARMUP_CARRY_FIELDS), the pooled metric's three factors,
    the window moments accumulated so far and the warmup divergence flags.
    ``state`` holds named sampler arrays: ``logp`` and ``grad`` at ``psi``
    (a resumed run restores them instead of re-evaluating), the dense
    metric's factors, ChEES's principal component."""

    psi: np.ndarray          # (C, dim) positions
    step_size: np.ndarray    # (C,) adapted step sizes
    inv_mass: np.ndarray     # (C, dim) diagonal, or (dim, dim) dense-pooled
    rng_state: np.ndarray    # uint8, torch.Generator.get_state()
    rng_device: str          # the generator's device type
    n_samples_drawn: int = 0
    meta: Optional[Dict] = None
    phase: str = "sampling"
    warmup: Optional[Dict] = None
    state: Optional[Dict[str, np.ndarray]] = None


def generator_state(generator: torch.Generator):
    """(state bytes as numpy, device type) of a torch generator."""
    return generator.get_state().numpy().copy(), torch.device(generator.device).type


def set_generator_state(generator: torch.Generator, rng_state, rng_device: str) -> None:
    """Put ``generator`` in the saved state; a state saved on another
    device type is refused (CPU and CUDA generators are different
    algorithms)."""
    device_type = torch.device(generator.device).type
    if str(rng_device) != device_type:
        raise MagiError(
            f"checkpoint random state was saved on a {rng_device} generator; this run "
            f"draws on {device_type}. Resume on the device type that wrote it."
        )
    generator.set_state(torch.as_tensor(np.asarray(rng_state, dtype=np.uint8)))


def restore_generator(rng_state, rng_device: str, device) -> torch.Generator:
    """A new generator on ``device`` in the saved state."""
    generator = torch.Generator(device=device)
    set_generator_state(generator, rng_state, rng_device)
    return generator


def check_port_checkpoint(ckpt) -> None:
    """Refuse a checkpoint that carries no torch generator state (one
    written or loaded by the JAX package)."""
    has = "rng_state" in ckpt if isinstance(ckpt, dict) else hasattr(ckpt, "rng_state")
    if not has:
        raise MagiError(JAX_REFUSAL)


def check_warmup_schedule(ckpt: SamplerCheckpoint, n_adapts: int, chunk_size: int) -> None:
    """A warmup checkpoint resumes only under the schedule that wrote it."""
    meta = ckpt.meta or {}
    for key, value in (("n_adapts", n_adapts), ("chunk_size", chunk_size)):
        if int(meta.get(key, -1)) != int(value):
            raise MagiError(
                f"warmup checkpoint was written with {key}={meta.get(key)}; this call has "
                f"{key}={value}. The resumed call must use the arguments of the original run."
            )


def checkpoint_from_result(result) -> SamplerCheckpoint:
    """A sampling-phase checkpoint from a finished NUTS ``MagiResult``:
    the final positions, adapted step sizes and metric and the generator
    state after the last draw (the log-densities are re-evaluated on
    resume)."""
    d = result.diagnostics
    n_chains = int(d["n_chains"])
    lp_pc = np.asarray(d["lp_per_chain"])
    meta = {"n_chains": n_chains}
    if d.get("metric") == "dense-pooled":
        meta["metric"] = "dense-pooled"
    return SamplerCheckpoint(
        psi=np.asarray(d["final_psi"]),
        step_size=np.atleast_1d(np.asarray(d["step_size"])),
        inv_mass=np.atleast_2d(np.asarray(d["inv_mass"])),
        rng_state=np.asarray(d["final_key"], dtype=np.uint8),
        rng_device=torch.device(d["device"]).type,
        n_samples_drawn=n_chains * lp_pc.shape[-1],
        meta=meta,
    )


def save_checkpoint(path: str, ckpt: SamplerCheckpoint) -> None:
    arrays = dict(
        psi=ckpt.psi,
        step_size=ckpt.step_size,
        inv_mass=ckpt.inv_mass,
        rng_state=np.asarray(ckpt.rng_state, dtype=np.uint8),
        rng_device=np.asarray(ckpt.rng_device),
        n_samples_drawn=np.asarray(ckpt.n_samples_drawn),
        meta=np.asarray(json.dumps(ckpt.meta) if ckpt.meta else ""),
        phase=np.asarray(ckpt.phase),
    )
    for name, value in (ckpt.state or {}).items():
        arrays[f"st_{name}"] = np.asarray(value)
    if ckpt.warmup is not None:
        w = ckpt.warmup
        arrays["wu_pos"] = np.asarray(int(w["pos"]))
        for name in WARMUP_CARRY_FIELDS:
            arrays[f"wu_carry_{name}"] = np.asarray(w["carry"][name])
        for name in ("metric_minv", "metric_chol", "metric_pchol", "div"):
            arrays[f"wu_{name}"] = np.asarray(w[name])
        for i, mom in enumerate(w["moments"]):
            for j, part in enumerate(mom):
                arrays[f"wu_mom_{i:03d}_{j}"] = np.asarray(part)
    np.savez(path, **arrays)


def load_checkpoint(path: str) -> SamplerCheckpoint:
    with np.load(path) as z:
        if "rng_state" not in z.files:
            raise MagiError(f"{path}: {JAX_REFUSAL}")
        meta_raw = str(z["meta"])
        phase = str(z["phase"])
        warmup = None
        if phase == "warmup":
            n_moms = len({k[: len("wu_mom_000")] for k in z.files if k.startswith("wu_mom_")})
            warmup = {
                "pos": int(z["wu_pos"]),
                "carry": {name: z[f"wu_carry_{name}"] for name in WARMUP_CARRY_FIELDS},
                "moments": [tuple(z[f"wu_mom_{i:03d}_{j}"] for j in range(5))
                            for i in range(n_moms)],
                **{name: z[f"wu_{name}"]
                   for name in ("metric_minv", "metric_chol", "metric_pchol", "div")},
            }
        state = {k[len("st_"):]: z[k] for k in z.files if k.startswith("st_")}
        return SamplerCheckpoint(
            psi=z["psi"],
            step_size=z["step_size"],
            inv_mass=z["inv_mass"],
            rng_state=z["rng_state"],
            rng_device=str(z["rng_device"]),
            n_samples_drawn=int(z["n_samples_drawn"]),
            meta=json.loads(meta_raw) if meta_raw else None,
            phase=phase,
            warmup=warmup,
            state=state or None,
        )


def from_jax_checkpoint(ckpt, seed: int, device="cpu"):
    """The port's checkpoint from a JAX package sampler checkpoint, loaded
    as numpy: a NUTS or ChEES ``SamplerCheckpoint`` (sampling phase) or a
    parallel-tempering dict. Positions, step sizes, inverse metrics
    (diagonal, shared dense or per-rung dense), the ladder, the swap
    counters and sweep parity, ChEES's trajectory length, its Adam state,
    Halton index and principal component (when the checkpoint has one)
    carry over unchanged. Threefry keys do not: the random state starts
    from ``torch.Generator(device).manual_seed(seed)``."""
    rng_state, rng_device = generator_state(torch.Generator(device=device).manual_seed(int(seed)))
    if isinstance(ckpt, dict):
        out = {k: np.asarray(v) for k, v in ckpt.items() if k != "key"}
        out.update(rng_state=rng_state, rng_device=np.asarray(rng_device))
        return out
    if getattr(ckpt, "phase", "sampling") != "sampling":
        raise MagiError("a JAX warmup-phase checkpoint stores its carry by pytree leaf "
                        "order; only sampling-phase checkpoints convert.")
    meta = dict(ckpt.meta) if ckpt.meta else None
    state = None
    if meta and meta.get("pc") is not None:
        state = {"pc": np.asarray(meta.pop("pc"))}
    return SamplerCheckpoint(
        psi=np.asarray(ckpt.psi), step_size=np.asarray(ckpt.step_size),
        inv_mass=np.asarray(ckpt.inv_mass), rng_state=rng_state, rng_device=rng_device,
        n_samples_drawn=int(ckpt.n_samples_drawn), meta=meta, state=state,
    )


def run_chains_resumed(
    vg,
    ckpt: SamplerCheckpoint,
    n_samples: int,
    max_depth: int = 10,
    dtype=None,
    device=None,
    chunk_size: int = 1000,
    checkpoint_path: Optional[str] = None,
    progress: bool = False,
):
    """Continue NUTS sampling from a sampling-phase checkpoint: no warmup,
    frozen step sizes and metric (per-chain diagonal, or the shared dense
    metric when meta says "dense-pooled"), the saved generator state and
    step-jitter stream. Writes a checkpoint after every chunk when
    ``checkpoint_path`` is set. Returns (samples (C, S, dim), info,
    new_checkpoint)."""
    if ckpt.phase == "warmup":
        raise ValueError(
            "this checkpoint was written mid-warmup; resume it through "
            "solve_magi(resume=...) / run_chains(resume_ckpt=...), which "
            "continue adaptation from the saved state."
        )
    check_port_checkpoint(ckpt)
    from ..parallel.chains import sample_from_checkpoint

    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    return sample_from_checkpoint(vg, ckpt, n_samples, max_depth, dtype, device, chunk_size,
                                  checkpoint_path, progress)
