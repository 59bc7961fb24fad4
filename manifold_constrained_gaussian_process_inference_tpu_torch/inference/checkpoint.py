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

A file is written whole or not at all: into a temporary file beside it,
then renamed over it, so a run killed mid-write leaves the previous
checkpoint. Under a mesh rank 0 alone writes it (parallel/chains.py).

Protocol:
  result = solve_magi(..., config with checkpoint_path=path)
  solve_magi(..., resume=path)        # or resume=load_checkpoint(path)
  run_chains_resumed(vg, load_checkpoint(path), n_more)
"""
from __future__ import annotations

import dataclasses
import json
import os
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
    the window moments accumulated so far, the warmup divergence flags and
    the curvature envelope's probes (``envelope``: points and precisions,
    or None), so a resumed warmup folds the same precisions.
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


def savez_atomic(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)`` (the same file name: ``.npz`` added when
    missing), written to a temporary file of this process and renamed over
    ``path``: a reader never sees a partial file."""
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = f"{final}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)


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
        env = w.get("envelope")
        if env is not None:  # the JAX package's keys
            for i, (pt, pr) in enumerate(zip(env["points"], env["precs"])):
                arrays[f"wu_env_pt_{i:03d}"] = np.asarray(pt)
                arrays[f"wu_env_prec_{i:03d}"] = np.asarray(pr)
    savez_atomic(path, arrays)


def load_checkpoint(path: str) -> SamplerCheckpoint:
    with np.load(path) as z:
        if "rng_state" not in z.files:
            raise MagiError(f"{path}: {JAX_REFUSAL}")
        meta_raw = str(z["meta"])
        phase = str(z["phase"])
        warmup = None
        if phase == "warmup":
            n_moms = len({k[: len("wu_mom_000")] for k in z.files if k.startswith("wu_mom_")})
            env_pts = sorted(k for k in z.files if k.startswith("wu_env_pt_"))
            warmup = {
                "pos": int(z["wu_pos"]),
                "carry": {name: z[f"wu_carry_{name}"] for name in WARMUP_CARRY_FIELDS},
                "moments": [tuple(z[f"wu_mom_{i:03d}_{j}"] for j in range(5))
                            for i in range(n_moms)],
                **{name: z[f"wu_{name}"]
                   for name in ("metric_minv", "metric_chol", "metric_pchol", "div")},
                "envelope": ({"points": [z[k] for k in env_pts],
                              "precs": [z[k.replace("_pt_", "_prec_")] for k in env_pts]}
                             if env_pts else None),
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


# The leaves of the JAX package's pooled WarmupCarry in pytree order:
# chain (q, logp, grad, key), dual averaging (5), Welford (count, mean, m2),
# inv_mass. The port keeps the chain and dual-averaging fields.
JAX_WARMUP_LEAVES = ("q", "logp", "grad", None, "log_eps", "log_eps_avg", "h_bar", "mu",
                     "count", None, None, None, None)


def _from_jax_warmup(w: dict) -> dict:
    """A JAX warmup-phase ``warmup`` dict in the port's layout: the carry
    by field name instead of by leaf, the rest (metric factors, moments,
    divergence flags, the envelope's probes) as it is."""
    if w is None:
        raise MagiError("this JAX warmup-phase checkpoint holds no warmup state to convert.")
    leaves = w["carry_leaves"]
    if len(leaves) != len(JAX_WARMUP_LEAVES):
        raise MagiError(f"a JAX warmup checkpoint has {len(JAX_WARMUP_LEAVES)} carry leaves; "
                        f"this one has {len(leaves)}.")
    carry = {name: np.asarray(leaf) for name, leaf in zip(JAX_WARMUP_LEAVES, leaves) if name}
    env = w.get("envelope")
    return {
        "pos": int(w["pos"]), "carry": carry,
        **{name: np.asarray(w[name]) for name in ("metric_minv", "metric_chol", "metric_pchol",
                                                  "div")},
        "moments": [tuple(np.asarray(p) for p in m) for m in w["moments"]],
        "envelope": None if env is None else {
            "points": [np.asarray(p) for p in env["points"]],
            "precs": [np.asarray(p) for p in env["precs"]]},
    }


def from_jax_checkpoint(ckpt, seed: int, device="cpu"):
    """The port's checkpoint from a JAX package sampler checkpoint, loaded
    as numpy: a NUTS or ChEES ``SamplerCheckpoint`` (sampling or warmup
    phase) or a parallel-tempering dict. Positions, step sizes, inverse
    metrics (diagonal, shared dense or per-rung dense), the ladder, the
    swap counters and sweep parity, ChEES's trajectory length, its Adam
    state, Halton index and principal component (when the checkpoint has
    one) carry over unchanged, and so does a pooled warmup's state: its
    carry (mapped from pytree leaves to field names), metric, window
    moments, divergence flags and envelope probes. Threefry keys do not:
    the random state starts from ``torch.Generator(device).manual_seed(seed)``."""
    rng_state, rng_device = generator_state(torch.Generator(device=device).manual_seed(int(seed)))
    if isinstance(ckpt, dict):
        out = {k: np.asarray(v) for k, v in ckpt.items() if k != "key"}
        out.update(rng_state=rng_state, rng_device=np.asarray(rng_device))
        return out
    phase = getattr(ckpt, "phase", "sampling")
    meta = dict(ckpt.meta) if ckpt.meta else None
    state = None
    if meta and meta.get("pc") is not None:
        state = {"pc": np.asarray(meta.pop("pc"))}
    return SamplerCheckpoint(
        psi=np.asarray(ckpt.psi), step_size=np.asarray(ckpt.step_size),
        inv_mass=np.asarray(ckpt.inv_mass), rng_state=rng_state, rng_device=rng_device,
        n_samples_drawn=int(ckpt.n_samples_drawn), meta=meta, state=state, phase=phase,
        warmup=_from_jax_warmup(ckpt.warmup) if phase == "warmup" else None,
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
