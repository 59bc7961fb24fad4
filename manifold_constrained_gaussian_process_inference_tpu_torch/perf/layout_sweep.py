"""The layout sweep behind ``band_impl="auto"`` on the card: ms per
replayed value-and-grad of the slice's likelihood, band storage (the K1
kernels) against the dense stacks, over grids and chain counts.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.layout_sweep \\
        [--deadline 900] [--out chiprun_out/layout_sweep.jsonl]

Each FN point builds the workload at a filllevel (``fn_bench_workload``),
its whitened, mode-centered likelihood (``slice_likelihood``; the band
escalates from the requested bandsize as ``build_gp_cov`` settles it, or is
held there) and, per chain count C, one ``GraphedValueAndGrad`` per
layout, as ``chip_smoke.py``'s [likelihood] does. The problem points below
n = 199 (the model families' and config 3's grids) build the raw target
that ``solve_magi`` builds for them at their own options. The layouts are timed in turns
(band, dense, band), each turn the median of ``N_CALLS`` CUDA-event
timings of one replay. One JSON line per point, printed and appended to
``--out``; points past the deadline are skipped (and said so). Runs on a
CUDA card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CHAINS = (1, 8, 40, 128)
# where a batch threshold sits: between 8 chains (the row tile's most) and
# 40, where dense was ahead at the wide bands
BATCH_CHAINS = (1, 8, 9, 12, 16, 24, 40, 128)
# (filllevel, requested bandsize, escalate, chain counts): FN at n = 199,
# 397, 793, 1585 and 3169 from MagiConfig's default bandsize of 20,
# escalated as build_gp_cov settles it; n = 1585 held at 40, 80 and 160,
# and n = 199 and 397 held at wide bands (b/n 0.16 to 0.4) from b = 32 to
# 160, where a bandwidth test would sit
POINTS = ((1, 20, True, CHAINS), (2, 20, True, CHAINS), (3, 20, True, CHAINS),
          (4, 20, True, CHAINS), (5, 20, True, CHAINS), (4, 40, False, CHAINS),
          (4, 80, False, CHAINS), (4, 160, False, CHAINS),
          *((1, b, False, BATCH_CHAINS) for b in (32, 48, 64, 80)),
          *((2, b, False, BATCH_CHAINS) for b in (64, 80, 160)))
# solve_magi's own workloads below n = 199, at the band they settle on
# (b = 20 >= n / 2): the model families' (perf.workload.FAMILY_CASES; one
# chain in their runs; n = 12-15, D = 3-5) and config 3's (40 chains, 10
# rungs x 4 replicas; n = 33, D = 3)
PROBLEMS = ("ptrans", "hiv", "hes1log_fixg", "config3")
N_CALLS = 20
TURNS = ("band", "dense", "band")


def replay_ms(fn, x, n_calls: int = N_CALLS) -> float:
    """Median of ``n_calls`` CUDA-event timings of fn(x), after warm-up."""
    for _ in range(3):
        fn(x)
    times = []
    for _ in range(n_calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed_rows(vgs, center, scale, chains, **point):
    """One row per chain count: both layouts' ``vgs`` replayed in turns at
    (C, dim) inputs drawn around ``center``."""
    from ..parallel.chains import GraphedValueAndGrad

    rng = np.random.default_rng(1)
    for c in chains:
        zeta = torch.as_tensor(center + rng.normal(size=(c, center.size)) * scale,
                               dtype=torch.float32, device="cuda")
        graphed = {impl: GraphedValueAndGrad(vg, zeta) for impl, vg in vgs.items()}
        times = {impl: [] for impl in vgs}
        for impl in TURNS:
            times[impl].append(replay_ms(graphed[impl], zeta))
        band, dense = float(np.mean(times["band"])), times["dense"][0]
        yield dict(point, c=c, dim=center.size, band_ms=times["band"], dense_ms=times["dense"],
                   faster="band" if band < dense else "dense", dense_over_band=dense / band,
                   band_launches_per_vg=graphed["band"].kernel_launches,
                   band_tiles_per_vg=graphed["band"].tile_launches)
        del graphed, zeta
        torch.cuda.empty_cache()


def sweep_point(fill: int, bandsize: int, escalate: bool, chains, device_name: str):
    """The rows of one (filllevel, bandsize): one per chain count."""
    from .workload import fn_bench_workload, slice_likelihood

    y, t = fn_bench_workload(fill=fill)
    t0 = time.perf_counter()
    lik = slice_likelihood(y, t, bandsize=bandsize, auto_escalate=escalate)
    setup_s = time.perf_counter() - t0
    vgs = {impl: lik.vg(impl) for impl in ("band", "dense")}
    yield from _timed_rows(vgs, np.zeros(lik.dimension), 0.5, chains, fill=fill, n=len(t),
                           m=y.shape[1], bandsize_requested=bandsize, escalated=escalate,
                           b=lik.cov64.bandsize, setup_s=setup_s, device=device_name)


def problem_targets(name: str):
    """(config, cov64, build(impl[, dtype, device]) -> MagiTarget, psi
    center) of a FAMILY_CASES
    workload or config 3, built as solve_magi builds its target from the
    options' phi and sigma (raw Psi, the untempered target: config 3's
    whitening and tempering scale both layouts alike)."""
    from ..config import MagiConfig
    from ..inference.solve import _init_x_interpolation, resolve_gp_mean
    from ..inference.target import MagiTarget
    from ..inference.transforms import make_theta_transform, unconstrain
    from ..models import HES1LOG_FIXF_SYSTEM
    from ..ops.gp_cov import build_gp_cov
    from .workload import (
        FAMILY_CASES, HES1_CONFIG3, HES1_THETA_TRUE_FIXF, family_problem, hes1_workload,
    )

    if name == "config3":
        system, options, theta = HES1LOG_FIXF_SYSTEM, HES1_CONFIG3, HES1_THETA_TRUE_FIXF
        t, y, _ = hes1_workload()
    else:
        system, y, t, options = family_problem(name)
        theta = np.asarray(FAMILY_CASES[name]["theta"], dtype=np.float64)
    config = MagiConfig(**options)
    cov64 = build_gp_cov(config.kernel, np.asarray(config.phi), t, bandsize=config.band_size,
                         complexity=2, jitter=config.jitter,
                         auto_escalate_bandsize=config.band_auto_escalate)
    tr = None
    if config.theta_constrained:
        tr = make_theta_transform(system.theta_lower_bound, system.theta_upper_bound)
        theta = unconstrain(tr, theta)
    gp_mean = resolve_gp_mean(config.gp_mean, y)

    def build(impl, dtype=torch.float32, device="cuda"):
        return MagiTarget.build(y, cov64.to(dtype=dtype, device=device), system,
                                np.asarray(config.sigma), config.prior_temperature, True,
                                band_impl=impl, theta_transform=tr, gp_mean=gp_mean)

    center = np.concatenate([_init_x_interpolation(y, t).T.reshape(-1), theta])
    return config, cov64, build, center


def problem_point(name: str, chains, device_name: str):
    """The rows of one of PROBLEMS: one per chain count."""
    t0 = time.perf_counter()
    config, cov64, build, center = problem_targets(name)
    setup_s = time.perf_counter() - t0
    vgs = {impl: build(impl).value_and_grad_fn() for impl in ("band", "dense")}
    yield from _timed_rows(vgs, center, 0.01, chains, problem=name, n=cov64.tvec.shape[0],
                           m=cov64.phi.shape[0], bandsize_requested=config.band_size,
                           escalated=config.band_auto_escalate, b=cov64.bandsize,
                           setup_s=setup_s, device=device_name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--deadline", type=float, default=900.0,
                    help="seconds after which the remaining points are skipped")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/layout_sweep.jsonl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("layout_sweep needs a CUDA card")
    import manifold_constrained_gaussian_process_inference_tpu_torch  # noqa: F401  (TF32 off)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    with args.out.open("a") as f:
        points = [(f"filllevel {fill} bandsize {bandsize}",
                   lambda p=(fill, bandsize, escalate, chains): sweep_point(*p, smi))
                  for fill, bandsize, escalate, chains in POINTS]
        points += [(name, lambda name=name: problem_point(name, BATCH_CHAINS, smi))
                   for name in PROBLEMS]
        for label, rows in points:
            if time.perf_counter() - t_start > args.deadline:
                print(f"[skipped] {label}: past the deadline of {args.deadline:.0f} s",
                      flush=True)
                continue
            for row in rows():
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
