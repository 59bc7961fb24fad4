"""Host-and-card A/B of the sampler: ms per batched leaf and host reads per
transition of the NUTS paths for several checkouts of the repo, in turns,
in one call, so that every checkout runs on the same host and card.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.slice_ab \\
        --trees OLD_CHECKOUT,. [--cells slice,default,pt,envelope,mesh] [--rounds 2] \\
        [--out slice_ab.json]

The cells, each through ``solve_magi`` on the card at a cut of
``CELL_NITER`` iterations:

- slice: ``bench.py``'s production recipe (FN, n = 397, 128 whitened
  chains, pooled dense metric, band kernels);
- default: the library's defaults on the FN example's workload (one chain,
  diag metric, raw Psi);
- pt: config 3 of docs/BENCHMARKS.md (log-Hes1, 10 rungs x 4 replicas),
  its MAP warm start cut to ``PT_MAP_ITERS`` Adam steps;
- envelope: the slice's recipe with ``divergence_envelope=True`` (step
  jitter off; ``ENVELOPE_ADAPTS`` warmup iterations, one window end);
- mesh: the slice's recipe over ``MESH_RANKS`` gloo ranks sharing the card
  (``solve_magi(mesh=...)``); rank 0's readings, and every rank's ms per
  leaf.

Each turn is a fresh process started in the checkout's root, which imports
that checkout's package (and builds its kernels there); for every cell the
turns go A B ... B A, round after round. A turn reports its ms per batched
leaf (warmup and sampling wall over batched leaves; and without the
seconds its NUTS trees spent capturing CUDA graphs), batched leaves and
host reads per transition (all of them, and the trees' own where the
checkout counts them apart), a digest of its draws (theta, the sampled x,
sigma, the log-densities: rank 0's gathered result in the mesh cell) and
the card's name and power limit; each cell's line ends with whether every
checkout's turns gave the same draws. Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

RECIPE = dict(
    burnin_ratio=0.5, step_size_factor=0.06, prior_temperature=(1.0, 1.0, 1.0),
    sampler="nuts", n_chains=128, mass_matrix="dense-pooled", chain_init_jitter=0.05,
    x_whitened=True, theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125,
    seed=42, chunk_size=250, band_impl="band", device="cuda",
)
# examples/fn_example.py's settings at the library's defaults
DEFAULT = dict(burnin_ratio=0.5, step_size_factor=0.06, target_accept_ratio=0.8, jitter=1e-6,
               prior_temperature=(1.0, 1.0, 5.0), seed=12345, band_impl="band", device="cuda")
CELL_NITER = {"slice": 200, "default": 200, "pt": 100, "envelope": 225, "mesh": 100}
PT_MAP_ITERS = 300
ENVELOPE_ADAPTS = 200
MESH_RANKS = 4
CELLS = tuple(CELL_NITER)


def _readings(d) -> dict:
    pt = d["phase_times_s"]
    capture = d.get("graph_capture_s", 0.0)  # a checkout before the graphed tree has none
    nuts_s = pt["warmup_s"] + pt["sampling_s"]
    return dict(ms_per_leaf=1e3 * nuts_s / d["lockstep_leaves"],
                ms_per_leaf_after_capture=1e3 * (nuts_s - capture) / d["lockstep_leaves"],
                graph_capture_s=capture,
                leaves_per_transition=d["lockstep_leaves"] / d["transitions"],
                host_reads_per_transition=d["host_syncs"] / d["transitions"],
                tree_reads_per_transition=(d["tree_reads"] / d["transitions"]
                                           if "tree_reads" in d else None),
                doublings_per_transition=(d["doublings"] / d["transitions"]
                                          if "doublings" in d else None),
                sampling_s=pt["sampling_s"], warmup_s=pt["warmup_s"])


def _problem(cell: str):
    """(system, y, t, MagiConfig) of a cell."""
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf import workload as w

    n = CELL_NITER[cell]
    if cell == "default":
        y, t = w.fn_bench_workload(seed=DEFAULT["seed"])
        return mt.FN_SYSTEM, y, t, mt.MagiConfig(niter_hmc=n, **DEFAULT)
    if cell == "pt":
        from manifold_constrained_gaussian_process_inference_tpu_torch.models import (
            HES1LOG_FIXF_SYSTEM,
        )

        t, y, _ = w.hes1_workload()
        return HES1LOG_FIXF_SYSTEM, y, t, mt.MagiConfig(**{
            **w.HES1_CONFIG3, "niter_hmc": n, "seed": 0, "map_init_iterations": PT_MAP_ITERS},
            band_impl="band", device="cuda")
    y, t = w.fn_bench_workload()
    if cell == "envelope":
        return mt.FN_SYSTEM, y, t, mt.MagiConfig(**{
            **RECIPE, "niter_hmc": n, "burnin_ratio": (ENVELOPE_ADAPTS + 0.5) / n,
            "step_jitter": 0.0, "chunk_size": 25}, divergence_envelope=True)
    return mt.FN_SYSTEM, y, t, mt.MagiConfig(niter_hmc=n, **RECIPE)


def _draws_digest(res) -> str:
    """sha256 of a result's draws, to tell whether two turns sampled alike."""
    import numpy as np

    h = hashlib.sha256()
    for a in (res.theta, res.x_sampled, res.sigma, res.lp):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _mesh_rank(rank: int) -> dict:
    """One rank of the mesh cell."""
    import torch.distributed as dist

    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        make_chain_mesh,
    )

    system, y, t, config = _problem("mesh")
    mesh = make_chain_mesh(device="cuda")
    dist.barrier()
    res = mt.solve_magi(y, t, system, config, mesh=mesh)
    return dict(_readings(res.diagnostics), draws=_draws_digest(res))


def _turn(cell: str) -> dict:
    """One run of a cell with the package of the working directory."""
    sys.path.insert(0, os.getcwd())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    if cell == "mesh":
        from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.dryrun import (
            run_ranks,
        )

        ranks = run_ranks(_mesh_rank, MESH_RANKS,
                          threads=max(1, (os.cpu_count() or MESH_RANKS) // MESH_RANKS))
        return dict(ranks[0], rank_ms_per_leaf=[r["ms_per_leaf"] for r in ranks],
                    card=smi.strip())
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt

    system, y, t, config = _problem(cell)
    res = mt.solve_magi(y, t, system, config)
    return dict(_readings(res.diagnostics), draws=_draws_digest(res), card=smi.strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".", help="comma-separated checkout roots")
    ap.add_argument("--cells", default="slice", help=f"comma-separated, of {','.join(CELLS)}")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn(args.turn)), flush=True)
        return 0
    trees = [os.path.abspath(p) for p in args.trees.split(",")]
    cells = args.cells.split(",")
    unknown = set(cells) - set(CELLS)
    if unknown:
        raise SystemExit(f"unknown cells {sorted(unknown)}; known: {CELLS}")
    runs = []
    for r in range(args.rounds):
        for cell in cells:
            for tree in trees if r % 2 == 0 else trees[::-1]:
                out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", cell],
                                     cwd=tree, stdout=subprocess.PIPE, text=True,
                                     check=True).stdout
                runs.append(dict(cell=cell, tree=tree, **json.loads(out.strip().splitlines()[-1])))
                print(json.dumps(runs[-1]), flush=True)
    for cell in cells:
        draws = {r["draws"] for r in runs if r["cell"] == cell}
        print(json.dumps(dict(cell=cell, same_draws=len(draws) == 1, draws=sorted(draws))),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
