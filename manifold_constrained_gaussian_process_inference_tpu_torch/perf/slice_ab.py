"""Host-and-card A/B of the sampler: ms per batched leaf of [slice]'s recipe
(``bench.py``'s FN workload, n = 397, 128 whitened chains, pooled dense
metric, band kernels) for several checkouts of the repo, in turns, in one
call, so that every checkout runs on the same host and card.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.slice_ab \\
        --trees OLD_CHECKOUT,. [--niter 100] [--rounds 2] [--out slice_ab.json]

Each turn is a fresh process started in the checkout's root, which imports
that checkout's package (and builds its kernel there) and runs
``solve_magi`` on the card; turns go A B ... B A for each round. A turn
reports its ms per batched leaf (warmup and sampling wall over batched
leaves), batched leaves per transition and the card's name and power limit.
Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
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


def _turn(niter: int) -> dict:
    """One run of the recipe with the package of the working directory."""
    sys.path.insert(0, os.getcwd())
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.perf.workload import (
        fn_bench_workload,
    )

    y, t = fn_bench_workload()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, mt.MagiConfig(niter_hmc=niter, **RECIPE))
    d = res.diagnostics
    pt = d["phase_times_s"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    return dict(ms_per_leaf=1e3 * (pt["warmup_s"] + pt["sampling_s"]) / d["lockstep_leaves"],
                leaves_per_transition=d["lockstep_leaves"] / d["transitions"],
                sampling_s=pt["sampling_s"], warmup_s=pt["warmup_s"], card=smi.strip())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".", help="comma-separated checkout roots")
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn(args.niter)), flush=True)
        return 0
    trees = [os.path.abspath(p) for p in args.trees.split(",")]
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", "--niter",
                              str(args.niter)], cwd=tree, stdout=subprocess.PIPE, text=True,
                             check=True).stdout
        runs.append(dict(tree=tree, **json.loads(out.strip().splitlines()[-1])))
        print(json.dumps(runs[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
