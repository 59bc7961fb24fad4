"""How far a cell's adaptation has settled after a warmup of a given length:

    python3 portbench/settle.py --workload <name> --warmups 250,500,1000 \
        --setup-seeds 101,202,303 [--transitions 100] [--target 0.8] \
        [--out settle.jsonl]

For each warmup length and set-up seed it sets the cell up as a run does,
with that length and seed in place of the traffic mix's (and with
``--target`` in place of the recipe's target acceptance), then drives
``--transitions`` sampling transitions and prints one JSON line: the
adapted step sizes, the batched leaves per transition and the share of
transitions that reached the depth cap, and the mean acceptance statistic
the port reports. A length has settled where these agree across set-up
seeds. The benchmark's own runs never run this; its readings chose each
mix's ``warmup`` (PERF.md).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def one_setup(cell, warmup: int, setup_seed: int, transitions: int, target, device="cuda"):
    import numpy as np
    import torch

    from portbench.core import data, sampler

    cell = copy.copy(cell)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(warmup=warmup, setup_seed=setup_seed)
    if target is not None:
        cell.traffic["recipe"]["target_accept_ratio"] = target
    y, t, _ = data.make(cell.config)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        driver, result = sampler.set_up(cell, y, t, setup_seed, device,
                                        os.path.join(tmp, "ckpt.npz"))
    setup_s = time.perf_counter() - t0
    leaves, accept, depth = [], [], []
    cap = driver.tree.max_depth
    for mult in driver.mults(transitions):
        _, _, stats, _ = driver.advance(mult)
        leaves.append(int(stats.lockstep_leaves))
        accept.append(stats.accept_prob.detach().double().cpu().numpy())
        depth.append(int(stats.tree_depth.max()))
    eps = (driver.eps if hasattr(driver, "eps") else driver.carry.eps).double().cpu().numpy()
    accept = np.stack(accept)
    out = {"workload": cell.name, "warmup": warmup, "setup_seed": setup_seed,
           "target": cell.traffic["recipe"].get("target_accept_ratio"),
           "transitions": transitions, "setup_s": round(setup_s, 2),
           "phase_times_s": {k: round(v, 2) for k, v in
                             result.diagnostics["phase_times_s"].items()},
           "eps_median": float(np.median(eps)), "eps_min": float(eps.min()),
           "eps_max": float(eps.max()),
           "leaves_mean": float(np.mean(leaves)),
           "leaves_quartiles": [float(v) for v in np.percentile(leaves, [25, 50, 75])],
           "share_at_cap": float(np.mean(np.asarray(depth) >= cap)),
           "accept_mean": float(accept.mean())}
    if accept.shape[1] > 1:
        per_chain = accept.mean(0)
        out["accept_chain_range"] = [float(per_chain.min()), float(per_chain.max())]
    del driver, result
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--warmups", required=True)
    parser.add_argument("--setup-seeds", required=True)
    parser.add_argument("--transitions", type=int, default=100)
    parser.add_argument("--target", type=float, default=None)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    import torch

    from portbench.core import spec

    if not torch.cuda.is_available():
        print("portbench settle: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(args.workload, spec.benchmark(ROOT))
    for warmup in (int(w) for w in args.warmups.split(",")):
        for seed in (int(s) for s in args.setup_seeds.split(",")):
            line = json.dumps(one_setup(cell, warmup, seed, args.transitions, args.target))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
