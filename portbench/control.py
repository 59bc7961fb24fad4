"""The check's control and faults on the chip, at a cell's own size:

    python3 portbench/control.py --workload <name> --seeds 11,12,13 --seconds 5 \
        [--faults unchanged,half,altered] [--target 0.8] [--out control.jsonl]

For each seed it sets the cell up as a run does, drives a short window and
prints the numbers the check compares (``core/judge.py``) three ways: of
the program's draws; of the control, the reference in float32 with TF32
products (and its GP smoothing in float32) put in the program's place on
the same positions, starts and random numbers; and of each fault planted in
the port's tree (``core/faults.py``) over a further short window. Each
comes with its verdict by the cell's limits (``judge.verdict``, as a run
decides ``correct``). With ``--target`` set-up adapts to that target
acceptance in place of the recipe's, the fault ``accept_shortfall`` is
there to catch, and the program's readings are that fault's (the control
is not read). The benchmark's own runs never run this; its readings set
the limits of ``cells/<workload>.json``.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


FITS = {}  # the reference's phi of each cell, worked out once a process


def _readings(cell, y, t, driver, w, result, device, control=False):
    """The check's numbers and, by the cell's limits, their verdict."""
    from portbench.core import judge

    if cell.name not in FITS:
        FITS[cell.name] = judge.fit(cell, y, t)
    numbers = judge.check(cell, y, t, judge.capture(driver, w, result), device, control,
                          FITS[cell.name])
    return {**numbers, "verdict": judge.verdict(numbers, cell.limits)}


def one_seed(cell, seed: int, seconds: float, faults, device="cuda", target=None) -> dict:
    import numpy as np
    import torch

    from portbench.core import data, faults as fault_mod, sampler, window

    recipe_cell = cell
    if target is not None:
        cell = copy.copy(cell)
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.traffic["recipe"]["target_accept_ratio"] = target
    y, t, _ = data.make(cell.config)
    with tempfile.TemporaryDirectory() as tmp:
        driver, result = sampler.set_up(cell, y, t, seed, device, os.path.join(tmp, "ckpt.npz"))
    traffic = cell.traffic
    rng = np.random.default_rng([seed, 1])
    run = lambda: window.run(driver, seconds, int(traffic["chunk"]),  # noqa: E731
                             int(traffic["checked_transitions"]), rng)
    w = run()
    out = {"seed": seed, "transitions": w.transitions}
    if target is not None:
        # judged against the recipe's target, as a run judges it
        out[f"target_{target}"] = _readings(recipe_cell, y, t, driver, w, result, device)
        faults = ()
    else:
        out["program"] = _readings(cell, y, t, driver, w, result, device)
        out["control"] = _readings(cell, y, t, driver, w, result, device, control=True)
    for kind in faults:
        with fault_mod.planted(kind):
            wf = run()
        out[kind] = _readings(cell, y, t, driver, wf, result, device)
    del driver, result
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--target", type=float, default=None)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    import torch

    from portbench.core import spec

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(args.workload, spec.benchmark(ROOT))
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, **one_seed(cell, seed, args.seconds,
                                                                 faults, target=args.target)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
