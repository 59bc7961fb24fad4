"""Shared helpers of the benchmark's tests: a cell of BENCHMARK.json, or
one of the two cells PERF.md keeps under Open questions (whose mixes and
configuration stay in ``portbench/``, unproved, so that the harness's
tempering and raw-target paths stay tested), cut to a size the CPU runs in
seconds (a grid of 21 points, 4 chains or 3 rungs x 2 replicas, a short
warmup, trees of depth 6 at most)."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# The cells under Open questions: their entries, and the limits their tiny
# runs are held to (fn-fill2.nuts128's, less accept_shortfall where the tiny
# ladder's short warmup leaves its hot rungs far below the target).
UNPROVED = {
    "hes1log.pt40": {"config": "hes1log-h-unobserved", "traffic": "pt40",
                     "limits": {"lp_gap": 0.3, "grad_gap": 0.01, "step_mismatch": 0.1,
                                "band_gap": 0}},
    "fn-fill2.default1": {"config": "fn-fill2", "traffic": "default1",
                          "limits": {"lp_gap": 0.3, "step_mismatch": 0.1, "band_gap": 0,
                                     "nlml_gap": 1e-8, "accept_shortfall": 0.03}},
}


TINY_ACCEPT_SHORTFALL = 0.1


def bench_with_unproved() -> dict:
    from portbench.core import spec

    bench = copy.deepcopy(spec.benchmark(ROOT))
    names = {c["name"] for c in bench["configs"]}
    for name, u in UNPROVED.items():
        bench["workloads"].append({"name": name, "config": u["config"],
                                   "traffic": u["traffic"], "chips": 1, "why": "unproved"})
        if u["config"] not in names:
            names.add(u["config"])
            bench["configs"].append({"name": u["config"],
                                     "file": f"portbench/configs/{u['config']}.json"})
    return bench


def tiny_cell(name: str):
    from portbench.core import spec

    limits = UNPROVED[name]["limits"] if name in UNPROVED else None
    cell = spec.Cell(name, bench_with_unproved(), limits=limits)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if cfg["data"]["generator"] == "fn_grid":
        cfg["data"].update(n_obs=21, fill=0)
    tr["warmup"] = 100
    rec = tr["recipe"]
    if rec.get("n_chains", 1) > 1:
        rec["n_chains"] = 4
    if rec.get("sampler") == "pt-nuts":
        rec.update(pt_temps=3, pt_replicas=2, map_init_iterations=50)
    rec["max_tree_depth"] = 6
    tr["warm_transitions"], tr["chunk"] = 1, 5
    tr["checked_transitions"] = min(tr["checked_transitions"], 3)
    cell.config, cell.traffic = cfg, tr
    if "accept_shortfall" in cell.limits:
        # a tiny run re-runs a dozen chain-transitions after a 100-iteration
        # warmup: their mean acceptance spreads by a few hundredths
        cell.limits = {**cell.limits, "accept_shortfall": TINY_ACCEPT_SHORTFALL}
    return cell
