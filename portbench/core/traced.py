"""The readings of a traced run, from which each per-layer metric's reader
(``metrics/<name>.py``) takes its number: the program's spans
(``phase_times_s``) and counters (batched and per-chain leaves), the
window's host clock, the device's busy time from CUDA events around every
graph replay, the value-and-grad's and single kernels' device times from
replayed graphs of many calls at the cell's shapes on the window's last
positions, and the least time of a batched leaf's work (``work.py``).
Device readings are absent on the CPU, and so are the metrics that need
them."""
from __future__ import annotations

import importlib

import torch

from .sampler import PKG, TemperingDriver
from .trace import graph_ms


def _kernel_ms(driver, q, g) -> dict:
    """Device ms of the cell's kernels alone at its shapes: the whitened FN
    kernel on its route and the dense metric's product (K1's launches are
    for a cell on the K1 route to time, with a metric of its own)."""
    out = {}
    if driver.route == "kernel":
        cv = importlib.import_module(f"{PKG}.ops.centered_vg")
        params = cv.make_params(driver.target, driver.whitener.center)
        dpsi = (q @ driver.whitener.W.T).contiguous()
        out["centered_vg"] = graph_ms(lambda: cv.centered_fn_vg(dpsi, params))
    if not isinstance(driver, TemperingDriver) and getattr(driver, "dense", False):
        mm = importlib.import_module(f"{PKG}.ops.minv_mv")
        prep = mm.prepare(driver.metric.minv)
        gc = g.contiguous()
        out["minv_mv"] = graph_ms(lambda: mm.product(prep, gc))
    return out


def shapes(driver, alive: float) -> dict:
    """The cell's shapes, as the metrics' operation and byte counts take
    them: chains, dimension, grid, state dimensions, band, the route of the
    value-and-grad, whether it is whitened, the metric's kind and rungs,
    and the chains alive per batched leaf on average."""
    tgt = driver.target
    tempering = isinstance(driver, TemperingDriver)
    return dict(c=driver.n_chains, dim=driver.dim, n=tgt.n_times, d=tgt.n_dims,
                b=tgt.bandwidth, route=driver.route, whitened=driver.whitener is not None,
                metric="rung" if tempering else ("dense" if driver.dense else "diag"),
                rungs=driver.k if tempering else 1, alive=alive)


def readings(driver, w, result, spans) -> dict:
    d = result.diagnostics
    leaves = sum(w.leaves)
    chain_leaves = float(w.n_leapfrog.sum())
    r = dict(phase_times=dict(d["phase_times_s"]), transitions=w.transitions,
             window_s=w.wall_s, wall_s=w.wall_s, leaves=leaves, chain_leaves=chain_leaves,
             n_chains=driver.n_chains)
    r["shapes"] = shapes(driver, chain_leaves / max(leaves, 1))
    if spans is None:
        return r
    replays = spans.seconds()
    depth_of = {id(g): i for i, g in driver.tree.graphs.items()}
    by_depth = {}
    for graph, sec in replays:
        key = f"doubling graph, depth {depth_of.get(id(graph), '?')}"
        by_depth[key] = by_depth.get(key, 0.0) + sec
    busy = sum(sec for _, sec in replays)
    r.update(busy_s=busy, replays=len(replays))
    q, _, g = (t.contiguous() for t in driver.state())
    vg = getattr(driver.vg, "eager", driver.vg)
    r["vg_ms"] = graph_ms(lambda: vg(q))
    r["kernel_ms"] = _kernel_ms(driver, q, g)
    torch.cuda.synchronize()
    ops = sorted(by_depth.items(), key=lambda kv: -kv[1])[:10]
    r["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                      "idle_gaps": [["host between and around the doubling graphs' replays",
                                     w.wall_s - busy]]}
    return r
