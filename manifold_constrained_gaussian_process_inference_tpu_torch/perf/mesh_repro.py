"""Where two runs of the [mesh] cell first part: a digest of every stage of
a sharded ``solve_magi`` on each rank, over several 4-rank worlds, each
world a fresh spawn on the card.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.mesh_repro \\
        [--variants kernel:4,autograd:2] [--concurrent 1] [--stress 8] \\
        [--out mesh_repro.json]

The cell (``_problem``) is the [slice] recipe, ``bench.py``'s production
recipe (FN, n = 397, 128 whitened chains, pooled dense metric), sharded
over MESH_RANKS ranks, 32 chains a rank, 100 iterations. On every rank the run records, in order:
the whitener as the rank received it (its host copy read once before and
once after a device synchronize), the kernel route's constants, the
value-and-grad at a fixed zeta (three eager calls), each NUTS doubling
graph's shape at its capture and every tree state buffer after each of
the first TREE_REPLAYS replays, the chain positions after every warmup
and sampling transition, the window moments before and after their sum
over the ranks, every metric the ranks take from rank 0, and the draws.

Each variant (``VARIANTS``) runs its count of worlds, ``--concurrent``
worlds at a time (each a process of its own spawning four ranks, so that
more processes share the card and a race shows): the kernel route as it
ships ("kernel"); the autograd route, which the port ran before it; the
kernel's plain version on the card in its place; the eager NUTS tree;
two edited builds of the kernel (``SOURCE_EDITS``: shared memory zeroed
before use, band coefficients by plain loads instead of ``__ldg``); the
kernel's outputs cloned; both the kernel and its plain version run, with
the plain version's outputs used ("kernel_discarded") or the kernel's
("plain_discarded"); and "kernel_traced", which appends float64 sums of
zeta, dpsi, lp, g_psi and g of every value-and-grad call to a device
buffer (so that the calls the graphs replay are traced too). The report
gives, per variant and rank, the first stage at which the worlds' digests
differ, or none. ``--stress N`` first runs ``stress``, the kernel route's
GEMM-kernel-GEMM chain alone, in N processes at once. Runs on a CUDA card
only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..ops import centered_vg
from ..parallel import chains
from ..inference import solve

MESH_RANKS = 4
MESH_NITER = 100
RECIPE = dict(
    burnin_ratio=0.5, step_size_factor=0.06, prior_temperature=(1.0, 1.0, 1.0),
    sampler="nuts", n_chains=128, mass_matrix="dense-pooled", chain_init_jitter=0.05,
    x_whitened=True, theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125,
    seed=42, chunk_size=250, band_impl="band", device="cuda",
)
TREE_REPLAYS = 40
VARIANTS = ("kernel", "autograd", "plain_on_card", "eager_tree", "kernel_smem_zeroed",
            "kernel_no_ldg", "kernel_clone_outputs", "kernel_discarded", "plain_discarded",
            "kernel_traced")
# "kernel_traced": per value-and-grad call, on the device (captured with the
# graphs): float64 sums of zeta, dpsi, the kernel's lp and g_psi, and g
TRACE_ROWS = 80000
# the kernel's source edited for a variant: (text, replacement)
SOURCE_EDITS = {
    "kernel_smem_zeroed": ("  T* H = X + 3 * nd;\n",
                           "  T* H = X + 3 * nd;\n"
                           "  for (int o = threadIdx.x; o < (kSums + kParams + kWarps * 7) + "
                           "static_cast<int>(sizeof(T)) * n; o += kThreads)\n"
                           "    reinterpret_cast<double*>(smem_raw)[o] = 0.0;\n"
                           "  __syncthreads();\n"),
    "kernel_no_ldg": ("__ldg(diag[j] + at)", "diag[j][at]"),
}


def variant_source(variant: str) -> Path:
    """The kernel's source with ``SOURCE_EDITS[variant]``, under build/."""
    from ..ops import cuda_band

    old, new = SOURCE_EDITS[variant]
    text = centered_vg.SOURCE.read_text()
    if old not in text:
        raise SystemExit(f"{variant}: {old!r} not in {centered_vg.SOURCE}")
    path = cuda_band.BUILD_DIR / "variants" / f"centered_vg_{variant}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(old, new))
    return path


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _instrument(log: list, variant: str) -> None:
    """Patch the stages of solve_magi's pooled NUTS path to append
    (stage, digest) to ``log``, and set up ``variant``."""
    if variant == "autograd":
        centered_vg.takes = lambda target: False
    elif variant == "plain_on_card":
        centered_vg.centered_fn_vg = centered_vg.centered_fn_vg_torch
    elif variant == "eager_tree":
        from ..inference import nuts_batched

        nuts_batched.tree_graphed = lambda device, vg_b: False
    elif variant in ("kernel_clone_outputs", "kernel_discarded", "plain_discarded"):
        kernel, plain = centered_vg.centered_fn_vg, centered_vg.centered_fn_vg_torch

        def vg(dpsi, p):
            if variant == "kernel_clone_outputs":
                return tuple(t.clone() for t in kernel(dpsi, p))
            both = (kernel(dpsi, p), plain(dpsi, p))
            return both[1] if variant == "kernel_discarded" else both[0]

        centered_vg.centered_fn_vg = vg
    elif variant == "kernel_traced":
        _trace_vg(log)
    elif variant in SOURCE_EDITS:
        centered_vg._LIB = centered_vg.load(variant_source(variant))

    make_vg = solve.make_centered_whitened_vg

    def make_centered_whitened_vg(target, whitener):
        log.append(("center_host", _digest(whitener.center)))
        if whitener.center.is_cuda:
            torch.cuda.synchronize()
        log.append(("center_host_synced", _digest(whitener.center)))
        log.append(("whitener", _digest(*whitener)))
        vg = make_vg(target, whitener)
        zeta = np.random.default_rng(7).standard_normal((32, whitener.W.shape[0])) * 0.1
        zeta = torch.as_tensor(zeta, dtype=whitener.W.dtype, device=whitener.W.device)
        for i in range(3):
            log.append((f"vg_fixed_zeta_{i}", _digest(*vg(zeta))))
        return vg

    solve.make_centered_whitened_vg = make_centered_whitened_vg

    params = centered_vg.make_params

    def make_params(target, center):
        p = params(target, center)
        log.append(("kernel_constants", _digest(p.bands, p.fields, p.scalars)))
        return p

    centered_vg.make_params = make_params

    def stepper(make, name):
        def wrapped(*args, **kwargs):
            step = make(*args, **kwargs)
            count = [0]

            def run(carry, *a, **k):
                out = step(carry, *a, **k)
                c = out[0]
                q = c.chain.q if hasattr(c, "chain") else c.q
                log.append((f"{name}_{count[0]}", _digest(q)))
                count[0] += 1
                return out

            return run

        return wrapped

    chains.make_warmup_step_pooled_batched = stepper(chains.make_warmup_step_pooled_batched,
                                                     "warmup")
    chains.make_sample_step_batched = stepper(chains.make_sample_step_batched, "sample")

    psum = chains._psum_moments
    calls = [0]

    def psum_moments(mesh, moments):
        log.append((f"moments_local_{calls[0]}", _digest(*moments)))
        out = psum(mesh, moments)
        log.append((f"moments_summed_{calls[0]}", _digest(*out)))
        calls[0] += 1
        return out

    chains._psum_moments = psum_moments

    # the NUTS tree's doublings on the card: each captured graph's shape, and
    # after each of the first TREE_REPLAYS replays every state buffer
    from ..inference import nuts_batched

    capture, replay = nuts_batched.LockstepTree._capture, nuts_batched.LockstepTree._replay
    replays = [0]

    def traced_capture(self, metric, i):
        graph = capture(self, metric, i)
        info = self.graph_info[i]
        log.append((f"capture_{i}", [info["nodes"], info["body_nodes"], info["captured_leaves"],
                                     self.per_leaf]))
        return graph

    def traced_replay(self, metric, i):
        out = replay(self, metric, i)
        if replays[0] < TREE_REPLAYS:
            bufs = sorted((k, v) for k, v in vars(self.st).items() if isinstance(v, torch.Tensor))
            log.append((f"replay_{replays[0]}_depth_{i}", [list(out)] + [
                [k, _digest(v)] for k, v in bufs]))
        replays[0] += 1
        return out

    nuts_batched.LockstepTree._capture = traced_capture
    nuts_batched.LockstepTree._replay = traced_replay

    bcast = chains.broadcast_tensors
    metrics = [0]

    def broadcast_tensors(mesh, tensors):
        out = bcast(mesh, tensors)
        log.append((f"metric_{metrics[0]}", _digest(*out)))
        metrics[0] += 1
        return out

    chains.broadcast_tensors = broadcast_tensors


def _trace_vg(log: list) -> None:
    """Every value-and-grad call of the kernel route appends a row of float64
    sums [zeta, dpsi, lp, g_psi, g] to a device buffer (so that the calls
    the CUDA graphs replay append too); ``log`` gets the rows at the end
    (``_rank``)."""
    from ..inference import whiten

    state = {}
    kernel = centered_vg.centered_fn_vg

    def fn_vg(dpsi, p):
        lp, g_psi = kernel(dpsi, p)
        state["mid"] = [dpsi, lp, g_psi]
        return lp, g_psi

    centered_vg.centered_fn_vg = fn_vg
    make = whiten.make_centered_whitened_vg_kernel

    def make_traced(target, whitener):
        vg = make(target, whitener)
        dev = whitener.W.device
        rows = torch.zeros((TRACE_ROWS, 5), dtype=torch.float64, device=dev)
        pos = torch.zeros(1, dtype=torch.int64, device=dev)
        state["trace"] = (rows, pos)

        def traced(zeta):
            lp, g = vg(zeta)
            parts = [zeta, *state.pop("mid"), g]
            row = torch.stack([t.double().sum() for t in parts])
            rows.index_copy_(0, pos.clamp(max=TRACE_ROWS - 1), row[None])
            pos.add_(1)
            return lp, g

        traced.route = vg.route
        return traced

    whiten.make_centered_whitened_vg_kernel = make_traced
    _TRACE.append(state)


_TRACE = []


def _rank(rank: int, variant: str) -> list:
    import torch.distributed as dist

    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel import (
        make_chain_mesh,
    )

    log = []
    _instrument(log, variant)
    system, y, t, config = _problem()
    mesh = make_chain_mesh(device="cuda")
    dist.barrier()
    res = mt.solve_magi(y, t, system, config, mesh=mesh)
    if _TRACE and "trace" in _TRACE[0]:
        rows, pos = _TRACE[0]["trace"]
        n = min(int(pos.item()), TRACE_ROWS)
        log.append(("vg_trace", rows[:n].cpu().numpy().view(np.int64).tolist()))
    log.append(("route", res.diagnostics["vg_route"]))
    log.append(("draws", _digest(res.theta, res.x_sampled, res.sigma, res.lp)))
    return log


def _problem():
    """(system, y, t, MagiConfig) of the cell."""
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt

    from . import workload

    y, t = workload.fn_bench_workload()
    return mt.FN_SYSTEM, y, t, mt.MagiConfig(niter_hmc=MESH_NITER, **RECIPE)


def _first_parting(worlds: list) -> list:
    """Per rank: the first stage whose digests differ between the worlds,
    with the digests, or None."""
    out = []
    for r in range(MESH_RANKS):
        logs = [w[r] for w in worlds]
        first = None
        for i, entry in enumerate(logs[0]):
            vals = [log[i] if i < len(log) else None for log in logs]
            if len({json.dumps(v) for v in vals}) > 1:
                first = dict(index=i, stages=vals)
                break
        out.append(first)
    return out


STRESS_CALLS, STRESS_REPLAYS, STRESS_MODES = 50, 20, ("eager", "graph", "while")


def stress(mode: str, seed: int = 1) -> dict:
    """One process: the kernel route's value-and-grad at a [mesh] rank's
    batch (32 chains of [slice]'s target, float32), dpsi = zeta W^T, the
    kernel, g = g_psi W, run STRESS_CALLS times per round for
    STRESS_REPLAYS rounds, every output held bit for bit to the first
    call's: ``mode`` "eager" (stream launches), "graph" (one CUDA graph of
    the calls, replayed) or "while" (the calls as the iterations of a WHILE
    node's body, ops/graph_if, as the NUTS tree runs its leaves). Returns
    the calls whose dpsi, lp, g_psi or g differed."""
    from ..ops import graph_if
    from .workload import fn_bench_workload, slice_likelihood

    y, t = fn_bench_workload()
    lik = slice_likelihood(y, t, 40)
    put = dict(dtype=torch.float32, device="cuda")
    wh = type(lik.whitener)(*(a.to(**put) for a in lik.whitener))
    params = centered_vg.make_params(lik.target(lik.cov64.to(**put), "band"), wh.center)
    w, w_t = wh.W, wh.W.T
    z = torch.as_tensor(np.random.default_rng(seed).normal(size=(32, lik.dimension)) * 0.5,
                        **put)

    def chain():
        dpsi = z @ w_t
        lp, g_psi = centered_vg.centered_fn_vg_cuda(dpsi, params)
        return dpsi, lp, g_psi, g_psi @ w

    ref = [a.clone() for a in chain()]
    torch.cuda.synchronize()
    rows = 1 if mode == "while" else STRESS_CALLS
    bufs = [torch.empty((rows, *a.shape), **put) for a in ref]
    sums = [torch.zeros_like(a) for a in ref]  # "while": every iteration's outputs summed

    def call(i):
        for b, s, a in zip(bufs, sums, chain()):
            b[i].copy_(a)
            s.add_(a)

    if mode == "eager":
        def run():
            for i in range(STRESS_CALLS):
                call(i)
    else:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if mode == "graph":
            with torch.cuda.graph(graph):
                for i in range(STRESS_CALLS):
                    call(i)
        else:
            counter = torch.zeros(1, dtype=torch.int32, device="cuda")
            limit = torch.full((1,), STRESS_CALLS, dtype=torch.int32, device="cuda")
            loops = graph_if.WhileNodes("cuda")
            with torch.cuda.graph(graph):
                counter.zero_()
                for s in sums:
                    s.zero_()
                handle = loops.handle()
                graph_if.probe(handle, counter, limit)
                loops.loop(handle, lambda: (call(0), graph_if.probe(handle, counter, limit)))
        run = graph.replay
    bad, first = [0, 0, 0, 0], None
    for _ in range(STRESS_REPLAYS):
        for b in bufs:
            b.fill_(float("nan"))
        run()
        torch.cuda.synchronize()
        for k, (b, r) in enumerate(zip(bufs, ref)):
            bad[k] += int(sum(not torch.equal(b[i], r) for i in range(rows)))
        if mode == "while":  # the sums of all iterations, against the first round's
            first = first or [s.clone() for s in sums]
            bad = [k + int(not torch.equal(s, f)) for k, s, f in zip(bad, sums, first)]
    return dict(mode=mode, rounds=STRESS_REPLAYS, calls_checked=rows * STRESS_REPLAYS,
                differing=dict(zip(("dpsi", "lp", "g_psi", "g"), bad)))


def run_stress(procs: int) -> dict:
    """``stress`` in ``procs`` processes at once, per mode in turn."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = {}
    ctx = multiprocessing.get_context("spawn")
    for mode in STRESS_MODES:
        with ProcessPoolExecutor(procs, mp_context=ctx) as pool:
            out[mode] = list(pool.map(stress, [mode] * procs, range(1, procs + 1)))
        print(json.dumps({mode: out[mode]}), flush=True)
    return out


def _world(variant: str) -> list:
    from ..parallel.dryrun import run_ranks

    threads = max(1, (os.cpu_count() or MESH_RANKS) // MESH_RANKS)
    return run_ranks(_rank, MESH_RANKS, args=(variant,), threads=threads)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="kernel:4,autograd:2",
                    help=f"variant:worlds, comma-separated, of {','.join(VARIANTS)}")
    ap.add_argument("--concurrent", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--stress", type=int, default=0,
                    help="run ``stress`` in this many processes at once per mode, then the worlds")
    ap.add_argument("--world", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_repro needs a CUDA card")
    if args.world:
        variant, out = args.world.split(":", 1)
        with open(out, "w") as f:
            json.dump(_world(variant), f)
        return 0
    import subprocess
    import tempfile

    report = {}
    if args.stress:
        from ..ops import cuda_band as cb

        cb.build(centered_vg.SOURCE)
        report["stress"] = run_stress(args.stress)

    from ..ops import cuda_band, graph_if, leaf

    jobs = []
    for item in filter(None, args.variants.split(",")):
        variant, n = item.split(":")
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant}; known: {VARIANTS}")
        jobs += [variant] * int(n)
    sources = [cuda_band.SOURCE, centered_vg.SOURCE, leaf.SOURCE, graph_if.SOURCE]
    sources += [variant_source(v) for v in dict.fromkeys(jobs) if v in SOURCE_EDITS]
    with ThreadPoolExecutor(max_workers=8) as pool:  # once, before the spawns
        list(pool.map(cuda_band.build, sources))
    report.update({v: dict(worlds=[]) for v in dict.fromkeys(jobs)})
    with tempfile.TemporaryDirectory() as tmp:
        for start in range(0, len(jobs), args.concurrent):
            batch = list(enumerate(jobs[start:start + args.concurrent], start))
            procs = [(v, f"{tmp}/w{i}.json", subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--world", f"{v}:{tmp}/w{i}.json"]))
                for i, v in batch]
            for v, path, proc in procs:
                if proc.wait() != 0:
                    raise SystemExit(f"a world of {v} failed (exit {proc.returncode})")
                with open(path) as f:
                    world = json.load(f)
                report[v]["worlds"].append(world)
                print(json.dumps(dict(variant=v, draws=[log[-1][1] for log in world],
                                      stages=len(world[0]))), flush=True)
    for v in dict.fromkeys(jobs):
        r = report[v]
        r["first_parting"] = _first_parting(r["worlds"]) if len(r["worlds"]) > 1 else None
        r["same_draws"] = len({json.dumps(w[0][-1]) for w in r["worlds"]}) == 1
        print(json.dumps({v: dict(same_draws=r["same_draws"],
                                  first_parting=r["first_parting"])}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
