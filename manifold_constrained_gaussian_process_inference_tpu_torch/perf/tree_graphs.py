"""The NUTS tree's CUDA graphs on the card (inference/nuts_batched.py
``LockstepTree``): per depth, the graph's nodes, capture seconds and
memory-pool bytes; the graphed tree against the eager one on the same
transitions; the device time of a batched leaf and of its bookkeeping;
the device's idle share under each.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.tree_graphs \\
        [--chains 128] [--transitions 6] [--max-depth 10] [--out tree_graphs.json]

The value-and-grad is [slice]'s (FN, n = 397, whitened and mode-centered,
band kernels, float32; ``perf/workload.slice_likelihood``), replayed from
its own CUDA graph (``GraphedValueAndGrad``). The chains start at 0.5
N(0, I) in the whitened coordinates under the identity metric, with step
sizes spread geometrically over ``STEP_RANGE``, so that the trees reach
deep doublings, as [slice]'s do (574 batched leaves per transition). The graphed and the eager tree run the same
transitions from generators seeded alike; their draws, log-densities,
gradients and statistics must be equal bit for bit.

A third tree captures every depth up front (0 to max depth - 1), to give
the graphs the transitions did not reach (``capture_all_depths``): per depth
its leaves captured (min(2^i, 4): leaves 0 and 1, then one WHILE node whose
body is one pair), its top-level and WHILE-body nodes, the nodes per
captured leaf, capture seconds (instantiation included) and pool bytes, and
the device memory all of them take (``torch.cuda.mem_get_info`` before and
after); one transition then runs on them.

Per transition: host wall (after a synchronize), host reads, batched
leaves, the WHILE iterations its timed replays ran (a doubling of i >= 2
runs (leaves - 2) / 2), whether it captured a graph. Device time per batched
leaf: CUDA events around every doubling's replay, over the leaves they ran
(the WHILE nodes' condition tests included); the bookkeeping's device time per
leaf is that less the value-and-grad's replay (CUDA events, mean of
``VG_REPS``), and holds the dense metric's product ``velocity_device_ms``
(ops/minv_mv.py's kernel, timed alike, beside ``matmul_device_ms``: the same
product by torch.matmul); ``replay_share``: the replays' device time over the host
wall of the transitions that captured nothing. Idle share: one minus the
summed kernel durations of a ``torch.profiler`` trace over the host wall
of ``PROFILE_TRANSITIONS`` transitions, for each tree; from the same trace
the doubling's kernels' (ops/leaf.py: D1, L2, D2) and the product's
device ms per leaf run and their kernel events per leaf (where the trace
sees every kernel the graphs replay: one L2 and one product a leaf, one D1
and one D2 a doubling). Launch counts: the band kernels', the doubling's
kernels' and the product's. Runs on a CUDA card only.

``--parts`` (with ``--trees A,B``: each checkout's package in a fresh
process started in its root, in turns A B B A) breaks the doubling's
bookkeeping down, float32, from CUDA graphs of ``PART_REPS`` repetitions,
at [slice]'s, [default]'s and [pt]'s
(chains, dim, metric) (``PART_SHAPES``), on a tree state left by one eager
transition of a Gaussian target, every 7th chain done:

- ``draws_ms``: the doubling's two draws (and the reset of the done flags
  that every graph below repeats);
- ``open_ms``: the doubling up to its first leaf (a leaf that raises ends
  the captured call) less the draws: D1, or an older checkout's setup in
  torch operations (whose leaf 0 also ran a drift kernel, not counted here);
- ``merge_ms``: a doubling of two leaves whose leaves do nothing, less the
  above: D2, or an older checkout's merge; ``outside_leaves_ms`` the two
  together; ``nodes``: the top-level nodes of one such doubling's graph
  (draws and the reset included);
- at [slice] with its value-and-grad (``leaf``): ``leaf_ms`` a leaf's device
  time (pairs of leaves 0 and 1 from a graph, the pair counter and alive
  reset before each pair, the reset's own time taken out), ``kernels_ms``
  its kernels' summed durations in a ``torch.profiler`` trace of that graph
  and ``gaps_ms`` the rest (the card idle between a leaf's kernels), with
  the kernel events seen per leaf; ``while_iteration_ms``: one leaf pair
  under a WHILE node for ``WHILE_ITERS`` iterations (L2 setting the
  condition, tiny steps so that no chain stops) against the same pairs
  unrolled, over the iterations.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

VG_REPS = 50
PROFILE_TRANSITIONS = 2
STEP_RANGE = (0.0005, 0.05)
# --parts: (chains, dim, metric) of [slice], [default] and [pt] (PT_RUNGS rungs)
PART_SHAPES = {"slice": (128, 799, "dense"), "default": (1, 799, "diag"),
               "pt": (40, 105, "rung")}
PT_RUNGS, PART_REPS, WHILE_ITERS = 10, 100, 16
PKG = "manifold_constrained_gaussian_process_inference_tpu_torch"


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _vg_ms(vg, q) -> float:
    """Device ms of one replay of the value-and-grad's graph."""
    vg(q)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(VG_REPS):
        vg.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / VG_REPS


def graph_ms(fn, reps: int = VG_REPS) -> float:
    """Device ms of one ``fn()`` from a replayed CUDA graph of ``reps``
    calls."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_replays(tree):
    """Wrap ``tree._replay`` to time each doubling's replay with CUDA events
    (returns the list the (ms, leaves) pairs go to; a replay right after its
    capture is not timed: the card idles while the host captures)."""
    log, real = [], tree._replay

    def replay(metric, i):
        if i not in tree.graphs:
            return real(metric, i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(metric, i)  # ends in a host read: the events have completed
        end.record()
        end.synchronize()
        log.append((start.elapsed_time(end), out[1]))
        return out

    tree._replay = replay
    return log


def _idle_share(run, names=()) -> dict:
    """Kernel-busy and idle share of the card over ``run()``'s host wall,
    and the summed device ms and events of the kernels whose names hold
    each of ``names``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = 1e-6 * sum(e.get("dur", 0.0) for e in kernels)
    named = {name: [e for e in kernels if name in e.get("name", "")] for name in names}
    return dict(wall_s=wall, kernel_s=busy, kernels=len(kernels), idle_share=1.0 - busy / wall,
                by_name={name: dict(ms=1e-3 * sum(e.get("dur", 0.0) for e in ev), events=len(ev))
                         for name, ev in named.items()})


def capture_all_depths(vg, q0, eps, metric, max_depth: int, generator) -> dict:
    """Every depth of a graphed tree for ``vg`` captured up front: per depth
    its ``graph_info`` and nodes per captured leaf, the device bytes all of
    them hold, the capture seconds; then one transition on them (finite
    log-densities)."""
    from ..inference.nuts_batched import LockstepTree

    tree = LockstepTree(vg, generator, max_depth, graphed=True)
    bound = tree._bind(q0, eps, metric)
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    for i in range(max_depth):
        tree.graphs[i] = tree._capture(bound, i)
    torch.cuda.synchronize()
    graphs = {i: dict(info, nodes_per_graph=info["nodes"] + info["body_nodes"],
                      nodes_per_leaf=(info["nodes"] + info["body_nodes"])
                      / info["captured_leaves"])
              for i, info in sorted(tree.graph_info.items())}
    out = dict(graphs=graphs, device_bytes=free0 - torch.cuda.mem_get_info()[0],
               capture_s=tree.capture_seconds)
    _, lp0, _, _ = tree(q0, *vg(q0), eps, metric)
    out["transition_ok"] = bool(torch.isfinite(lp0).all())
    return out


class _Stop(Exception):
    """Raised by a leaf to end a captured doubling at its opening."""


def _graph_of(body, reps: int, generator=None, warm: bool = True):
    """(device ms of one ``body()`` from a replayed CUDA graph of ``reps``
    calls, the graph's top-level nodes at one call, the graph); ``warm``:
    one eager call first (not for a body that holds a WHILE node)."""
    from importlib import import_module

    graph_if = import_module(f"{PKG}.ops.graph_if")
    if warm:
        body()
    torch.cuda.synchronize()
    one, graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    for g, n in ((one, 1), (graph, reps)):
        if generator is not None:
            g.register_generator_state(generator)
        with torch.cuda.graph(g, stream=stream):
            for _ in range(n):
                body()
            if n == 1:
                nodes = graph_if.capture_nodes(stream)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, nodes, graph


def _metric(kind: str, c: int, dim: int, f: dict):
    from importlib import import_module

    nuts = import_module(f"{PKG}.inference.nuts")
    eye = torch.eye(dim, **f)
    if kind == "dense":
        return nuts.DenseMetric(eye, eye, eye)
    if kind == "rung":
        k = eye.expand(PT_RUNGS, dim, dim).contiguous()
        return nuts.RungDenseMetric(k, k, k)
    return nuts.DiagMetric(torch.ones(c, dim, **f))


def doubling_parts(c: int, dim: int, kind: str, reps: int = PART_REPS,
                   device: str = "cuda") -> dict:
    """A depth-1 doubling's draws, opening and merge alone at (c, dim, kind)
    on ``device`` (see the module docstring)."""
    from importlib import import_module

    nb = import_module(f"{PKG}.inference.nuts_batched")
    f = dict(dtype=torch.float32, device=device)
    rng = np.random.default_rng(c + dim)
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, dim), **f)

    def vg(q):
        return -0.5 * (scale * q * q).sum(-1), -scale * q

    metric = _metric(kind, c, dim, f)
    q = torch.as_tensor(rng.normal(size=(c, dim)), **f)
    eps = torch.as_tensor(np.geomspace(0.05, 0.5, c), **f)
    gen = torch.Generator(device=device).manual_seed(1)
    tree = nb.LockstepTree(vg, gen, 10, graphed=False)
    tree(q, *vg(q), eps, metric)  # the edges, rho and sums of real leaves
    st = tree.st
    done0 = torch.as_tensor(np.arange(c) % 7 == 6, device=device)

    def draws():
        st.done.copy_(done0)
        torch.rand((2, c), generator=gen, **f)
        torch.rand((2, c), generator=gen, **f).contiguous()

    def stop(*args, **kwargs):
        raise _Stop

    def opening():
        st.done.copy_(done0)
        try:
            tree._doubling(metric, 1)
        except _Stop:
            pass

    def no_leaves():
        st.done.copy_(done0)
        tree._doubling(metric, 1)

    out = dict(chains=c, dim=dim, metric=kind)
    out["draws_ms"], out["draws_nodes"], _ = _graph_of(draws, reps, gen)
    tree._leaf = stop
    open_ms, out["open_nodes"], _ = _graph_of(opening, reps, gen)
    tree._leaf = lambda *args, **kwargs: None
    whole_ms, out["nodes"], _ = _graph_of(no_leaves, reps, gen)
    out["open_ms"] = open_ms - out["draws_ms"]
    out["merge_ms"] = whole_ms - open_ms
    out["outside_leaves_ms"] = whole_ms - out["draws_ms"]
    return out


def leaf_parts(reps: int = PART_REPS) -> dict:
    """A [slice] leaf's device time, its kernels' and the gaps between them,
    and a WHILE iteration over a leaf pair (see the module docstring)."""
    from importlib import import_module

    nb = import_module(f"{PKG}.inference.nuts_batched")
    graph_if = import_module(f"{PKG}.ops.graph_if")
    chains = import_module(f"{PKG}.parallel.chains")
    workload = import_module(f"{PKG}.perf.workload")
    y, t = workload.fn_bench_workload()
    lik = workload.slice_likelihood(y, t, 20)
    c, dim, kind = PART_SHAPES["slice"]
    f = dict(dtype=torch.float32, device="cuda")
    q = torch.as_tensor(0.5 * np.random.default_rng(0).normal(size=(c, dim)), **f)
    vg = chains.GraphedValueAndGrad(lik.vg("band"), q)
    metric = _metric(kind, c, dim, f)
    gen = torch.Generator(device="cuda").manual_seed(7)
    tree = nb.LockstepTree(vg, gen, 10, graphed=False)
    tree.leaf_vg = vg.eager  # as a graphed tree's leaves call it
    eps = torch.as_tensor(np.geomspace(*STEP_RANGE, c), **f)
    tree(q, *vg(q), eps, metric)
    st = tree.st
    alive = torch.ones(c, dtype=torch.bool, device="cuda")
    tiny = torch.full((c, 1), 1e-6, **f)
    half = 0.5 * tiny
    u_leaf = torch.zeros((2 * WHILE_ITERS + 2, c), **f)

    def reset():
        st.counters.zero_()
        st.alive.copy_(alive)

    def pair(handle=None, k=0):
        tree._leaf(metric, half, tiny, u_leaf, 2 * k, handle)
        tree._leaf(metric, half, tiny, u_leaf, 2 * k + 1, handle)

    def pairs():
        reset()
        pair()

    reset_ms = _graph_of(reset, reps)[0]
    pairs_ms, _, graph = _graph_of(pairs, reps)
    leaf_ms = (pairs_ms - reset_ms) / 2
    traced = _idle_share(graph.replay)
    out = dict(chains=c, dim=dim, leaf_ms=leaf_ms, reset_ms=reset_ms,
               kernels_ms=1e3 * traced["kernel_s"] / (2 * reps),
               kernel_events_per_leaf=traced["kernels"] / (2 * reps))
    out["gaps_ms"] = pairs_ms / 2 - out["kernels_ms"]

    loops = graph_if.WhileNodes(torch.device("cuda"))

    def looped():
        reset()
        handle = loops.handle()
        pair(handle)
        loops.loop(handle, lambda: pair(handle, 1))

    def unrolled():
        reset()
        for k in range(WHILE_ITERS + 1):
            pair(None, k)

    ran = {}
    for name, body in (("while", looped), ("unrolled", unrolled)):
        out[f"{name}_ms"] = _graph_of(body, 1, warm=False)[0]
        ran[name] = int(st.counters[0].item())
    out["while_iterations"] = ran["while"] - 1
    out["unrolled_pairs"] = ran["unrolled"]
    out["while_iteration_ms"] = ((out["while_ms"] - out["unrolled_ms"])
                                 / max(out["while_iterations"], 1))
    return out


def parts() -> dict:
    """The ``--parts`` readings of the package that is imported."""
    out = dict(device=_card(), torch=torch.__version__)
    out["doubling"] = {name: doubling_parts(*shape) for name, shape in PART_SHAPES.items()}
    out["leaf"] = leaf_parts()
    return out


def _parts_in_trees(trees, rounds: int) -> list:
    """``parts()`` of each checkout in ``trees``, each in a fresh process
    started in its root (its package imported), in turns A B ... B A."""
    import os
    import sys

    results = []
    order = []
    for r in range(rounds):
        order += list(trees) + list(reversed(trees))
    for tree in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--parts-here"],
                              cwd=tree, env=env, stdout=subprocess.PIPE, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        row = dict(tree=tree, rc=proc.returncode, parts=json.loads(lines[-1]) if lines else None)
        results.append(row)
        print("[parts] " + json.dumps(row), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--transitions", type=int, default=6)
    ap.add_argument("--max-depth", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", action="store_true",
                    help="break the doubling's bookkeeping down (see the module docstring)")
    ap.add_argument("--trees", default=None,
                    help="with --parts: checkouts whose packages are read in turns, A,B")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts-here", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tree_graphs: no CUDA device")
    if args.parts_here:
        print(json.dumps(parts()), flush=True)
        return 0
    if args.parts:
        rows = (_parts_in_trees(args.trees.split(","), args.rounds) if args.trees
                else [dict(tree=".", rc=0, parts=parts())])
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0 if all(r["rc"] == 0 for r in rows) else 1

    from ..inference.nuts import DenseMetric
    from ..inference.nuts_batched import LockstepTree
    from ..ops import cuda_band, leaf, minv_mv
    from ..parallel.chains import GraphedValueAndGrad
    from .workload import fn_bench_workload, slice_likelihood

    card = _card()
    print(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    y, t = fn_bench_workload()
    lik = slice_likelihood(y, t, 20)
    c, dim = args.chains, lik.dimension
    q0 = torch.as_tensor(0.5 * np.random.default_rng(0).normal(size=(c, dim)),
                         dtype=torch.float32, device="cuda")
    vg = GraphedValueAndGrad(lik.vg("band"), q0)
    eps = torch.as_tensor(np.geomspace(*STEP_RANGE, c), dtype=torch.float32, device="cuda")
    eye = torch.eye(dim, dtype=torch.float32, device="cuda")
    metric = DenseMetric(eye, eye, eye)
    vg_ms = _vg_ms(vg, q0)
    velocity_ms = graph_ms(lambda: metric.velocity(q0))  # the dense metric's product
    matmul_ms = graph_ms(lambda: q0 @ eye.T)  # the same by torch.matmul

    runs = {}
    for kind in ("graphed", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(7)
        tree = LockstepTree(vg, gen, args.max_depth, graphed=kind == "graphed")
        log = _timed_replays(tree) if tree.graphed else None
        q, (lp, g) = q0, vg(q0)
        per, outs = [], []
        cuda_band.reset_launches()
        leaf.reset_launches()
        minv_mv.reset_launches()
        for _ in range(args.transitions):
            n_graphs, n_log = len(tree.graphs), len(log or ())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, lp, g, stats = tree(q, lp, g, eps, metric)
            torch.cuda.synchronize()
            per.append(dict(wall_s=time.perf_counter() - t0, host_reads=stats.host_syncs,
                            leaves=stats.lockstep_leaves,
                            while_iterations=(sum((n - 2) // 2 for _, n in log[n_log:] if n > 2)
                                              if log is not None else None),
                            max_depth=int(stats.tree_depth.max()),
                            captured=len(tree.graphs) > n_graphs,
                            replay_ms=sum(ms for ms, _ in (log or [])[n_log:])))
            outs.append([q, lp, g, *stats[:6]])
        launches = {**cuda_band.counts(), **leaf.LAUNCHES, **minv_mv.LAUNCHES}
        leaves = sum(p["leaves"] for p in per)
        run = dict(transitions=per, launches=launches, leaves=leaves,
                   ms_per_transition=[1e3 * p["wall_s"] for p in per],
                   host_ms_per_leaf=1e3 * sum(p["wall_s"] for p in per) / leaves,
                   host_reads_per_transition=sum(p["host_reads"] for p in per) / len(per))
        if tree.graphed:
            first = {i: dict(info) for i, info in sorted(tree.graph_info.items())}
            dev_ms = sum(ms for ms, _ in log) / max(sum(n for _, n in log), 1)
            steady = [p for p in per if not p["captured"]]
            deep = [n for _, n in log if n > 2]  # the replays of doublings with a WHILE node
            run.update(graphs=first, device_ms_per_leaf=dev_ms,
                       while_iterations_per_replay=(sum((n - 2) // 2 for n in deep)
                                                    / max(len(deep), 1)),
                       replay_share=sum(p["replay_ms"] for p in steady)
                       / max(1e3 * sum(p["wall_s"] for p in steady), 1e-9),
                       bookkeeping_device_ms_per_leaf=dev_ms - vg_ms, per_leaf_launches=tree.per_leaf)
        traced = []
        run["profile"] = _idle_share(
            lambda: traced.extend(tree(q, lp, g, eps, metric) for _ in range(PROFILE_TRANSITIONS)),
            names=(*leaf.LAUNCHES, "minv_mv_kernel"))
        traced_leaves = sum(out[3].lockstep_leaves for out in traced)
        run["leaf_kernels_per_leaf"] = {
            name: dict(device_ms=k["ms"] / traced_leaves, events=k["events"] / traced_leaves)
            for name, k in run["profile"]["by_name"].items()}
        runs[kind] = (run, outs)
        print(f"[{kind}] " + json.dumps({k: v for k, v in run.items() if k != "transitions"}),
              flush=True)
        for p in per:
            print(f"[{kind}] transition {json.dumps(p)}", flush=True)

    all_depths = capture_all_depths(vg, q0, eps, metric, args.max_depth,
                                    torch.Generator(device="cuda").manual_seed(7))
    print("[all depths] " + json.dumps(all_depths), flush=True)

    (g_run, g_outs), (e_run, e_outs) = runs["graphed"], runs["eager"]
    first_diff = next((t for t, (a, b) in enumerate(zip(g_outs, e_outs))
                       if not all(torch.equal(x, y) for x, y in zip(a, b))), None)
    result = dict(device=card, chains=c, dim=dim, vg_device_ms=vg_ms,
                  velocity_device_ms=velocity_ms, matmul_device_ms=matmul_ms, graphed=g_run,
                  eager=e_run,
                  all_depths=all_depths,
                  bit_equal=first_diff is None, first_differing_transition=first_diff)
    print(json.dumps(dict(vg_device_ms=vg_ms, velocity_device_ms=velocity_ms,
                          matmul_device_ms=matmul_ms, bit_equal=first_diff is None,
                          first_differing_transition=first_diff)), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if first_diff is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
