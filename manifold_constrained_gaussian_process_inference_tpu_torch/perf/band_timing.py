"""Device time of the band-matvec kernels (csrc/band_matvec.cu) against
their bound, their plain PyTorch versions and the dense ``torch.matmul``,
the C sweep of the row tile against the chain tile, and a profiler trace
of the slice's replayed value-and-grad.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.band_timing \
        [--shapes main,long] [--baseline OTHER.cu] \
        [--variants fma_only,staging_only,row_stages3,row_stages8] [--csweep] [--profile] \
        [--out chiprun_out/band_timing.json]

Each time is per launch: CUDA events around one replay of a CUDA graph of
``COUNT`` back-to-back calls (device time, no host enqueue), median of
``REPS`` replays after warm-up; the "eager" column times the same calls
launched one by one from Python, host enqueue included. Callers run in
turns (kernel, baseline, plain, library, ..., kernel) in one process.
``--baseline`` builds another source with the C interface (for example an
older commit's kernel, whose entry points may take no tile) and times it
beside this one; ``equal_to_kernel`` says whether its outputs are the
kernel's bit for bit. ``--variants`` also times variants of the kernel,
each built from its source with one of the measurement defines the source
names: "fma_only" skips the staging (it multiplies whatever shared memory
holds) and "staging_only" skips the FMA loop, so their outputs are wrong
by design, and their times say which half holds the kernel back;
"row_stagesK" keeps K chunks of the row tile in flight. ``--csweep`` times
the row tile against the chain tile, in turns, at every C of
``CSWEEP_CHAINS`` and every (M, b, n) of ``CSWEEP_SHAPES``, each tile's
outputs held bit-equal to the other's (the sweep that set
``ops/cuda_band.ROW_TILE_BELOW``; the variants' row tiles are timed beside
them). ``--profile`` traces ``PROFILE_CALLS`` replays of the slice's
value-and-grad (C=128, n=397, band and dense) with ``torch.profiler`` and
reports its route (band: the whitened FN kernel), each kernel's share of
the device time and the device's idle share over the window. Runs on a
CUDA card only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

COUNT, REPS = 200, 5
PROFILE_CALLS = 20
# (C, M, b, n): the 128-chain slice's shape and the filllevel-5 grid
# (bandsize 160), each also at one chain (the default single-chain path);
# config 3's parallel tempering (10 rungs x 4 replicas, D=3, n=33, bandsize
# 20), config 7's 64 ChEES chains, a rank's 32 chains of the slice sharded
# over 4 ranks, and the local blocks of the filllevel-5 grid sharded over 4
# ranks (nloc = 793: the paired mphi/GC^T storage of nloc + 4b columns and
# GK^T's of nloc + 2b) at C = 128 and 1
SHAPES = {"main": (128, 2, 40, 397), "long": (128, 2, 160, 3169),
          "pt": (40, 3, 20, 33), "chees": (64, 2, 40, 397),
          "main_c1": (1, 2, 40, 397), "long_c1": (1, 2, 160, 3169),
          "mesh": (32, 2, 40, 397),
          "grid_pair": (128, 2, 160, 1433), "grid_single": (128, 2, 160, 1113),
          "grid_pair_c1": (1, 2, 160, 1433), "grid_single_c1": (1, 2, 160, 1113)}
# The C sweep: (M, b, n) of the slice's grid, [grid]'s blocks (GK^T's and
# the paired storages') and the filllevel-5 grid, each at every C here.
CSWEEP_SHAPES = {"main": (2, 40, 397), "grid_single": (2, 160, 1113),
                 "grid_pair": (2, 160, 1433), "long": (2, 160, 3169)}
CSWEEP_CHAINS = (1, 2, 3, 4, 5, 8)
# NVIDIA H100 SXM: float32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def band_terms(b: int, n: int) -> int:
    """Products y[i] += A[i, j] x[j] with both i and j in [0, n)."""
    i = np.arange(n)
    return int(np.sum(np.minimum(n - 1, i + b) - np.maximum(0, i - b) + 1))


def bound_ms(c, m, b, n, n_bands=1, n_in=1, n_out=1, itemsize=4):
    """Least time on the card: the larger of the FMA time at the float32
    peak and the time to move each input once and each output once."""
    flops = 2 * n_bands * c * m * band_terms(b, n)
    nbytes = itemsize * (n_bands * m * (2 * b + 1) * n + (n_in + n_out) * c * m * n)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def graph_ms(fn, count=COUNT, reps=REPS) -> float:
    """Per-call device time of fn from a CUDA graph of ``count`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    del graph
    return float(np.median(times))


def eager_ms(fn, count=COUNT, reps=REPS) -> float:
    """Per-call time of ``count`` calls launched one by one (host enqueue
    included where it is the slower side)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return float(np.median(times))


# The measurement defines of csrc/band_matvec.cu, one per --variants name.
VARIANTS = {
    "fma_only": "BAND_ABLATE_NO_STAGE",
    "staging_only": "BAND_ABLATE_NO_FMA",
    "row_stages3": "BAND_ROW_STAGES 3",
    "row_stages8": "BAND_ROW_STAGES 8",
}


def _variant(name: str) -> Path:
    """The kernel's source with one measurement define, under build/."""
    from ..ops import cuda_band as cb

    path = cb.BUILD_DIR / "variants" / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"#define {VARIANTS[name]}\n{cb.SOURCE.read_text()}")
    return path


def load_any(source: Path):
    """Build and bind ``source``, of this interface or an older one: a source
    from before the row tile has entry points without the tile argument
    (``lib.takes_tile`` False)."""
    import ctypes

    from ..ops import cuda_band as cb

    lib = ctypes.CDLL(str(cb.build(source)))
    lib.takes_tile = "int tile" in source.read_text()
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, k in cb.N_POINTERS.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes = [p] * k + [i] * (5 if lib.takes_tile else 4) + [p]
                fn.restype = i
    return lib


def _dense(bands: torch.Tensor, b: int) -> torch.Tensor:
    """(M, W, n) band storage -> (M, n, n) dense: A[j-k, j] = band[b+k, j]."""
    m, w, n = bands.shape
    out = torch.zeros((m, n, n), dtype=bands.dtype, device=bands.device)
    j = torch.arange(n, device=bands.device)
    for k in range(-b, b + 1):
        i = j - k
        ok = (i >= 0) & (i < n)
        out[:, i[ok], j[ok]] = bands[:, b + k, j[ok]]
    return out


# The C entry point of each op.
OPS = {"single": "band_matvec", "pair": "band_matvec_pair", "pair_t": "band_matvec_pair_t"}


def op_cases(shape, dtype, rng):
    """Inputs on the card for the three ops at one shape, and per op: its
    wrapper call, a raw launch of a library's entry point (for another
    source's kernel; ``raw(fn, *tile)``: the tile argument where the entry
    point takes one), its plain version, the dense torch.matmul computing
    the same function (the yardstick), its bound, and its outputs."""
    from ..ops import cuda_band as cb
    from ..ops.band import band_matvec_pair_t_torch, band_matvec_pair_torch
    from ..ops.band import band_storage_matvec_torch as twin

    c, m, b, n = shape
    put = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device="cuda")
    ba, bb = put(m, 2 * b + 1, n), put(m, 2 * b + 1, n)
    xa, xb = put(c, m, n), put(c, m, n)
    ya, yb = torch.empty_like(xa), torch.empty_like(xa)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    da, db = _dense(ba, b), _dense(bb, b)
    xa_t = xa.permute(1, 2, 0).contiguous()          # (M, n, C)
    xb_t = xb.permute(1, 2, 0).contiguous()
    d_pair = torch.stack([da, db])                   # (2, M, n, n)
    d_cat = torch.cat([da, db], dim=-1)              # (M, n, 2n)
    x_cat = torch.cat([xa_t, xb_t], dim=-2)          # (M, 2n, C)
    dims = (c, m, n, b)
    return {
        "single": dict(
            wrapper=lambda: cb.band_matvec_cuda(ba, xa, b),
            raw=lambda fn, *tile: lambda: fn(ba.data_ptr(), xa.data_ptr(), ya.data_ptr(),
                                             *dims, *tile, stream()),
            out=(ya,),
            plain=lambda: twin(ba, xa, b),
            library=lambda: torch.matmul(da, xa_t),
            bound=bound_ms(c, m, b, n, itemsize=xa.element_size()),
        ),
        "pair": dict(
            wrapper=lambda: cb.band_matvec_pair_cuda(ba, bb, xa, b),
            raw=lambda fn, *tile: lambda: fn(ba.data_ptr(), bb.data_ptr(), xa.data_ptr(),
                                             ya.data_ptr(), yb.data_ptr(), *dims, *tile,
                                             stream()),
            out=(ya, yb),
            plain=lambda: band_matvec_pair_torch(ba, bb, xa, b),
            library=lambda: torch.matmul(d_pair, xa_t),
            bound=bound_ms(c, m, b, n, n_bands=2, n_in=1, n_out=2, itemsize=xa.element_size()),
        ),
        "pair_t": dict(
            wrapper=lambda: cb.band_matvec_pair_t_cuda(ba, bb, xa, xb, b),
            raw=lambda fn, *tile: lambda: fn(ba.data_ptr(), bb.data_ptr(), xa.data_ptr(),
                                             xb.data_ptr(), ya.data_ptr(), *dims, *tile,
                                             stream()),
            out=(ya,),
            plain=lambda: band_matvec_pair_t_torch(ba, bb, xa, xb, b),
            library=lambda: torch.matmul(d_cat, x_cat),
            bound=bound_ms(c, m, b, n, n_bands=2, n_in=2, n_out=1, itemsize=xa.element_size()),
        ),
    }


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over matching tuples of tensors."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def time_in_turns(fns: dict, order) -> dict:
    """graph_ms and eager_ms of each named callable, in the given order
    (names may repeat); name -> list of (graph_ms, eager_ms)."""
    times = {}
    for tag in order:
        times.setdefault(tag, []).append((graph_ms(fns[tag]), eager_ms(fns[tag])))
    return times


def _tile_args(lib, n_chains, bandwidth, dtype, tile=None):
    """The tile argument of a library's entry points: ``tile``, by default
    the wrapper's choice; none for a source that takes none."""
    from ..ops import cuda_band as cb

    if not lib.takes_tile:
        return ()
    return (cb.TILES.index(tile or cb.tile_for(n_chains, bandwidth, dtype)),)


def _outputs(fn, out):
    """Clones of ``out`` after one call of fn (the outputs NaN-filled
    before it)."""
    for t in out:
        t.fill_(float("nan"))
    fn()
    return tuple(t.clone() for t in out)


def time_shape(name, shape, libs, rng, dtype=torch.float32, timed=True):
    """Every op at one shape: the raw launches of each library that has
    them, each checked against its plain version (and, bit for bit, against
    the kernel's outputs), then timed in turns beside it and the dense
    torch.matmul."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    c, _, b, _ = shape
    rows = []
    for op, case in op_cases(shape, dtype, rng).items():
        kernels = {}
        for tag, lib in libs.items():
            fn = getattr(lib, f"{OPS[op]}_{suffix}", None)
            if fn is None:
                continue
            kernels[tag] = _raising(case["raw"](fn, *_tile_args(lib, c, b, dtype)))
        if not kernels:
            continue
        want = case["plain"]()
        errs, outs = {}, {}
        for tag, fn in kernels.items():
            outs[tag] = _outputs(fn, case["out"])
            errs[tag] = rel_err(outs[tag], want)
        same = {tag: all(torch.equal(u, v) for u, v in zip(got, outs["kernel"]))
                for tag, got in outs.items() if tag != "kernel"}
        print(f"[check] {name} {op} {suffix} (C,M,b,n)={shape}: max rel err vs plain "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + "".join(f"; {k} bit-equal to kernel: {v}" for k, v in same.items()), flush=True)
        if not timed:
            rows.append(dict(shape=name, op=op, dtype=suffix, rel_err=errs, equal_to_kernel=same))
            continue
        fns = {**kernels, "plain": case["plain"], "library": case["library"]}
        times = time_in_turns(fns, list(kernels) + ["plain", "library"] + list(kernels)[::-1])
        bound, bound_by = case["bound"]
        row = dict(shape=name, op=op, c=shape[0], m=shape[1], b=shape[2], n=shape[3],
                   bound_ms=bound, bound_by=bound_by, rel_err=errs, equal_to_kernel=same)
        for tag, pairs in times.items():
            row[f"{tag}_ms"] = [p[0] for p in pairs]
            row[f"{tag}_eager_ms"] = [p[1] for p in pairs]
        rows.append(row)
        cells = "; ".join(
            f"{tag} {', '.join(f'{v:.5f}' for v in row[f'{tag}_ms'])}" for tag in times
        )
        print(f"[time] {name} {op} (C,M,b,n)={shape}: bound {bound:.5f} ms ({bound_by}); "
              f"graph ms/launch: {cells}", flush=True)
    return rows


def c_sweep(libs, rng) -> list:
    """The row tile against the chain tile at every C of CSWEEP_CHAINS and
    (M, b, n) of CSWEEP_SHAPES, float32, each op: both tiles' outputs
    bit-equal and against the plain version, then the device ms per launch
    in turns (row, chain, the variants' row tiles, plain, library, and back
    in reverse)."""
    from ..ops import cuda_band as cb

    rows = []
    for name, (m, b, n) in CSWEEP_SHAPES.items():
        order = cb.tile_for(cb.ROW_TILE_BELOW, b, torch.float32).split("_")[1]
        for c in CSWEEP_CHAINS:
            for op, case in op_cases((c, m, b, n), torch.float32, rng).items():
                fns = {}
                for tag, lib in libs.items():
                    if not lib.takes_tile or tag in ("fma_only", "staging_only"):
                        continue
                    fn = getattr(lib, f"{OPS[op]}_f32")
                    for kind in ("row", "chain") if tag == "kernel" else ("row",):
                        tile = _tile_args(lib, c, b, torch.float32, f"{kind}_{order}")
                        fns[kind if tag == "kernel" else f"row@{tag}"] = _raising(
                            case["raw"](fn, *tile))
                want = case["plain"]()
                outs = {tag: _outputs(fn, case["out"]) for tag, fn in fns.items()}
                equal = all(torch.equal(u, v) for got in outs.values()
                            for u, v in zip(got, outs["chain"]))
                err = max(rel_err(got, want) for got in outs.values())
                fns.update(plain=case["plain"], library=case["library"])
                order_of_turns = list(fns) + list(fns)[-3::-1]
                times = {}
                for tag in order_of_turns:
                    times.setdefault(tag, []).append(graph_ms(fns[tag]))
                bound, bound_by = case["bound"]
                row = dict(shape=name, op=op, c=c, m=m, b=b, n=n, bound_ms=bound,
                           bound_by=bound_by, tiles_bit_equal=equal, rel_err=err,
                           **{f"{tag}_ms": v for tag, v in times.items()})
                rows.append(row)
                print(f"[csweep] {name} {op} (C,M,b,n)=({c},{m},{b},{n}): tiles bit-equal "
                      f"{equal}, rel err vs plain {err:.2e}; bound {bound:.5f} ms ({bound_by}); "
                      + "; ".join(f"{tag} {', '.join(f'{v:.5f}' for v in t)}"
                                  for tag, t in times.items()), flush=True)
    return rows


def _raising(launch):
    """``launch`` (a raw C entry point call), raising on its error code."""

    def run():
        err = launch()
        if err:
            raise RuntimeError(f"kernel launch failed: CUDA error {err}")

    return run


def _kernel_intervals(trace_path: Path):
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["dur"]), e["name"]) for e in events
            if e.get("cat") == "kernel"]


def profile_vg(out_dir: Path, n_calls=PROFILE_CALLS):
    """torch.profiler over replayed value-and-grads of the slice's target:
    each kernel's share of the device time and the idle share."""
    from ..ops import cuda_band as cb
    from ..parallel.chains import GraphedValueAndGrad
    from .workload import fn_bench_workload, slice_likelihood

    y, t = fn_bench_workload()
    lik = slice_likelihood(y, t, bandsize=40)
    zeta = torch.as_tensor(np.random.default_rng(1).normal(size=(128, lik.dimension)) * 0.5,
                           dtype=torch.float32, device="cuda")
    rows = []
    for impl in ("band", "dense"):
        graphed = GraphedValueAndGrad(lik.vg(impl), zeta)
        for _ in range(5):
            graphed(zeta)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_calls):
            graphed(zeta)
        end.record()
        end.synchronize()
        vg_ms = start.elapsed_time(end) / n_calls
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_calls):
                graphed(zeta)
            torch.cuda.synchronize()
        trace = out_dir / f"vg_{impl}_trace.json"
        prof.export_chrome_trace(str(trace))
        ivals = sorted(_kernel_intervals(trace))
        launches = graphed.kernel_launches
        row = dict(impl=impl, route=graphed.eager.route, vg_ms=vg_ms, n_kernels=len(ivals),
                   band_launches_per_vg=sum(k for name, k in launches.items()
                                            if name != cb.CENTERED_VG),
                   centered_vg_launches_per_vg=launches[cb.CENTERED_VG])
        if ivals:
            busy, cur_s, cur_e = 0.0, None, None
            for ts, dur, _ in ivals:
                if cur_e is None or ts > cur_e:
                    busy += 0.0 if cur_e is None else cur_e - cur_s
                    cur_s, cur_e = ts, ts + dur
                else:
                    cur_e = max(cur_e, ts + dur)
            busy += cur_e - cur_s
            window = max(ts + dur for ts, dur, _ in ivals) - ivals[0][0]
            total = sum(dur for _, dur, _ in ivals)
            by_name = {}
            for _, dur, name in ivals:
                by_name[name] = by_name.get(name, 0.0) + dur
            band = sum(v for k, v in by_name.items() if "band_matvec" in k)
            fused = sum(v for k, v in by_name.items() if "centered_vg" in k)
            row.update(
                kernel_us_per_vg=total / n_calls, window_us_per_vg=window / n_calls,
                idle_share=1.0 - busy / window, band_share=band / total,
                band_us_per_vg=band / n_calls, centered_vg_share=fused / total,
                centered_vg_us_per_vg=fused / n_calls,
                top=sorted(((v / n_calls, k[:80]) for k, v in by_name.items()), reverse=True)[:10],
            )
        rows.append(row)
        print(f"[profile] {impl}: {json.dumps(row)}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--csweep", action="store_true",
                    help="time the row tile against the chain tile at few chains")
    ap.add_argument("--shapes", default="main,long")
    ap.add_argument("--variants", default="",
                    help=f"also time these builds of the kernel, of {','.join(VARIANTS)}")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/band_timing.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_timing needs a CUDA card")
    import manifold_constrained_gaussian_process_inference_tpu_torch  # noqa: F401  (TF32 off)
    from ..ops import cuda_band as cb

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    libs = {"kernel": load_any(cb.SOURCE)}
    if args.baseline is not None:
        libs["baseline"] = load_any(args.baseline)
    libs.update({name: load_any(_variant(name)) for name in args.variants.split(",") if name})
    for tag, lib in libs.items():
        log = Path(lib._name).with_suffix(".log")
        print(f"[ptxas] {tag}:\n{log.read_text() if log.exists() else '(no log)'}", flush=True)
    rng = np.random.default_rng(0)
    result = dict(device=smi, rows=[])
    for name in filter(None, args.shapes.split(",")):
        result["rows"] += time_shape(name, SHAPES[name], libs, rng, torch.float64, timed=False)
        result["rows"] += time_shape(name, SHAPES[name], libs, rng)
    if args.csweep:
        result["csweep"] = c_sweep(libs, rng)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    if args.profile:
        result["profile"] = profile_vg(args.out.parent)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"[done] {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
