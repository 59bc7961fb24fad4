"""The whitened FN value-and-grad's kernel (csrc/centered_vg.cu) on the
card: held to its plain version and to its first design (one block per
chain, ``perf/baselines/centered_vg_pr11.cu``, built beside it), timed
per launch against its bound, the plain version and that baseline, and the
whole value-and-grad on both routes.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.vg_timing \\
        [--cases slice,c1,chees,mesh,resume,long,long_c1,n793,n793_c1] [--repeat] \\
        [--probe] [--phases slice,resume] [--variants base,g4,u4 --variant-cases slice,c1] \\
        [--out chiprun_out/vg_timing.json]

Cases (chains, workload): [slice]'s (128 chains, FN n = 397, b = 40, sigma
sampled, theta bounded below), one chain, [chees]' 64, a [mesh] rank's 32,
[resume]'s (8 chains, n = 41, b = 20, sigma fixed, theta unbounded), the
filllevel-5 grid's (n = 3169, b = 160) and config 4's (n = 793, the
band escalated from 20), each at 128 chains and one. Inputs: dpsi = zeta W^T
from 0.5 N(0, I) draws of zeta under the GN whitener at the interpolated
start (``perf/workload.slice_likelihood``; for n = 3169, whose whitener is
not built here, 0.05 N(0, I) draws of dpsi).

Checks (``check_case``): the float64 kernel against the float64 plain
version, max |difference| over max |plain| of lp and of g_psi, within
``TOL_F64``; the float32 kernel's error against the float64 plain version
at most ``F32_FACTOR`` times the float32 plain version's own; and a
chain's bits the same whatever shares its launch: the launches of
SUBSETS' chains against the rows of the whole launch, in both dtypes; and
the x block of g_psi bit-equal to the one-block baseline's, in both dtypes
(every per-row vector keeps that kernel's arithmetic and order; only the
chain's sums, lp and the gradient's tail, are taken in another order).

Times (``time_case``): device ms per launch from CUDA events around one
replay of a CUDA graph of ``COUNT`` launches, median of ``REPS`` replays,
beside the tiling it ran (``centered_vg.tiling``); the one-block baseline
likewise; the plain version likewise (a graph of
``PLAIN_COUNT`` calls); the bound, the larger of the bytes at 3.35 TB/s and
the multiply-adds at the H100's 67 TFLOP/s float32 peak (34 in float64),
each from ``centered_vg.bound_work``; the two whitening GEMMs alone, by
torch.matmul and by the product kernel (``ops/minv_mv``, on W and W^T
prepared), and the route that ``centered_vg.gemm_takes_kernel`` gives
them; the whole value-and-grad per replayed call (``GraphedValueAndGrad``)
on the kernel route, on the kernel route with its GEMMs on torch.matmul
(``matmul_gemms``) and on the autograd one
(``make_centered_whitened_vg_autograd``); and, in float32, both GEMM
routes' value-and-grads against the float64 autograd route's, which runs
neither kernel (``vg_rel``).
``--phases CASES`` builds a copy of the kernel that stamps the device
clock at each of its phases (``phase_source``) and prints, per phase, the
median and largest microseconds over the launch's blocks. ``--variants``
times copies of the kernel with source edits (``SOURCE_VARIANTS``) or G
capped ("g<chains>"), each held to the plain version and the one-block kernel's x block.
``--repeat`` digests both routes' value-and-grad over 300 calls of a
[mesh] rank's batch in two spawned worlds of four ranks on the card and in
two lone processes (``repeat_digest``): whether a route gives the same bits
run to run and whatever shares the card. ``--probe`` times, at [slice]'s
case, a copy of the kernel whose band coefficients are a constant instead
of loads from L2 (``probe_source``; its outputs are wrong by design): what
the loads of the six storages cost a launch. Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

COUNT, REPS, PLAIN_COUNT, VG_REPS = 200, 5, 20, 50
TOL_F64, F32_FACTOR = 1e-12, 2.0
HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"
FMA_PER_S = {torch.float32: 33.5e12, torch.float64: 17e12}  # 67 and 34 TFLOP/s
# (chains, n_obs, t_end, fill, bandsize, sigma sampled, theta bounded below,
# the band escalated from bandsize as build_gp_cov settles it)
CASES = {
    "slice": (128, 100, 20.0, 2, 40, True, True, False),
    "c1": (1, 100, 20.0, 2, 40, True, True, False),
    "chees": (64, 100, 20.0, 2, 40, True, True, False),
    "mesh": (32, 100, 20.0, 2, 40, True, True, False),
    "resume": (8, 21, 8.0, 1, 20, False, False, False),
    "long": (128, 100, 20.0, 5, 160, True, True, False),
    "long_c1": (1, 100, 20.0, 5, 160, True, True, False),
    # config 4's grid (docs/BENCHMARKS.md, n = 793) from MagiConfig's band 20
    "n793": (128, 100, 20.0, 3, 20, True, True, True),
    "n793_c1": (1, 100, 20.0, 3, 20, True, True, True),
}
# chains launched alone, held against their rows of the whole launch
SUBSETS = {1: (5,), 3: (7, 8, 9), 32: tuple(range(32, 64))}
BASELINE = Path(__file__).resolve().parent / "baselines" / "centered_vg_pr11.cu"
_BASELINE_LIB = None


def baseline_lib():
    """The one-block kernel (BASELINE), built and bound once."""
    global _BASELINE_LIB
    if _BASELINE_LIB is None:
        from ..ops import centered_vg as cv

        _BASELINE_LIB = cv.load(BASELINE)
    return _BASELINE_LIB


def launch_pr11(dpsi, p):
    """(lp, g_psi) of the one-block kernel on the current stream: one block per
    chain, its integer arguments those of its own interface."""
    import ctypes

    from ..ops import centered_vg as cv

    lib = baseline_lib()
    c, dim = dpsi.shape
    g_psi, lp = torch.empty_like(dpsi), torch.empty(c, dtype=dpsi.dtype, device=dpsi.device)
    out = dict(dpsi=dpsi, bands=p.bands, fields=p.fields, scalars=p.scalars, g_psi=g_psi, lp=lp)
    ptrs = (ctypes.c_void_p * 6)(*(out[k].data_ptr() for k in out))  # its VgArgs' order
    ints = (ctypes.c_longlong * 8)(c, p.n, p.bandwidth, dim, int(p.sigma_sampled), p.theta_kind,
                                   len(cv.POINTERS), 8)
    fn = getattr(lib, f"{cv.NAME}_{'f64' if dpsi.dtype == torch.float64 else 'f32'}")
    err = fn(ptrs, ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"one-block baseline launch failed: CUDA error {err}")
    return lp, g_psi


def make_case(name: str, cov64=None) -> dict:
    """A case's targets (float32 and float64 on the card), center, whitener
    W (float64, or None at n = 3169) and inputs. ``cov64``: the case's
    float64 covariances where the caller built them already."""
    from ..inference.solve import _init_x_interpolation
    from ..inference.target import MagiTarget
    from ..inference.transforms import make_theta_transform, unconstrain
    from ..inference.whiten import build_psi_whitener
    from ..models import FN_SYSTEM
    from ..ops.gp_cov import build_gp_cov
    from .workload import PHI, SIGMA_TRUE, TEMPS, THETA_TRUE, fn_bench_workload

    chains, n_obs, t_end, fill, bandsize, sampled, bounded, escalate = CASES[name]
    y, t = fn_bench_workload(n_obs=n_obs, t_end=t_end, fill=fill)
    if cov64 is None:
        cov64 = build_gp_cov("matern52", PHI, t, bandsize=bandsize,
                             auto_escalate_bandsize=escalate)
    tr = (make_theta_transform(FN_SYSTEM.theta_lower_bound, FN_SYSTEM.theta_upper_bound)
          if bounded else None)
    sigma0 = np.full(2, SIGMA_TRUE)

    def target(dtype, device, impl="band"):
        cov = cov64.to(dtype=dtype, device=device)
        return MagiTarget.build(y, cov, FN_SYSTEM, sigma0, TEMPS, not sampled, band_impl=impl,
                                theta_transform=tr)

    x0 = _init_x_interpolation(y, t)
    z_theta = unconstrain(tr, THETA_TRUE) if bounded else THETA_TRUE
    center = np.concatenate([x0.T.reshape(-1), z_theta] + ([np.log(sigma0)] if sampled else []))
    rng = np.random.default_rng(sum(map(ord, name)))
    dim = center.shape[0]
    w = None
    if fill < 5:
        t64 = target(torch.float64, "cpu", "dense")
        w = build_psi_whitener(cov64, y, t64, center, TEMPS, torch.float64).W.numpy()
        dpsi = (0.5 * rng.normal(size=(chains, dim))) @ w.T
    else:
        dpsi = 0.05 * rng.normal(size=(chains, dim))
    return dict(name=name, chains=chains, n=len(t), bandwidth=int(cov64.bandsize), dim=dim,
                center=center, w=w, dpsi=dpsi, cov64=cov64,
                targets={dt: target(dt, DEVICE) for dt in (torch.float32, torch.float64)})


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def check_case(case: dict) -> dict:
    """The kernel against its plain version (see the module docstring);
    raises AssertionError on a failed check, else returns the errors."""
    from ..ops import centered_vg as cv

    f32, f64 = torch.float32, torch.float64
    params = {dt: cv.make_params(case["targets"][dt], case["center"]) for dt in (f32, f64)}
    dpsi32 = torch.as_tensor(case["dpsi"], dtype=f32, device=DEVICE)
    dpsi = {f32: dpsi32, f64: dpsi32.double()}  # one input, representable in both
    ref = cv.centered_fn_vg_torch(dpsi[f64], params[f64])
    out = {}
    for dt in (f64, f32):
        kern = cv.centered_fn_vg_cuda(dpsi[dt], params[dt])
        plain = cv.centered_fn_vg_torch(dpsi[dt], params[dt])
        torch.cuda.synchronize()
        for what, k, p, r in zip(("lp", "g"), kern, plain, ref):
            assert bool(torch.isfinite(k).all()), f"{case['name']} {dt} {what}: non-finite"
            ek, ep = _rel(k.double(), r), _rel(p.double(), r)
            out[f"{what}_{str(dt)[6:]}"] = ek
            if dt == f64:
                assert ek <= TOL_F64, f"{case['name']} float64 {what}: rel {ek:.3e} > {TOL_F64}"
            else:
                out[f"{what}_float32_plain"] = ep
                assert ek <= F32_FACTOR * ep, (f"{case['name']} float32 {what}: kernel rel "
                                               f"{ek:.3e} > {F32_FACTOR} x plain's {ep:.3e}")
        out[f"max_abs_err_{str(dt)[6:]}"] = max(float((k.double() - p.double()).abs().max())
                                                for k, p in zip(kern, plain))
        out[f"max_abs_plain_{str(dt)[6:]}"] = max(float(p.double().abs().max()) for p in plain)
        # the x block against the one-block kernel's, bit for bit
        nd = 2 * case["n"]
        base = launch_pr11(dpsi[dt], params[dt])
        torch.cuda.synchronize()
        assert torch.equal(kern[1][:, :nd], base[1][:, :nd]), (
            f"{case['name']} {dt}: the x block of g_psi differs from the one-block kernel's (max "
            f"{float((kern[1][:, :nd] - base[1][:, :nd]).abs().max()):.3e})")
        out[f"x_block_bits_pr11_{str(dt)[6:]}"] = True
        out[f"tail_rel_pr11_{str(dt)[6:]}"] = max(
            _rel(kern[0].double(), base[0].double()),
            _rel(kern[1][:, nd:].double(), base[1][:, nd:].double()))
        # a chain's bits: chains launched alone
        for c, rows in SUBSETS.items():
            if max(rows) >= case["chains"]:
                continue
            idx = torch.as_tensor(rows, device=DEVICE)
            alone = cv.centered_fn_vg_cuda(dpsi[dt][idx].contiguous(), params[dt])
            assert all(torch.equal(a, b[idx]) for a, b in zip(alone, kern)), \
                f"{case['name']} {dt}: chains {rows} launched alone differ from the whole launch"
    return out


def graph_ms(fn, count: int, reps: int = REPS) -> float:
    """Device ms per call: CUDA events around one replay of a graph of
    ``count`` calls, median of ``reps`` replays after warm-up."""
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
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return float(np.median(times))


def replay_ms(vg, zeta, reps: int = VG_REPS) -> float:
    """Device ms per call of ``vg`` replayed from its own CUDA graph
    (CUDA events around each replay, median)."""
    from ..parallel.chains import GraphedValueAndGrad

    graphed = GraphedValueAndGrad(vg, zeta)
    for _ in range(3):
        graphed(zeta)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graphed.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(case: dict, dtype) -> tuple:
    """(the bound in ms, "bytes" or "operations") of one launch."""
    from ..ops import centered_vg as cv

    itemsize = torch.empty((), dtype=dtype).element_size()
    moved, fma = cv.bound_work(case["chains"], case["n"], case["bandwidth"], case["dim"], itemsize)
    by_bytes, by_ops = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * fma / FMA_PER_S[dtype]
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def time_case(case: dict, dtype=torch.float32, whole: bool = True) -> dict:
    """Per-launch times of the kernel, its plain version and bound; with ``whole``, the GEMMs and the whole
    value-and-grad per replayed call on both routes."""
    from ..inference.whiten import (
        PsiWhitener, make_centered_whitened_vg_autograd, make_centered_whitened_vg_kernel,
    )
    from ..ops import centered_vg as cv
    from ..ops import minv_mv

    target = case["targets"][dtype]
    params = cv.make_params(target, case["center"])
    dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device="cuda")
    tile = cv.tiling(case["n"], case["bandwidth"], case["chains"])
    out = {"chains": case["chains"], "n": case["n"], "bandwidth": case["bandwidth"],
           "dtype": str(dtype)[6:], "tiling": {k: v for k, v in tile._asdict().items()
                                                 if k != "slabs"}}
    out["ms"] = graph_ms(lambda: cv.centered_fn_vg_cuda(dpsi, params), COUNT)
    out["pr11_ms"] = graph_ms(lambda: launch_pr11(dpsi, params), COUNT)
    out["active_clusters"] = cv.max_clusters(cv._library(), cv._ints(
        case["chains"], case["dim"], params, tile), dtype == torch.float64)
    out["plain_ms"] = graph_ms(lambda: cv.centered_fn_vg_torch(dpsi, params), PLAIN_COUNT)
    out["bound_ms"], out["bound_by"] = bound_ms(case, dtype)
    out["library_ms"] = None
    if whole:
        if case["w"] is not None:
            w = torch.as_tensor(case["w"], dtype=dtype, device="cuda")
        else:  # a whitener's shape and cost, not its values
            w = 0.05 * torch.eye(case["dim"], dtype=dtype, device="cuda")
        wh = PsiWhitener(W=w, L_T=w, center=torch.as_tensor(case["center"], dtype=dtype,
                                                             device="cuda"))
        zeta = torch.as_tensor(np.random.default_rng(1).normal(size=dpsi.shape) * 0.5,
                               dtype=dtype, device="cuda")
        w_t = w.T
        out["gemm_ms"] = [graph_ms(lambda: zeta @ w_t, PLAIN_COUNT),
                          graph_ms(lambda: dpsi @ w, PLAIN_COUNT)]
        preps = (minv_mv.prepare(w), minv_mv.prepare(w_t))
        out["gemm_kernel_ms"] = [graph_ms(lambda: minv_mv.product(preps[0], zeta), PLAIN_COUNT),
                                 graph_ms(lambda: minv_mv.product(preps[1], dpsi), PLAIN_COUNT)]
        out["gemm_route"] = "kernel" if cv.gemm_takes_kernel(*zeta.shape) else "matmul"
        out["vg_ms"] = {"kernel": replay_ms(make_centered_whitened_vg_kernel(target, wh), zeta),
                        "autograd": replay_ms(make_centered_whitened_vg_autograd(target, wh),
                                              zeta)}
        with matmul_gemms():
            out["vg_ms"]["kernel_matmul_gemms"] = replay_ms(
                make_centered_whitened_vg_kernel(target, wh), zeta)
        if dtype == torch.float32:  # both GEMM routes against the float64 value-and-grad
            f64 = torch.float64  # of the autograd route: no kernel of the routes under test
            wh64 = PsiWhitener(W=w.to(f64), L_T=w.to(f64), center=wh.center.to(f64))
            want = make_centered_whitened_vg_autograd(case["targets"][f64], wh64)(zeta.to(f64))
            with matmul_gemms():
                on_matmul = make_centered_whitened_vg_kernel(target, wh)(zeta)
            on_kernel = make_centered_whitened_vg_kernel(target, wh)(zeta)
            out["vg_rel"] = {
                gemms: {what: _rel(got.double(), ref) for what, got, ref in
                        zip(("lp", "g"), run, want)}
                for gemms, run in (("kernel_gemms", on_kernel), ("matmul_gemms", on_matmul))}
    return out


@contextlib.contextmanager
def matmul_gemms():
    """The kernel route's whitening GEMMs on torch.matmul whatever their
    shape (``centered_vg.gemm_takes_kernel`` patched to False), for the
    value-and-grads made and called inside the block."""
    from ..ops import centered_vg as cv

    real = cv.gemm_takes_kernel
    cv.gemm_takes_kernel = lambda n_chains, dim: False
    try:
        yield
    finally:
        cv.gemm_takes_kernel = real


def probe_source() -> Path:
    """A copy of the kernel's source, under build/, whose band coefficient
    loads read zeros: a timing probe, not a kernel."""
    from ..ops import centered_vg as cv, cuda_band

    text = cv.SOURCE.read_text()
    load = "__ldg(reinterpret_cast<const V*>(diags[j] + static_cast<ptrdiff_t>(t0 + u) * cols))"
    if load not in text:
        raise SystemExit(f"{cv.SOURCE}: no '{load}' to replace")
    path = cuda_band.BUILD_DIR / "probes" / "centered_vg_no_band_loads.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(load, "V{}"))
    return path


# Where ``phase_source`` stamps the time: before each anchor (all of a
# block's threads at it first), in order; each phase ends at its stamp
PHASES = (("fill", "  {\n    double* eg = staged(kE, 0, 0);"),
          ("zero", "  for (int o = tid; o < chains * 5; o += nthreads) {"),
          ("params", "  // Barriers: a cluster of one block"),
          ("barrier0", "  // a unit: kRows rows of one state for G chains"),
          ("stage1", "  arrive();\n  {\n    const int first[3] = {0, 1, 2}"),
          ("reduce1", "  // stage 2:"),
          ("stage2", "  arrive();\n  {\n    const int first[1]"),
          ("reduce2", "  // stage 3:"),
          ("stage3", "  sync_all();  // ebar complete"),
          ("barrier3", "  // stage 4:"),
          ("stage4", "  {\n    const int first[3] = {0, 2, 3}"),
          ("reduce4", "  if (rank == 0) {\n    for (int o = tid"),
          ("partials", "  if (rank != 0) return;"))


def phase_source() -> Path:
    """A copy of the kernel's source, under build/, that records the
    device clock (%globaltimer, ns) of each block at the start and at each
    of PHASES (a block barrier first), into a device array that
    ``centered_vg_phases`` copies out: a timing probe."""
    from ..ops import centered_vg as cv, cuda_band

    text = cv.SOURCE.read_text()
    stamp = ("  __syncthreads(); if (threadIdx.x == 0) { unsigned long long t_; "
             "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
             "g_phase_ns[blockIdx.x][K] = t_; }\n")
    head = "  cg::cluster_group cluster = cg::this_cluster();\n"
    if head not in text:
        raise SystemExit(f"{cv.SOURCE}: no '{head.strip()}'")
    text = text.replace(head, head + stamp.replace("[K]", "[0]"), 1)
    pos = 0
    for k, (_, anchor) in enumerate(PHASES, start=1):
        at = text.find(anchor, pos)
        if at < 0:
            raise SystemExit(f"{cv.SOURCE}: no '{anchor}' after the previous phase")
        line = stamp.replace("[K]", f"[{k}]")
        text = text[:at] + line + text[at:]
        pos = at + len(line) + len(anchor)
    text = text.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                        "g_phase_ns[4096][16];\n", 1)
    text += ('\nextern "C" int centered_vg_phases(unsigned long long* out) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_ns, "
             "sizeof(g_phase_ns)));\n}\n")
    path = cuda_band.BUILD_DIR / "probes" / "centered_vg_phases.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def time_probe(case: dict) -> dict:
    """ms per launch of the kernel and of ``probe_source``'s build at
    ``case``, in both dtypes."""
    from ..ops import centered_vg as cv

    lib = cv.load(probe_source())
    out = {}
    for dtype in (torch.float32, torch.float64):
        params = cv.make_params(case["targets"][dtype], case["center"])
        dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device=DEVICE)
        out[str(dtype)[6:]] = dict(
            kernel=graph_ms(lambda: cv.centered_fn_vg_cuda(dpsi, params), COUNT),
            no_band_loads=graph_ms(lambda: cv.launch(lib, dpsi, params), COUNT))
    return out


# Variants of the kernel (``--variants``): a name and the edits of its
# source, each (text, replacement); "g<chains>" caps G (MAX_PER_THREAD)
SOURCE_VARIANTS = {
    # float32 chunks of 4 terms, not 8
    "u4": (("  using type = float2;\n  static constexpr int U = 8;",
            "  using type = float2;\n  static constexpr int U = 4;"),),
}


def variant_source(name: str) -> Path:
    """A copy of the kernel's source, under build/, with the edits of the
    variant ``name`` (its parts joined by "+": SOURCE_VARIANTS' keys)."""
    from ..ops import centered_vg as cv, cuda_band

    text = cv.SOURCE.read_text()
    for part in filter(None, name.split("+")):
        if part == "base" or part.startswith("g"):
            continue
        for old, new in SOURCE_VARIANTS[part]:
            if old not in text:
                raise SystemExit(f"{cv.SOURCE}: variant {part}: no '{old}'")
            text = text.replace(old, new)
    path = cuda_band.BUILD_DIR / "probes" / f"centered_vg_{name.replace('+', '_') or 'base'}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def time_variants(cases: list, names: list) -> dict:
    """Each variant at each case: held to the plain version (float64 rel)
    and to the one-block kernel's x block (bits), and timed per launch in both dtypes."""
    import contextlib
    import re

    from ..ops import centered_vg as cv, cuda_band

    parsed = {}
    for name in names:
        g = re.search(r"(?:^|\+)g(\d+)", name)
        parsed[name] = int(g.group(1)) if g else cv.MAX_PER_THREAD
    sources = {name: variant_source(name) for name in names}
    with ThreadPoolExecutor() as pool:
        list(pool.map(cuda_band.build, sources.values()))

    @contextlib.contextmanager
    def constants(per_thread):
        old = cv.MAX_PER_THREAD
        cv.MAX_PER_THREAD = per_thread
        try:
            yield
        finally:
            cv.MAX_PER_THREAD = old

    out = {}
    for name, per_thread in parsed.items():
        lib = cv.load(sources[name])
        for case in cases:
            row = {}
            for dtype in (torch.float32, torch.float64):
                with constants(per_thread):
                    params = cv.make_params(case["targets"][dtype], case["center"])
                    dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device=DEVICE)
                    got = cv.launch(lib, dpsi, params)
                    base = launch_pr11(dpsi, params)
                    plain = cv.centered_fn_vg_torch(dpsi.double(), params._replace(
                        bands=params.bands.double(), fields=params.fields.double(),
                        scalars=params.scalars.double()))
                    torch.cuda.synchronize()
                    nd = 2 * case["n"]
                    row[str(dtype)[6:]] = dict(
                        ms=graph_ms(lambda: cv.launch(lib, dpsi, params), COUNT),
                        x_bits_pr11=bool(torch.equal(got[1][:, :nd], base[1][:, :nd])),
                        rel_g=_rel(got[1].double(), plain[1]),
                        tiling=tuple(cv.tiling(case["n"], case["bandwidth"], case["chains"])[:6]))
            out[f"{name}:{case['name']}"] = row
            print(f"[variant] {name} {case['name']}: {json.dumps(row)}", flush=True)
    return out


def time_phases(case: dict) -> dict:
    """Per phase, microseconds from the previous stamp, the median and the
    largest over the launch's blocks, float32 and float64, from
    ``phase_source``'s build after warm-up launches."""
    import ctypes

    from ..ops import centered_vg as cv

    lib = cv.load(phase_source())
    out = {}
    for dtype in (torch.float32, torch.float64):
        params = cv.make_params(case["targets"][dtype], case["center"])
        dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device=DEVICE)
        for _ in range(5):
            cv.launch(lib, dpsi, params)
        torch.cuda.synchronize()
        raw = np.zeros((4096, 16), dtype=np.uint64)
        err = lib.centered_vg_phases(ctypes.c_void_p(raw.ctypes.data))
        if err:
            raise RuntimeError(f"centered_vg_phases: CUDA error {err}")
        tile = cv.tiling(case["n"], case["bandwidth"], case["chains"])
        blocks = tile.cluster * tile.clusters
        stamps = raw[:blocks, : len(PHASES) + 1].astype(np.int64)
        row = {}
        for k, (name, _) in enumerate(PHASES, start=1):
            d = (stamps[:, k] - stamps[:, k - 1]) / 1e3
            row[name] = [round(float(np.median(d)), 3), round(float(d.max()), 3)]
        row["first_to_last_us"] = round(float((stamps[:, -1].max() - stamps[:, 0].min()) / 1e3),
                                        3)
        row["start_spread_us"] = round(float((stamps[:, 0].max() - stamps[:, 0].min()) / 1e3), 3)
        out[str(dtype)[6:]] = row
    return out


def repeat_digest(rank: int = 0, calls: int = 300) -> dict:
    """Digests of the kernel route's and the autograd route's value-and-grad
    over ``calls`` calls of [slice]'s target (32 chains: a [mesh] rank's
    batch), replayed from their CUDA graphs and eager: equal digests in
    every process say the route gives the same bits run to run."""
    import hashlib

    from ..inference.whiten import (
        make_centered_whitened_vg_autograd, make_centered_whitened_vg_kernel,
    )
    from ..parallel.chains import GraphedValueAndGrad
    from .workload import fn_bench_workload, slice_likelihood

    y, t = fn_bench_workload()
    lik = slice_likelihood(y, t, 40)
    put = dict(dtype=torch.float32, device=DEVICE)
    cov = lik.cov64.to(**put)
    wh = type(lik.whitener)(*(a.to(**put) for a in lik.whitener))
    target = lik.target(cov, "band")
    z0 = torch.as_tensor(np.random.default_rng(1).normal(size=(32, lik.dimension)) * 0.5, **put)
    out = {}
    for route, make in (("kernel", make_centered_whitened_vg_kernel),
                        ("autograd", make_centered_whitened_vg_autograd)):
        vg = make(target, wh)
        fns = {"graphed": GraphedValueAndGrad(vg, z0), "eager": vg}
        digests = {how: hashlib.sha256() for how in fns}
        for k in range(calls):
            z = z0 * (1 + 0.001 * k)
            for how, f in fns.items():
                for a in f(z):
                    digests[how].update(a.cpu().numpy().tobytes())
        out[route] = {how: h.hexdigest()[:16] for how, h in digests.items()}
    return out


def ptxas_summary(log: str) -> list:
    """(instance, registers, stack frame bytes, spill stores, spill loads)
    per kernel instance of an ``nvcc -Xptxas=-v`` log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = re.sub(r"^_ZN.*centered_vg_kernelI([df])(?:Li(\d+)E)?E.*$", r"\1\2",
                          m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out.append([name, None, *map(int, m.groups())])
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1][1] is None:
            out[-1][1] = int(m.group(1))
    return out


def local_memory(so: Path) -> dict:
    """Local-memory loads and stores (LDL, STL) in each kernel instance's
    SASS (cuobjdump)."""
    import re

    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run([str(cuobjdump if cuobjdump.exists() else "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.sub(r"^_ZN.*centered_vg_kernelI([df])(?:Li(\d+)E)?E.*$", r"\1\2", m.group(1))
            out[fn] = {"LDL": 0, "STL": 0, "instructions": 0}
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            out[fn]["instructions"] += 1
            for op in ("LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    out[fn][op] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--repeat", action="store_true",
                    help="digests of both routes in two worlds of 4 ranks and two lone processes")
    ap.add_argument("--probe", action="store_true",
                    help="time the kernel without its band loads at [slice]'s case")
    ap.add_argument("--variants", default="",
                    help="source variants (SOURCE_VARIANTS' keys joined by '+', "
                         "g<chains> caps G) to time at --variant-cases")
    ap.add_argument("--variant-cases", default="slice,c1")
    ap.add_argument("--phases", default="",
                    help="cases whose per-phase device times to take (phase_source)")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/vg_timing.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vg_timing needs a CUDA card")
    import manifold_constrained_gaussian_process_inference_tpu_torch  # noqa: F401  (TF32 off)
    from ..ops import cuda_band
    from ..ops import centered_vg as cv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    with ThreadPoolExecutor() as pool:  # one nvcc each, at once
        so, _ = pool.map(cuda_band.build, (cv.SOURCE, BASELINE))
    print(f"[ptxas] {ptxas_summary(so.with_suffix('.log').read_text())}; local memory "
          f"{local_memory(so)}", flush=True)
    result = dict(device=smi, cases={})
    covs = {}  # the n = 3169 covariances take ~50 s on the host: build them once
    for name in filter(None, args.cases.split(",")):
        key = CASES[name][1:5] + CASES[name][7:]
        case = make_case(name, covs.get(key))
        covs[key] = case["cov64"]
        row = dict(check=check_case(case))
        for dt in (torch.float32, torch.float64):
            row[str(dt)[6:]] = time_case(case, dt, whole=dt == torch.float32)
        result["cases"][name] = row
        print(f"[{name}] {json.dumps(row)}", flush=True)
    if args.probe:
        result["probe"] = time_probe(make_case("slice"))
        print(f"[probe] ms per launch at [slice]: {json.dumps(result['probe'])}", flush=True)
    if args.variants:
        cases = []
        for name in args.variant_cases.split(","):
            key = CASES[name][1:5] + CASES[name][7:]
            cases.append(make_case(name, covs.get(key)))
            covs[key] = cases[-1]["cov64"]
        result["variants"] = time_variants(cases, args.variants.split(","))
    for name in filter(None, args.phases.split(",")):
        key = CASES[name][1:5] + CASES[name][7:]
        result.setdefault("phases", {})[name] = time_phases(make_case(name, covs.get(key)))
        print(f"[phases] {name}: us per phase [median, max over blocks]: "
              f"{json.dumps(result['phases'][name])}", flush=True)
    if args.repeat:
        from ..parallel.dryrun import run_ranks

        result["repeat"] = {f"world{w}": run_ranks(repeat_digest, 4, threads=2) for w in range(2)}
        result["repeat"].update({f"alone{w}": [repeat_digest()] for w in range(2)})
        digests = {json.dumps(d, sort_keys=True) for ds in result["repeat"].values() for d in ds}
        print(f"[repeat] {json.dumps(result['repeat'])}; one digest per route in every "
              f"process: {len(digests) == 1}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"[done] {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
