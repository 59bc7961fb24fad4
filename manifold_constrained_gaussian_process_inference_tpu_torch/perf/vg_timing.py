"""The whitened FN value-and-grad's kernel (csrc/centered_vg.cu) on the
card: held to its plain version and to its earlier designs (one block per
chain, ``perf/baselines/centered_vg_pr11.cu``; the cluster with scalar
multiply-adds, ``perf/baselines/centered_vg_pr12.cu``; both built beside it),
timed per launch against its bound, the plain version and those baselines,
and the whole value-and-grad on both routes.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.vg_timing \\
        [--cases slice,c1,chees,mesh,resume,long,long_c1,n793,n793_c1] [--repeat] \\
        [--probe] [--phases slice,resume] [--variants base,s3,n1 --variant-cases slice,c1] \\
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
version and against the scalar cluster kernel, max |difference| over max |other| of
lp and of g_psi, within ``TOL_F64``; the float32 kernel's error against
the float64 plain version at most ``F32_FACTOR`` times the float32 plain
version's own and times the scalar cluster kernel's own; and a chain's bits the same
whatever shares its launch: the launches of SUBSETS' chains against the
rows of the whole launch, in both dtypes. (The DMMAs sum a row's terms in
another order than the earlier designs, so the x block's float32 bits are
not theirs.) Besides: the prepared tiles of the card's preparation
(``centered_vg.prepare_tiles``) bit-equal to its plain version
``prepare_tiles_torch`` in both dtypes, and, where the tiling keeps the
launch within TARGET_BLOCKS blocks (one wave meant), the card's
cudaOccupancyMaxActiveClusters at least the launch's clusters.

Times (``time_case``): device ms per launch from CUDA events around one
replay of a CUDA graph of ``COUNT`` launches, median of ``REPS`` replays,
beside the tiling it ran (``centered_vg.tiling``) and the bytes of
prepared tiles its blocks read from L2 (``tile_bytes``); both baselines
likewise; the plain version likewise (a graph of
``PLAIN_COUNT`` calls); the tiles' preparation (``prepare_ms``) beside its
plain version (eager: it copies its index from the host) and its bytes bound (the storages read and the tiles written
at 3.35 TB/s); the bound, the larger of the bytes at 3.35 TB/s and
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
times the kernel on other tilings: "s<k>" S's limit (k up to WAVE_CLUSTER, the kernel's
largest cluster), "n<k>" the N tiles a cluster (MAX_NTILES), "t<k>" the blocks a launch
(TARGET_BLOCKS), "k<k>" the chain groups' unit (Cg a multiple of k), "r<k>" a block's
rings in KiB (RING_BYTES, in a build with that kRingBytes), each held to the plain
version.
``--repeat`` digests both routes' value-and-grad over 300 calls of a
[mesh] rank's batch in two spawned worlds of four ranks on the card and in
two lone processes (``repeat_digest``): whether a route gives the same bits
run to run and whatever shares the card. ``--probe`` times, at [slice]'s
case, a copy of the kernel whose tiles are never copied (each slot's
mbarrier is only arrived at; ``probe_source``; its outputs are wrong by
design): what the tiles' traffic from L2 costs a launch. Runs on a CUDA
card only.
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
BASELINE_PR12 = Path(__file__).resolve().parent / "baselines" / "centered_vg_pr12.cu"
_BASELINE_LIB = None
_PR12 = {}  # the library; per storages tensor, the tensor and its row-indexed copy


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


# the scalar cluster kernel reads the storages through a row-indexed diagonal copy and
# runs on its own tiling: frozen copies of ops/centered_vg.py's as it was
def pr12_band_diags(bands: torch.Tensor, bandwidth: int) -> torch.Tensor:
    """out[..., b + k, i] = A[i, i + k], terms padded to whole chunks of 8 and
    rows to an even count of at least n + 2, zero outside the grid."""
    b = bandwidth
    *lead, w, n = bands.shape
    flat = bands.reshape(-1, w, n)
    width = n + 2 * b
    padded = torch.nn.functional.pad(flat, (b, b)).contiguous()
    by_row = padded.as_strided((flat.shape[0], w, n), (w * width, width + 1, 1))
    terms, cols = 8 * (-(-(2 * b + 1) // 8)), 2 * (-(-(n + 2) // 2))
    out = torch.zeros((flat.shape[0], terms, cols), dtype=bands.dtype, device=bands.device)
    out[:, :w, :n] = by_row
    return out.reshape(*lead, terms, cols)


def pr12_tiling(n: int, b: int, c: int) -> tuple:
    """(S, L, Cg, G, split, threads, shared bytes) of the scalar cluster kernel's launch."""
    cdiv = lambda a, d: -(-a // d)  # noqa: E731
    s = 1
    while 2 * s <= 16 and n // (2 * s) >= max(b, 32) and (2 * s - 1) * 2 * cdiv(n, 4 * s) < n:
        s *= 2
    slab = cdiv(n, s) if s == 1 else 2 * cdiv(n, 2 * s)
    groups = cdiv(slab, 2)
    per_chain = 8 * (8 + 8 + 4 * groups + 3 * 2 * (groups * 2 + 2 * b))
    cg = max(1, min(cdiv(c * s, 128), 232448 // per_chain, c))
    if cg > 8:
        cg -= cg % 8
    g = next((g for g in (8, 4, 2) if cg % g == 0 and 2 * groups * (cg // g) >= 96), 1)
    units = 2 * 32 * cdiv(groups, 32) * (cg // g)
    split = cg == 1 and 2 * units <= 256
    units *= 2 if split else 1
    threads = 32 * cdiv(cdiv(units, cdiv(units, 256)), 32)
    return s, slab, cg, g, split, threads, cg * per_chain


def launch_pr12(dpsi, p):
    """(lp, g_psi) of the scalar cluster kernel on the current stream."""
    import ctypes

    from ..ops import centered_vg as cv

    if "lib" not in _PR12:
        _PR12["lib"] = cv.load(BASELINE_PR12)
    # keyed by address, the storages kept alive beside their copy: a freed
    # tensor's address may come back holding another case's storages
    key = (p.bands.data_ptr(), p.bands.dtype)
    if key not in _PR12 or _PR12[key][0] is not p.bands:
        _PR12[key] = (p.bands, pr12_band_diags(p.bands, p.bandwidth))
    c, dim = dpsi.shape
    g_psi, lp = torch.empty_like(dpsi), torch.empty(c, dtype=dpsi.dtype, device=dpsi.device)
    tensors = (dpsi, _PR12[key][1], p.fields, p.scalars, g_psi, lp)  # its VgArgs' order
    ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in tensors))
    s, slab, cg, g, split, threads, shared = pr12_tiling(p.n, p.bandwidth, c)
    ints = (ctypes.c_longlong * 15)(c, p.n, p.bandwidth, dim, int(p.sigma_sampled), p.theta_kind,
                                    s, slab, cg, g, int(split), threads, shared, 6, 15)
    fn = getattr(_PR12["lib"], f"{cv.NAME}_{'f64' if dpsi.dtype == torch.float64 else 'f32'}")
    err = fn(ptrs, ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the scalar cluster kernel: launch failed: CUDA error {err}")
    return lp, g_psi


def tile_bytes(n: int, b: int, c: int, itemsize: int) -> int:
    """Bytes of prepared tiles one launch's blocks copy from L2: every block
    its slab's row tiles, both states, six operators, each a window's k
    steps of FRAG_ELEMS values of ``itemsize`` bytes, in every cluster."""
    from ..ops import centered_vg as cv

    t = cv.tiling(n, b, c)
    tiles = sum(-(-(hi - lo) // cv.TILE_ROWS) for lo, hi in t.slabs)
    return (t.clusters * tiles * len(cv.BANDS) * cv.N_DIMS * cv.ksteps(b) * cv.FRAG_ELEMS
            * itemsize)


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
    for dt in (f64, f32):  # the card's preparation against its plain version
        got = params[dt].tiles
        assert got.is_cuda and torch.equal(got, cv.prepare_tiles_torch(params[dt].bands,
                                                                       params[dt].bandwidth)), \
            f"{case['name']} {dt}: the prepared tiles differ from prepare_tiles_torch's"
    out["prepare_equal"] = True
    tile = cv.tiling(case["n"], case["bandwidth"], case["chains"])
    out["clusters"] = tile.clusters
    out["active_clusters"] = cv.max_clusters(cv._library(), cv._ints(
        case["chains"], case["dim"], params[f32], tile), False)
    if tile.cluster * tile.clusters <= cv.TARGET_BLOCKS:
        assert out["active_clusters"] >= tile.clusters, (
            f"{case['name']}: the card runs {out['active_clusters']} clusters of {tile} at once, "
            f"fewer than the launch's {tile.clusters}")
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
        # against the scalar cluster kernel: float64 to rounding, float32 as accurate
        base = launch_pr12(dpsi[dt], params[dt])
        torch.cuda.synchronize()
        for what, k, b, r in zip(("lp", "g"), kern, base, ref):
            if dt == f64:
                e12 = _rel(k, b)
                out[f"{what}_rel_pr12_float64"] = e12
                assert e12 <= TOL_F64, (f"{case['name']} float64 {what}: rel {e12:.3e} to the scalar "
                                        f"kernel > {TOL_F64}")
            else:
                ek, e12 = _rel(k.double(), r), _rel(b.double(), r)
                out[f"{what}_float32_pr12"] = e12
                assert ek <= F32_FACTOR * e12, (
                    f"{case['name']} float32 {what}: kernel rel {ek:.3e} > {F32_FACTOR} x PR "
                    f"12's kernel's {e12:.3e}")
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


def eager_ms(fn, count: int, reps: int = REPS) -> float:
    """ms per call of ``count`` eager calls between CUDA events, median of
    ``reps`` (for a function that copies from the host, which a graph
    cannot capture)."""
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
    out["tiling"]["ring_slots"] = cv.ring_slots(tile.slab, case["bandwidth"], tile.chains)
    out["tile_bytes"] = tile_bytes(case["n"], case["bandwidth"], case["chains"], dtype.itemsize)
    out["ms"] = graph_ms(lambda: cv.centered_fn_vg_cuda(dpsi, params), COUNT)
    launch_pr12(dpsi, params)  # its row-indexed copy, made outside the graph
    out["pr12_ms"] = graph_ms(lambda: launch_pr12(dpsi, params), COUNT)
    out["pr11_ms"] = graph_ms(lambda: launch_pr11(dpsi, params), COUNT)
    out["active_clusters"] = cv.max_clusters(cv._library(), cv._ints(
        case["chains"], case["dim"], params, tile), dtype == torch.float64)
    out["plain_ms"] = graph_ms(lambda: cv.centered_fn_vg_torch(dpsi, params), PLAIN_COUNT)
    out["prepare_ms"] = graph_ms(lambda: cv.prepare_tiles(params.bands, params.bandwidth),
                                 PLAIN_COUNT)
    out["prepare_plain_ms"] = eager_ms(
        lambda: cv.prepare_tiles_torch(params.bands, params.bandwidth), PLAIN_COUNT)
    moved = dtype.itemsize * (params.bands.numel() + params.tiles.numel())
    out["prepare_bound_ms"] = 1e3 * moved / HBM_BYTES_PER_S
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
    """A copy of the kernel's source, under build/, whose prepared tiles
    are never copied (each slot's mbarrier is arrived at without a
    transaction): a timing probe, not a kernel."""
    from ..ops import centered_vg as cv, cuda_band

    text = cv.SOURCE.read_text()
    start = text.index("__device__ __forceinline__ void stage_copy(")
    body = text.index("{", start)
    end = text.index("\n}\n", body)
    probe = ('{\n  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");\n'
             "  (void)dst, (void)src, (void)bytes;")
    path = cuda_band.BUILD_DIR / "probes" / "centered_vg_no_tile_copies.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text[:body] + probe + text[end:])
    return path


# Where ``phase_source`` stamps the time: before each anchor (all of a
# block's threads at it first), in order; each phase ends at its stamp
PHASES = (("ring", "  const T* s = a.scalars;"),
          ("fill", "  {\n    double* eg = staged(kE, 0, 0);"),
          ("zero", "  for (int o = tid; o < chains * 5; o += nthreads) {"),
          ("params", "  // Barriers: a cluster of one block"),
          ("barrier0", "  // A lane's outputs of an item"),
          ("stage1", "  arrive();\n  {\n    const int first[3] = {0, 1, 2}"),
          ("reduce1", "  // stage 2:"),
          ("stage2", "  arrive();\n  {\n    const int first[1]"),
          ("reduce2", "  // stage 3:"),
          ("stage3", "  sync_all();  // ebar complete"),
          ("barrier3", "  // stage 4:"),
          ("stage4", "  {\n    const int first[3] = {0, 2, 3}"),
          ("reduce4", "  // every block's sums into rank 0's gathered sums"),
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
            no_tile_copies=graph_ms(lambda: cv.launch(lib, dpsi, params), COUNT))
    return out


# Variants of the kernel (``--variants``): its tiling with a constant of
# ops/centered_vg.py capped, "n<k>" MAX_NTILES, "t<k>" TARGET_BLOCKS, "k<k>"
# the chain groups' unit (CHAIN_TILE in ``tiling`` alone: Cg a multiple of
# k, the kernel's N tile still 8), or
# "s<k>" S's limit (``cluster_size`` with k for WAVE_CLUSTER, k at most
# WAVE_CLUSTER: the kernel's shared memory holds that many blocks' sums),
# or "r<k>" a block's rings at most k KiB (RING_BYTES, in a build of the
# source with its kRingBytes so: ``ring_source``), joined by "+"; "base" the
# tiling as it is
VARIANT_CAPS = {"n": "MAX_NTILES", "t": "TARGET_BLOCKS", "k": "CHAIN_TILE"}


def ring_source(ring_bytes: int) -> Path:
    """A copy of the kernel's source, under build/, whose blocks' rings
    hold at most ``ring_bytes`` (kRingBytes)."""
    from ..ops import centered_vg as cv, cuda_band

    text = cv.SOURCE.read_text()
    old = f"constexpr int kRingBytes = {cv.RING_BYTES};"
    if old not in text:
        raise SystemExit(f"{cv.SOURCE}: no '{old}'")
    path = cuda_band.BUILD_DIR / "probes" / f"centered_vg_ring{ring_bytes}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text.replace(old, f"constexpr int kRingBytes = {ring_bytes};"))
    return path


def time_variants(cases: list, names: list) -> dict:
    """Each variant at each case: held to the plain version (float64 rel)
    and timed per launch in both dtypes, beside its tiling."""
    from ..ops import centered_vg as cv

    real_size = cv.cluster_size

    def capped_size(k):
        if not 1 <= k <= cv.WAVE_CLUSTER:
            raise SystemExit(f"--variants s{k}: S's limit runs from 1 to {cv.WAVE_CLUSTER}")

        def size(n, bandwidth):
            tiles = -(-n // cv.TILE_ROWS)
            return real_size(n, bandwidth) if 2 * tiles <= cv.MAX_WARPS else -(-tiles // -(-tiles // k))
        return size

    @contextlib.contextmanager
    def constants(name):
        parts = [part for part in name.split("+") if part != "base"]
        caps = {VARIANT_CAPS[part[0]]: int(part[1:]) for part in parts if part[0] in VARIANT_CAPS}
        caps.update({"RING_BYTES": 1024 * int(part[1:]) for part in parts if part[0] == "r"})
        caps.update({"cluster_size": capped_size(int(part[1:])) for part in parts
                     if part[0] == "s"})
        old = {k: getattr(cv, k) for k in caps}
        for k, v in caps.items():
            setattr(cv, k, v)
        try:
            yield
        finally:
            for k, v in old.items():
                setattr(cv, k, v)

    out = {}
    for name in names:
        rings = [1024 * int(part[1:]) for part in name.split("+") if part[0] == "r"]
        lib = cv.load(ring_source(rings[0])) if rings else cv._library()
        for case in cases:
            row = {}
            for dtype in (torch.float32, torch.float64):
                with constants(name):
                    params = cv.make_params(case["targets"][dtype], case["center"])
                    dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device=DEVICE)
                    got = cv.launch(lib, dpsi, params)
                    plain = cv.centered_fn_vg_torch(dpsi.double(), params._replace(
                        bands=params.bands.double(), fields=params.fields.double(),
                        scalars=params.scalars.double()))
                    torch.cuda.synchronize()
                    tile = cv.tiling(case["n"], case["bandwidth"], case["chains"])
                    row[str(dtype)[6:]] = dict(
                        ms=graph_ms(lambda: cv.launch(lib, dpsi, params), COUNT),
                        rel_g=_rel(got[1].double(), plain[1]),
                        tiling=[tile.cluster, tile.slab, tile.chains, tile.clusters, tile.threads,
                                cv.ring_slots(tile.slab, case["bandwidth"], tile.chains)],
                        tile_bytes=tile_bytes(case["n"], case["bandwidth"], case["chains"],
                                              dtype.itemsize))
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
                    help="time the kernel without its tile copies at [slice]'s case")
    ap.add_argument("--variants", default="",
                    help="tilings to time at --variant-cases: 's<k>' S's limit (k up to "
                         "WAVE_CLUSTER), 'n<k>' the N tiles a cluster, 't<k>' the blocks, 'k<k>' "
                         "the chain groups' unit, 'r<k>' a block's rings in KiB, joined by '+'; "
                         "'base' as it is")
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
        so, _, _ = pool.map(cuda_band.build, (cv.SOURCE, BASELINE, BASELINE_PR12))
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
