"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's production path (``solve_magi`` on the FitzHugh-Nagumo
bench workload: n=397, D=2, 128 NUTS chains under a pooled dense metric,
exact-Hessian whitening, mode-centered float32 evaluation) with the
likelihood on the band-storage layout, so every gradient evaluation runs
the hand-written CUDA band-matvec kernel (forward and backward). Phases:

1. device: the card's name and power limit; TF32 must be off;
2. build: compile the kernel from csrc/ with nvcc;
3. kernel: the kernel against its plain PyTorch twin at the main path's
   shapes and at edge shapes, float64 and float32, forward and backward,
   with CUDA-event timings;
4. likelihood: the whitened centered value-and-grad on the card, band
   against dense in float32, both against a float64 CPU evaluation;
5. slice: ``solve_magi`` end to end; draws finite, recovery within the
   bars, and the kernel launched by the main path.

Each phase prints one line; a failed check exits non-zero. The last line is
``{"ok": true, "device": {...}}``. There is no CPU branch: without a CUDA
device the script raises.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 42
N_CHAINS = 128
# 400 warmup + 400 draws per chain: at ~0.8 ms per batched leapfrog step
# (value-and-grad replayed from a CUDA graph) and ~600 batched steps per
# iteration, ~400 s of sampling, half the script's time limit (PERF.md).
NITER_HMC = 800
MAIN_BANDSIZE = 40  # the band after escalation on this workload (20 -> 40)
THETA_TRUE = np.array([0.2, 0.2, 3.0])
SIGMA_TRUE = 0.2
KERNEL_SOURCE = "manifold_constrained_gaussian_process_inference_tpu_torch/csrc/band_matvec.cu"
KERNEL_REPLACES = "manifold_constrained_gaussian_process_inference_tpu/ops/pallas_band.py:52"
# Tolerances: float64 agrees to rounding; float32 sums run in another order.
TOL_F64, TOL_F32 = 1e-12, 1e-5
TOL_VALUE, TOL_GRAD = 1e-4, 1e-3
THETA_RMSE_MAX, SIGMA_RMSE_MAX, RHAT_MAX = 0.2, 0.05, 1.05


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, n_runs: int = 50) -> float:
    """Median of ``n_runs`` CUDA-event timings of fn(), after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def build_workload(mt, n_obs=100, t_end=20.0, fill=2, seed=SEED):
    """bench.py's workload, generated with the port's integrators: FN at
    the true theta, 100 noisy observations on [0, 20] (noise sd 0.2), on a
    filllevel-2 grid (n = 397)."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.utils.integrators import (
        integrate_system, sample_on_grid,
    )

    rng = np.random.default_rng(seed)
    ts, xs = integrate_system(mt.FN_SYSTEM, [-1.0, 1.0], 0.0, t_end, THETA_TRUE, 4000)
    t_obs = np.linspace(0.0, t_end, n_obs)
    y_at_obs = sample_on_grid(ts.numpy(), xs.numpy(), t_obs) + SIGMA_TRUE * rng.normal(
        size=(n_obs, 2)
    )
    ins = 2**fill - 1
    segs = [np.linspace(t_obs[i], t_obs[i + 1], ins + 2)[:-1] for i in range(n_obs - 1)]
    t_grid = np.concatenate(segs + [t_obs[-1:]])
    y_grid = np.full((len(t_grid), 2), np.nan)
    y_grid[:: ins + 1] = y_at_obs
    return y_grid, t_grid


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on")
    check(torch.get_float32_matmul_precision() == "highest", "float32 matmul precision")
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off", flush=True)
    return smi


def phase_build(cb):
    t0 = time.perf_counter()
    so = cb.build()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s", flush=True)


def _kernel_case(cb, twin, c, m, b, n, dtype, rng, timed=False):
    """Kernel against twin, forward and backward, on one shape."""
    dev = "cuda"
    bands = torch.as_tensor(rng.normal(size=(m, 2 * b + 1, n)), dtype=dtype, device=dev)
    bands_t = torch.as_tensor(rng.normal(size=(m, 2 * b + 1, n)), dtype=dtype, device=dev)
    x = torch.as_tensor(rng.normal(size=(c, m, n)), dtype=dtype, device=dev)
    g = torch.as_tensor(rng.normal(size=(c, m, n)), dtype=dtype, device=dev)
    xr = x.clone().requires_grad_(True)
    y = cb.band_matvec(bands, bands_t, xr, b)
    (gx,) = torch.autograd.grad(y, xr, g)
    torch.cuda.synchronize()
    y_ref = twin(bands, x, b)
    gx_ref = twin(bands_t, g, b)
    y, gx = y.detach(), gx.detach()
    err = max(float((y - y_ref).abs().max()), float((gx - gx_ref).abs().max()))
    rel = max(float((y - y_ref).abs().max() / y_ref.abs().max().clamp(min=1e-300)),
              float((gx - gx_ref).abs().max() / gx_ref.abs().max().clamp(min=1e-300)))
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    check(rel <= tol, f"kernel vs twin at {(c, m, b, n)} {dtype}: rel {rel:.3e} > {tol}")
    times = {}
    if timed:
        xg = x.clone().requires_grad_(True)

        def fwd_bwd_kernel():
            torch.autograd.grad(cb.band_matvec(bands, bands_t, xg, b), xg, g)

        def fwd_bwd_twin():
            torch.autograd.grad(twin(bands, xg, b), xg, g)

        times = dict(
            ms=cuda_ms(lambda: cb.band_matvec_cuda(bands, x, b)),
            plain_ms=cuda_ms(lambda: twin(bands, x, b)),
            fwd_bwd_ms=cuda_ms(fwd_bwd_kernel),
            plain_fwd_bwd_ms=cuda_ms(fwd_bwd_twin),
        )
    return err, rel, times


def phase_kernel(cb, twin):
    rng = np.random.default_rng(0)
    bandsize = MAIN_BANDSIZE
    main = (N_CHAINS, 2, bandsize, 397)
    edges = [(3, 2, 5, 7), (2, 3, 0, 130), (4, 2, 3, 129), (1, 2, 64, 200), (5, 2, 40, 50)]
    worst = {}
    for shape in [main] + edges:
        for dtype in (torch.float64, torch.float32):
            _, rel, _ = _kernel_case(cb, twin, *shape, dtype, rng)
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
    err, rel, times = _kernel_case(cb, twin, *main, torch.float32, rng, timed=True)
    # the (M, n) form of the parity API
    x2 = torch.as_tensor(rng.normal(size=(2, 397)), dtype=torch.float64, device="cuda")
    bs2 = torch.as_tensor(rng.normal(size=(2, 2 * bandsize + 1, 397)), device="cuda")
    rel2 = float((cb.band_matvec_cuda(bs2, x2, bandsize) - twin(bs2, x2, bandsize)).abs().max()
                 / twin(bs2, x2, bandsize).abs().max())
    check(rel2 <= TOL_F64, f"kernel (M, n) form: rel {rel2:.3e}")
    print(f"[kernel] main shape (C,M,b,n)={main} float32 fwd+bwd max abs err {err:.3e} "
          f"(rel {rel:.3e}); worst rel over {1 + len(edges)} shapes: float64 "
          f"{worst[torch.float64]:.3e} (tol {TOL_F64}), float32 {worst[torch.float32]:.3e} "
          f"(tol {TOL_F32}); fwd kernel {times['ms']:.4f} ms vs twin {times['plain_ms']:.4f} ms; "
          f"fwd+bwd kernel {times['fwd_bwd_ms']:.4f} ms vs twin "
          f"{times['plain_fwd_bwd_ms']:.4f} ms (CUDA events, median of 50)", flush=True)
    return err, times


def phase_likelihood(mt, y, t):
    """Whitened, mode-centered value-and-grad on the card, band vs dense in
    float32, both against float64 on the CPU, at one batch of C zetas."""
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.target import MagiTarget
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.transforms import (
        make_theta_transform, unconstrain,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.whiten import (
        build_psi_whitener, make_centered_whitened_vg,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.inference.solve import (
        _init_x_interpolation,
    )
    from manifold_constrained_gaussian_process_inference_tpu_torch.parallel.chains import (
        GraphedValueAndGrad,
    )

    cov64 = mt.build_gp_cov("matern52", np.array([[2.0, 2.0], [1.5, 1.5]]), t,
                            bandsize=MAIN_BANDSIZE)
    tr = make_theta_transform(mt.FN_SYSTEM.theta_lower_bound, mt.FN_SYSTEM.theta_upper_bound)
    sigma0 = np.array([SIGMA_TRUE, SIGMA_TRUE])

    def target(cov, impl):
        return MagiTarget.build(y, cov, mt.FN_SYSTEM, sigma0, (1.0, 1.0, 1.0), False,
                                band_impl=impl, theta_transform=tr)

    x0 = _init_x_interpolation(y, t)
    center = np.concatenate([x0.T.reshape(-1), unconstrain(tr, THETA_TRUE), np.log(sigma0)])
    t64 = target(cov64, "dense")
    wh = build_psi_whitener(cov64, y, t64, center, (1.0, 1.0, 1.0), torch.float64)
    zeta = np.random.default_rng(1).normal(size=(N_CHAINS, t64.dimension)) * 0.5
    v64, g64 = make_centered_whitened_vg(t64, wh)(torch.as_tensor(zeta))
    v64, g64 = v64.numpy(), g64.numpy()
    cov32 = cov64.to(dtype=torch.float32, device="cuda")
    wh32 = type(wh)(*(a.to(dtype=torch.float32, device="cuda") for a in wh))
    zeta32 = torch.as_tensor(zeta, dtype=torch.float32, device="cuda")
    out, rates, vals = {}, {}, {}
    for impl in ("band", "dense"):
        vg = make_centered_whitened_vg(target(cov32, impl), wh32)
        vals[impl] = vg(zeta32)
        torch.cuda.synchronize()
        v, g = (a.double().cpu().numpy() for a in vals[impl])
        check(np.isfinite(v).all() and np.isfinite(g).all(), f"{impl}: non-finite")
        out[impl] = (float(np.max(np.abs(v - v64) / np.abs(v64))),
                     float(np.max(np.abs(g - g64)) / np.max(np.abs(g64))))
        graphed = GraphedValueAndGrad(vg, zeta32)
        rates[impl] = tuple(1e3 * N_CHAINS / cuda_ms(lambda: f(zeta32), 20)
                            for f in (vg, graphed))
    (vb, gb), (vd, gd) = vals["band"], vals["dense"]
    band_vs_dense = (float(((vb - vd).abs() / vd.abs()).max()),
                     float((gb - gd).abs().max() / gd.abs().max()))
    for impl, (ev, eg) in out.items():
        check(ev <= TOL_VALUE, f"{impl} value rel err {ev:.3e} > {TOL_VALUE}")
        check(eg <= TOL_GRAD, f"{impl} grad err {eg:.3e} > {TOL_GRAD} of max |grad|")
    check(band_vs_dense[0] <= TOL_VALUE and band_vs_dense[1] <= TOL_GRAD, "band vs dense")
    print(f"[likelihood] C={N_CHAINS} dim={t64.dimension} bandsize={cov64.bandsize} float32 vs "
          f"float64 CPU: band value rel {out['band'][0]:.3e} grad {out['band'][1]:.3e}; dense "
          f"value rel {out['dense'][0]:.3e} grad {out['dense'][1]:.3e}; band vs dense value "
          f"{band_vs_dense[0]:.3e} grad {band_vs_dense[1]:.3e}; value-and-grad evals/s "
          f"(chains x calls) eager / CUDA-graph replay: band {rates['band'][0]:.0f} / "
          f"{rates['band'][1]:.0f}, dense {rates['dense'][0]:.0f} / {rates['dense'][1]:.0f}",
          flush=True)


def phase_slice(mt, cb, y, t):
    from manifold_constrained_gaussian_process_inference_tpu_torch.postprocess.diagnostics import (
        ess, split_rhat,
    )

    config = mt.MagiConfig(
        niter_hmc=NITER_HMC, burnin_ratio=0.5, step_size_factor=0.06,
        prior_temperature=(1.0, 1.0, 1.0), sampler="nuts", n_chains=N_CHAINS,
        mass_matrix="dense-pooled", chain_init_jitter=0.05, x_whitened=True,
        theta_constrained=True, target_accept_ratio=0.95, step_jitter=0.125,
        seed=SEED, chunk_size=250, band_impl="band", device="cuda", verbose=True,
    )
    cb.LAUNCHES = 0
    t0 = time.perf_counter()
    res = mt.solve_magi(y, t, mt.FN_SYSTEM, config)
    wall = time.perf_counter() - t0
    launches = cb.LAUNCHES
    d = res.diagnostics
    tpc = d["theta_per_chain"]
    ess_min = min(ess(tpc[:, :, j]) for j in range(tpc.shape[-1]))
    rhat_max = max(split_rhat(tpc[:, :, j]) for j in range(tpc.shape[-1]))
    theta_rmse = float(np.sqrt(np.mean((res.theta.mean(0) - THETA_TRUE) ** 2)))
    sigma_rmse = float(np.sqrt(np.mean((res.sigma.mean(0) - SIGMA_TRUE) ** 2)))
    pt = d["phase_times_s"]
    nuts_s = pt["warmup_s"] + pt["sampling_s"]
    device_evals = d["lockstep_leaves"] * N_CHAINS
    print(f"[slice] niter_hmc={NITER_HMC} chains={N_CHAINS} band_impl={d['band_impl']} "
          f"bandsize={d['bandsize']} dtype={d['dtype']}; wall {wall:.1f} s: nlml "
          f"{pt['nlml_s']:.2f} s, gn_map {pt['gn_map_s']:.2f} s, hessian+whitener "
          f"{pt['whitener_s']:.2f} s, warmup {pt['warmup_s']:.2f} s, sampling "
          f"{pt['sampling_s']:.2f} s; batched value-and-grad evals/s "
          f"{device_evals / nuts_s:.0f} (useful sampling leapfrogs/s "
          f"{d['gradient_evals'] / pt['sampling_s']:.0f}); host syncs/transition "
          f"{d['host_syncs'] / d['transitions']:.2f}; min-theta ESS {ess_min:.1f}, ESS/s "
          f"{ess_min / wall:.3f} (total wall); max R-hat {rhat_max:.4f}; theta mean "
          f"{np.round(res.theta.mean(0), 4).tolist()} RMSE {theta_rmse:.4f}; sigma RMSE "
          f"{sigma_rmse:.4f}; divergences {d['n_divergent']}; band kernel launches "
          f"{launches}", flush=True)
    for name in ("theta", "x_sampled", "sigma", "lp"):
        check(np.isfinite(getattr(res, name)).all(), f"non-finite {name}")
    check(res.x_sampled.shape == (N_CHAINS * (NITER_HMC // 2), 397, 2), "x_sampled shape")
    check(d["band_impl"] == "band", f"band_impl {d['band_impl']}")
    check(d["bandsize"] == MAIN_BANDSIZE, f"bandsize {d['bandsize']} != {MAIN_BANDSIZE}")
    check(launches > 0, "the main path never launched the band kernel")
    check(theta_rmse <= THETA_RMSE_MAX, f"theta RMSE {theta_rmse:.4f}")
    check(sigma_rmse <= SIGMA_RMSE_MAX, f"sigma RMSE {sigma_rmse:.4f}")
    check(rhat_max <= RHAT_MAX, f"max R-hat {rhat_max:.4f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    import manifold_constrained_gaussian_process_inference_tpu_torch as mt
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops import cuda_band as cb
    from manifold_constrained_gaussian_process_inference_tpu_torch.ops.band import (
        band_storage_matvec_torch,
    )

    smi = phase_device()
    phase_build(cb)
    y, t = build_workload(mt)
    phase_likelihood(mt, y, t)
    err, times = phase_kernel(cb, band_storage_matvec_torch)
    launches = phase_slice(mt, cb, y, t)
    print(json.dumps({"kernels": [{
        "name": "band_matvec", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[FAIL] {e}", file=sys.stderr, flush=True)
        sys.exit(1)
