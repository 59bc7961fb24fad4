"""Did nvcc's unrolling of the whitened FN kernel's per-row chunk loop change
what the kernel computed? A reproducer on the card, in float64 at
[resume]'s grid (n = 41, b = 20), where a build of the kernel's earlier,
group-templated version once summed rows wrongly, after which its chunk
loop was put under ``#pragma unroll 1``.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.unroll_repro \\
        [--old OLD_SOURCE.cu] [--out chiprun_out/unroll_repro]

``--old`` (default ``perf/baselines/centered_vg_groups.cu``, that earlier
version) is built twice: as written (the chunk loop under the pragma) and
with the pragma removed. The run holds

- ``band_rows`` alone (the minimal reproducer): one block computes the
  stage-1 pair u = mphi dx, v = GC^T dx of [resume]'s operators for one
  chain's dx from shared memory, as the kernel does, in both builds at G = 1
  and 2 and in the shipped kernel's (csrc/centered_vg.cu), held to the
  plain float64 product (``ops/band.band_storage_matvec_torch``) row by
  row;
- the whole kernel of both builds at every G, and the shipped one, at
  [resume]'s case (the shipped one at [slice]'s too) against the plain
  version (``centered_vg.centered_fn_vg_torch``);
- the two builds' SASS (``cuobjdump -sass``, written under ``--out`` with
  instruction counts by opcode per function), compared instance by
  instance with addresses stripped;

and times the earlier version by G at [slice]'s case beside the shipped
kernel, in both dtypes (the measurement that chose one chain a block).
Rows that differ are printed with the term the difference matches (a term
of the row dropped or counted twice), if any. Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

PRAGMA_RE = re.compile(r"#pragma unroll 1\s*//[^\n]*")
OLD_SOURCE = Path(__file__).resolve().parent / "baselines" / "centered_vg_groups.cu"
GROUPS = (1, 2, 4, 8)

HARNESS = r"""
#include "%(source)s"

namespace {
// one block: u, v of the stage-1 pair for one chain's dx, as the kernel
// computes them (dx in shared memory; threads take rows in a fixed stride)
__global__ void __launch_bounds__(512) repro_kernel(const double* mphi, const double* gct,
                                                    const double* dx, double* out, int n, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* X = reinterpret_cast<double*>(smem_raw);
  for (int o = threadIdx.x; o < %(group)d * 4 * n; o += blockDim.x)
    X[o] = o %% (4 * n) < n ? dx[o %% (4 * n)] : 0.0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double* const diag[2] = {mphi + static_cast<size_t>(b) * n,
                                   gct + static_cast<size_t>(b) * n};
    const double* const xs[1] = {X};
    %(call)s
  }
}
}  // namespace

extern "C" int band_rows_repro(const double* mphi, const double* gct, const double* dx,
                               double* out, int n, int b) {
  repro_kernel<<<1, 512, sizeof(double) * %(group)d * 4 * n>>>(mphi, gct, dx, out, n, b);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
"""
CALL_NEW = """double acc[2] = {0.0, 0.0};
    band_rows<double, 2, 1>(diag, xs, i, n, b, acc);
    out[i] = acc[0];
    out[n + i] = acc[1];"""
CALL_OLD = """double acc[2][%(group)d] = {};
    band_rows<double, %(group)d, 2, 1>(diag, xs, 4 * n, i, n, b, acc);
    out[i] = acc[0][0];
    out[n + i] = acc[1][0];"""


def unrolled_copy(source: Path, build_dir: Path) -> Path:
    """``source`` with its chunk loop's ``#pragma unroll 1`` removed."""
    text = source.read_text()
    new = PRAGMA_RE.sub("", text, count=1)
    if new == text:
        raise SystemExit(f"{source}: no '#pragma unroll 1' on the chunk loop")
    path = build_dir / f"{source.stem}_unrolled.cu"
    path.write_text(new)
    return path


def harness(source: Path, build_dir: Path, old: bool, group: int) -> Path:
    call = (CALL_OLD % dict(group=group)) if old else CALL_NEW
    path = build_dir / f"repro_{source.stem}_g{group}.cu"
    path.write_text(HARNESS % dict(source=source.resolve(), call=call, group=group))
    return path


def sass(so: Path, out_dir: Path) -> dict:
    """The library's SASS written beside the results, and its instruction
    counts by opcode per function."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    text = subprocess.run([str(cuobjdump if cuobjdump.exists() else "cuobjdump"), "-sass",
                           str(so)], capture_output=True, text=True, check=True).stdout
    (out_dir / f"{so.stem}.sass").write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            counts[fn][m.group(1).split(".")[0]] += 1
    return {f: dict(c.most_common()) for f, c in counts.items()}


def _explain(row_err: float, terms: np.ndarray) -> str:
    """Which single term of a row the error matches: dropped (-t) or
    counted twice (+t), if any, to 1e-6 relative."""
    for k, t in enumerate(terms):
        for sign, what in ((-1.0, "dropped"), (1.0, "twice")):
            if t != 0 and abs(row_err - sign * t) <= 1e-6 * abs(t):
                return f"term {k} {what}"
    return "no single term"


def run_minimal(lib_path: Path, case: dict) -> dict:
    """band_rows alone against the plain product, row by row, for both
    states' operators: the rows whose difference exceeds 1e-12 of the sum
    of their terms' magnitudes (a summation order's rounding stays far
    below it)."""
    from ..ops.band import band_storage_matvec_torch

    t = case["targets"][torch.float64]
    n, b = case["n"], case["bandwidth"]
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.band_rows_repro.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int]
    rows, worst = [], 0.0
    for d in range(2):
        mphi, gct = t.data.mphi_bs[d].contiguous(), t.data.GCt_bs[d].contiguous()
        dx = torch.as_tensor(case["dpsi"][0, d * n:(d + 1) * n], dtype=torch.float64,
                             device="cuda")
        out = torch.empty(2 * n, dtype=torch.float64, device="cuda")
        err = lib.band_rows_repro(mphi.data_ptr(), gct.data_ptr(), dx.data_ptr(), out.data_ptr(),
                                  n, b)
        if err:
            raise RuntimeError(f"{lib_path.name}: CUDA error {err}")
        got = out.cpu().numpy().reshape(2, n)
        bands = torch.stack([mphi, gct]).cpu()
        want = band_storage_matvec_torch(bands, dx.cpu().expand(2, n), b).numpy()
        bnp, xnp = bands.numpy(), dx.cpu().numpy()
        for j in range(2):
            for i in range(n):
                ks = [k for k in range(-b, b + 1) if 0 <= i + k < n]
                terms = np.array([bnp[j, b + k, i + k] * xnp[i + k] for k in ks])
                diff = float(got[j, i] - want[j, i])
                rel = abs(diff) / max(float(np.abs(terms).sum()), 1e-300)
                worst = max(worst, rel)
                if rel > 1e-12:
                    rows.append(dict(state=d, op=("mphi", "GCt")[j], row=i, diff=diff, rel=rel,
                                     explains=_explain(diff, terms)))
    return dict(max_rel_to_terms=worst, rows_off=rows)


def launch_old(lib, dpsi, p, group: int):
    """The earlier source's entry point, whose integer arguments carried a
    group of G chains a block before their two counts."""
    lp = torch.empty(dpsi.shape[0], dtype=dpsi.dtype, device=dpsi.device)
    g_psi = torch.empty_like(dpsi)
    ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in (dpsi, p.bands, p.fields, p.scalars,
                                                           g_psi, lp)))
    ints = (ctypes.c_longlong * 9)(dpsi.shape[0], p.n, p.bandwidth, dpsi.shape[1],
                                   int(p.sigma_sampled), p.theta_kind, group, 6, 9)
    fn = lib.centered_vg_f32 if dpsi.dtype == torch.float32 else lib.centered_vg_f64
    fn.argtypes = [ctypes.c_void_p] * 3
    err = fn(ptrs, ints, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old kernel: CUDA error {err}")
    return lp, g_psi


def time_groups(lib, case: dict) -> dict:
    """The earlier source's ms per launch by G at ``case``, both dtypes, and
    the shipped kernel's beside them (``vg_timing.graph_ms``)."""
    from ..ops import centered_vg as cv
    from .vg_timing import COUNT, graph_ms

    out = {}
    for dtype in (torch.float32, torch.float64):
        params = cv.make_params(case["targets"][dtype], case["center"])
        dpsi = torch.as_tensor(case["dpsi"], dtype=dtype, device="cuda")
        row = {f"G{g}": graph_ms(lambda g=g: launch_old(lib, dpsi, params, g), COUNT)
               for g in GROUPS}
        row["shipped"] = graph_ms(lambda: cv.centered_fn_vg_cuda(dpsi, params), COUNT)
        out[str(dtype)[6:]] = row
    return out


def run_kernel(lib, case: dict, group: int = 0) -> tuple:
    """The whole kernel in float64 (the earlier source's at ``group``),
    and its error against the plain version, max |difference| over max
    |plain| of lp and of g_psi."""
    from ..ops import centered_vg as cv

    params = cv.make_params(case["targets"][torch.float64], case["center"])
    dpsi = torch.as_tensor(case["dpsi"], dtype=torch.float64, device="cuda")
    got = launch_old(lib, dpsi, params, group) if group else cv.launch(lib, dpsi, params)
    want = cv.centered_fn_vg_torch(dpsi, params)
    torch.cuda.synchronize()
    rel = [float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want)]
    return got, rel


def sass_bodies(text: str) -> dict:
    """Each function's SASS with addresses and encodings stripped."""
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        lines = (re.sub(r"/\*[0-9a-f]+\*/", "", line).strip() for line in body.splitlines())
        out[name] = [re.sub(r"\s+", " ", line) for line in lines
                     if line and not line.startswith("/* 0x")]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, default=OLD_SOURCE,
                    help="the earlier, group-templated source")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/unroll_repro"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unroll_repro needs a CUDA card")
    import manifold_constrained_gaussian_process_inference_tpu_torch  # noqa: F401
    from ..ops import centered_vg as cv, cuda_band
    from .vg_timing import make_case

    args.out.mkdir(parents=True, exist_ok=True)
    build_dir = cuda_band.BUILD_DIR / "repro"
    build_dir.mkdir(parents=True, exist_ok=True)
    cases = dict(resume=make_case("resume"), slice=make_case("slice"))
    old = dict(rolled=args.old, unrolled=unrolled_copy(args.old, build_dir))
    harnesses = {f"{cv.SOURCE.stem}:G1": harness(cv.SOURCE, build_dir, False, 1)}
    for how, src in old.items():
        for g in (1, 2):
            harnesses[f"{args.old.stem}:{how}:G{g}"] = harness(src, build_dir, True, g)
    # every build at once (nvcc, one process each)
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(cuda_band.build, [*harnesses.values(), *old.values(), cv.SOURCE]))
    report = {}
    for key, path in harnesses.items():
        so = cuda_band.build(path)
        report[key] = dict(minimal=run_minimal(so, cases["resume"]), sass=sass(so, args.out))
        print(f"[minimal] {key} {json.dumps(report[key]['minimal'])}", flush=True)
    lib = cv.load(cv.SOURCE)
    for name, case in cases.items():
        _, rel = run_kernel(lib, case)
        report[f"kernel:{name}"] = dict(rel=rel)
        print(f"[kernel] {name}: rel lp, g against the plain version {rel}", flush=True)
    bodies = {}
    for how, src in old.items():
        lib = cv.load(src)
        for g in GROUPS:
            _, rel = run_kernel(lib, cases["resume"], g)
            report[f"old_kernel:{how}:G{g}"] = dict(rel=rel)
            print(f"[old kernel] {how} G={g} resume: rel lp, g {rel}", flush=True)
        if how == "rolled":
            report["old_kernel:ms_by_group"] = time_groups(lib, cases["slice"])
            print(f"[old kernel] ms per launch by G at [slice]: "
                  f"{report['old_kernel:ms_by_group']}", flush=True)
        so = cuda_band.build(src)
        report[f"old_kernel:{how}:sass"] = sass(so, args.out)
        bodies[how] = sass_bodies((args.out / f"{so.stem}.sass").read_text())
    same = [a == b for a, b in zip(bodies["rolled"].values(), bodies["unrolled"].values())]
    report["old_kernel:sass_identical"] = len(same) == len(bodies["rolled"]) and all(same)
    print(f"[old kernel] SASS of every instance identical with and without the pragma: "
          f"{report['old_kernel:sass_identical']}", flush=True)
    (args.out / "report.json").write_text(json.dumps(report, indent=1))
    print(f"[done] {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
