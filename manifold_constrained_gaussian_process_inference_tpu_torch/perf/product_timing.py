"""The dense metric's product kernel (csrc/minv_mv.cu, ops/minv_mv.py) on the
card, beside torch.matmul, at the shapes of the whitening GEMMs.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.product_timing \\
        [--probes 1,2,3,4] [--out product_timing.json]

The whitened value-and-grad (inference/whiten.py) runs two GEMMs of the
product's shape around its kernel: dpsi = zeta W^T and g_zeta = g W, each
(C, dim) by (dim, dim); the second is the kernel's product on W^T laid out
row-major. For C in CHAINS and dim in DIMS ([slice]'s 799 and config 4's
1591, n = 793), float32: device ms per call from a replayed CUDA graph of
REPS calls of the kernel and of torch.matmul on the same operands, their
float32 errors against the float64 product, and the bound (2 C dim^2 flop at
67 TFLOP/s or the bytes at 3.35 TB/s, the larger). The whitening keeps
torch.matmul: this times the kernel there, it does not route it.
``--probes`` builds the kernel's measurement copies (``MINV_MV_PROBE`` in
the source: without the DMMAs, the copies, the cluster's reduction, or the
body) and times each beside. Each row also gives how many of the launch's
clusters the card runs at once. Runs on a CUDA card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .tree_graphs import graph_ms

CHAINS = (128, 64, 32, 1)
DIMS = (799, 1591)
REPS = 200
FLOP_PER_MS, BYTES_PER_MS = 67e9, 3.35e9


def main(argv=None) -> int:
    from ..ops import cuda_band, minv_mv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    others = {}  # name -> the f32 entry point of a probe's build
    for probe in filter(None, args.probes.split(",")):
        copy = cuda_band.BUILD_DIR / f"minv_mv_probe{probe}.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(f"#define MINV_MV_PROBE {int(probe)}\n" + minv_mv.SOURCE.read_text())
        fn = ctypes.CDLL(str(cuda_band.build(copy))).minv_mv_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        others[f"probe{probe}"] = fn

    def other(fn, m, z, out):
        stream = torch.cuda.current_stream().cuda_stream
        if fn(m.data_ptr(), z.data_ptr(), out.data_ptr(), z.shape[0], z.shape[1], stream):
            raise RuntimeError("a probe's launch failed")
        return out

    if not torch.cuda.is_available():
        raise SystemExit("product_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    rows = []
    for dim in DIMS:
        rng = np.random.default_rng(dim)
        w = rng.normal(size=(dim, dim)) / np.sqrt(dim)  # a whitener-like factor
        for c in CHAINS:
            x = rng.normal(size=(c, dim))
            want = torch.as_tensor(x) @ torch.as_tensor(w).T
            m, z = (torch.as_tensor(v, dtype=torch.float32, device="cuda") for v in (w, x))
            flop, nbytes = minv_mv.product_work(c, dim, 4)
            row = dict(chains=c, dim=dim, ms=graph_ms(lambda: minv_mv.minv_mv_cuda(m, z), REPS),
                       matmul_ms=graph_ms(lambda: z @ m.T, REPS),
                       bound_ms=max(flop / FLOP_PER_MS, nbytes / BYTES_PER_MS),
                       err=float((minv_mv.minv_mv_cuda(m, z).cpu().double() - want).abs().max()),
                       matmul_err=float(((z @ m.T).cpu().double() - want).abs().max()),
                       split=minv_mv.split(dim), max_clusters=minv_mv.max_clusters(c, dim))
            for name, fn in others.items():
                out = torch.empty_like(z)
                row[f"{name}_ms"] = graph_ms(lambda: other(fn, m, z, out), REPS)
                row[f"{name}_err"] = float((other(fn, m, z, out).cpu().double() - want).abs().max())
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
