"""The dense metric's product kernel (csrc/minv_mv.cu, ops/minv_mv.py) on the
card, beside torch.matmul and the kernel's first design, at the shapes of the
leaf and of the whitening GEMMs.

    python3 -m manifold_constrained_gaussian_process_inference_tpu_torch.perf.product_timing \\
        [--probes 1,2,3,4,5,6] [--rounds 2] [--chains 128,64,32,1] [--dims 799,1591] \\
        [--out product_timing.json]

The whitened value-and-grad (inference/whiten.py) runs two GEMMs of the
product's shape around its kernel: dpsi = zeta W^T and g_zeta = g W, each
(C, dim) by (dim, dim); the second is the kernel's product on W^T. For C in
``--chains`` and dim in ``--dims`` ([slice]'s 799 and config 4's 1591, n =
793), float32: device ms per call from a replayed CUDA graph of REPS calls
of the kernel (on its prepared operand, ``minv_mv.product``), of the first
design's kernel (``perf/baselines/minv_mv_pr13.cu``, built beside it) and of
torch.matmul on the same operands, in turns (kernel, first design, matmul, then
the other way round, ``--rounds`` times); their float32 errors against the
float64 product; the kernel's float64 error relative to the largest
output; whether a chain's bits at C = 1, 3 and 32 equal its rows of the
launch's (C = 128 rows); the bound (2 C dim^2 flop at 67 TFLOP/s or the
bytes at 3.35 TB/s, the larger); the chain tile and how many of the
launch's clusters the card runs at once. Per dim the preparation
(``minv_mv.prepare``, one launch a metric) is timed alike, beside its bytes
bound, and held bit for bit to its plain version ``prepare_torch``.
``--probes`` builds the kernel's measurement copies (``MINV_MV_PROBE`` in
the source: without the DMMAs, the copies, the cluster's reduction, or the
body, the g loads, the conversions) and times each beside. Runs on a
CUDA card only.
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
SUBSETS = ((5,), (7, 8, 9), tuple(range(32, 64)))
REPS = 200
FLOP_PER_MS, BYTES_PER_MS = 67e9, 3.35e9
BASELINE = Path(__file__).resolve().parent / "baselines" / "minv_mv_pr13.cu"


def _entry(path: Path, name: str):
    """The f32 product entry point of a build of ``path``: (a, g, out, C,
    dim, stream), ``a`` minv (the first design) or a prepared operand."""
    from ..ops import cuda_band

    fn = getattr(ctypes.CDLL(str(cuda_band.build(path))), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, a, z, out):
    stream = torch.cuda.current_stream().cuda_stream
    if fn(a.data_ptr(), z.data_ptr(), out.data_ptr(), z.shape[0], z.shape[1], stream):
        raise RuntimeError("a timed build's launch failed")
    return out


def main(argv=None) -> int:
    from ..ops import cuda_band, minv_mv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", default="")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--chains", default=",".join(map(str, CHAINS)))
    ap.add_argument("--dims", default=",".join(map(str, DIMS)))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("product_timing: no CUDA device")
    probes = {}  # name -> the f32 entry point of a probe's build
    for probe in filter(None, args.probes.split(",")):
        copy = cuda_band.BUILD_DIR / f"minv_mv_probe{probe}.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(f"#define MINV_MV_PROBE {int(probe)}\n" + minv_mv.SOURCE.read_text())
        probes[f"probe{probe}"] = _entry(copy, "minv_mv_f32")
    pr13 = _entry(BASELINE, "minv_mv_f32")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    rows, preps = [], []
    for dim in map(int, args.dims.split(",")):
        rng = np.random.default_rng(dim)
        w = rng.normal(size=(dim, dim)) / np.sqrt(dim)  # a whitener-like factor
        m = torch.as_tensor(w, dtype=torch.float32, device="cuda")
        m64 = torch.as_tensor(w, device="cuda")
        prep = minv_mv.prepare(m)
        plain_prep = minv_mv.prepare_torch(m)
        steps = -(-dim // minv_mv.STEP)
        preps.append(dict(
            dim=dim, ms=graph_ms(lambda: minv_mv.prepare(m, prep), REPS),
            plain_ms=graph_ms(lambda: minv_mv.prepare_torch(m), REPS),
            bound_ms=(4 * dim * dim + 8 * minv_mv.prepared_size(dim)) / BYTES_PER_MS,
            bits_equal_plain=bool(torch.equal(prep, plain_prep)),
            transposed_bits_equal_plain=bool(torch.equal(
                minv_mv.prepare(m.T), minv_mv.prepare_torch(m.T))), blocks=steps * steps))
        print(json.dumps(dict(prepare=preps[-1])), flush=True)
        prep64 = minv_mv.prepare(m64)
        for c in map(int, args.chains.split(",")):
            x = rng.normal(size=(c, dim))
            want = torch.as_tensor(x) @ torch.as_tensor(w).T
            z = torch.as_tensor(x, dtype=torch.float32, device="cuda")
            z64 = torch.as_tensor(x, device="cuda")
            flop, nbytes = minv_mv.product_work(c, dim, 4)
            out = torch.empty_like(z)
            timed = {"ms": lambda: minv_mv.product(prep, z),
                     "pr13_ms": lambda: _call(pr13, m, z, out),
                     "matmul_ms": lambda: z @ m.T}
            times = {k: [] for k in timed}
            for r in range(args.rounds):
                for k in (list(timed) if r % 2 == 0 else list(timed)[::-1]):
                    times[k].append(graph_ms(timed[k], REPS))
            got = minv_mv.product(prep, z)
            err = lambda t: float((t.cpu().double() - want).abs().max())  # noqa: E731
            row = dict(chains=c, dim=dim, **times,
                       bound_ms=max(flop / FLOP_PER_MS, nbytes / BYTES_PER_MS),
                       bound_by="operations" if flop / FLOP_PER_MS > nbytes / BYTES_PER_MS
                       else "bytes",
                       err=err(got), matmul_err=err(z @ m.T),
                       pr13_err=err(_call(pr13, m, z, out)),
                       pr13_bits_equal=bool(torch.equal(got, _call(pr13, m, z, out))),
                       f64_rel=err(minv_mv.product(prep64, z64)) / float(want.abs().max()),
                       split=minv_mv.split(dim), chain_tile=minv_mv.chain_tile(c),
                       max_clusters=minv_mv.max_clusters(c, dim))
            if c >= 64:
                row["chain_bits_equal"] = all(
                    torch.equal(minv_mv.product(prep, z[list(idx)]), got[list(idx)])
                    and torch.equal(minv_mv.product(prep64, z64[list(idx)]),
                                    minv_mv.product(prep64, z64)[list(idx)])
                    for idx in SUBSETS if max(idx) < c)
            for name, fn in probes.items():
                row[f"{name}_ms"] = graph_ms(lambda: _call(fn, prep, z, out), REPS)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(device=card, rows=rows, prepare=preps),
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
