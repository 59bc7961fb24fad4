"""The benchmark of the PyTorch and CUDA port: one cell per run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The workload is an entry of
``BENCHMARK.json``; its configuration, traffic mix, limits and per-layer
metrics are files of ``portbench/`` found by name (``core/spec.py``). The
run makes the data from the seed, sets the port up through ``solve_magi``
(the recipe's warmup), captures every graph the window will replay, drives
the sampling window for ``--seconds`` and then checks what the window
produced against the plain float64 reference (``core/judge.py``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number of the check with its
limit, which the last lines of standard error repeat.

It exits non-zero and prints no result without enough CUDA cards, without
the port, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_TOP = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "manifold_constrained_gaussian_process_inference_tpu")
CHECK_STREAM = 0x5EED  # the seed's stream that picks the transitions checked


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = process_age_s()


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def since_start() -> float:
    return AGE_AT_TOP + time.perf_counter() - T_TOP


def _p95(seconds) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(seconds), 95.0))


def _end_to_end(cell, window, driver, setup_s):
    """The cell's end-to-end metrics from the window."""
    import numpy as np

    values = {"setup_s": setup_s,
              "draws_per_s": driver.n_draws * window.transitions / window.wall_s,
              "transition_ms_p95": 1e3 * _p95(window.seconds)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    return {name: {"value": float(values[name]), "unit": units[name]}
            for name in units if np.isfinite(values[name])}


def _mixing(cell, window, driver, truth) -> str:
    """The window's theta draws' smallest ESS per second, largest split
    R-hat (``core/diagnostics.py``) and RMSE of their mean from the truth,
    printed as information: over one window they spread too widely from
    seed to seed to carry a bound."""
    import numpy as np

    from portbench.core.diagnostics import ess, split_rhat

    theta = _theta_draws(cell, window, driver)
    if theta.shape[1] < 8:
        return "mixing: too few draws"
    k = theta.shape[-1]
    return (f"mixing (information): min theta ESS per s "
            f"{min(ess(theta[:, :, j]) for j in range(k)) / window.wall_s:.2f}, max split R-hat "
            f"{max(split_rhat(theta[:, :, j]) for j in range(k)):.4f}, theta RMSE "
            f"{float(np.sqrt(np.mean((theta.mean((0, 1)) - truth['theta']) ** 2))):.4f}")


def _theta_draws(cell, window, driver):
    """(chains, draws, k) theta of the window's draws: the sampler's
    coordinates mapped to psi as the port's result maps them, and theta
    through its transform."""
    import numpy as np

    from portbench.core.judge import host

    draws = window.draws  # (chains, T, dim)
    tgt = driver.target
    n, d, k = tgt.n_times, tgt.n_dims, tgt.n_params_ode
    if driver.whitener is not None:
        draws = draws @ host(driver.whitener.W).T + host(driver.whitener.center)
    z = draws[..., n * d: n * d + k]
    if cell.traffic["recipe"].get("theta_constrained", False):
        return np.asarray(cell.config["problem"]["theta_lower"]) + np.exp(z)
    return z


def measure(cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of ``cell``; the result line's object."""
    import numpy as np
    import torch

    from portbench.core import data, judge, sampler, spec, window as win
    from portbench.core.trace import ReplaySpans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    on_chip = device != "cpu"
    marks = [("imports", since_start())]
    y, t, truth = data.make(cell.config)
    marks.append(("data", since_start()))
    with tempfile.TemporaryDirectory() as tmp:
        driver, result = sampler.set_up(cell, y, t, seed, device, os.path.join(tmp, "ckpt.npz"))
    marks.append(("solve_magi and capture", since_start()))
    traffic = cell.traffic
    for mult in driver.mults(int(traffic["warm_transitions"])):
        driver.advance(mult)
    if on_chip:
        torch.cuda.synchronize()
    setup_s = since_start()
    marks.append(("warm transitions", setup_s))
    phases = {k: round(v, 3) for k, v in result.diagnostics["phase_times_s"].items()}
    print("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in marks) + f"; solve_magi {phases}",
          file=sys.stderr)
    rng = np.random.default_rng([int(seed), CHECK_STREAM])
    spans = ReplaySpans() if trace and on_chip else contextlib.nullcontext()
    with spans:
        w = win.run(driver, seconds, int(traffic["chunk"]), int(traffic["checked_transitions"]),
                    rng)
    peak = torch.cuda.max_memory_allocated() if on_chip else 0
    print(f"window: {w.transitions} transitions in {w.wall_s:.3f} s, "
          f"{sum(w.leaves) / max(w.transitions, 1):.1f} batched leaves each, host ms per "
          f"transition median {1e3 * float(np.median(w.seconds)):.2f}", file=sys.stderr)
    metrics = _end_to_end(cell, w, driver, setup_s)
    print(_mixing(cell, w, driver, truth), file=sys.stderr)
    breakdown = None
    if trace:
        from portbench.core import traced

        readings = traced.readings(driver, w, result, spans if on_chip else None)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(readings)
            if value is not None and np.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = readings.get("breakdown")
    attempted = int(w.draws.shape[0] * w.transitions)
    failed = int(np.sum(~np.isfinite(w.lp)) + np.sum(~np.isfinite(w.draws).all(-1)))
    state = judge.capture(driver, w, result)
    busy = readings.get("busy_s") if trace else None
    del driver, result, w
    gc.collect()
    if on_chip:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge.check(cell, y, t, state, device)
    correct = failed == 0 and judge.verdict(numbers, cell.limits)
    print(f"check readings ({time.perf_counter() - t_check:.1f} s): "
          + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    dev = {"platform": "gpu" if on_chip else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_chip else "cpu",
           "count": cell.chips if on_chip else 0, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=busy, window_s=readings["window_s"])
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {name: {"value": numbers[name], "limit": limit}
                       for name, limit in cell.limits.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench.core import spec

    cell = spec.Cell(args.workload, spec.benchmark(ROOT))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; nothing it runs may import JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
