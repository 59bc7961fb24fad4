"""Each cell at a tiny size on the CPU: set-up through the port's
solve_magi, a short window, the traced readings and the check, with the
result's keys; the check coming out false for each fault the cells can
have, planted in the port's transition (``core/faults.py``); and the
command refusing to run without a card."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT, tiny_cell

CELLS = ["fn-fill2.nuts128", "hes1log.pt40", "fn-fill2.default1"]


def _measure(name, trace, seconds=1.0, seed=3000000019):
    from portbench import run

    return run.measure(tiny_cell(name), seed, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    out = _measure(name, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert {"leaves_per_transition", "lockstep_useful_share", "batched_leaf_ms",
            "setup_fit_s", "setup_warmup_s"} <= set(out["metrics"])
    # device readings are the card's alone
    assert not {"leaf_mfu", "vg_ms", "device_idle_share"} & set(out["metrics"])
    compared = out["compared"]
    assert set(compared) == set(tiny_cell(name).limits)
    assert compared["step_mismatch"]["value"] == 0.0
    if "nlml_gap" in compared:
        # the reference fits phi itself: at 21 observations the two optima
        # agree to rounding in the objective, and their flat direction moves
        # phi in its fifth digit, lp by a few thousandths of a nat
        assert compared["nlml_gap"]["value"] < 1e-8 and compared["lp_gap"]["value"] < 0.01
    else:
        assert compared["lp_gap"]["value"] < 1e-6


@pytest.mark.parametrize("name", ["fn-fill2.nuts128", "fn-fill2.default1"])
def test_end_to_end_metrics_untraced(name):
    out = _measure(name, trace=False, seconds=2.0)
    assert set(out["metrics"]) == {"draws_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["fn-fill2.nuts128", "hes1log.pt40"])
def test_a_fault_comes_out_not_correct(monkeypatch, name, kind):
    """The harness's look for a chip skipped, a run with the port's
    transition broken underneath its window reads correct false."""
    from portbench.core import faults, window

    real = window.run

    def broken(*args, **kwargs):
        with faults.planted(kind):
            return real(*args, **kwargs)

    monkeypatch.setattr(window, "run", broken)
    out = _measure(name, trace=False)
    assert not out["correct"], out["compared"]


def test_control_and_faults_are_judged_as_a_run_is():
    """``control.py`` judges the program's readings, the control's and each
    fault's by the cell's limits through ``judge.verdict``, as a run decides
    ``correct``: the program reads true; the control (its GP smoothing in
    float32 moves phi off the optimum) false, a state left unchanged false,
    and so does set-up adapted to a lower target acceptance than the
    recipe's."""
    from portbench import control

    cell = tiny_cell("fn-fill2.nuts128")
    out = control.one_seed(cell, 3000000029, 1.0, ["unchanged"], device="cpu")
    assert out["program"]["verdict"] and not out["unchanged"]["verdict"]
    assert set(cell.limits) <= set(out["control"]) and not out["control"]["verdict"]
    low = control.one_seed(cell, 3000000029, 1.0, [], device="cpu", target=0.6)["target_0.6"]
    assert low["accept_shortfall"] > cell.limits["accept_shortfall"] and not low["verdict"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output; so it does in a directory with only BENCHMARK.json
    and the benchmark's files."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal off the card")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """A short run of each cell of BENCHMARK.json on the card, through the
    command."""
    import json

    from portbench.core import spec

    for name in [w["name"] for w in spec.benchmark(ROOT)["workloads"]]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                              "--seed", "2147483659", "--seconds", "3", "--trace", "1"],
                             cwd=ROOT, capture_output=True, text=True, timeout=360)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["kind"] == card
