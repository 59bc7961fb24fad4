"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell's files by name: a cell, a configuration, a traffic mix and a
per-layer metric are added as new files and entries, with no edit to a
file that is there."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench.tests.helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(
        not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_and_names(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_rules():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(layer) <= 200 for layer in layers)
    for w in cells:
        reported = [m for m in e2e.values() if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert [m for m in BENCH["per_layer"] if w in m.get("workloads", cells)]


def test_every_cell_found_by_name():
    from portbench.core import spec

    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = spec.Cell(w["name"], BENCH)
        assert cell.config["name"] == w["config"]
        assert {"lp_gap", "step_mismatch", "band_gap", "accept_shortfall"} <= set(
            cell.limits) <= {"lp_gap", "grad_gap", "step_mismatch", "band_gap", "nlml_gap",
                             "accept_shortfall"}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/") and (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) <= set(json.loads((ROOT / c["file"]).read_text())["reduced"])


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A copy of the benchmark gets a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new entries alone; every file
    already there is byte for byte the same, and the harness finds them."""
    from portbench.core import spec

    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "fn-fill2.json").read_text())
    cfg["name"] = "fn-fill3"
    cfg["data"]["fill"] = 3
    (base / "configs" / "fn-fill3.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "nuts128.json").read_text())
    traffic["recipe"]["n_chains"] = 32
    (base / "traffic" / "nuts32.json").write_text(json.dumps(traffic))
    (base / "cells" / "fn-fill3.nuts32.json").write_text(
        (base / "cells" / "fn-fill2.nuts128.json").read_text())
    (base / "metrics" / "draws_per_leaf.py").write_text(
        "def read(r):\n    return r['transitions'] * r['n_chains'] / r['leaves']\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "fn-fill3",
                             "file": "portbench/configs/fn-fill3.json"})
    bench["workloads"].append({"name": "fn-fill3.nuts32", "config": "fn-fill3",
                               "traffic": "nuts32", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "draws_per_leaf", "unit": "draws", "better": "higher",
                               "source": "program_counter", "layer": "samplers",
                               "moves": "draws_per_s", "workloads": ["fn-fill3.nuts32"]})
    cell = spec.Cell("fn-fill3.nuts32", bench, base=base)
    assert cell.config["data"]["fill"] == 3 and cell.traffic["recipe"]["n_chains"] == 32
    assert [m["name"] for m in cell.per_layer][-1] == "draws_per_leaf"
    read = spec.metric_reader("draws_per_leaf", base=base)
    assert read({"transitions": 10, "n_chains": 32, "leaves": 640}) == 0.5
    assert all(p.read_bytes() == b for p, b in before.items())
