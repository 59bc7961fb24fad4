"""Finding a cell by name: ``BENCHMARK.json`` at the checkout's root names
each workload's configuration and traffic mix; each lives in a file of its
own (``configs/<config>.json``, ``traffic/<traffic>.json``), the limits of
its check in ``cells/<workload>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. A later PR adds a cell by adding files and
entries; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One workload: its entry, configuration, traffic mix and limits (from
    ``cells/<workload>.json`` unless given), and the per-layer metrics that
    ``BENCHMARK.json`` asks of it."""

    def __init__(self, name: str, bench: dict, base: Path = HERE, limits=None):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(entries)})")
        self.name, self.entry = name, entries[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(base.parent / configs[self.entry["config"]]["file"])
        self.traffic = load_json(base / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = (load_json(base / "cells" / f"{name}.json")["limits"] if limits is None
                       else limits)
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
