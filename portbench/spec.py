"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root lists the cells, configurations and
metrics.  Everything that belongs to one of them sits in a file of its own
under ``portbench/``, found by the name ``BENCHMARK.json`` gives it:

  ``workloads/<cell>.json``   the cell's traffic mix: its driver, the
                              traffic's parameters, the driver's settings
                              and the limits of its comparison
  ``configs/<config>.json``   the configuration (``BENCHMARK.json`` names
                              the file), with the reference module it uses
  ``metrics/<metric>.py``     one per-layer metric's reader (``read(r)``)
  ``drivers/<driver>.py``     one kind of run (``run(cell, args, device)``)
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List

__all__ = ["ROOT", "HERE", "Cell", "benchmark", "cell", "metric_reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


class Cell:
    """One entry of ``workloads`` with its traffic file, configuration and
    the metrics it reports."""

    def __init__(self, bench: Dict, name: str):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entries[name]
        self.workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((ROOT / self.config_entry["file"]).read_text())
        self.end_to_end = self._metrics(bench["end_to_end"])
        self.per_layer = self._metrics(bench["per_layer"])

    def _metrics(self, entries: List[Dict]) -> List[Dict]:
        return [m for m in entries if self.name in m.get("workloads", [self.name])]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return importlib.import_module(f"portbench.drivers.{self.workload['driver']}")


def cell(name: str) -> Cell:
    return Cell(benchmark(), name)


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return importlib.import_module(f"portbench.metrics.{name}").read
