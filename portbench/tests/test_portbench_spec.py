"""Every cell, configuration, traffic file and metric is found by its name,
and a new one is a new file: nothing else changes."""

from __future__ import annotations

import json
import shutil

import pytest

import portbench.metrics
from portbench import spec

from .conftest import CELLS


def test_benchmark_names_these_cells():
    bench = spec.benchmark()
    assert tuple(sorted(w["name"] for w in bench["workloads"])) == CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    c = spec.cell(name)
    assert c.workload["config"] == c.entry["config"] == c.config["name"]
    assert c.driver().run
    assert {m["name"] for m in c.end_to_end} == {"train_tokens_per_s", "peak_mem_gib",
                                                 "setup_s"}
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] == "train_tokens_per_s"


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = spec.benchmark()
    names = {m["name"] for m in bench["per_layer"]}
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py") if not p.stem.startswith("_")}
    assert names == files


def test_config_files_are_what_benchmark_names():
    bench = spec.benchmark()
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_are_new_files_only(tmp_path, monkeypatch):
    """Copy the benchmark, add a cell, a traffic file and a metric reader as
    files, and find them without touching any code."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "mamba2-780m.train_4k", "config": "mamba2-780m",
                               "traffic": "train_4k", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["mamba2-780m.train_4k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((spec.HERE / "workloads" / "mamba2-780m.train_8k.json").read_text())
    wl["traffic"]["seq_len"] = 4096
    (tmp_path / "portbench" / "workloads" / "mamba2-780m.train_4k.json").write_text(
        json.dumps(wl))
    (tmp_path / "portbench" / "metrics" / "steps_in_window.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "HERE", tmp_path / "portbench")
    monkeypatch.setattr(portbench.metrics, "__path__",
                        [str(tmp_path / "portbench" / "metrics")])
    c = spec.cell("mamba2-780m.train_4k")
    assert c.workload["traffic"]["seq_len"] == 4096
    assert [m["name"] for m in c.per_layer] == ["steps_in_window"]

    class R:
        steps = 7
    assert spec.metric_reader("steps_in_window")(R) == 7.0
