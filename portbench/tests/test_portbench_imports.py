"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``repro_torch`` begins with ``repro`` and is not it)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench import spec
from portbench.run import FORBIDDEN, forbidden_modules


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        bad = set(_imports(path)) & set(FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert forbidden_modules() == ["repro"]


_PROBE = r"""
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from portbench.tests.conftest import small_cell
from portbench import run as R
c = small_cell("{cell}", seq_len=64)
out = c.driver().run(c, 5, 0.2, {trace}, "cpu")
line = R.result_line(c, out, {trace}, {{"platform": "cpu"}})
print(json.dumps({{"modules": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "keys": list(line)}}))
"""


def _probe(cell, trace):
    code = _PROBE.format(cell=cell, trace=trace)
    res = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True,
                         text=True, timeout=240, env={"PATH": "/usr/bin:/bin",
                                                      "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package_and_prints_only_the_keys():
    for cell, trace in (("mamba2-780m.train_8k", False), ("mistral-nemo-12b.train_16k", True)):
        got = _probe(cell, trace)
        assert not set(got["modules"]) & set(FORBIDDEN), got["modules"]
        assert "repro_torch" in got["modules"]
        want = ["correct", "attempted", "failed", "metrics", "device"]
        assert got["keys"] == want + (["breakdown"] if trace else []) + ["checks"]
