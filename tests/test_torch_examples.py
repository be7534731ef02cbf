"""The port's examples (``examples/*_torch.py``) run on the CPU.

Each is the JAX package's example of the same name on ``repro_torch``, on
the card unless given ``--device cpu``.  Here each runs as a user runs it, a
script in a subprocess, at its smallest arguments: ``quickstart_torch`` and
``moe_dse_autotune_torch`` as they are (seconds on the CPU),
``serve_batched_torch`` with 4 requests of 4 tokens, and ``train_e2e_torch``
for 2 steps of 16 tokens (the injected crash and the restart included).
Left to the card: ``inswitch_allreduce_torch``, which has no smaller
argument than the reference's full trace (515,653 cycles a switch, ~6 min
each on the CPU in the eager loop; its switches and hook are held to the
reference on a short trace in ``test_torch_switch_hooks.py``), and
``train_e2e_torch`` at its 200 steps.  Every example's imports and flags
are checked here.  Neither the examples nor this file import ``jax`` or
``repro``.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "moe_dse_autotune", "serve_batched", "train_e2e",
            "inswitch_allreduce")

#: example -> (arguments besides --device cpu, a pattern its output must hold)
RUNS = {
    "quickstart": ((), r"selected micro-architecture : \S+"),
    "moe_dse_autotune": ((), r"selected CommSpec : cf="),
    "serve_batched": (("--requests", "4", "--max-new", "4"),
                      r"4/4 requests served, 16 tokens"),
    "train_e2e": (("--steps", "2", "--seq", "16"),
                  r"2 steps in \d+s \(\d+ tok/s incl\. 1 restart\(s\)\)"),
}


def _run(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, pattern = RUNS[name]
    if name == "train_e2e":
        args += ("--ckpt-dir", str(tmp_path / "ckpt"))
    res = _run([str(ROOT / "examples" / f"{name}_torch.py"), *args, "--device", "cpu"],
               tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert re.search(pattern, res.stdout), res.stdout[-3000:]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_is_the_reference_on_the_port(name):
    """Each port example beside its reference, importing neither ``jax`` nor
    ``repro``, with a ``--device`` flag."""
    ref = (ROOT / "examples" / f"{name}.py").read_text()
    src = (ROOT / "examples" / f"{name}_torch.py").read_text()
    assert re.search(r"^\s*(import|from) repro[ .]", ref, re.M)
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|from repro[. ])",
                         src, re.M)
    assert "repro_torch" in src and '"--device"' in src


@pytest.mark.parametrize("name,args,result", [
    ("serve_batched", ("--requests", "1"), "requests served"),
    ("inswitch_allreduce", (), "delivered="),
])
def test_examples_default_to_the_card(name, args, result, tmp_path):
    """Without --device an example asks for CUDA: without a card it fails
    naming it, and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    res = _run([str(ROOT / "examples" / f"{name}_torch.py"), *args], tmp_path)
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert result not in res.stdout
