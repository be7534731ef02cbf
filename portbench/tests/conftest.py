"""Shared pieces of the benchmark's CPU tests: a cell cut to CPU sizes.

Run from the root of the repo: ``python -m pytest -q portbench/tests``
(``tests/``, the repo's own suite, does not collect them)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CELLS = ("mamba2-780m.train_8k", "mistral-nemo-12b.train_16k")


#: per cell: the model block's sizes and the tokens a sequence at which a CPU
#: run holds the cell's limits and its control fails them (at the 2-layer
#: d 128 smoke widths the control's fp8 error stays inside them)
SMALL = {
    "mamba2-780m.train_8k": ({"n_layers": 48, "d_model": 128, "vocab": 2048,
                              "ssm_state": 64, "ssm_headdim": 64}, 256),
    "mistral-nemo-12b.train_16k": ({"n_layers": 2, "d_model": 512, "vocab": 2048,
                                    "n_heads": 8, "n_kv_heads": 2, "head_dim": 64,
                                    "d_ff": 2048}, 512),
}


def small_cell(name: str, seq_len: int | None = None):
    """The cell at the small sizes of SMALL (one sequence a step), with its
    configuration's other settings, its init rules and its limits as
    committed."""
    from portbench.spec import cell

    sizes, s = SMALL[name]
    c = cell(name)
    c.config = dict(c.config, model=dict(c.config["model"], **sizes))
    c.workload = copy.deepcopy(c.workload)
    c.workload["traffic"].update(batch=1, seq_len=seq_len or s)
    return c


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
