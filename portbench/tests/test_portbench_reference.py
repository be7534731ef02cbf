"""The plain reference against the port's CPU path at small sizes: the
program's first steps fall within the cell's limits, the control (the
reference with fp8 operands) and each fault a training cell can have fall
outside them, and a run with a fault planted under the timed path comes
out not correct."""

from __future__ import annotations

import pytest

from portbench import run as R
from portbench.drivers import train as D
from portbench.reference.common import Prec

from .conftest import CELLS, small_cell

SEEDS = (3, 2 ** 31 + 11)


def _within(numbers, limits):
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference_and_the_control_does_not(name):
    c = small_cell(name)
    prog = D.Program(c, "cpu")
    limits = c.workload["limits"]
    for seed in SEEDS:
        _, _, got, _ = D.first_steps(prog, seed)
        ref = D.reference_readings(prog, seed)
        assert _within(D.compare(got, ref), limits), (seed, D.compare(got, ref))
        ctl = D.reference_readings(prog, seed, Prec.FP8)
        assert not _within(D.compare(ctl, ref), limits), (seed, D.compare(ctl, ref))


def _frozen(step):
    """A step that computes its loss and returns its state unchanged."""
    def broken(params, state, batch, i):
        _, _, m = step(params, state, batch, i)
        return params, state, m
    return broken


def _half(step):
    """A step that leaves half of the batch's tokens out of its loss."""
    def broken(params, state, batch, i):
        return step(params, state, D.half_batch(lambda _: batch)(i), i)
    return broken


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, _frozen, _half], ids=["sound", "frozen", "half"])
def test_a_run_with_a_fault_under_the_timed_path_is_not_correct(name, fault, monkeypatch):
    c = small_cell(name, seq_len=128)
    if fault is not None:
        build = D.Program.__init__

        def init(self, *a, **k):
            build(self, *a, **k)
            self.step = fault(self.step)
        monkeypatch.setattr(D.Program, "__init__", init)
    out = c.driver().run(c, SEEDS[1], 0.1, False, "cpu")
    line = R.result_line(c, out, False, {"platform": "cpu"})
    assert line["correct"] is (fault is None), line["checks"]
