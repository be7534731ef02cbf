"""The port's main path end to end against the JAX package.

Contract: ``repro_torch.core.dse.run_dse`` on a port ``SwitchDSEProblem``,
run on the CPU with the kernels' plain versions, gives the reference's
``run_dse`` result bitwise (Pareto shorts, float64 latencies, drop rates,
resources and stage logs) for hft, datacenter, hft_nsga2 and hft_codesign,
and reproduces their golden reports under the golden harness's
``diff_reports``.  ``optimize_switch`` matches the reference's one-call
wrapper, and a CPU run launches no CUDA kernel.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402

import pytest  # noqa: E402

from repro.api.runner import build_problem  # noqa: E402
from repro.core import dse as ref_dse  # noqa: E402
from repro.sim import switch_problem as ref_sp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import dse as port_dse  # noqa: E402
from repro_torch.kernels.netsim import kernel as netsim_kernel  # noqa: E402
from repro_torch.kernels.xbar import kernel as xbar_kernel  # noqa: E402
from repro_torch.sim import switch_problem as port_sp  # noqa: E402

from test_golden import GOLDEN_DIR, SCENARIOS, diff_reports  # noqa: E402

NAMES = ["hft", "datacenter", "hft_nsga2", "hft_codesign"]


def _verify_tuple(v):
    return (v.p99_latency_ns, v.mean_latency_ns, v.drop_rate,
            v.throughput_gbps)


def _same_float(a, b):
    return a == b or (math.isinf(a) and math.isinf(b) and (a > 0) == (b > 0))


def _assert_results_bitwise(got, want):
    assert (got.best is None) == (want.best is None)
    if want.best is not None:
        assert got.best.short() == want.best.short()
        assert all(map(_same_float, _verify_tuple(got.best_verify),
                       _verify_tuple(want.best_verify)))
    assert [a.short() for a, _ in got.pareto] == \
        [a.short() for a, _ in want.pareto]
    for (_, vg), (_, vw) in zip(got.pareto, want.pareto):
        assert _verify_tuple(vg) == _verify_tuple(vw)
    assert len(got.evaluated) == len(want.evaluated)
    for (ag, vg, rg, okg), (aw, vw, rw, okw) in zip(got.evaluated,
                                                     want.evaluated):
        assert ag.short() == aw.short()
        assert all(map(_same_float, _verify_tuple(vg), _verify_tuple(vw)))
        assert rg == rw and okg == okw
    assert [(lg.stage, lg.considered, lg.survived, list(lg.notes))
            for lg in got.logs] == \
        [(lg.stage, lg.considered, lg.survived, list(lg.notes))
         for lg in want.logs]


@pytest.mark.parametrize("name", NAMES)
def test_run_dse_bitwise_vs_reference_and_golden(name):
    scenario = SCENARIOS[name]()
    problem, sla, budget = build_problem(scenario)
    fid = scenario.fidelity
    want = ref_dse.run_dse(problem, sla, budget, delta=fid.delta,
                           top_k=fid.top_k, search=scenario.search)

    xbar_kernel.LAUNCHES = netsim_kernel.LAUNCHES = 0
    pproblem, psla, pbudget, kw = convert.switch_problem_from_dict(
        scenario.to_dict(), device="cpu")
    got = port_dse.run_dse(pproblem, psla, pbudget, **kw)
    assert xbar_kernel.LAUNCHES == 0 and netsim_kernel.LAUNCHES == 0
    _assert_results_bitwise(got, want)

    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        golden = json.load(f)
    report = json.loads(json.dumps(convert.report_dict(pproblem, got)))
    errors = diff_reports(report, {k: golden[k] for k in report})
    assert not errors, "\n".join(errors)


def test_optimize_switch_matches_reference():
    scenario = SCENARIOS["datacenter"]()
    problem, sla, budget = build_problem(scenario)
    want, _ = ref_sp.optimize_switch(problem.request, problem.bound,
                                     problem.trace, sla=sla, budget=budget,
                                     back_annotation=False)
    got, pproblem = port_sp.optimize_switch(
        convert.from_reference(problem.request),
        convert.from_reference(problem.bound),
        convert.from_reference(problem.trace),
        sla=convert.from_reference(sla), budget=convert.from_reference(budget),
        back_annotation=False, device="cpu")
    assert pproblem.device.type == "cpu"
    _assert_results_bitwise(got, want)
