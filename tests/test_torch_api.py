"""The port's scenario API and command line (``repro_torch.api``) against the
JAX package, with back-annotation on and the champion escalated to the
cycle-level switch.

Contract, on the CPU with the kernels' plain versions: ``Scenario`` dicts
round-trip between the packages and the registries hold the same entries;
``run_scenario`` on ``hft`` (short trace, ``verify_engine="auto"``, the
registry's back-annotation) gives the reference's report under the golden
harness's ``diff_reports``, the reference's escalated ``SwitchSimResult``
exactly and the same η cache; a three-scenario ``run_campaign`` equals the
reference's; ``python -m repro_torch`` ``list``/``show``/``run`` print what
the reference CLI prints (apart from wall times) and its default device
raises without a card.  The fixtures under ``tests/torch_golden/`` (the
reference's runs that ``chip_smoke.py`` holds the card to) are regenerated
from the JAX package and must match.

Regenerate the fixtures after an intentional change to the reference:

    PYTHONPATH=src python tests/test_torch_api.py --write-fixtures
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.api import registry as ref_registry  # noqa: E402
from repro.api import run_campaign as ref_run_campaign  # noqa: E402
from repro.api import run_scenario as ref_run_scenario  # noqa: E402
from repro.api.cli import main as ref_main  # noqa: E402
from repro.sim import backannotate as ref_ba  # noqa: E402

from repro_torch.api import Scenario as PortScenario  # noqa: E402
from repro_torch.api import registry as port_registry  # noqa: E402
from repro_torch.api import run_campaign, run_scenario  # noqa: E402
from repro_torch.api.cli import main as port_main  # noqa: E402
from repro_torch.sim import backannotate as port_ba  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import diff_reports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
#: the runs chip_smoke.py reproduces on the card: registry defaults with the
#: champion escalated; datacenter's trace is cut to 200 µs to keep the card
#: run well inside its time limit (it still calibrates 6 families, and its
#: champion is iSLIP at 32 ports)
FIXTURES = {
    "hft_auto": lambda reg: reg["hft"].override(verify_engine="auto"),
    "datacenter_auto": lambda reg: reg["datacenter"].override(
        verify_engine="auto", trace_params={"duration_s": 2e-4}),
}
SIM_ARRAYS = ("latency_cycles", "latency_ns", "occ_max", "occ_trace")


def _clear_eta():
    ref_ba._ETA_CACHE.clear()
    port_ba._ETA_CACHE.clear()


def _eta_list(cache):
    return [[k[0].value, k[1], k[2].value, k[3], v] for k, v in cache.items()]


def _sim_scalars(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)
            if f.name not in SIM_ARRAYS}


def _escalated(report):
    return report.best_verify.meta["escalated"].meta["cycle"]


def _assert_sim_equal(got, want):
    assert _sim_scalars(got) == _sim_scalars(want)
    for k in SIM_ARRAYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


def _json(x):
    return json.loads(json.dumps(x))


# --------------------------------------------------------------------------
# specs and registry
# --------------------------------------------------------------------------

def test_scenario_dicts_round_trip_and_registries_match():
    assert port_registry.names() == ref_registry.names()
    for name in ref_registry.names():
        want = ref_registry[name].to_dict()
        got = PortScenario.from_dict(want)
        assert got.to_dict() == want
        assert port_registry[name].to_dict() == want
        assert PortScenario.from_json(got.to_json()) == got
    spec = port_registry["hft"].override(co_design=True, devices=2,
                                         trace_params={"duration_s": 1e-4})
    assert spec.to_dict() == ref_registry["hft"].override(
        co_design=True, devices=2, trace_params={"duration_s": 1e-4}).to_dict()


# --------------------------------------------------------------------------
# run_scenario with back-annotation and rung 4
# --------------------------------------------------------------------------

def test_run_scenario_hft_auto_equals_reference():
    spec = dict(trace_params={"duration_s": 8e-05}, verify_engine="auto")
    _clear_eta()
    want = ref_run_scenario(ref_registry["hft"].override(**spec))
    ref_eta = _eta_list(ref_ba._ETA_CACHE)
    got = run_scenario(port_registry["hft"].override(**spec), device="cpu")
    errors = diff_reports(_json(got.to_dict()), _json(want.to_dict()))
    assert not errors, "\n".join(errors)
    assert _eta_list(port_ba._ETA_CACHE) == ref_eta
    assert len(ref_eta) == 6
    _assert_sim_equal(_escalated(got), _escalated(want))
    _clear_eta()


def test_run_campaign_equals_reference():
    over = {"hft": dict(back_annotation=False, trace_params={"duration_s": 1e-4}),
            "underwater": dict(back_annotation=False, trace_params={"duration_s": 1e-4}),
            "datacenter": dict(back_annotation=False)}
    want = ref_run_campaign([ref_registry[n].override(**o) for n, o in over.items()])
    got = run_campaign([port_registry[n].override(**o) for n, o in over.items()],
                       device="cpu")
    keys = ("stage2_candidates", "stage2_batches", "stage4_candidates",
            "stage4_batches", "shared_trace_scenarios", "name")
    assert {k: got.to_dict()[k] for k in keys} == {k: want.to_dict()[k] for k in keys}
    for r_got, r_want in zip(got.reports, want.reports):
        errors = diff_reports(_json(r_got.to_dict()), _json(r_want.to_dict()))
        assert not errors, "\n".join(errors)
    # a campaign's per-scenario result is the solo run's
    solo = run_scenario(port_registry["underwater"].override(**over["underwater"]),
                        device="cpu")
    assert not diff_reports(_json(solo.to_dict()), _json(got["underwater"].to_dict()))


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _mask_times(text):
    return re.sub(r"\(\d+\.\d+s\)", "(<t>s)", text)


def test_cli_list_and_show_print_the_reference_output():
    for argv in (["list"], ["list", "--json"], ["show", "hft"],
                 ["show", "fattree_dc"]):
        assert _run_cli(port_main, argv) == _run_cli(ref_main, argv)
    out = subprocess.run([sys.executable, "-m", "repro_torch", "show", "datacenter"],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0
    assert out.stdout == _run_cli(ref_main, ["show", "datacenter"])[1]


def test_cli_run_hft_equals_reference(tmp_path):
    argv = ["run", "hft", "--duration-s", "8e-05", "--top-k", "2"]
    _clear_eta()
    rc_ref, text_ref = _run_cli(ref_main, argv + ["--out", str(tmp_path / "ref.json")])
    _clear_eta()
    rc, text = _run_cli(port_main, argv + ["--device", "cpu", "--out",
                                           str(tmp_path / "port.json")])
    assert rc == rc_ref == 0
    assert _mask_times(text).replace("port.json", "ref.json") == _mask_times(text_ref)
    with open(tmp_path / "ref.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    errors = diff_reports(got, want)
    assert not errors, "\n".join(errors)
    _clear_eta()


def test_cli_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["run", "hft", "--duration-s", "2e-05", "--no-back-annotation"])
    with pytest.raises(SystemExit):
        port_main(["serve", "hft"])             # not registered until its slice


# --------------------------------------------------------------------------
# fixtures for the card (chip_smoke.py)
# --------------------------------------------------------------------------

def reference_fixture(name):
    """The reference's run of one fixture scenario, from a cold η cache:
    (the JSON part, the escalated result's arrays)."""
    ref_ba._ETA_CACHE.clear()
    report = ref_run_scenario(FIXTURES[name](ref_registry))
    res = _escalated(report)
    doc = {"report": _json(report.to_dict()),  # wall_time_s: skipped by diffs
           "escalated": _json(_sim_scalars(res)),
           "eta_cache": _eta_list(ref_ba._ETA_CACHE)}
    ref_ba._ETA_CACHE.clear()
    return doc, {k: np.asarray(getattr(res, k)) for k in SIM_ARRAYS}


def _fixture_paths(name):
    base = os.path.join(FIXTURE_DIR, name)
    return base + ".json", base + ".npz"


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_card_fixtures_match_the_reference(name):
    doc, arrays = reference_fixture(name)
    jpath, npath = _fixture_paths(name)
    with open(jpath) as f:
        stored = json.load(f)
    errors = diff_reports(stored, doc)
    assert not errors, "\n".join(errors)
    assert stored["escalated"] == doc["escalated"]
    assert stored["eta_cache"] == doc["eta_cache"]
    with np.load(npath) as z:
        assert sorted(z.files) == sorted(SIM_ARRAYS)
        for k in SIM_ARRAYS:
            np.testing.assert_array_equal(z[k], arrays[k], err_msg=k)


def write_fixtures():
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for name in sorted(FIXTURES):
        doc, arrays = reference_fixture(name)
        jpath, npath = _fixture_paths(name)
        with open(jpath, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        np.savez_compressed(npath, **arrays)
        print(f"wrote {jpath} and {npath} (the reference ran "
              f"{doc['report']['wall_time_s']:.2f} s on {jax.devices()[0].platform})")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    else:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_api.py --write-fixtures")
