"""The port's DSE service (``repro_torch.api.service``) against
``run_scenario`` and against the JAX package's service.

Contract: a served report equals the port's ``run_scenario`` on the same
(scenario, seed) and the reference's served report, modulo the volatile
``*_time_s`` keys (the reference's own float tolerance of ``diff_reports``
across the packages), however requests interleave, chunk, pad or dedup;
repeats are answered from the report cache and in-flight twins are computed
once; ``request_key`` is the reference's; a bad spec fails its own request
only, a kernel fault stops the service; a mesh larger than the devices
available is refused up front, and a forced count serves the same reports
(the goldens on a mesh: ``tests/test_torch_mesh.py``); the chunks launch
at fixed widths (the retrace guard adds no call key on a second wave).
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import json  # noqa: E402
import os  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from repro.api import registry as ref_registry  # noqa: E402
from repro.api.service import Client as RefClient  # noqa: E402
from repro.api.service import request_key as ref_request_key  # noqa: E402

from repro_torch.analysis import retrace_guard  # noqa: E402
from repro_torch.api import registry, run_scenario  # noqa: E402
from repro_torch.api.scenario import Scenario, SearchSpec  # noqa: E402
from repro_torch.api.service import (Client, DSEServeEngine,  # noqa: E402
                                     request_key, strip_times)

from test_golden import diff_reports  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
W = dict(slots=2, batch_width=16, verify_width=4, device="cpu")


def _tiny(name, reg=registry, **over):
    return reg[name].override(back_annotation=False, top_k=2,
                              trace_params={"duration_s": 8e-5}, **over)


def _run(scenario):
    return strip_times(run_scenario(scenario, device="cpu").to_dict())


@pytest.fixture(scope="module")
def tiny_hft():
    return _tiny("hft")


@pytest.fixture(scope="module")
def hft_golden(tiny_hft):
    """The standalone single-scenario report every served variant must hit."""
    return _run(tiny_hft)


def test_serve_matches_run_scenario_and_caches(tiny_hft, hft_golden):
    cli = Client(**W)
    first = cli.result(cli.submit(tiny_hft))
    assert strip_times(first) == hft_golden
    rep = cli.submit(tiny_hft)
    assert cli.result(rep) == first
    assert rep.cached
    st = cli.engine.stats()
    assert st["report_hits"] == 1 and st["report_misses"] == 1
    assert st["stage2_rows"] > 0 and st["stage2_chunks"] > 0
    assert st["timeline"]["stage2_builds"] >= 1


def test_serve_inflight_twins_compute_once(tiny_hft):
    eng = DSEServeEngine(slots=4, batch_width=16, verify_width=4, device="cpu")
    a = eng.submit(tiny_hft)
    b = eng.submit(tiny_hft)
    done = eng.run_until_drained()
    assert {r.rid for r in done} == {a.rid, b.rid}
    assert a.report == b.report
    assert b.cached and not a.cached
    st = eng.stats()
    assert st["report_misses"] == 1 and st["report_hits"] == 1


def test_serve_seed_is_part_of_request_identity(tiny_hft):
    assert request_key(tiny_hft) != request_key(
        tiny_hft.override(trace_params={"seed": 3}))
    cli = Client(**W)
    base = cli.result(cli.submit(tiny_hft))
    other = cli.result(cli.submit(tiny_hft, seed=3))
    st = cli.engine.stats()
    assert st["report_misses"] == 2 and st["report_hits"] == 0
    assert base["scenario"] != other["scenario"]
    assert strip_times(other) == _run(tiny_hft.override(trace_params={"seed": 3}))


def test_serve_interleaved_scenarios_stay_deterministic(tiny_hft, hft_golden):
    tiny_dc = _tiny("datacenter")
    dc_golden = _run(tiny_dc)
    eng = DSEServeEngine(slots=4, batch_width=16, verify_width=4, device="cpu")
    reqs = [eng.submit(s) for s in (tiny_hft, tiny_dc, tiny_hft, tiny_dc)]
    done = eng.run_until_drained()
    assert len(done) == 4 and all(r.report is not None for r in done)
    for req, want in zip(reqs, (hft_golden, dc_golden) * 2):
        assert strip_times(req.report) == want
    st = eng.stats()
    assert st["report_misses"] == 2 and st["report_hits"] == 2
    assert st["problem_entries"] == 2


def test_serve_nsga2_search_matches_run_scenario():
    spec = _tiny("hft", search=SearchSpec(population=8, generations=3, seed=0))
    cli = Client(**W)
    assert strip_times(cli.result(cli.submit(spec))) == _run(spec)


def test_serve_use_kernel_on_matches_run_scenario():
    spec = _tiny("hft", use_kernel="on")
    cli = Client(**W)
    assert strip_times(cli.result(cli.submit(spec))) == _run(spec)


def test_serve_bad_request_errors_without_killing_service(tiny_hft,
                                                          monkeypatch):
    import repro_torch.api.service as service
    eng = DSEServeEngine(**W)
    with pytest.raises(KeyError):
        eng.submit("no-such-scenario")
    real = service.build_problem
    monkeypatch.setattr(service, "build_problem",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    bad = eng.submit(tiny_hft, seed=99)
    while not bad.done:
        eng.step()
    assert bad.error is not None and "boom" in bad.error
    monkeypatch.setattr(service, "build_problem", real)
    ok = eng.submit(tiny_hft)
    done = eng.run_until_drained()
    assert ok in done and ok.report is not None
    assert eng.counters["errors"] == 1


def test_serve_kernel_fault_is_not_a_request_error(tiny_hft, monkeypatch):
    """A kernel that fails to build or launch stops the service: it never
    becomes a request error, a CPU rerun or a silent retry."""
    import repro_torch.api.service as service
    from repro_torch.kernels.build import KernelError
    eng = DSEServeEngine(**W)
    monkeypatch.setattr(service, "build_problem",
                        lambda *a, **k: (_ for _ in ()).throw(
                            KernelError("nvcc failed")))
    eng.submit(tiny_hft, seed=5)
    with pytest.raises(KernelError, match="nvcc failed"):
        eng.step()
    assert eng.counters["errors"] == 0


def test_serve_cli_smoke(tmp_path, capsys, monkeypatch):
    from repro_torch.api.cli import main
    out = tmp_path / "served.json"
    reqs = tmp_path / "reqs.json"
    reqs.write_text(json.dumps([{"scenario": "hft", "repeat": 2,
                                 "fidelity": {"top_k": 2,
                                              "back_annotation": False},
                                 "trace": {"params": {"duration_s": 8e-5}}}]))
    rc = main(["serve", "--requests", str(reqs), "--slots", "2",
               "--batch-width", "16", "--verify-width", "4", "--device", "cpu",
               "--out", str(out), "--stats"])
    assert rc == 0
    assert "served 2 request(s), 0 error(s)" in capsys.readouterr().out
    payload = json.loads(out.read_text())
    assert len(payload["requests"]) == 2
    assert payload["stats"]["report_misses"] == 1
    assert payload["stats"]["report_hits"] == 1
    a, b = payload["requests"]
    assert strip_times(a["report"]) == strip_times(b["report"])
    # --devices 2: with one device a usage error naming both counts; with
    # two (forced) the same reports
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    with pytest.raises(SystemExit, match="needs 2 devices but only 1"):
        main(["serve", "hft", "--devices", "2", "--device", "cpu"])
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    out2 = tmp_path / "served2.json"
    assert main(["serve", "--requests", str(reqs), "--slots", "2",
                 "--batch-width", "16", "--verify-width", "4", "--device", "cpu",
                 "--devices", "2", "--out", str(out2)]) == 0
    sharded = json.loads(out2.read_text())["requests"]
    assert [strip_times(r["report"]) for r in sharded] == [
        strip_times(r["report"]) for r in payload["requests"]]


def test_serve_mesh_and_device_refusals(monkeypatch):
    # a mesh larger than the devices available is refused up front, naming
    # both counts; a forced count lets it through
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        DSEServeEngine(mesh=2, device="cpu")
    assert DSEServeEngine(mesh=1, device="cpu").mesh is None
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    assert DSEServeEngine(mesh=2, device="cpu").mesh.shard_axis == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DSEServeEngine()            # the card by default, raising without


# --------------------------------------------------------------------------
# against the JAX package's service
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,seed", [
    (n, s) for n in registry.names() for s in (None, 1)
    if s is None or registry[n].domain == "switch"])
def test_request_key_equals_reference(name, seed):
    over = {} if seed is None else {"trace_params": {"seed": seed}}
    port = registry[name].override(devices=3, **over)
    ref = ref_registry[name].override(devices=3, **over)
    assert request_key(port) == ref_request_key(ref)
    assert request_key(port) == request_key(registry[name].override(**over))


@pytest.mark.parametrize("name", ["hft", "datacenter", "fattree_dc"])
def test_served_report_equals_reference_served(name):
    """The same requests through both services: reports equal under the
    golden harness's rules, modulo *_time_s."""
    mk = (lambda reg: reg[name].override(back_annotation=False, top_k=2)) \
        if name == "fattree_dc" else (lambda reg: _tiny(name, reg))
    cli = Client(**W)
    ref = RefClient(slots=2, batch_width=16, verify_width=4)
    got = [cli.submit(mk(registry)), cli.submit(mk(registry), seed=2)]
    want = [ref.submit(mk(ref_registry)), ref.submit(mk(ref_registry), seed=2)]
    cli.drain()
    ref.drain()
    for g, w in zip(got, want):
        assert g.error is None and w.error is None
        assert diff_reports(strip_times(g.report), strip_times(w.report)) == []


def test_served_goldens_equal_recorded(tmp_path):
    """hft_nsga2 and fattree_dc as their golden reports record them, served
    together, reproduce the goldens."""
    eng = DSEServeEngine(slots=4, batch_width=16, verify_width=4, device="cpu")
    wants = {}
    for name in ("hft_nsga2", "fattree_dc"):
        with open(os.path.join(GOLDEN, f"{name}.json")) as f:
            wants[name] = json.load(f)
    reqs = {n: eng.submit(Scenario.from_dict(w["scenario"]))
            for n, w in wants.items()}
    eng.run_until_drained()
    for name, req in reqs.items():
        assert req.error is None
        assert diff_reports(req.report, wants[name]) == [], name


def test_second_wave_adds_no_call_key(tiny_hft):
    """Fixed-width chunks: a fresh engine serving the same requests again
    launches every engine at shapes already seen."""
    reqs = [tiny_hft, _tiny("datacenter"), _tiny("hft", use_kernel="on")]
    first = DSEServeEngine(slots=4, batch_width=16, verify_width=4, device="cpu")
    for s in reqs:
        first.submit(s)
    first.run_until_drained()
    with retrace_guard(expect=0):
        again = DSEServeEngine(slots=4, batch_width=16, verify_width=4,
                               device="cpu")
        for s in reqs:
            again.submit(s)
        done = again.run_until_drained()
    assert all(r.report is not None and not r.cached for r in done)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_served_tiny_hft_equals_cpu(tiny_hft, hft_golden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.xbar import kernel as xk
    nk.LAUNCHES = xk.LAUNCHES = 0
    cli = Client(slots=2, batch_width=16, verify_width=4, device="cuda")
    got = cli.result(cli.submit(tiny_hft))
    assert strip_times(got) == hft_golden
    assert xk.LAUNCHES > 0 and nk.LAUNCHES > 0
