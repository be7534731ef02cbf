"""The port's comm domain (``repro_torch.comm``, ``repro_torch.models.moe``)
against the JAX package: the MoE dispatch fabric and the DSE over it.

Contract, on the CPU with the kernels' plain versions and the reference's
parameters and routing sample carried across (``repro_torch.convert``; the
port's own seeded init cannot give ``jax.random``'s bits):

- ``route_trace`` gives the reference's expert loads, also with tied
  logits (top-k takes the lower index first, as ``jax.lax.top_k``);
- ``apply_moe`` gives the reference's ``expert_load`` and ``drop_frac``
  exactly and ``y`` within ``Y_RTOL`` of the largest |y| (the expert FFN's
  bfloat16 products round differently in PyTorch and XLA), over both
  payloads, ``a2a_chunks`` 1/2/4, both routers, both weight modes, top-1/2/4
  and capacity factors that drop tokens; the reference runs jitted there
  (its eager ``shard_map`` takes ~10-25 s a call on a CPU), with token
  counts that are powers of two, where the jitted and eager ``drop_frac``
  agree; one eager run holds ``drop_frac`` at 60 tokens, where they do not;
- the analytic hooks (stages 1-3) price every candidate as the reference;
- ``run_scenario`` on ``comm_small`` equals ``tests/golden/comm_small.json``
  under the golden harness's ``diff_reports``;
- the port's runs of ``comm_small``, ``moe_dispatch`` and ``grad_bucket``
  (registry settings) with the inputs stored in ``tests/torch_golden/``
  equal the reference's runs stored there: the report, and each verified
  candidate's ``expert_load`` and ``drop_frac``; those inputs are the
  reference's own init;
- ``python -m repro_torch run`` runs comm scenarios (``--device cpu``) and
  its default device raises without a card; a mesh axis above 1 raises.

``chip_smoke.py`` holds the card to the same fixtures.  Regenerate them
after an intentional change to the reference (the reference's runs of the
two registry scenarios take minutes on a CPU, so they happen only then):

    PYTHONPATH=src python tests/test_torch_comm.py --write-fixtures
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
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.api import registry as ref_registry  # noqa: E402
from repro.api import run_scenario as ref_run_scenario  # noqa: E402
from repro.api.cli import main as ref_main  # noqa: E402
from repro.api.runner import _build_comm_problem as ref_build_comm_problem  # noqa: E402
from repro.comm.dse_comm import CommDSEProblem as RefCommDSEProblem  # noqa: E402
from repro.comm.dse_comm import CommSpec as RefCommSpec  # noqa: E402
from repro.comm.dse_comm import route_trace as ref_route_trace  # noqa: E402
from repro.core.dse import VerifyResult as RefVerifyResult  # noqa: E402
from repro.models import SINGLE_POD_PLAN as REF_PLAN  # noqa: E402
from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models.moe import MoEOptions as RefOptions  # noqa: E402
from repro.models.moe import apply_moe as ref_apply_moe  # noqa: E402
from repro.models.moe import init_moe as ref_init_moe  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.api import Scenario as PortScenario  # noqa: E402
from repro_torch.api import registry as port_registry  # noqa: E402
from repro_torch.api import run_scenario  # noqa: E402
from repro_torch.api.cli import main as port_main  # noqa: E402
from repro_torch.comm import CommDSEProblem, autotune_moe, route_trace  # noqa: E402
from repro_torch.core.dse import VerifyResult  # noqa: E402
from repro_torch.kernels import quant_pack  # noqa: E402
from repro_torch.models import SINGLE_POD_PLAN, ModelConfig, MoEOptions  # noqa: E402
from repro_torch.models.moe import apply_moe, top_k  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import SCENARIOS, diff_reports  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
#: the comm runs chip_smoke.py reproduces on the card
FIXTURES = {
    "comm_small": SCENARIOS["comm_small"],
    "moe_dispatch": lambda: ref_registry["moe_dispatch"],
    "grad_bucket": lambda: ref_registry["grad_bucket"],
}
#: the inputs each fixture stores; expert weights reach no report, so only
#: comm_small (whose apply_moe output is stored too) keeps them
STORED = {"comm_small": ("router", "hash_proj", "w1", "wg", "w2", "x"),
          "moe_dispatch": ("router", "hash_proj", "x"),
          "grad_bucket": ("router", "hash_proj", "x")}
#: comm_small's stored apply_moe outputs: its champion's options per payload
Y_OPTIONS = {p: dict(capacity_factor=2.0, payload=p, a2a_chunks=1)
             for p in ("bf16", "int8")}
#: y tolerance, relative to max |y_ref|: bfloat16 FFN products rounded by
#: PyTorch's and XLA's matmuls differ in the last bits of h, g and y, and the
#: int8 payload can move a code by one step where those bits cross a .5 tie
Y_RTOL = 2e-2


def _json(x):
    return json.loads(json.dumps(x))


def _bits(a):
    """A JAX or NumPy array as stored: bfloat16 as its uint16 bit pattern."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(a):
    """JAX, NumPy (uint16 = bfloat16 bits) or torch array -> float32 NumPy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# --------------------------------------------------------------------------
# one MoE layer in both packages
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Layer:
    ref_cfg: RefConfig
    cfg: ModelConfig
    ref_params: dict
    ref_x: jnp.ndarray
    params: dict
    x: torch.Tensor


def _layer(d=128, ff=256, e=8, k=2, b=2, s=64, seed=0, ties=False):
    kw = dict(name="moe", family="moe", n_layers=1, d_model=d, n_heads=4,
              n_kv_heads=2, d_ff=ff, vocab=256, moe_experts=e, moe_topk=k)
    ref_cfg, cfg = RefConfig(**kw), ModelConfig(**kw)
    params, _ = ref_init_moe(jax.random.PRNGKey(seed), ref_cfg, REF_PLAN)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (b, s, d), jnp.bfloat16)
    if ties:
        # experts 1 and 5 copy experts 0 and 2: their logits tie exactly
        r = params["router"]
        params["router"] = r.at[:, 1].set(r[:, 0]).at[:, 5].set(r[:, 2])
    arrays = {n: np.asarray(v) for n, v in params.items()}
    t = convert.moe_tensors({**arrays, "x": np.asarray(x)}, "cpu")
    xt = t.pop("x")
    return Layer(ref_cfg, cfg, params, x, t, xt)


def _ref_apply(layer, opts, mesh, *, eager=False):
    """The reference layer on the runner's (1, 1) mesh: jitted (compiled
    once, fast) or eager, as ``CommDSEProblem.verify_batch`` calls it."""
    ropts = RefOptions(**dataclasses.asdict(opts))
    if eager:
        return ref_apply_moe(layer.ref_params, layer.ref_cfg, REF_PLAN, mesh,
                             layer.ref_x, ropts)
    fn = jax.jit(lambda p, x: ref_apply_moe(p, layer.ref_cfg, REF_PLAN, mesh,
                                            x, ropts))
    return fn(layer.ref_params, layer.ref_x)


def _assert_y_close(got, want):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    scale = float(np.abs(w).max())
    print(f"y: max |err| {err:.3g} of max |y| {scale:.3g}")
    assert np.isfinite(g).all()
    assert err <= Y_RTOL * scale


def _margin_report(layer, logits_port, k):
    """Smallest top-k margin of the reference's logits beside the largest
    logit difference between the packages (a flip needs margin < diff)."""
    flat = np.asarray(layer.ref_x, np.float32).reshape(-1, layer.cfg.d_model)
    ref_logits = flat @ np.asarray(layer.ref_params["router"])
    srt = -np.sort(-ref_logits, axis=1)
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    diff = float(np.abs(logits_port - ref_logits).max())
    print(f"smallest top-{k} margin {margin:.3g}, largest logit diff {diff:.3g}")
    return margin, diff


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [dict(), dict(d=256, e=16, k=4, b=4, s=32),
                                  dict(d=128, e=16, k=1, b=2, s=128)],
                         ids=["e8k2", "e16k4", "e16k1"])
def test_route_trace_loads_equal(dims):
    layer = _layer(**dims)
    for tp in (1, 4):
        want = ref_route_trace(layer.ref_params, layer.ref_cfg, layer.ref_x, tp)
        got = route_trace(layer.params, layer.cfg, layer.x, tp)
        np.testing.assert_array_equal(got, want)
    k = layer.cfg.moe_topk
    assert (got.sum(1) == got.sum(1)[0]).all() and got.sum(1)[0] % k == 0
    logits = (layer.x.float().reshape(-1, layer.cfg.d_model)
              @ layer.params["router"]).numpy()
    _margin_report(layer, logits, k)


def test_top_k_breaks_ties_by_the_lower_index():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, (64, 16)).astype(np.float32)      # many ties
    for k in (1, 3, 8, 16):
        want_v, want_i = jax.lax.top_k(jnp.asarray(v), k)
        got_v, got_i = top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_tied_logits_route_like_the_reference(mesh11):
    layer = _layer(ties=True)
    want = ref_route_trace(layer.ref_params, layer.ref_cfg, layer.ref_x, 1)
    np.testing.assert_array_equal(
        route_trace(layer.params, layer.cfg, layer.x, 1), want)
    opts = MoEOptions(capacity_factor=0.75)
    _, aux_ref = _ref_apply(layer, opts, mesh11)
    _, aux = apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN, None, layer.x, opts)
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(aux_ref["expert_load"]))
    assert float(aux["drop_frac"]) == float(aux_ref["drop_frac"])


# --------------------------------------------------------------------------
# the fabric
# --------------------------------------------------------------------------

#: (payload, a2a_chunks, router, capacity_factor, weights, layer dims)
FABRIC_CASES = [
    ("bf16", 1, "learned_topk", 2.0, "gathered", {}),
    ("int8", 1, "learned_topk", 2.0, "gathered", {}),
    ("bf16", 2, "learned_topk", 0.5, "gathered", {}),
    ("int8", 4, "learned_topk", 0.5, "gathered", {}),
    ("int8", 2, "hash", 1.0, "gathered", {}),
    ("bf16", 4, "hash", 0.5, "gathered", {}),
    ("int8", 1, "learned_topk", 1.0, "ff_sharded", {}),
    ("int8", 2, "learned_topk", 0.75, "gathered", dict(d=256, e=16, k=4, b=2, s=32)),
    ("bf16", 1, "hash", 0.75, "gathered", dict(d=256, e=16, k=4, b=2, s=32)),
]


@pytest.mark.parametrize("payload,chunks,router,cf,weights,dims", FABRIC_CASES,
                         ids=[f"{p}-a2a{c}-{r}-cf{cf}-{w}-k{d.get('k', 2)}"
                              for p, c, r, cf, w, d in FABRIC_CASES])
def test_apply_moe_equals_reference(payload, chunks, router, cf, weights, dims,
                                    mesh11):
    layer = _layer(**dims)
    opts = MoEOptions(capacity_factor=cf, payload=payload, a2a_chunks=chunks,
                      router=router, weights=weights)
    y_ref, aux_ref = _ref_apply(layer, opts, mesh11)
    y, aux = apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN, None, layer.x, opts)
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(aux_ref["expert_load"]))
    assert aux["drop_frac"].dtype == torch.float32
    assert float(aux["drop_frac"]) == float(aux_ref["drop_frac"])
    if cf < 1.0:
        assert float(aux["drop_frac"]) > 0.0          # the case drops tokens
    assert y.dtype == torch.bfloat16
    _assert_y_close(y, y_ref)
    assert float(aux["aux_loss"]) == pytest.approx(float(aux_ref["aux_loss"]),
                                                   rel=1e-5, abs=1e-6)


def test_drop_frac_at_60_tokens_equals_the_eager_reference(mesh11):
    """3 x 10 tokens, top-2: 1 - kept * float32(1/60), which is what the
    reference's eager shard_map (the verify path) computes."""
    layer = _layer(b=3, s=10)
    opts = MoEOptions(capacity_factor=0.7)
    _, aux_ref = _ref_apply(layer, opts, mesh11, eager=True)
    _, aux = apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN, None, layer.x, opts)
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(aux_ref["expert_load"]))
    assert 0.0 < float(aux_ref["drop_frac"]) < 1.0
    assert float(aux["drop_frac"]) == float(aux_ref["drop_frac"])


def test_int8_payload_goes_through_quant_pack(monkeypatch):
    calls = {"q": 0, "d": 0}
    real_q, real_d = quant_pack.quantize, quant_pack.dequantize

    def q(x):
        calls["q"] += 1
        return real_q(x)

    def d(q_, s, dtype=torch.float32):
        calls["d"] += 1
        return real_d(q_, s, dtype)
    monkeypatch.setattr(quant_pack, "quantize", q)
    monkeypatch.setattr(quant_pack, "dequantize", d)
    layer = _layer()
    for payload, chunks, n in (("int8", 2, 4), ("int8", 1, 2), ("bf16", 4, 0)):
        calls.update(q=0, d=0)
        apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN, None, layer.x,
                  MoEOptions(capacity_factor=1.0, payload=payload, a2a_chunks=chunks))
        assert calls == {"q": n, "d": n}


def test_mesh_extent_above_one_raises():
    layer = _layer()
    with pytest.raises(NotImplementedError, match="queue 1: mesh"):
        apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN,
                  {"data": 1, "model": 2}, layer.x)
    with pytest.raises(NotImplementedError, match="queue 1: mesh"):
        CommDSEProblem(layer.params, layer.cfg, SINGLE_POD_PLAN,
                       {"data": 4, "model": 1}, layer.x)
    y, _ = apply_moe(layer.params, layer.cfg, SINGLE_POD_PLAN,
                     {"data": 1, "model": 1}, layer.x)
    assert y.shape == layer.x.shape


# --------------------------------------------------------------------------
# the DSE problem
# --------------------------------------------------------------------------

def test_analytic_hooks_equal_reference(mesh11):
    layer = _layer(d=256, e=16, k=4, b=4, s=32)
    ref = RefCommDSEProblem(layer.ref_params, layer.ref_cfg, REF_PLAN, mesh11,
                            layer.ref_x, model_tp=16)
    port = CommDSEProblem(layer.params, layer.cfg, SINGLE_POD_PLAN, None,
                          layer.x, model_tp=16)
    np.testing.assert_array_equal(port.loads, ref.loads)
    assert (port.tokens_per_round, port.tokens_per_device, port.tp_size) == \
        (ref.tokens_per_round, ref.tokens_per_device, ref.tp_size)
    space = port.space()
    decoded = [port.decode(dict(zip([d.name for d in space.dims], g)))
               for g in [("int8", 8, 4), ("bf16", 2, 1)]]
    cands = port.candidates() + decoded
    ref_cands = [RefCommSpec(**dataclasses.asdict(c)) for c in cands]
    assert [c.short() for c in cands] == [c.short() for c in ref_cands]
    srs, ref_srs = port.surrogate_batch(cands), ref.surrogate_batch(ref_cands)
    for c, rc, sr, rsr in zip(cands, ref_cands, srs, ref_srs):
        assert port.static_timing(c) == ref.static_timing(rc)
        np.testing.assert_array_equal(sr.q_occupancy, rsr.q_occupancy)
        np.testing.assert_array_equal(sr.latency_ns, rsr.latency_ns)
        assert sr.throughput_gbps == rsr.throughput_gbps
        for eps in (1e-2, 2e-2, 0.2):
            assert (port.size_buffers(c, sr.q_occupancy, eps).short()
                    == ref.size_buffers(rc, rsr.q_occupancy, eps).short())
        assert port.resources(c) == ref.resources(rc)
        v, rv = VerifyResult(1.0, 1.0, 0.0, 1.0), RefVerifyResult(1.0, 1.0, 0.0, 1.0)
        assert port.objectives(c, v) == ref.objectives(rc, rv)


def test_autotune_moe_on_the_cpu():
    layer = _layer(d=256, e=16, k=4, b=4, s=32)
    result, problem = autotune_moe(layer.params, layer.cfg, SINGLE_POD_PLAN,
                                   None, layer.x, model_tp=16)
    t = layer.x.shape[0] * layer.x.shape[1]
    assert problem.loads.sum() == t * layer.cfg.moe_topk
    assert result.best is not None and result.best_verify.drop_rate <= 2e-2
    assert len(result.evaluated) == min(8, len(result.evaluated)) > 0
    for _, v, _, _ in result.evaluated:
        assert v.meta["expert_load"].sum() == t * layer.cfg.moe_topk


def test_run_scenario_comm_small_equals_the_golden_report():
    ref_scenario = SCENARIOS["comm_small"]()
    prob = ref_build_comm_problem(ref_scenario)
    arrays = {k: np.asarray(v) for k, v in prob.params.items()}
    arrays["x"] = np.asarray(prob.sample_x)
    report = convert.run_comm_scenario(
        PortScenario.from_dict(ref_scenario.to_dict()), arrays, device="cpu")
    with open(os.path.join(GOLDEN_DIR, "comm_small.json")) as f:
        want = json.load(f)
    errors = diff_reports(_json(report.to_dict()), want)
    assert not errors, "\n".join(errors)


# --------------------------------------------------------------------------
# fixtures for the card (chip_smoke.py)
# --------------------------------------------------------------------------

def _fixture_paths(name):
    base = os.path.join(FIXTURE_DIR, name)
    return base + ".json", base + ".npz"


def _load_fixture(name):
    jpath, npath = _fixture_paths(name)
    with open(jpath) as f:
        doc = json.load(f)
    with np.load(npath) as z:
        arrays = {k: z[k] for k in z.files}
    return doc, arrays


def _verified(report):
    return [{"candidate": a.short(), "drop_frac": float(v.drop_rate),
             "expert_load": np.asarray(v.meta["expert_load"]).tolist()}
            for a, v, _, _ in report.result.evaluated]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_inputs_are_the_reference_init(name):
    doc, arrays = _load_fixture(name)
    scenario = FIXTURES[name]()
    assert doc["report"]["scenario"] == _json(scenario.to_dict())
    prob = ref_build_comm_problem(scenario)
    want = {**prob.params, "x": prob.sample_x}
    assert sorted(k for k in arrays if not k.startswith("y_")) == sorted(STORED[name])
    for k in STORED[name]:
        np.testing.assert_array_equal(arrays[k], _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_run_with_fixture_inputs_equals_the_reference_run(name):
    doc, arrays = _load_fixture(name)
    report = convert.run_comm_scenario(
        PortScenario.from_dict(doc["report"]["scenario"]), arrays, device="cpu")
    errors = diff_reports(_json(report.to_dict()), doc["report"])
    assert not errors, "\n".join(errors)
    assert _verified(report) == doc["verified"]
    if name == "comm_small":
        with open(os.path.join(GOLDEN_DIR, "comm_small.json")) as f:
            assert not diff_reports(_json(report.to_dict()), json.load(f))


def test_comm_small_apply_moe_output_within_tolerance_of_the_reference():
    doc, arrays = _load_fixture("comm_small")
    scenario = PortScenario.from_dict(doc["report"]["scenario"])
    prob = convert.comm_problem(scenario, arrays, device="cpu")
    for payload, kw in Y_OPTIONS.items():
        assert doc["apply_moe"][payload] == kw
        y, aux = apply_moe(prob.params, prob.cfg, prob.plan, None, prob.sample_x,
                           MoEOptions(**kw))
        _assert_y_close(y, arrays[f"y_{payload}"])


def reference_fixture(name):
    """The reference's run of one fixture scenario at its settings:
    (the JSON part, the arrays)."""
    report = ref_run_scenario(FIXTURES[name]())
    prob = report.problem
    inputs = {**prob.params, "x": prob.sample_x}
    arrays = {k: _bits(inputs[k]) for k in STORED[name]}
    doc = {"report": _json(report.to_dict()),  # wall times: skipped by diffs
           "verified": _verified(report)}
    if name == "comm_small":
        doc["apply_moe"] = Y_OPTIONS
        for payload, kw in Y_OPTIONS.items():
            opts = RefOptions(router=prob.cfg.router, **kw)
            # eager, as verify_batch calls it
            y, _ = ref_apply_moe(prob.params, prob.cfg, prob.plan, prob.mesh,
                                 prob.sample_x, opts)
            arrays[f"y_{payload}"] = _bits(y)
    return doc, arrays


def write_fixtures(names=None):
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for name in names or sorted(FIXTURES):
        doc, arrays = reference_fixture(name)
        jpath, npath = _fixture_paths(name)
        with open(jpath, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        np.savez_compressed(npath, **arrays)
        print(f"wrote {jpath} and {npath} (the reference ran "
              f"{doc['report']['wall_time_s']:.2f} s on {jax.devices()[0].platform})",
              flush=True)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cli_show_and_run_comm_scenarios(tmp_path):
    for name in ("moe_dispatch", "grad_bucket"):
        assert _run_cli(port_main, ["show", name]) == _run_cli(ref_main, ["show", name])
    # a scenario file, and a report whose scenario reruns
    spec = tmp_path / "comm_small.json"
    spec.write_text(PortScenario.from_dict(
        SCENARIOS["comm_small"]().to_dict()).to_json())
    golden = os.path.join(GOLDEN_DIR, "comm_small.json")
    outs = []
    for target in (str(spec), golden):
        out = tmp_path / f"report{len(outs)}.json"
        rc, text = _run_cli(port_main, ["run", target, "--device", "cpu",
                                        "--out", str(out)])
        assert rc == 0 and "[comm]" in text
        with open(out) as f:
            outs.append(json.load(f))
    assert not diff_reports(outs[0], outs[1])
    got = outs[0]
    # the port's own seeded init: its report, not the golden's
    want = run_scenario(PortScenario.from_dict(got["scenario"]), device="cpu")
    assert not diff_reports(got, _json(want.to_dict()))
    assert got["scenario"]["domain"] == "comm" and got["best"] is not None
    rc, text = _run_cli(port_main, ["run", "grad_bucket", "--device", "cpu"])
    assert rc == 0 and "grad_bucket" in text


def test_cli_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["run", "moe_dispatch"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(port_registry["grad_bucket"])


def test_registry_comm_entries_run_and_pass_their_sla():
    for name in ("moe_dispatch", "grad_bucket"):
        report = run_scenario(port_registry[name], device="cpu")
        best = report.best_verify
        assert best is not None and best.drop_rate <= report.scenario.sla.drop_rate
        assert not math.isnan(best.p99_latency_ns)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-fixtures"]:
        write_fixtures(sys.argv[2:] or None)
    else:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_comm.py "
                 "--write-fixtures [name ...]")
