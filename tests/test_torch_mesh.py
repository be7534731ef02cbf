"""The port's device mesh (``repro_torch.launch.mesh``) and every path that
shards over it, against the port's serial path and the JAX package.

Contract (the reference's ``tests/test_mesh_dse.py``,
``tests/test_mesh_properties.py``, ``tests/test_golden.py:164-230``,
``tests/test_serve.py:178`` and ``tests/test_multidevice.py:30``):

- ``padded_size``/``shard_pad``/``shard_unpad`` are the reference's (same
  arrays out); a mesh larger than the devices available raises naming both
  counts; ``REPRO_TORCH_FORCE_DEVICE_COUNT`` (the counterpart of
  ``--xla_force_host_platform_device_count``, set here with
  ``monkeypatch.setenv``) lets more shards than devices run, each device
  taking its shards in turn, never on another device type;
- stage 2 and both stage-4 engines are **bitwise** the serial path at B 21
  on meshes 2, 8, 2x2 and 4x2, at B 1 and 7 on 8 shards, and on a
  fixed-point case whose rows iterate (the sharded gated replay), and the
  serial path is bitwise the reference's; ``_bucket`` is the reference's;
- ``hft_nsga2`` at 2 shards and ``fattree_dc`` at 2 and 4 reproduce their
  goldens; an NSGA-II report at 2 and 8 shards is the serial one; a search
  stopped on N shards resumes on M bitwise (front, ``hv_history``, next
  RNG draws), also from the reference's serial checkpoint restamped to 8
  devices; the DSE service on 2 shards serves the goldens;
- the sharded engines are tracked under the reference's names, a sharded
  run adds no key to the serial ``surrogate.engine`` and a second one none
  at all; the CLI runs ``--devices 2`` to the serial report and exits with
  the reference's message on ``--devices 0``;
- ``apply_moe`` at (2,4), (4,2) and (8,1), bf16 and int8 payloads, is
  within atol 3e-2 of (1,1) (the reference's bar), and at (2,4) within it
  of the reference's ``apply_moe`` at (2,4) (run in a subprocess with 8
  forced host devices, arrays passed back as ``.npy``), with the
  reference's ``expert_load`` exactly and ``drop_frac`` within rtol 1e-6 at
  capacity factor 1.0; on the CPU the int8 payload takes ``quant_pack``'s
  plain versions.

The ``cuda``-marked twins hold the engine matrix and the MoE layouts on the
card (8 shards on one card, in turn) against the port's plain versions.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core import ArchRequest, bind, compressed_protocol, enumerate_candidates  # noqa: E402
from repro.core.search import NSGA2Search as RefNSGA2Search  # noqa: E402
from repro.core.search import remesh_search_state as ref_remesh  # noqa: E402
from repro.core.search import run_search as ref_run_search  # noqa: E402
from repro.core.search import SearchSpec as RefSearchSpec  # noqa: E402
from repro.api import registry as ref_registry  # noqa: E402
from repro.api.runner import build_problem as ref_build_problem  # noqa: E402
from repro.kernels.netsim.ops import _bucket as ref_bucket  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.sim import run_netsim_batched as ref_netsim_batched  # noqa: E402
from repro.sim import run_surrogate_batched as ref_surrogate_batched  # noqa: E402
from repro.traces import hft  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.analysis.retrace import call_counts, retrace_guard, tracked_names  # noqa: E402
from repro_torch.api import Scenario, registry, run_scenario, strip_times  # noqa: E402
from repro_torch.api.cli import main as port_main  # noqa: E402
from repro_torch.api.runner import build_problem  # noqa: E402
from repro_torch.api.scenario import SearchSpec  # noqa: E402
from repro_torch.api.service import DSEServeEngine  # noqa: E402
from repro_torch.core.search import load_search_state, run_search  # noqa: E402
from repro_torch.kernels import quant_pack  # noqa: E402
from repro_torch.kernels.netsim.ops import _bucket  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.mesh import (FORCE_ENV, MeshSpec, compat_make_mesh,  # noqa: E402
                                     device_count, padded_size, shard_pad,
                                     shard_unpad)
from repro_torch.models import SINGLE_POD_PLAN, ModelConfig, MoEOptions  # noqa: E402
from repro_torch.models.moe import apply_moe  # noqa: E402
from repro_torch.sim import run_netsim_batched, run_surrogate_batched  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_golden import diff_reports  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
REF_BOUND = bind(compressed_protocol(addr_bits=4, length_bits=6), flit_bits=256)
BOUND = convert.from_reference(REF_BOUND)
#: the engine matrix's meshes: (devices, scenario_axis)
MESHES = [(2, 1), (8, 1), (2, 2), (4, 2)]
#: MoE layouts (data, model) and the reference's bar between them
LAYOUTS = [(2, 4), (4, 2), (8, 1)]
MOE_ATOL = 3e-2
MOE_KW = dict(name="t", family="moe", n_layers=1, d_model=128, n_heads=4,
              n_kv_heads=2, d_ff=256, vocab=512, moe_experts=8, moe_topk=2)


@pytest.fixture
def forced8(monkeypatch):
    monkeypatch.setenv(FORCE_ENV, "8")


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        want = json.load(f)
    return Scenario.from_dict(want["scenario"]), want


def _json(report):
    return json.loads(json.dumps(report.to_dict()))


# --------------------------------------------------------------------------
# the mesh: pad/unpad, validation, placement
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,k", [(1, 8), (7, 8), (21, 2), (16, 8), (8, 8),
                                 (1, 1), (5, 3), (33, 16)])
def test_pad_unpad_roundtrip_equals_reference(b, k):
    rng = np.random.default_rng(b * 31 + k)
    a = rng.random((b, 5))
    p = shard_pad(a, k)
    np.testing.assert_array_equal(p, ref_mesh.shard_pad(a, k))
    assert p.shape[0] == padded_size(b, k) == ref_mesh.padded_size(b, k)
    assert p.shape[0] % k == 0 and p.shape[0] - b < k
    np.testing.assert_array_equal(shard_unpad(p, b), a)
    if p.shape[0] > b:      # every pad row replicates row 0
        np.testing.assert_array_equal(p[b:], np.broadcast_to(a[0], (p.shape[0] - b, 5)))
    # 1-D candidate arrays and a candidate axis other than 0
    v = rng.random(b)
    np.testing.assert_array_equal(shard_pad(v, k), ref_mesh.shard_pad(v, k))
    np.testing.assert_array_equal(shard_unpad(shard_pad(a.T, k, axis=1), b, axis=1), a.T)
    np.testing.assert_array_equal(shard_pad(a.T, k, axis=1),
                                  ref_mesh.shard_pad(a.T, k, axis=1))


def test_pad_returns_divisible_batches_untouched_and_padded_size_rejects_zero():
    a = np.arange(12.0).reshape(6, 2)
    assert shard_pad(a, 3) is a
    assert padded_size(0, 4) == 4 == ref_mesh.padded_size(0, 4)
    with pytest.raises(ValueError, match="must be >= 1"):
        padded_size(8, 0)


def test_validation_names_both_numbers(monkeypatch):
    monkeypatch.delenv(FORCE_ENV, raising=False)
    assert device_count("cpu") == 1
    with pytest.raises(ValueError, match=r"extent 0"):
        compat_make_mesh((0, 1), ("scenario", "cand"), "cpu")
    with pytest.raises(ValueError) as ei:
        compat_make_mesh((2, 1), ("scenario", "cand"), "cpu")
    assert "needs 2 devices but only 1" in str(ei.value) and FORCE_ENV in str(ei.value)
    with pytest.raises(ValueError, match=r"size 0"):
        MeshSpec(devices=0)
    with pytest.raises(ValueError, match=r"size 0"):
        MeshSpec(scenario_axis=0)
    with pytest.raises(ValueError, match="needs 4 devices but only 1"):
        MeshSpec(devices=4).build("cpu")
    for bad in ("x", "0"):
        monkeypatch.setenv(FORCE_ENV, bad)
        with pytest.raises(ValueError, match=FORCE_ENV):
            device_count("cpu")


def test_forced_count_places_shards_round_robin_on_the_callers_type(monkeypatch):
    monkeypatch.setenv(FORCE_ENV, "8")
    mesh = MeshSpec(devices=4, scenario_axis=2).build("cpu")
    assert mesh is MeshSpec(devices=4, scenario_axis=2).build("cpu")   # cached
    assert mesh.axis_names == ("scenario", "cand") and mesh.axis_sizes == (2, 4)
    assert mesh.shape == {"scenario": 2, "cand": 4}
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.label() == "2x4 scenario,cand"
    assert [mesh.shard(mesh.coords(s)) for s in range(8)] == list(range(8))
    assert mesh.coords(5) == (1, 1)
    with pytest.raises(ValueError, match="needs 16 devices but only 8"):
        MeshSpec(devices=16).build("cpu")
    # three cards: shard s on cuda:(s % 3), never the CPU (placement only)
    monkeypatch.setattr(port_mesh, "_MESH_CACHE", {})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    import repro_torch.device as pdev
    monkeypatch.setattr(pdev, "resolve_device", lambda d=None: torch.device("cuda", 0))
    cuda = compat_make_mesh((2, 4), ("data", "model"))
    assert cuda.devices == tuple(torch.device("cuda", s % 3) for s in range(8))
    assert device_count("cuda") == 8
    monkeypatch.delenv(FORCE_ENV)
    assert device_count("cuda") == 3
    with pytest.raises(ValueError, match="needs 8 devices but only 3"):
        compat_make_mesh((2, 4), ("data", "model"))


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_bucket_equals_reference(k):
    assert [_bucket(b, k) for b in range(1, 41)] == [ref_bucket(b, k) for b in range(1, 41)]


# --------------------------------------------------------------------------
# the engine matrix: bitwise the serial path
# --------------------------------------------------------------------------

def _cands():
    return enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))[:21]


@pytest.fixture(scope="module")
def engine_inputs():
    """hft, 21 candidates of 8 ports, and a fixed-point case whose rows drop
    and iterate: the port's serial results, each held bitwise against the
    reference's serial engines."""
    tr = hft(seed=0)
    ref_cands = _cands()
    low = [a.with_depth(d) for a in ref_cands[:6] for d in (1, 2)]
    ptr, cands, low_p = (convert.from_reference(tr), convert.from_reference(ref_cands),
                         convert.from_reference(low))
    kw = dict(back_annotation=False, device="cpu")
    s2 = run_surrogate_batched(cands, BOUND, ptr, **kw)
    s4 = {u: run_netsim_batched(cands, BOUND, ptr, use_kernel=u, **kw)
          for u in ("auto", "off")}
    s4_low = run_netsim_batched(low_p, BOUND, ptr, use_kernel="auto", **kw)
    want2 = ref_surrogate_batched(ref_cands, REF_BOUND, tr, back_annotation=False)
    for f in ("latency_ns", "q_occupancy", "dep_end_s", "throughput_gbps",
              "line_rate_feasible"):
        np.testing.assert_array_equal(getattr(s2, f), getattr(want2, f))
    for got, want in ((s4["auto"], ref_netsim_batched(ref_cands, REF_BOUND, tr,
                                                      back_annotation=False,
                                                      use_kernel=True)),
                      (s4["off"], ref_netsim_batched(ref_cands, REF_BOUND, tr,
                                                     back_annotation=False)),
                      (s4_low, ref_netsim_batched(low, REF_BOUND, tr,
                                                  back_annotation=False,
                                                  use_kernel=True))):
        _assert_stage4_equal(got, want)
    assert any(v.drop_rate > 0 for v in s4_low)
    return dict(trace=ptr, cands=cands, low=low_p, s2=s2, s4=s4, s4_low=s4_low)


def _assert_stage2_equal(got, want, rows=slice(None)):
    for f in ("latency_ns", "q_occupancy", "dep_end_s", "throughput_gbps",
              "line_rate_feasible"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f)[rows])


def _assert_stage4_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.p99_latency_ns, g.drop_rate, g.throughput_gbps) == (
            w.p99_latency_ns, w.drop_rate, w.throughput_gbps)
        np.testing.assert_array_equal(g.meta["latency_ns"], w.meta["latency_ns"])
        assert g.meta.get("fallback") == w.meta.get("fallback")


@pytest.mark.parametrize("devices,scenario_axis", MESHES)
def test_engines_bit_identical_on_mesh(engine_inputs, forced8, devices, scenario_axis):
    e = engine_inputs
    mesh = MeshSpec(devices=devices, scenario_axis=scenario_axis)
    kw = dict(back_annotation=False, device="cpu", mesh=mesh)
    _assert_stage2_equal(run_surrogate_batched(e["cands"], BOUND, e["trace"], **kw),
                         e["s2"])
    for u in ("auto", "off"):
        _assert_stage4_equal(run_netsim_batched(e["cands"], BOUND, e["trace"],
                                                use_kernel=u, **kw), e["s4"][u])


@pytest.mark.parametrize("b", [1, 7])
def test_engines_bit_identical_when_padding_fills_most_shards(engine_inputs, forced8, b):
    """B 1 and 7 on 8 shards: shards that hold only pad replicas of row 0."""
    e = engine_inputs
    kw = dict(back_annotation=False, device="cpu", mesh=MeshSpec(devices=8))
    _assert_stage2_equal(run_surrogate_batched(e["cands"][:b], BOUND, e["trace"], **kw),
                         e["s2"], rows=slice(0, b))
    for u in ("auto", "off"):
        _assert_stage4_equal(run_netsim_batched(e["cands"][:b], BOUND, e["trace"],
                                                use_kernel=u, **kw), e["s4"][u][:b])


def test_fixed_point_past_round_one_runs_the_sharded_gated_replay(engine_inputs, forced8):
    e = engine_inputs
    name = "netsim.kernel.replay.sharded[1x8 scenario,cand n_ports=8]"
    before = call_counts(name) if name in tracked_names() else {}
    got = run_netsim_batched(e["low"], BOUND, e["trace"], back_annotation=False,
                             device="cpu", use_kernel="auto", mesh=8)
    _assert_stage4_equal(got, e["s4_low"])
    assert sum(call_counts(name).values()) > sum(before.values())


def test_sharded_engines_are_tracked_and_add_no_serial_key(engine_inputs, forced8):
    """The reference's names; a sharded run adds no ``surrogate.engine``
    key, and a second identical run adds no key at all."""
    e = engine_inputs
    serial = call_counts("surrogate.engine")

    def run():
        kw = dict(back_annotation=False, device="cpu", mesh=MeshSpec(devices=2))
        run_surrogate_batched(e["cands"], BOUND, e["trace"], **kw)
        for u in ("auto", "off"):
            run_netsim_batched(e["low"], BOUND, e["trace"], use_kernel=u, **kw)

    run()
    assert call_counts("surrogate.engine") == serial
    names = set(tracked_names())
    for want in ("surrogate.sharded[1x2 scenario,cand n_ports=8]",
                 "netsim.kernel.round1.sharded[1x2 scenario,cand n_ports=8]",
                 "netsim.kernel.replay.sharded[1x2 scenario,cand n_ports=8]"):
        assert want in names
    assert any(n.startswith("netsim.sharded[1x2 scenario,cand n_ports=8 d_max=")
               for n in names)
    with retrace_guard(expect=0):
        run()


# --------------------------------------------------------------------------
# reports, search and resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,devices", [("hft_nsga2", 2), ("fattree_dc", 2),
                                          ("fattree_dc", 4)])
def test_golden_reproduces_on_mesh(forced8, name, devices):
    scen, want = _golden(name)
    got = _json(run_scenario(scen, mesh=MeshSpec(devices=devices), device="cpu"))
    assert diff_reports(got, want) == []


def _nsga2_scenario(generations):
    return registry["hft"].override(
        back_annotation=False,
        search=SearchSpec(population=16, generations=generations, seed=7))


@pytest.fixture(scope="module")
def nsga2_serial():
    return _json(run_scenario(_nsga2_scenario(3), device="cpu"))


@pytest.mark.parametrize("devices", [2, 8])
def test_nsga2_report_identical_across_shard_counts(nsga2_serial, forced8, devices):
    got = _json(run_scenario(_nsga2_scenario(3), mesh=MeshSpec(devices=devices),
                             device="cpu"))
    assert diff_reports(got, nsga2_serial) == []
    assert strip_times(got) == strip_times(nsga2_serial)


def _search(scn, mesh, ckpt=None, resume=False, cut=None):
    problem, sla, _ = build_problem(scn, mesh=mesh, device="cpu")
    return run_search(problem, scn.search, sla, delta=scn.fidelity.delta,
                      checkpoint_dir=ckpt, resume=resume,
                      max_generations_this_run=cut)


def _front(outcome):
    return sorted(c.short() for c, _ in outcome.valid)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The serial NSGA-II run of 4 generations, checkpointed."""
    ck = str(tmp_path_factory.mktemp("serial"))
    scn = _nsga2_scenario(4)
    return scn, ck, _search(scn, None, ckpt=ck)


def _stamp(ck):
    """The mesh stamped into the newest checkpoint's manifest."""
    newest = sorted(d for d in os.listdir(ck) if d.startswith("step_"))[-1]
    with open(os.path.join(ck, newest, "manifest.json")) as f:
        return json.load(f)["extra"].get("mesh")


def _assert_resumed_like(scn, ck, out, ref_ck, ref_out):
    assert out.resumed
    assert _front(out) == _front(ref_out)
    assert out.hv_history == ref_out.hv_history
    space = build_problem(scn, device="cpu")[0].space()
    eng_a = load_search_state(ck, space, scn.search)
    eng_b = load_search_state(ref_ck, space, scn.search)
    assert eng_a.hv_history == eng_b.hv_history
    np.testing.assert_array_equal(eng_a.rng.random(16), eng_b.rng.random(16))


@pytest.mark.parametrize("n,m", [(8, 2), (2, 8)])
def test_checkpoint_remesh_resume_bit_identical(uninterrupted, forced8, tmp_path, n, m):
    scn, ref_ck, ref_out = uninterrupted
    ck = str(tmp_path / f"{n}to{m}")
    _search(scn, MeshSpec(devices=n), ckpt=ck, cut=2)              # stopped on N
    assert _stamp(ck) == {"devices": n, "scenario_axis": 1}
    out = _search(scn, MeshSpec(devices=m), ckpt=ck, resume=True)  # resumed on M
    _assert_resumed_like(scn, ck, out, ref_ck, ref_out)


def test_reference_checkpoint_restamped_to_8_resumes_on_2_shards(uninterrupted,
                                                                  forced8, tmp_path):
    """The reference's serial search, stopped after 2 generations, its state
    restamped by the reference's ``remesh_search_state`` to 8 devices,
    resumes in the port on 2 shards as the uninterrupted serial run."""
    scn, ref_ck, ref_out = uninterrupted
    ref_scn = ref_registry["hft"].override(
        back_annotation=False,
        search=RefSearchSpec(population=16, generations=4, seed=7))
    problem, sla, _ = ref_build_problem(ref_scn)
    ck0, ck = str(tmp_path / "ref"), str(tmp_path / "ref8")
    ref_run_search(problem, ref_scn.search, sla, delta=ref_scn.fidelity.delta,
                   checkpoint_dir=ck0, max_generations_this_run=2)
    step = ref_store.latest_step(ck0)
    template = {k: np.zeros((0,), np.int64) for k in RefNSGA2Search._STATE_KEYS}
    tree, manifest = ref_store.restore(ck0, step, template=template)
    tree, extra = ref_remesh(tree, manifest["extra"], 8)
    ref_store.save(ck, step, tree, extra=extra)
    assert _stamp(ck) == {"devices": 8, "scenario_axis": 1}
    out = _search(scn, MeshSpec(devices=2), ckpt=ck, resume=True)
    _assert_resumed_like(scn, ck, out, ref_ck, ref_out)


def test_campaign_on_a_2x2_mesh_equals_serial(forced8):
    """A sweep's grouped stage-2/stage-4 calls split over both mesh axes."""
    from repro_torch.api import run_campaign
    scns = [registry[n].override(back_annotation=False, top_k=2,
                                 trace_params={"duration_s": 8e-5})
            for n in ("hft", "datacenter", "hft")]
    serial = run_campaign(scns, device="cpu")
    sharded = run_campaign(scns, mesh=MeshSpec(devices=2, scenario_axis=2),
                           device="cpu")
    assert [strip_times(r.to_dict()) for r in sharded.reports] == [
        strip_times(r.to_dict()) for r in serial.reports]


def test_service_on_two_shards_serves_the_goldens(forced8):
    eng = DSEServeEngine(slots=4, batch_width=16, verify_width=4, mesh=2,
                         device="cpu")
    assert eng.mesh == MeshSpec(devices=2)
    names = ("hft", "datacenter", "hft_nsga2", "hft_codesign", "fattree_dc")
    wants = {n: _golden(n) for n in names}
    reqs = {n: eng.submit(scen) for n, (scen, _) in wants.items()}
    eng.run_until_drained()
    for n, req in reqs.items():
        assert req.error is None, (n, req.error)
        assert diff_reports(req.report, wants[n][1]) == [], n


def test_cli_runs_devices_and_refuses_zero(monkeypatch, capsys, tmp_path):
    args = ["run", "hft", "--duration-s", "8e-05", "--no-back-annotation",
            "--top-k", "2", "--device", "cpu", "--out"]
    assert port_main(args + [str(tmp_path / "serial.json")]) == 0
    monkeypatch.delenv(FORCE_ENV, raising=False)
    with pytest.raises(SystemExit, match="needs 2 devices but only 1"):
        port_main(args + [str(tmp_path / "x.json"), "--devices", "2"])
    monkeypatch.setenv(FORCE_ENV, "2")
    assert port_main(args + [str(tmp_path / "d2.json"), "--devices", "2"]) == 0
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("serial.json", "d2.json"))
    assert strip_times(a) == strip_times(b)
    # --devices 0 exits with the reference's MeshSpec message (the
    # reference's CLI reads 0 as "unset" and runs serially)
    with pytest.raises(ValueError) as want:
        ref_mesh.MeshSpec(devices=0)
    with pytest.raises(SystemExit) as got:
        port_main(["run", "hft", "--devices", "0", "--device", "cpu"])
    assert str(got.value) == str(want.value) and "size 0" in str(got.value)


# --------------------------------------------------------------------------
# the MoE fabric over a (data, model) mesh
# --------------------------------------------------------------------------

#: the reference's layer at (2, 4) in 8 forced host devices: its init and
#: input, then y at capacity factor 8.0 (no drops) for both payloads and the
#: statistics at 1.0 (drops), jitted (32 tokens x top-2 a shard, a power of
#: two, where the jitted and eager drop_frac agree)
_REF_MOE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import compat_make_mesh
from repro.models.config import ModelConfig, ShardingPlan
from repro.models.moe import init_moe, apply_moe, MoEOptions
out = sys.argv[1]
cfg = ModelConfig(**{KW})
plan = ShardingPlan()
params, _ = init_moe(jax.random.PRNGKey(0), cfg, plan)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 32, 128), jnp.float32).astype(jnp.bfloat16)
bits = lambda a: np.asarray(a).view(np.uint16) if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a)
arrays = {k: bits(v) for k, v in params.items()}
arrays["x"] = bits(x)
mesh = compat_make_mesh((2, 4), ("data", "model"))
for tag, cf, payload in (("cf8_bf16", 8.0, "bf16"), ("cf8_int8", 8.0, "int8"),
                         ("cf1_bf16", 1.0, "bf16")):
    opts = MoEOptions(capacity_factor=cf, payload=payload)
    y, aux = jax.jit(lambda p, x: apply_moe(p, cfg, plan, mesh, x, opts))(params, x)
    arrays[f"y_{tag}"] = np.asarray(y.astype(jnp.float32))
    arrays[f"drop_{tag}"] = np.asarray(aux["drop_frac"], np.float32)
    arrays[f"load_{tag}"] = np.asarray(aux["expert_load"])
np.savez(out, **arrays)
print("ok")
"""


@pytest.fixture(scope="module")
def ref_moe(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_moe") / "moe.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    code = _REF_MOE.replace("{KW}", repr(MOE_KW))
    res = subprocess.run([sys.executable, "-c", code, out], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    arrays = dict(np.load(out))
    t = convert.moe_tensors({k: arrays[k] for k in
                             ("router", "hash_proj", "w1", "wg", "w2", "x")}, "cpu")
    return ModelConfig(**MOE_KW), t, arrays


def _moe(layer, shape, cf, payload, device="cpu"):
    cfg, t, _ = layer
    mesh = None if shape is None else compat_make_mesh(shape, ("data", "model"), device)
    params = {k: v.to(device) for k, v in t.items() if k != "x"}
    return apply_moe(params, cfg, SINGLE_POD_PLAN, mesh, t["x"].to(device),
                     MoEOptions(capacity_factor=cf, payload=payload))


@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_moe_layouts_within_bar_of_one_device(ref_moe, forced8, payload):
    y11, aux11 = _moe(ref_moe, (1, 1), 8.0, payload)
    y0, _ = _moe(ref_moe, None, 8.0, payload)
    assert torch.equal(y11, y0)
    for shape in LAYOUTS:
        y, aux = _moe(ref_moe, shape, 8.0, payload)
        assert y.dtype == torch.bfloat16 and y.shape == y11.shape
        err = float((y.float() - y11.float()).abs().max())
        assert err <= MOE_ATOL, (shape, err)
        assert float(aux["drop_frac"]) == 0.0
        np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                      aux11["expert_load"].numpy())


@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_moe_at_2x4_within_bar_of_reference(ref_moe, forced8, payload):
    y, aux = _moe(ref_moe, (2, 4), 8.0, payload)
    want = ref_moe[2][f"y_cf8_{payload}"]
    err = float(np.abs(y.float().numpy() - want).max())
    assert err <= MOE_ATOL, err
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  ref_moe[2][f"load_cf8_{payload}"])


def test_moe_drops_at_2x4_equal_reference(ref_moe, forced8):
    y, aux = _moe(ref_moe, (2, 4), 1.0, "bf16")
    arrays = ref_moe[2]
    np.testing.assert_array_equal(aux["expert_load"].numpy(), arrays["load_cf1_bf16"])
    want = float(arrays["drop_cf1_bf16"])
    assert want > 0.0
    assert float(aux["drop_frac"]) == pytest.approx(want, rel=1e-6)
    err = float(np.abs(y.float().numpy() - arrays["y_cf1_bf16"]).max())
    assert err <= MOE_ATOL, err


def test_moe_int8_exchange_goes_through_quant_pack_plain_versions(ref_moe, forced8,
                                                                   monkeypatch):
    """Each leg of each exchange quantizes on every sending shard and
    dequantizes on every receiving one; on the CPU those are the plain
    versions (no kernel launch)."""
    from repro_torch.kernels.quant_pack import kernel as qk
    calls = {"q": 0, "d": 0}
    real_q, real_d = quant_pack.quantize, quant_pack.dequantize

    def q(x):
        calls["q"] += 1
        assert x.device.type == "cpu"
        return real_q(x)

    def d(q_, s, dtype=torch.float32):
        calls["d"] += 1
        return real_d(q_, s, dtype)
    monkeypatch.setattr(quant_pack, "quantize", q)
    monkeypatch.setattr(quant_pack, "dequantize", d)
    launches = (qk.QUANTIZE_LAUNCHES, qk.DEQUANTIZE_LAUNCHES)
    _moe(ref_moe, (2, 4), 8.0, "int8")
    assert calls == {"q": 16, "d": 16}          # 8 shards x 2 legs x 1 chunk
    assert (qk.QUANTIZE_LAUNCHES, qk.DEQUANTIZE_LAUNCHES) == launches


# --------------------------------------------------------------------------
# on the card: 8 shards on one card, in turn
# --------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")


@pytest.mark.cuda
@pytest.mark.parametrize("devices,scenario_axis", MESHES)
def test_cuda_engines_bit_identical_on_mesh(engine_inputs, forced8, devices,
                                            scenario_axis):
    _need_cuda()
    e = engine_inputs
    kw = dict(back_annotation=False, device="cuda")
    mesh = MeshSpec(devices=devices, scenario_axis=scenario_axis)
    serial2 = run_surrogate_batched(e["cands"], BOUND, e["trace"], **kw)
    _assert_stage2_equal(serial2, e["s2"])
    _assert_stage2_equal(run_surrogate_batched(e["cands"], BOUND, e["trace"],
                                               mesh=mesh, **kw), e["s2"])
    for u in ("auto", "off"):
        _assert_stage4_equal(run_netsim_batched(e["cands"], BOUND, e["trace"],
                                                use_kernel=u, mesh=mesh, **kw),
                             e["s4"][u])
    _assert_stage4_equal(run_netsim_batched(e["low"], BOUND, e["trace"],
                                            use_kernel="auto", mesh=mesh, **kw),
                         e["s4_low"])


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_cuda_moe_layouts_within_bar_of_one_device(ref_moe, forced8, payload):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    y11, aux11 = _moe(ref_moe, (1, 1), 8.0, payload, "cuda")
    for shape in LAYOUTS:
        y, aux = _moe(ref_moe, shape, 8.0, payload, "cuda")
        err = float((y.float() - y11.float()).abs().max())
        assert err <= MOE_ATOL, (shape, err)
        assert torch.equal(aux["expert_load"], aux11["expert_load"])
