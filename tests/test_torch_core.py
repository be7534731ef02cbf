"""The port's copied, framework-free modules against the JAX package, and
the port's hygiene.

Contract: ``repro_torch`` copies ``core``, ``traces``, ``sim/resources``,
``sim/backannotate``, ``sim/surrogate`` and ``sim/netsim`` from ``repro``
(imports rewritten), so on the same inputs they give the same answers:
candidate lists, bound layouts, trace arrays from every generator, resource
reports, trace features and the serial stage-2/stage-4 oracles are equal,
floats bitwise.  The port imports neither ``jax`` nor ``repro``, runs on
the card unless told otherwise, and refuses what it has not ported yet
(the token server's production meshes, which come with training); the
paths it once refused (the mesh among them) run.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import ast  # noqa: E402
import dataclasses  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ArchRequest, ForwardTableKind, SchedulerKind,  # noqa: E402
                        SLA, VOQKind, analyze, bind, compressed_protocol,
                        enumerate_candidates, ethernet_ipv4_udp,
                        hypervolume_2d, pareto_front)
from repro.sim import run_netsim, run_surrogate, synthesize  # noqa: E402
from repro.traces import hft  # noqa: E402
from repro.traces import Trace as RefTrace  # noqa: E402
from repro.traces.workloads import WORKLOADS  # noqa: E402

import repro_torch.core as pcore  # noqa: E402
import repro_torch.sim as psim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import search as psearch  # noqa: E402
from repro_torch.traces import Trace as PortTrace  # noqa: E402
from repro_torch.traces.workloads import WORKLOADS as PORT_WORKLOADS  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

REQUESTS = [
    ArchRequest(n_ports=8, addr_bits=4),
    ArchRequest(n_ports=32, addr_bits=5),
    ArchRequest(n_ports=10, addr_bits=4, voq=VOQKind.NXN),
    ArchRequest(n_ports=16, addr_bits=8, fwd=ForwardTableKind.MULTIBANK_HASH,
                sched=SchedulerKind.ISLIP, bus_bits=512),
]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# --------------------------------------------------------------------------
# copied modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("req", range(len(REQUESTS)))
def test_enumerate_candidates_identical(req):
    want = enumerate_candidates(REQUESTS[req])
    got = pcore.enumerate_candidates(convert.from_reference(REQUESTS[req]))
    assert [a.short() for a in got] == [a.short() for a in want]
    assert [_fields(convert.from_reference(a)) for a in want] == \
        [_fields(a) for a in got]


@pytest.mark.parametrize("proto", ["hft", "dc32", "qos_seq", "ethernet"])
def test_bound_layouts_identical(proto):
    make = {
        "hft": lambda m: m.compressed_protocol(addr_bits=4, length_bits=12,
                                               name="spac_hft"),
        "dc32": lambda m: m.compressed_protocol(addr_bits=5, length_bits=12),
        "qos_seq": lambda m: m.compressed_protocol(addr_bits=8, qos_bits=4,
                                                   length_bits=16, seq_bits=16),
        "ethernet": lambda m: m.ethernet_ipv4_udp(),
    }[proto]
    import repro.core as rcore
    for flit in (64, 256):
        want = rcore.bind(make(rcore), flit_bits=flit)
        got = pcore.bind(make(pcore), flit_bits=flit)
        assert [_fields(f) for f in got.protocol.fields] == \
            [_fields(f) for f in want.protocol.fields]
        assert got.semantics == want.semantics
        assert got.header_bytes == want.header_bytes
        assert [_fields(s) for s in got.plan.slices] == \
            [_fields(s) for s in want.plan.slices]
        assert got.plan.straddling_fields == want.plan.straddling_fields
        assert _fields(convert.from_reference(want).plan) == _fields(got.plan)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_every_generator_bitwise(name, seed):
    want = WORKLOADS[name](seed=seed)
    got = PORT_WORKLOADS[name](seed=seed)
    assert sorted(PORT_WORKLOADS) == sorted(WORKLOADS)
    for f in ("time_s", "src", "dst", "payload_bytes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.name, got.n_ports, got.link_gbps) == \
        (want.name, want.n_ports, want.link_gbps)


def test_synthesize_reports_and_features_equal():
    bound = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256)
    pbound = convert.from_reference(bound)
    for req in REQUESTS[:2]:
        for a in enumerate_candidates(req):
            want = synthesize(a, bound)
            got = psim.synthesize(convert.from_reference(a), pbound)
            assert _fields(got) == _fields(want)
    tr = hft(seed=0)
    assert _fields(pcore.analyze(convert.from_reference(tr))) == \
        _fields(analyze(tr))


def test_serial_oracles_bitwise_on_hft():
    tr = hft(seed=0)
    ptr = convert.from_reference(tr)
    bound = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256)
    pbound = convert.from_reference(bound)
    cands = enumerate_candidates(REQUESTS[0])[::7]
    for a in cands:
        pa = convert.from_reference(a)
        sw = run_surrogate(a, bound, tr, back_annotation=False)
        sg = psim.run_surrogate(pa, pbound, ptr, back_annotation=False)
        np.testing.assert_array_equal(sg.latency_ns, sw.latency_ns)
        np.testing.assert_array_equal(sg.q_occupancy, sw.q_occupancy)
        assert sg.throughput_gbps == sw.throughput_gbps
        for d in (4, 64):
            vw = run_netsim(a.with_depth(d), bound, tr, back_annotation=False)
            vg = psim.run_netsim(pa.with_depth(d), pbound, ptr,
                                 back_annotation=False)
            assert (vg.drop_rate, vg.p99_latency_ns, vg.mean_latency_ns,
                    vg.throughput_gbps) == (vw.drop_rate, vw.p99_latency_ns,
                                            vw.mean_latency_ns,
                                            vw.throughput_gbps)
            np.testing.assert_array_equal(vg.meta["latency_ns"],
                                          vw.meta["latency_ns"])


def test_pareto_and_hypervolume_equal():
    rng = np.random.default_rng(0)
    pts = [tuple(p) for p in rng.uniform(0, 10, (200, 2))]
    assert pcore.pareto_front(pts, key=lambda p: p) == \
        pareto_front(pts, key=lambda p: p)
    front = np.asarray(pareto_front(pts, key=lambda p: p))
    assert pcore.hypervolume_2d(front, (11.0, 11.0)) == \
        hypervolume_2d(front, (11.0, 11.0))


def test_convert_round_trips_and_npz_is_shared(tmp_path):
    sla = SLA(p99_latency_ns=5e3, drop_rate=1e-3)
    assert _fields(convert.from_reference(sla)) == _fields(sla)
    req = convert.from_reference(REQUESTS[3])
    assert req.fwd is pcore.ForwardTableKind.MULTIBANK_HASH
    assert convert.from_reference(REQUESTS[0]).bus_bits is pcore.AUTO
    tr = hft(seed=1)
    tr.save(tmp_path / "ref.npz")
    got = PortTrace.load(tmp_path / "ref.npz")
    convert.from_reference(tr).save(tmp_path / "port.npz")
    back = RefTrace.load(tmp_path / "port.npz")
    for f in ("time_s", "src", "dst", "payload_bytes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(tr, f))
        np.testing.assert_array_equal(getattr(back, f), getattr(tr, f))
    with pytest.raises(TypeError, match="no repro_torch counterpart"):
        convert.from_reference(object())


# --------------------------------------------------------------------------
# hygiene
# --------------------------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(p.relative_to(REPO), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    bound = convert.from_reference(
        bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256))
    tr = convert.from_reference(hft(seed=0).head(64))
    req = convert.from_reference(REQUESTS[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.SwitchDSEProblem(req, bound, tr, back_annotation=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        psim.run_surrogate_batched(pcore.enumerate_candidates(req)[:2], bound,
                                   tr)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_paths_raise_not_implemented(tmp_path, monkeypatch):
    bound = convert.from_reference(
        bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256))
    tr = convert.from_reference(hft(seed=0).head(64))
    req = convert.from_reference(REQUESTS[0])
    for engine in ("cycle", "auto"):        # rung 4 is ported: no refusal
        assert psim.SwitchDSEProblem(req, bound, tr, verify_engine=engine,
                                     device="cpu").verify_engine == engine
    # the mesh is ported (tests/test_torch_mesh.py): a sharded problem and
    # run_dse over 2 shards give the serial result
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    from repro_torch.launch.mesh import MeshSpec
    assert psim.SwitchDSEProblem(req, bound, tr, mesh=2,
                                 device="cpu").mesh_spec == MeshSpec(devices=2)
    prob = psim.SwitchDSEProblem(req, bound, tr, back_annotation=False,
                                 device="cpu")
    serial = pcore.run_dse(prob, pcore.SLA(), pcore.ResourceBudget({}))
    prob2 = psim.SwitchDSEProblem(req, bound, tr, back_annotation=False,
                                  device="cpu")
    sharded = pcore.run_dse(prob2, pcore.SLA(), pcore.ResourceBudget({}), mesh=2)
    assert prob2.mesh_spec == MeshSpec(devices=2)
    assert ([(c.short(), v.p99_latency_ns, v.drop_rate) for c, v in sharded.pareto]
            == [(c.short(), v.p99_latency_ns, v.drop_rate) for c, v in serial.pareto])
    # the token server's production mesh is ported with training: a host
    # without its 512 devices refuses it with the mesh's device-count message
    from repro_torch.launch import serve as launch_serve
    assert launch_serve.main(["--arch", "llama3.2-1b", "--smoke", "--mesh", "multi",
                              "--device", "cpu"]) == 2
    with pytest.raises(ValueError, match="needs 512 devices but only 2"):
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh(multi_pod=True, device="cpu")
    # the ring-scan engine and fabrics are ported (tests/test_torch_ring_scan.py,
    # tests/test_torch_fabric.py): no refusal
    [v] = psim.run_netsim_batched(pcore.enumerate_candidates(req)[:1], bound,
                                  tr, back_annotation=False, use_kernel="off",
                                  device="cpu")
    assert v.meta["engine"] == "batched_netsim"
    from repro_torch.api import build_problem, registry as port_registry, run_scenario
    from repro_torch.fabric import FabricDSEProblem
    problem, _, _ = build_problem(port_registry["fattree_dc"], device="cpu")
    assert isinstance(problem, FabricDSEProblem)
    small = port_registry["hft"].override(back_annotation=False,
                                          trace_params={"duration_s": 8e-5})
    from repro_torch.api import strip_times
    assert (strip_times(run_scenario(small, mesh=2, device="cpu").to_dict())
            == strip_times(run_scenario(small, device="cpu").to_dict()))
    # search checkpoints are ported (tests/test_torch_checkpoint.py): the
    # three state functions run instead of refusing
    space = psearch.DesignSpace((psearch.Dim("a", (1, 2)),))
    eng = psearch.NSGA2Search(space, psearch.SearchSpec(population=4,
                                                        generations=1))
    ck = str(tmp_path / "ck")
    assert psearch.load_search_state(ck, space, eng.spec) is None
    psearch.save_search_state(ck, eng)
    assert psearch.load_search_state(ck, space, eng.spec).pending == eng.pending
    tree, extra = psearch.remesh_search_state(*eng.state(), 2)
    assert extra["mesh"] == {"devices": 2, "scenario_axis": 1}
