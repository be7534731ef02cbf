"""The port's multi-hop fabric layer (``repro_torch.fabric``) against the JAX
package.

Contract: on the four topologies of the reference's ``tests/test_fabric.py``
the port routes every (src, dst) pair, lists nodes and links and builds the
hop tables exactly as the reference does; ``evaluate_fabric_batched`` and
``surrogate_fabric_batched`` give the reference's results on a k=4 fat-tree
under both stage-4 engines (float64 latencies bitwise, drops exact); the
reference's fabric contract tests hold for the port (a 1-node ring is the
direct engine bit for bit, multi-hop equals a per-hop serial replay,
``VOQKind.SHARED`` is rejected, the per-tier genome splice, resources
summed over nodes, co-design dominates fixed Ethernet, the report's
multi-hop block); and the golden ``fattree_dc`` report reproduces on the
CPU under the golden harness's ``diff_reports``.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import fabric as ref_fabric  # noqa: E402
from repro.core import (ArchRequest, ForwardTableKind, VOQKind, bind,  # noqa: E402
                        compressed_protocol, enumerate_candidates)
from repro.traces import datacenter, uniform  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.api import Scenario, registry, run_scenario  # noqa: E402
from repro_torch.core import ResourceBudget, SLA, run_dse  # noqa: E402
from repro_torch.core.dsl import ethernet_ipv4_udp  # noqa: E402
from repro_torch.fabric import (FabricCandidate, FabricDSEProblem, FatTree,  # noqa: E402
                                LeafSpine, Ring, TIER_DIM_PREFIX,
                                evaluate_fabric_batched, fabric_routes,
                                flatten_tier_arch, surrogate_fabric_batched)
from repro_torch.sim import run_netsim, run_netsim_batched  # noqa: E402
from repro_torch.sim.backannotate import annotate  # noqa: E402
from repro_torch.sim.resources import ALVEO_U45N, synthesize  # noqa: E402
from repro_torch.sim.switch_problem import SwitchDSEProblem  # noqa: E402
from repro_torch.traces.base import Trace  # noqa: E402

from test_golden import diff_reports  # noqa: E402

REF_BOUND = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256)
BOUND = convert.from_reference(REF_BOUND)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

#: name -> (the port's topology, the reference's), as tests/test_fabric.py:44
TOPOLOGIES = {
    "fattree4": (FatTree(4), ref_fabric.FatTree(4)),
    "leafspine": (LeafSpine(leaves=2, spines=3, hosts_per_leaf=2),
                  ref_fabric.LeafSpine(leaves=2, spines=3, hosts_per_leaf=2)),
    "ring": (Ring(n_nodes=4, hosts_per_node=2),
             ref_fabric.Ring(n_nodes=4, hosts_per_node=2)),
    "ring1": (Ring(n_nodes=1, hosts_per_node=8),
              ref_fabric.Ring(n_nodes=1, hosts_per_node=8)),
}


def _nxn_candidates(n_ports, depths=(1, 64)):
    base = [a for a in enumerate_candidates(
        ArchRequest(n_ports=n_ports, addr_bits=4,
                    fwd=ForwardTableKind.MULTIBANK_HASH))
            if a.voq is VOQKind.NXN]
    return [a.with_depth(d) for a in base[:3] for d in depths]


def _assert_verify_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("drop_rate", "p99_latency_ns", "mean_latency_ns",
                  "throughput_gbps"):
            a, b = getattr(g, f), getattr(w, f)
            assert a == b or (math.isinf(a) and math.isinf(b)), (f, a, b)
        assert g.meta["delivered"] == w.meta["delivered"]
        np.testing.assert_array_equal(g.meta["latency_ns"], w.meta["latency_ns"])
        np.testing.assert_array_equal(g.meta["latency_full_ns"],
                                      w.meta["latency_full_ns"])
        assert g.meta["fabric"] == w.meta["fabric"]


# --------------------------------------------------------------------------
# routes and links
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_routes_links_and_hop_tables_equal_reference(name):
    topo, ref = TOPOLOGIES[name]
    assert topo.key() == ref.key()
    assert topo.nodes() == ref.nodes()
    assert topo.links() == ref.links()
    for src, dst in itertools.product(range(topo.n_hosts), repeat=2):
        hops = topo.route(src, dst)
        assert hops == ref.route(src, dst)
        assert hops and len(hops) <= topo.max_hops
        topo.validate_route(hops)
    tr = uniform(seed=2, n_ports=topo.n_hosts, duration_s=50e-6)
    got = fabric_routes(topo, convert.from_reference(tr))
    want = ref_fabric.fabric_routes(ref, tr)
    for f in ("n_hops", "tier_of", "flat_in", "flat_out"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_hops == want.max_hops


# --------------------------------------------------------------------------
# hop-composed evaluation against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True], ids=["ring", "fixed_point"])
def test_evaluate_fabric_equals_reference(use_kernel):
    topo, ref = TOPOLOGIES["fattree4"]
    tr = uniform(seed=1, n_ports=8, duration_s=100e-6)
    edge = _nxn_candidates(4, depths=(1, 16))
    tiers = [(edge[0], edge[3]), (edge[1], edge[4]), (edge[2], edge[2])]
    want = ref_fabric.evaluate_fabric_batched(
        ref, tiers, [(REF_BOUND, REF_BOUND)] * len(tiers), tr,
        back_annotation=False, use_kernel=use_kernel)
    got = evaluate_fabric_batched(
        topo, convert.from_reference(tiers), [(BOUND, BOUND)] * len(tiers),
        convert.from_reference(tr), back_annotation=False,
        use_kernel=use_kernel, device="cpu")
    assert any(v.drop_rate > 0 for v in want)
    _assert_verify_equal(got, want)


def test_surrogate_fabric_equals_reference():
    topo, ref = TOPOLOGIES["fattree4"]
    tr = datacenter(seed=0, n_ports=8)
    edge = _nxn_candidates(4, depths=(64,))
    tiers = [(edge[0], edge[1]), (edge[2], edge[0])]
    want = ref_fabric.surrogate_fabric_batched(
        ref, tiers, [(REF_BOUND, REF_BOUND)] * 2, tr)
    got = surrogate_fabric_batched(
        topo, convert.from_reference(tiers), [(BOUND, BOUND)] * 2,
        convert.from_reference(tr), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.q_occupancy, w.q_occupancy)
        np.testing.assert_array_equal(g.latency_ns, w.latency_ns)
        assert g.throughput_gbps == w.throughput_gbps
        assert g.meta == w.meta


# --------------------------------------------------------------------------
# the reference's fabric contract tests, on the port
# --------------------------------------------------------------------------

def test_single_hop_ring_is_bit_identical_to_direct_engine():
    topo = TOPOLOGIES["ring1"][0]
    tr = convert.from_reference(uniform(seed=0, n_ports=8))
    cands = convert.from_reference(_nxn_candidates(8))
    direct = run_netsim_batched(cands, BOUND, tr, back_annotation=False,
                                device="cpu")
    fabric = evaluate_fabric_batched(
        topo, [(a,) for a in cands], [(BOUND,) for _ in cands], tr,
        back_annotation=False, device="cpu")
    assert any(v.drop_rate > 0 for v in direct)      # the depths bind
    for a, d, f in zip(cands, direct, fabric):
        msg = a.short()
        assert f.drop_rate == d.drop_rate, msg
        assert f.meta["delivered"] == d.meta["delivered"], msg
        np.testing.assert_array_equal(f.meta["latency_full_ns"],
                                      d.meta["latency_full_ns"], err_msg=msg)
        assert f.p99_latency_ns == d.p99_latency_ns, msg
        assert f.mean_latency_ns == d.mean_latency_ns, msg
        assert f.meta["fabric"]["per_tier_drops"] == [
            int(d.drop_rate * d.meta["offered"])], msg


def test_multihop_matches_manual_per_hop_oracle():
    """Per hop: sort the masked arrivals, run the serial ``run_netsim`` on
    the flattened tier, forward ``t + latency*1e-9``, mask drops, sum
    latencies in ns; the batched evaluator agrees exactly."""
    topo = TOPOLOGIES["fattree4"][0]
    tr = convert.from_reference(uniform(seed=1, n_ports=8, duration_s=100e-6))
    arch = convert.from_reference(_nxn_candidates(4, depths=(1,))[0])
    tiers = (arch, arch.with_depth(16))
    hw = tuple(annotate(a, BOUND, source="model") for a in tiers)

    got = evaluate_fabric_batched(topo, [tiers], [(BOUND, BOUND)], tr,
                                  back_annotation=False, device="cpu")[0]

    routes = fabric_routes(topo, tr)
    t0 = np.asarray(tr.time_s, float)
    payload = np.asarray(tr.payload_bytes)
    arr, e2e = t0.copy(), np.zeros(t0.size)
    alive = np.ones(t0.size, bool)
    for s in range(routes.max_hops):
        for t, tier in enumerate(topo.tiers):
            sel = np.nonzero(routes.tier_of[s] == t)[0]
            if not sel.size:
                continue
            times = arr[sel].copy()
            if not alive[sel].all():
                live = times[alive[sel]]
                times[~alive[sel]] = (live.max() if live.size else 0.0) + 1.0
            # the oracle re-sorts per hop on purpose: it must independently
            # reproduce the evaluator's per-hop sorting, not share it
            perm = np.argsort(times, kind="stable")  # spaclint: disable=SPAC208
            sub = Trace(name=f"manual@{s}{t}", time_s=times[perm],
                        src=routes.flat_in[s, sel][perm].astype(np.int32),
                        dst=routes.flat_out[s, sel][perm].astype(np.int32),
                        payload_bytes=payload[sel][perm],
                        n_ports=tier.n_nodes * tier.degree,
                        link_gbps=tr.link_gbps)
            v = run_netsim(flatten_tier_arch(tiers[t], tier.n_nodes), BOUND,
                           sub, hw=hw[t], back_annotation=False)
            lat = np.empty(sel.size)
            lat[perm] = v.meta["latency_full_ns"]
            ok = alive[sel] & ~np.isnan(lat)
            arr[sel] = np.where(ok, arr[sel] + lat * 1e-9, arr[sel])
            e2e[sel] = np.where(ok, e2e[sel] + lat, e2e[sel])
            alive[sel] = ok

    assert got.drop_rate > 0                 # the masking path has teeth
    assert got.meta["delivered"] == int(alive.sum())
    np.testing.assert_array_equal(got.meta["latency_full_ns"],
                                  np.where(alive, e2e, np.nan))
    assert got.meta["fabric"]["mean_hops"] > 1.0
    assert got.meta["fabric"]["max_hops"] == 3


def _fabric_problem(bound, topo=None, **kwargs):
    return FabricDSEProblem(
        topo or TOPOLOGIES["fattree4"][0],
        convert.from_reference(ArchRequest(
            n_ports=4, addr_bits=4, fwd=ForwardTableKind.MULTIBANK_HASH,
            voq=VOQKind.NXN)),
        bound, convert.from_reference(datacenter(seed=0, n_ports=8)),
        back_annotation=False, device="cpu", **kwargs)


def test_shared_voq_is_fabric_infeasible_everywhere():
    from repro_torch.core.archspec import VOQKind as PVOQ
    shared = [a for a in enumerate_candidates(
        ArchRequest(n_ports=4, addr_bits=4)) if a.voq is VOQKind.SHARED][0]
    with pytest.raises(ValueError, match="SHARED"):
        flatten_tier_arch(convert.from_reference(shared), 4)
    problem = _fabric_problem(BOUND)
    for p in problem.tier_problems:
        assert all(SwitchDSEProblem._arch(c).voq is not PVOQ.SHARED
                   for c in p.candidates())
        for d in p.space().dims:
            if d.name == "voq":
                assert PVOQ.SHARED not in d.choices


def test_fabric_space_is_the_per_tier_splice():
    problem = _fabric_problem(BOUND)
    space = problem.space()
    per_tier = problem.tier_problems[0].space()
    assert space.size() == per_tier.size() ** 2
    names = [d.name for d in space.dims]
    assert all(n.startswith(TIER_DIM_PREFIX(0)) or
               n.startswith(TIER_DIM_PREFIX(1)) for n in names)
    assignment = {d.name: (d.choices[0] if d.name.startswith("t0:")
                           else d.choices[-1]) for d in space.dims}
    cand = problem.decode(assignment)
    assert isinstance(cand, FabricCandidate) and len(cand.tiers) == 2
    archs = problem._tier_archs(cand)
    assert [a.n_ports for a in archs] == [4, 4]
    assert archs[0].bus_bits != archs[1].bus_bits
    assert len(problem.diversity_key(cand)) == 2


def test_fabric_resources_sum_over_nodes():
    problem = _fabric_problem(BOUND)
    cand = problem.candidates()[0]
    per_node = [synthesize(a, b) for a, b in
                zip(problem._tier_archs(cand), problem._tier_bounds(cand))]
    tot = problem.resources(cand)
    assert tot["luts"] == pytest.approx(
        per_node[0].luts * 4 + per_node[1].luts * 2)
    assert tot["bram"] == tot["brams"]


class _HomogeneousFabric(FabricDSEProblem):
    """Baseline problem: both tiers forced to one identical design."""

    def candidates(self):
        return [FabricCandidate(tiers=(a, a))
                for a in self.tier_problems[0].candidates()]


def test_codesign_strictly_dominates_homogeneous_ethernet():
    sla = SLA(p99_latency_ns=1e5, drop_rate=1e-2)
    budget = ResourceBudget({k: v * 6 for k, v in ALVEO_U45N.items()})
    req = convert.from_reference(ArchRequest(
        n_ports=4, addr_bits=4, fwd=ForwardTableKind.MULTIBANK_HASH,
        voq=VOQKind.NXN))
    tr = convert.from_reference(datacenter(seed=0, n_ports=8))
    topo = TOPOLOGIES["fattree4"][0]
    pc = FabricDSEProblem(topo, req, BOUND, tr, back_annotation=False,
                          device="cpu")
    front_c = [pc.objectives(a, v)
               for a, v in run_dse(pc, sla, budget, delta=2.5).pareto]
    pe = _HomogeneousFabric(topo, req, convert.from_reference(
        bind(ethernet_ipv4_udp(), flit_bits=256)), tr, back_annotation=False,
        device="cpu")
    front_e = [pe.objectives(a, v)
               for a, v in run_dse(pe, sla, budget, delta=2.5).pareto]
    assert front_c and front_e
    assert any(all(c[0] < e[0] and c[1] < e[1] for e in front_e)
               for c in front_c), (front_c, front_e)
    assert ethernet_ipv4_udp().header_bytes > BOUND.header_bytes


def test_fabric_report_carries_multi_hop_metrics():
    report = run_scenario(registry["fattree_dc"].override(
        back_annotation=False), device="cpu")
    assert report.best is not None
    fab = report.to_dict()["best_verify"]["fabric"]
    assert fab["max_hops"] == 3 and 1.0 < fab["mean_hops"] <= 3.0
    assert fab["p50_latency_ns"] <= report.result.best_verify.p99_latency_ns
    assert len(fab["per_tier_drops"]) == 2


def test_fabric_mesh_above_one_device_raises(monkeypatch):
    """With one device a fabric mesh of 2 raises, naming both counts; with
    two (forced) it evaluates, equal to the serial result."""
    topo = TOPOLOGIES["ring1"][0]
    tr = convert.from_reference(uniform(seed=0, n_ports=8).head(32))
    cands = [(convert.from_reference(a),) for a in _nxn_candidates(8)[:3]]
    bounds = [(BOUND,)] * len(cands)
    monkeypatch.delenv("REPRO_TORCH_FORCE_DEVICE_COUNT", raising=False)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        evaluate_fabric_batched(topo, cands, bounds, tr, mesh=2, device="cpu")
    problem = _fabric_problem(BOUND, mesh=2)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        problem.verify_batch(problem.candidates()[:2])
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICE_COUNT", "2")
    serial = evaluate_fabric_batched(topo, cands, bounds, tr, device="cpu")
    sharded = evaluate_fabric_batched(topo, cands, bounds, tr, mesh=2,
                                      device="cpu")
    for g, w in zip(sharded, serial):
        assert (g.drop_rate, g.p99_latency_ns) == (w.drop_rate, w.p99_latency_ns)
        np.testing.assert_array_equal(g.meta["latency_ns"], w.meta["latency_ns"])


# --------------------------------------------------------------------------
# the golden report
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", ["auto", "off"])
def test_golden_fattree_dc_reproduces(use_kernel):
    """``tests/golden/fattree_dc.json`` under the golden harness's rules,
    with the scenario's engine (auto: the fixed point) and with the ring
    scan, where the scenario's ``fidelity.use_kernel`` is the only field
    allowed to differ."""
    with open(os.path.join(GOLDEN, "fattree_dc.json")) as f:
        want = json.load(f)
    scen = Scenario.from_dict(want["scenario"])
    if use_kernel != "auto":
        scen = scen.override(use_kernel=use_kernel)
    got = json.loads(json.dumps(run_scenario(scen, device="cpu").to_dict()))
    if use_kernel != "auto":
        assert got["scenario"]["fidelity"].pop("use_kernel") == use_kernel
    assert diff_reports(got, want) == []
