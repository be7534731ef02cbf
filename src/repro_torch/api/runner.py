"""Scenario execution: one spec in, a structured ``ScenarioReport`` out —
and campaign-level fan-out that batches stage 2 across scenarios.

``run_scenario`` is semantically identical to the legacy hand-wired path
(``optimize_switch`` / ``autotune_moe``): it builds the protocol, binds it,
materialises the trace, instantiates the domain's ``DSEProblem`` and runs
Algorithm 1 with the scenario's SLA/budget/fidelity.  The legacy wrappers
remain as thin compatibility shims over the same machinery.

``run_campaign`` exploits the staged DSE (``repro_torch.core.dse``): it prunes
every scenario (stage 1), fans *all* scenarios' surviving candidates through
the batched surrogate engine (stage 2), sizes each scenario's survivors
(stage 3), then fans *all* scenarios' sized candidates through the batched
stage-4 verifier — at both batched stages, scenarios that share a trace and
a bound protocol share one batched call, and every scenario reuses a cached
trace + feature analysis.  The campaign report carries aggregate stage-2
*and* stage-4 throughput (candidates/sec across the whole campaign).

The port's copy of the JAX package's ``api/runner.py``.  Every entry point
takes ``device`` (default: the first CUDA device; raises without one),
where the batched stages, back-annotation and the cycle-level switch run.
Single-switch, fabric and comm-domain scenarios run here; a scenario with a
mesh raises ``NotImplementedError`` (ROADMAP queue 1: mesh).  (A comm
scenario runs its fabric on one device whatever its mesh, as in the
reference.)
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.binding import BoundProtocol, bind
from repro_torch.core.dse import (DSEProblem, DSEResult, ResourceBudget, SLA,
                                  StageLog, SurrogateResult, VerifyResult,
                                  finalize_result, stage1_static, stage2_screen,
                                  stage3_size, stage4_verify)
from repro_torch.core.search import SearchDriver, run_search

from .registry import registry
from .scenario import MeshSpec, Scenario

__all__ = ["ScenarioReport", "CampaignReport", "build_bound", "build_problem",
           "run_scenario", "run_campaign"]


# --------------------------------------------------------------------------
# problem construction
# --------------------------------------------------------------------------

def build_bound(scenario: Scenario) -> BoundProtocol:
    """Protocol spec → built ``Protocol`` → semantic binding (§III-A)."""
    return bind(scenario.protocol.build(), scenario.semantic_binding(),
                flit_bits=scenario.flit_bits)


def _validate_addressing(scenario: Scenario, bound: BoundProtocol) -> None:
    """Fail at scenario-build time if an address field cannot address every
    port — ``compressed_protocol(addr_bits=2)`` on an 8-port scenario used to
    run (and silently alias destinations via ``dst % n_ports``).  Same rule
    the co-design stage-1 prune applies (``address_width_error``).  On a
    fabric scenario the routing field must address every *host in the
    topology*, not one switch's ports (``spac check`` SPAC106)."""
    from repro_torch.core.dsl import address_width_error
    n = (scenario.topology.build().n_hosts if scenario.topology is not None
         else scenario.arch.n_ports)
    for sem in ("routing_key", "src_key"):
        if not bound.has(sem):
            continue
        f = bound.protocol.field(bound.semantics[sem])
        err = address_width_error(sem, f.name, f.bits, n)
        if err is not None:
            raise ValueError(
                f"scenario {scenario.name!r}: protocol "
                f"{bound.protocol.name!r} {err}; widen the field")


def _default_budget(scenario: Scenario) -> ResourceBudget:
    if scenario.domain == "comm":
        return ResourceBudget({"bytes_per_device": 4e9})
    from repro_torch.sim.resources import ALVEO_U45N
    if scenario.topology is not None:
        # fabric resources are summed over every switch; the default budget
        # is one FPGA card per node
        n_nodes = sum(t.n_nodes for t in scenario.topology.build().tiers)
        return ResourceBudget({k: v * n_nodes for k, v in ALVEO_U45N.items()})
    return ResourceBudget(dict(ALVEO_U45N))


def _build_comm_problem(scenario: Scenario, device=None,
                        tensors=None) -> DSEProblem:
    """The comm scenario's ``CommDSEProblem`` on ``device``: the MoE layer's
    parameters and the routing sample drawn from the port's seeded
    generators (``seed`` and ``seed + 1`` of the scenario; they cannot give
    the reference's ``jax.random`` bits).  ``tensors`` (name -> tensor: any
    of ``router``, ``hash_proj``, ``w1``, ``wg``, ``w2`` and the sample
    ``x``) replaces the draw of each tensor it names; ``repro_torch.convert``
    carries the reference's across this way.  The fabric runs on one
    device; ``model_tp`` is the tensor extent the analytic model prices."""
    import torch

    from repro_torch.comm.dse_comm import CommDSEProblem
    from repro_torch.device import resolve_device
    from repro_torch.models import SINGLE_POD_PLAN, ModelConfig
    from repro_torch.models.moe import init_moe

    dev = resolve_device(device)
    c = scenario.comm
    cfg = ModelConfig(name=scenario.name, family="moe", n_layers=1,
                      d_model=c.d_model, n_heads=c.n_heads,
                      n_kv_heads=c.n_kv_heads, d_ff=c.d_ff, vocab=c.vocab,
                      moe_experts=c.moe_experts, moe_topk=c.moe_topk,
                      router=c.router)
    plan = SINGLE_POD_PLAN
    tensors = dict(tensors or {})
    params = init_moe(torch.Generator(dev).manual_seed(c.seed), cfg, plan)
    x = tensors.pop("x", None)
    if x is None:
        x = torch.randn((c.batch, c.seq, c.d_model),
                        generator=torch.Generator(dev).manual_seed(c.seed + 1),
                        dtype=torch.float32, device=dev).to(torch.bfloat16)
    unknown = set(tensors) - set(params)
    if unknown:
        raise ValueError(f"unknown MoE tensors {sorted(unknown)}")
    for name, t in tensors.items():
        if t.shape != params[name].shape or t.dtype != params[name].dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(params[name].shape)} {params[name].dtype}")
        params[name] = t.to(dev)
    want = (c.batch, c.seq, c.d_model)
    if tuple(x.shape) != want or x.dtype != torch.bfloat16:
        raise ValueError(f"x: {tuple(x.shape)} {x.dtype}, expected {want} "
                         "torch.bfloat16")
    return CommDSEProblem(params, cfg, plan, None, x.to(dev),
                          model_tp=c.model_tp)


def build_problem(
    scenario: Scenario,
    *,
    trace=None,
    features=None,
    mesh=None,
    device=None,
) -> Tuple[DSEProblem, SLA, ResourceBudget]:
    """Materialise the scenario into a ready-to-run ``DSEProblem``.

    ``trace``/``features`` let a campaign hand scenarios that share a
    ``TraceSpec`` one built trace and one feature analysis.  ``mesh``
    (a ``MeshSpec`` or device count) overrides ``scenario.mesh``; a mesh is
    not ported yet and raises.  ``device`` is where the problem runs
    (default: the first CUDA device).
    """
    mesh = MeshSpec.coerce(mesh) if mesh is not None else scenario.mesh
    budget = scenario.budget or _default_budget(scenario)
    if scenario.domain == "comm":
        # as in the reference, the comm fabric runs on one device whatever
        # the scenario's mesh
        return _build_comm_problem(scenario, device), scenario.sla, budget
    from repro_torch.sim.switch_problem import SwitchDSEProblem
    tr = trace if trace is not None else scenario.trace.build()
    if scenario.topology is not None:
        from repro_torch.fabric import FabricDSEProblem
        topo = scenario.topology.build()
        if scenario.co_design:
            if scenario.search is None:
                raise ValueError(
                    f"scenario {scenario.name!r}: co_design joint spaces are "
                    "generational-search territory — set a SearchSpec "
                    "(spac run --co-design --search nsga2)")
            problem = FabricDSEProblem(
                topo, scenario.arch, None, tr,
                back_annotation=scenario.fidelity.back_annotation,
                features=features,
                verify_engine=scenario.fidelity.verify_engine,
                use_kernel=scenario.fidelity.use_kernel,
                protocol_space=scenario.protocol.space(),
                binding=scenario.semantic_binding(),
                flit_bits=scenario.flit_bits,
                mesh=mesh, device=device)
            return problem, scenario.sla, budget
        bound = build_bound(scenario)
        _validate_addressing(scenario, bound)
        problem = FabricDSEProblem(
            topo, scenario.arch, bound, tr,
            back_annotation=scenario.fidelity.back_annotation,
            features=features,
            verify_engine=scenario.fidelity.verify_engine,
            use_kernel=scenario.fidelity.use_kernel,
            mesh=mesh, device=device)
        return problem, scenario.sla, budget
    if scenario.co_design:
        if scenario.search is None:
            raise ValueError(
                f"scenario {scenario.name!r}: co_design joint spaces are "
                "generational-search territory — set a SearchSpec "
                "(spac run --co-design --search nsga2)")
        problem = SwitchDSEProblem(
            scenario.arch, None, tr,
            back_annotation=scenario.fidelity.back_annotation,
            features=features,
            verify_engine=scenario.fidelity.verify_engine,
            use_kernel=scenario.fidelity.use_kernel,
            protocol_space=scenario.protocol.space(),
            binding=scenario.semantic_binding(),
            flit_bits=scenario.flit_bits,
            mesh=mesh, device=device)
        return problem, scenario.sla, budget
    bound = build_bound(scenario)
    _validate_addressing(scenario, bound)
    problem = SwitchDSEProblem(
        scenario.arch, bound, tr,
        back_annotation=scenario.fidelity.back_annotation,
        features=features,
        verify_engine=scenario.fidelity.verify_engine,
        use_kernel=scenario.fidelity.use_kernel,
        mesh=mesh, device=device)
    return problem, scenario.sla, budget


# --------------------------------------------------------------------------
# reports
# --------------------------------------------------------------------------

def _short(cand: Any) -> str:
    fn = getattr(cand, "short", None)
    return fn() if callable(fn) else repr(cand)


def _verify_dict(v: VerifyResult) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "p99_latency_ns": float(v.p99_latency_ns),
        "mean_latency_ns": float(v.mean_latency_ns),
        "drop_rate": float(v.drop_rate),
        "throughput_gbps": float(v.throughput_gbps),
    }
    fab = v.meta.get("fabric") if isinstance(v.meta, dict) else None
    if fab is not None:
        # end-to-end multi-hop metrics the single-switch path cannot express
        d["fabric"] = {
            "p50_latency_ns": float(fab["p50_latency_ns"]),
            "max_hops": int(fab["max_hops"]),
            "mean_hops": float(fab["mean_hops"]),
            "per_tier_drops": [int(x) for x in fab["per_tier_drops"]],
        }
    return d


def _protocol_dict(bound: Optional[BoundProtocol]) -> Optional[Dict[str, Any]]:
    """The winning wire layout, serialized field-by-field (report/golden)."""
    if bound is None:
        return None
    p = bound.protocol
    return {
        "name": p.name,
        "header_bits": int(p.header_bits),
        "header_bytes": int(p.header_bytes),
        "fields": [{"name": f.name, "bits": f.bits, "semantic": f.semantic}
                   for f in p.fields],
    }


@dataclasses.dataclass
class ScenarioReport:
    """Structured outcome of one scenario: Pareto front, best arch, verify
    metrics, resource report, stage logs.  ``problem``/``result`` are the
    live objects for further poking; ``to_dict()`` is the serializable view."""

    scenario: Scenario
    result: DSEResult
    problem: DSEProblem
    wall_time_s: float
    stage2_candidates: int = 0
    stage2_time_s: float = 0.0
    stage4_candidates: int = 0
    stage4_time_s: float = 0.0

    @property
    def best(self) -> Optional[Any]:
        return self.result.best

    @property
    def best_verify(self) -> Optional[VerifyResult]:
        return self.result.best_verify

    @property
    def pareto(self) -> List[Tuple[Any, VerifyResult]]:
        return self.result.pareto

    @property
    def resources(self) -> Dict[str, float]:
        if self.result.best is None:
            return {}
        return {k: float(v)
                for k, v in self.problem.resources(self.result.best).items()}

    @property
    def stage2_cands_per_sec(self) -> float:
        return self.stage2_candidates / max(self.stage2_time_s, 1e-12)

    @property
    def best_bound(self) -> Optional[BoundProtocol]:
        """The winning design's bound protocol: the co-design candidate's own
        decoded layout, or the scenario's fixed protocol (switch domain)."""
        if self.result.best is None:
            return None
        own = getattr(self.result.best, "bound", None)
        return own if own is not None else getattr(self.problem, "bound", None)

    def summary(self) -> str:
        head = (f"scenario {self.scenario.name!r} [{self.scenario.domain}] "
                f"({self.wall_time_s:.2f}s)")
        lines = [head, self.result.summary()]
        bound = self.best_bound
        if bound is not None and self.scenario.co_design:
            p = bound.protocol
            lines.append(
                f"  protocol: {p.name} — {p.header_bits} header bits "
                f"({p.header_bytes} B on the wire)")
        res = self.resources
        if res:
            lines.append("  resources: " + " ".join(
                f"{k}={v:,.0f}" for k, v in sorted(res.items()) if k != "bram"))
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario.to_dict(),
            "best": _short(self.result.best) if self.result.best is not None else None,
            "best_verify": (_verify_dict(self.result.best_verify)
                            if self.result.best_verify is not None else None),
            "best_protocol": _protocol_dict(self.best_bound),
            "resources": self.resources,
            "pareto": [
                {"candidate": _short(a), **_verify_dict(v)}
                for a, v in self.result.pareto
            ],
            "stages": [
                {"stage": lg.stage, "considered": lg.considered,
                 "survived": lg.survived, "notes": list(lg.notes)}
                for lg in self.result.logs
            ],
            "n_verified": len(self.result.evaluated),
            "wall_time_s": self.wall_time_s,
            "stage2_candidates": self.stage2_candidates,
            "stage2_time_s": self.stage2_time_s,
            "stage4_candidates": self.stage4_candidates,
            "stage4_time_s": self.stage4_time_s,
        }


@dataclasses.dataclass
class CampaignReport:
    """Per-scenario reports + aggregate batched stage-2/4 throughput."""

    name: str
    reports: List[ScenarioReport]
    stage2_candidates: int
    stage2_time_s: float
    stage2_batches: int
    shared_trace_scenarios: int      # scenarios that reused a cached trace
    wall_time_s: float
    stage4_candidates: int = 0
    stage4_time_s: float = 0.0
    stage4_batches: int = 0

    @property
    def stage2_cands_per_sec(self) -> float:
        return self.stage2_candidates / max(self.stage2_time_s, 1e-12)

    @property
    def stage4_cands_per_sec(self) -> float:
        return self.stage4_candidates / max(self.stage4_time_s, 1e-12)

    def __getitem__(self, name: str) -> ScenarioReport:
        for r in self.reports:
            if r.scenario.name == name:
                return r
        raise KeyError(name)

    def summary(self) -> str:
        lines = [f"campaign {self.name!r}: {len(self.reports)} scenarios "
                 f"in {self.wall_time_s:.2f}s"]
        for r in self.reports:
            best = _short(r.best) if r.best is not None else "infeasible"
            v = r.best_verify
            tail = (f" p99={v.p99_latency_ns:.0f}ns drop={v.drop_rate:.1e}"
                    if v is not None else "")
            lines.append(f"  {r.scenario.name:16s} -> {best}{tail}")
        lines.append(
            f"  stage-2 fan-out: {self.stage2_candidates} candidates in "
            f"{self.stage2_batches} batched calls, {self.stage2_time_s*1e3:.1f}ms "
            f"({self.stage2_cands_per_sec:.0f} cand/s aggregate; "
            f"{self.shared_trace_scenarios} scenario(s) shared a trace)")
        lines.append(
            f"  stage-4 fan-out: {self.stage4_candidates} sized candidates in "
            f"{self.stage4_batches} batched calls, {self.stage4_time_s*1e3:.1f}ms "
            f"({self.stage4_cands_per_sec:.0f} cand/s verify aggregate)")
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "scenarios": [r.to_dict() for r in self.reports],
            "stage2_candidates": self.stage2_candidates,
            "stage2_time_s": self.stage2_time_s,
            "stage2_cands_per_sec": self.stage2_cands_per_sec,
            "stage2_batches": self.stage2_batches,
            "stage4_candidates": self.stage4_candidates,
            "stage4_time_s": self.stage4_time_s,
            "stage4_cands_per_sec": self.stage4_cands_per_sec,
            "stage4_batches": self.stage4_batches,
            "shared_trace_scenarios": self.shared_trace_scenarios,
            "wall_time_s": self.wall_time_s,
        }


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _search_checkpoint_dir(scenario: Scenario, *, campaign: bool = False) -> Optional[str]:
    """Campaigns nest each scenario's search state under its own name so one
    ``checkpoint_dir`` serves the whole sweep."""
    spec = scenario.search
    if spec is None or not spec.checkpoint_dir:
        return None
    return (os.path.join(spec.checkpoint_dir, scenario.name)
            if campaign else spec.checkpoint_dir)


def run_scenario(scenario: Union[Scenario, str], *, verbose: bool = False,
                 resume: bool = False, mesh=None, device=None,
                 problem: Optional[DSEProblem] = None) -> ScenarioReport:
    """One spec in, verified Pareto front out (the quickstart in one call).

    Runs the same staged composition as ``run_dse`` (inlined only to time
    the batched surrogate call); ``tests/test_api.py`` asserts the stage
    logs and Pareto front stay identical to the legacy ``optimize_switch``
    → ``run_dse`` path, so the two cannot silently diverge.

    With ``scenario.search`` set, stages 1-2 are replaced by the seeded
    generational NSGA-II engine (``repro_torch.core.search``); the final
    archive feeds the identical stage-3/4 ladder.  ``resume`` continues a
    checkpointed search from ``search.checkpoint_dir`` (not ported yet:
    checkpoints raise).

    ``mesh`` (a ``MeshSpec`` / device count, winning over ``scenario.mesh``)
    is not ported yet and raises.  ``device`` is where the scenario runs
    (default: the first CUDA device).  ``problem`` is one already built for
    ``scenario`` (``repro_torch.convert.comm_problem`` builds one with the
    reference's tensors); by default it is built here, inside the wall time.
    """
    if isinstance(scenario, str):
        scenario = registry[scenario]
    t0 = time.perf_counter()
    if problem is None:
        problem, sla, budget = build_problem(scenario, mesh=mesh, device=device)
    else:
        sla = scenario.sla
        budget = scenario.budget or _default_budget(scenario)
    fid = scenario.fidelity
    if scenario.search is not None:
        t2 = time.perf_counter()
        outcome = run_search(problem, scenario.search, sla, delta=fid.delta,
                             checkpoint_dir=_search_checkpoint_dir(scenario),
                             resume=resume)
        stage2_time = time.perf_counter() - t2
        valid, pre_logs = outcome.valid, [outcome.log]
        stage2_cands = outcome.surrogate_rows
        if verbose:
            print(outcome.log)
    else:
        active, log1 = stage1_static(problem, delta=fid.delta)
        if verbose:
            print(log1)
        t2 = time.perf_counter()
        srs = problem.surrogate_batch(active)
        stage2_time = time.perf_counter() - t2
        valid, log2 = stage2_screen(problem, active, sla, surrogates=srs)
        if verbose:
            print(log2)
        pre_logs = [log1, log2]
        stage2_cands = len(active)
    sized, n_explored = stage3_size(problem, valid, sla, budget, top_k=fid.top_k)
    t4 = time.perf_counter()
    verifies = problem.verify_batch([a for a, _ in sized])
    stage4_time = time.perf_counter() - t4
    evaluated, best, best_v = stage4_verify(problem, sized, sla,
                                            verifies=verifies)
    log3 = StageLog("stage3-sizing+verify", n_explored, len(sized))
    if verbose:
        print(log3)
    result = finalize_result(problem, evaluated, best, best_v, pre_logs + [log3])
    return ScenarioReport(scenario=scenario, result=result, problem=problem,
                          wall_time_s=time.perf_counter() - t0,
                          stage2_candidates=stage2_cands,
                          stage2_time_s=stage2_time,
                          stage4_candidates=len(sized),
                          stage4_time_s=stage4_time)


@dataclasses.dataclass
class _Ctx:
    scenario: Scenario
    problem: DSEProblem
    budget: ResourceBudget
    shared_trace: bool
    group_key: Optional[str]                 # None -> own surrogate_batch call
    driver: Optional[SearchDriver] = None    # set iff scenario.search
    active: List[Any] = dataclasses.field(default_factory=list)
    log1: Optional[StageLog] = None
    surrogates: List[SurrogateResult] = dataclasses.field(default_factory=list)
    stage1_time_s: float = 0.0
    stage2_time_s: float = 0.0               # this scenario's share of its batch
    stage2_candidates: int = 0               # rows this scenario fanned out
    # --- stages 2-screen + 3 (sizing), filled before the stage-4 fan-out
    log2: Optional[StageLog] = None
    sized: List[Any] = dataclasses.field(default_factory=list)
    n_explored: int = 0
    stage3_time_s: float = 0.0
    verifies: List[VerifyResult] = dataclasses.field(default_factory=list)
    stage4_time_s: float = 0.0               # this scenario's share of its batch


def _switch_group_key(s: Scenario) -> str:
    """Scenarios share one batched stage-2 call iff this key matches: the
    batched engine takes one (trace, bound protocol, back-annotation) tuple."""
    return json.dumps({
        "trace": s.trace.to_dict(),
        "protocol": s.protocol.to_dict(),
        "flit_bits": s.flit_bits,
        "binding": s.binding,
        "back_annotation": s.fidelity.back_annotation,
        "use_kernel": s.fidelity.use_kernel,
        "co_design": s.co_design,
        # a fabric problem's batched calls evaluate per-tier designs over a
        # topology-specific hop decomposition — only identical topologies
        # (incl. the single-switch None) may share one call
        "topology": (s.topology.to_dict() if s.topology is not None else None),
    }, sort_keys=True)


def _verify_group_key(ctx: _Ctx) -> str:
    """Scenarios share one batched stage-4 call iff this key matches: the
    stage-2 key plus the verify engine (sized candidates from two scenarios
    may ride one batched netsim call only if the same rung verifies both)."""
    if ctx.group_key is None:
        return None
    return (ctx.group_key + "|" + ctx.scenario.fidelity.verify_engine
            + "|" + ctx.scenario.fidelity.use_kernel)


def run_campaign(
    scenarios: Sequence[Union[Scenario, str]],
    *,
    name: str = "campaign",
    verbose: bool = False,
    resume: bool = False,
    mesh=None,
    device=None,
) -> CampaignReport:
    """Run many scenarios with shared trace analysis and batched stage 2.

    Per-scenario results are identical to ``run_scenario`` (candidates of the
    batched engine are row-independent), so a campaign is never a fidelity
    trade-off — only a throughput one.

    Scenarios carrying a ``search`` spec run their generational engines in
    *lockstep*: each round, every active engine's pending population joins
    its group's single batched surrogate call (groups share a trace + bound
    protocol exactly as in exhaustive stage 2), so N searching scenarios
    still cost one batched call per group per generation.  ``resume``
    continues each scenario's checkpointed search from
    ``search.checkpoint_dir/<scenario name>``.

    ``mesh`` (a ``MeshSpec`` / device count, winning over each scenario's
    own ``mesh``) is not ported yet and raises.  ``device`` is where every
    scenario runs (default: the first CUDA device).
    """
    scns = [registry[s] if isinstance(s, str) else s for s in scenarios]
    if not scns:
        raise ValueError("run_campaign needs at least one scenario")
    t_start = time.perf_counter()

    # ---- build: share built traces + feature analysis across scenarios
    from repro_torch.core.features import analyze
    trace_cache: Dict[str, Tuple[Any, Any]] = {}
    ctxs: List[_Ctx] = []
    for s in scns:
        if s.domain == "switch":
            tkey = s.trace.key()
            shared = tkey in trace_cache
            if not shared:
                tr = s.trace.build()
                trace_cache[tkey] = (tr, analyze(tr))
            tr, feats = trace_cache[tkey]
            problem, _, budget = build_problem(s, trace=tr, features=feats,
                                               mesh=mesh, device=device)
            ctxs.append(_Ctx(s, problem, budget, shared, _switch_group_key(s)))
        else:
            problem, _, budget = build_problem(s, mesh=mesh, device=device)
            ctxs.append(_Ctx(s, problem, budget, False, None))

    # ---- search engines: one driver per searching scenario
    for ctx in ctxs:
        s = ctx.scenario
        if s.search is not None:
            ctx.driver = SearchDriver(
                ctx.problem, s.search, s.sla, delta=s.fidelity.delta,
                checkpoint_dir=_search_checkpoint_dir(s, campaign=True),
                resume=resume)

    # ---- stage 1 per scenario (search drivers do their own static pruning)
    for ctx in ctxs:
        if ctx.driver is not None:
            continue
        t0 = time.perf_counter()
        ctx.active, ctx.log1 = stage1_static(ctx.problem,
                                             delta=ctx.scenario.fidelity.delta)
        ctx.stage1_time_s = time.perf_counter() - t0
        if verbose:
            print(f"[{ctx.scenario.name}] {ctx.log1}")

    # ---- stage 2: fan every scenario's survivors through the batched engine;
    # scenarios sharing (trace, bound, fidelity) share one call
    groups: Dict[str, List[_Ctx]] = {}
    order: List[str] = []
    for i, ctx in enumerate(ctxs):
        if ctx.driver is not None:
            continue
        key = ctx.group_key if ctx.group_key is not None else f"solo-{i}"
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(ctx)

    total_cands = 0
    stage2_time = 0.0
    n_batches = 0
    for key in order:
        members = groups[key]
        archs = [a for ctx in members for a in ctx.active]
        srs: List[SurrogateResult] = []
        elapsed = 0.0
        if archs:
            t0 = time.perf_counter()
            srs = members[0].problem.surrogate_batch(archs)
            elapsed = time.perf_counter() - t0
            stage2_time += elapsed
            n_batches += 1
            total_cands += len(archs)
        off = 0
        for ctx in members:
            ctx.surrogates = srs[off:off + len(ctx.active)]
            # apportion the batched call's cost by candidate share
            ctx.stage2_time_s = elapsed * len(ctx.active) / max(len(archs), 1)
            ctx.stage2_candidates = len(ctx.active)
            off += len(ctx.active)

    # ---- generational lockstep for searching scenarios: each round, every
    # active engine's pending population rides its group's one batched call
    sgroups: Dict[str, List[_Ctx]] = {}
    sorder: List[str] = []
    for i, ctx in enumerate(ctxs):
        if ctx.driver is None:
            continue
        key = (ctx.group_key if ctx.group_key is not None
               else f"solo-{i}") + "|search"
        if key not in sgroups:
            sgroups[key] = []
            sorder.append(key)
        sgroups[key].append(ctx)
    while any(not ctx.driver.done for key in sorder for ctx in sgroups[key]):
        for key in sorder:
            members = [ctx for ctx in sgroups[key] if not ctx.driver.done]
            if not members:
                continue
            asks = [ctx.driver.ask_candidates() for ctx in members]
            cands = [c for a in asks for c in a]
            elapsed = 0.0
            srs = []
            if cands:
                t0 = time.perf_counter()
                srs = members[0].problem.surrogate_batch(cands)
                elapsed = time.perf_counter() - t0
                stage2_time += elapsed
                n_batches += 1
                total_cands += len(cands)
            off = 0
            for ctx, a in zip(members, asks):
                ctx.driver.tell_candidates(srs[off:off + len(a)])
                ctx.stage2_time_s += elapsed * len(a) / max(len(cands), 1)
                ctx.stage2_candidates += len(a)
                off += len(a)

    # ---- stage-2 screening (or search finalize) + stage-3 sizing
    for ctx in ctxs:
        s = ctx.scenario
        t0 = time.perf_counter()
        if ctx.driver is not None:
            outcome = ctx.driver.finalize()
            valid, ctx.log2 = outcome.valid, outcome.log
            # match solo run_scenario accounting: finalize()'s archive
            # re-surrogation (resume path) counts as stage-2 fan-out
            ctx.stage2_candidates = outcome.surrogate_rows
        else:
            valid, ctx.log2 = stage2_screen(ctx.problem, ctx.active, s.sla,
                                            surrogates=ctx.surrogates)
        ctx.sized, ctx.n_explored = stage3_size(
            ctx.problem, valid, s.sla, ctx.budget, top_k=s.fidelity.top_k)
        ctx.stage3_time_s = time.perf_counter() - t0
        if verbose:
            print(f"[{s.name}] {ctx.log2}")

    # ---- stage 4: fan every scenario's sized survivors through the batched
    # verifier; scenarios sharing (trace, bound, fidelity, engine) share one
    # batched call, exactly as stage 2 shares the surrogate scan
    vgroups: Dict[str, List[_Ctx]] = {}
    vorder: List[str] = []
    for i, ctx in enumerate(ctxs):
        key = _verify_group_key(ctx) or f"solo-{i}"
        if key not in vgroups:
            vgroups[key] = []
            vorder.append(key)
        vgroups[key].append(ctx)

    total_verifies = 0
    stage4_time = 0.0
    n_vbatches = 0
    for key in vorder:
        members = vgroups[key]
        cands = [a for ctx in members for a, _ in ctx.sized]
        vs: List[VerifyResult] = []
        elapsed = 0.0
        if cands:
            t0 = time.perf_counter()
            vs = members[0].problem.verify_batch(cands)
            elapsed = time.perf_counter() - t0
            stage4_time += elapsed
            n_vbatches += 1
            total_verifies += len(cands)
        off = 0
        for ctx in members:
            ctx.verifies = vs[off:off + len(ctx.sized)]
            # apportion the batched call's cost by candidate share
            ctx.stage4_time_s = elapsed * len(ctx.sized) / max(len(cands), 1)
            off += len(ctx.sized)

    # ---- assemble per-scenario results
    reports: List[ScenarioReport] = []
    for ctx in ctxs:
        s = ctx.scenario
        t0 = time.perf_counter()
        evaluated, best, best_v = stage4_verify(ctx.problem, ctx.sized, s.sla,
                                                verifies=ctx.verifies)
        log3 = StageLog("stage3-sizing+verify", ctx.n_explored, len(ctx.sized))
        result = finalize_result(
            ctx.problem, evaluated, best, best_v,
            [lg for lg in (ctx.log1, ctx.log2, log3) if lg is not None])
        if verbose:
            print(f"[{s.name}] {log3}")
        reports.append(ScenarioReport(
            scenario=s, result=result, problem=ctx.problem,
            wall_time_s=(ctx.stage1_time_s + ctx.stage2_time_s
                         + ctx.stage3_time_s + ctx.stage4_time_s
                         + time.perf_counter() - t0),
            stage2_candidates=ctx.stage2_candidates,
            stage2_time_s=ctx.stage2_time_s,
            stage4_candidates=len(ctx.sized),
            stage4_time_s=ctx.stage4_time_s))

    return CampaignReport(
        name=name,
        reports=reports,
        stage2_candidates=total_cands,
        stage2_time_s=stage2_time,
        stage2_batches=n_batches,
        stage4_candidates=total_verifies,
        stage4_time_s=stage4_time,
        stage4_batches=n_vbatches,
        shared_trace_scenarios=sum(c.shared_trace for c in ctxs),
        wall_time_s=time.perf_counter() - t_start,
    )
