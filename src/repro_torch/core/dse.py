"""Progressive Constraint Satisfaction DSE — Algorithm 1 of the paper.

The engine is deliberately generic: a ``DSEProblem`` supplies templates,
timing, surrogate evaluation, buffer sizing and verification, and the engine
runs the paper's four stages:

  Stage 1  Static pruning        T_proc > (1+δ)·T_arrival ⇒ drop
  Stage 2  Coarse profiling      surrogate w/ infinite buffers; prune on p99 SLA
  Stage 3  Statistical sizing    d_opt from queue-occupancy histogram @ ε,
                                 aligned to physical memory; prune on resources
  Stage 4  Verification          full simulation of the sized survivors, fanned
                                 through one ``verify_batch`` call

Two concrete problems implement this interface:
  * ``repro.sim.switch_problem.SwitchDSEProblem``  — the paper's FPGA switch
  * ``repro.comm.dse_comm.CommDSEProblem``         — the TPU comm/dispatch layer
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pareto import pareto_front

if TYPE_CHECKING:                      # import cycle: search imports this module
    from .search import DesignSpace, SearchSpec

__all__ = [
    "SLA",
    "ResourceBudget",
    "VERIFY_ENGINES",
    "USE_KERNEL_MODES",
    "SurrogateResult",
    "VerifyResult",
    "DSEProblem",
    "DSEResult",
    "StageLog",
    "run_dse",
    "stage1_static",
    "stage2_screen",
    "stage3_size",
    "stage3_verify",
    "stage4_verify",
    "finalize_result",
    "check_index_aligned",
    "depth_for_drop_rate",
    "IncrementalDSE",
]


#: stage-4 policy vocabulary — the single source of truth shared by the
#: switch problem, the Scenario `Fidelity` spec and the CLI flag:
#: "netsim"  — every sized survivor through the batched finite-buffer sim,
#: "cycle"   — every survivor through the cycle-accurate datapath (slow),
#: "auto"    — netsim for the front, cycle-sim for the champion only
#: (via the `escalate` hook).
VERIFY_ENGINES = ("netsim", "cycle", "auto")

#: `use_kernel` knob vocabulary — shared by the switch problem, the Scenario
#: `Fidelity` spec and the CLI `--use-kernel` flag:
#: "auto" — the segmented netsim kernels when available (bit-exact oracle
#:          fallback otherwise; `SPAC_NETSIM_KERNEL=off` disables globally),
#: "on"   — force the kernel engines,
#: "off"  — force today's oracle scans (byte-identical legacy path).
USE_KERNEL_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class SLA:
    p99_latency_ns: float = math.inf
    drop_rate: float = 1e-3          # ε: target tail drop rate for sizing
    min_throughput_gbps: float = 0.0


@dataclasses.dataclass(frozen=True)
class ResourceBudget:
    """Generic resource vector; keys are resource names (LUT/BRAM/… or bytes)."""

    limits: Dict[str, float]

    def admits(self, usage: Dict[str, float]) -> bool:
        return all(usage.get(k, 0.0) <= v for k, v in self.limits.items())


@dataclasses.dataclass
class SurrogateResult:
    """Stage-2 output: infinite-buffer queue occupancy histogram + latencies."""

    q_occupancy: np.ndarray       # samples (or histogram support) of max queue depth
    latency_ns: np.ndarray        # per-packet latency samples
    throughput_gbps: float = 0.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def p(self, q: float) -> float:
        return float(np.percentile(self.latency_ns, q)) if self.latency_ns.size else math.inf


@dataclasses.dataclass
class VerifyResult:
    p99_latency_ns: float
    mean_latency_ns: float
    drop_rate: float
    throughput_gbps: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def meets(self, sla: SLA) -> bool:
        return (
            self.p99_latency_ns <= sla.p99_latency_ns
            and self.drop_rate <= sla.drop_rate * 1.5  # discretised sizing slack
            and self.throughput_gbps >= sla.min_throughput_gbps
        )


class DSEProblem:
    """Interface Algorithm 1 runs against (override all methods)."""

    #: optional ``repro_torch.launch.mesh.MeshSpec`` — problems whose batched
    #: stages can shard the candidate axis read it; results must be
    #: bit-identical to the serial default (None)
    mesh_spec = None

    def candidates(self) -> List[Any]:
        raise NotImplementedError

    def static_timing(self, cand) -> Tuple[float, float]:
        """Return (T_proc, T_arrival) in seconds for stage-1 pruning."""
        raise NotImplementedError

    def surrogate(self, cand) -> SurrogateResult:
        """Infinite-buffer statistical simulation (stage 2)."""
        raise NotImplementedError

    def surrogate_batch(self, cands: Sequence[Any]) -> List[SurrogateResult]:
        """Stage-2 fan-out hook: evaluate a whole candidate batch at once.

        Results must be index-aligned with ``cands``.  The default is the
        serial fallback (one ``surrogate`` call per candidate); problems with
        a vectorised surrogate override this — e.g. the switch problem fans
        candidates out through the batched JAX engine
        (``repro.sim.batched_surrogate``) so thousands of templates cost one
        jitted scan instead of thousands of Python loops.  Stage 3 consumes
        the returned occupancy samples unchanged."""
        return [self.surrogate(c) for c in cands]

    def size_buffers(self, cand, q_occupancy: np.ndarray, eps: float):
        """Map occupancy histogram to a sized candidate (stage 3)."""
        raise NotImplementedError

    def resources(self, cand) -> Dict[str, float]:
        raise NotImplementedError

    def verify(self, cand) -> VerifyResult:
        """High-fidelity simulation of the sized candidate (stage 4)."""
        raise NotImplementedError

    def verify_batch(self, cands: Sequence[Any]) -> List[VerifyResult]:
        """Stage-4 fan-out hook: verify a whole sized-candidate batch at once.

        The mirror of ``surrogate_batch`` one rung up the fidelity ladder:
        ``stage3_verify`` sizes *all* explored candidates first, then fans the
        sized survivors through one call here.  Results must be index-aligned
        with ``cands``.  The default is the serial fallback (one ``verify``
        call per candidate); problems with a batched verifier override it —
        the switch problem runs the finite-buffer event simulator as one
        jitted scan with sized VOQ depths as a batch axis
        (``repro.sim.batched_netsim``), the comm problem vectorises its
        analytic fabric metrics."""
        return [self.verify(c) for c in cands]

    def space(self) -> Optional["DesignSpace"]:
        """Parameterized design space for the generational search engine.

        Where ``candidates()`` returns a *pre-built list* of templates, this
        returns per-dimension ranges (``repro.core.search.DesignSpace``) that
        NSGA-II samples — so the joint space can be combinatorially larger
        than anything worth enumerating.  Problems that support search
        override this together with ``decode``; the default (None) keeps the
        problem exhaustive-only."""
        return None

    def decode(self, assignment: Dict[str, Any]) -> Any:
        """Materialise one ``space()`` point (a name->choice dict) into a
        candidate — the inverse of a genome, used by the search engine."""
        raise NotImplementedError

    def surrogate_objectives(self, cand, sr: SurrogateResult) -> Tuple[float, float]:
        """Stage-2-fidelity (latency, primary-resource) pair for the search
        engine (minimise both).  Mirrors ``objectives`` one rung down the
        ladder: the generational engine ranks whole populations on surrogate
        results long before anything is sized or verified."""
        res = self.resources(cand)
        primary = res.get("bram", res.get("bytes_per_device", sum(res.values())))
        return (sr.p(99), float(primary))

    def escalate(self, cand, v: VerifyResult) -> Optional[VerifyResult]:
        """Optional champion escalation to a higher fidelity rung.

        Called once per DSE with the winning (candidate, verify) pair; a
        problem may re-verify the champion on a more faithful engine (e.g.
        the cycle-accurate datapath under ``verify_engine="auto"``) and
        return that result — it is attached as ``meta["escalated"]`` on the
        champion's verify, never replacing the ranking metrics (so the
        Pareto front is engine-independent).  Default: no escalation."""
        return None

    def objectives(self, cand, verify: VerifyResult) -> Tuple[float, float]:
        """(latency, primary-resource) pair for ranking/Pareto (minimise both)."""
        res = self.resources(cand)
        primary = res.get("bram", res.get("bytes_per_device", sum(res.values())))
        return (verify.p99_latency_ns, float(primary))

    def diversity_key(self, cand):
        """Architecture-family key: stage 3 verifies the best candidate of
        every family in addition to the global top-K, so a surrogate ranking
        bias cannot starve a whole scheduler/buffer family of verification."""
        return None


@dataclasses.dataclass
class StageLog:
    stage: str
    considered: int
    survived: int
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DSEResult:
    best: Optional[Any]
    best_verify: Optional[VerifyResult]
    pareto: List[Tuple[Any, VerifyResult]]
    evaluated: List[Tuple[Any, VerifyResult, Dict[str, float], bool]]
    logs: List[StageLog]

    def summary(self) -> str:
        lines = [f"DSE: {len(self.evaluated)} verified, {len(self.pareto)} on Pareto front"]
        for lg in self.logs:
            lines.append(f"  [{lg.stage}] {lg.considered} -> {lg.survived}")
        if self.best is not None and self.best_verify is not None:
            lines.append(
                f"  best: {getattr(self.best, 'short', lambda: repr(self.best))()} "
                f"p99={self.best_verify.p99_latency_ns:.1f}ns "
                f"drop={self.best_verify.drop_rate:.2e} "
                f"thru={self.best_verify.throughput_gbps:.1f}Gbps"
            )
        return "\n".join(lines)


def check_index_aligned(problem: DSEProblem, results: Sequence[Any],
                        cands: Sequence[Any], hook: str) -> None:
    """One home for the batch-hook alignment error, shared by the staged
    engine and the search driver so the message can never drift."""
    if len(results) != len(cands):
        raise ValueError(
            f"{type(problem).__name__}.{hook} returned {len(results)} "
            f"results for a {len(cands)}-candidate batch (result shape "
            f"[{len(results)}] vs candidate shape [{len(cands)}]); results "
            "must be index-aligned")


def depth_for_drop_rate(q_occupancy: np.ndarray, eps: float) -> int:
    """Smallest depth d with P(occupancy > d) <= ε (stage 3 core)."""
    q = np.asarray(q_occupancy, dtype=np.float64)
    if q.size == 0:
        return 1
    d = float(np.quantile(q, 1.0 - eps, method="higher"))
    return max(1, int(math.ceil(d)))


def stage1_static(problem: DSEProblem, *, delta: float = 0.2) -> Tuple[List[Any], StageLog]:
    """Stage 1: static timing pruning over the enumerated templates."""
    cands = list(problem.candidates())
    active = []
    for a in cands:
        t_proc, t_arrival = problem.static_timing(a)
        if t_proc <= (1.0 + delta) * t_arrival:
            active.append(a)
    return active, StageLog("stage1-static", len(cands), len(active))


def stage2_screen(
    problem: DSEProblem,
    active: Sequence[Any],
    sla: SLA,
    *,
    surrogates: Optional[Sequence[SurrogateResult]] = None,
) -> Tuple[List[Tuple[Any, SurrogateResult]], StageLog]:
    """Stage 2: coarse-grained profiling + SLA screening.

    ``surrogates`` lets a caller inject precomputed stage-2 results (index-
    aligned with ``active``) — the campaign runner uses this to fan *several*
    scenarios' candidates through one batched-engine call and hand each
    scenario its slice back.  When absent, the problem's ``surrogate_batch``
    hook runs (vectorised where the problem provides it, serial otherwise).
    """
    active = list(active)
    srs = list(surrogates) if surrogates is not None else problem.surrogate_batch(active)
    check_index_aligned(problem, srs, active, "surrogate_batch")
    valid: List[Tuple[Any, SurrogateResult]] = []
    for a, sr in zip(active, srs):
        if sr.p(99) <= sla.p99_latency_ns and sr.throughput_gbps >= sla.min_throughput_gbps:
            valid.append((a, sr))
    return valid, StageLog("stage2-surrogate", len(active), len(valid))


def stage3_size(
    problem: DSEProblem,
    valid: Sequence[Tuple[Any, SurrogateResult]],
    sla: SLA,
    budget: ResourceBudget,
    *,
    top_k: int = 8,
) -> Tuple[List[Tuple[Any, Dict[str, float]]], int]:
    """Stage 3 alone: exploration, statistical sizing, resource pruning.

    TopKLatency: explore the K best candidates by surrogate p99, plus the
    best of each architecture family (diversity-preserving).  Every explored
    candidate is sized from its occupancy histogram and priced; survivors of
    the budget come back as index-stable ``(sized, resources)`` pairs so the
    whole batch can fan through one ``verify_batch`` call.
    """
    valid = sorted(valid, key=lambda av: av[1].p(99))
    explored = list(valid[: top_k if top_k > 0 else len(valid)])
    seen_keys = {id(a) for a, _ in explored}
    families = {}
    for a, sr in valid:
        k = problem.diversity_key(a)
        if k is not None and k not in families:
            families[k] = (a, sr)
    for a, sr in families.values():
        if id(a) not in seen_keys:
            explored.append((a, sr))
    sized: List[Tuple[Any, Dict[str, float]]] = []
    for a, sr in explored:
        s = problem.size_buffers(a, sr.q_occupancy, sla.drop_rate)
        if s is None:
            continue
        res = problem.resources(s)
        if not budget.admits(res):
            continue
        sized.append((s, res))
    return sized, len(explored)


def stage4_verify(
    problem: DSEProblem,
    sized: Sequence[Tuple[Any, Dict[str, float]]],
    sla: SLA,
    *,
    verifies: Optional[Sequence[VerifyResult]] = None,
) -> Tuple[List[Tuple[Any, VerifyResult, Dict[str, float], bool]],
           Optional[Any], Optional[VerifyResult]]:
    """Stage 4: fan the sized survivors through one ``verify_batch`` call.

    ``verifies`` lets a caller inject precomputed verification results
    (index-aligned with ``sized``) — the campaign runner uses this to batch
    stage 4 across scenarios sharing a (trace, bound protocol, engine)
    exactly as it already batches stage 2.  The champion is escalated via
    ``problem.escalate`` (a no-op by default)."""
    cands = [a for a, _ in sized]
    vs = list(verifies) if verifies is not None else problem.verify_batch(cands)
    check_index_aligned(problem, vs, cands, "verify_batch")
    evaluated: List[Tuple[Any, VerifyResult, Dict[str, float], bool]] = []
    best: Optional[Any] = None
    best_v: Optional[VerifyResult] = None
    for (a, res), v in zip(sized, vs):
        feasible = v.meets(sla)
        evaluated.append((a, v, res, feasible))
        if feasible:
            if best_v is None or problem.objectives(a, v) < problem.objectives(best, best_v):
                best, best_v = a, v
    if best is not None:
        esc = problem.escalate(best, best_v)
        if esc is not None:
            best_v.meta["escalated"] = esc
    return evaluated, best, best_v


def stage3_verify(
    problem: DSEProblem,
    valid: Sequence[Tuple[Any, SurrogateResult]],
    sla: SLA,
    budget: ResourceBudget,
    *,
    top_k: int = 8,
    verifies: Optional[Sequence[VerifyResult]] = None,
) -> Tuple[List[Tuple[Any, VerifyResult, Dict[str, float], bool]],
           Optional[Any], Optional[VerifyResult], StageLog]:
    """Stages 3+4 composed: size all explored candidates, then verify the
    sized survivors in one batch (see ``stage3_size`` / ``stage4_verify``)."""
    sized, n_explored = stage3_size(problem, valid, sla, budget, top_k=top_k)
    evaluated, best, best_v = stage4_verify(problem, sized, sla,
                                            verifies=verifies)
    return evaluated, best, best_v, StageLog("stage3-sizing+verify",
                                             n_explored, len(sized))


def finalize_result(
    problem: DSEProblem,
    evaluated: List[Tuple[Any, VerifyResult, Dict[str, float], bool]],
    best: Optional[Any],
    best_v: Optional[VerifyResult],
    logs: List[StageLog],
) -> DSEResult:
    """Rank the verified candidates into a Pareto front and assemble the result."""
    feas = [(a, v) for a, v, _, ok in evaluated if ok] or [(a, v) for a, v, _, _ in evaluated]
    front = pareto_front(feas, key=lambda av: problem.objectives(av[0], av[1])) if feas else []
    return DSEResult(best=best, best_verify=best_v, pareto=front, evaluated=evaluated, logs=logs)


def run_dse(
    problem: DSEProblem,
    sla: SLA,
    budget: ResourceBudget,
    *,
    delta: float = 0.2,
    top_k: int = 8,
    verbose: bool = False,
    search: Optional["SearchSpec"] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    mesh=None,
) -> DSEResult:
    """Algorithm 1: Progressive Constraint Satisfaction.

    Composed from the staged functions above so callers that need to
    interleave stages across problems (``repro.api.run_campaign`` batches
    stage 2 across scenarios) reuse the exact same semantics.

    ``search`` replaces the exhaustive stage-1/2 enumeration with the
    generational NSGA-II engine over ``problem.space()`` (seeded, resumable
    — see ``repro.core.search``): the engine's final archive plays the role
    of the screened ``valid`` set, and stages 3-4 run unchanged, so
    verification semantics are identical either way.  ``checkpoint_dir`` /
    ``resume`` control search-state persistence (``checkpoint_dir`` defaults
    to ``search.checkpoint_dir``).

    ``mesh`` is an optional ``repro_torch.launch.mesh.MeshSpec`` (or device
    count) set on ``problem.mesh_spec``: batched stages shard their
    candidate axis across the device mesh, bit-identical to the serial
    default.
    """
    if mesh is not None:
        from repro_torch.launch.mesh import MeshSpec
        problem.mesh_spec = MeshSpec.coerce(mesh)
    if search is not None:
        from .search import run_search
        outcome = run_search(problem, search, sla, delta=delta,
                             checkpoint_dir=checkpoint_dir, resume=resume)
        valid, logs = outcome.valid, [outcome.log]
        if verbose:
            print(outcome.log)
    else:
        active, log1 = stage1_static(problem, delta=delta)
        if verbose:
            print(log1)
        valid, log2 = stage2_screen(problem, active, sla)
        if verbose:
            print(log2)
        logs = [log1, log2]
    evaluated, best, best_v, log3 = stage3_verify(problem, valid, sla, budget, top_k=top_k)
    if verbose:
        print(log3)
    return finalize_result(problem, evaluated, best, best_v, logs + [log3])


class IncrementalDSE:
    """Algorithm 1 as a per-request state machine for an external batcher.

    The staged functions above run one request's whole batch per call; the
    serving engine (``repro.api.service``) instead multiplexes many
    concurrent requests through *shared* fixed-width jitted calls, so it
    needs each request's stage work exposed as "which candidates do you need
    evaluated next, at which fidelity?".  An ``IncrementalDSE`` holds one
    request's Algorithm-1 state:

    * stage 1 runs at construction (host-side, cheap);
    * ``kind``/``pending`` expose the current evaluation queue —
      ``"surrogate"`` rows until stage 2 drains, then ``"verify"`` rows;
    * the owner evaluates any *prefix* of ``pending`` (batched together with
      other requests' rows) and hands the index-aligned results to
      ``feed()``; when a queue drains the machine advances — screen → size →
      verify → ``result``.

    Feeding results chunk-at-a-time is exact because both batch hooks are
    row-independent — the same invariant the campaign runner's
    cross-scenario batching already relies on, so a served request's
    ``DSEResult`` is identical to ``run_dse`` on the same problem.

    With a ``SearchSpec``, stage 2 becomes the generational ask/tell loop
    (``repro.core.search.SearchDriver``): ``pending`` is the current
    generation's population, and a fully-fed generation advances the engine
    exactly as the campaign's lockstep driver does.
    """

    def __init__(self, problem: DSEProblem, sla: SLA, budget: ResourceBudget,
                 *, delta: float = 0.2, top_k: int = 8,
                 search: Optional["SearchSpec"] = None,
                 checkpoint_dir: Optional[str] = None, resume: bool = False):
        self.problem = problem
        self.sla = sla
        self.budget = budget
        self.top_k = top_k
        self.kind = "surrogate"
        self.stage2_candidates = 0      # rows this request fanned out
        self.stage4_candidates = 0      # sized rows verified
        self._logs: List[StageLog] = []
        self._pending: List[Any] = []
        self._fed: List[Any] = []
        self._sized: List[Tuple[Any, Dict[str, float]]] = []
        self._n_explored = 0
        self._result: Optional[DSEResult] = None
        self._driver = None
        if search is not None:
            from .search import SearchDriver
            self._driver = SearchDriver(problem, search, sla, delta=delta,
                                        checkpoint_dir=checkpoint_dir,
                                        resume=resume)
            self._ask()
        else:
            self._active, log1 = stage1_static(problem, delta=delta)
            self._logs.append(log1)
            self._pending = list(self._active)
            self.stage2_candidates = len(self._active)
            if not self._pending:
                self._finish_stage2()

    # -------------------------------------------------------------- queries
    @property
    def done(self) -> bool:
        return self._result is not None

    @property
    def result(self) -> DSEResult:
        if self._result is None:
            raise ValueError("IncrementalDSE still has pending work")
        return self._result

    @property
    def pending(self) -> List[Any]:
        """Candidates awaiting evaluation at the current ``kind`` fidelity.
        The owner may evaluate any prefix and ``feed()`` it back."""
        return list(self._pending)

    # ------------------------------------------------------------- advance
    def _ask(self) -> None:
        """Generational mode: advance to the next non-empty population (an
        ask can come back empty when every genome was pruned or answered
        from the phenotype cache — tell the engine and move on)."""
        while not self._driver.done:
            cands = self._driver.ask_candidates()
            if cands:
                self._pending = list(cands)
                self._fed = []
                return
            self._driver.tell_candidates([])
        self._finish_stage2()

    def feed(self, results: Sequence[Any]) -> None:
        """Hand back index-aligned results for the first ``len(results)``
        entries of ``pending``; drained queues advance the stage machine."""
        if self.done:
            raise ValueError("IncrementalDSE is already finished")
        results = list(results)
        if len(results) > len(self._pending):
            raise ValueError(
                f"fed {len(results)} results for {len(self._pending)} "
                "pending candidates; feed at most the pending prefix")
        self._fed.extend(results)
        del self._pending[:len(results)]
        if self._pending:
            return
        if self.kind == "surrogate":
            if self._driver is not None:
                self._driver.tell_candidates(self._fed)
                self._ask()
            else:
                self._finish_stage2()
        else:
            self._finish()

    def _finish_stage2(self) -> None:
        if self._driver is not None:
            outcome = self._driver.finalize()
            valid, log2 = outcome.valid, outcome.log
            # finalize()'s archive re-surrogation (resume path) counts as
            # stage-2 fan-out, matching run_scenario's accounting
            self.stage2_candidates = outcome.surrogate_rows
        else:
            valid, log2 = stage2_screen(self.problem, self._active, self.sla,
                                        surrogates=self._fed)
        self._logs.append(log2)
        self._sized, self._n_explored = stage3_size(
            self.problem, valid, self.sla, self.budget, top_k=self.top_k)
        self.kind = "verify"
        self._pending = [a for a, _ in self._sized]
        self._fed = []
        self.stage4_candidates = len(self._sized)
        if not self._pending:
            self._finish()

    def _finish(self) -> None:
        evaluated, best, best_v = stage4_verify(self.problem, self._sized,
                                                self.sla, verifies=self._fed)
        log3 = StageLog("stage3-sizing+verify", self._n_explored,
                        len(self._sized))
        self._result = finalize_result(self.problem, evaluated, best, best_v,
                                       self._logs + [log3])
        self.kind = "done"
