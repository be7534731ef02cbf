"""Joint per-tier fabric DSE: one genome, one design per topology tier.

``FabricDSEProblem`` lifts the single-switch Progressive-Constraint-
Satisfaction problem to a network: each tier of the topology is its own
(arch, protocol) design point, evaluated end-to-end by the multi-hop
composition in ``fabric.evaluate``.  The genome is the per-tier splice —
tier t's architecture genes (and, under co-design, its ``proto:*`` layout
genes) ride the same NSGA-II genome under the ``t{t}:`` prefix, the exact
analogue of how ``PROTO_DIM_PREFIX`` splices protocol genes next to
architecture genes for one switch.

Each tier is internally a ``SwitchDSEProblem`` over a request with
``n_ports = tier.degree`` — re-using its decode memoisation, static timing,
sizing and pricing verbatim — with one fabric twist: the routing field must
address the *fabric host count*, not the tier's local port count
(``addressing_ports`` override), because a packet's destination id names a
host anywhere in the network.

The port's copy of the JAX package's ``fabric/problem.py``.  Every tier and
every fabric evaluation runs on ``device`` (default: the first CUDA
device), sharded over ``mesh`` as in ``SwitchDSEProblem``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.archspec import ArchRequest, SwitchArch, VOQKind
from repro_torch.core.dse import (DSEProblem, SurrogateResult, VerifyResult,
                            depth_for_drop_rate)
from repro_torch.core.search import DesignSpace, Dim
from repro_torch.sim.netsim import NetSimConfig
from repro_torch.sim.resources import synthesize
from repro_torch.sim.switch_problem import CoDesignCandidate, SwitchDSEProblem

from .evaluate import evaluate_fabric_batched, surrogate_fabric_batched
from .topology import Topology

__all__ = ["FabricCandidate", "FabricDSEProblem", "TIER_DIM_PREFIX"]


def TIER_DIM_PREFIX(tier: int) -> str:
    """Genome dimension-name prefix for tier ``tier``'s genes (checkpoint
    signatures include it, so per-tier resume round-trips by name)."""
    return f"t{tier}:"


@dataclasses.dataclass(frozen=True, eq=False)
class FabricCandidate:
    """One joint fabric phenotype: a per-tier tuple of single-switch
    candidates (``SwitchArch`` templates in classic mode,
    ``CoDesignCandidate`` phenotypes under co-design).  Identity is the
    tier tuple — both element kinds hash on their own phenotype identity,
    so search dedupe and checkpoint equivalence compose tier-wise."""

    tiers: Tuple[Any, ...]

    def __hash__(self):
        return hash(self.tiers)

    def __eq__(self, other):
        return isinstance(other, FabricCandidate) and self.tiers == other.tiers

    @property
    def infeasible(self) -> Optional[str]:
        for t, c in enumerate(self.tiers):
            if isinstance(c, CoDesignCandidate) and c.infeasible is not None:
                return f"tier {t}: {c.infeasible}"
        return None

    def short(self) -> str:
        return " || ".join(
            c.short() if hasattr(c, "short") else str(c) for c in self.tiers)


class _TierProblem(SwitchDSEProblem):
    """One tier's slice of the fabric problem: a stock switch problem over
    ``n_ports = degree``, minus ``VOQKind.SHARED`` (super-switch flattening
    would pool the shared cap across the tier's nodes — see
    ``fabric.evaluate``), plus fabric-wide routing addressability."""

    def __init__(self, *args, fabric_hosts: int, **kwargs):
        self._fabric_hosts = fabric_hosts
        super().__init__(*args, **kwargs)

    @property
    def addressing_ports(self) -> int:
        return self._fabric_hosts

    def candidates(self) -> List[SwitchArch]:
        return [a for a in super().candidates()
                if a.voq is not VOQKind.SHARED]

    def space(self, **kwargs) -> DesignSpace:
        base = super().space(**kwargs)
        dims = tuple(
            d if d.name != "voq" else Dim(
                "voq",
                tuple(v for v in d.choices if v is not VOQKind.SHARED)
                or (VOQKind.NXN,))
            for d in base.dims)
        return DesignSpace(dims)


class FabricDSEProblem(DSEProblem):
    """End-to-end multi-hop DSE over a topology of co-designed tiers.

    Same constructor vocabulary as ``SwitchDSEProblem`` plus the topology;
    ``request`` is the per-tier policy template — each tier's request is the
    template with ``n_ports`` set to that tier's degree, so one scenario
    parameterises every tier (homogeneous-tier: one design *per tier*, all
    nodes of a tier identical — the searchable fabric remains tractable
    while tiers still specialise independently).

    Objectives are the acceptance pair (end-to-end p99 latency, total fabric
    LUTs) with drop rate and the remaining tier resources carried through
    the SLA/budget constraints — sizing, screening and verification all run
    through the fabric-level evaluators."""

    def __init__(
        self,
        topology: Topology,
        request: ArchRequest,
        bound,
        trace,
        *,
        back_annotation: bool = True,
        headroom: float = 1.25,
        features=None,
        verify_engine: str = "netsim",
        protocol_space=None,
        binding=None,
        flit_bits: Optional[int] = None,
        require_seq: bool = False,
        mesh=None,
        use_kernel: str = "auto",
        device=None,
    ):
        if verify_engine not in ("netsim", "auto"):
            raise ValueError(
                f"fabric evaluation verifies with the batched netsim engine; "
                f"verify_engine={verify_engine!r} is not supported (the "
                f"cycle-accurate rung models one datapath, not a network)")
        self.topology = topology
        self.request = request
        self.trace = trace
        self.verify_engine = verify_engine
        self.tier_problems: List[_TierProblem] = []
        for tier in topology.tiers:
            tp = _TierProblem(
                dataclasses.replace(request, n_ports=tier.degree),
                bound, trace,
                fabric_hosts=topology.n_hosts,
                back_annotation=back_annotation, headroom=headroom,
                features=features, verify_engine="netsim",
                protocol_space=protocol_space, binding=binding,
                flit_bits=flit_bits, require_seq=require_seq,
                mesh=mesh, use_kernel=use_kernel, device=device)
            # campaigns analyze the trace once; later tiers share tier 0's
            features = tp.features
            self.tier_problems.append(tp)
        t0 = self.tier_problems[0]
        self.features = t0.features
        self.device = t0.device
        self.mesh_spec = t0.mesh_spec
        self.back_annotation = back_annotation
        self.headroom = headroom
        self.use_kernel = use_kernel
        self.bound = t0.bound
        self.cfg = NetSimConfig()

    @property
    def co_design(self) -> bool:
        return self.tier_problems[0].co_design

    @property
    def n_tiers(self) -> int:
        return self.topology.n_tiers

    # ------------------------------------------------------------ plumbing
    def _tier_archs(self, cand: FabricCandidate) -> Tuple[SwitchArch, ...]:
        return tuple(SwitchDSEProblem._arch(c) for c in cand.tiers)

    def _tier_bounds(self, cand: FabricCandidate):
        return tuple(p._bound_for(c)
                     for p, c in zip(self.tier_problems, cand.tiers))

    # ------------------------------------------------------------- stage 1
    def candidates(self) -> List[FabricCandidate]:
        """Exhaustive baseline: the cross product of the per-tier template
        enumerations (small explicit requests only — AUTO-heavy requests are
        search territory, exactly as for one switch)."""
        per_tier = [p.candidates() for p in self.tier_problems]
        return [FabricCandidate(tiers=combo)
                for combo in itertools.product(*per_tier)]

    def static_timing(self, cand: FabricCandidate) -> Tuple[float, float]:
        """Ratio encoding of the per-tier conjunction: every tier must clear
        its own line-rate bound, so stage 1's single ``t_proc <= (1+δ)·t_arr``
        comparison receives ``(max_t t_proc/t_arr, 1.0)`` — the fabric passes
        iff its slowest tier passes."""
        worst = 0.0
        for p, c in zip(self.tier_problems, cand.tiers):
            t_proc, t_arr = p.static_timing(c)
            if not math.isfinite(t_proc):
                return math.inf, 1.0
            worst = max(worst, t_proc / t_arr)
        return worst, 1.0

    # ------------------------------------------------------ search support
    def space(self) -> DesignSpace:
        """The per-tier splice: tier t's dims (architecture + ``proto:*``
        layout genes under co-design) join the genome under the ``t{t}:``
        prefix."""
        dims: List[Dim] = []
        for t, p in enumerate(self.tier_problems):
            prefix = TIER_DIM_PREFIX(t)
            dims.extend(Dim(prefix + d.name, d.choices)
                        for d in p.space().dims)
        return DesignSpace(tuple(dims))

    def decode(self, assignment: Dict[str, Any]) -> FabricCandidate:
        tiers = []
        for t, p in enumerate(self.tier_problems):
            prefix = TIER_DIM_PREFIX(t)
            sub = {k[len(prefix):]: v for k, v in assignment.items()
                   if k.startswith(prefix)}
            tiers.append(p.decode(sub))
        return FabricCandidate(tiers=tuple(tiers))

    # ------------------------------------------------------------- stage 2
    def surrogate(self, cand: FabricCandidate) -> SurrogateResult:
        return self.surrogate_batch([cand])[0]

    def surrogate_batch(self, cands) -> List[SurrogateResult]:
        cands = list(cands)
        if not cands:
            return []
        return surrogate_fabric_batched(
            self.topology,
            [self._tier_archs(c) for c in cands],
            [self._tier_bounds(c) for c in cands],
            self.trace,
            back_annotation=self.back_annotation,
            i_burst=self.features.i_burst, mesh=self.mesh_spec,
            use_kernel=self.use_kernel, device=self.device)

    # ------------------------------------------------------------- stage 3
    def size_buffers(self, cand: FabricCandidate, q_occupancy: np.ndarray,
                     eps: float) -> FabricCandidate:
        """Row t of the ``[n_tiers, max_len]`` NaN-padded occupancy stack
        sizes tier t's VOQ depth through the stock per-tier sizing rule; a
        tier no route traverses (all-NaN row) keeps its template depth."""
        stack = np.atleast_2d(np.asarray(q_occupancy, np.float64))
        sized = []
        for t, (p, c) in enumerate(zip(self.tier_problems, cand.tiers)):
            row = stack[t] if t < stack.shape[0] else np.array([])
            row = row[np.isfinite(row)]
            if row.size == 0:
                sized.append(c)
                continue
            sized.append(p.size_buffers(c, row, eps))
        return FabricCandidate(tiers=tuple(sized))

    def resources(self, cand: FabricCandidate) -> Dict[str, float]:
        """Summed tier resources: per-node synthesis × node count, totalled
        over tiers — the whole fabric's silicon."""
        tot = {"luts": 0.0, "ffs": 0.0, "brams": 0.0}
        for tier, p, c in zip(self.topology.tiers, self.tier_problems,
                              cand.tiers):
            rep = synthesize(SwitchDSEProblem._arch(c), p._bound_for(c))
            tot["luts"] += rep.luts * tier.n_nodes
            tot["ffs"] += rep.ffs * tier.n_nodes
            tot["brams"] += rep.brams * tier.n_nodes
        tot["bram"] = tot["brams"]
        return tot

    # ------------------------------------------------------------- stage 4
    def verify(self, cand: FabricCandidate) -> VerifyResult:
        return self.verify_batch([cand])[0]

    def verify_batch(self, cands) -> List[VerifyResult]:
        cands = list(cands)
        if not cands:
            return []
        return evaluate_fabric_batched(
            self.topology,
            [self._tier_archs(c) for c in cands],
            [self._tier_bounds(c) for c in cands],
            self.trace,
            cfg=self.cfg,
            back_annotation=self.back_annotation,
            i_burst=self.features.i_burst, mesh=self.mesh_spec,
            use_kernel=self.use_kernel, device=self.device)

    # ------------------------------------------------------------- ranking
    def surrogate_objectives(self, cand, sr: SurrogateResult):
        return (sr.p(99), self.resources(cand)["luts"])

    def objectives(self, cand, v: VerifyResult) -> Tuple[float, float]:
        # the acceptance pair: end-to-end tail latency vs total fabric LUTs
        return (v.p99_latency_ns, self.resources(cand)["luts"])

    def diversity_key(self, cand: FabricCandidate):
        return tuple((SwitchDSEProblem._arch(c).sched,
                      SwitchDSEProblem._arch(c).voq) for c in cand.tiers)
