"""The FPGA-switch DSE problem — Algorithm 1 instantiated on the paper's domain.

Plugs the resource model, statistical surrogate and network simulator into the
generic Progressive-Constraint-Satisfaction engine (``repro_torch.core.dse``).
The batched stages, back-annotation and the cycle-level switch run on
``device`` (default: the first CUDA device, which must exist): stage 2's
contention scan, stage 4's port replay and the switch's parser and iSLIP
step are hand-written CUDA kernels there, their plain PyTorch versions on
the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.archspec import (AUTO, ArchRequest, BUS_WIDTHS,
                                 ForwardTableKind, SchedulerKind, SwitchArch,
                                 VOQKind, enumerate_candidates)
from repro_torch.core.binding import BoundProtocol, SemanticBinding, bind
from repro_torch.core.dse import (
    DSEProblem,
    ResourceBudget,
    SLA,
    SurrogateResult,
    USE_KERNEL_MODES,
    VERIFY_ENGINES,
    VerifyResult,
    depth_for_drop_rate,
    run_dse,
)
from repro_torch.core.dsl import LayoutKey, ProtocolSpace
from repro_torch.core.features import TraceFeatures, analyze
from repro_torch.core.search import DesignSpace, Dim
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MeshSpec
from .backannotate import annotate
from .batched_netsim import run_netsim_batched
from .batched_surrogate import run_surrogate_batched
from .netsim import NetSimConfig, run_netsim
from .resources import ALVEO_U45N, BRAM_BITS, synthesize
from .surrogate import run_surrogate

__all__ = ["SwitchDSEProblem", "CoDesignCandidate", "VERIFY_ENGINES",
           "optimize_switch", "ISLIP_ITER_RANGE", "HASH_BANK_RANGE",
           "HASH_DEPTH_RANGE", "PROTO_DIM_PREFIX"]

#: genome dimension-name prefix separating protocol genes from architecture
#: genes in ``SwitchDSEProblem.space()`` (checkpoint signatures include it)
PROTO_DIM_PREFIX = "proto:"

#: extended per-dimension ranges the parameterized ``space()`` sweeps beyond
#: the classic ``enumerate_candidates`` grid (which pins these to the
#: ``SwitchArch`` defaults) — the joint space for the paper's all-AUTO 8-port
#: request is 4*2*2*3*4*3*3 = 1728 points, squarely generational-search
#: territory
ISLIP_ITER_RANGE: Tuple[int, ...] = (1, 2, 3, 4)
HASH_BANK_RANGE: Tuple[int, ...] = (2, 4, 8)
HASH_DEPTH_RANGE: Tuple[int, ...] = (128, 256, 512)


def align_depth_to_bram(d_opt: int, bus_bits: int) -> int:
    """AlignToBRAM: round the depth up to a whole number of RAMB36 rows."""
    entries_per_bram = max(1, BRAM_BITS // bus_bits)
    return int(math.ceil(max(d_opt, 1) / entries_per_bram) * entries_per_bram)


@dataclasses.dataclass(frozen=True, eq=False)
class CoDesignCandidate:
    """One joint (protocol layout, micro-architecture) phenotype.

    The co-design DSE's candidate: the decoded ``SwitchArch`` plus the
    decoded-and-bound protocol it was priced against.  Identity — for
    phenotype dedupe, surrogate caching and checkpoint equivalence — is
    ``(arch, layout)`` where ``layout`` is the canonical
    ``ProtocolSpace.layout_key`` tuple, so two genomes decoding to the same
    architecture *and* wire layout are one phenotype regardless of which
    memoized ``BoundProtocol`` instance they carry.  ``bound is None`` marks
    a statically infeasible layout (the stage-1 prune rejects it before any
    simulation)."""

    arch: SwitchArch
    bound: Optional[BoundProtocol]
    layout: LayoutKey
    infeasible: Optional[str] = None     # ProtocolSpace.feasible() reason

    def __hash__(self):
        return hash((self.arch, self.layout))

    def __eq__(self, other):
        return (isinstance(other, CoDesignCandidate)
                and self.arch == other.arch and self.layout == other.layout)

    @property
    def protocol(self):
        return self.bound.protocol if self.bound is not None else None

    def with_depth(self, depth: int) -> "CoDesignCandidate":
        return dataclasses.replace(self, arch=self.arch.with_depth(depth))

    def short(self) -> str:
        if self.bound is None:
            return f"{self.arch.short()} | <infeasible layout>"
        p = self.bound.protocol
        return f"{self.arch.short()} | {p.name} ({p.header_bytes}B hdr)"


class SwitchDSEProblem(DSEProblem):
    """The paper's FPGA-switch DSE problem.

    Classic mode: one fixed ``bound`` protocol, candidates are plain
    ``SwitchArch`` templates.  Co-design mode (``protocol_space`` given): the
    protocol layout joins the genome — candidates are ``CoDesignCandidate``
    phenotypes carrying their own decoded+bound protocol, ``space()`` splices
    the per-field width genes next to the architecture genes, and every
    stage prices/simulates against the candidate's own layout.  Decoded
    layouts are bound once and memoized on the canonical layout key, so N
    genomes sharing a layout compile one ``ParserPlan``.  ``require_seq=True``
    (for retransmitting deployments, cf. ``NetSimConfig.retransmit``) makes
    layouts without a ``seq_no`` field statically infeasible."""

    def __init__(
        self,
        request: ArchRequest,
        bound: Optional[BoundProtocol],
        trace,
        *,
        back_annotation: bool = True,
        headroom: float = 1.25,
        features: Optional[TraceFeatures] = None,
        verify_engine: str = "netsim",
        protocol_space: Optional[ProtocolSpace] = None,
        binding: Optional[SemanticBinding] = None,
        flit_bits: Optional[int] = None,
        require_seq: bool = False,
        mesh=None,
        use_kernel: str = "auto",
        device=None,
    ):
        if verify_engine not in VERIFY_ENGINES:
            raise ValueError(f"unknown verify_engine {verify_engine!r}; "
                             f"known: {VERIFY_ENGINES}")
        if not isinstance(use_kernel, bool) and use_kernel not in USE_KERNEL_MODES:
            raise ValueError(f"unknown use_kernel {use_kernel!r}; "
                             f"known: {USE_KERNEL_MODES} or a bool")
        self.request = request
        self.trace = trace
        # where the batched stages run; None means the first CUDA device
        self.device = resolve_device(device)
        # optional launch.mesh.MeshSpec: shards the stage-2/stage-4 batched
        # scans across a mesh of that device type (bit-identical to the
        # serial default)
        self.mesh_spec = MeshSpec.coerce(mesh)
        self.protocol_space = protocol_space
        self.binding = binding if binding is not None else SemanticBinding()
        self.require_seq = require_seq
        self._bound_cache: Dict[LayoutKey, BoundProtocol] = {}
        self._bind_errors: Dict[LayoutKey, str] = {}
        if bound is None:
            if protocol_space is None:
                raise ValueError("SwitchDSEProblem needs a bound protocol or "
                                 "a protocol_space to decode one from")
            # reference point: the widest layout (bindable iff any layout is)
            self.flit_bits = flit_bits if flit_bits is not None else 256
            bound = self._bind_layout(protocol_space.max_widths())
        else:
            self.flit_bits = (flit_bits if flit_bits is not None
                              else bound.plan.flit_bits)
        self.bound = bound
        # campaigns hand every problem sharing a trace one precomputed analysis
        self.features: TraceFeatures = features if features is not None else analyze(trace)
        self.back_annotation = back_annotation
        self.headroom = headroom
        self.verify_engine = verify_engine
        # "auto"|"on"|"off"|bool — resolved per batch call so the
        # SPAC_NETSIM_KERNEL kill-switch works mid-session
        self.use_kernel = use_kernel
        payload = np.asarray(trace.payload_bytes)
        self._max_payload = int(payload.max()) if payload.size else 0
        self._variable_payload = bool(payload.size
                                      and int(payload.min()) != self._max_payload)

    # --------------------------------------------------- co-design plumbing
    def _bind_layout(self, widths) -> BoundProtocol:
        """Decode + bind one layout, memoized on the canonical layout key, so
        recompiling ``ParserPlan``s costs one ``bind`` per distinct layout no
        matter how many genomes the search sends through it."""
        key = self.protocol_space.layout_key(widths)
        bp = self._bound_cache.get(key)
        if bp is None:
            bp = bind(self.protocol_space.decode(widths), self.binding,
                      flit_bits=self.flit_bits)
            self._bound_cache[key] = bp
        return bp

    @property
    def co_design(self) -> bool:
        return self.protocol_space is not None

    @property
    def addressing_ports(self) -> int:
        """Endpoint count the routing field must address.  A standalone
        switch addresses its own ports; fabric tier sub-problems override
        this with the *fabric* host count — a tier switch's routing field
        must name any host in the network, not just its local ports."""
        return self.request.n_ports

    @staticmethod
    def _arch(c) -> SwitchArch:
        return c.arch if isinstance(c, CoDesignCandidate) else c

    def _bound_for(self, c) -> BoundProtocol:
        return c.bound if isinstance(c, CoDesignCandidate) else self.bound

    def _batch_bound(self, cands):
        """The ``bound`` argument for a batched engine call: the shared
        protocol in classic mode, a per-candidate list under co-design."""
        if not self.co_design:
            return self.bound
        return [self._bound_for(c) for c in cands]

    # ------------------------------------------------------------- stage 1
    def candidates(self) -> List[SwitchArch]:
        if self.co_design:
            raise ValueError(
                "co-design joint spaces are generational-search territory; "
                "run with a SearchSpec (space()/decode()) instead of "
                "exhaustive candidates()")
        return enumerate_candidates(self.request)

    # ------------------------------------------------------ search support
    def space(
        self,
        *,
        islip_iters: Tuple[int, ...] = ISLIP_ITER_RANGE,
        hash_banks: Tuple[int, ...] = HASH_BANK_RANGE,
        hash_depths: Tuple[int, ...] = HASH_DEPTH_RANGE,
    ) -> DesignSpace:
        """Parameterized design space for the generational search engine.

        Per-dimension ranges instead of the pre-built ``candidates()`` list:
        explicit (non-AUTO) request policies collapse to single-choice
        dimensions, and the micro-architecture knobs ``enumerate_candidates``
        pins (iSLIP iterations, hash banking/depth) become searchable.
        """
        req = self.request
        fwd_opts = [
            f for f in (list(ForwardTableKind) if req.fwd is AUTO else [req.fwd])
            if not (f is ForwardTableKind.FULL_LOOKUP and req.addr_bits > 16)
        ] or [ForwardTableKind.MULTIBANK_HASH]
        voq_opts = list(VOQKind) if self.request.voq is AUTO else [req.voq]
        sched_opts = list(SchedulerKind) if req.sched is AUTO else [req.sched]
        bus_opts = BUS_WIDTHS if req.bus_bits is AUTO else (req.bus_bits,)
        dims = [
            Dim("bus_bits", tuple(bus_opts)),
            Dim("fwd", tuple(fwd_opts)),
            Dim("voq", tuple(voq_opts)),
            Dim("sched", tuple(sched_opts)),
            Dim("islip_iters", tuple(islip_iters)),
            Dim("hash_banks", tuple(hash_banks)),
            Dim("hash_depth", tuple(hash_depths)),
        ]
        if self.protocol_space is not None:
            # the tentpole splice: per-field width genes ride the same genome
            dims.extend(Dim(PROTO_DIM_PREFIX + fname, choices)
                        for fname, choices in self.protocol_space.dims())
        return DesignSpace(tuple(dims))

    def _decode_arch(self, assignment, addr_bits: int) -> SwitchArch:
        req = self.request
        fwd, sched = assignment["fwd"], assignment["sched"]
        is_islip = sched is SchedulerKind.ISLIP
        is_hash = fwd is ForwardTableKind.MULTIBANK_HASH
        return SwitchArch(
            n_ports=req.n_ports,
            bus_bits=assignment["bus_bits"],
            fwd=fwd,
            voq=assignment["voq"],
            sched=sched,
            voq_depth=64 if req.voq_depth is AUTO else req.voq_depth,
            hash_banks=assignment["hash_banks"] if is_hash else 4,
            hash_depth=assignment["hash_depth"] if is_hash else 256,
            islip_iters=assignment["islip_iters"] if is_islip else 2,
            addr_bits=addr_bits,
            custom_kernels=req.custom_kernels,
        )

    def decode(self, assignment):
        """One space point -> concrete template.  Genes that are inert for
        the selected policies (iSLIP iterations under RR/EDRRM, hash banking
        under FullLookup) canonicalise to the ``SwitchArch`` defaults so
        distinct genomes encoding the same micro-architecture decode to one
        phenotype — the search driver dedupes on it.

        Under co-design, the ``proto:*`` genes decode to a protocol layout:
        statically infeasible layouts (``ProtocolSpace.feasible``) come back
        as ``CoDesignCandidate(bound=None)`` — ``static_timing`` prices them
        infeasible so stage 1 prunes without ever binding or simulating —
        and feasible ones bind through the layout-keyed memo, with the
        architecture's forwarding key width (``addr_bits``) taken from the
        decoded routing field, so CAM/hash pricing follows the layout."""
        if self.protocol_space is None:
            return self._decode_arch(assignment, self.request.addr_bits)
        widths = {fname: assignment[PROTO_DIM_PREFIX + fname]
                  for fname, _ in self.protocol_space.dims()}
        key = self.protocol_space.layout_key(widths)
        reason = self.protocol_space.feasible(
            widths,
            n_ports=self.addressing_ports,
            max_payload_bytes=self._max_payload,
            variable_payload=self._variable_payload,
            needs_seq=self.require_seq,
        )
        if reason is None:
            reason = self._bind_errors.get(key)
        if reason is None:
            try:
                bound = self._bind_layout(widths)
            except ValueError as e:
                # feasible() reasons about semantics, not explicit binding
                # overrides — an override naming a field this layout drops
                # (binding={'qos': 'qos'} with qos width 0) fails only at
                # bind time; treat it as one more static-infeasibility
                reason = str(e)
                self._bind_errors[key] = reason
        if reason is not None:
            arch = self._decode_arch(assignment, self.request.addr_bits)
            return CoDesignCandidate(arch=arch, bound=None, layout=key,
                                     infeasible=reason)
        arch = self._decode_arch(assignment, bound.routing_field.bits)
        return CoDesignCandidate(arch=arch, bound=bound, layout=key)

    def static_timing(self, c) -> Tuple[float, float]:
        if isinstance(c, CoDesignCandidate) and c.bound is None:
            return math.inf, 1.0           # infeasible layout: stage-1 prune
        a, bound = self._arch(c), self._bound_for(c)
        rep = synthesize(a, bound)
        # one flit of the smallest packet must clear the pipe before the next
        s_min_wire = self.features.s_min + bound.header_bytes
        flits = max(1, math.ceil(s_min_wire / (a.bus_bits / 8)))
        t_proc = a.ii * flits / (rep.fmax_mhz * 1e6)
        t_arrival = s_min_wire * 8 / (self.trace.link_gbps * 1e9)
        return t_proc, t_arrival

    # ------------------------------------------------------------- stage 2
    def surrogate(self, c) -> SurrogateResult:
        return run_surrogate(self._arch(c), self._bound_for(c), self.trace,
                             back_annotation=self.back_annotation,
                             i_burst=self.features.i_burst, device=self.device)

    def surrogate_batch(self, cands) -> List[SurrogateResult]:
        """Fan stage 2 out through the batched engine: one
        contention scan over the shared trace with all candidate parameters
        (bus width, η, pipeline, stalls — and, under co-design, per-candidate
        header wire-bytes) as batch axes."""
        cands = list(cands)
        if not cands:
            return []
        return run_surrogate_batched(
            [self._arch(c) for c in cands], self._batch_bound(cands),
            self.trace,
            back_annotation=self.back_annotation,
            i_burst=self.features.i_burst, mesh=self.mesh_spec,
            use_kernel=self.use_kernel, device=self.device).results()

    # ------------------------------------------------------------- stage 3
    def size_buffers(self, c, q_occupancy: np.ndarray, eps: float):
        d_opt = depth_for_drop_rate(q_occupancy, eps)
        d = align_depth_to_bram(int(d_opt * self.headroom) + 1,
                                self._arch(c).bus_bits)
        return c.with_depth(d)

    def resources(self, c) -> Dict[str, float]:
        rep = synthesize(self._arch(c), self._bound_for(c))
        return {"luts": rep.luts, "ffs": rep.ffs, "brams": rep.brams, "bram": rep.brams}

    # ------------------------------------------------------------- stage 4
    def verify(self, c) -> VerifyResult:
        if self.verify_engine == "cycle":
            from .engines import get_engine
            return get_engine("cycle").evaluate(
                self._arch(c), self._bound_for(c), self.trace,
                back_annotation=self.back_annotation,
                i_burst=self.features.i_burst, device=self.device)
        return run_netsim(self._arch(c), self._bound_for(c), self.trace,
                          back_annotation=self.back_annotation,
                          i_burst=self.features.i_burst, device=self.device)

    def verify_batch(self, cands) -> List[VerifyResult]:
        """Fan stage 4 out through the batched finite-buffer verifier: one
        replay over the shared event timeline with every sized VOQ depth
        (and bus width, η, pipeline/arb cycles, stalls, f_clk) as a batch
        axis — drop counts and latencies exact vs the serial heapq path.
        Co-design batches mixing header widths partition internally by
        ``(n_ports, header_bytes)`` (the event timeline is width-dependent)."""
        cands = list(cands)
        if not cands:
            return []
        if self.verify_engine == "cycle":
            return [self.verify(c) for c in cands]     # rung 4 has no batch form
        return run_netsim_batched(
            [self._arch(c) for c in cands], self._batch_bound(cands),
            self.trace,
            back_annotation=self.back_annotation,
            i_burst=self.features.i_burst, mesh=self.mesh_spec,
            use_kernel=self.use_kernel, device=self.device)

    def escalate(self, c, v: VerifyResult) -> Optional[VerifyResult]:
        """``verify_engine="auto"``: the front was verified by batched netsim;
        climb the champion one rung to the cycle-accurate datapath.  The
        result lands in ``meta["escalated"]`` (ranking stays netsim-based, so
        "auto" and "netsim" produce the identical Pareto front)."""
        if self.verify_engine != "auto":
            return None
        from .engines import get_engine
        return get_engine("cycle").evaluate(
            self._arch(c), self._bound_for(c), self.trace, hw=v.meta.get("hw"),
            back_annotation=self.back_annotation,
            i_burst=self.features.i_burst, device=self.device)

    def objectives(self, c, v: VerifyResult) -> Tuple[float, float]:
        # Table II reports *average* latency; p99 is already an SLA constraint
        rep = synthesize(self._arch(c), self._bound_for(c))
        return (v.mean_latency_ns, rep.brams)

    def diversity_key(self, c):
        a = self._arch(c)
        return (a.sched, a.voq)


def optimize_switch(
    request: ArchRequest,
    bound: BoundProtocol,
    trace,
    *,
    sla: Optional[SLA] = None,
    budget: Optional[ResourceBudget] = None,
    back_annotation: bool = True,
    delta: float = 0.2,
    top_k: int = 8,
    verify_engine: str = "netsim",
    verbose: bool = False,
    device=None,
):
    """One-call wrapper: trace in, Pareto-optimal switch out (Table II flow).

    Compatibility wrapper for the pre-Scenario API.  New code should build a
    ``repro_torch.api.Scenario`` and call ``repro_torch.api.run_scenario`` —
    a scenario is the same (request, protocol, trace, SLA, budget) bundle as
    a serializable config, and ``run_scenario`` runs exactly this path
    underneath.  ``device`` defaults to the first CUDA device.
    """
    problem = SwitchDSEProblem(request, bound, trace,
                               back_annotation=back_annotation,
                               verify_engine=verify_engine, device=device)
    sla = sla or SLA(p99_latency_ns=math.inf, drop_rate=1e-3)
    budget = budget or ResourceBudget(dict(ALVEO_U45N))
    result = run_dse(problem, sla, budget, delta=delta, top_k=top_k, verbose=verbose)
    return result, problem
